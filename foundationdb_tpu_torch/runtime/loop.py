"""Deterministic single-threaded event loop with virtual time.

The analog of the reference's Net2 run loop (flow/Net2.actor.cpp:545) and —
more importantly — of the Sim2 deterministic simulator
(fdbrpc/sim2.actor.cpp:720): all scheduling, timers, and randomness flow
through one seeded loop, so any execution is exactly reproducible from its
seed. Time is virtual: ``now()`` advances only when the loop runs a timer,
never with wall-clock (the property that makes whole-cluster simulation of
hours of activity run in seconds and replays bit-identical).

Tasks carry priorities (the reference's ~40-level TaskPriority enum,
flow/network.h:30-75, collapsed to the levels this system uses); ready tasks
at the same time run in (priority, seq) order, with seq assigned at schedule
time — deterministic FIFO within a priority.
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional

from .rng import DeterministicRandom


class TaskPriority:
    MAX = 1000000
    COORDINATION = 8800
    TLOG_COMMIT = 8570
    PROXY_COMMIT = 8540
    RESOLVER = 8700
    DEFAULT = 7500
    STORAGE = 6500
    LOW = 2000
    ZERO = 0


class Cancelled(Exception):
    """Raised inside an actor when its future is cancelled (the analog of
    actor_cancelled, flow/error_definitions.h)."""


# owner sentinel marking a batch-runner queue entry: the run loops execute
# it UNWRAPPED (the runner applies per-item profiler attribution itself —
# wrapping it again would double-count busy time and steps)
BATCH_OWNER = "<batch>"


class EventLoop:
    """Priority run loop over virtual time. Single-threaded; determinism
    comes from (time, -priority, seq) ordering and the seeded RNG."""

    def __init__(self, seed: int = 0):
        self._queue: list[tuple] = []  # (when, -priority, seq, fn, owner)
        self._time = 0.0
        self._seq = 0
        self.random = DeterministicRandom(seed)
        self.stopped = False
        self._stall_detector: Optional[Callable[[], None]] = None
        # run-loop profiler (runtime/profiler.py), installed by the world
        # constructors behind the RUN_LOOP_PROFILER knob; when present,
        # every callback executes under per-actor/per-band attribution
        self.profiler = None
        # settle-slab hook (futures.settle_batch): while non-None, Task
        # wakeups append (task, value, error) here instead of paying one
        # call_soon per woken task; the installer flushes the slab as
        # per-priority call_soon_batch entries
        self._wake_collector = None

    def now(self) -> float:
        return self._time

    def call_at(
        self,
        when: float,
        fn: Callable[[], None],
        priority: int = TaskPriority.DEFAULT,
        owner: Optional[str] = None,
    ) -> None:
        # reentrancy-safe: a GC run triggered by the allocations below can
        # finalize coroutines whose finally-blocks schedule more callbacks
        # (re-entering this method); the seq must be latched in a local or
        # two entries can share one and the heap falls over comparing the
        # callables
        seq = self._seq = self._seq + 1
        heapq.heappush(
            self._queue, (max(when, self._time), -priority, seq, fn, owner)
        )

    def call_soon(
        self,
        fn: Callable[[], None],
        priority: int = TaskPriority.DEFAULT,
        owner: Optional[str] = None,
    ) -> None:
        self.call_at(self._time, fn, priority, owner)

    def call_soon_batch(
        self, items: list, priority: int = TaskPriority.DEFAULT
    ) -> None:
        """Schedule many callbacks as ONE queue entry: ``items`` is a list
        of ``(fn, owner)`` pairs run in order within a single loop step —
        the server-side batch dispatch that drains a whole super-frame of
        requests per wakeup instead of paying a heap entry (and a
        profiler-wrapped step) per request. Each item still executes under
        its own per-actor attribution; only the schedule→run lag collapses
        to the batch's (it is one schedule)."""
        if len(items) == 1:
            fn, owner = items[0]
            self.call_at(self._time, fn, priority, owner)
            return

        def _run_batch():
            prof = self.profiler
            if prof is None:
                for fn, _owner in items:
                    fn()
            else:
                for fn, owner in items:
                    prof.run_task(fn, owner, priority, 0.0)

        self.call_at(self._time, _run_batch, priority, BATCH_OWNER)

    def run(self, until: float = float("inf"), stop_when: Callable[[], bool] = None):
        """Drain tasks until the queue empties, virtual time passes ``until``,
        or ``stop_when()`` turns true."""
        while self._queue and not self.stopped:
            when, negpri, _seq, fn, owner = self._queue[0]
            if when > until:
                break
            heapq.heappop(self._queue)
            self._time = max(self._time, when)
            prof = self.profiler
            if prof is None or owner is BATCH_OWNER:
                fn()
            else:
                # virtual schedule→run lag: deterministically ~0 here (the
                # sim warps time to the due instant), but the call keeps
                # one code path for both personalities
                prof.run_task(fn, owner, -negpri, self._time - when)
            if stop_when is not None and stop_when():
                break
        return self._time


class RealLoop(EventLoop):
    """Wall-clock run loop with socket IO — the non-simulated personality
    of the event loop (the reference's Net2 over boost.asio,
    flow/Net2.actor.cpp:545 + AsioReactor: timers and socket readiness in
    one reactor). The actor/future machinery is loop-agnostic, so server
    code runs unmodified on either personality; only this loop may block
    in ``select``.
    """

    def __init__(self, seed: Optional[int] = None):
        import os as _os
        import selectors
        from collections import deque

        if seed is None:
            # the REAL personality seeds from OS entropy by design: there is
            # no replay to protect, and distinct processes must diverge
            seed = int.from_bytes(_os.urandom(8), "little")  # flowlint: disable=det-entropy
        super().__init__(seed)
        self._selector = selectors.DefaultSelector()
        self._t0 = self._monotonic()
        self._time = 0.0
        # cross-thread handoff: worker threads (device waits, blocking IO)
        # may not touch the heap; they append here and the loop drains at
        # the top of each cycle (the select timeout bounds wakeup latency)
        self._posted = deque()
        # external work in flight (e.g. a resolver's device thread): the
        # loop must not take the "nothing left to wait for" exit while a
        # completion post is still coming. Both counters are mutated ONLY
        # on the loop thread (begin at submit, end inside the posted
        # completion), so no lock is needed.
        self._external_pending = 0
        # self-pipe: post() writes a byte so a loop parked in select()
        # wakes immediately instead of at the 50 ms timeout (the reference
        # wakes its reactor the same way, Net2's ASIOReactor::wake)
        import socket as _socket

        self._wake_r, self._wake_w = _socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self.add_reader(self._wake_r, self._drain_wake)

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def close(self) -> None:
        """Release the wake pipe AND the selector (a loop is one-per-process
        in production, but tests create many — an unclosed selector leaks
        one epoll fd per loop until the fd table fills). Idempotent: the
        __del__ backstop and explicit close may both run."""
        if self.profiler is not None:
            try:
                self.profiler.flame_stop()  # sampler thread must not outlive us
            except Exception:
                pass
        try:
            self.remove_reader(self._wake_r)
        except Exception:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        try:
            self._selector.close()
        except (OSError, RuntimeError):
            pass

    def __del__(self):  # backstop for leak-prone test loops
        self.close()

    def post(self, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` onto the loop from ANY thread (deque.append is
        atomic). The reference's onMainThread (flow/ThreadHelper.actor.h)."""
        self._posted.append(fn)
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # pipe full = wakeup already pending

    def external_begin(self) -> None:
        self._external_pending += 1

    def external_end(self) -> None:
        self._external_pending -= 1

    @staticmethod
    def _monotonic() -> float:
        import time as _time

        # the ONE place wall time enters the system: RealLoop IS the
        # wall-clock personality; everything above it sees loop.now()
        return _time.monotonic()  # flowlint: disable=det-wall-clock

    def _wall(self) -> float:
        return self._monotonic() - self._t0

    # -- IO registration -------------------------------------------------------

    def add_reader(self, sock, cb: Callable[[], None]) -> None:
        import selectors

        try:
            key = self._selector.get_key(sock)
        except KeyError:
            self._selector.register(sock, selectors.EVENT_READ, [cb, None])
            return
        key.data[0] = cb
        self._selector.modify(sock, key.events | selectors.EVENT_READ, key.data)

    def add_writer(self, sock, cb: Callable[[], None]) -> None:
        import selectors

        try:
            key = self._selector.get_key(sock)
        except KeyError:
            self._selector.register(sock, selectors.EVENT_WRITE, [None, cb])
            return
        key.data[1] = cb
        self._selector.modify(sock, key.events | selectors.EVENT_WRITE, key.data)

    def remove_reader(self, sock) -> None:
        self._remove(sock, 0)

    def remove_writer(self, sock) -> None:
        self._remove(sock, 1)

    def _remove(self, sock, slot: int) -> None:
        import selectors

        try:
            key = self._selector.get_key(sock)
        except (KeyError, ValueError):
            return  # never registered, or already closed (fd -1)
        key.data[slot] = None
        events = (selectors.EVENT_READ if key.data[0] else 0) | (
            selectors.EVENT_WRITE if key.data[1] else 0
        )
        if events:
            self._selector.modify(sock, events, key.data)
        else:
            self._selector.unregister(sock)

    # -- running ---------------------------------------------------------------

    def run(self, until: float = float("inf"), stop_when: Callable[[], bool] = None):
        import selectors

        while not self.stopped:
            prof = self.profiler
            while self._posted:
                self.call_soon(self._posted.popleft())
            self._time = self._wall()
            # drain due callbacks
            while self._queue and self._queue[0][0] <= self._time:
                when, negpri, _s, fn, owner = heapq.heappop(self._queue)
                if prof is None or owner is BATCH_OWNER:
                    fn()
                else:
                    # wall schedule→run lag: how long past due this task
                    # ran — the starvation the blocked loop inflicted
                    prof.run_task(fn, owner, -negpri, self._time - when)
                if stop_when is not None and stop_when():
                    return self._time
                self._time = self._wall()
            if stop_when is not None and stop_when():
                return self._time
            if self._time >= until:
                return self._time
            if (
                not self._queue
                and len(self._selector.get_map()) <= 1  # wake pipe only
                and self._external_pending == 0
                and not self._posted
            ):
                return self._time  # nothing left to wait for
            wait = 0.05
            if self._queue:
                wait = max(0.0, min(wait, self._queue[0][0] - self._time))
            if until != float("inf"):
                wait = max(0.0, min(wait, until - self._time))
            if prof is None:
                ready = self._selector.select(wait)
            else:
                t0 = self._monotonic()
                ready = self._selector.select(wait)
                prof.select_done(self._monotonic() - t0)
            for key, events in ready:
                rd, wr = key.data
                if events & selectors.EVENT_READ and rd is not None:
                    rd() if prof is None else prof.run_io(rd)
                if events & selectors.EVENT_WRITE and wr is not None:
                    wr() if prof is None else prof.run_io(wr)
            # a stop condition satisfied inside an IO callback must end the
            # run NOW — falling through to the next cycle would execute
            # whatever timers are due (and, with an empty selector map,
            # could park in select again) before anyone re-consulted it
            if stop_when is not None and stop_when():
                return self._time
        return self._time


_current: Optional[EventLoop] = None


def current_loop() -> EventLoop:
    if _current is None:
        raise RuntimeError("no event loop active (use with_loop / Sim)")
    return _current


def set_loop(loop: Optional[EventLoop]) -> None:
    global _current
    _current = loop


def now() -> float:
    return current_loop().now()
