"""Futures, promises, actors, streams, and combinators on the event loop.

The analog of the reference's flow core (flow/flow.h:275-899 —
SAV/Future/Promise/PromiseStream/NotifiedQueue) and its combinator library
(flow/genericactors.actor.h). Python coroutines replace the C# actor
compiler: ``async def`` bodies are the ``ACTOR`` functions, ``await`` is
``wait()``, and ``spawn()`` drives them as cancellable tasks on the loop.

Semantics mirrored from the reference:
- ``Promise.send`` fires callbacks immediately-but-scheduled (delivery order
  is loop order, deterministic);
- dropping/cancelling an actor's future cancels the actor (Cancelled is
  thrown at its current await point — flow's actor_cancelled);
- ``PromiseStream`` is a multi-value channel; readers block on next().
"""

from __future__ import annotations

from collections import deque
from typing import Any, Awaitable, Callable, Generic, Optional, TypeVar

from . import trace as _trace
from .loop import Cancelled, TaskPriority, current_loop

T = TypeVar("T")


class Future(Generic[T]):
    __slots__ = ("_value", "_error", "_done", "_callbacks", "_task")

    def __init__(self):
        self._value: Optional[T] = None
        self._error: Optional[BaseException] = None
        self._done = False
        self._callbacks: list[Callable[[Future], None]] = []
        self._task: Optional[Task] = None  # set when this is an actor's future

    # -- inspection
    def is_ready(self) -> bool:
        return self._done

    def is_error(self) -> bool:
        return self._done and self._error is not None

    def get(self) -> T:
        assert self._done
        if self._error is not None:
            raise self._error
        return self._value

    # -- completion
    def _set(self, value: T) -> None:
        if self._done:
            return
        self._value = value
        self._done = True
        self._fire()

    def _set_error(self, err: BaseException) -> None:
        if self._done:
            return
        self._error = err
        self._done = True
        self._fire()

    def _fire(self) -> None:
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def add_callback(self, cb: Callable[["Future"], None]) -> None:
        if self._done:
            cb(self)
        else:
            self._callbacks.append(cb)

    def cancel(self) -> None:
        """Cancel the actor producing this future (no-op if plain promise)."""
        if self._task is not None and not self._done:
            self._task.cancel()

    # -- await protocol
    def __await__(self):
        if not self._done:
            yield self
        if self._error is not None:
            raise self._error
        return self._value


class Promise(Generic[T]):
    __slots__ = ("future",)

    def __init__(self):
        self.future: Future[T] = Future()

    def send(self, value: T = None) -> None:
        self.future._set(value)

    def send_error(self, err: BaseException) -> None:
        self.future._set_error(err)

    def is_set(self) -> bool:
        return self.future.is_ready()


class Task:
    """Drives a coroutine on the loop; the generated actor state machine."""

    def __init__(self, coro, priority: int = TaskPriority.DEFAULT, name: str = None):
        self.coro = coro
        self.future: Future = Future()
        self.future._task = self
        self.priority = priority
        # actor identity for run-loop attribution (runtime/profiler.py):
        # the coroutine's qualname names the async def that IS the actor,
        # threaded through every (re)schedule so the loop can attribute
        # each callback's on-CPU time to its owner. RPC dispatch overrides
        # it with the handler's qualname (the wrapper is anonymous plumbing).
        self.name = (
            name or getattr(coro, "__qualname__", None) or type(coro).__name__
        )
        self._cancelled = False
        # set by a spawner that reads this actor's outcome itself (a hedged
        # request's entrant, client/loadbalance.py): its error is passed to
        # the owning ActorCollection's on_error as observed
        self.observed = False
        self._waiting_on: Optional[Future] = None
        # home loop: every (re)scheduling of this task goes here, NOT to
        # whatever loop is current at wake time — when an old simulation's
        # coroutines are garbage-collected while a new simulation runs,
        # their finalizers must not leak callbacks into the new world
        self.loop = current_loop()
        # trace-span inheritance (runtime/trace.py): a spawned actor runs
        # inside the spawner's active span context; each step saves the
        # (possibly changed) context back so it survives awaits
        self._span_ctx = _trace.active_span()

    def start(self) -> Future:
        self.loop.call_soon(lambda: self._step(None, None), self.priority, self.name)
        return self.future

    def cancel(self) -> None:
        if self.future.is_ready() or self._cancelled:
            return
        self._cancelled = True
        self.loop.call_soon(
            lambda: self._step(None, Cancelled()), TaskPriority.MAX, self.name
        )

    def _step(self, value, error) -> None:
        if self.future.is_ready():
            return
        self._waiting_on = None
        prev_span = _trace.swap_active_span(self._span_ctx)
        try:
            self._step_inner(value, error)
        finally:
            # latch whatever context the body left active (a span opened
            # across this await) and restore the interrupted one
            self._span_ctx = _trace.swap_active_span(prev_span)

    def _step_inner(self, value, error) -> None:
        try:
            if error is not None:
                awaited = self.coro.throw(error)
            else:
                awaited = self.coro.send(value)
        except StopIteration as stop:
            # a cancelled actor never produces a value, even if its body
            # swallowed the Cancelled and returned (flow: actor_cancelled)
            if self._cancelled:
                self.future._set_error(Cancelled())
            else:
                self.future._set(stop.value)
            return
        except Cancelled as c:
            self.future._set_error(c)
            return
        except BaseException as e:
            self.future._set_error(e)
            return
        # The coroutine yielded a Future it waits on.
        assert isinstance(awaited, Future), f"actors must await Futures, got {awaited!r}"
        if self._cancelled:
            # keep re-throwing at every await until the body exits, so an
            # actor that catches Cancelled and awaits again can't hang forever
            self.loop.call_soon(
                lambda: self._step(None, Cancelled()), TaskPriority.MAX, self.name
            )
            return
        self._waiting_on = awaited

        def wake(f: Future, task=self):
            # only the await the task is currently parked on may resume it
            # (a stale pre-cancellation future can fire later); a cancelled
            # task is resumed solely by the Cancelled re-throw in _step
            if (
                task.future.is_ready()
                or task._cancelled
                or task._waiting_on is not f
            ):
                return
            col = task.loop._wake_collector
            if col is not None:
                # settle-slab mode (settle_batch): record the wakeup; the
                # installer reschedules the whole slab in per-priority
                # call_soon_batch entries. All resume-eligibility guards
                # ran above, exactly as on the direct path.
                if f._error is not None:
                    col.append((task, None, f._error))
                else:
                    col.append((task, f._value, None))
                return
            if f._error is not None:
                task.loop.call_soon(
                    lambda: task._step(None, f._error), task.priority, task.name
                )
            else:
                task.loop.call_soon(
                    lambda: task._step(f._value, None), task.priority, task.name
                )

        awaited.add_callback(wake)


def spawn(coro, priority: int = TaskPriority.DEFAULT, name: str = None) -> Future:
    """Run an async def body as an actor; returns its future (cancellable).
    ``name`` overrides the profiler attribution (defaults to the
    coroutine's qualname)."""
    return Task(coro, priority, name).start()


def start_batch(tasks: list) -> None:
    """Start many NOT-yet-started Tasks with ONE loop queue entry (the
    transport's server-side batch dispatch, net/tcp.py): a super-frame of
    N requests drains in a single loop step instead of scheduling N
    wakeups. Each task's first step still runs under its own profiler
    attribution (loop.call_soon_batch); subsequent steps reschedule
    individually as usual. A task cancelled before the batch runs resolves
    through the normal MAX-priority Cancelled re-throw — its batch step
    then no-ops on the ready future."""
    if not tasks:
        return
    if len(tasks) == 1:
        tasks[0].start()
        return
    tasks[0].loop.call_soon_batch(
        [((lambda t=t: t._step(None, None)), t.name) for t in tasks],
        tasks[0].priority,
    )


# slab settling on/off (knob FUTURE_SLAB_SETTLE): off restores the
# one-call_soon-per-wakeup path for A/B runs and chaos coverage
_SLAB_ON = True


def set_slab_settle(on: bool) -> None:
    global _SLAB_ON
    _SLAB_ON = bool(on)


def slab_settle_enabled() -> bool:
    return _SLAB_ON


def settle_batch(settlements: list) -> None:
    """Settle many ``(future, value, error)`` triples in ONE loop step —
    the completion-side mirror of start_batch. A super-frame of N replies
    (net/tcp.py) or a GRV batch fan-out used to pay one call_soon per
    woken waiter task; here every ``_set`` runs under a slab collector
    (loop._wake_collector), the woken tasks are grouped by priority, and
    each priority group resumes via one call_soon_batch entry — per-item
    profiler attribution preserved (BATCH_OWNER discipline).

    Semantics match per-item settling exactly: non-Task callbacks still
    fire synchronously inside ``_set`` (cascaded Task wakeups they cause
    are collected too), wake-eligibility guards run at fire time as
    usual, and priority ordering across groups is the heap's as before.
    With slab settling off (set_slab_settle) this degrades to the plain
    per-item loop."""
    if not settlements:
        return
    if not _SLAB_ON or len(settlements) == 1:
        for fut, value, err in settlements:
            if err is not None:
                fut._set_error(err)
            else:
                fut._set(value)
        return
    loop = current_loop()
    collected: list = []
    prev = loop._wake_collector
    loop._wake_collector = collected
    try:
        for fut, value, err in settlements:
            if err is not None:
                fut._set_error(err)
            else:
                fut._set(value)
    finally:
        loop._wake_collector = prev
    if not collected:
        return
    if len(collected) == 1:
        task, value, err = collected[0]
        loop.call_soon(
            lambda: task._step(value, err), task.priority, task.name
        )
        return
    by_pri: dict = {}
    for item in collected:
        by_pri.setdefault(item[0].priority, []).append(item)
    for pri, items in by_pri.items():
        loop.call_soon_batch(
            [
                ((lambda t=t, v=v, e=e: t._step(v, e)), t.name)
                for t, v, e in items
            ],
            pri,
        )


# ---------------------------------------------------------------------------
# Timers / yields


def delay(seconds: float, priority: int = TaskPriority.DEFAULT) -> Future[None]:
    f: Future[None] = Future()
    current_loop().call_at(current_loop().now() + seconds, lambda: f._set(None), priority)
    return f


def yield_now(priority: int = TaskPriority.DEFAULT) -> Future[None]:
    return delay(0.0, priority)


async def forever():
    await Future()  # never completes (until cancelled)


# ---------------------------------------------------------------------------
# Streams (PromiseStream / NotifiedQueue, flow/flow.h:504-899)


class StreamClosed(Exception):
    pass


class PromiseStream(Generic[T]):
    def __init__(self):
        self._queue: deque[T] = deque()
        self._waiters: deque[Future] = deque()
        self._closed = False
        self._close_error: Optional[BaseException] = None

    def send(self, value: T) -> None:
        if self._closed:
            return
        if self._waiters:
            self._waiters.popleft()._set(value)
        else:
            self._queue.append(value)

    def close(self, err: Optional[BaseException] = None) -> None:
        self._closed = True
        self._close_error = err or StreamClosed()
        while self._waiters:
            self._waiters.popleft()._set_error(self._close_error)

    def next(self) -> Future[T]:
        f: Future[T] = Future()
        if self._queue:
            f._set(self._queue.popleft())
        elif self._closed:
            f._set_error(self._close_error)
        else:
            self._waiters.append(f)
        return f

    def is_empty(self) -> bool:
        return not self._queue


# ---------------------------------------------------------------------------
# Combinators (genericactors.actor.h analogs)


async def wait_for_all(futures: list[Future]) -> list:
    out = []
    for f in futures:
        out.append(await f)
    return out


def wait_for_any(futures: list[Future]) -> Future[int]:
    """Resolves to the index of the first completed future."""
    out: Future[int] = Future()

    def make_cb(i):
        def cb(f: Future):
            if not out.is_ready():
                if f._error is not None:
                    out._set_error(f._error)
                else:
                    out._set(i)

        return cb

    for i, f in enumerate(futures):
        f.add_callback(make_cb(i))
    return out


def settled(fut: Future) -> Future[None]:
    """A future that resolves (never errors) once ``fut`` completes — for
    racing an error-prone future inside wait_for_any without the error
    killing the waiter (flow's ``ready()``). Inspect ``fut`` afterwards."""
    out: Future[None] = Future()
    fut.add_callback(lambda f: out._set(None) if not out.is_ready() else None)
    return out


class TimedOut(Exception):
    pass


class QuorumFailed(Exception):
    """Too many of a quorum's futures failed for it ever to succeed."""


def quorum(futures: list[Future], n: int) -> Future[list]:
    """Resolves once ``n`` of the futures succeed (flow's ``quorum()``),
    with the successful results (order of completion). Errors with
    QuorumFailed as soon as success becomes impossible."""
    out: Future[list] = Future()
    successes: list = []
    fails = [0]
    total = len(futures)
    if n > total:
        out._set_error(QuorumFailed(f"need {n} of {total}"))
        return out

    def cb(f: Future):
        if out.is_ready():
            return
        if f._error is not None:
            fails[0] += 1
            if total - fails[0] < n:
                out._set_error(QuorumFailed(f"{fails[0]}/{total} failed, need {n}"))
        else:
            successes.append(f._value)
            if len(successes) >= n:
                out._set(list(successes))

    for f in futures:
        f.add_callback(cb)
    return out


async def timeout(fut: Future[T], seconds: float, default=None) -> T:
    timer = delay(seconds)
    which = await wait_for_any([fut, timer])
    if which == 0:
        return fut.get()
    fut.cancel()
    return default


class AsyncVar(Generic[T]):
    """A variable whose changes can be awaited (flow's AsyncVar)."""

    def __init__(self, value: T = None):
        self._value = value
        self._change: Future[None] = Future()

    def get(self) -> T:
        return self._value

    def set(self, value: T) -> None:
        if value != self._value:
            self._value = value
            old, self._change = self._change, Future()
            old._set(None)

    def on_change(self) -> Future[None]:
        return self._change


class AsyncTrigger:
    def __init__(self):
        self._f: Future[None] = Future()

    def trigger(self) -> None:
        old, self._f = self._f, Future()
        old._set(None)

    def on_trigger(self) -> Future[None]:
        return self._f


class RequestBatcher:
    """Natural request coalescing: one fetch in flight at a time; callers
    that arrive during a flight form the next batch and share its result.
    The pattern behind GRV batching at both ends (the client's
    readVersionBatcher, fdbclient/NativeAPI.actor.cpp:1290, and the
    proxy's transactionStarter master fetch,
    fdbserver/MasterProxyServer.actor.cpp:925). Joining an *in-flight*
    fetch would break causality (a result observed elsewhere after the
    fetch began could be newer), so only pre-flight arrivals share.

    ``fetch`` is a zero-arg coroutine function; ``spawn`` schedules the
    batcher actor (e.g. ``process.spawn`` or a client's spawn).
    ``counted=True`` calls ``fetch(n)`` with the batch size instead — the
    GRV batcher reports how many transactions share the fetch so proxy
    admission debits per TRANSACTION, not per coalesced request (the
    reference's GetReadVersionRequest.transactionCount)."""

    def __init__(self, fetch, spawn_fn, counted: bool = False):
        self._fetch = fetch
        self._spawn = spawn_fn
        self._counted = counted
        self._waiters: list[Future] = []
        self._running = False

    def join(self) -> Future:
        fut: Future = Future()
        self._waiters.append(fut)
        if not self._running:
            self._running = True
            self._spawn(self._run())
        return fut

    async def _run(self):
        try:
            while self._waiters:
                waiters, self._waiters = self._waiters, []
                try:
                    value = await (
                        self._fetch(len(waiters))
                        if self._counted
                        else self._fetch()
                    )
                except Cancelled:
                    # actor-cancelled-swallow: the batcher dies with its
                    # cancellation, but parked callers must not hang on a
                    # fetch that will never be retried
                    for w in waiters:
                        if not w.is_ready():
                            w._set_error(Cancelled())
                    raise
                except BaseException as e:
                    settle_batch(
                        [(w, None, e) for w in waiters if not w.is_ready()]
                    )
                    continue
                if len(waiters) == 1:
                    # no-hedge single-waiter fast path: resolve the lone
                    # caller's future directly, no slab machinery
                    w = waiters[0]
                    if not w.is_ready():
                        w._set(value)
                else:
                    settle_batch(
                        [(w, value, None) for w in waiters if not w.is_ready()]
                    )
        finally:
            self._running = False


class VersionGate:
    """Orders batch application by (prev_version → version) chaining — the
    sequencing discipline shared by resolvers (Resolver.actor.cpp:104-122)
    and tlogs (tLogCommit version ordering): a batch waits until the gate
    reaches its prev_version, applies, then advances the gate to its own
    version."""

    def __init__(self, version: int = 0):
        self.version = version
        self._waiters: dict[int, Future] = {}  # target version → wakeup

    async def wait_until(self, version: int) -> None:
        while self.version < version:
            f = self._waiters.get(version)
            if f is None:
                f = self._waiters[version] = Future()
            await f

    def advance_to(self, version: int) -> None:
        if version > self.version:
            self.version = version
            for t in [t for t in self._waiters if t <= version]:
                self._waiters.pop(t)._set(None)


class ActorCollection:
    """Holds actor futures; errors propagate, completions are discarded
    (flow/ActorCollection.actor.cpp).

    ``on_error`` (optional) is invoked synchronously with the exception the
    first time an actor dies unhandled — the hook that makes actor death
    LOUD (the reference turns an unhandled error into a TraceEvent + process
    death; silence here once hid a cluster-wide boot failure). Its second
    argument says whether the actor's spawner reads that error itself
    (``Task.observed``)."""

    def __init__(
        self, on_error: Optional[Callable[[BaseException, bool], None]] = None
    ):
        self._actors: list[Future] = []
        self.error: Future = Future()
        self.on_error = on_error

    def add(self, fut: Future) -> None:
        self._actors.append(fut)

        def cb(f: Future):
            # A Cancelled error is benign only if the actor was itself
            # cancelled (cancel_all / explicit cancel). Cancelled *propagated*
            # from awaiting some other cancelled actor is a real failure
            # (the reference's broken_promise) and must surface.
            genuine_cancel = (
                isinstance(f._error, Cancelled)
                and f._task is not None
                and f._task._cancelled
            )
            if f._error is not None and not genuine_cancel:
                if self.on_error is not None:
                    try:
                        self.on_error(
                            f._error, f._task is not None and f._task.observed
                        )
                    except Exception:
                        pass
                if not self.error.is_ready():
                    self.error._set_error(f._error)
            # prune: completed actors (and their results) must not accumulate
            try:
                self._actors.remove(f)
            except ValueError:
                pass

        fut.add_callback(cb)

    def cancel_all(self) -> None:
        for f in self._actors:
            f.cancel()
        self._actors.clear()
