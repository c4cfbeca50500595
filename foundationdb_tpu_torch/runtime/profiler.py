"""Run-loop profiler: slow-task attribution, per-priority starvation, and
sampled flame evidence.

The analog of the reference's run-loop profiler + NetworkMetrics
(flow/Net2.actor.cpp's checkForSlowTask / NetworkMetrics in flow/network.h,
flow/Profiler.actor.cpp's sampling profiler): the whole process is one
single-threaded priority loop, so one blocking callback stalls every role
hosted by the process. Spans (runtime/trace.py) measure wall time *between*
hops and counters (runtime/stats.py) measure *what* happened; this module
attributes **on-CPU time holding the loop** — who ran, for how long, at what
priority, and who waited because of it.

Three instruments, one per failure mode:

- ``LoopProfiler`` — wraps every callback the loop executes (both
  personalities hook it from ``EventLoop.run`` / ``RealLoop.run``).
  Each callback is attributed to its owning actor (``futures.Task`` threads
  the coroutine's ``__qualname__`` through the scheduling calls), rolled up
  per actor (steps, busy seconds, max single step) and per priority band
  (busy fraction, schedule→run starvation latency as a ``LatencySample``).
  On the REAL personality a callback that holds the loop longer than
  ``RUN_LOOP_SLOW_TASK_MS`` emits a ``Type="SlowTask"`` trace event (the
  reference's SlowTask / Net2SlowTaskTrace) naming the actor. The SIM
  personality emits no wall-dependent trace events — its step counters are
  deterministic under a fixed seed, so attribution is *testable*.

- per-band ``NetworkMetrics``: the profiler owns a ``CounterCollection``
  (``RunLoopMetrics`` periodic trace events) with step/slow-task counters,
  per-band starvation samples, select/poll latency on the real loop, and a
  queue-depth gauge — everything in the collection is loop-derived, so the
  sim's periodic RunLoopMetrics events stay byte-deterministic.

- ``FlameProfiler`` — a sampler THREAD reading the loop thread's stack via
  ``sys._current_frames()`` at ``PROFILER_SAMPLE_HZ``, aggregating collapsed
  stacks into flamegraph/speedscope-compatible folded lines
  (``a;b;c 42``) — the evidence for *where inside the callback* the time
  went, dumped via ``cli profile``.

Wall-clock reads here are the profiler's measurement function, not sim
state: nothing measured feeds back into scheduling, so replays stay
bit-identical (the inline flowlint disables below mark each deliberate
site).
"""

from __future__ import annotations

import sys
import threading
from typing import Optional

from .loop import TaskPriority
from .stats import CounterCollection

# priority → band: the reference's ~40-level TaskPriority enum collapsed to
# the levels this system schedules at (loop.py TaskPriority). A priority
# lands in the highest band whose threshold it reaches; IO readiness
# callbacks (no priority — the selector dispatches them directly) get the
# dedicated "io" band.
PRIORITY_BANDS = (
    (TaskPriority.MAX, "max"),
    (TaskPriority.COORDINATION, "coordination"),
    (TaskPriority.RESOLVER, "resolver"),
    (TaskPriority.TLOG_COMMIT, "tlog_commit"),
    (TaskPriority.PROXY_COMMIT, "proxy_commit"),
    (TaskPriority.DEFAULT, "default"),
    (TaskPriority.STORAGE, "storage"),
    (TaskPriority.LOW, "low"),
    (TaskPriority.ZERO, "zero"),
)

BAND_ORDER = tuple(name for _thresh, name in PRIORITY_BANDS) + ("io",)


def band_of(priority: int) -> str:
    for thresh, name in PRIORITY_BANDS:
        if priority >= thresh:
            return name
    return "zero"


class _ActorStats:
    __slots__ = ("name", "steps", "busy", "max_busy")

    def __init__(self, name: str):
        self.name = name
        self.steps = 0
        self.busy = 0.0
        self.max_busy = 0.0


class LoopProfiler:
    """Per-loop callback attribution. Installed as ``loop.profiler`` by the
    world constructors (net/sim.py Sim, net/tcp.py RealWorld) behind the
    ``RUN_LOOP_PROFILER`` knob; the loops call ``run_task``/``run_io``/
    ``select_done`` on the hot path, everything else is pull-only."""

    def __init__(self, loop, knobs=None, wall: bool = True, ident: str = ""):
        import time as _time

        self.loop = loop
        self.wall = wall  # True = real personality: SlowTask trace events
        self.ident = ident
        # distinguishes distinct loops behind identical per-process
        # snapshots (every sim process shares ONE loop; status consumers
        # dedupe on this before summing)
        self.loop_id = f"loop-{id(loop):x}"
        self._slow_s = (
            getattr(knobs, "RUN_LOOP_SLOW_TASK_MS", 50.0) or 50.0
        ) / 1000.0
        self._sample_hz = getattr(knobs, "PROFILER_SAMPLE_HZ", 100.0)
        # measurement clock: a REFERENCE latched once (dependency-injection
        # shape); measured durations never feed back into scheduling
        self._clock = _time.perf_counter  # flowlint: disable=det-wall-clock
        self._t_start = self._clock()
        self._busy_total = 0.0
        self.actors: dict[str, _ActorStats] = {}
        # the worker-level CounterCollection behind process.metrics: only
        # loop-derived values live in it, so the periodic RunLoopMetrics
        # trace events are byte-deterministic on the sim personality
        self.stats = CounterCollection("RunLoop", ident)
        self._c_steps = self.stats.counter("steps")
        self._c_slow = self.stats.counter("slowTasks")
        self._c_io = self.stats.counter("ioCallbacks")
        self._c_selects = self.stats.counter("selects")
        self.stats.gauge("queueDepth", lambda: len(loop._queue))
        self._sel_sample = self.stats.latency("selectSeconds")
        # band name → [busy_seconds, steps, starvation LatencySample]
        self._bands: dict[str, list] = {}
        for name in BAND_ORDER:
            self._bands[name] = [
                0.0,
                0,
                self.stats.latency(f"starvation_{name}"),
            ]
        self._band_cache: dict[int, list] = {}  # priority → band record
        self._band_names: dict[int, str] = {}
        self.flame: Optional[FlameProfiler] = None
        self._trace_loop_claimed = False

    # -- hot path (called by the loops around every callback) ------------------

    def run_task(self, fn, owner: Optional[str], priority: int, lag: float) -> None:
        """Execute one queued callback under attribution. ``owner`` is the
        scheduling actor's qualname (None for plain timers/posted work);
        ``lag`` is schedule→run latency — virtual on the sim loop (where it
        is deterministically ~0: virtual time warps straight to the due
        time), wall on the real loop (genuine starvation)."""
        band = self._band_cache.get(priority)
        if band is None:
            name = band_of(priority)
            band = self._band_cache[priority] = self._bands[name]
            self._band_names[priority] = name
        band[1] += 1
        band[2].add(lag)
        self._c_steps.value += 1
        clock = self._clock
        t0 = clock()
        try:
            fn()
        finally:
            busy = clock() - t0
            self._busy_total += busy
            band[0] += busy
            name = owner or getattr(fn, "__qualname__", "") or "callback"
            a = self.actors.get(name)
            if a is None:
                a = self.actors[name] = _ActorStats(name)
            a.steps += 1
            a.busy += busy
            if busy > a.max_busy:
                a.max_busy = busy
            if busy >= self._slow_s and self.wall:
                self._slow_task(name, busy, priority)

    def run_io(self, cb) -> None:
        """One selector-readiness callback (real personality only)."""
        band = self._bands["io"]
        self._c_io.value += 1
        clock = self._clock
        t0 = clock()
        try:
            cb()
        finally:
            busy = clock() - t0
            self._busy_total += busy
            band[0] += busy
            band[1] += 1
            name = getattr(cb, "__qualname__", "") or "io"
            a = self.actors.get(name)
            if a is None:
                a = self.actors[name] = _ActorStats(name)
            a.steps += 1
            a.busy += busy
            if busy > a.max_busy:
                a.max_busy = busy
            if busy >= self._slow_s and self.wall:
                self._slow_task(name, busy, -1)

    def select_done(self, dt: float) -> None:
        """One select()/poll() block on the real loop."""
        self._c_selects.value += 1
        self._sel_sample.add(dt)

    def _slow_task(self, name: str, busy: float, priority: int) -> None:
        from .trace import SevWarn, trace

        self._c_slow.value += 1
        trace(
            SevWarn,
            "SlowTask",
            self.ident,
            Actor=name,
            BusyMs=round(busy * 1000.0, 3),
            Priority=priority,
            Band="io" if priority < 0 else self._band_names.get(
                priority, band_of(priority)
            ),
        )

    # -- snapshots --------------------------------------------------------------

    def busy_fraction(self) -> float:
        """Lifetime on-CPU fraction of this loop (wall-measured)."""
        return self._busy_total / max(self._clock() - self._t_start, 1e-9)

    def snapshot(self, top: int = 10) -> dict:
        """The ``run_loop`` section (process.metrics endpoint / status):
        loop totals, per-band busy fraction + starvation percentiles, and
        the hottest actors by on-CPU time. Wall fields (busy/elapsed) are
        evidence, not sim state — only the step counters are deterministic
        on the sim personality."""
        elapsed = max(
            self._clock() - self._t_start, 1e-9
        )
        bands = {}
        for name in BAND_ORDER:
            busy, steps, sample = self._bands[name]
            bands[name] = {
                "steps": steps,
                "busy_seconds": round(busy, 6),
                "busy_fraction": round(busy / elapsed, 6),
                "starvation": sample.snapshot(),
            }
        hot = sorted(
            self.actors.values(), key=lambda a: (-a.busy, -a.steps, a.name)
        )[:top]
        return {
            "loop_id": self.loop_id,
            "personality": "real" if self.wall else "sim",
            "steps": self._c_steps.value,
            "io_callbacks": self._c_io.value,
            "slow_tasks": self._c_slow.value,
            "busy_seconds": round(self._busy_total, 6),
            "elapsed_seconds": round(elapsed, 3),
            "busy_fraction": round(self._busy_total / elapsed, 6),
            "queue_depth": len(self.loop._queue),
            "select_seconds": self._sel_sample.snapshot(),
            "bands": bands,
            "hot_actors": [
                {
                    "name": a.name,
                    "steps": a.steps,
                    "busy_seconds": round(a.busy, 6),
                    "max_ms": round(a.max_busy * 1000.0, 3),
                }
                for a in hot
            ],
        }

    async def ensure_trace_loop(self, interval: float, process: str):
        """Periodic RunLoopMetrics trace events — claimed by the FIRST
        worker on the loop (every sim process shares one loop; two trace
        loops would fight over the counters' interval state)."""
        if self._trace_loop_claimed:
            return
        self._trace_loop_claimed = True
        await self.stats.trace_loop(interval, process)

    # -- flame sampling ---------------------------------------------------------

    def flame_start(self, hz: Optional[float] = None) -> "FlameProfiler":
        """Start (or restart) sampling the CALLING thread's stack — the
        loop thread, since only loop code calls this."""
        if self.flame is not None:
            self.flame.stop()
        self.flame = FlameProfiler(hz or self._sample_hz)
        self.flame.start()
        return self.flame

    def flame_stop(self) -> str:
        """Stop the sampler and return the folded stacks collected."""
        if self.flame is None:
            return ""
        folded = self.flame.stop()
        self.flame = None
        return folded


class FlameProfiler:
    """Sampling stack profiler for the loop thread (the analog of
    flow/Profiler.actor.cpp's SIGPROF sampler, portable via a daemon
    thread + ``sys._current_frames``). Output is folded-stack lines
    (``file:func;file:func;... count``) consumable by flamegraph.pl and
    speedscope. The sampler never touches loop state — it only *reads*
    frames, so it is safe to run against either personality."""

    def __init__(self, hz: float = 100.0, thread_id: Optional[int] = None):
        self.hz = max(float(hz), 1.0)
        self.thread_id = thread_id if thread_id is not None else threading.get_ident()
        self.samples = 0
        self._counts: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="flame-sampler", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        interval = 1.0 / self.hz
        counts = self._counts
        # Event.wait paces the sampler on ITS OWN thread; the loop thread
        # never blocks on the sampler
        while not self._stop.wait(interval):
            frame = sys._current_frames().get(self.thread_id)
            if frame is None:
                continue
            stack = []
            while frame is not None:
                code = frame.f_code
                fname = code.co_filename
                cut = fname.rfind("/")
                stack.append(f"{fname[cut + 1:]}:{code.co_name}")
                frame = frame.f_back
            key = ";".join(reversed(stack))
            counts[key] = counts.get(key, 0) + 1
            self.samples += 1

    def stop(self) -> str:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._thread = None
        return self.folded()

    def folded(self) -> str:
        """Collapsed-stack lines, hottest first — flamegraph.pl /
        speedscope input format."""
        return "\n".join(
            f"{stack} {n}"
            for stack, n in sorted(
                self._counts.items(), key=lambda kv: (-kv[1], kv[0])
            )
        )


def install(loop, knobs=None, wall: bool = True, ident: str = "") -> Optional[LoopProfiler]:
    """Attach a LoopProfiler to ``loop`` if the knob allows and none is
    installed yet (several RealWorlds may share one loop — first wins, and
    a world must never displace a profiler that has been accumulating)."""
    if knobs is not None and not getattr(knobs, "RUN_LOOP_PROFILER", True):
        return getattr(loop, "profiler", None)
    if getattr(loop, "profiler", None) is None:
        loop.profiler = LoopProfiler(loop, knobs=knobs, wall=wall, ident=ident)
    return loop.profiler
