"""Counters, rates, and latency samples — the analog of flow/Stats.h.

The reference instruments every role with `Counter`s grouped into a
`CounterCollection` traced periodically (flow/Stats.h:55-63 Counter /
:101 CounterCollection; fdbserver/MasterProxyServer.actor.cpp:60
ProxyStats, fdbserver/storageserver.actor.cpp:510 StorageServerMetrics).
This module provides the same three primitives, loop-agnostic (sim or
real time):

- ``Counter``: monotonically growing total with per-interval delta, so a
  trace shows both lifetime totals and current rate.
- ``LatencySample``: bounded reservoir of durations answering p50/p95/p99
  (the reference's LatencyBands / Sample, flow/Stats.h:140).
- ``CounterCollection``: a named group; ``trace_loop()`` emits one trace
  event per interval with every counter's total+rate and every sample's
  percentiles, then resets interval state. ``snapshot()`` returns the
  same data as a dict for the status document (Status.actor.cpp pulls
  role metrics the same way).
"""

from __future__ import annotations

import random
from typing import Optional

from .loop import now
from .trace import SevInfo, trace


class Counter:
    __slots__ = ("name", "value", "_interval_start")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._interval_start = 0

    def add(self, n: int = 1) -> None:
        self.value += n

    def __iadd__(self, n: int) -> "Counter":
        self.value += n
        return self

    @property
    def interval_delta(self) -> int:
        return self.value - self._interval_start

    def reset_interval(self) -> None:
        self._interval_start = self.value


class LatencySample:
    """Reservoir sample of durations (seconds). Bounded memory; exact
    percentiles while under capacity, uniform reservoir beyond it.

    The reservoir is sorted lazily, at most once per run of reads: every
    percentile/snapshot call reuses one cached sorted buffer until the
    next ``add`` dirties it (a snapshot used to re-sort three times —
    once per percentile — which made a busy status pull O(3·n log n) per
    sample)."""

    __slots__ = ("name", "cap", "count", "_buf", "_rnd", "_sorted")

    def __init__(self, name: str, cap: int = 1024, seed: int = 0):
        self.name = name
        self.cap = cap
        self.count = 0
        self._buf: list[float] = []
        self._rnd = random.Random(seed)
        self._sorted: list[float] = None  # cache; None = dirty

    def add(self, dt: float) -> None:
        self.count += 1
        self._sorted = None
        if len(self._buf) < self.cap:
            self._buf.append(dt)
        else:
            i = self._rnd.randrange(self.count)
            if i < self.cap:
                self._buf[i] = dt

    def _sorted_buf(self) -> list[float]:
        if self._sorted is None:
            self._sorted = sorted(self._buf)
        return self._sorted

    def percentile(self, p: float) -> float:
        if not self._buf:
            return 0.0
        s = self._sorted_buf()
        return s[min(int(len(s) * p), len(s) - 1)]

    def snapshot(self) -> dict:
        # one sort serves all three percentiles
        s = self._sorted_buf()
        n = len(s)

        def pick(p: float) -> float:
            return s[min(int(n * p), n - 1)] if n else 0.0

        return {
            "count": self.count,
            "p50": round(pick(0.5), 6),
            "p95": round(pick(0.95), 6),
            "p99": round(pick(0.99), 6),
        }

    @staticmethod
    def merge(snaps: list) -> dict:
        """Aggregate sample snapshots from many loops/roles: counts sum,
        percentiles take the WORST (a cluster-wide p99 cannot be computed
        from per-role percentiles, but the worst observed band is exactly
        what an operator scanning for starvation wants)."""
        out = {"count": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        for s in snaps:
            if not s:
                continue
            out["count"] += s.get("count") or 0
            for k in ("p50", "p95", "p99"):
                out[k] = max(out[k], s.get(k) or 0.0)
        return out


# default band edges (seconds) — the reference's LatencyBands knob
# thresholds scaled to this system's sim/TCP latency envelope: sub-ms
# fast path through multi-second stalls
DEFAULT_BAND_EDGES = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.1, 0.5, 2.0)


class LatencyBands:
    """Fixed-threshold latency histogram (flow/Stats.h LatencyBands /
    fdbserver's GRV+commit+read latency bands): each request lands in the
    first band whose upper edge covers it, overflow in ``inf``. Unlike the
    reservoir LatencySample this never forgets — band counts are exact
    over the role's lifetime, which is what per-endpoint SLO accounting
    needs."""

    __slots__ = ("name", "edges", "counts", "overflow", "count")

    def __init__(self, name: str, edges: tuple = DEFAULT_BAND_EDGES):
        self.name = name
        self.edges = tuple(edges)
        self.counts = [0] * len(self.edges)
        self.overflow = 0
        self.count = 0

    def add(self, dt: float) -> None:
        self.count += 1
        for i, edge in enumerate(self.edges):
            if dt <= edge:
                self.counts[i] += 1
                return
        self.overflow += 1

    def snapshot(self) -> dict:
        bands = {f"{edge:g}": n for edge, n in zip(self.edges, self.counts)}
        bands["inf"] = self.overflow
        return {"count": self.count, "bands": bands}

    @staticmethod
    def merge(snaps: list) -> dict:
        """Aggregate band snapshots from many roles (the status document
        sums per-endpoint bands cluster-wide)."""
        total = 0
        bands: dict[str, int] = {}
        for s in snaps:
            if not s:
                continue
            total += s.get("count", 0)
            for edge, n in (s.get("bands") or {}).items():
                bands[edge] = bands.get(edge, 0) + n
        return {"count": total, "bands": bands}


class CounterCollection:
    """A role's counters + samples, traced as one periodic event
    (CounterCollection::logToTraceEvent, flow/Stats.cpp)."""

    def __init__(self, name: str, ident: str = ""):
        self.name = name
        self.id = ident
        self.counters: dict[str, Counter] = {}
        self.samples: dict[str, LatencySample] = {}
        self.band_sets: dict[str, LatencyBands] = {}
        self.gauges: dict[str, object] = {}  # name → zero-arg callable
        self._last_trace = None
        self.history = None  # MetricsHistory ring, see ensure_history()

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def latency(self, name: str, cap: int = 1024) -> LatencySample:
        s = self.samples.get(name)
        if s is None:
            s = self.samples[name] = LatencySample(name, cap)
        return s

    def bands(self, name: str, edges: tuple = DEFAULT_BAND_EDGES) -> LatencyBands:
        b = self.band_sets.get(name)
        if b is None:
            b = self.band_sets[name] = LatencyBands(name, edges)
        return b

    def gauge(self, name: str, fn) -> None:
        """Register a zero-arg callable polled at snapshot/trace time
        (the reference's SpecialCounter, flow/Stats.h:121)."""
        self.gauges[name] = fn

    def snapshot(self, elapsed: Optional[float] = None) -> dict:
        out: dict = {"name": self.name, "id": self.id}
        for n, c in self.counters.items():
            out[n] = c.value
            if elapsed and elapsed > 0:
                out[n + "_hz"] = round(c.interval_delta / elapsed, 2)
        for n, s in self.samples.items():
            out[n] = s.snapshot()
        for n, b in self.band_sets.items():
            out[n] = b.snapshot()
        for n, fn in self.gauges.items():
            try:
                out[n] = fn()
            except Exception:
                out[n] = None
        return out

    def trace_now(self, process: str = "") -> dict:
        t = now()
        elapsed = None if self._last_trace is None else t - self._last_trace
        snap = self.snapshot(elapsed)
        self._last_trace = t
        for c in self.counters.values():
            c.reset_interval()
        trace(
            SevInfo,
            f"{self.name}Metrics",
            process,
            ID=self.id,
            Elapsed=round(elapsed, 3) if elapsed is not None else None,
            **{k: v for k, v in snap.items() if k not in ("name", "id")},
        )
        return snap

    async def trace_loop(self, interval: float = 5.0, process: str = ""):
        """Actor: trace this collection every ``interval`` seconds — the
        per-role metrics logger every reference role runs
        (e.g. masterProxyServerCore's traceRole counters)."""
        from .futures import delay

        self._last_trace = now()
        while True:
            await delay(interval)
            self.trace_now(process)

    def ensure_history(self, capacity: int) -> "object":
        """Attach (or resize lazily — capacity changes only apply to a
        fresh ring) the bounded metrics-history ring."""
        if self.history is None:
            from .timeseries import MetricsHistory

            self.history = MetricsHistory(capacity)
        return self.history

    def record_history(self, t: Optional[float] = None) -> None:
        """Snapshot numeric counters/gauges into the history ring now.
        No-op until ensure_history() has been called."""
        if self.history is None:
            return
        self.history.record(now() if t is None else t, self.snapshot())

    async def history_loop(self, knobs):
        """Actor: feed the metrics-history ring at the knob-set cadence
        (METRICS_HISTORY_INTERVAL / METRICS_HISTORY_SAMPLES). Gated on
        METRICS_HISTORY_ENABLED so the overhead-sensitive path can turn
        the whole subsystem off with one knob."""
        from .futures import delay

        if not getattr(knobs, "METRICS_HISTORY_ENABLED", True):
            return
        self.ensure_history(int(knobs.METRICS_HISTORY_SAMPLES))
        interval = float(knobs.METRICS_HISTORY_INTERVAL)
        while True:
            await delay(interval)
            self.record_history()
