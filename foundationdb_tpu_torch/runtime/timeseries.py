"""Bounded metrics history: a ring buffer of CounterCollection
snapshots, so "what did this counter look like 60s ago" has an answer
without replaying a trace file.

The reference keeps its per-role counters only as periodic trace events;
operators reconstruct timelines offline (contrib's monitoring pollers).
Here every CounterCollection can own a MetricsHistory that a host loop
(`CounterCollection.history_loop`) feeds at a knob-set cadence
(METRICS_HISTORY_INTERVAL / METRICS_HISTORY_SAMPLES); the worker's
`worker.metricsHistory` endpoint, `cli metrics <role> <counter>` and
`tools/trace_analyze --timeline` read it back.

Only numeric scalars are retained — gauge lists and latency/band dicts
are dropped at record time so a full ring stays a few KB per role. Time
is always passed IN (the sim's model clock or the real loop's), never
read here: the module stays flowlint-deterministic by construction.
"""

from __future__ import annotations

from collections import deque


class MetricsHistory:
    """Fixed-capacity ring of ``(t, {name: value})`` snapshots."""

    __slots__ = ("capacity", "_buf")

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._buf: deque = deque(maxlen=self.capacity)

    def __len__(self) -> int:
        return len(self._buf)

    def record(self, t: float, snapshot: dict) -> None:
        """Append one snapshot, keeping only numeric scalar fields (bools
        excluded: they are flags, not series)."""
        vals = {
            k: v
            for k, v in snapshot.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        self._buf.append((t, vals))

    def points(self) -> list:
        """[(t, {name: value})] oldest → newest."""
        return list(self._buf)

    def series(self, name: str) -> list:
        """[(t, value)] for one counter, skipping snapshots without it."""
        return [(t, vals[name]) for t, vals in self._buf if name in vals]

    def names(self) -> list:
        """Every counter name seen anywhere in the ring (sorted)."""
        seen: set = set()
        for _t, vals in self._buf:
            seen.update(vals)
        return sorted(seen)

    def to_dict(self) -> dict:
        """Wire/JSON shape for the `*.metricsHistory` endpoints."""
        return {
            "capacity": self.capacity,
            "points": [[t, dict(vals)] for t, vals in self._buf],
        }

    @staticmethod
    def from_dict(d: dict) -> "MetricsHistory":
        h = MetricsHistory(d.get("capacity") or 1)
        for t, vals in d.get("points") or []:
            h._buf.append((t, dict(vals)))
        return h
