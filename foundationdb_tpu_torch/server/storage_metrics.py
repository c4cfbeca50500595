"""Keyspace telemetry for a storage server — the analog of
fdbserver/StorageMetrics.actor.h.

The reference never range-scans to learn how big or how hot a shard is:
every applied mutation is *byte-sampled* with probability proportional
to its size (StorageServerMetrics::byteSample), so per-range byte counts
are answered by summing a sparse sample in O(sampled keys) instead of
O(all keys); bandwidth and op rates come from short sampled windows; and
`getReadHotRanges` buckets the byte sample and ranks buckets by
read-bytes ÷ size density. Data distribution then *subscribes* rather
than polls: `waitMetrics` parks a reply until the estimate leaves a
caller-set [min, max] band (StorageMetrics.actor.h waitMetrics /
DataDistributionTracker.actor.cpp:829 trackShardBytes).

This module is that sensor, sim/real agnostic:

- ``StorageServerMetrics``: owns the byte sample (dict + sorted key
  list), the cumulative read sample, the rolling write windows, and the
  waitMetrics subscription list. The storage server calls
  ``on_set``/``on_clear_key``/``on_clear_range``/``on_epoch`` from its
  mutation-apply paths and ``on_read`` from its read paths; DD calls
  ``wait_metrics`` through the `storage.waitMetrics` endpoint.
- Determinism: the sampling RNG is a private ``DeterministicRandom``
  whose seed is *derived* from the hosting loop's seed + the server's
  identity (uid/tag) — it never consumes the sim stream, so arming or
  disarming sampling cannot perturb a pinned-seed run, and same-seed
  runs produce byte-identical sample sets (as the seeded span and profiler streams).
  Exactly one RNG draw happens per sampled-set decision regardless of
  outcome, so the draw count is a pure function of the mutation stream.
"""

from __future__ import annotations

import zlib
from bisect import bisect_left, bisect_right, insort
from typing import Optional

from ..runtime.futures import Future
from ..runtime.loop import current_loop, now
from ..runtime.rng import DeterministicRandom

END_KEY = b"\xff\xff"


def derive_metrics_seed(uid: str, tag: int) -> int:
    """Seed for a server's sampling RNG: loop seed mixed with identity.

    Reads (never draws from) the hosting loop's RNG so the sim stream is
    untouched; falls back to identity-only when constructed outside a
    loop (unit tests build a bare StorageServerMetrics)."""
    try:
        base = current_loop().random.seed
    except Exception:
        base = 0
    return (base * 1000003 + zlib.crc32(uid.encode()) + tag * 8191) & ((1 << 63) - 1)


class _WaitMetricsSub:
    """One parked waitMetrics subscription: a threshold band plus an
    incrementally-maintained byte estimate for the watched range."""

    __slots__ = ("begin", "end", "min_bytes", "max_bytes", "bytes", "future")

    def __init__(self, begin: bytes, end: bytes, min_bytes: int, max_bytes: int, bytes_now: int):
        self.begin = begin
        self.end = end
        self.min_bytes = min_bytes
        self.max_bytes = max_bytes
        self.bytes = bytes_now
        self.future: Future = Future()

    def covers(self, key: bytes) -> bool:
        return self.begin <= key < self.end

    def crossed(self) -> bool:
        return self.bytes < self.min_bytes or self.bytes > self.max_bytes


class StorageServerMetrics:
    """Per-storage-server sampled keyspace telemetry.

    Counter hooks are optional (``None`` in bare unit-test construction);
    when provided they are the literal counters pinned by flowlint's
    ``role_required_counters`` on the storage role.
    """

    def __init__(
        self,
        knobs,
        seed: int = 0,
        *,
        c_bytes_sampled=None,
        c_hot_range_checks=None,
        c_wait_metrics_fired=None,
    ):
        self.knobs = knobs
        self.rng = DeterministicRandom(seed)
        self.enabled = bool(getattr(knobs, "STORAGE_METRICS_SAMPLING", True))
        # byte sample: key → sampled weight (bytes, bias-corrected), plus
        # a parallel sorted key list for range queries / bucketing
        self._sample: dict[bytes, int] = {}
        self._keys: list[bytes] = []
        # cumulative read sample: key → sampled read-bytes weight
        self._read: dict[bytes, float] = {}
        self._read_keys: list[bytes] = []
        # rolling write windows for bandwidth/ops: key → [bytes_w, ops_w]
        self._w_cur: dict[bytes, list] = {}
        self._w_prev: dict[bytes, list] = {}
        self._w_t0: float = 0.0
        self._subs: list[_WaitMetricsSub] = []
        self._c_bytes_sampled = c_bytes_sampled
        self._c_hot_range_checks = c_hot_range_checks
        self._c_wait_metrics_fired = c_wait_metrics_fired

    # ---- byte sample ---------------------------------------------------

    def _sample_weight(self, size: int) -> int:
        """One RNG draw, always: returns the bias-corrected sampled
        weight for a value of ``size`` bytes, or 0 if not sampled. The
        unconditional draw keeps the stream position a function of the
        mutation sequence alone (byteSample's a-priori coin)."""
        factor = max(1, int(self.knobs.STORAGE_BYTE_SAMPLE_FACTOR))
        p = min(1.0, size / factor)
        hit = self.rng.random01() < p
        if not hit:
            return 0
        return max(1, int(size / p))

    def _drop_sampled(self, key: bytes) -> int:
        old = self._sample.pop(key, None)
        if old is None:
            return 0
        i = bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            del self._keys[i]
        return old

    def on_set(self, key: bytes, value_len: int) -> None:
        if not self.enabled:
            return
        size = len(key) + value_len
        delta = -self._drop_sampled(key)
        w = self._sample_weight(size)
        if w:
            self._sample[key] = w
            insort(self._keys, key)
            delta += w
            if self._c_bytes_sampled is not None:
                self._c_bytes_sampled.add(w)
        self._note_write(key, size)
        if delta:
            self._notify(key, delta)

    def on_clear_key(self, key: bytes) -> None:
        if not self.enabled:
            return
        old = self._drop_sampled(key)
        self._note_write(key, len(key))
        if old:
            self._notify(key, -old)

    def on_clear_range(self, begin: bytes, end: Optional[bytes]) -> None:
        if not self.enabled:
            return
        end = END_KEY if end is None else end
        lo = bisect_left(self._keys, begin)
        hi = bisect_left(self._keys, end)
        if hi > lo:
            dropped = self._keys[lo:hi]
            del self._keys[lo:hi]
            for k in dropped:
                old = self._sample.pop(k, 0)
                if old:
                    self._notify(k, -old)
        self._note_write(begin, len(begin) + len(end))

    def on_epoch(self, entries: dict, clears: list) -> None:
        """Batch hook for the epoch apply path: ``clears`` is a list of
        (begin, end) ranges, ``entries`` maps key → value-or-None (None
        is a compare-and-clear tombstone)."""
        if not self.enabled:
            return
        for begin, end in clears:
            self.on_clear_range(begin, end)
        for key, value in entries.items():
            if value is None:
                self.on_clear_key(key)
            else:
                self.on_set(key, len(value))

    def sample_bytes(self, begin: bytes, end: Optional[bytes] = None) -> int:
        """Estimated logical bytes in [begin, end) from the byte sample."""
        end = END_KEY if end is None else end
        lo = bisect_left(self._keys, begin)
        hi = bisect_left(self._keys, end)
        s = self._sample
        return sum(s[k] for k in self._keys[lo:hi])

    def sample_entries(self) -> int:
        return len(self._sample)

    # ---- read sample ---------------------------------------------------

    def on_read(self, key: bytes, nbytes: int) -> None:
        """Sampled cumulative read-byte accounting (the read-hot input).

        Cumulative (never expires) so hot-range density survives idle
        gaps between workload and inspection; bounded by smallest-weight
        eviction at STORAGE_READ_SAMPLE_MAX_KEYS."""
        if not self.enabled or nbytes <= 0:
            return
        factor = max(1, int(self.knobs.STORAGE_READ_SAMPLE_FACTOR))
        p = min(1.0, nbytes / factor)
        hit = self.rng.random01() < p
        if not hit:
            return
        w = nbytes / p
        if key in self._read:
            self._read[key] += w
        else:
            cap = int(self.knobs.STORAGE_READ_SAMPLE_MAX_KEYS)
            if len(self._read) >= cap:
                victim = min(self._read, key=self._read.get)
                del self._read[victim]
                i = bisect_left(self._read_keys, victim)
                if i < len(self._read_keys) and self._read_keys[i] == victim:
                    del self._read_keys[i]
            self._read[key] = w
            insort(self._read_keys, key)
        self._note_read_rate(nbytes)

    def read_sample_bytes(self, begin: bytes, end: bytes) -> float:
        lo = bisect_left(self._read_keys, begin)
        hi = bisect_left(self._read_keys, end)
        r = self._read
        return sum(r[k] for k in self._read_keys[lo:hi])

    # ---- bandwidth / ops windows ---------------------------------------

    def _maybe_roll(self, t: float) -> None:
        w = float(self.knobs.STORAGE_METRICS_WINDOW)
        if self._w_t0 == 0.0:
            self._w_t0 = t
            return
        if t - self._w_t0 >= 2 * w:
            self._w_cur.clear()
            self._w_prev.clear()
            self._w_t0 = t
        elif t - self._w_t0 >= w:
            self._w_prev = self._w_cur
            self._w_cur = {}
            self._w_t0 += w

    def _note_write(self, key: bytes, size: int) -> None:
        t = now()
        self._maybe_roll(t)
        ent = self._w_cur.get(key)
        if ent is None:
            self._w_cur[key] = [size, 1]
        else:
            ent[0] += size
            ent[1] += 1

    def _note_read_rate(self, nbytes: int) -> None:
        t = now()
        self._maybe_roll(t)
        ent = self._w_cur.get(b"")
        # read rate rides the same window structure under a reserved key
        if ent is None:
            self._w_cur[b""] = [0, 0, nbytes]
        elif len(ent) == 2:
            ent.append(nbytes)
        else:
            ent[2] += nbytes

    def _window_rates(self, begin: bytes, end: bytes) -> tuple:
        t = now()
        self._maybe_roll(t)
        w = float(self.knobs.STORAGE_METRICS_WINDOW)
        elapsed = w + max(0.0, t - self._w_t0)
        wbytes = ops = rbytes = 0.0
        for window in (self._w_prev, self._w_cur):
            for key, ent in window.items():
                if key == b"":
                    if len(ent) > 2:
                        rbytes += ent[2]
                    continue
                if begin <= key < end:
                    wbytes += ent[0]
                    ops += ent[1]
        return wbytes / elapsed, ops / elapsed, rbytes / elapsed

    # ---- range metrics + waitMetrics subscriptions ---------------------

    def range_metrics(self, begin: bytes, end: Optional[bytes] = None) -> dict:
        end = END_KEY if end is None else end
        bps, ops, rbps = self._window_rates(begin, end)
        return {
            "bytes": self.sample_bytes(begin, end),
            "bytes_per_second": round(bps, 2),
            "ops_per_second": round(ops, 2),
            "read_bytes_per_second": round(rbps, 2),
            "sampled": True,
        }

    def wait_metrics(self, begin: bytes, end: Optional[bytes], min_bytes: int, max_bytes: int) -> Future:
        """Park until the sampled byte estimate for [begin, end) leaves
        [min_bytes, max_bytes]; reply immediately if already outside
        (StorageMetrics.actor.h waitMetrics). Returns a Future settled
        with a ``range_metrics`` dict."""
        if self._subs:
            self.drop_cancelled_subs()
        end = END_KEY if end is None else end
        est = self.sample_bytes(begin, end)
        if est < min_bytes or est > max_bytes:
            f = Future()
            f._set(self.range_metrics(begin, end))
            if self._c_wait_metrics_fired is not None:
                self._c_wait_metrics_fired.add()
            return f
        # a re-arm for the same range replaces the older parked sub (the
        # caller timed out and came back, or a new DD took over): settle
        # the displaced one — a parked handler must not leak, and a live
        # caller treats any reply as a fresh estimate to re-band around
        for old in [s for s in self._subs if s.begin == begin and s.end == end]:
            self._subs.remove(old)
            if not old.future.is_ready():
                old.future._set(self.range_metrics(old.begin, old.end))
        sub = _WaitMetricsSub(begin, end, min_bytes, max_bytes, est)
        self._subs.append(sub)
        return sub.future

    def wait_active(self) -> int:
        return len(self._subs)

    def _notify(self, key: bytes, delta: int) -> None:
        """Per-sampled-mutation incremental update of parked bands; fires
        any subscription whose estimate crossed its threshold."""
        if not self._subs:
            return
        fired = None
        for sub in self._subs:
            if not sub.covers(key):
                continue
            sub.bytes += delta
            if sub.crossed():
                if fired is None:
                    fired = []
                fired.append(sub)
        if not fired:
            return
        for sub in fired:
            self._subs.remove(sub)
            if not sub.future.is_ready():  # cancelled by a timed-out caller?
                sub.future._set(self.range_metrics(sub.begin, sub.end))
                if self._c_wait_metrics_fired is not None:
                    self._c_wait_metrics_fired.add()

    def drop_cancelled_subs(self) -> None:
        """GC subscriptions whose callers went away (cancelled futures)."""
        self._subs = [s for s in self._subs if not s.future.is_ready()]

    # ---- read-hot ranges -----------------------------------------------

    def read_hot_ranges(self, top: int = 8) -> list:
        """Bucket the byte sample every STORAGE_HOT_RANGE_BUCKET_SAMPLES
        keys and rank buckets by read-bytes ÷ size density, the shape of
        the reference's getReadHotRanges. Returns
        [{begin, end, density, read_bytes, bytes}] sorted hottest-first."""
        bucket_n = max(1, int(self.knobs.STORAGE_HOT_RANGE_BUCKET_SAMPLES))
        ks = self._keys
        bounds = [b""] + ks[bucket_n::bucket_n] + [END_KEY]
        out = []
        for b, e in zip(bounds, bounds[1:]):
            if b >= e:
                continue
            size = self.sample_bytes(b, e)
            read_bytes = self.read_sample_bytes(b, e)
            if self._c_hot_range_checks is not None:
                self._c_hot_range_checks.add()
            if read_bytes <= 0:
                continue
            density = read_bytes / max(size, 1)
            out.append(
                {
                    "begin": b,
                    "end": e,
                    "density": density,
                    "read_bytes": read_bytes,
                    "bytes": size,
                }
            )
        out.sort(key=lambda r: r["density"], reverse=True)
        return out[:top]

    def hot_ranges_status(self, n: Optional[int] = None) -> list:
        """JSON/trace-safe hot-range list for the status document: keys
        decoded to str, densities rounded, filtered to ranges hotter
        than STORAGE_HOT_RANGE_MIN_DENSITY."""
        if n is None:
            n = int(self.knobs.STORAGE_HOT_RANGE_STATUS_N)
        min_density = float(self.knobs.STORAGE_HOT_RANGE_MIN_DENSITY)
        out = []
        for r in self.read_hot_ranges(top=n):
            if r["density"] < min_density:
                continue
            out.append(
                {
                    "begin": r["begin"].decode("utf-8", "replace"),
                    "end": r["end"].decode("utf-8", "replace"),
                    "density": round(r["density"], 2),
                    "read_bytes": int(r["read_bytes"]),
                    "bytes": int(r["bytes"]),
                }
            )
        return out
