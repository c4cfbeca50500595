"""Proxy-side conflict pre-filter: a decaying summary of recently
committed write ranges.

Each proxy keeps a cheap, strictly-conservative picture of what the
resolvers have recently committed, fed from committed-write-range
feedback piggybacked on every ``ResolveBatchReply``. Before a
transaction joins a commit batch, the proxy probes this summary with the
transaction's read conflict ranges: if a *stored* committed range
provably overlaps a read at a version newer than the read snapshot, the
resolver is guaranteed to convict the transaction (its history only ever
contains MORE than this summary), so the proxy fails it locally with the
normal retryable ``not_committed`` — skipping the version grant, the
resolver codec round, and the tlog push the doomed transaction would
otherwise pay for.

Structure: a coarse interval bloom over key prefixes. Ranges whose
``[begin, end)`` stays within one ``PREFILTER_PREFIX_LEN``-byte prefix
live as exact ``(begin, end, version)`` entries in that prefix's bucket;
ranges spanning prefixes go on a small *wide* side list. Each bucket
additionally tracks the max committed version it has ever seen
(``ceiling``) as a cheap first-pass screen. A check probes only the
buckets of the read range's two endpoint prefixes plus the wide list —
reads spanning many buckets may miss entries in the middle, which is
fine: misses are free (the resolver still convicts), false rejections
are not.

Conservativeness invariant (the in-sim oracle differential in
runtime/validation.py re-proves this on every rejection): every
path that LOSES information — bucket-entry eviction, whole-bucket
eviction, wide-list overflow, version-floor decay, feedback truncation,
``reset()`` — only produces false NEGATIVES. A rejection requires an
exact stored entry ``(b, e, v)`` with ``b < read_end and read_begin < e``
(the same half-open overlap the authoritative conflict set uses) and
``v > read_snapshot``.
"""

from __future__ import annotations

from collections import OrderedDict, deque

from ..runtime.stats import CounterCollection


def _strinc(prefix: bytes):
    """First key after the range of keys with this prefix, or None if
    there is none (prefix is all 0xff — the range is open-ended)."""
    p = prefix.rstrip(b"\xff")
    if not p:
        return None
    return p[:-1] + bytes([p[-1] + 1])


class _Bucket:
    __slots__ = ("entries", "ceiling", "touched")

    def __init__(self, cap: int):
        # (begin, end, version), oldest first; overflow pops oldest
        self.entries: deque = deque(maxlen=cap)
        # max committed version ever recorded here (cheap pre-screen)
        self.ceiling = 0
        # last feed version, for stalest-bucket eviction
        self.touched = 0


class ConflictPrefilter:
    """Per-proxy decaying summary of recently committed write ranges."""

    def __init__(self, knobs, ident: str = ""):
        self.knobs = knobs
        self.prefix_len = int(knobs.PREFILTER_PREFIX_LEN)
        self.bucket_cap = int(knobs.PREFILTER_BUCKET_ENTRIES)
        self.max_buckets = int(knobs.PREFILTER_MAX_BUCKETS)
        self.wide_cap = int(knobs.PREFILTER_WIDE_RANGES)
        # insertion-ordered so stalest-bucket eviction is O(1)-ish;
        # move_to_end on touch keeps it LRU by feed version
        self.buckets: "OrderedDict[bytes, _Bucket]" = OrderedDict()
        self.wide: deque = deque(maxlen=self.wide_cap)
        # everything committed at or below this version has been
        # forgotten; checks below it can't be rejected by us (the
        # resolver may still TOO_OLD them — not our job)
        self.floor = 0
        self.max_version = 0
        self._ranges_fed = 0
        self._ranges_decayed = 0
        self._buckets_evicted = 0
        self.stats = CounterCollection("Prefilter", ident)
        self.stats.gauge("buckets", lambda: len(self.buckets))
        self.stats.gauge(
            "rangeEntries",
            lambda: sum(len(b.entries) for b in self.buckets.values()),
        )
        self.stats.gauge("wideRanges", lambda: len(self.wide))
        self.stats.gauge("versionFloor", lambda: self.floor)
        self.stats.gauge("maxVersion", lambda: self.max_version)
        self.stats.gauge("rangesFed", lambda: self._ranges_fed)
        self.stats.gauge("rangesDecayed", lambda: self._ranges_decayed)
        self.stats.gauge("bucketsEvicted", lambda: self._buckets_evicted)

    # ------------------------------------------------------------- feed

    def feed(self, committed_ranges, version_floor: int = 0) -> int:
        """Absorb resolver feedback: ``committed_ranges`` is a list of
        ``(version, [(begin, end), ...])`` pairs; ``version_floor`` is
        the resolver's authoritative forget horizon (jumps on failover /
        journal capacity pressure). Returns the number of ranges fed."""
        fed = 0
        for version, ranges in committed_ranges:
            version = int(version)
            if version <= self.floor:
                continue
            if version > self.max_version:
                self.max_version = version
            for begin, end in ranges:
                self._insert(bytes(begin), bytes(end), version)
                fed += 1
        self._ranges_fed += fed
        if version_floor > self.floor:
            self.note_floor(version_floor)
        return fed

    def _insert(self, begin: bytes, end: bytes, version: int) -> None:
        prefix = begin[: self.prefix_len]
        nxt = _strinc(prefix)
        if nxt is not None and end <= nxt:
            bucket = self.buckets.get(prefix)
            if bucket is None:
                bucket = self.buckets[prefix] = _Bucket(self.bucket_cap)
                while len(self.buckets) > self.max_buckets:
                    # stalest feed version first (LRU order)
                    _, evicted = self.buckets.popitem(last=False)
                    self._buckets_evicted += 1
                    self._ranges_decayed += len(evicted.entries)
            else:
                self.buckets.move_to_end(prefix)
            if len(bucket.entries) == bucket.entries.maxlen:
                self._ranges_decayed += 1  # deque pops the oldest
            bucket.entries.append((begin, end, version))
            if version > bucket.ceiling:
                bucket.ceiling = version
            bucket.touched = version
        else:
            # spans buckets: exact entry on the bounded wide list
            if len(self.wide) == self.wide.maxlen:
                self._ranges_decayed += 1
            self.wide.append((begin, end, version))

    def note_floor(self, version_floor: int) -> None:
        """Advance the forget horizon and drop entries at/below it.
        Dropping only forgets conflicts — conservative."""
        if version_floor <= self.floor:
            return
        self.floor = version_floor
        dead = []
        for prefix, bucket in self.buckets.items():
            if bucket.ceiling <= version_floor:
                dead.append(prefix)
                self._ranges_decayed += len(bucket.entries)
                continue
            kept = [e for e in bucket.entries if e[2] > version_floor]
            self._ranges_decayed += len(bucket.entries) - len(kept)
            bucket.entries.clear()
            bucket.entries.extend(kept)
        for prefix in dead:
            del self.buckets[prefix]
        kept_wide = [e for e in self.wide if e[2] > version_floor]
        self._ranges_decayed += len(self.wide) - len(kept_wide)
        self.wide.clear()
        self.wide.extend(kept_wide)

    def reset(self, floor: int = 0) -> None:
        """Forget everything (e.g. resolver generation change)."""
        self._ranges_decayed += len(self.wide) + sum(
            len(b.entries) for b in self.buckets.values()
        )
        self.buckets.clear()
        self.wide.clear()
        self.floor = max(self.floor, floor)

    # ------------------------------------------------------------ check

    def check(self, read_snapshot: int, read_ranges) -> bool:
        """True iff some *stored* committed range overlaps a read range
        at a version newer than ``read_snapshot`` — i.e. the resolver is
        guaranteed to convict this transaction. Never guesses: absent or
        forgotten entries mean False."""
        if read_snapshot >= self.max_version or not read_ranges:
            return False  # nothing committed past the snapshot
        for rb, re_ in read_ranges:
            rb = bytes(rb)
            re_ = bytes(re_)
            probes = [rb[: self.prefix_len]]
            # end key is exclusive; probing its prefix still only ADDS
            # candidate entries, and the exact overlap test below
            # filters non-overlaps, so over-probing stays conservative
            ep = re_[: self.prefix_len]
            if ep != probes[0]:
                probes.append(ep)
            for prefix in probes:
                bucket = self.buckets.get(prefix)
                if bucket is None or bucket.ceiling <= read_snapshot:
                    continue
                for eb, ee, v in bucket.entries:
                    if v > read_snapshot and eb < re_ and rb < ee:
                        return True
            for eb, ee, v in self.wide:
                if v > read_snapshot and eb < re_ and rb < ee:
                    return True
        return False
