"""Watches and change feeds — version-ordered notification fan-out
(the reference's watchValue_impl plus the
change-feed machinery of StorageServer::ChangeFeedInfo).

The epoch-batched engine already reduces every mutation batch
to a per-version final-entries dict and native range tombstones — exactly
the trigger source a watch needs. This module owns the subsystem the
storage server mounts on that path:

- **Staging, then committed-gated firing.** ``on_epoch`` stages each
  applied version's diffs; nothing fires until ``advance_committed``
  moves the committed frontier past them. The frontier is the
  ``known_committed`` version the proxies piggyback on tlog pushes and
  the peek cursor relays to storage — a recovery's rollback boundary can
  never cut below it, so a rolled-back epoch is truncated from the
  *staged* region only: it never fired a watch and never streamed a feed
  entry. Zero phantom triggers by construction, and fires happen in
  version order because staged epochs drain in version order.

- **Bounded memory.** A parked watch costs its key + believed value +
  fixed overhead, summed into the ``watchBytes`` gauge; registration
  past ``STORAGE_WATCH_LIMIT`` raises the typed retryable
  ``TooManyWatches`` (clients back off and re-register — parked watches
  fire and drain continuously, so capacity returns).

- **Never lost across forget_before.** A watch's belief is compared
  against diffs at versions above the committed frontier at registration
  time; the registration-time immediate check (in storage.watch_value)
  reads the live MVCC tip, which the durability drain never discards —
  so a change that lands while the registration RPC is in flight is
  caught either by the immediate check or by a staged epoch, with no
  window in between. The change FEED is where retention genuinely bites:
  committed diffs are kept ``STORAGE_FEED_RETENTION_VERSIONS`` behind
  the frontier, active subscriber cursors lease-pin the floor (like scan
  leases pin engine snapshots, bounded at 2x retention so an abandoned
  subscriber cannot wedge memory), and resuming below the floor raises
  TOO_OLD.

- **Fan-out shape.** One ``advance_committed`` call resolves every
  parked future whose key changed; each parked handler wakes in the same
  scheduler tick and replies at the same sim instant, so the transport's
  super-frame path coalesces a 100K-watch burst into ~one frame per
  connection (``watchFanoutBatches`` counts the bursts).
"""

from __future__ import annotations

from bisect import bisect_left, insort
from collections import deque
from typing import Optional

from ..errors import TooManyWatches, TransactionTooOld
from ..runtime.futures import Future
from ..runtime.trace import emit_span

# fixed per-watch bookkeeping cost (entry slots + dict/list cells),
# counted into watchBytes next to the key/value bytes themselves
_ENTRY_OVERHEAD = 64

# absolute cap on how far subscriber leases may hold the feed floor
# behind the committed frontier, as a multiple of the retention knob
_LEASE_RETENTION_FACTOR = 2


class WatchEntry:
    """One parked watch: key, the watcher's believed value, and the
    future its storage handler is parked on. ``future`` resolves to
    ``(new_value, version)`` on fire, or errors (WrongShardServer on a
    shard drop; handler cancellation covers process death)."""

    __slots__ = ("key", "value", "future", "span_ctx", "cost", "fired")

    def __init__(self, key: bytes, value: Optional[bytes], span_ctx=None):
        self.key = key
        self.value = value
        self.future: Future = Future()
        self.span_ctx = span_ctx  # caller's trace context (rode the RPC)
        self.cost = _ENTRY_OVERHEAD + len(key) + (len(value) if value else 0)
        self.fired = False


class WatchManager:
    """Registry + trigger evaluation + change-feed log for one storage
    server. The server registers the counters (flowlint's
    role_required_counters wants the literal names in the role class
    body) and hands them in."""

    def __init__(
        self,
        knobs,
        *,
        registered,
        fired,
        cancelled,
        streamed,
        fanout_batches,
    ):
        self.knobs = knobs
        self._c_registered = registered
        self._c_fired = fired
        self._c_cancelled = cancelled
        self._c_streamed = streamed
        self._c_fanout = fanout_batches
        # key → parked entries in registration order (a dict: a set of
        # entries iterates in address order, so the watches of one key
        # fired in a different order from run to run of one seed, and the
        # seed's run with them); _keys mirrors the keys sorted, so a range
        # tombstone finds its watchers in O(log W + hits)
        self._watches: dict[bytes, dict] = {}
        self._keys: list[bytes] = []
        self._count = 0
        self._bytes = 0
        # staged (applied, not yet known-committed) and committed
        # (feed-servable, watch-fired) per-version diff regions:
        # (version, entries dict, clears tuple, staged_at)
        self._staged: deque = deque()
        self._feed: deque = deque()
        self.committed = 0  # the known-committed frontier
        self._floor = 0  # versions ≤ this may be trimmed from the feed
        # sub_id → (cursor_version, lease_deadline): active feed readers
        # hold the retention floor at their cursor until the lease lapses
        self._leases: dict = {}

    # -- gauges ----------------------------------------------------------------

    def parked_count(self) -> int:
        return self._count

    def bytes_held(self) -> int:
        return self._bytes

    def feed_versions_held(self) -> int:
        held = len(self._feed) + len(self._staged)
        return held

    # -- watch registration ----------------------------------------------------

    def register(self, key: bytes, value: Optional[bytes], span_ctx=None) -> WatchEntry:
        if self._count >= self.knobs.STORAGE_WATCH_LIMIT:
            raise TooManyWatches(
                f"{self._count} watches parked (STORAGE_WATCH_LIMIT)"
            )
        entry = WatchEntry(key, value, span_ctx)
        bucket = self._watches.get(key)
        if bucket is None:
            bucket = self._watches[key] = {}
            insort(self._keys, key)
        bucket[entry] = None
        self._count += 1
        self._bytes += entry.cost
        self._c_registered.add()
        return entry

    def _discard(self, entry: WatchEntry) -> bool:
        bucket = self._watches.get(entry.key)
        if bucket is None or entry not in bucket:
            return False
        del bucket[entry]
        if not bucket:
            del self._watches[entry.key]
            i = bisect_left(self._keys, entry.key)
            if i < len(self._keys) and self._keys[i] == entry.key:
                del self._keys[i]
        self._count -= 1
        self._bytes -= entry.cost
        return True

    def deregister(self, entry: WatchEntry) -> None:
        """Handler unwound (reply sent, caller gone, or process dying):
        drop the entry. Counts as a cancel only if it never fired."""
        if self._discard(entry) and not entry.fired:
            self._c_cancelled.add()

    def fail_range(self, begin: bytes, end: bytes, exc_type) -> None:
        """Fail every parked watch in [begin, end) with ``exc_type`` —
        used by shard drops (WrongShardServer: the holder re-locates and
        re-registers at the new team). A drop's private clear is NOT a
        data change, so these must never fire value=None; failing them
        here, before the epoch's tombstone reaches the trigger path,
        guarantees that."""
        i = bisect_left(self._keys, begin)
        doomed = []
        while i < len(self._keys) and self._keys[i] < end:
            doomed.extend(self._watches[self._keys[i]])
            i += 1
        for entry in doomed:
            if self._discard(entry):
                self._c_cancelled.add()
                entry.future._set_error(exc_type())

    # -- trigger path ----------------------------------------------------------

    def on_epoch(self, version: int, entries: dict, clears, staged_at: float) -> None:
        """Stage one applied version's final diffs (the epoch build's
        entries dict — shared with the engine, treated as immutable — and
        its DATA clears; private/shard-drop clears are excluded by the
        caller). Nothing fires yet: triggers and feed visibility wait for
        the committed frontier."""
        if not entries and not clears:
            return
        self._staged.append((version, entries, tuple(clears), staged_at))

    def advance_committed(self, frontier: int, now: float, process: str = "ss") -> None:
        """Move the committed frontier: newly covered staged epochs fire
        their watches (version order = staging order) and become
        feed-servable; then the retention floor advances."""
        if frontier > self.committed:
            self.committed = frontier
        fired_any = False
        while self._staged and self._staged[0][0] <= self.committed:
            version, entries, clears, staged_at = self._staged.popleft()
            fired_any |= self._fire_epoch(
                version, entries, clears, staged_at, now, process
            )
            self._feed.append((version, entries, clears))
        if fired_any:
            self._c_fanout.add()
        self._trim(now)

    def _fire_epoch(
        self, version, entries, clears, staged_at, now, process
    ) -> bool:
        if not self._count:
            return False
        hits = []
        for k, v in entries.items():
            bucket = self._watches.get(k)
            if bucket:
                for entry in bucket:
                    if entry.value != v:
                        hits.append((entry, v))
        for b, e in clears:
            i = bisect_left(self._keys, b)
            while i < len(self._keys) and self._keys[i] < e:
                k = self._keys[i]
                if k not in entries:  # a later set in the epoch won
                    for entry in self._watches[k]:
                        if entry.value is not None:
                            hits.append((entry, None))
                i += 1
        fired = False
        for entry, value in hits:
            if entry.fired:
                continue  # overlapping tombstones in one epoch
            self._discard(entry)
            entry.fired = True
            fired = True
            self._c_fired.add()
            entry.future._set((value, version))
            if entry.span_ctx is not None:
                emit_span(
                    "Storage.watchFire",
                    process,
                    entry.span_ctx,
                    staged_at,
                    now,
                    Version=version,
                )
        return fired

    # -- change feed -----------------------------------------------------------

    def feed_collect(
        self,
        begin: bytes,
        end: bytes,
        from_version: int,
        limit: int,
        sub_id: str,
        now: float,
    ):
        """Committed per-version diffs intersecting [begin, end) with
        version > from_version — whole versions at a time (a version's
        mutations never split across pages), paged after ~``limit``
        entries. Returns (batches, next_version, more); batches are
        ``(version, [(clear_begin, clear_end)...], [(key, value)...])``
        with clears clipped to the subscribed range and both lists in
        canonical sorted order. Raises TOO_OLD below the retention
        floor."""
        if from_version < self._floor:
            raise TransactionTooOld(
                f"feed resume {from_version} below retained floor {self._floor}"
            )
        batches = []
        n = 0
        more = False
        last = from_version
        for version, entries, clears in self._feed:
            if version <= from_version:
                continue
            if n >= limit:
                more = True
                break
            sets = sorted(
                (k, v) for k, v in entries.items() if begin <= k < end
            )
            cl = sorted(
                (max(b, begin), min(e, end))
                for b, e in clears
                if b < end and begin < e
            )
            if sets or cl:
                batches.append((version, cl, sets))
                n += len(sets) + len(cl)
            last = version
        next_version = last if more else max(last, self.committed)
        if sub_id:
            self._leases[sub_id] = (
                next_version,
                now + self.knobs.STORAGE_SNAPSHOT_LEASE,
            )
        if n:
            self._c_streamed.add(n)
        return batches, next_version, more

    def _trim(self, now: float) -> None:
        retention = self.knobs.STORAGE_FEED_RETENTION_VERSIONS
        target = self.committed - retention
        self._leases = {
            s: (cur, dl) for s, (cur, dl) in self._leases.items() if dl > now
        }
        if self._leases:
            target = min(
                target, min(cur for cur, _dl in self._leases.values())
            )
        # an abandoned/slow subscriber cannot hold memory without bound
        target = max(target, self.committed - _LEASE_RETENTION_FACTOR * retention)
        if target <= self._floor:
            return
        self._floor = target
        while self._feed and self._feed[0][0] <= target:
            self._feed.popleft()

    # -- recovery --------------------------------------------------------------

    def rollback_after(self, boundary: int) -> None:
        """An epoch change cut versions > boundary. Those versions were
        never acked, so they live in the staged region (the committed
        frontier can't exceed a recovery boundary) — drop them: they
        never fired and never streamed. The feed-side pop is defensive
        only; the frontier clamp makes a violation fail TOO_OLD/retry,
        never phantom."""
        while self._staged and self._staged[-1][0] > boundary:
            self._staged.pop()
        while self._feed and self._feed[-1][0] > boundary:
            self._feed.pop()
        if self.committed > boundary:
            self.committed = boundary
