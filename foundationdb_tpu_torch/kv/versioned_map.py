"""Multi-version ordered map — the storage server's MVCC window.

The analog of the reference's VersionedMap persistent treap
(fdbclient/VersionedMap.h:31-68): holds the last few seconds of versions in
memory so reads at any version in [oldest_version, latest_version] see a
consistent snapshot. The reference uses a path-copying treap; here the same
semantics come from per-key version-history lists over one sorted key index —
simpler, and the batched-lookup form feeds the planned device range-query
primitive (SURVEY.md §7 stage 7) where the treap's pointer-chasing could not.

Two personalities share the read interface:

- ``VersionedMap`` — the legacy per-mutation store: every write keeps the
  key index sorted with an O(n) ``bisect.insort`` and every ``clear_range``
  materializes per-key tombstones.
- ``EpochVersionedMap`` — the epoch-batched store (Jiffy's
  batch-update + O(1)-snapshot shape from PAPERS.md): ``apply_epoch``
  applies a whole mutation batch at one version, merging the sorted key
  index ONCE per batch, recording ``clear_range`` as native range
  tombstones (no per-key materialization, and wide clears stop touching
  engine rows entirely), and ``snapshot(version)`` returns an O(1)
  ``PinnedSnapshot`` handle whose pin clamps the owner's compaction
  horizon — a reader at a pinned version never races ``forget_before``.

Both keep a touch log — (version, key) per appended history entry — so
compaction visits only keys touched below the new horizon instead of
scanning the whole ``_hist`` dict per durability advance.

Mutations must be applied in nondecreasing version order (the storage server's
update loop guarantees this, mirroring storageserver.actor.cpp:2321).
"""

from __future__ import annotations

import bisect
from typing import Iterator, Optional


def _find_le(h: list[tuple[int, Optional[bytes]]], version: int) -> int:
    """Index of the last entry with entry.version <= version, else -1."""
    lo, hi = 0, len(h)
    while lo < hi:
        mid = (lo + hi) // 2
        if h[mid][0] <= version:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1


def merge_sorted_keys(keys: list, new_sorted: list) -> tuple[list, int]:
    """(merged, elements_moved): merge sorted distinct new keys into a
    sorted key list — the per-epoch replacement for per-key ``insort``
    (which moves O(n) elements per NEW key). A small batch insorts (the
    C memmove beats any merge below ~16 keys); a larger one extends and
    sorts — CPython's timsort detects the two runs and gallops the merge
    at C speed, O(n+m) with a tiny constant. ``elements_moved`` feeds
    the ``keys_moved`` regression counters (the transport RecvBuffer's
    ``bytes_moved`` discipline): callers assert bulk ingest stays
    O(N log N), not N·O(n)."""
    if not keys:
        return list(new_sorted), len(new_sorted)
    if new_sorted[0] > keys[-1]:
        # append-only fast path (fresh suffix): nothing below moves
        keys.extend(new_sorted)
        return keys, len(new_sorted)
    if len(new_sorted) < 16:
        moved = 0
        for k in new_sorted:
            i = bisect.bisect_left(keys, k)
            moved += len(keys) - i
            keys.insert(i, k)
        return keys, moved
    keys.extend(new_sorted)
    keys.sort()
    return keys, len(keys)


class VersionedMap:
    def __init__(self) -> None:
        self._keys: list[bytes] = []  # sorted; includes tombstoned keys until GC
        self._hist: dict[bytes, list[tuple[int, Optional[bytes]]]] = {}
        # (version, key) per appended entry, version-nondecreasing: the
        # compaction work list — forget_before visits only keys touched
        # below its horizon (the old code scanned every key in _hist per
        # durability advance, O(total-keys) even for a 2-key epoch)
        self._touch_log: list[tuple[int, bytes]] = []
        self.forget_visits = 0  # keys visited by forget_before (test evidence)
        self.oldest_version = 0
        self.latest_version = 0

    # -- writes (version-ordered) ---------------------------------------------

    def _append(self, key: bytes, version: int, value: Optional[bytes]) -> None:
        h = self._hist.get(key)
        if h is None:
            self._hist[key] = [(version, value)]
            bisect.insort(self._keys, key)
            self._touch_log.append((version, key))
        elif h[-1][0] == version:
            h[-1] = (version, value)  # same-version overwrite: already logged
        else:
            h.append((version, value))
            self._touch_log.append((version, key))

    def set(self, key: bytes, value: bytes, version: int) -> None:
        assert version >= self.latest_version, "mutations must be version-ordered"
        self.latest_version = version
        self._append(key, version, value)

    def clear_range(self, begin: bytes, end: bytes, version: int) -> None:
        assert version >= self.latest_version
        self.latest_version = version
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        for key in self._keys[lo:hi]:
            self._append(key, version, None)

    def latest(self, key: bytes) -> Optional[bytes]:
        """Value at latest_version (used when applying atomic ops)."""
        h = self._hist.get(key)
        return h[-1][1] if h else None

    def latest_with_presence(self, key: bytes):
        """(known, value) at latest_version — known=False means the window
        has no entry and the caller falls through to the durable engine."""
        h = self._hist.get(key)
        if h:
            return True, h[-1][1]
        return False, None

    # -- reads ----------------------------------------------------------------

    def _at(self, key: bytes, version: int) -> Optional[bytes]:
        h = self._hist.get(key)
        if not h:
            return None
        i = _find_le(h, version)
        return h[i][1] if i >= 0 else None

    def get(self, key: bytes, version: int) -> Optional[bytes]:
        assert version >= self.oldest_version, "read below MVCC window"
        return self._at(key, version)

    def get_with_presence(self, key: bytes, version: int):
        """(known, value): known=False means the window has no entry — the
        caller falls through to the durable engine (the storage server's
        memory-over-disk merge, storageserver readRange:916)."""
        assert version >= self.oldest_version, "read below MVCC window"
        h = self._hist.get(key)
        if not h:
            return False, None
        i = _find_le(h, version)
        if i < 0:
            return False, None  # all entries newer than `version`
        return True, h[i][1]

    def entries_with_tombstones(
        self, begin: bytes, end: bytes, version: int
    ) -> list[tuple[bytes, Optional[bytes]]]:
        """All window-known (key, value|None-tombstone) in [begin, end) at
        `version` — for merging over the engine's rows."""
        assert version >= self.oldest_version
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        out = []
        for k in self._keys[lo:hi]:
            h = self._hist.get(k)
            i = _find_le(h, version)
            if i >= 0:
                out.append((k, h[i][1]))
        return out

    def window_view(self, begin: bytes, end: bytes, version: int):
        """(overlay, clears) for the window-over-engine merge: overlay maps
        window-known keys in [begin, end) to value|None-tombstone; clears
        are the native range tombstones that must additionally mask engine
        rows. The legacy map materializes per-key tombstones, so its
        clears list is always empty."""
        return dict(self.entries_with_tombstones(begin, end, version)), ()

    def range(
        self,
        begin: bytes,
        end: bytes,
        version: int,
        limit: int = 1 << 30,
        reverse: bool = False,
    ) -> list[tuple[bytes, bytes]]:
        assert version >= self.oldest_version
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        keys = self._keys[lo:hi]
        if reverse:
            keys = reversed(keys)
        out: list[tuple[bytes, bytes]] = []
        for k in keys:
            v = self._at(k, version)
            if v is not None:
                out.append((k, v))
                if len(out) >= limit:
                    break
        return out

    def __iter__(self) -> Iterator[bytes]:
        return iter(self._keys)

    # -- rollback (storageserver.actor.cpp:2172) ------------------------------

    def _rollback_entries(self, version: int) -> None:
        """Discard history entries above `version`, visiting only keys the
        touch log names there (rollback is rare; the filter is O(log))."""
        stale = {k for v, k in self._touch_log if v > version}
        self._touch_log = [e for e in self._touch_log if e[0] <= version]
        dead: list[bytes] = []
        for key in stale:
            h = self._hist.get(key)
            if h is None:
                continue
            i = _find_le(h, version)
            del h[i + 1 :]
            if not h:
                dead.append(key)
        self._drop_keys(dead)

    def _drop_keys(self, dead: list) -> None:
        if not dead:
            return
        if len(dead) == 1:
            key = dead[0]
            del self._hist[key]
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]
            return
        dead_set = set(dead)
        for key in dead_set:
            del self._hist[key]
        self._keys = [k for k in self._keys if k not in dead_set]

    def rollback_after(self, version: int) -> None:
        """Discard all history above `version` — the storage server's
        rollback when a recovery's epoch-end cuts off versions it had
        applied from a tlog whose tail didn't survive (rollback:2172)."""
        if version >= self.latest_version:
            return
        self._rollback_entries(version)
        self.latest_version = version

    # -- compaction -----------------------------------------------------------

    def _pop_touched(self, version: int) -> set:
        """Keys touched at versions <= `version`: the only keys a
        compaction to that horizon can affect. Pops the log prefix."""
        n = 0
        log = self._touch_log
        while n < len(log) and log[n][0] <= version:
            n += 1
        touched = {k for _v, k in log[:n]}
        del log[:n]
        return touched

    def forget_before(self, version: int, drop_known: bool = False) -> None:
        """Advance oldest_version, dropping superseded history (the analog of
        the storage server making versions durable and trimming the treap,
        storageserver.actor.cpp:2536). Visits only keys the touch log
        names below the horizon — a 2-key epoch costs 2 visits, not a
        scan of every key in the window.

        drop_known=True additionally drops entries ≤ version entirely —
        correct only when a durable engine holds the state at `version`
        and reads fall through to it (get_with_presence)."""
        if version < self.oldest_version or (
            version == self.oldest_version and not drop_known
        ):
            return
        version = min(version, self.latest_version)
        dead: list[bytes] = []
        for key in self._pop_touched(version):
            h = self._hist.get(key)
            if h is None:
                continue  # rolled back or already dropped
            self.forget_visits += 1
            # keep the newest entry at-or-below `version` plus everything after
            i = _find_le(h, version)
            if drop_known:
                if i >= 0:
                    del h[: i + 1]
                if not h:
                    dead.append(key)
                continue
            if i > 0:
                del h[:i]
            if len(h) == 1 and h[0][1] is None and h[0][0] <= version:
                dead.append(key)
        self._drop_keys(dead)
        self.oldest_version = version


class PinnedSnapshot:
    """O(1) immutable read handle at a pinned version (ROADMAP item 5 —
    Jiffy's snapshot operation). Registering the pin clamps the owner's
    compaction horizon: while the pin is held, ``forget_before`` cannot
    pass ``version``, so every read through the handle sees exactly the
    state at pin time without copying anything. The handle goes TOO_OLD
    (``invalidated``) when a rollback cuts off its version, or when the
    owner is forced past it (the storage server's pin-lag cap bounds how
    long an abandoned pin may grow the MVCC window)."""

    __slots__ = ("version", "pinned_at", "invalidated", "_vm", "_id")

    def __init__(self, vm: "EpochVersionedMap", version: int, pinned_at: float):
        self.version = version
        self.pinned_at = pinned_at
        self.invalidated = False
        self._vm = vm
        self._id = None

    def release(self) -> None:
        self._vm._pins.pop(self._id, None)

    @property
    def valid(self) -> bool:
        return not self.invalidated and self.version >= self._vm.oldest_version

    def _check(self) -> None:
        if not self.valid:
            from ..errors import TransactionTooOld

            raise TransactionTooOld()

    def get(self, key: bytes) -> Optional[bytes]:
        self._check()
        return self._vm.get(key, self.version)

    def get_with_presence(self, key: bytes):
        self._check()
        return self._vm.get_with_presence(key, self.version)

    def range(self, begin, end, limit: int = 1 << 30, reverse: bool = False):
        self._check()
        return self._vm.range(begin, end, self.version, limit=limit, reverse=reverse)

    def window_view(self, begin, end):
        self._check()
        return self._vm.window_view(begin, end, self.version)


class EpochVersionedMap(VersionedMap):
    """Epoch-batched MVCC window: whole mutation batches apply
    as one epoch, clears are native range tombstones, and snapshots pin.

    Write path: ``apply_epoch(version, entries, clears)`` — entries is the
    batch's FINAL per-key state (a set overwritten by a later clear in the
    same batch was already dropped when the batch was reduced; values may be None for
    point tombstones from atomic clears), clears the batch's range
    tombstones in arrival order. The sorted key index merges once per
    epoch (``merge_sorted_keys``) instead of an O(n) insort per new key.

    Read path: a key's value at ``version`` is its newest history entry
    ≤ version, unless a range tombstone with a version in (entry_version,
    version] covers the key — then it reads as absent-with-presence (the
    tombstone masks both window history and engine rows below it).

    Compaction: ``forget_before`` pops whole superseded epochs off the
    touch log and the clear list — O(touched), never O(total-keys) — and
    is clamped by active pins (``min_pinned``); ``rollback_after``
    truncates clears above the boundary and invalidates pins that hold
    cut-off versions (they fail TOO_OLD instead of serving them)."""

    def __init__(self) -> None:
        super().__init__()
        # native range tombstones, version-ascending; parallel version
        # list for bisect. A clear never touches per-key history.
        self._clears: list[tuple[int, bytes, bytes]] = []
        self._clear_versions: list[int] = []
        self._pins: dict[int, PinnedSnapshot] = {}
        self._pin_seq = 0
        self.keys_moved = 0  # sorted-index elements moved (regression counter)
        self.epochs_applied = 0

    # -- epoch writes ----------------------------------------------------------

    def apply_epoch(
        self,
        version: int,
        entries: dict,
        clears=(),
    ) -> None:
        assert version >= self.latest_version, "epochs must be version-ordered"
        self.latest_version = version
        new_keys: list = []
        hist = self._hist
        log = self._touch_log
        for k, v in entries.items():
            h = hist.get(k)
            if h is None:
                hist[k] = [(version, v)]
                new_keys.append(k)
                log.append((version, k))
            elif h[-1][0] == version:
                h[-1] = (version, v)
            else:
                h.append((version, v))
                log.append((version, k))
        for b, e in clears:
            self._clears.append((version, b, e))
            self._clear_versions.append(version)
        if new_keys:
            new_keys.sort()
            self._keys, moved = merge_sorted_keys(self._keys, new_keys)
            self.keys_moved += moved
        self.epochs_applied += 1

    # single-mutation writes ride one-op epochs (fetchKeys splices and
    # tests); the storage server's pull loop always batches
    def set(self, key: bytes, value: bytes, version: int) -> None:
        self.apply_epoch(version, {key: value})

    def clear_range(self, begin: bytes, end: bytes, version: int) -> None:
        self.apply_epoch(version, {}, ((begin, end),))

    # -- reads -----------------------------------------------------------------

    def _clears_over(self, key: bytes, after: int, upto: int) -> bool:
        """Any range tombstone with version in (after, upto] covering key?"""
        lo = bisect.bisect_right(self._clear_versions, after)
        hi = bisect.bisect_right(self._clear_versions, upto)
        for _cv, b, e in self._clears[lo:hi]:
            if b <= key < e:
                return True
        return False

    def latest_with_presence(self, key: bytes):
        h = self._hist.get(key)
        ev = h[-1][0] if h else -1
        if self._clears_over(key, ev, self.latest_version):
            return True, None
        if h:
            return True, h[-1][1]
        return False, None

    def latest(self, key: bytes) -> Optional[bytes]:
        return self.latest_with_presence(key)[1]

    def _at_presence(self, key: bytes, version: int):
        h = self._hist.get(key)
        i = _find_le(h, version) if h else -1
        ev = h[i][0] if i >= 0 else -1
        if self._clears_over(key, ev, version):
            return True, None
        if i >= 0:
            return True, h[i][1]
        return False, None

    def _at(self, key: bytes, version: int) -> Optional[bytes]:
        return self._at_presence(key, version)[1]

    def get_with_presence(self, key: bytes, version: int):
        assert version >= self.oldest_version, "read below MVCC window"
        return self._at_presence(key, version)

    def _range_clears(self, begin: bytes, end: bytes, version: int) -> list:
        hi = bisect.bisect_right(self._clear_versions, version)
        return [
            c for c in self._clears[:hi] if c[1] < end and c[2] > begin
        ]

    def window_view(self, begin: bytes, end: bytes, version: int):
        """(overlay, clears): overlay maps window-touched keys in
        [begin, end) to value|None at `version`; clears are the range
        tombstones ≤ version overlapping the range, which the caller must
        additionally apply over engine rows (every retained clear is
        newer than any engine content — superseded clears are drained to
        the engine before forget_before pops them)."""
        assert version >= self.oldest_version
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        clears = self._range_clears(begin, end, version)
        out: dict = {}
        for k in self._keys[lo:hi]:
            h = self._hist.get(k)
            i = _find_le(h, version)
            ev = h[i][0] if i >= 0 else -1
            if any(cv > ev and b <= k < e for cv, b, e in clears):
                out[k] = None
            elif i >= 0:
                out[k] = h[i][1]
        return out, [(b, e) for _cv, b, e in clears]

    def entries_with_tombstones(
        self, begin: bytes, end: bytes, version: int
    ) -> list[tuple[bytes, Optional[bytes]]]:
        """Window-TOUCHED keys only: a native range tombstone is NOT
        expanded over engine rows here — engine-merging callers must use
        window_view and apply its clears to the engine side."""
        overlay, _clears = self.window_view(begin, end, version)
        return sorted(overlay.items())

    def range(
        self,
        begin: bytes,
        end: bytes,
        version: int,
        limit: int = 1 << 30,
        reverse: bool = False,
    ) -> list[tuple[bytes, bytes]]:
        assert version >= self.oldest_version
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        keys = self._keys[lo:hi]
        if reverse:
            keys = reversed(keys)
        clears = self._range_clears(begin, end, version)
        out: list[tuple[bytes, bytes]] = []
        for k in keys:
            h = self._hist.get(k)
            i = _find_le(h, version)
            if i < 0:
                continue
            ev = h[i][0]
            if h[i][1] is None or any(
                cv > ev and b <= k < e for cv, b, e in clears
            ):
                continue
            out.append((k, h[i][1]))
            if len(out) >= limit:
                break
        return out

    # -- snapshots (O(1) pins) -------------------------------------------------

    def snapshot(self, version: int, pinned_at: float = 0.0) -> PinnedSnapshot:
        """An immutable read handle at `version`, O(1): nothing is copied —
        the pin registration clamps forget_before instead."""
        assert version >= self.oldest_version, "snapshot below MVCC window"
        snap = PinnedSnapshot(self, version, pinned_at)
        self._pin_seq += 1
        snap._id = self._pin_seq
        self._pins[snap._id] = snap
        return snap

    def min_pinned(self) -> Optional[int]:
        versions = [p.version for p in self._pins.values() if not p.invalidated]
        return min(versions) if versions else None

    def oldest_pin(self) -> Optional[PinnedSnapshot]:
        live = [p for p in self._pins.values() if not p.invalidated]
        return min(live, key=lambda p: (p.version, p.pinned_at)) if live else None

    def pinned_count(self) -> int:
        return sum(1 for p in self._pins.values() if not p.invalidated)

    # -- rollback / compaction -------------------------------------------------

    def rollback_after(self, version: int) -> None:
        if version >= self.latest_version:
            return
        # pins above the boundary hold versions the recovery cut off:
        # they must fail TOO_OLD, never serve them
        for pin in self._pins.values():
            if pin.version > version:
                pin.invalidated = True
        cut = bisect.bisect_right(self._clear_versions, version)
        del self._clears[cut:]
        del self._clear_versions[cut:]
        self._rollback_entries(version)
        self.latest_version = version

    def forget_before(self, version: int, drop_known: bool = False) -> None:
        if version < self.oldest_version or (
            version == self.oldest_version and not drop_known
        ):
            return
        version = min(version, self.latest_version)
        floor = self.min_pinned()
        if floor is not None and floor < version:
            # a pin holds the horizon; the storage server's pin-lag cap
            # invalidates overstaying pins BEFORE asking for the advance
            version = floor
            if version < self.oldest_version or (
                version == self.oldest_version and not drop_known
            ):
                return
        visit = self._pop_touched(version)
        # superseded range tombstones: whole clears pop off the list.
        # Without an engine the final pre-horizon state must survive in
        # the per-key chains, so a popped clear first materializes point
        # tombstones over the keys it still masks (bounded by covered
        # keys); with an engine (drop_known) the drained engine already
        # reflects the clear and it simply drops.
        cut = bisect.bisect_right(self._clear_versions, version)
        if cut:
            if not drop_known:
                for cv, b, e in self._clears[:cut]:
                    lo = bisect.bisect_left(self._keys, b)
                    hi = bisect.bisect_left(self._keys, e)
                    for k in self._keys[lo:hi]:
                        h = self._hist.get(k)
                        i = _find_le(h, cv)
                        # an entry AT the clear's version is the epoch's
                        # final word (set-after-clear): the clear lost
                        if i < 0 or h[i][1] is None or h[i][0] == cv:
                            continue
                        h.insert(i + 1, (cv, None))
                        visit.add(k)
            del self._clears[:cut]
            del self._clear_versions[:cut]
        dead: list[bytes] = []
        for key in visit:
            h = self._hist.get(key)
            if h is None:
                continue
            self.forget_visits += 1
            i = _find_le(h, version)
            if drop_known:
                if i >= 0:
                    del h[: i + 1]
                if not h:
                    dead.append(key)
                continue
            if i > 0:
                del h[:i]
            if len(h) == 1 and h[0][1] is None and h[0][0] <= version:
                dead.append(key)
        self._drop_keys(dead)
        self.oldest_version = version
        # a pin the caller force-advanced past (pin-lag cap) is dead
        for pin in self._pins.values():
            if pin.version < version:
                pin.invalidated = True
