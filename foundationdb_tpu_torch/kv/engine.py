"""IKeyValueStore: local durable storage engines.

The analog of fdbserver/IKeyValueStore.h (:27-77): the storage server's
and txn-state's local engine seam. Engines here:

- ``KeyValueStoreMemory`` — the reference's memory engine
  (KeyValueStoreMemory.actor.cpp): all data in an ordered in-memory map;
  durability from an operation log in a DiskQueue, periodically compacted
  by writing a full snapshot entry and popping everything before it
  (:337 op-log, :580 snapshotting).
- the native B-tree engine (kv/native_engine.py over
  foundationdb_tpu_torch/native) is its disk-resident sibling for real
  deployments — same interface.

Writes buffer in memory; ``commit()`` makes everything before it durable.
"""

from __future__ import annotations

import bisect

from ..runtime.serialize import BinaryReader, BinaryWriter
from .diskqueue import DiskQueue
from .versioned_map import merge_sorted_keys

_OP_SET = 0
_OP_CLEAR = 1
_SNAPSHOT = 2


class KeyValueStoreMemory:
    SNAPSHOT_AFTER_BYTES = 1 << 20  # op-log size that triggers a snapshot

    def __init__(self, disk, name: str):
        self.dq = DiskQueue(disk, name)
        self._keys: list[bytes] = []  # sorted
        self._map: dict[bytes, bytes] = {}
        self._ops = BinaryWriter()
        self._ops_count = 0
        self._oplog_bytes = 0  # op-log bytes since the last snapshot
        # key → was it present BEFORE its first touch this epoch? The
        # storage's device range index delta-merges from the EXACT diff
        # (present-before vs present-after), so add+clear-within-an-epoch
        # nets out instead of corrupting the index. Tracking is off until
        # the index consumer enables it (a real server with the index
        # disabled must not leak touched keys forever).
        self.track_dirty = False
        self.dirty_keys: dict = {}
        # sorted-index elements moved by inserts/merges — the bulk-ingest
        # regression counter (the transport RecvBuffer's bytes_moved discipline):
        # per-key insort moves O(n) per NEW key, apply_epoch merges once
        self.keys_moved = 0

    # -- recovery --------------------------------------------------------------

    async def recover(self) -> None:
        entries = await self.dq.recover()
        for _off, payload in entries:
            r = BinaryReader(payload)
            kind = r.u8()
            if kind == _SNAPSHOT:
                self._map = {}
                n = r.u32()
                for _ in range(n):
                    k = r.bytes_()
                    self._map[k] = r.bytes_()
            else:
                self._apply_ops(r, kind)
                while r.remaining():
                    self._apply_ops(r, r.u8())
        self._keys = sorted(self._map)

    def _apply_ops(self, r: BinaryReader, kind: int) -> None:
        if kind == _OP_SET:
            # locals first: Python evaluates an assignment's RHS before
            # the subscript target, so inlining both reads SWAPPED
            # key/value on op-log replay (a reboot then served rows whose
            # key was the old value — found by the chaos soak's
            # ConsistencyCheck as replica divergence)
            k = r.bytes_()
            v = r.bytes_()
            self._map[k] = v
        elif kind == _OP_CLEAR:
            b, e = r.bytes_(), r.bytes_()
            for k in [k for k in self._map if b <= k < e]:
                del self._map[k]
        else:
            raise AssertionError(f"bad op {kind}")

    # -- writes ----------------------------------------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        if key not in self._map:
            if self.track_dirty:
                self.dirty_keys.setdefault(key, False)
            i = bisect.bisect_left(self._keys, key)
            self.keys_moved += len(self._keys) - i
            self._keys.insert(i, key)
        self._map[key] = value
        self._ops.u8(_OP_SET).bytes_(key).bytes_(value)
        self._ops_count += 1

    def clear_range(self, begin: bytes, end: bytes) -> None:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        for k in self._keys[lo:hi]:
            del self._map[k]
            if self.track_dirty:
                self.dirty_keys.setdefault(k, True)
        self.keys_moved += len(self._keys) - hi
        del self._keys[lo:hi]
        self._ops.u8(_OP_CLEAR).bytes_(begin).bytes_(end)
        self._ops_count += 1

    def apply_epoch(self, entries: dict, clears=()) -> None:
        """One durability epoch in a single call: range clears
        first, then the epoch's FINAL per-key entries (the caller drops a
        set that a later clear in the same epoch overwrote, so this
        normalized order reproduces the in-order result; the op log
        records the same order for replay). A None entry is a point
        tombstone (atomic clear). The sorted key index merges ONCE per
        epoch — O(n + m) — instead of paying an O(n) insort per new key."""
        for b, e in clears:
            self.clear_range(b, e)
        new_keys: list = []
        dead: list = []
        for k, v in entries.items():
            if v is None:
                self._ops.u8(_OP_CLEAR).bytes_(k).bytes_(k + b"\x00")
                self._ops_count += 1
                if k in self._map:
                    del self._map[k]
                    dead.append(k)
                    if self.track_dirty:
                        self.dirty_keys.setdefault(k, True)
                continue
            if k not in self._map:
                if self.track_dirty:
                    self.dirty_keys.setdefault(k, False)
                new_keys.append(k)
            self._map[k] = v
            self._ops.u8(_OP_SET).bytes_(k).bytes_(v)
            self._ops_count += 1
        for k in dead:
            i = bisect.bisect_left(self._keys, k)
            self.keys_moved += len(self._keys) - i - 1
            del self._keys[i]
        if new_keys:
            new_keys.sort()
            self._keys, moved = merge_sorted_keys(self._keys, new_keys)
            self.keys_moved += moved

    async def commit(self) -> None:
        if self._ops_count:
            blob = self._ops.data()
            self._oplog_bytes += len(blob)
            self.dq.push(blob)
            self._ops = BinaryWriter()
            self._ops_count = 0
        await self.dq.commit()
        # snapshot when the op-log since the last snapshot dominates —
        # comparing against total queue bytes would re-snapshot the whole
        # dataset on every commit once it exceeds a fixed threshold
        if self._oplog_bytes > max(
            self.SNAPSHOT_AFTER_BYTES, self.dq.bytes_used - self._oplog_bytes
        ):
            await self._snapshot()

    async def _snapshot(self) -> None:
        w = BinaryWriter()
        w.u8(_SNAPSHOT).u32(len(self._map))
        for k in self._keys:
            w.bytes_(k).bytes_(self._map[k])
        offset = self.dq.push(w.data())
        await self.dq.commit()
        self.dq.pop(offset)
        await self.dq.commit()
        await self.dq.compact()
        self._oplog_bytes = 0

    # -- reads -----------------------------------------------------------------

    def take_dirty(self):
        """(added, removed): the exact key diff since the last call —
        keys absent before and present now, and vice versa. Keys that
        net out (add+clear, clear+re-add within the window) appear in
        neither."""
        d, self.dirty_keys = self.dirty_keys, {}
        added = [k for k, was in d.items() if not was and k in self._map]
        removed = [k for k, was in d.items() if was and k not in self._map]
        return added, removed

    def read_value(self, key: bytes):
        return self._map.get(key)

    def read_range(
        self, begin: bytes, end: bytes, limit: int = 1 << 30, reverse: bool = False
    ):
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        if reverse:
            # the LAST `limit` rows below `end` — O(limit), so a
            # reverse-limited storage read never materializes the shard
            ks = self._keys[max(lo, hi - limit) : hi]
            return [(k, self._map[k]) for k in reversed(ks)]
        out = []
        for k in self._keys[lo:hi]:
            out.append((k, self._map[k]))
            if len(out) >= limit:
                break
        return out

    def __len__(self) -> int:
        return len(self._map)
