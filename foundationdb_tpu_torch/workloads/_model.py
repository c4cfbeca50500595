"""In-memory model store for oracle-checked API fuzzing.

The reference checks its API against a `MemoryKeyValueStore`
(fdbserver/workloads/MemoryKeyValueStore.cpp) — a plain map with the same
range/clear semantics as the database. This is that store, plus helpers to
apply the client mutation vocabulary (including atomic ops, via the same
kv/atomic.py byte-op definitions the storage servers execute — byte-level
op semantics have their own unit tests; the fuzz targets the PIPELINE:
RYW overlay, conflict ranges, proxy substitution, storage apply)."""

from __future__ import annotations

from typing import Optional

from ..kv.atomic import apply_atomic
from ..kv.mutations import MutationType


class ModelStore:
    def __init__(self):
        self.data: dict[bytes, bytes] = {}

    def copy(self) -> "ModelStore":
        m = ModelStore()
        m.data = dict(self.data)
        return m

    def set(self, key: bytes, value: bytes) -> None:
        self.data[key] = value

    def clear(self, key: bytes) -> None:
        self.data.pop(key, None)

    def clear_range(self, begin: bytes, end: bytes) -> None:
        for k in [k for k in self.data if begin <= k < end]:
            del self.data[k]

    def atomic(self, op: MutationType, key: bytes, param: bytes) -> None:
        self.data[key] = apply_atomic(op, self.data.get(key), param)

    def get(self, key: bytes) -> Optional[bytes]:
        return self.data.get(key)

    def get_range(
        self, begin: bytes, end: bytes, limit: int = 1 << 30, reverse: bool = False
    ) -> list[tuple[bytes, bytes]]:
        rows = sorted(
            (k, v) for k, v in self.data.items() if begin <= k < end
        )
        if reverse:
            rows.reverse()
        return rows[:limit]
