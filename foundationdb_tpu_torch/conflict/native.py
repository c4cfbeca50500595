"""ctypes binding for the native C++ versioned-skip-list conflict set.

The CPU baseline beside the device backends, and the guard's failover
target (conflict/failover.py). The port keeps its own copy of the source,
``foundationdb_tpu_torch/native/skiplist_conflict.cpp``, and builds it at
first use into the git-ignored ``build/native/`` at the repository root
(``foundationdb_tpu_torch/cxx.py``). Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .. import cxx
from .api import CommitTransaction, ConflictSet, Verdict

_SRC = cxx.NATIVE_DIR / "skiplist_conflict.cpp"
BUILD_DIR = cxx.BUILD_DIR
_lib = None
_lock = threading.Lock()


def lib_path():
    return cxx.lib_path(_SRC, BUILD_DIR)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(cxx.load(_SRC, BUILD_DIR))
        return _lib


def _bind(lib):
    lib.csn_create.restype = ctypes.c_void_p
    lib.csn_destroy.argtypes = [ctypes.c_void_p]
    lib.csn_count.argtypes = [ctypes.c_void_p]
    lib.csn_count.restype = ctypes.c_int64
    lib.csn_set_oldest.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.csn_resolve.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,  # keys
        np.ctypeslib.ndpointer(np.uint64),  # offsets
        np.ctypeslib.ndpointer(np.int32),  # reads
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32),  # writes
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64),  # snapshots
        ctypes.c_int32,
        ctypes.c_int64,  # now
        ctypes.c_int64,  # new_oldest
        np.ctypeslib.ndpointer(np.uint8),  # verdicts out
    ]
    return lib


class NativeConflictSet(ConflictSet):
    def __init__(self) -> None:
        super().__init__()
        self._lib = _load()
        self._cs = self._lib.csn_create()

    def __del__(self):
        if getattr(self, "_cs", None):
            self._lib.csn_destroy(self._cs)
            self._cs = None

    def clear(self, version: int) -> None:
        self._lib.csn_destroy(self._cs)
        self._cs = self._lib.csn_create()
        self._lib.csn_set_oldest(self._cs, version)
        self.oldest_version = version

    @property
    def boundary_count(self) -> int:
        return self._lib.csn_count(self._cs)

    def encode_batch(self, transactions: list[CommitTransaction]):
        """Pack a batch into the flat C ABI arrays (reusable across calls)."""
        keys: list[bytes] = []
        reads: list[int] = []
        writes: list[int] = []
        snaps = np.zeros(max(len(transactions), 1), np.int64)

        def add_key(k: bytes) -> int:
            keys.append(k)
            return len(keys) - 1

        for t, tr in enumerate(transactions):
            snaps[t] = tr.read_snapshot
            for (b, e) in tr.read_conflict_ranges:
                reads.extend((add_key(b), add_key(e), t))
            for (b, e) in tr.write_conflict_ranges:
                writes.extend((add_key(b), add_key(e), t))

        blob = b"".join(keys)
        offsets = np.zeros(len(keys) + 1, np.uint64)
        np.cumsum([len(k) for k in keys], out=offsets[1:])
        r = np.asarray(reads or [0], np.int32)
        w = np.asarray(writes or [0], np.int32)
        return (
            blob,
            offsets,
            r,
            len(reads) // 3,
            w,
            len(writes) // 3,
            snaps,
            len(transactions),
        )

    def resolve_encoded(self, enc, now: int, new_oldest_version: int) -> np.ndarray:
        blob, offsets, r, nr, w, nw, snaps, nt = enc
        verdicts = np.zeros(max(nt, 1), np.uint8)
        self._lib.csn_resolve(
            self._cs, blob, offsets, r, nr, w, nw, snaps, nt,
            now, new_oldest_version, verdicts,
        )
        if new_oldest_version > self.oldest_version:
            self.oldest_version = new_oldest_version
        return verdicts[:nt]

    def detect_batch(
        self, transactions: list[CommitTransaction], now: int, new_oldest_version: int
    ) -> list[Verdict]:
        enc = self.encode_batch(transactions)
        out = self.resolve_encoded(enc, now, new_oldest_version)
        return [Verdict(int(v)) for v in out]
