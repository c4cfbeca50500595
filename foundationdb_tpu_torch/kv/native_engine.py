"""ctypes binding for the native C++ copy-on-write B-tree engine — port of
``foundationdb_tpu/kv/native_engine.py``.

The disk-resident IKeyValueStore (the role of the reference's modified
sqlite btree, fdbserver/KeyValueStoreSQLite.actor.cpp) — same interface as
kv.engine.KeyValueStoreMemory, for real deployments and benchmarks (the
simulator uses the Python engines on SimDisk for determinism, mirroring
how the reference runs sqlite on simulated files).

The port keeps its own copy of the source,
``foundationdb_tpu_torch/native/btree_kvstore.cpp``, with the JAX package's
on-disk format, and builds it at first use into the git-ignored
``build/native/`` at the repository root (``foundationdb_tpu_torch/cxx.py``).
A failed build or load raises; nothing is built at import. A read copies
only the row's bytes out of the reusable buffers (a slice of the ctypes
array, where ``.raw`` would first copy the whole 1 MiB value buffer).
"""

from __future__ import annotations

import ctypes
import threading

from .. import cxx

_SRC = cxx.NATIVE_DIR / "btree_kvstore.cpp"
BUILD_DIR = cxx.BUILD_DIR
_lib = None
_lock = threading.Lock()

_MAX_VALUE = 1 << 20


def lib_path():
    return cxx.lib_path(_SRC, BUILD_DIR)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(cxx.load(_SRC, BUILD_DIR))
        return _lib


def _bind(lib):
    lib.bt_open.restype = ctypes.c_void_p
    lib.bt_open.argtypes = [ctypes.c_char_p]
    lib.bt_close.argtypes = [ctypes.c_void_p]
    lib.bt_set.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.bt_clear_range.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.bt_commit.argtypes = [ctypes.c_void_p]
    lib.bt_get.restype = ctypes.c_int64
    lib.bt_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.bt_range_open.restype = ctypes.c_void_p
    lib.bt_range_open.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.bt_cursor_next.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.bt_cursor_current.argtypes = lib.bt_cursor_next.argtypes
    lib.bt_cursor_close.argtypes = [ctypes.c_void_p]
    lib.bt_stats.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    return lib


class KeyValueStoreBTree:
    """IKeyValueStore over the native B-tree (kv.engine-compatible)."""

    def __init__(self, path: str):
        self._lib = _load()
        self.path = path
        self._h = self._lib.bt_open(path.encode())
        if not self._h:
            raise OSError(f"bt_open failed: {path}")
        self._vbuf = ctypes.create_string_buffer(_MAX_VALUE)
        self._kbuf = ctypes.create_string_buffer(1 << 14)

    async def recover(self) -> None:
        pass  # bt_open already recovered the latest committed epoch

    def set(self, key: bytes, value: bytes) -> None:
        rc = self._lib.bt_set(self._h, key, len(key), value, len(value))
        if rc != 0:
            raise ValueError(f"bt_set failed (rc={rc}; key too large?)")

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._lib.bt_clear_range(self._h, begin, len(begin), end, len(end))

    async def commit(self) -> None:
        rc = self._lib.bt_commit(self._h)
        if rc != 0:
            raise OSError(f"bt_commit failed: {rc}")

    def read_value(self, key: bytes):
        n = self._lib.bt_get(self._h, key, len(key), self._vbuf, len(self._vbuf))
        if n < 0:
            return None
        if n > len(self._vbuf):
            # value larger than the buffer: grow and re-read (bt_get never
            # truncates silently — it reports the true length)
            self._vbuf = ctypes.create_string_buffer(int(n))
            n = self._lib.bt_get(self._h, key, len(key), self._vbuf, len(self._vbuf))
        return self._vbuf[:n]

    def read_range(self, begin: bytes, end: bytes, limit: int = 1 << 30):
        cur = self._lib.bt_range_open(self._h, begin, len(begin), end, len(end))
        out = []
        klen = ctypes.c_int64()
        vlen = ctypes.c_int64()
        try:
            while len(out) < limit:
                rc = self._lib.bt_cursor_next(
                    cur,
                    self._kbuf, len(self._kbuf), ctypes.byref(klen),
                    self._vbuf, len(self._vbuf), ctypes.byref(vlen),
                )
                if rc == 0:
                    break
                if rc == -1:
                    # row held in the cursor; grow and re-copy
                    if klen.value > len(self._kbuf):
                        self._kbuf = ctypes.create_string_buffer(int(klen.value))
                    if vlen.value > len(self._vbuf):
                        self._vbuf = ctypes.create_string_buffer(int(vlen.value))
                    rc = self._lib.bt_cursor_current(
                        cur,
                        self._kbuf, len(self._kbuf), ctypes.byref(klen),
                        self._vbuf, len(self._vbuf), ctypes.byref(vlen),
                    )
                    assert rc == 1
                out.append((self._kbuf[: klen.value], self._vbuf[: vlen.value]))
        finally:
            self._lib.bt_cursor_close(cur)
        return out

    def stats(self):
        e = ctypes.c_uint64()
        p = ctypes.c_uint64()
        lb = ctypes.c_uint64()
        self._lib.bt_stats(self._h, ctypes.byref(e), ctypes.byref(p), ctypes.byref(lb))
        return {"epoch": e.value, "pages": p.value, "live_bytes": lb.value}

    def close(self) -> None:
        if self._h:
            self._lib.bt_close(self._h)
            self._h = None

    def __len__(self) -> int:
        return len(self.read_range(b"", b"\xff\xff\xff\xff\xff\xff"))
