"""Subspace: a fixed key prefix + tuple-structured suffixes.

The analog of fdbclient/Subspace.cpp / bindings' subspace_impl.py."""

from __future__ import annotations

from . import tuple as tuple_layer


class Subspace:
    def __init__(self, prefix_tuple=(), raw_prefix: bytes = b""):
        self.raw_prefix = raw_prefix + tuple_layer.pack(prefix_tuple)

    def key(self) -> bytes:
        return self.raw_prefix

    def pack(self, t=()) -> bytes:
        return self.raw_prefix + tuple_layer.pack(t)

    def unpack(self, key: bytes) -> tuple:
        if not self.contains(key):
            raise ValueError("key not in subspace")
        return tuple_layer.unpack(key[len(self.raw_prefix) :])

    def contains(self, key: bytes) -> bool:
        return key.startswith(self.raw_prefix)

    def range(self, t=()) -> tuple[bytes, bytes]:
        p = self.pack(t)
        return p + b"\x00", p + b"\xff"

    def subspace(self, t) -> "Subspace":
        return Subspace(t, raw_prefix=self.raw_prefix)

    def __getitem__(self, item) -> "Subspace":
        return self.subspace((item,))

    def __repr__(self):
        return f"Subspace({self.raw_prefix!r})"
