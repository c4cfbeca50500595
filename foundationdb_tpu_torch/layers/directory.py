"""Directory layer: named hierarchies of short key prefixes.

The analog of the bindings' directory layer (directory_impl.py /
bindings/flow Directory): paths like ("app", "users") map to compact
allocated prefixes, with the mapping itself stored transactionally in the
database under a node subspace. Supports create/open/create_or_open,
list, and remove. (The reference's HCA allocator is approximated with a
transactional counter — contended allocations retry through the normal
conflict machinery.)
"""

from __future__ import annotations

from . import tuple as tuple_layer
from .subspace import Subspace

_NODE_PREFIX = b"\xfe"
_COUNTER_KEY = b"\xfe\x00alloc"
_PREFIX_BASE = b"\x15"  # allocated data prefixes start here


class DirectoryLayer:
    def __init__(self, node_prefix: bytes = _NODE_PREFIX):
        self.nodes = Subspace(raw_prefix=node_prefix + b"nodes/")

    def _node_key(self, path: tuple) -> bytes:
        return self.nodes.pack((tuple(path),))

    async def create_or_open(self, tr, path) -> Subspace:
        path = tuple(path)
        existing = await tr.get(self._node_key(path))
        if existing is not None:
            return Subspace(raw_prefix=existing)
        return await self.create(tr, path)

    async def open(self, tr, path) -> Subspace:
        path = tuple(path)
        prefix = await tr.get(self._node_key(path))
        if prefix is None:
            raise KeyError(f"directory {path} does not exist")
        return Subspace(raw_prefix=prefix)

    async def create(self, tr, path) -> Subspace:
        path = tuple(path)
        if await tr.get(self._node_key(path)) is not None:
            raise KeyError(f"directory {path} already exists")
        # parents must exist (auto-create, like the reference)
        if len(path) > 1:
            await self.create_or_open(tr, path[:-1])
        # allocate the next short prefix from the counter
        raw = await tr.get(_COUNTER_KEY)
        n = int.from_bytes(raw, "big") if raw else 0
        tr.set(_COUNTER_KEY, (n + 1).to_bytes(8, "big"))
        prefix = _PREFIX_BASE + tuple_layer.pack((n,))
        tr.set(self._node_key(path), prefix)
        return Subspace(raw_prefix=prefix)

    async def list(self, tr, path=()) -> list:
        path = tuple(path)
        begin, end = self.nodes.range()
        rows = await tr.get_range(begin, end)
        out = []
        for k, _v in rows:
            (p,) = self.nodes.unpack(k)
            if len(p) == len(path) + 1 and tuple(p[: len(path)]) == path:
                out.append(p[-1])
        return out

    async def exists(self, tr, path) -> bool:
        return await tr.get(self._node_key(tuple(path))) is not None

    async def remove(self, tr, path) -> None:
        """Remove the directory, its subdirectories, and all contents."""
        path = tuple(path)
        prefix = await tr.get(self._node_key(path))
        if prefix is None:
            raise KeyError(f"directory {path} does not exist")
        # clear contents of this dir and every descendant
        begin, end = self.nodes.range()
        for k, v in await tr.get_range(begin, end):
            (p,) = self.nodes.unpack(k)
            if tuple(p[: len(path)]) == path:
                tr.clear_range(v, v + b"\xff")
                tr.clear(k)
