"""Serial-MVCC model database: the bindingtester's second 'binding'.

An independent, dead-simple implementation of the client Transaction
surface over a versioned dict — the oracle the real client is diffed
against (the reference diffs two real bindings; with one binding, the
model plays the other side). Serial interleaving only (the stack machine
executes one instruction at a time), but transactions from the machine's
transaction MAP can interleave reads/writes/commits, so commits check
read ranges against writes committed after the read version — the same
conflict rule the resolvers enforce.

Reference provenance: semantics from fdbclient/ReadYourWrites.actor.cpp
(overlay rules) + SkipList.cpp conflict rule; structure original.
"""

from __future__ import annotations

import bisect

from ..errors import FdbError, NotCommitted, TransactionTooOld
from ..kv.atomic import apply_atomic
from ..kv.mutations import MutationType
from ..kv.selector import SELECTOR_END, KeySelector, as_selector
from ..runtime.loop import Cancelled


class ModelDatabase:
    def __init__(self):
        self.data: dict[bytes, bytes] = {}
        self.version = 1
        # committed write ranges: [(version, begin, end)]
        self._writes: list[tuple[int, bytes, bytes]] = []
        # full snapshot per committed version: SET_READ_VERSION pins a
        # transaction to an OLDER version and its reads must see that
        # state (tiny at tester scale; the real MVCC storage is the thing
        # under test, not this)
        self.history: dict[int, dict[bytes, bytes]] = {1: {}}

    def transaction(self) -> "ModelTransaction":
        return ModelTransaction(self)

    async def run(self, body):
        while True:
            tr = self.transaction()
            try:
                result = await body(tr)
                await tr.commit()
                return result
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception as e:
                await tr.on_error(e)

    def _commit(self, tr) -> int:
        for rb, re_ in tr._rcr:
            for v, wb, we in self._writes:
                if v > tr._read_version and rb < we and wb < re_:
                    raise NotCommitted()
        self.version += 1
        for op, k, p in tr._ops:
            if op == "set":
                self.data[k] = p
            elif op == "clear_range":
                for kk in [x for x in self.data if k <= x < p]:
                    del self.data[kk]
            else:  # atomic
                nv = apply_atomic(op, self.data.get(k), p)
                if nv is None:
                    self.data.pop(k, None)
                else:
                    self.data[k] = nv
        for wb, we in tr._wcr:
            self._writes.append((self.version, wb, we))
        self.history[self.version] = dict(self.data)
        return self.version


def _key_after(k: bytes) -> bytes:
    return k + b"\x00"


class ModelTransaction:
    def __init__(self, db: ModelDatabase):
        self.db = db
        self._read_version = None
        self._snapshot: dict[bytes, bytes] = None
        self._ops: list = []  # ("set"|"clear_range"|MutationType, k, p)
        self._rcr: list[tuple[bytes, bytes]] = []
        self._wcr: list[tuple[bytes, bytes]] = []
        self.committed_version = None

    async def get_read_version(self) -> int:
        if self._read_version is None:
            self._read_version = self.db.version
            self._snapshot = dict(self.db.data)
        return self._read_version

    def set_read_version(self, v: int) -> None:
        self._read_version = v
        eligible = [h for h in self.db.history if h <= v]
        self._snapshot = (
            dict(self.db.history[max(eligible)]) if eligible else {}
        )

    def _visible(self, key: bytes):
        v = self._snapshot.get(key)
        for op, k, p in self._ops:
            if op == "set":
                if k == key:
                    v = p
            elif op == "clear_range":
                if k <= key < p:
                    v = None
            elif k == key:
                v = apply_atomic(op, v, p)
        return v

    def _determine(self, key: bytes):
        """Mirror the real overlay's provenance states (transaction.py
        get): ('value', v) = determined by own writes alone, ('cleared',
        None) = own clear, ('chain', ops) = atomic chain over an unread
        base, (None, None) = untouched. Pin timing depends on this: only
        reads that must observe the DATABASE pin the read version."""
        state, val = None, None
        chain: list = []
        for op, k, p in self._ops:
            if op == "set":
                if k == key:
                    state, val, chain = "value", p, []
            elif op == "clear_range":
                if k <= key < p:
                    state, val, chain = "cleared", None, []
            elif k == key:
                if state in ("value", "cleared"):
                    state, val = "value", apply_atomic(op, val, p)
                else:
                    state = "chain"
                    chain.append((op, p))
        return state, val, chain

    async def get(self, key: bytes, snapshot: bool = False):
        state, val, chain = self._determine(key)
        if state == "value":
            # fully determined by own writes: no read conflict, no pin
            return val
        if state == "cleared":
            if not snapshot:
                self._rcr.append((key, _key_after(key)))
            return val
        if not snapshot:
            self._rcr.append((key, _key_after(key)))
        await self.get_read_version()  # observes the database: pin here
        v = self._snapshot.get(key)
        for op, p in chain:
            v = apply_atomic(op, v, p)
        return v

    def _visible_keys(self) -> list[bytes]:
        """Sorted keys present through this txn's overlay, excluding the
        system keyspace — the key list selector walks navigate."""
        keys = set(self._snapshot)
        for op, k, _p in self._ops:
            if op != "clear_range":
                keys.add(k)
        return sorted(
            k
            for k in keys
            if k < SELECTOR_END and self._visible(k) is not None
        )

    async def get_key(self, selector, snapshot: bool = False) -> bytes:
        """Reference-exact selector resolution over the overlay-visible
        key list, with the same conflict span and read-version pin timing
        as the real client (transaction.py get_key) — conformance diffs
        the two instruction-for-instruction."""
        k, off = as_selector(selector).normalized()
        await self.get_read_version()
        keys = self._visible_keys()
        i = bisect.bisect_left(keys, k) - 1 + off
        if i < 0:
            resolved = b""
        elif i >= len(keys):
            resolved = SELECTOR_END
        else:
            resolved = keys[i]
        if off >= 1:
            lo = k
            hi = _key_after(resolved) if resolved < SELECTOR_END else SELECTOR_END
        else:
            lo, hi = resolved, min(k, SELECTOR_END)
        if lo < hi and not snapshot:
            self._rcr.append((lo, hi))
        return resolved

    async def get_range(
        self,
        begin,
        end,
        limit: int = 1 << 30,
        reverse: bool = False,
        snapshot: bool = False,
    ):
        if isinstance(begin, KeySelector) or isinstance(end, KeySelector):
            b = (
                begin
                if not isinstance(begin, KeySelector)
                else await self.get_key(begin, snapshot=True)
            )
            e = (
                end
                if not isinstance(end, KeySelector)
                else await self.get_key(end, snapshot=True)
            )
            if b >= e:
                return []
            return await self.get_range(
                b, e, limit=limit, reverse=reverse, snapshot=snapshot
            )
        await self.get_read_version()
        keys = set(self._snapshot)
        for op, k, _p in self._ops:
            if op != "clear_range":
                keys.add(k)
        rows = []
        for k in sorted(keys, reverse=reverse):
            if not (begin <= k < end):
                continue
            v = self._visible(k)
            if v is not None:
                rows.append((k, v))
            if len(rows) >= limit:
                break
        if not snapshot:
            # clamp at the last observed key like the real client
            if rows and len(rows) >= limit:
                if reverse:
                    self._rcr.append((rows[-1][0], end))
                else:
                    self._rcr.append((begin, _key_after(rows[-1][0])))
            else:
                self._rcr.append((begin, end))
        return rows

    def set(self, key: bytes, value: bytes) -> None:
        self._ops.append(("set", key, value))
        self._wcr.append((key, _key_after(key)))

    def clear(self, key: bytes) -> None:
        self.clear_range(key, _key_after(key))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        if begin >= end:
            return
        self._ops.append(("clear_range", begin, end))
        self._wcr.append((begin, end))

    def atomic_op(self, op: MutationType, key: bytes, param: bytes) -> None:
        self._ops.append((op, key, param))
        self._wcr.append((key, _key_after(key)))

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._rcr.append((begin, end))

    def add_write_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._wcr.append((begin, end))

    async def commit(self) -> int:
        if not self._ops and not self._wcr:
            self.committed_version = self._read_version or 0
            return self.committed_version
        await self.get_read_version()
        self.committed_version = self.db._commit(self)
        return self.committed_version

    def reset(self) -> None:
        self.__init__(self.db)

    async def on_error(self, e: Exception) -> None:
        # mirror the real client's predicate (transaction.py on_error):
        # any retryable FdbError resets; everything else re-raises
        if isinstance(e, FdbError) and e.retryable:
            self.reset()
            return
        raise e
