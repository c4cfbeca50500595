"""RYW fuzz: random op sequences INSIDE one transaction, every read checked
against a transaction-local model mid-flight.

The analog of fdbserver/workloads/FuzzApiCorrectness.actor.cpp +
WriteDuringRead's RYW checking: the adversary for the read-your-writes
overlay (client/transaction.py) — write/clear/atomic-chain interleaved
with point reads, snapshot reads, and forward/reverse range reads with
limits, where every read must see (committed state + this txn's writes so
far). Also exercises the unreadable-range corner: reading a pending
versionstamped key must raise AccessedUnreadable, and reads elsewhere in
the transaction still work.

Commits are applied to the committed model via the same marker
disambiguation as ApiCorrectness; some transactions are abandoned
(reset) to check nothing leaks.
"""

from __future__ import annotations

import struct

from . import Workload
from ..errors import (
    AccessedUnreadable,
    CommitUnknownResult,
    NotCommitted,
    TransactionTooOld,
)
from ..kv.mutations import MutationType
from ._model import ModelStore
from .api_correctness import _ATOMICS


class RywFuzzWorkload(Workload):
    def __init__(
        self, db, rng, transactions=25, keys=24, ops_per_txn=10, **kw
    ):
        super().__init__(db, rng, **kw)
        self.transactions = transactions
        self.keys = keys
        self.ops_per_txn = ops_per_txn
        self.prefix = b"rywfuzz/c%d/" % self.client_id
        self.model = ModelStore()
        self._attempt = 0
        self.errors: list[str] = []

    def _key(self, i=None) -> bytes:
        if i is None:
            i = self.rng.random_int(0, self.keys)
        return self.prefix + b"k%04d" % i

    async def _fuzz_one(self) -> None:
        while True:
            self._attempt += 1
            attempt = self._attempt
            tr = self.db.transaction()
            local = self.model.copy()
            unreadable: set[bytes] = set()
            ok = await self._run_ops(tr, local, unreadable)
            if not ok:
                return  # a model mismatch was recorded; stop this txn
            if self.rng.coinflip(0.25):
                return  # abandoned transaction: must leave no trace
            marker = self.prefix + b"marker/%08d" % attempt
            tr.set(marker, b"x")
            local.set(marker, b"x")
            try:
                await tr.commit()
                committed = True
            except (NotCommitted, TransactionTooOld) as e:
                await tr.on_error(e)
                continue
            except CommitUnknownResult:
                # fence before probing (see ApiCorrectness._marker_exists:
                # a bare probe can read a GRV below the orphaned commit)
                async def fence(t):
                    t.set(self.prefix + b"fence", b"%d" % attempt)

                await self.db.run(fence)

                async def probe(t):
                    return await t.get(marker)

                committed = await self.db.run(probe) is not None
            if committed:
                # versionstamped keys land with the real stamp — the local
                # model can't predict them, so fold them in from the db
                self.model = local
                for body in unreadable:
                    self.model.clear_range(body, body + b"\xff")

                    async def sweep(t, body=body):
                        return await t.get_range(body, body + b"\xff")

                    for k, v in await self.db.run(sweep):
                        self.model.set(k, v)
                return
            # not committed: retry a fresh sequence

    async def _run_ops(self, tr, local, unreadable) -> bool:
        """Random ops; returns False when a mismatch was recorded."""
        for _ in range(1 + self.rng.random_int(0, self.ops_per_txn)):
            roll = self.rng.random01()
            if roll < 0.22:
                k, v = self._key(), b"v%d" % self.rng.random_int(0, 1 << 20)
                tr.set(k, v)
                local.set(k, v)
            elif roll < 0.32:
                k = self._key()
                tr.clear(k)
                local.clear(k)
            elif roll < 0.42:
                a = self.rng.random_int(0, self.keys)
                b = a + self.rng.random_int(0, max(2, self.keys // 3))
                tr.clear_range(self._key(a), self._key(b))
                local.clear_range(self._key(a), self._key(b))
            elif roll < 0.54:
                op = _ATOMICS[self.rng.random_int(0, len(_ATOMICS))]
                k = self._key()
                param = bytes(
                    self.rng.random_int(0, 256)
                    for _ in range(self.rng.random_choice([1, 4, 8]))
                )
                tr.atomic_op(op, k, param)
                local.atomic(op, k, param)
            elif roll < 0.60 and not unreadable:
                # pending versionstamped key: the literal placeholder key
                # is the unreadable WriteMap entry (the final key is
                # unknowable before commit)
                body = self.prefix + b"vs/%04d" % self.rng.random_int(0, 50)
                tr.set_versionstamped_key(
                    body + b"\x00" * 10 + struct.pack("<I", len(body)),
                    b"stamped",
                )
                unreadable.add(body)
            elif roll < 0.78:
                k = self._key()
                snapshot = self.rng.coinflip(0.3)
                got = await tr.get(k, snapshot=snapshot)
                want = local.get(k)
                if got != want:
                    self.errors.append(
                        f"in-txn get({k!r}, snap={snapshot}) = {got!r}, "
                        f"model {want!r}"
                    )
                    return False
            elif roll < 0.94:
                a = self.rng.random_int(0, self.keys)
                b = a + self.rng.random_int(1, max(2, self.keys // 2))
                lo, hi = self._key(a), self._key(b)
                reverse = self.rng.coinflip(0.4)
                limit = self.rng.random_choice([1, 2, 5, 64])
                got = await tr.get_range(lo, hi, limit=limit, reverse=reverse)
                want = local.get_range(lo, hi, limit=limit, reverse=reverse)
                if got != want:
                    self.errors.append(
                        f"in-txn range({lo!r},{hi!r},lim={limit},"
                        f"rev={reverse}) = {got} != {want}"
                    )
                    return False
            else:
                # unreadable corner: the pending versionstamped entry
                # lives at the literal placeholder key — a point read of
                # it, or a range read spanning it, MUST raise
                if unreadable:
                    body = next(iter(unreadable))
                    try:
                        if self.rng.coinflip():
                            await tr.get(body + b"\x00" * 10)
                            what = "point read"
                        else:
                            await tr.get_range(body, body + b"\xff", limit=64)
                            what = "range read"
                        self.errors.append(
                            f"{what} over unreadable {body!r} did not raise"
                        )
                        return False
                    except AccessedUnreadable:
                        pass
                    # a point read of the BARE body prefix is legal (it
                    # cannot be the stamped key) and must not throw
                    got = await tr.get(body)
                    want = local.get(body)
                    if got != want:
                        self.errors.append(
                            f"get({body!r}) near unreadable = {got!r}, "
                            f"model {want!r}"
                        )
                        return False
        return True

    async def start(self):
        for _ in range(self.transactions):
            await self._fuzz_one()
            if self.errors:
                return

    async def check(self) -> bool:
        async def sweep(tr):
            return await tr.get_range(
                self.prefix + b"k", self.prefix + b"k\xff"
            )

        got = await self.db.run(sweep)
        want = self.model.get_range(self.prefix + b"k", self.prefix + b"k\xff")
        if got != want:
            self.errors.append(
                f"final sweep: {got} != model {want}"
            )
        if self.errors:
            for e in self.errors[:5]:
                print("RywFuzz:", e)
        return not self.errors
