"""WriteDuringRead workload: RYW-semantics fuzz against a model.

The analog of fdbserver/workloads/WriteDuringRead.actor.cpp: one transaction
performs a random interleaving of reads and writes (sets, clears, range
clears, atomic ops, gets, range reads); every read is compared against an
in-memory model applying the same operations. After commit, the database
state must equal the model; after an abandoned transaction, it must not
change.
"""

from __future__ import annotations

from ..kv.atomic import apply_atomic
from ..kv.mutations import ATOMIC_OPS, MutationType
from . import Workload

OPS = list(ATOMIC_OPS - {MutationType.COMPARE_AND_CLEAR})


class WriteDuringReadWorkload(Workload):
    def __init__(self, db, rng, rounds=10, ops_per_round=30, keyspace=12,
                 prefix=b"wdr/", **kw):
        super().__init__(db, rng, **kw)
        self.rounds = rounds
        self.ops = ops_per_round
        self.keys = [prefix + b"%02d" % i for i in range(keyspace)]
        self.prefix = prefix
        self.model: dict[bytes, bytes] = {}

    def _rand_key(self) -> bytes:
        return self.rng.random_choice(self.keys)

    def _rand_range(self):
        a, b = self._rand_key(), self._rand_key()
        return (a, b) if a <= b else (b, a)

    async def _one_op(self, tr) -> None:
        r = self.rng.random01()
        if r < 0.25:
            k = self._rand_key()
            got = await tr.get(k)
            assert got == self.model.get(k), (k, got, self.model.get(k))
        elif r < 0.4:
            a, b = self._rand_range()
            got = await tr.get_range(a, b)
            want = sorted((k, v) for k, v in self.model.items() if a <= k < b)
            assert got == want, (a, b, got, want)
        elif r < 0.6:
            k, v = self._rand_key(), b"v%04d" % self.rng.random_int(0, 10000)
            tr.set(k, v)
            self.model[k] = v
        elif r < 0.7:
            a, b = self._rand_range()
            tr.clear_range(a, b)
            for k in [k for k in self.model if a <= k < b]:
                del self.model[k]
        elif r < 0.8:
            k = self._rand_key()
            tr.clear(k)
            self.model.pop(k, None)
        else:
            op = self.rng.random_choice(OPS)
            k = self._rand_key()
            param = bytes([self.rng.random_int(0, 256) for _ in range(2)])
            new = apply_atomic(op, self.model.get(k), param)
            tr.atomic_op(op, k, param)
            if new is None:
                self.model.pop(k, None)
            else:
                self.model[k] = new

    async def start(self):
        for rnd in range(self.rounds):
            committed_model = dict(self.model)
            tr = self.db.transaction()
            for _ in range(self.ops):
                await self._one_op(tr)
            if self.rng.coinflip(0.8):
                await tr.commit()
            else:
                self.model = committed_model  # abandoned txn changes nothing

    async def check(self) -> bool:
        tr = self.db.transaction()
        rows = await tr.get_range(self.prefix, self.prefix + b"\xff")
        return rows == sorted(self.model.items())
