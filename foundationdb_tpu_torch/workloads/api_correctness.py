"""ApiCorrectness: random single-writer API traffic diffed against a model.

The analog of fdbserver/workloads/ApiCorrectness.actor.cpp: each client owns
a sub-prefix, runs random mutation transactions (set / clear / clear_range /
every atomic op), mirrors each COMMITTED transaction into a ModelStore, and
continuously verifies point reads and range reads (forward/reverse, limits)
against the model from fresh transactions.

commit_unknown_result is disambiguated the way the reference's clients do:
every transaction also writes a per-attempt marker key; whether the marker
is readable afterwards decides whether the model applies the mutations.
"""

from __future__ import annotations

from . import Workload
from ..errors import CommitUnknownResult, NotCommitted, TransactionTooOld
from ..kv.mutations import MutationType
from ._model import ModelStore

_ATOMICS = [
    MutationType.ADD,
    MutationType.AND,
    MutationType.OR,
    MutationType.XOR,
    MutationType.MAX,
    MutationType.MIN,
    MutationType.BYTE_MAX,
    MutationType.BYTE_MIN,
    MutationType.APPEND_IF_FITS,
]


class ApiCorrectnessWorkload(Workload):
    def __init__(
        self,
        db,
        rng,
        transactions=40,
        keys=32,
        ops_per_txn=6,
        prefix=b"apicheck/",
        **kw,
    ):
        super().__init__(db, rng, **kw)
        self.transactions = transactions
        self.keys = keys
        self.ops_per_txn = ops_per_txn
        self.prefix = prefix + b"c%d/" % self.client_id
        self.model = ModelStore()
        self._attempt = 0
        self.errors: list[str] = []

    def _key(self, i=None) -> bytes:
        if i is None:
            i = self.rng.random_int(0, self.keys)
        return self.prefix + b"k%04d" % i

    def _marker(self, attempt: int) -> bytes:
        return self.prefix + b"marker/%08d" % attempt

    def _random_mutations(self):
        """[(kind, args)] applied identically to the txn and the model."""
        ops = []
        for _ in range(1 + self.rng.random_int(0, self.ops_per_txn)):
            roll = self.rng.random01()
            if roll < 0.40:
                ops.append(
                    ("set", self._key(), b"v%d" % self.rng.random_int(0, 1 << 20))
                )
            elif roll < 0.55:
                ops.append(("clear", self._key()))
            elif roll < 0.70:
                a = self.rng.random_int(0, self.keys)
                b = a + self.rng.random_int(0, max(2, self.keys // 4))
                ops.append(("clear_range", self._key(a), self._key(b)))
            else:
                op = _ATOMICS[self.rng.random_int(0, len(_ATOMICS))]
                width = self.rng.random_choice([1, 4, 8])
                param = bytes(
                    self.rng.random_int(0, 256) for _ in range(width)
                )
                ops.append(("atomic", op, self._key(), param))
        return ops

    @staticmethod
    def _apply(target, ops, is_model: bool):
        for op in ops:
            kind = op[0]
            if kind == "set":
                target.set(op[1], op[2])
            elif kind == "clear":
                target.clear(op[1])
            elif kind == "clear_range":
                target.clear_range(op[1], op[2])
            else:
                if is_model:
                    target.atomic(op[1], op[2], op[3])
                else:
                    target.atomic_op(op[1], op[2], op[3])

    async def _mutate_once(self) -> None:
        ops = self._random_mutations()
        while True:
            self._attempt += 1
            attempt = self._attempt
            tr = self.db.transaction()
            try:
                self._apply(tr, ops, is_model=False)
                tr.set(self._marker(attempt), b"x")
                await tr.commit()
                committed = True
            except (NotCommitted, TransactionTooOld) as e:
                await tr.on_error(e)
                continue
            except CommitUnknownResult:
                committed = await self._marker_exists(attempt)
            if committed:
                self._apply(self.model, ops, is_model=True)
                self.model.set(self._marker(attempt), b"x")
                return
            # genuinely not committed: retry with the same ops

    async def _marker_exists(self, attempt: int) -> bool:
        # FENCE first: an unknown result means the proxy died — possibly
        # after its tlog push. A plain probe could read a GRV below the
        # orphaned commit and wrongly decide "not committed". A successful
        # fence commit gets a version assigned AFTER the orphan's, so a
        # read after the fence sees the marker iff the orphan committed.
        async def fence(tr):
            # outside self.prefix: the final sweep compares that whole
            # range against the model, which doesn't track fences
            tr.set(b"apifence/" + self.prefix, b"%d" % attempt)

        await self.db.run(fence)

        async def body(tr):
            return await tr.get(self._marker(attempt))

        return await self.db.run(body) is not None

    async def _verify_once(self) -> None:
        roll = self.rng.random01()
        if roll < 0.5:
            key = self._key()

            async def body(tr):
                return await tr.get(key)

            got = await self.db.run(body)
            want = self.model.get(key)
            if got != want:
                self.errors.append(f"get({key!r}) = {got!r}, model {want!r}")
        else:
            a = self.rng.random_int(0, self.keys)
            b = a + self.rng.random_int(1, max(2, self.keys // 2))
            lo, hi = self._key(a), self._key(b)
            reverse = self.rng.coinflip(0.4)
            limit = self.rng.random_choice([1, 3, 1 << 30 if not reverse else 64])

            async def body(tr):
                return await tr.get_range(lo, hi, limit=limit, reverse=reverse)

            got = await self.db.run(body)
            want = self.model.get_range(lo, hi, limit=limit, reverse=reverse)
            if got != want:
                self.errors.append(
                    f"get_range({lo!r},{hi!r},lim={limit},rev={reverse}): "
                    f"{got} != model {want}"
                )

    async def start(self):
        for _ in range(self.transactions):
            await self._mutate_once()
            await self._verify_once()

    async def check(self) -> bool:
        # full final sweep: every key and the whole prefix range
        async def sweep(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff")

        got = await self.db.run(sweep)
        want = self.model.get_range(self.prefix, self.prefix + b"\xff")
        if got != want:
            self.errors.append(f"final sweep: {len(got)} rows != model {len(want)}")
        if self.errors:
            for e in self.errors[:5]:
                print("ApiCorrectness:", e)
        return not self.errors
