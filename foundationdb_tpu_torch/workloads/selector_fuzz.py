"""Selector fuzz: random key selectors checked against a model oracle.

The adversary for the key-selector subsystem (kv/selector.py, the
storage getKey endpoint, the client findKey loop, and the RYW overlay
resolution path) — the selector-flavored sibling of RywFuzz. Each
transaction interleaves writes/clears with random get_key and
selector-endpoint get_range calls; every resolution is checked against
reference-exact resolution over the transaction-local model
(kv/selector.resolve). Under the soak's random cluster shapes the data
prefix spans storage teams, so walks cross shard boundaries and exercise
the partially-resolved continuation protocol.

The model only knows THIS workload's keys, so expectations clamp at the
prefix edges (the bindingtester's prefix-window discipline): a walk the
model resolves inside our keyspace must resolve identically for real —
no foreign keys can sort between ours — while a walk the model resolves
off either end must land outside the prefix for real (b""/below-prefix,
or at/above strinc(prefix)).
"""

from __future__ import annotations

from . import Workload
from ..client.transaction import strinc
from ..errors import CommitUnknownResult, NotCommitted, TransactionTooOld
from ..kv.selector import SELECTOR_END, KeySelector, resolve
from ._model import ModelStore


class SelectorFuzzWorkload(Workload):
    def __init__(
        self, db, rng, transactions=12, keys=20, ops_per_txn=8, **kw
    ):
        super().__init__(db, rng, **kw)
        self.transactions = transactions
        self.keys = keys
        self.ops_per_txn = ops_per_txn
        self.prefix = b"selfuzz/c%d/" % self.client_id
        self.model = ModelStore()
        self._attempt = 0
        self.errors: list[str] = []

    def _key(self, i=None) -> bytes:
        if i is None:
            i = self.rng.random_int(0, self.keys)
        return self.prefix + b"k%04d" % i

    def _selector(self) -> KeySelector:
        anchor = self._key()
        ctor = self.rng.random_choice(
            [
                KeySelector.first_greater_or_equal,
                KeySelector.first_greater_than,
                KeySelector.last_less_than,
                KeySelector.last_less_or_equal,
            ]
        )
        sel = ctor(anchor)
        shift = self.rng.random_int(0, 7) - 3
        return sel + shift if shift >= 0 else sel - (-shift)

    def _check_resolution(self, what, sel, got, expected) -> bool:
        """Clamped oracle check (module doc): exact inside the prefix,
        directional outside it."""
        if expected == b"":
            ok = got < self.prefix
        elif expected == SELECTOR_END:
            ok = got >= strinc(self.prefix)
        else:
            ok = got == expected
        if not ok:
            self.errors.append(
                f"{what} {sel!r} = {got!r}, model expected {expected!r}"
            )
        return ok

    async def _fuzz_one(self) -> None:
        while True:
            self._attempt += 1
            tr = self.db.transaction()
            local = self.model.copy()
            if not await self._run_ops(tr, local):
                return  # mismatch recorded; stop this txn
            if self.rng.coinflip(0.3):
                return  # abandoned transaction: must leave no trace
            marker = self.prefix + b"marker/%08d" % self._attempt
            tr.set(marker, b"x")
            local.set(marker, b"x")
            try:
                await tr.commit()
                committed = True
            except (NotCommitted, TransactionTooOld) as e:
                await tr.on_error(e)
                continue
            except CommitUnknownResult:
                # fence before probing (ApiCorrectness._marker_exists: a
                # bare probe can read a GRV below the orphaned commit).
                # The fence key lives inside our prefix, so selector
                # walks see it: it must be modeled on both sides
                fence_key = self.prefix + b"fence"
                fence_val = b"%d" % self._attempt

                async def fence(t):
                    t.set(fence_key, fence_val)

                await self.db.run(fence)
                self.model.set(fence_key, fence_val)
                local.set(fence_key, fence_val)

                async def probe(t):
                    return await t.get(marker)

                committed = await self.db.run(probe) is not None
            if committed:
                self.model = local
                return

    def _local_keys(self, local) -> list[bytes]:
        return sorted(local.data)

    async def _run_ops(self, tr, local) -> bool:
        for _ in range(1 + self.rng.random_int(0, self.ops_per_txn)):
            roll = self.rng.random01()
            if roll < 0.20:
                k, v = self._key(), b"v%d" % self.rng.random_int(0, 1 << 20)
                tr.set(k, v)
                local.set(k, v)
            elif roll < 0.30:
                k = self._key()
                tr.clear(k)
                local.clear(k)
            elif roll < 0.38:
                a = self.rng.random_int(0, self.keys)
                b = a + self.rng.random_int(0, max(2, self.keys // 3))
                tr.clear_range(self._key(a), self._key(b))
                local.clear_range(self._key(a), self._key(b))
            elif roll < 0.72:
                sel = self._selector()
                snapshot = self.rng.coinflip(0.4)
                got = await tr.get_key(sel, snapshot=snapshot)
                expected = resolve(self._local_keys(local), sel)
                if not self._check_resolution("get_key", sel, got, expected):
                    return False
            else:
                bsel, esel = self._selector(), self._selector()
                reverse = self.rng.coinflip(0.3)
                got = await tr.get_range(
                    bsel, esel, limit=4096, reverse=reverse,
                    snapshot=self.rng.coinflip(0.4),
                )
                got = [(k, v) for k, v in got if k.startswith(self.prefix)]
                ks = self._local_keys(local)
                lo = max(resolve(ks, bsel), self.prefix)
                hi = min(resolve(ks, esel), strinc(self.prefix))
                want = local.get_range(lo, hi) if lo < hi else []
                if reverse:
                    want = list(reversed(want))
                if got != want:
                    self.errors.append(
                        f"selector range ({bsel!r}, {esel!r}, rev={reverse})"
                        f" = {got} != model {want}"
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
                KeySelector.first_greater_or_equal(self.prefix),
                KeySelector.first_greater_or_equal(strinc(self.prefix)),
            )

        got = [
            (k, v)
            for k, v in await self.db.run(sweep)
            if k.startswith(self.prefix)
        ]
        want = self.model.get_range(self.prefix, strinc(self.prefix))
        if got != want:
            self.errors.append(f"final selector sweep: {got} != model {want}")
        if self.errors:
            for e in self.errors[:5]:
                print("SelectorFuzz:", e)
        return not self.errors
