"""KernelChaos — contended read-modify-write traffic that must stay
exactly correct while the conflict kernel faults, fails over to the native
backend, and re-promotes (conflict/faults.py + conflict/failover.py).

The oracle here is a client-side ledger: several actors increment shared
counter keys through an idempotent retry loop; every increment that is
KNOWN to have committed is tallied. At check time each counter must equal
its tally exactly:

- a **false commit** during failover / journal replay (two increments
  admitted over the same snapshot) loses an update and breaks the
  equality;
- **conservative extra aborts** (the allowed degradation mode) only cost
  retries, never correctness.

``commit_unknown_result`` (a proxy erroring a batch whose resolver faulted
mid-flight) is disambiguated with a per-attempt marker key written in the
same transaction — the standard idempotent-retry pattern — so the ledger
stays exact under chaos.

The check phase also asserts commit AVAILABILITY recovered: a final probe
transaction must commit, i.e. an injected device loss bends into bounded
stalls and failover, never the old permanent ``resolver backend failed``.
"""

from __future__ import annotations

from ..errors import CommitUnknownResult, FdbError
from ..runtime.futures import delay, spawn, wait_for_all
from ..runtime.loop import Cancelled
from . import Workload


class KernelChaosWorkload(Workload):
    PREFIX = b"kchaos/"

    def __init__(self, db, rng, keys=4, actors=3, increments=8, **kw):
        super().__init__(db, rng, **kw)
        self.keys = keys
        self.actors = actors
        self.increments = increments
        self.tally: dict[bytes, int] = {}
        self.unknown_results = 0
        self.aborts = 0

    def _key(self, i: int) -> bytes:
        return self.PREFIX + b"k%02d" % i

    async def setup(self) -> None:
        if self.client_id != 0:
            return

        async def init(tr):
            for i in range(self.keys):
                tr.set(self._key(i), b"0")

        await self.db.run(init)

    async def _marker_committed(self, marker: bytes) -> bool:
        async def read(tr):
            return await tr.get(marker)

        return await self.db.run(read) is not None

    async def _increment(self, key: bytes, marker: bytes) -> None:
        """One exactly-once increment: retried until it is KNOWN committed
        (marker present), bounded so a wedged cluster fails the workload
        instead of spinning it."""
        for _attempt in range(60):
            tr = self.db.transaction()
            try:
                v = int(await tr.get(key))
                tr.set(key, b"%d" % (v + 1))
                tr.set(marker, b"1")
                await tr.commit()
                self.tally[key] = self.tally.get(key, 0) + 1
                return
            except Cancelled:
                raise
            except CommitUnknownResult:
                # may or may not have applied: the marker decides, so an
                # unknown result can never double-count the ledger
                self.unknown_results += 1
                await delay(0.05)
                if await self._marker_committed(marker):
                    self.tally[key] = self.tally.get(key, 0) + 1
                    return
            except FdbError as e:
                self.aborts += 1
                await tr.on_error(e)  # re-raises if not retryable
        raise AssertionError(f"increment of {key!r} never committed")

    async def start(self) -> None:
        async def actor(aid: int, rng) -> None:
            for seq in range(self.increments):
                key = self._key(rng.random_int(0, self.keys - 1))
                marker = self.PREFIX + b"m/%03d/%03d/%03d" % (
                    self.client_id,
                    aid,
                    seq,
                )
                await self._increment(key, marker)

        await wait_for_all(
            [
                spawn(actor(a, self.rng.fork()))
                for a in range(self.actors)
            ]
        )

    async def check(self) -> bool:
        async def read_all(tr):
            return [await tr.get(self._key(i)) for i in range(self.keys)]

        vals = await self.db.run(read_all)
        for i, raw in enumerate(vals):
            want = self.tally.get(self._key(i), 0)
            got = int(raw) if raw is not None else 0
            assert got == want, (
                f"counter {self._key(i)!r}: value {got} != {want} known "
                f"commits — a false commit slipped through the kernel "
                f"failover path"
            )

        # availability recovered: one more commit must go through
        async def probe(tr):
            tr.set(self.PREFIX + b"probe", b"ok")

        await self.db.run(probe)
        return True
