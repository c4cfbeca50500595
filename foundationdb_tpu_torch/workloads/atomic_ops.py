"""AtomicOps workload: concurrent atomic RMWs must sum exactly.

The analog of fdbserver/workloads/AtomicOps.actor.cpp: N clients blind-
ADD random deltas to shared counters and log every committed delta under
a versionstamped key; the check asserts each counter equals the sum of
its logged deltas — a lost, double-applied, or reordered atomic breaks
the equality. Exercises the full pipeline's atomic handling: RYW
coalescing, proxy pass-through, storage apply, engine replay after
reboots."""

from __future__ import annotations

import struct

from . import Workload
from ..errors import CommitUnknownResult, FdbError
from ..kv.mutations import MutationType


class AtomicOpsWorkload(Workload):
    COUNTERS = b"atomic/ctr/"
    LOG = b"atomic/log/"

    def __init__(self, db, rng, transactions=25, counters=4, **kw):
        super().__init__(db, rng, **kw)
        self.transactions = transactions
        self.counters = counters
        self._seq = 0

    async def _one(self):
        ctr = self.COUNTERS + b"%02d" % self.rng.random_int(0, self.counters)
        delta = self.rng.random_int(-50, 51)
        while True:
            self._seq += 1
            marker = self.LOG + b"%d/%08d" % (self.client_id, self._seq)
            tr = self.db.transaction()
            tr.atomic_op(
                MutationType.ADD, ctr, struct.pack("<q", delta)
            )
            # the delta log rides the same txn: committed iff the ADD is
            tr.set(marker, ctr + b"|" + struct.pack("<q", delta))
            try:
                await tr.commit()
                return
            except CommitUnknownResult:
                async def probe(t, marker=marker):
                    return await t.get(marker)

                if await self.db.run(probe) is not None:
                    return  # landed; retrying would double-count
            except FdbError as e:
                await tr.on_error(e)

    async def start(self):
        for _ in range(self.transactions):
            await self._one()

    async def check(self) -> bool:
        if self.client_id != 0:
            return True

        async def read(tr):
            ctrs = await tr.get_range(self.COUNTERS, self.COUNTERS + b"\xff")
            logs = await tr.get_range(self.LOG, self.LOG + b"\xff")
            return ctrs, logs

        ctrs, logs = await self.db.run(read)
        want: dict[bytes, int] = {}
        for _k, v in logs:
            ctr, raw = v.rsplit(b"|", 1)
            want[ctr] = want.get(ctr, 0) + struct.unpack("<q", raw)[0]
        got = {
            k: struct.unpack("<q", v.ljust(8, b"\x00")[:8])[0]
            for k, v in ctrs
        }
        for ctr, total in want.items():
            if got.get(ctr, 0) != total:
                print(
                    f"AtomicOps: {ctr} = {got.get(ctr, 0)}, "
                    f"logged deltas sum to {total}"
                )
                return False
        # counters with no logged delta must not exist
        for k in got:
            if k not in want:
                print(f"AtomicOps: spurious counter {k}")
                return False
        return True
