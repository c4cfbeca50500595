"""Cycle workload: transactional pointer-chasing over a ring.

The analog of fdbserver/workloads/Cycle.actor.cpp: keys 0..n-1 hold "next"
pointers forming one cycle. Each transaction splices a node to a new position
(3 reads, 3 writes). Serializability means the permutation stays a single
n-cycle no matter how many transactions race; a lost update or phantom read
breaks it. The final check walks the ring in one snapshot.
"""

from __future__ import annotations

from . import Workload


def _key(prefix: bytes, i: int) -> bytes:
    return prefix + b"%06d" % i


class CycleWorkload(Workload):
    def __init__(self, db, rng, nodes=20, transactions=50, prefix=b"cycle/", **kw):
        super().__init__(db, rng, **kw)
        self.nodes = nodes
        self.transactions = transactions
        self.prefix = prefix
        self.retries = 0

    async def setup(self):
        if self.client_id != 0:
            return

        async def init(tr):
            for i in range(self.nodes):
                tr.set(_key(self.prefix, i), b"%06d" % ((i + 1) % self.nodes))

        await self.db.run(init)

    async def start(self):
        for _ in range(self.transactions):
            a = self.rng.random_int(0, self.nodes)

            async def splice(tr, a=a):
                ka = _key(self.prefix, a)
                b = int(await tr.get(ka))
                if b == a:
                    return  # degenerate (n=1 ring segment), nothing to do
                kb = _key(self.prefix, b)
                c = int(await tr.get(kb))
                if c in (a, b):
                    return
                kc = _key(self.prefix, c)
                d = int(await tr.get(kc))
                # splice b out of a→b→c→d and back in after c: a→c→b→d
                tr.set(ka, b"%06d" % c)
                tr.set(kc, b"%06d" % b)
                tr.set(kb, b"%06d" % d)

            tries = 0

            async def counted(tr):
                nonlocal tries
                tries += 1
                await splice(tr)

            await self.db.run(counted)
            self.retries += tries - 1

    async def check(self) -> bool:
        if self.client_id != 0:
            return True
        tr = self.db.transaction()
        rows = await tr.get_range(self.prefix, self.prefix + b"\xff")
        if len(rows) != self.nodes:
            return False
        nxt = {int(k[len(self.prefix):]): int(v) for k, v in rows}
        seen, i = set(), 0
        for _ in range(self.nodes):
            if i in seen:
                return False
            seen.add(i)
            i = nxt[i]
        return i == 0 and len(seen) == self.nodes
