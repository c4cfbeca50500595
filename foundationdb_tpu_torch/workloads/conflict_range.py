"""ConflictRange workload: oracle-checked conflict detection.

The analog of fdbserver/workloads/ConflictRange.actor.cpp (+
MemoryKeyValueStore.h): two transactions race — A snapshots then reads
random ranges, B writes random keys and commits, then A writes and commits.
A model predicts exactly whether A must conflict (B's committed writes
intersect A's reads). Both false conflicts and missed conflicts fail.
"""

from __future__ import annotations

from ..errors import NotCommitted
from . import Workload


class ConflictRangeWorkload(Workload):
    def __init__(self, db, rng, rounds=30, keyspace=40, prefix=b"cr/", **kw):
        super().__init__(db, rng, **kw)
        self.rounds = rounds
        self.keys = [prefix + b"%03d" % i for i in range(keyspace)]
        self.prefix = prefix
        self.stats = {"conflict": 0, "clean": 0}

    def _rand_range(self):
        i = self.rng.random_int(0, len(self.keys))
        j = self.rng.random_int(0, len(self.keys))
        i, j = min(i, j), max(i, j)
        return self.keys[i], self.keys[j]

    async def start(self):
        for rnd in range(self.rounds):
            # A starts and reads ranges
            a = self.db.transaction()
            a_reads = []
            for _ in range(self.rng.random_int(1, 4)):
                begin, end = self._rand_range()
                await a.get_range(begin, end)
                a_reads.append((begin, end))

            # B writes keys and commits
            b = self.db.transaction()
            b_writes = []
            for _ in range(self.rng.random_int(1, 4)):
                k = self.rng.random_choice(self.keys)
                b.set(k, b"b%d" % rnd)
                b_writes.append(k)
            await b.commit()

            # A writes something and tries to commit
            a.set(self.prefix + b"result", b"a%d" % rnd)
            must_conflict = any(
                begin <= k < end for k in b_writes for begin, end in a_reads
            )
            try:
                await a.commit()
                conflicted = False
            except NotCommitted:
                conflicted = True
            assert conflicted == must_conflict, (
                f"round {rnd}: predicted conflict={must_conflict}, "
                f"got {conflicted} (reads={a_reads}, writes={b_writes})"
            )
            self.stats["conflict" if conflicted else "clean"] += 1

    async def check(self) -> bool:
        # both outcomes must actually occur over the run, or the test
        # proved nothing (reference asserts the same via its metrics)
        return self.stats["conflict"] > 0 and self.stats["clean"] > 0
