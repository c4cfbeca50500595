"""RandomClogging workload: network fault injection during other workloads.

The analog of fdbserver/workloads/RandomClogging.actor.cpp over the
simulator's clogging API (fdbrpc/sim2.actor.cpp SimClogging:114): while
correctness workloads run, random process pairs get their traffic delayed.
Everything must still pass — the retry machinery, long-polls, and version
gates have to absorb arbitrary delay.
"""

from __future__ import annotations

from ..runtime.futures import delay
from . import Workload


class RandomCloggingWorkload(Workload):
    def __init__(self, db, rng, duration=5.0, interval=0.5, **kw):
        super().__init__(db, rng, **kw)
        self.duration = duration
        self.interval = interval
        self.clogs = 0

    async def start(self):
        sim = self.db.sim
        addrs = list(sim.processes)
        t_end = sim.loop.now() + self.duration
        while sim.loop.now() < t_end:
            a = self.rng.random_choice(addrs)
            b = self.rng.random_choice(addrs)
            if a != b:
                sim.clog_pair(a, b, self.rng.random01() * self.interval * 2)
                self.clogs += 1
            await delay(self.interval * self.rng.random01())
