"""Watches workload: every fired watch reflects a real change.

The analog of fdbserver/workloads/Watches.actor.cpp: a setter cycles a
key through distinct values; a watcher registers a watch at each observed
value and, when it fires, re-reads — the value MUST differ from the
watched one (a spurious fire) and every value the setter committed must
eventually be observed (a lost wakeup hangs the workload and fails the
run's time limit)."""

from __future__ import annotations

from . import Workload
from ..runtime.futures import delay


class WatchesWorkload(Workload):
    def __init__(self, db, rng, changes=15, key=b"watch/k", **kw):
        super().__init__(db, rng, **kw)
        self.changes = changes
        self.key = key
        self.observed = 0
        self.spurious = 0

    async def _setter(self):
        for i in range(self.changes):
            async def w(tr, i=i):
                tr.set(self.key, b"v%04d" % i)

            await self.db.run(w)
            await delay(self.rng.random01() * 0.1)

    async def _watcher(self):
        final = b"v%04d" % (self.changes - 1)
        last = None
        while last != final:
            tr = self.db.transaction()
            cur = await tr.get(self.key)
            if cur != last:
                # watches legitimately coalesce intermediate values; count
                # the distinct ones we did observe
                last = cur
                if cur is not None:
                    self.observed += 1
                continue
            fut = tr.watch(self.key)
            await tr.commit()
            fired_value = await fut
            # a genuine fire reports a CHANGED value. (Re-reading can
            # legitimately still see the old value: the storage applies —
            # and fires — after the tlog push but before the commit's
            # phase-5 ack, so a racing GRV may lag the fire, especially
            # across a recovery.)
            if fired_value == cur:
                self.spurious += 1

    async def start(self):
        from ..runtime.futures import spawn, wait_for_all

        await wait_for_all([spawn(self._setter()), spawn(self._watcher())])

    async def check(self) -> bool:
        # FDB watches may fire spuriously (failovers / recoveries
        # re-register them) — that's allowed; a SPURIOUS-FIRE STORM or a
        # lost wakeup (watcher never reaches the final value → the run's
        # time limit trips) is not
        if self.spurious > self.changes:
            print(f"Watches: spurious-fire storm ({self.spurious})")
            return False
        if self.observed < 1:
            print("Watches: observed nothing")
            return False
        return True
