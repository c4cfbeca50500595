"""Overload burst workload: drive admission control past capacity.

The chaos-soak arm for Ratekeeper-grade admission control: a
short burst of greedy batch/default-class traffic from a handful of
tenants, offered well above whatever the Ratekeeper is granting, runs
CONCURRENTLY with the soak's correctness workloads. Self-checking:

- the burst makes progress (shed-don't-collapse: bounded-backoff retries
  must keep landing commits at the granted rate — zero goodput under its
  own overload is the collapse admission control exists to prevent);
- an immediate-class canary transaction issued DURING the burst
  completes (batch flood cannot starve the immediate class);
- any grv_throttled errors observed are the typed retryable shed path,
  never a hang.
"""

from __future__ import annotations

from ..errors import FdbError
from ..net.sim import BrokenPromise
from ..runtime.futures import spawn, wait_for_all
from ..runtime.loop import Cancelled, now
from . import Workload


class OverloadBurstWorkload(Workload):
    def __init__(
        self,
        db,
        rng,
        actors: int = 6,
        txns: int = 8,
        duration: float = 4.0,
        tenants: int = 3,
        prefix: bytes = b"overload/",
        **kw,
    ):
        super().__init__(db, rng, **kw)
        self.actors = actors
        self.txns = txns
        self.duration = duration
        self.tenants = max(tenants, 1)
        self.prefix = prefix
        self.commits = 0
        self.sheds = 0
        self.canary_done = False

    async def start(self):
        t_end = now() + self.duration

        async def flood(i: int):
            # tenant skew: tenant-0 is the hot tenant (double the actors
            # land on it), exercising the per-tenant fair-share buckets
            tenant = f"tenant-{(i // 2) % self.tenants if i % 2 else 0}"
            priority = "batch" if i % 2 else "default"
            rnd = self.rng.fork()
            done = 0
            while done < self.txns and now() < t_end:
                async def body(tr, i=i, done=done):
                    tr.set_priority(priority)
                    tr.set_tenant(tenant)
                    tr.set(
                        self.prefix + b"%d/%d/%d" % (self.client_id, i, done),
                        b"x",
                    )

                try:
                    # bounded attempts: a batch-class txn under full shed
                    # must abandon and count, not anchor the workload past
                    # the burst window
                    await self.db.run(body, max_retries=5)
                except Cancelled:
                    raise  # actor-cancelled-swallow
                except (FdbError, BrokenPromise):
                    self.sheds += 1
                else:
                    self.commits += 1
                done += 1
            return True

        async def canary():
            # immediate-class traffic DURING the burst: admission drains
            # immediate first, so this must complete however hard the
            # batch flood is shedding
            async def body(tr):
                tr.set_priority("immediate")
                tr.set(self.prefix + b"canary/%d" % self.client_id, b"ok")

            await self.db.run(body)
            self.canary_done = True
            return True

        await wait_for_all(
            [spawn(flood(i)) for i in range(self.actors)] + [spawn(canary())]
        )

    async def check(self) -> bool:
        # progress, not perfection: sheds are expected and healthy; zero
        # commits from the default-class half would mean collapse
        assert self.canary_done, "immediate-class canary starved by the burst"
        assert self.commits > 0, (
            f"overload burst made no progress (sheds={self.sheds})"
        )
        return True
