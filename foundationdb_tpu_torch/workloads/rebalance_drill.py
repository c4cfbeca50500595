"""Hot-prefix resolutionBalancing drill, shared by the test suite and
the multichip dry run (one scenario, one maintained copy).

Drives all load into a prefix deep inside one resolver's partition,
waits for the balancer to move a boundary, then measures how post-move
traffic spreads. Returns (moves, gained_per_resolver)."""

from __future__ import annotations

from ..runtime.futures import delay
from ..runtime.loop import Cancelled


async def hot_prefix_rebalance(cluster, db, balancer, bursts=(150, 150)):
    async def burst(n):
        for i in range(n):
            tr = db.transaction()
            # confined to a hot prefix in resolver 1's half of the
            # keyspace (the static recruitment split is at 0x80)
            k = b"\xc0hot/%04d" % (i % 50)
            await tr.get(k)
            tr.set(k, b"v%d" % i)
            try:
                await tr.commit()
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                pass

    await burst(bursts[0])
    # let the balancer poll, split, and record the move
    for _ in range(12):
        await delay(0.5)
        if balancer.moves:
            break
    before = [int(r._c_txns.value) for r in cluster.resolvers]
    await burst(bursts[1])
    after = [int(r._c_txns.value) for r in cluster.resolvers]
    return balancer.moves, [a - b for b, a in zip(before, after)]
