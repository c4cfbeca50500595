"""QuietDatabase: wait for the cluster to settle before strict checks.

The analog of fdbserver/QuietDatabase.actor.cpp (waitForQuietDatabase):
before ConsistencyCheck, wait until data distribution has no in-flight
relocations and storage has caught up — otherwise the check races a
half-finished shard move and sees transient divergence.

Signals polled (the reference polls DD's MovingData/queue metrics and the
storage queue; this cluster's equivalents):
- the shard map is STABLE across two consecutive walks (no boundary or
  team changed — a relocation in flight changes one);
- every live member of every shard reports the shard fully readable
  (GET_SHARD_STATE — finishMoveKeys' own readiness poll);
- every storage server's durable version is within the configured lag of
  its current version (the storage-queue signal).
"""

from __future__ import annotations

from ..net.sim import Endpoint
from ..runtime.futures import delay, timeout
from ..server.interfaces import Tokens
from ..server.movekeys import walk_shards as _walk_shards
from ..runtime.loop import Cancelled


async def quiet_database(db, max_wait: float = 120.0, settle_polls: int = 2) -> None:
    """Park until the cluster is quiet; raises on timeout."""
    waited = 0.0
    prev = None
    stable = 0
    while waited < max_wait:
        try:
            shards = await _walk_shards(db)
            ok = True
            # every member readable for its whole shard
            for begin, end, team, _tags in shards:
                for addr in team:
                    r = await timeout(
                        db.client.request(
                            Endpoint(addr, Tokens.GET_SHARD_STATE),
                            (begin, end if end is not None else b"\xff\xff"),
                        ),
                        1.0,
                    )
                    if not r:
                        ok = False
                        break
                if not ok:
                    break
            if ok and shards == prev:
                stable += 1
                if stable >= settle_polls:
                    return
            else:
                stable = 0
            prev = shards
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception:
            prev, stable = None, 0  # mid-recovery: start over
        await delay(1.0)
        waited += 1.0
    raise AssertionError(f"database did not quiet within {max_wait}s")
