"""TaskBucket: a persistent, leased task queue stored in the database.

The analog of fdbclient/TaskBucket.actor.cpp — the execution substrate of
the backup/DR agents: tasks are rows in a subspace; agents claim a task by
moving it to a timeout subspace with a lease deadline (transactionally, so
exactly one claimer wins); finished tasks are removed; expired leases put
tasks back. Parameters are a JSON dict, matching the reference's
key-value task params.
"""

from __future__ import annotations

import json

from ..runtime.loop import Cancelled, now
from .subspace import Subspace


class TaskBucket:
    def __init__(self, subspace: Subspace, lease: float = 10.0):
        self.available = subspace["avail"]
        self.claimed = subspace["claimed"]  # packs (deadline, id)
        self.counter_key = subspace.pack(("next_id",))
        self.lease = lease

    # -- producer --------------------------------------------------------------

    async def add_task(self, tr, task_type: str, **params) -> str:
        """Queue a task (inside the caller's transaction). Ids come from a
        transactional counter: deterministic under the seeded simulation
        (Python's salted hash() is not) and collision-free for identical
        tasks queued together."""
        raw = await tr.get(self.counter_key)
        n = int.from_bytes(raw, "big") if raw else 0
        tr.set(self.counter_key, (n + 1).to_bytes(8, "big"))
        blob = json.dumps({"type": task_type, "params": params}).encode()
        tid = f"{task_type}-{n:012d}"
        tr.set(self.available.pack((tid,)), blob)
        return tid

    # -- consumer --------------------------------------------------------------

    async def claim_one(self, db):
        """Claim an available (or lease-expired) task. Returns
        (task_id, task_dict) or None."""

        async def body(tr):
            # recover expired claims first
            b, e = self.claimed.range()
            for k, v in await tr.get_range(b, e, limit=10):
                deadline, tid = self.claimed.unpack(k)
                if deadline < now():
                    tr.clear(k)
                    tr.set(self.available.pack((tid,)), v)
            b, e = self.available.range()
            rows = await tr.get_range(b, e, limit=1)
            if not rows:
                return None
            k, v = rows[0]
            (tid,) = self.available.unpack(k)
            tr.clear(k)
            tr.set(self.claimed.pack((now() + self.lease, tid)), v)
            return tid, json.loads(v.decode())

        return await db.run(body)

    async def finish(self, db, task_id: str) -> None:
        async def body(tr):
            b, e = self.claimed.range()
            for k, _v in await tr.get_range(b, e):
                _deadline, tid = self.claimed.unpack(k)
                if tid == task_id:
                    tr.clear(k)

        await db.run(body)

    async def extend(self, db, task_id: str) -> None:
        """Renew the lease on a long-running task."""

        async def body(tr):
            b, e = self.claimed.range()
            for k, v in await tr.get_range(b, e):
                _deadline, tid = self.claimed.unpack(k)
                if tid == task_id:
                    tr.clear(k)
                    tr.set(self.claimed.pack((now() + self.lease, tid)), v)

        await db.run(body)

    async def is_empty(self, db) -> bool:
        async def body(tr):
            b, e = self.available.range()
            avail = await tr.get_range(b, e, limit=1)
            b, e = self.claimed.range()
            claimed = await tr.get_range(b, e, limit=1)
            return not avail and not claimed

        return await db.run(body)


async def run_agent(db, bucket: TaskBucket, handlers: dict, stop) -> None:
    """A task-execution loop (the reference's taskBucket->run agents):
    claims tasks and dispatches to `handlers[type](db, params)` until
    `stop` (a Future) is set."""
    from ..runtime.futures import delay

    while not stop.is_ready():
        claimed = await bucket.claim_one(db)
        if claimed is None:
            await delay(0.25)
            continue
        tid, task = claimed
        handler = handlers.get(task["type"])
        if handler is None:
            await bucket.finish(db, tid)  # drop unknown task types
            continue
        try:
            await handler(db, task["params"])
            await bucket.finish(db, tid)
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception:
            # leave claimed: the lease expiry re-queues it for retry
            await delay(0.5)
