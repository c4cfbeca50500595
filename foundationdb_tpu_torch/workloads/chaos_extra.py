"""Chaos workloads, second set: Rollback, RandomMoveKeys, ChangeConfig,
DiskFailure — faults that run DURING correctness load.

Analogs of fdbserver/workloads/Rollback.actor.cpp (clog a proxy→tlog
link so in-flight batches die and the epoch rolls back),
RandomMoveKeys.actor.cpp (fight DataDistribution for the shard map),
ChangeConfig.actor.cpp (reconfigure the transaction subsystem under
load) and DiskFailureInjection (io_error / disk-full on a live machine's
files, flow/FaultInjection.h:26 + sim2.actor.cpp:676 SimDiskSpace).
"""

from __future__ import annotations

from ..runtime.futures import delay
from . import Workload
from ..runtime.loop import Cancelled


class RollbackWorkload(Workload):
    """Clog the links between a proxy host and every tlog host for a
    few seconds mid-load: its in-flight batches die (clients see
    commit_unknown_result and retry), and if the clog outlives the
    failure monitor a recovery rolls the epoch. Either way no acked
    write may be lost — ConsistencyCheck and the durability oracle judge
    the aftermath."""

    def __init__(self, db, rng, sim=None, clogs=2, duration=2.0, **kw):
        super().__init__(db, rng, **kw)
        self.sim = sim or db.sim
        self.clogs = clogs
        self.duration = duration
        self.performed = 0

    def _hosts_with(self, kind: str) -> list[str]:
        out = []
        for addr, p in self.sim.processes.items():
            w = getattr(p, "worker", None)
            if w is None or not p.alive:
                continue
            if any(h.kind == kind for h in w.roles.values()):
                out.append(addr)
        return sorted(out)

    async def start(self) -> None:
        for _ in range(self.clogs):
            await delay(self.duration * (0.5 + self.rng.random01()))
            proxies = self._hosts_with("proxy")
            tlogs = self._hosts_with("tlog")
            if not proxies or not tlogs:
                continue
            src = self.rng.random_choice(proxies)
            for t in tlogs:
                self.sim.clog_pair(src, t, self.duration)
            self.performed += 1

    async def check(self) -> bool:
        return True  # the oracle/ConsistencyCheck carry the assertions


class RandomMoveKeysWorkload(Workload):
    """Move random shards between random legal teams while traffic runs
    (RandomMoveKeys.actor.cpp): every move races DataDistribution's own
    relocations through the same moveKeys lock; losers retry or give
    up — correctness is judged by the reads that follow."""

    def __init__(self, db, rng, sim=None, moves=3, **kw):
        super().__init__(db, rng, **kw)
        self.sim = sim or db.sim
        self.moves_target = moves
        self.moved = 0
        self.attempts = 0

    def _storage_interfaces(self):
        from ..server.interfaces import StorageInterface

        out = []
        for addr, p in self.sim.processes.items():
            w = getattr(p, "worker", None)
            if w is None or not p.alive:
                continue
            for h in w.roles.values():
                if h.kind == "storage" and not h.uid.startswith("rss-"):
                    out.append(
                        StorageInterface(
                            address=addr, uid=h.uid, tag=h.obj.tag
                        )
                    )
        return sorted(out, key=lambda s: s.tag)

    async def start(self) -> None:
        from ..server.movekeys import move_shard, walk_shards

        for _ in range(self.moves_target):
            await delay(1.0 + self.rng.random01())
            self.attempts += 1
            try:
                shards = await walk_shards(self.db)
                candidates = self._storage_interfaces()
                if len(candidates) < 1 or not shards:
                    continue
                begin, end, team, tags = self.rng.random_choice(shards)
                if begin >= (end or b"\xff"):
                    continue
                width = len(team)
                if len(candidates) < width:
                    continue
                # a random legal destination team of the same width
                dest = []
                pool = list(candidates)
                for _i in range(width):
                    s = self.rng.random_choice(pool)
                    pool = [x for x in pool if x.tag != s.tag]
                    dest.append(s)
                await move_shard(
                    self.db,
                    begin,
                    end,
                    dest,
                    lock_owner=f"randommove-{self.client_id}",
                    ready_timeout=20.0,
                )
                self.moved += 1
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                continue  # lost the lock race / mid-move failure: fine

    async def check(self) -> bool:
        return True


class ChangeConfigWorkload(Workload):
    """Reconfigure the transaction subsystem under load
    (ChangeConfig.actor.cpp): each change commits new shape knobs and
    forces a recovery; clients must ride through on retry loops."""

    def __init__(
        self, db, rng, coordinators=None, changes=1, choices=None, **kw
    ):
        super().__init__(db, rng, **kw)
        self.coordinators = coordinators
        self.changes_target = changes
        self.choices = choices or [
            {"n_proxies": 1},
            {"n_proxies": 2},
            {"n_resolvers": 1},
            {"n_resolvers": 2},
        ]
        self.changed = 0

    async def start(self) -> None:
        from ..client.management import configure

        for _ in range(self.changes_target):
            await delay(2.0 + 2.0 * self.rng.random01())
            change = self.rng.random_choice(self.choices)
            try:
                await configure(
                    self.db, self.coordinators, self.db.client, **change
                )
                self.changed += 1
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                continue  # a racing recovery can eat the force; fine

    async def check(self) -> bool:
        return True


class DiskFailureWorkload(Workload):
    """Arm io_error injection (or a disk-full window) on a random worker
    machine for a while, then disarm (DiskFailureInjection /
    MachineAttrition's disk flavors). Roles that hit the fault die and
    recovery replaces them; acked data must survive."""

    def __init__(
        self, db, rng, sim=None, episodes=1, duration=2.0, p=0.05,
        disk_full=False, **kw,
    ):
        super().__init__(db, rng, **kw)
        self.sim = sim or db.sim
        self.episodes = episodes
        self.duration = duration
        self.p = p
        self.disk_full = disk_full
        self.faulted: list[str] = []

    async def start(self) -> None:
        for _ in range(self.episodes):
            await delay(self.duration * (0.5 + self.rng.random01()))
            machines = sorted(
                addr
                for addr, p in self.sim.processes.items()
                if p.alive and getattr(p, "worker", None) is not None
            )
            if not machines:
                continue
            victim = self.rng.random_choice(machines)
            disk = self.sim.disk(victim)
            if self.disk_full:
                disk.set_capacity(disk.total_bytes())  # next growth fails
            else:
                disk.inject_io_errors(self.p)
            self.faulted.append(victim)
            await delay(self.duration)
            disk.inject_io_errors(0.0)
            disk.set_capacity(None)

    async def check(self) -> bool:
        return True
