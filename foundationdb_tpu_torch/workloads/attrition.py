"""Attrition — kill (and optionally reboot) random processes while
correctness workloads run.

The analog of fdbserver/workloads/MachineAttrition.actor.cpp: the classic
composition is Cycle/Sideband + Attrition + RandomClogging in one spec
(e.g. tests/fast/WriteDuringRead.txt). Only meaningful against a
DynamicCluster (roles must re-recruit)."""

from __future__ import annotations

from ..runtime.futures import delay
from . import Workload


class AttritionWorkload(Workload):
    def __init__(
        self,
        db,
        rng,
        sim=None,
        kills: int = 2,
        interval: float = 3.0,
        reboot: bool = True,
        protect: set = None,  # addresses never killed (e.g. coordinators majority)
        **kw,
    ):
        super().__init__(db, rng, **kw)
        self.sim = sim or db.sim
        self.kills = kills
        self.interval = interval
        self.reboot = reboot
        self.protect = set(protect or ())
        self.killed: list[str] = []

    async def start(self) -> None:
        for _ in range(self.kills):
            await delay(self.interval * (0.5 + self.rng.random01()))
            victims = [
                a
                for a, p in self.sim.processes.items()
                if p.alive
                and a not in self.protect
                and getattr(p, "worker", None) is not None
            ]
            if not victims:
                continue
            victim = self.rng.random_choice(sorted(victims))
            self.killed.append(victim)
            self.sim.kill_process(
                victim, reboot_in=1.0 if self.reboot else None
            )

    async def check(self) -> bool:
        return True
