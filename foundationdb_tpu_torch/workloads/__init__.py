"""Self-checking workloads — the simulation test units.

The analog of fdbserver/workloads/ (TestWorkload, workloads.h:55-86) and the
tester orchestration (tester.actor.cpp:778 runTest): a workload has
setup → start → check phases; several run concurrently in one spec (fault
workloads run *during* correctness workloads), then every check must pass.
"""

from __future__ import annotations

from ..runtime.futures import spawn, wait_for_all


class Workload:
    """setup/start/check lifecycle (workloads.h:55-86)."""

    def __init__(self, db, rng, client_id: int = 0, client_count: int = 1):
        self.db = db
        self.rng = rng
        self.client_id = client_id
        self.client_count = client_count

    async def setup(self) -> None:
        pass

    async def start(self) -> None:
        pass

    async def check(self) -> bool:
        return True


async def run_workloads(workloads: list[Workload]) -> None:
    """The runTest sequence: all setups, then all starts concurrently,
    then all checks (tester.actor.cpp:778)."""
    for w in workloads:
        await w.setup()
    await wait_for_all([spawn(w.start()) for w in workloads])
    for w in workloads:
        ok = await w.check()
        assert ok, f"{type(w).__name__}.check() failed"


from .cycle import CycleWorkload  # noqa: E402,F401
from .conflict_range import ConflictRangeWorkload  # noqa: E402,F401
from .sideband import SidebandWorkload  # noqa: E402,F401
from .write_during_read import WriteDuringReadWorkload  # noqa: E402,F401
from .clogging import RandomCloggingWorkload  # noqa: E402,F401
from .attrition import AttritionWorkload  # noqa: E402,F401
from .consistency_check import ConsistencyCheckWorkload  # noqa: E402,F401
from .api_correctness import ApiCorrectnessWorkload  # noqa: E402,F401
from .serializability import SerializabilityWorkload  # noqa: E402,F401
from .ryw_fuzz import RywFuzzWorkload  # noqa: E402,F401
from .selector_fuzz import SelectorFuzzWorkload  # noqa: E402,F401
from .atomic_ops import AtomicOpsWorkload  # noqa: E402,F401
from .watches import WatchesWorkload  # noqa: E402,F401
from .backup_workload import BackupWorkload  # noqa: E402,F401
from .chaos_extra import (  # noqa: E402,F401
    ChangeConfigWorkload,
    DiskFailureWorkload,
    RandomMoveKeysWorkload,
    RollbackWorkload,
)
from .kernel_chaos import KernelChaosWorkload  # noqa: E402,F401
from .overload import OverloadBurstWorkload  # noqa: E402,F401
from .watch_semantics import (  # noqa: E402,F401
    WatchSemanticsWorkload,
    WatchStormWorkload,
)
