"""ConflictSet API — the narrow factory seam the commit path builds on.

Mirrors the reference's ``fdbserver/ConflictSet.h:27-60``
(``newConflictSet()`` / ``ConflictBatch``). Backends:

- ``oracle`` — pure-Python reference implementation (conflict/oracle.py),
  ground truth for differential tests;
- ``native`` — the C++ versioned skip list on the host (conflict/native.py),
  the CPU baseline and the guard's failover target;
- ``torch`` — the bucket-grid conflict index resident on the CUDA card
  (conflict/torch_backend.py), or its plain PyTorch version on the CPU
  when built with ``device="cpu"``; with no ``device`` on a host with more
  than one card it is ``torch_mesh`` over every card (``mesh_upgrade``),
  as the reference's ``tpu`` becomes its mesh;
- ``torch1`` — always the one grid (the reference's ``tpu1``);
- ``torch_mesh`` — the same index split into ``n_parts`` key-range
  partitions (conflict/mesh_backend.py), one stacked grid on one card, or
  spread over ``devices``; verdicts equal the ``torch`` backend's.

Transaction semantics (reference ``ConflictBatch::addTransaction``
SkipList.cpp:979 and ``detectConflicts`` SkipList.cpp:1163):

1. A transaction whose ``read_snapshot`` is older than the set's
   ``oldest_version`` *and* that has read conflict ranges is TOO_OLD.
2. A read range [begin, end) conflicts if some write range committed at
   version > read_snapshot overlaps it (history check).
3. Transactions are then scanned in batch order: a transaction also
   conflicts if any of its read ranges overlaps a write range of an
   *earlier, committed* transaction of the same batch.
4. Write ranges of committed transactions are merged into the history at
   version ``now``; history below ``new_oldest_version`` is
   garbage-collected.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Verdict(enum.IntEnum):
    COMMITTED = 0
    CONFLICT = 1
    TOO_OLD = 2


@dataclass
class CommitTransaction:
    """Wire-format analog of fdbclient/CommitTransaction.h:27-60 (conflict part)."""

    read_snapshot: int = 0
    read_conflict_ranges: list[tuple[bytes, bytes]] = field(default_factory=list)
    write_conflict_ranges: list[tuple[bytes, bytes]] = field(default_factory=list)


class ConflictSet:
    """Abstract versioned write-range history. One per resolver key-partition."""

    def __init__(self) -> None:
        self.oldest_version = 0

    def detect_batch(
        self, transactions: list[CommitTransaction], now: int, new_oldest_version: int
    ) -> list[Verdict]:
        raise NotImplementedError

    def clear(self, version: int) -> None:
        """Reset history (reference clearConflictSet, SkipList.cpp:1097)."""
        raise NotImplementedError


class ConflictBatch:
    """Collects one commit batch, then resolves it (ConflictSet.h:40-60)."""

    def __init__(self, cs: ConflictSet) -> None:
        self._cs = cs
        self._transactions: list[CommitTransaction] = []

    def add_transaction(self, tr: CommitTransaction) -> int:
        self._transactions.append(tr)
        return len(self._transactions) - 1

    def detect_conflicts(self, now: int, new_oldest_version: int) -> list[Verdict]:
        return self._cs.detect_batch(self._transactions, now, new_oldest_version)


def new_conflict_set(
    backend: str = "oracle", device=None, fault_injector=None, **kwargs
) -> ConflictSet:
    """The ``newConflictSet()`` factory seam (ConflictSet.h:28).

    ``device`` selects where the ``torch``, ``torch1`` and ``torch_mesh``
    backends run: ``None`` means the CUDA card (and raises without one;
    ``torch`` spreads over every card where there are several); ``"cpu"``
    or ``"cuda:N"`` that device. ``torch_mesh`` takes ``n_parts`` (default
    4, or one a device) and ``devices`` (a list, which overrides
    ``device``). The host backends (``oracle``, ``native``) ignore it.

    ``fault_injector`` (sim-only, conflict/faults.py) wraps the built
    device backend in a ``FaultInjectingConflictSet`` so chaos runs can
    inject dispatch errors, hangs, device loss, and compile stalls at this
    seam; it is ignored for the sync CPU backends (oracle/native), which
    are the failover *targets*.
    """
    cs = _build_conflict_set(backend, device, **kwargs)
    if fault_injector is not None and hasattr(cs, "detect_many_encoded_async"):
        from .faults import FaultInjectingConflictSet

        cs = FaultInjectingConflictSet(cs, fault_injector)
    return cs


def mesh_upgrade(device=None) -> dict | None:
    """Whether ``torch`` becomes the spread mesh (the reference's ``tpu``
    on more than one initialized device, ``foundationdb_tpu/conflict/
    api.py:116-147``): with no explicit ``device`` and more than one card
    visible, the ``TorchMeshConflictSet`` arguments of one partition on
    each card; else None."""
    if device is not None:
        return None
    import torch

    n = torch.cuda.device_count()
    if n <= 1:
        return None
    return {"devices": [torch.device("cuda", i) for i in range(n)], "n_parts": n}


def _build_conflict_set(backend: str, device, **kwargs) -> ConflictSet:
    if backend == "oracle":
        from .oracle import OracleConflictSet

        return OracleConflictSet(**kwargs)
    if backend == "native":
        from .native import NativeConflictSet

        return NativeConflictSet(**kwargs)
    if backend == "torch" and (spread := mesh_upgrade(device)) is not None:
        from .mesh_backend import TorchMeshConflictSet

        return TorchMeshConflictSet(**spread, **kwargs)
    if backend in ("torch", "torch1"):
        from .torch_backend import TorchConflictSet

        kwargs.pop("exchange_timeout", None)  # one grid: no other card's H to wait for
        return TorchConflictSet(device=device, **kwargs)
    if backend == "torch_mesh":
        from .mesh_backend import TorchMeshConflictSet

        return TorchMeshConflictSet(device=device, **kwargs)
    raise ValueError(f"unknown conflict-set backend {backend!r}")
