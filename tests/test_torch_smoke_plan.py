"""``chip_smoke.py``'s run plan and its multi-card gates on the CPU: the
phases ``--phases`` selects (each named phase with what it needs, in a
whole run's order), the resolver gate of phase 16 (a) on a status
document, which must hold what ``torch`` builds on the host (the spread
over every card on a host of several), and ``twin_layout``, which builds a
CPU twin in the layout of the card run (the spread over as many CPU
entries as the host has cards). A host of four cards is stood in for by
``api.mesh_upgrade``."""

import os
import sys

import pytest
import torch

from foundationdb_tpu_torch.conflict import api
from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet
from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

ALL = set(chip_smoke.PHASE_ORDER)
FOUR_CARDS = {"devices": [torch.device("cuda", i) for i in range(4)], "n_parts": 4}


@pytest.mark.parametrize("spec, phases, parts", [
    (None, ALL, "abc"),
    ("16", {16}, "abc"),
    ("16b", {16}, "b"),
    ("16a, 16c", {16}, "ac"),
    ("19", {7, 19}, ""),
    ("18", {7, 18}, ""),
    ("10", {3, 7, 10}, ""),
    ("5", {3, 4, 5}, ""),
    ("12", {8, 12}, ""),
    ("11,13,14,15,16,19", {7, 11, 13, 14, 15, 16, 19}, "abc"),
], ids=["whole", "16", "16b", "16a-16c", "19", "18", "10", "5", "12", "four-card"])
def test_phases_name_each_phase_with_what_it_needs(spec, phases, parts):
    assert chip_smoke.phase_plan(spec) == (phases, parts)


@pytest.mark.parametrize("spec", ["1", "2", "6", "20", "13b", "16d", "x", "", " , "])
def test_phases_refuse_what_is_not_a_phase(spec):
    with pytest.raises(ValueError, match="--phases"):
        chip_smoke.phase_plan(spec)


def status(backend: str, launches: dict, device: str = "cuda", generation: int = 2) -> dict:
    """A status document of two resolvers of one generation, each in a
    worker process of its own, both busy."""
    snap = {"address": None, "kernel": {"device": device, "batches": 9, "deviceDispatches": 9, "txns": 90,
                                        "health": {"state": "HEALTHY", "failovers": 0, "deadlineHits": 1,
                                                   "backend": backend},
                                        "launches": launches}}
    return {"resolvers": {f"res-{generation}-{i}": dict(snap, address=f"127.0.0.1:460{i}") for i in range(2)}}


@pytest.mark.parametrize("four_cards", [False, True], ids=["one-card", "four-cards"])
def test_the_resolver_gate_holds_what_torch_builds_on_the_host(monkeypatch, four_cards):
    monkeypatch.setattr(api, "mesh_upgrade", lambda device=None: FOUR_CARDS if four_cards and device is None else None)
    one = status("TorchConflictSet", {"resolve_many": 9})
    spread = status("TorchMeshConflictSet", {"resolve_many_spread": 36})
    good, bad = (spread, one) if four_cards else (one, spread)
    out = chip_smoke.check_cluster_kernels(good, "cuda", {}, want_batches=True)
    assert out["generation"] == 2 and len(out["resolvers"]) == 2
    with pytest.raises(AssertionError, match="resolvers"):
        chip_smoke.check_cluster_kernels(bad, "cuda", {}, want_batches=True)
    # off the card every worker builds the one grid, whatever the host
    assert chip_smoke.check_cluster_kernels(status("TorchConflictSet", {}, "cpu"), "cpu", {}, want_batches=True)
    # on the card a busy resolver's process launched its path's scan
    idle = status(good["resolvers"]["res-2-0"]["kernel"]["health"]["backend"], {"search": 3})
    with pytest.raises(AssertionError, match="resolvers"):
        chip_smoke.check_cluster_kernels(idle, "cuda", {}, want_batches=True)


@pytest.mark.parametrize("host", [None, FOUR_CARDS], ids=["one-card", "four-cards"])
def test_a_twin_takes_the_layout_of_the_card_run(monkeypatch, host):
    monkeypatch.setattr(api, "mesh_upgrade", lambda device=None: host if device is None else None)
    built = []
    try:
        built.append(api.new_conflict_set("torch", device="cpu", key_width=12, capacity=256))
        with chip_smoke.twin_layout():
            built.append(api.new_conflict_set("torch", device="cpu", key_width=12, capacity=256))
            assert chip_smoke.torch_built("torch", "cpu")["cls"] is type(built[-1])
            built.append(api.new_conflict_set("torch1", device="cpu", key_width=12, capacity=256))
        built.append(api.new_conflict_set("torch", device="cpu", key_width=12, capacity=256))
        assert api.mesh_upgrade("cpu") is None  # restored
        before, inside, pinned, after = built
        assert type(before) is type(after) is type(pinned) is TorchConflictSet
        if host is None:
            assert type(inside) is TorchConflictSet
        else:
            assert type(inside) is TorchMeshConflictSet
            assert [e.device for e in inside._spread.entries] == [torch.device("cpu")] * 4
            assert inside._n_parts == 4
    finally:
        for cs in built:
            cs.close()
