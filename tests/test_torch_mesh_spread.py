"""The spread of the port's partitioned resolver over several devices, at
its seams: the upgrade of ``torch`` to the spread mesh on a host with more
than one card (the JAX package's ``tpu`` on several devices,
tests/test_mesh_backend.py:40), the pinned ``torch1``, the names the soak
and the guard use, a resolver on a spread held to the JAX mesh's
(tests/test_mesh_backend.py:118), the kernel wrappers' refusal of tensors
on two devices, an absent card, and the card memory a role reports."""

import pytest
import torch

from foundationdb_tpu_torch import device as D
from foundationdb_tpu_torch.conflict import api, kernels
from foundationdb_tpu_torch.conflict import mesh_backend as MB
from foundationdb_tpu_torch.conflict.errors import DeviceUnavailableError
from foundationdb_tpu_torch.conflict.failover import DEVICE_BACKENDS
from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
from foundationdb_tpu_torch.server import worker
from foundationdb_tpu_torch.tools.soak import port_backend

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


@pytest.fixture
def four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def test_upgrade_picks_every_card_on_a_multi_card_host(four_cards):
    assert api.mesh_upgrade() == {"devices": [torch.device("cuda", i) for i in range(4)], "n_parts": 4}
    # an explicit device never upgrades
    for device in ("cpu", "cuda", "cuda:0", torch.device("cuda", 2)):
        assert api.mesh_upgrade(device) is None


def test_upgrade_declines_on_one_card(monkeypatch):
    for n in (0, 1):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
        assert api.mesh_upgrade() is None


def test_torch_builds_the_spread_mesh_only_when_upgraded(four_cards, monkeypatch):
    built = []

    class Recorder:
        def __init__(self, **kw):
            built.append(kw)

    monkeypatch.setattr(MB, "TorchMeshConflictSet", Recorder)
    cs = api.new_conflict_set("torch", key_width=12, capacity=1 << 10)
    assert isinstance(cs, Recorder)
    assert built == [{"devices": [torch.device("cuda", i) for i in range(4)], "n_parts": 4,
                      "key_width": 12, "capacity": 1 << 10}]
    assert isinstance(api.new_conflict_set("torch", device="cpu", capacity=1 << 10), TorchConflictSet)
    assert isinstance(api.new_conflict_set("torch1", device="cpu", capacity=1 << 10), TorchConflictSet)
    assert len(built) == 1


def test_torch1_pins_one_grid():
    cs = api.new_conflict_set("torch1", device="cpu", capacity=1 << 10)
    assert type(cs) is TorchConflictSet
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            api.new_conflict_set("torch1")


def test_names_of_the_pinned_grid():
    assert port_backend("tpu1") == "torch1"
    assert port_backend("tpu") == "torch"
    assert "torch1" in DEVICE_BACKENDS


def test_a_wrapper_given_tensors_on_two_devices_raises():
    """The wrappers take the tensors of one card: a launch whose tensors
    lie on two devices is refused before anything is allocated (here a
    CPU and a meta tensor stand for two cards), and so is one on the CPU."""
    T, KR, L, B, S = 4, 1, 3, 8, 4
    i32 = torch.int32
    state = (torch.zeros(B, L, dtype=i32), torch.zeros(B, S, L + 1, dtype=i32),
             *(torch.zeros(B, dtype=i32) for _ in range(3)))
    reads = [torch.zeros(T, KR, L, dtype=i32), torch.zeros(T, KR, L, dtype=i32)]
    snap = torch.zeros(T, dtype=i32)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="2 devices"):
        kernels.history(*state, reads[0], reads[1].to("meta"), snap)
    with pytest.raises(ValueError, match="2 devices"):
        kernels.search(torch.zeros(B, L, dtype=i32), torch.zeros(T, L, dtype=i32, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.history(*state, *reads, snap)
    assert kernels.launch_counts() == before


def test_an_absent_card_raises(monkeypatch):
    with pytest.raises(DeviceUnavailableError):
        MB.TorchMeshConflictSet(capacity=1 << 10, devices=["cpu", "cuda:7"], n_parts=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(DeviceUnavailableError, match="cuda:1"):
        D.resolve_device("cuda:1")
    assert D.resolve_device("cuda:0") == torch.device("cuda", 0)


def test_spread_layout_and_defaults():
    cs = MB.TorchMeshConflictSet(key_width=8, capacity=1 << 12, devices=["cpu"] * 2, n_parts=4)
    assert [e.states.grid.shape[0] for e in cs._spread.entries] == [2, 2]
    assert cs._spread.entry_of(3) == (1, 1)
    assert MB.TorchMeshConflictSet(capacity=1 << 12, devices=["cpu"] * 3)._n_parts == 3
    assert MB.TorchMeshConflictSet(capacity=1 << 12, device="cpu")._n_parts == 4
    with pytest.raises(ValueError, match="do not split"):
        MB.TorchMeshConflictSet(capacity=1 << 12, devices=["cpu"] * 3, n_parts=4)


def test_card_memory_sums_every_card_of_a_role(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 100 * (1 + d.index))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 1000 * (1 + d.index))
    cards = [torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cuda", 1)]
    assert worker._card_memory(cards) == {"allocated": 300, "reserved": 3000}
    assert worker._card_memory([torch.device("cuda")]) == {"allocated": 100, "reserved": 1000}
    assert worker._card_memory([torch.device("cpu")]) is None
    assert worker._card_memory([]) is None
