"""The port's seeded chaos soak (``foundationdb_tpu_torch/tools/soak.py``
over the port's ``DynamicCluster``, workloads, backup and layers) held
against the JAX package's on the CPU: ``run_one`` for the seeds of
``tests/test_soak.py`` gives the same transcript in both packages (the
summary with its fired buggify sites, every trace event, the live roles,
guards and recoveries, the sim clock and the database at the end;
``tests/soak_slice.py``). Seed 0 draws ``tpu`` (the port's ``torch``
against the JAX ``tpu1``), 1 and 7 ``oracle``; seed 4 arms kernel-fault
injection and is held to the reference across its faults
(``tests/soak_cases.py``).

Also: the soak runs on the card unless asked for the CPU, and the
reference's backend draws map to the port's names."""

import pytest
import torch

from soak_cases import same, same_across_kernel_faults
from foundationdb_tpu_torch.conflict.errors import DeviceUnavailableError
from foundationdb_tpu_torch.tools import soak

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_soak_seed_equals_the_reference(seed):
    out = same(seed)
    summary = dict(out["summary"])
    assert summary["seed"] == seed
    assert dict(summary["config"])["conflict_backend"] == {0: "torch", 1: "oracle", 7: "oracle"}[seed]


def test_soak_seed_4_equals_the_reference_until_its_first_kernel_fault():
    out = same_across_kernel_faults(4)
    assert dict(dict(out["summary"])["config"])["conflict_backend"] == "torch"


def test_backend_draws_map_to_the_ports_names():
    assert [soak.port_backend(n) for n in ("oracle", "tpu", "tpu1")] == ["oracle", "torch", "torch"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_the_soak_needs_a_card_unless_asked_for_the_cpu():
    with pytest.raises(DeviceUnavailableError):
        soak.run_one(1)
    with pytest.raises(DeviceUnavailableError):
        soak.main(["1", "1"])
