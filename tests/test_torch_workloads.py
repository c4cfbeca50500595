"""The port's workloads (``foundationdb_tpu_torch/workloads/``) held against
the JAX package's on the CPU: each case of ``tests/test_workloads.py`` and
``tests/test_api_fuzz.py`` gives the same transcript in both packages
(``tests/workload_slice.py``: every workload's results after its check,
the trace events and the sim clock), with ``oracle`` resolvers and with
the port's ``torch`` against the JAX ``tpu1``. A workload whose check
fails raises in either package, so each case also passes the reference
test's own check."""

import pytest
import torch

import workload_slice as WS

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

CASES = [
    "cycle_0", "cycle_1", "cycle_2", "cycle_with_clogging", "write_during_read_0", "write_during_read_1",
    "conflict_range_0", "conflict_range_1", "sideband_causality", "combined_spec_7", "combined_spec_8",
    "api_correctness_0", "api_correctness_1", "api_correctness_2", "serializability_0", "serializability_1",
    "serializability_2", "ryw_fuzz_0", "ryw_fuzz_1", "ryw_fuzz_2", "fuzz_battery_under_clogging",
    "fuzz_battery_across_recovery_11", "fuzz_battery_across_recovery_12",
]


@pytest.mark.parametrize("backend", ["oracle", "torch"])
@pytest.mark.parametrize("case", CASES)
def test_workload_cases_equal_the_reference(case, backend):
    port = WS.run_case(WS.PORT, case, backend)
    assert port == WS.run_case(WS.REFERENCE, case, backend)


def test_combined_spec_replays_and_seeds_differ():
    """The reference test's determinism property in the port: one seed
    replays to the same transcript, another seed explores another."""
    first = WS.run_case(WS.PORT, "combined_spec_7")
    assert WS.run_case(WS.PORT, "combined_spec_7") == first
    assert WS.run_case(WS.PORT, "combined_spec_8")["rec"] != first["rec"]
