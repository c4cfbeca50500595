"""The port's second chaos set (``workloads/chaos_extra.py``: Rollback,
RandomMoveKeys, ChangeConfig, DiskFailure) and the SimDisk faults they
use, held against the JAX package's on the CPU: each case of
``tests/test_chaos_extra.py`` but the one that runs real processes gives
the same transcript in both packages (``tests/workload_slice.py``), the
cluster cases with ``oracle`` resolvers and with the port's ``torch``
against the JAX ``tpu1``; the fault workloads did their work in both.

Then ``tests/test_kernel_faults.py``'s kernel chaos with attrition and
clogging on ``torch`` / ``tpu1`` with kernel-fault injection. The port's
resolver takes a kernel fault on purpose otherwise than the reference's
(ROADMAP §C: one batch encodes ahead, and recovery re-resolves in
version order behind a fence), so the injector's draws fall on other
batches from the first fault on. Both packages give the same trace up to
their first kernel-fault event; the port's run holds the workload's exact
ledger (zero false commits), fires its faults and replays to the same
transcript from its seed."""

import pytest
import torch

import workload_slice as WS

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

PURE = ("disk_io_error_injection", "disk_full")
LOAD = {"rollback_under_load": "performed", "random_move_keys_under_load": "attempts",
        "change_config_under_load": "changed", "disk_failure_under_load": "faulted"}


@pytest.mark.parametrize("case", PURE)
def test_sim_disk_faults_equal_the_reference(case):
    port = WS.run_case(WS.PORT, case)
    assert port == WS.run_case(WS.REFERENCE, case)
    assert port["rec"][0][0] == ["error", "DiskFault"]


@pytest.mark.parametrize("backend", ["oracle", "torch"])
@pytest.mark.parametrize("case", list(LOAD))
def test_chaos_under_load_equals_the_reference(case, backend):
    port = WS.run_case(WS.PORT, case, backend)
    assert port == WS.run_case(WS.REFERENCE, case, backend)
    fault = dict(dict(port["rec"][2][1]))  # the fault workload's results
    assert fault[LOAD[case]]


def _first_kernel_event(events):
    return next((i for i, e in enumerate(events) if dict(e)["Type"].startswith("Kernel")), len(events))


def test_kernel_chaos_with_attrition_and_clogging():
    port = WS.run_case(WS.PORT, "kernel_chaos", "torch")
    ref = WS.run_case(WS.REFERENCE, "kernel_chaos", "torch")
    cut = min(_first_kernel_event(port["events"]), _first_kernel_event(ref["events"]))
    assert 0 < cut < len(port["events"])
    assert port["events"][:cut] == ref["events"][:cut]
    chaos = dict(port["rec"][1][1])
    assert chaos["tally"] and sum(dict(chaos["tally"]).values()) == 2 * 5
    assert WS.run_case(WS.PORT, "kernel_chaos", "torch") == port
