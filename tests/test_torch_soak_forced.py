"""``tests/test_soak.py``'s pinned kernel-fault cases in the port:
``run_one(0, force_kernel_faults=True)`` and the composition with the
overload burst. Both pin the single grid (the port's ``torch``, the JAX
``tpu1``) and are held to the reference across their kernel faults
(``tests/soak_cases.py``); in the port the kernel-fault sites fire, the
guard fails over and the summary names every fired site."""

import torch

from soak_cases import kernel_sites, same_across_kernel_faults

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


def _failed_over(out) -> bool:
    return any(dict(e)["Type"] == "KernelFailover" for e in out["events"])


def test_soak_reports_fired_sites_and_kernel_faults_fire():
    out = same_across_kernel_faults(0, force_kernel_faults=True)
    summary = dict(out["summary"])
    assert len(summary["buggify_sites"]) == summary["buggify_fired"]
    assert kernel_sites(out) and _failed_over(out)


def test_soak_chaos_composition_kernel_faults_plus_overload():
    out = same_across_kernel_faults(0, force_kernel_faults=True, force_overload=True)
    assert dict(out["summary"])["overload_armed"] and kernel_sites(out)
