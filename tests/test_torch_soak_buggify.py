"""``tests/test_soak.py``'s buggify case in the port: seeds 2 and 3 both
fire buggify sites. Seed 3 draws ``tpu`` without kernel faults and gives
the JAX package's transcript (the port's ``torch`` against ``tpu1``);
seed 2 arms kernel-fault injection and is held to the reference across
its faults (``tests/soak_cases.py``)."""

import torch

from soak_cases import same, same_across_kernel_faults

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


def test_buggify_fires_under_chaos_as_in_the_reference():
    three = same(3)
    two = same_across_kernel_faults(2)
    assert dict(three["summary"])["buggify_fired"] > 0 and dict(two["summary"])["buggify_fired"] > 0
