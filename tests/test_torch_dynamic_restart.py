"""The port's dynamic cluster on ``torch`` resolvers (``device="cpu"``)
held against the JAX package's on ``tpu1``: the scenarios of
``tests/dynamic_slice.py`` that ``tests/test_torch_dynamic_device.py`` does
not run (data distribution and the Ratekeeper, shard moves, tlog and
storage reboots, a full restart, log routers, exclude and configure) give
the same transcript, and every live guard is HEALTHY with no fault."""

import pytest
import torch

import dynamic_slice as DS
from test_torch_dynamic_device import RECOVERY, _compare

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


@pytest.mark.parametrize("scenario", [s for s in DS.SCENARIOS if s not in RECOVERY])
def test_dynamic_cluster_on_torch_equals_tpu1(scenario):
    _compare(scenario, "torch")
