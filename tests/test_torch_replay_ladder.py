"""The port's replay ladder under a sequential bulk load, held against the
JAX package's: the reference's ladders stop converging once their key
sample holds older keys, the port's repivot on the device among the
replayed batches' own write endpoints. On the conflict sets (``torch`` /
JAX ``tpu1``, ``torch_mesh`` / JAX ``mesh``), through the whole commit
path, and on a skewed workload that is not a load. Verdicts, transcripts
and grids are compared exactly.
"""

import numpy as np
import pytest
import torch

from commit_slice import run_commit
from test_torch_commit_path import PORT, REF, _assert_equal, _bulk_load, _kw

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


def test_a_sequential_bulk_load_converges_on_the_mesh_where_the_reference_ladder_does_not(monkeypatch):
    """``test_torch_commit_path``'s bulk load on two partitions: the JAX
    mesh's ladder (device rebalance, host pivots from the key sample,
    growth) raises within 8 batches of 200 with the sample cut to 512. The
    port's takes the same six steps and then repivots the overflowing
    partitions on the device among their live boundaries and the replayed
    batches' own endpoints, from the grid size before the ladder: every
    batch converges, every verdict is the oracle's, and the loaded
    partition's grid is at least a quarter full."""
    import foundationdb_tpu.conflict.tpu_backend as JTB
    from foundationdb_tpu.conflict import api as j_api
    from foundationdb_tpu_torch.conflict import api as t_api
    from foundationdb_tpu_torch.conflict import torch_backend as TB

    monkeypatch.setattr(JTB, "_SAMPLE_CAP", 512)
    monkeypatch.setattr(TB, "_SAMPLE_CAP", 512)
    with pytest.raises(RuntimeError, match="did not converge"):
        _bulk_load(j_api.new_conflict_set("mesh", capacity=1 << 10, n_parts=2), j_api, 8)
    port = t_api.new_conflict_set("torch_mesh", device="cpu", capacity=1 << 10, n_parts=2)
    got = _bulk_load(port, t_api, 8)
    assert got == _bulk_load(t_api.new_conflict_set("oracle"), t_api, 8)
    assert got[0] == [0, 0] and all(v == [0, 1] for v in got[1:])  # each reader saw the last write
    occ = port.metrics.snapshot()["occupancy"]
    assert port.metrics.snapshot()["overflowReplays"] >= 7
    assert max(occ["liveRowsPerPartition"]) >= 0.25 * port._B * port._S, occ


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_a_cluster_takes_a_sequential_load(monkeypatch, backend):
    """The same load through the whole commit path (``commit_slice.bulk_load``,
    the key sample cut to 512 in both packages, where the reference's device
    backends give up their grids as the test above shows and their guards
    fail over to the native skip list): the port's guards stay HEALTHY on
    the device backend, and the transcript, every key read back, equals the
    JAX package's cluster on its ``oracle``."""
    import foundationdb_tpu.conflict.tpu_backend as JTB
    from foundationdb_tpu_torch.conflict import torch_backend as TB

    monkeypatch.setattr(JTB, "_SAMPLE_CAP", 512)
    monkeypatch.setattr(TB, "_SAMPLE_CAP", 512)
    common = dict(scenarios=("bulk_load",), knobs={"CONFLICT_SET_CAPACITY": 1 << 10})
    port = run_commit(PORT, backend=backend, device="cpu", **_kw(backend), **common)
    ref = run_commit(REF, backend="oracle", **common)
    _assert_equal(port, ref)
    assert len(port["scenarios"]["bulk_load"][-1][0]) == 1600
    assert port["guards"] == [("HEALTHY", 0)]
    assert port["ladders"][0]["overflowReplays"] >= 7, port["ladders"]


@pytest.mark.parametrize("pair", [("torch", "tpu1"), ("torch_mesh", "mesh")], ids=lambda p: "-".join(p))
def test_a_skewed_workload_grows_the_grid_no_more_than_the_reference(pair):
    """A workload that is not a load: 90 % of the writes on 1 % of a
    100,000-key space, reads anywhere. It overflows the staging planes and
    grows the grid in both packages; the port's ladder ends no larger than
    the reference's, with the same verdicts."""
    import random

    from foundationdb_tpu.conflict import api as j_api
    from foundationdb_tpu_torch.conflict import api as t_api

    def run(cs, api):
        rnd = random.Random(5)
        out = []
        for b in range(24):
            txs = []
            for _ in range(300):
                a = rnd.randrange(1000) if rnd.random() < 0.9 else rnd.randrange(100_000)
                r = rnd.randrange(100_000)
                txs.append(api.CommitTransaction(
                    read_snapshot=10 * b,
                    read_conflict_ranges=[(b"k%06d" % r, b"k%06d" % (r + 1))],
                    write_conflict_ranges=[(b"k%06d" % a, b"k%06d" % (a + 1 + rnd.randrange(3)))]))
            out.append([int(v) for v in cs.detect_batch(txs, 10 * (b + 1), max(0, 10 * (b - 20)))])
        return out

    port_name, jax_name = pair
    opts = {"n_parts": 2} if port_name == "torch_mesh" else {}
    port = t_api.new_conflict_set(port_name, device="cpu", capacity=1 << 10, **opts)
    ref = j_api.new_conflict_set(jax_name, capacity=1 << 10, **opts)
    assert run(port, t_api) == run(ref, j_api)
    assert ref.metrics.snapshot()["capacityGrowths"] > 0
    assert port._B <= ref._B, (port._B, ref._B)


