"""The port's dynamic cluster on its device backends, held against the JAX
package's on the CPU: the recovery scenarios of ``tests/dynamic_slice.py``
with the port's ``torch`` resolvers (``device="cpu"``: the kernels' plain
versions) and the JAX ``tpu1`` give the same transcript, and one with
``torch_mesh`` / ``mesh`` (4 partitions) too; the other scenarios are in
``tests/test_torch_dynamic_restart.py``. Every live guard is HEALTHY with
no fault on the port's backend.

Then the first batches a post-recovery resolver takes: a ``Resolver``
recruited with ``first_version`` at a recovery version gives the JAX
``tpu1`` verdicts request for request, TOO_OLD for every snapshot below
that version, across the first int32 rebase after the clear."""

import pytest
import torch

import dynamic_slice as DS
from test_torch_dynamic_cluster import check_outcome

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

JAX, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"
PAIRS = {"torch": "tpu1", "torch_mesh": "mesh"}
RECOVERY = ("forms_and_serves", "kill_master", "kill_proxy", "kill_tlog", "repeated_master_kills",
            "cc_reelected", "device_survives_recovery", "move_survives_recovery")
MESH_SCENARIOS = ("device_survives_recovery",)


def _compare(scenario, backend):
    kw = {"resolver_kw": {"n_parts": 4}} if backend == "torch_mesh" else {}
    port = DS.run_dynamic(PORT, [scenario], backend, device="cpu", **kw)[scenario]
    ref = DS.run_dynamic(JAX, [scenario], PAIRS[backend], **kw)[scenario]
    for part in ("client", "guards", "recoveries", "shards", "roles", "events", "now"):
        assert port[part] == ref[part], part
    check_outcome(scenario, port)
    assert port["guards"], "no live resolver"
    want = "TorchMeshConflictSet" if backend == "torch_mesh" else "TorchConflictSet"
    for _addr, _uid, state, faults, failovers, name in port["guards"]:
        assert (state, faults, failovers, name) == ("HEALTHY", 0, 0, want)


@pytest.mark.parametrize("scenario", RECOVERY)
def test_dynamic_cluster_on_torch_equals_tpu1(scenario):
    _compare(scenario, "torch")


@pytest.mark.parametrize("scenario", MESH_SCENARIOS)
def test_dynamic_cluster_on_torch_mesh_equals_mesh(scenario):
    _compare(scenario, "torch_mesh")


# -- the first batches of a post-recovery resolver ------------------------------

RV = 40_000_000  # a recovery version after a long-running generation
STEP = 1000  # versions a batch
WINDOW = 3 * STEP
LEAP = 1 << 30  # an idle cluster: one batch leaps the int32 origin


def _post_recovery_workload(seed, n_batches=8, n_txns=32):
    """(prev, version, transactions) a batch: the first batch's prev is the
    recovery version; batch 5 leaps 2^30 versions, so the device backends
    rebase there. Snapshots lie up to 4 batches back, so those of the first
    batches lie below the recovery version (the previous generation)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    out, prev = [], RV
    for i in range(n_batches):
        version = prev + (LEAP if i == 5 else STEP)

        def ranges(k):
            a = rs.randint(0, 100, size=k)
            return [(b"r%04d" % x, b"r%04d" % (x + 1 + rs.randint(0, 4))) for x in a]

        txns = [(int(version - STEP * rs.randint(1, 5)), ranges(rs.randint(0, 3)), ranges(rs.randint(0, 3)))
                for _ in range(n_txns)]
        out.append((prev, version, txns))
        prev = version
    return out


def _drive_post_recovery(pkg, backend, seed):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    loop_mod, fut_mod, ifs = mod("runtime.loop"), mod("runtime.futures"), mod("server.interfaces")
    loop = loop_mod.EventLoop(seed)
    loop_mod.set_loop(loop)
    knobs = mod("runtime.knobs").Knobs(MAX_READ_TRANSACTION_LIFE_VERSIONS=WINDOW, CONFLICT_SET_CAPACITY=256)
    kw = {"device": "cpu"} if pkg == PORT else {}
    r = mod("server.resolver").Resolver(knobs=knobs, backend=backend, first_version=RV, uid="r1", **kw)
    try:
        reqs = [
            ifs.ResolveBatchRequest(
                prev_version=prev, version=version, last_receive_version=prev, requesting_proxy="px",
                transactions=[ifs.TransactionData(read_snapshot=snap, read_conflict_ranges=list(rr),
                                                  write_conflict_ranges=list(ww)) for snap, rr, ww in txns],
            )
            for prev, version, txns in _post_recovery_workload(seed)
        ]
        futs = [fut_mod.spawn(r.resolve(q)) for q in reqs]
        loop.run(until=600.0, stop_when=lambda: all(f.is_ready() for f in futs))
        snap = r.stats.snapshot()
        return ([list(f.get().committed) for f in futs], snap["kernel"]["rebases"], snap["tooOld"],
                r.cs.health_snapshot())
    finally:
        r.close()
        loop_mod.set_loop(None)


def test_a_post_recovery_resolver_gives_the_tpu1_verdicts():
    got, rebases, too_old, health = _drive_post_recovery(PORT, "torch", 5)
    want, j_rebases, j_too_old, _h = _drive_post_recovery(JAX, "tpu1", 5)
    assert got == want
    assert rebases == j_rebases >= 1 and too_old == j_too_old
    # every snapshot below the recovery version is TOO_OLD (2)
    for (_prev, _version, txns), verdicts in zip(_post_recovery_workload(5), got):
        for (snap, reads, _w), v in zip(txns, verdicts):
            if snap < RV and reads:
                assert v == 2, (snap, v)
    assert {v for vs in got for v in vs} == {0, 1, 2}
    assert health["state"] == "HEALTHY" and health["faults"] == 0
