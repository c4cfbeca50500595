"""The port's commit path (client → proxy → master → resolver → tlog →
storage in the static ``Cluster``, on the port's ``Sim``) held against the
JAX package's, with the same seed and the same client scenarios
(``commit_slice.run_commit``: those of ``tests/test_commit_path.py`` and
``tests/test_tpu_in_cluster.py`` with every outcome recorded).

Backend pairs: ``oracle`` / ``oracle``, the port's ``torch`` on the CPU /
JAX ``tpu1``, and the port's ``torch_mesh`` with 4 partitions on the CPU /
JAX ``mesh`` with 4. Every read value, commit version, versionstamp and
error, the proxies' counters and sim-time latency samples, the resolvers'
counters, the storage counters, the master's versions and the sim clock
must be equal: the tolerance is exact. Also the cluster shapes of
``test_cluster_shapes``, the resolution balancer on, a run with the Sim's
buggify on, a 2000-write transaction and an empty batch through both
packages' conflict sets, and the refusal to build a cluster without a card.
"""

import functools

import numpy as np
import pytest
import torch

from commit_slice import SCENARIOS, run_commit

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

PORT, REF = "foundationdb_tpu_torch", "foundationdb_tpu"
PAIRS = [("oracle", "oracle"), ("torch", "tpu1"), ("torch_mesh", "mesh")]
MESH_KW = {"n_parts": 4}


def _kw(backend):
    return {"resolver_kw": MESH_KW} if backend in ("torch_mesh", "mesh") else {}


@functools.lru_cache(maxsize=None)
def _pair(port_backend, ref_backend, seed=0, scenarios=tuple(SCENARIOS), shape=(), balancer=False,
          buggify=False, knobs=()):
    """Both packages' transcripts of one seeded run (cached: the scenario
    tests of a pair read one run)."""
    common = dict(scenarios=scenarios, seed=seed, shape=dict(shape), balancer=balancer,
                  buggify=buggify, knobs=dict(knobs))
    port = run_commit(PORT, backend=port_backend, device="cpu", **_kw(port_backend), **common)
    ref = run_commit(REF, backend=ref_backend, **_kw(ref_backend), **common)
    return port, ref


def _assert_equal(port, ref):
    assert port["scenarios"] == ref["scenarios"]
    for part in ("proxies", "resolvers", "storages", "master", "resolver_map", "now"):
        assert port[part] == ref[part], part


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "-".join(p))
def test_scenario_equals_the_jax_package(pair, scenario):
    port, ref = _pair(*pair)
    assert port["scenarios"][scenario], "the scenario recorded nothing"
    assert port["scenarios"][scenario] == ref["scenarios"][scenario]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "-".join(p))
def test_roles_counters_and_clock_equal_the_jax_package(pair):
    port, ref = _pair(*pair)
    _assert_equal(port, ref)
    # the run did what the scenarios ask of a database: conflicts were
    # found, the idle proxy committed empty batches, storage served multiGets
    res = port["resolvers"][0]
    assert res["conflicts"] > 0 and res["resolveBatchIn"] > 0
    storage = dict(port["storages"][0])
    assert storage["multiGetKeys"] > 0


def test_every_scenario_outcome_is_the_expected_one():
    """The port's transcript says what ``test_commit_path.py`` asserts of
    the reference (oracle backend): the second writer of a read key is not
    committed, read-your-writes, ranges, versionstamps, exact counters."""
    s = _pair("oracle", "oracle")[0]["scenarios"]
    assert s["set_commit_get"][-1] == [b"world", None]
    assert s["read_your_writes"][1:5] == [[b"committed"], [b"mine"], [None], [b"mine!"]]
    assert s["conflicts"][3] == ["commit", ["error", "NotCommitted"]]
    assert s["conflicts"][4][0] == "commit" and isinstance(s["conflicts"][4][1], int)
    assert s["range_conflict"][-1] == ["commit", ["error", "NotCommitted"]]
    assert s["atomic_then_snapshot"][-1] == ["commit", ["error", "NotCommitted"]]
    assert s["shard_spread"][-1] == ["commit", ["error", "NotCommitted"]]
    stamp, v = s["versionstamps"][1][0], s["versionstamps"][0][1]
    assert int.from_bytes(stamp[:8], "big") == v
    assert s["versionstamps"][2][0] == [[b"vs/log/" + stamp, b"entry-1"]]
    assert s["atomics"][-1] == [bytes([10, 0])]
    assert s["contention"][-1] == [b"6", b"6"]
    # concurrent GRVs see every commit before them (getLiveCommittedVersion)
    versions = s["grv_batching"][0][0]
    assert len(versions) == 30 and min(versions) >= s["reverse_across_shards"][0][1]


SHAPES = [
    dict(n_proxies=2, n_resolvers=2, n_tlogs=2, n_storage=2),
    dict(n_proxies=1, n_resolvers=1, n_tlogs=1, n_storage=2, replication=2),
    dict(n_proxies=3, n_resolvers=2, n_tlogs=2, n_storage=4, replication=2),
]
SHAPE_SCENARIOS = ("shard_spread", "reverse_across_shards", "conflicts", "contention", "run_mix")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_cluster_shapes_equal_the_jax_package(shape):
    port, ref = _pair("torch", "tpu1", seed=8, scenarios=SHAPE_SCENARIOS,
                      shape=tuple(shape.items()))
    _assert_equal(port, ref)
    assert len(port["storages"]) == shape["n_storage"]
    assert len(port["resolvers"]) == shape["n_resolvers"]


def test_resolution_balancer_moves_the_boundary_as_the_jax_package_does():
    """Two resolvers, every key of the scenarios below 0x80 but one: only
    the balancer gives resolver 1 work. It must move the boundary at the
    same sim time in both packages, and both resolvers then resolve."""
    knobs = (("RESOLUTION_BALANCE_MIN_OPS", 20), ("RESOLUTION_BALANCING_INTERVAL", 0.3))
    port, ref = _pair("torch", "tpu1", seed=3, shape=(("n_proxies", 2), ("n_resolvers", 2)),
                      balancer=True, knobs=knobs,
                      scenarios=("run_mix", "causal", "run_mix", "contention", "run_mix"))
    _assert_equal(port, ref)
    assert len(port["resolver_map"]) > 2, "the balancer moved no boundary"
    assert all(r["transactions"] > 10 and r["conflicts"] > 0 for r in port["resolvers"]), port["resolvers"]


def test_buggify_run_equals_the_jax_package():
    """The Sim's buggify sites armed: the proxies', master's, client's and
    storage's draws go through both packages alike."""
    port, ref = _pair("torch", "tpu1", seed=5, buggify=True,
                      scenarios=("conflicts", "contention", "ranges", "atomics", "run_mix"))
    _assert_equal(port, ref)
    assert port["now"] > 2.0  # the injected delays stretched the run


# -- the conflict set at the commit path's extremes ---------------------------


def _conflict_sets(backend_pair):
    from foundationdb_tpu.conflict.api import new_conflict_set as j_new
    from foundationdb_tpu_torch.conflict.api import new_conflict_set as t_new

    port_b, ref_b = backend_pair
    kw = {"n_parts": 4} if port_b == "torch_mesh" else {}
    return (t_new(port_b, device="cpu", capacity=1 << 12, **kw),
            j_new(ref_b, capacity=1 << 12, **kw))


def _txn(api, snap, reads, writes):
    return api.CommitTransaction(read_snapshot=snap, read_conflict_ranges=reads,
                                 write_conflict_ranges=writes)


def test_a_2000_write_transaction_equals_the_jax_package():
    """A bulk-load transaction (2000 write ranges, no reads) in one batch,
    then readers of some of those keys at older and newer snapshots, through
    ``TorchConflictSet`` on the CPU and JAX ``tpu1``: the verdicts are equal
    and exact."""
    from foundationdb_tpu.conflict import api as j_api
    from foundationdb_tpu_torch.conflict import api as t_api

    rs = np.random.RandomState(4)
    load = [(b"rw/%08d" % i, b"rw/%08d\x00" % i) for i in range(2000)]
    batches = [
        [(0, [], load), (0, [(b"x", b"y")], [(b"x", b"y")])],
        [(snap, [load[i]], [(b"z%d" % j, b"z%d\x00" % j)])
         for j, (snap, i) in enumerate(zip(rs.choice([50, 150], 64), rs.randint(0, 2000, 64)))],
    ]
    port, ref = _conflict_sets(("torch", "tpu1"))
    got = []
    for cs, api in ((port, t_api), (ref, j_api)):
        out = []
        for k, batch in enumerate(batches):
            txns = [_txn(api, s, r, w) for s, r, w in batch]
            out.append([int(v) for v in cs.detect_batch(txns, 100 * (k + 1), 0)])
        got.append(out)
    assert got[0] == got[1]
    assert got[0][0] == [0, 0] and 0 < sum(got[0][1]) < 64  # committed, then a mix


@pytest.mark.parametrize("pair", [("torch", "tpu1"), ("torch_mesh", "mesh")], ids=lambda p: "-".join(p))
def test_an_empty_batch_equals_the_jax_package(pair):
    """T = 0: no verdicts, and the horizon still advances, so a later
    snapshot below it is too old in both packages."""
    from foundationdb_tpu.conflict import api as j_api
    from foundationdb_tpu_torch.conflict import api as t_api

    port, ref = _conflict_sets(pair)
    got = []
    for cs, api in ((port, t_api), (ref, j_api)):
        out = [cs.detect_batch([_txn(api, 0, [], [(b"a", b"b")])], 10, 0)]
        out.append(cs.detect_batch([], 20, 15))  # the empty batch raises the horizon
        out.append(cs.detect_batch([_txn(api, 12, [(b"a", b"b")], []), _txn(api, 16, [(b"a", b"b")], [])], 30, 15))
        got.append([[int(v) for v in vs] for vs in out] + [cs.oldest_version])
    assert got[0] == got[1]
    assert got[0][1] == [] and got[0][-1] == 15


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_an_empty_resolve_request_advances_both_resolvers_alike(backend):
    """An idle proxy's empty batch through the resolver role: an empty
    reply, and the next batch chains on its version."""
    from foundationdb_tpu.runtime import futures as j_futures
    from foundationdb_tpu.runtime import loop as j_loop
    from foundationdb_tpu.server import interfaces as j_if
    from foundationdb_tpu.server.resolver import Resolver as JResolver
    from foundationdb_tpu_torch.runtime import futures as t_futures
    from foundationdb_tpu_torch.runtime import loop as t_loop
    from foundationdb_tpu_torch.server import interfaces as t_if
    from foundationdb_tpu_torch.server.resolver import Resolver

    ref_backend = {"torch": "tpu1", "torch_mesh": "mesh"}[backend]
    got = []
    for loop_mod, fut_mod, ifs, cls, b, kw in (
        (t_loop, t_futures, t_if, Resolver, backend, {"device": "cpu"}),
        (j_loop, j_futures, j_if, JResolver, ref_backend, {}),
    ):
        if "mesh" in b:
            kw = {**kw, **MESH_KW}
        loop = loop_mod.EventLoop(1)
        loop_mod.set_loop(loop)
        try:
            r = cls(backend=b, uid="r0", **kw)
            reqs = [
                ifs.ResolveBatchRequest(prev_version=0, version=10, transactions=[]),
                ifs.ResolveBatchRequest(prev_version=10, version=20, transactions=[
                    ifs.TransactionData(read_snapshot=5, read_conflict_ranges=[(b"a", b"b")],
                                        write_conflict_ranges=[(b"a", b"b")])]),
            ]
            futs = [fut_mod.spawn(r.resolve(q)) for q in reqs]
            loop.run(until=60.0, stop_when=lambda: all(f.is_ready() for f in futs))
            got.append([list(f.get().committed) for f in futs] + [r.gate.version])
        finally:
            loop_mod.set_loop(None)
    assert got[0] == got[1] == [[], [0], 20]  # 0: committed


def test_a_cluster_without_a_card_raises():
    """``device=None`` is the card: without one the cluster is not built,
    and nothing is built on the host in its place."""
    from foundationdb_tpu_torch.conflict.errors import DeviceUnavailableError
    from foundationdb_tpu_torch.net.sim import Sim
    from foundationdb_tpu_torch.runtime.loop import set_loop
    from foundationdb_tpu_torch.server import Cluster, ClusterConfig

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    assert ClusterConfig().conflict_backend == "torch"
    sim = Sim(0)
    sim.activate()
    try:
        for cfg in (ClusterConfig(), ClusterConfig(conflict_backend="oracle")):
            with pytest.raises(DeviceUnavailableError, match="CUDA"):
                Cluster(sim, cfg)
        assert not sim.processes
    finally:
        set_loop(None)


def test_database_with_coordinators_is_not_implemented():
    from foundationdb_tpu_torch.client import Database
    from foundationdb_tpu_torch.net.sim import Sim
    from foundationdb_tpu_torch.runtime.loop import set_loop

    sim = Sim(0)
    sim.activate()
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Database(sim, coordinators=["coord0"])
        assert not sim.processes
    finally:
        set_loop(None)


def test_cluster_config_takes_only_what_the_static_cluster_reads():
    """The reference's multi-region options are read only by its dynamic
    cluster, which the port does not have yet: the port's config refuses
    them instead of building a one-region cluster."""
    from foundationdb_tpu_torch.server import ClusterConfig

    for option in ({"remote_dc": "dc2"}, {"n_log_routers": 2}):
        with pytest.raises(TypeError):
            ClusterConfig(**option)
    assert ClusterConfig().conflict_backend == "torch"


# -- the bulk load's grid growth (a repair of the reference's replay ladder;
# the mesh's, the cluster's and a skewed workload's in test_torch_replay_ladder.py)


def _bulk_load(cs, api, n_batches, sets=200):
    """ReadWriteWorkload.setup's shape: one transaction a batch of ``sets``
    sequential keys, each batch past every key before it."""
    out = []
    for b in range(n_batches):
        writes = [(b"rw/%08d" % i, b"rw/%08d\x00" % i) for i in range(b * sets, (b + 1) * sets)]
        reads = [(b"rw/%08d" % (b * sets - 1), b"rw/%08d\x00" % (b * sets - 1))] if b else []
        txns = [api.CommitTransaction(read_snapshot=100 * b, write_conflict_ranges=writes),
                api.CommitTransaction(read_snapshot=100 * b - 50, read_conflict_ranges=reads)]
        out.append([int(v) for v in cs.detect_batch(txns, 100 * (b + 1), 0)])
    return out


def test_a_sequential_bulk_load_converges_where_the_reference_ladder_does_not(monkeypatch):
    """Each load batch lands past every live boundary, so all its write
    endpoints stage into the last bucket. The reference's replay ladder
    (device rebalance, then host pivots from a key sample, then growth)
    stops converging once the sample is full of older keys: at the default
    sample of 131,072 endpoints that is batch 32 of 2000 sets; with the
    sample cut to 512 here, within 8 batches of 200. The port's ladder
    repivots on the device among the replayed batches' own endpoints after
    its first step (``TorchConflictSet._reshard_merge``): every batch
    converges, every verdict is the oracle's, and the grid grows only as
    far as the load needs: it is at least a quarter full."""
    import foundationdb_tpu.conflict.tpu_backend as JTB
    from foundationdb_tpu.conflict import api as j_api
    from foundationdb_tpu.conflict.api import new_conflict_set as j_new
    from foundationdb_tpu_torch.conflict import api as t_api
    from foundationdb_tpu_torch.conflict import torch_backend as TB

    monkeypatch.setattr(JTB, "_SAMPLE_CAP", 512)
    monkeypatch.setattr(TB, "_SAMPLE_CAP", 512)
    with pytest.raises(RuntimeError, match="did not converge"):
        _bulk_load(j_new("tpu1", capacity=1 << 10), j_api, 8)
    port = t_api.new_conflict_set("torch", device="cpu", capacity=1 << 10)
    got = _bulk_load(port, t_api, 8)
    assert got == _bulk_load(t_api.new_conflict_set("oracle"), t_api, 8)
    assert got[0] == [0, 0] and all(v == [0, 1] for v in got[1:])  # each reader saw the last write
    snap = port.metrics.snapshot()
    assert snap["overflowReplays"] >= 7
    assert snap["reshardsHost"] == 1  # only the first build
    assert snap["occupancy"]["liveRows"] >= 0.25 * port._B * port._S, snap["occupancy"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_pivots_equal_the_host_pivots_on_the_same_candidates(seed):
    """The replay ladder's repivot picks on the device the pivots that
    ``_pick_pivots`` picks on the host from the same candidates (the live
    boundaries and the extra codes, padding rows ignored), and the grid
    rebuilt under them is the one the host pivots give, array for array."""
    import random

    from foundationdb_tpu_torch.conflict import api as t_api
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import keys as K
    from foundationdb_tpu_torch.conflict.torch_backend import _pick_pivots, _pick_pivots_among

    rnd = random.Random(seed)
    cs = t_api.new_conflict_set("torch", device="cpu", capacity=1 << 10, key_width=12)
    for b in range(6):
        txs = []
        for _ in range(200):
            a = rnd.randrange(5000)
            txs.append(t_api.CommitTransaction(read_snapshot=b, write_conflict_ranges=[
                (b"k%05d" % a, b"k%05d" % (a + 1 + rnd.randrange(30)))]))
        cs.detect_batch(txs, 10 + b, max(b - 3, 0))
    state, L = cs._state, cs._lanes
    codes, _vers = G.live_rows(state)
    extra = K.encode_keys([b"k%05d" % rnd.randrange(6000) for _ in range(300)], 12)
    cands = np.concatenate([codes, extra])
    _, first = np.unique(G.codes_to_bytes(np.ascontiguousarray(cands)), return_index=True)
    cands = cands[first]
    cands = cands[cands.any(axis=1)]
    sentinel_rows = np.full((5, L), 0xFFFFFFFF, np.uint32)  # ignored, as a batch's padding is
    extra_t = torch.from_numpy(np.concatenate([extra, sentinel_rows]).view(np.int32))
    for B in (cs._B, 2 * cs._B):
        want = _pick_pivots(cands, B, L)
        got = _pick_pivots_among(G.live_codes(state)[0], extra_t, B)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        for name, a, b in zip(G.GridState._fields, G.reshard(state, got, B, cs._S),
                              G.reshard(state, want, B, cs._S)):
            assert torch.equal(a, b), name
