"""The port's ``("part", "data")`` spread held to the JAX package's data
mesh on conftest's 8 virtual CPU devices, exactly (every value is an
integer or a bool): ``resolve_one_spread`` on 2-D CPU spreads against
``sharded.build_sharded_resolver`` on ``Mesh(devs.reshape(p, d))`` (the
batches of tests/test_sharded_grid.py:81-125 with its mid-run reshard),
``TorchMeshConflictSet(devices=<rows of replicas>)`` against
``MeshConflictSet(mesh=<(4, 2) mesh>)`` through growth, overflow replays and
the int32 rebase at KR 2 and 3 (padded to 4), every replica's state equal
to the JAX stack's; and the one divergence kept on purpose: a KR that is
not a multiple of ``data`` (KR = 1 on ``data`` = 2), which the JAX mesh
refuses and the port pads with inactive read slots."""

import gc
import itertools
import random
import weakref

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from foundationdb_tpu.conflict import grid as JG
from foundationdb_tpu.conflict import keys as JK
from foundationdb_tpu.conflict import sharded as JS
from foundationdb_tpu.conflict.api import CommitTransaction as JTxn
from foundationdb_tpu.conflict.mesh_backend import MeshConflictSet
from foundationdb_tpu_torch.conflict import api
from foundationdb_tpu_torch.conflict import grid as G
from foundationdb_tpu_torch.conflict import sharded as TS
from foundationdb_tpu_torch.conflict import torch_backend as TB
from foundationdb_tpu_torch.conflict.api import CommitTransaction, Verdict, new_conflict_set
from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

CPU = torch.device("cpu")
MAINTENANCE = (
    "overflowReplays", "reshardsDevice", "reshardsHost", "reshardsProactive",
    "capacityGrowths", "rebases",
)


def jax_mesh(n_part, n_data):
    return Mesh(np.array(jax.devices()[: n_part * n_data]).reshape(n_part, n_data), ("part", "data"))


def cpu_rows(n_part, n_data):
    return [["cpu"] * n_data for _ in range(n_part)]


def _jtxs(txs):
    return [JTxn(t.read_snapshot, list(t.read_conflict_ranges), list(t.write_conflict_ranges)) for t in txs]


def _key(i, keyspace):
    # tests/test_sharded_grid.py:55: keys over the whole first-byte range
    return bytes([int(255 * i / (keyspace + 64)) % 256]) + (b"%06d" % i)


def _txns(rnd, n, keyspace, snap, n_reads=1, span=6):
    txs = []
    for _ in range(n):
        reads = []
        for _r in range(n_reads):
            a = rnd.randrange(keyspace)
            reads.append((_key(a, keyspace), _key(a + 1 + rnd.randrange(span), keyspace)))
        c = rnd.randrange(keyspace)
        txs.append(CommitTransaction(
            read_snapshot=snap, read_conflict_ranges=reads,
            write_conflict_ranges=[(_key(c, keyspace), _key(c + 1 + rnd.randrange(span), keyspace))],
        ))
    return txs


def _encode_batch(txs, width, T, KR, KW):
    """tests/test_sharded_grid.py:63: a batch at an exact padded shape."""
    sent = JK.max_sentinel(width)
    rb, re = np.tile(sent, (T, KR, 1)), np.tile(sent, (T, KR, 1))
    wb, we = np.tile(sent, (T, KW, 1)), np.tile(sent, (T, KW, 1))
    t_snap = np.zeros(T, np.int32)
    t_has_reads = np.zeros(T, bool)
    for t, tr in enumerate(txs):
        t_snap[t] = tr.read_snapshot
        t_has_reads[t] = bool(tr.read_conflict_ranges)
        for i, (b, e) in enumerate(tr.read_conflict_ranges):
            rb[t, i] = JK.encode_keys([b], width)[0]
            re[t, i] = JK.encode_keys([e], width, round_up=True)[0]
        for i, (b, e) in enumerate(tr.write_conflict_ranges):
            wb[t, i] = JK.encode_keys([b], width)[0]
            we[t, i] = JK.encode_keys([e], width, round_up=True)[0]
    return JG.Batch(rb=rb, re=re, wb=wb, we=we, t_snap=t_snap, t_has_reads=t_has_reads)


def assert_replicas_equal_jax(spread, jstates):
    """Every entry (every replica of every row) holds its row's slice of
    the JAX stack, array by array."""
    want = [np.asarray(x) for x in jstates]
    k = spread.per_entry
    for n, e in enumerate(spread.entries):
        row = n // spread.n_data
        for field, a, b in zip(G.GridState._fields, want, TS.states_to_numpy(e.states)):
            np.testing.assert_array_equal(a[row * k : (row + 1) * k], b, err_msg=f"entry {n} {field}")


def run_data_step(spread, hbatch, now, old):
    """``resolve_one_spread`` on CPU tensors, the read slices cut once."""
    batch = TB.upload(G.Batch(*hbatch), CPU)
    slices = TS.split_reads(batch.rb, batch.re, spread.n_data)
    return TS.resolve_one_spread(spread, [batch] * len(spread.entries), now, old, old,
                                 [slices[e.replica] for e in spread.entries])


@pytest.mark.parametrize("n_part,n_data", [(4, 2), (2, 4), (2, 2)])
def test_resolve_one_spread_matches_the_jax_data_mesh(n_part, n_data):
    """tests/test_sharded_grid.py:81-125 on both sides: 14 batches, KR =
    data, every partition resharded after batch 7."""
    mesh = jax_mesh(n_part, n_data)
    L, width, B, S = 2, 8, 64, 32
    T, KR, KW = 32, n_data, 1
    rnd = random.Random(11)
    spec = jax.tree.map(lambda _: NamedSharding(mesh, P("part")), JG.GridState(0, 0, 0, 0, 0))
    jstates = jax.device_put(JS.make_sharded_states(n_part, B, S, L), spec)
    step = JS.build_sharded_resolver(mesh, lanes=L)
    spread = TS.make_spread(n_part, B, S, L, cpu_rows(n_part, n_data))
    assert (spread.n_rows, spread.n_data, len(spread.entries)) == (n_part, n_data, n_part * n_data)
    assert_replicas_equal_jax(spread, jstates)
    oracle = OracleConflictSet()
    for i in range(14):
        txs = _txns(rnd, T, 3000, i, n_reads=1 + i % KR)
        old = max(i - 6, 0)
        want = oracle.detect_batch(list(txs), i + 20, old)
        hbatch = _encode_batch(txs, width, T, KR, KW)
        jstates, jv, jp = step(jstates, hbatch, np.int32(i + 20), np.int32(old), np.int32(old))
        verdicts, pressure = run_data_step(spread, hbatch, i + 20, old)
        np.testing.assert_array_equal(np.asarray(jv), verdicts.numpy(), err_msg=f"batch {i}")
        assert [Verdict(int(v)) for v in verdicts[: len(txs)]] == want, f"batch {i}"
        np.testing.assert_array_equal(np.asarray(jp), pressure.numpy(), err_msg=f"batch {i}")
        assert_replicas_equal_jax(spread, jstates)
        if i == 7:
            for p in range(n_part):
                jstates, jpres = JS.reshard_partition(jstates, p, B, S)
                spread, pres = TS.reshard_spread_partition(spread, p, B, S)
                assert pres == jpres <= S
            jstates = jax.device_put(jstates, spec)
            assert_replicas_equal_jax(spread, jstates)
    assert spread.replicas_equal()


def test_split_reads_pads_to_a_multiple_of_data_with_inactive_slots():
    rb = torch.arange(2 * 3 * 3 * 2, dtype=torch.int32).reshape(2, 3, 3, 2)  # [G, T, KR=3, L]
    re = rb + 1
    assert TS.split_reads(rb, re, 1) == [(rb, re)]
    for D, width in ((2, 2), (3, 1), (4, 1)):
        slices = TS.split_reads(rb, re, D)
        assert len(slices) == D
        for b, e in slices:
            assert b.shape == (2, 3, width, 2) and b.is_contiguous() and e.is_contiguous()
        cat_b = torch.cat([b for b, _e in slices], dim=2)
        cat_e = torch.cat([e for _b, e in slices], dim=2)
        assert torch.equal(cat_b[:, :, :3], rb) and torch.equal(cat_e[:, :, :3], re)
        # the padding: begin = end = the all-0xFF code, an empty range
        assert (cat_b[:, :, 3:] == -1).all() and (cat_e[:, :, 3:] == -1).all()


class DataPair:
    """The port's mesh backend on a (4, 2) CPU grid of replicas, the JAX
    mesh backend on a (4, 2) mesh and the port's oracle, fed the same
    groups; every call asserts identical verdicts."""

    def __init__(self, n_part=4, n_data=2, **kw):
        self.port = new_conflict_set("torch_mesh", device="cpu", devices=cpu_rows(n_part, n_data), **kw)
        self.jax = MeshConflictSet(mesh=jax_mesh(n_part, n_data), **kw)
        self.oracle = new_conflict_set("oracle")
        self.logs = (pressure_log(self.port), pressure_log(self.jax))

    def group(self, work):
        """Dispatch ``work`` [(txs, now, oldest)] as one group on each."""
        got = self.port.detect_many(work)
        want = self.jax.detect_many([(_jtxs(t), n, o) for t, n, o in work])
        assert [[int(v) for v in vs] for vs in got] == [[int(v) for v in vs] for vs in want]
        for (txs, now, old), vs in zip(work, got):
            assert vs == self.oracle.detect_batch(txs, now, old)
        return got

    def assert_same_state(self):
        assert_replicas_equal_jax(self.port._spread, self.jax._states)
        assert self.port._spread.replicas_equal()
        for field, a, b in zip(G.GridState._fields, self.jax._states, TS.gather_to_numpy(self.port._spread)):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=field)
        np.testing.assert_array_equal(*map(pressures, self.logs))
        pm, jm = self.port.metrics.snapshot(), self.jax.metrics.snapshot()
        assert {k: pm[k] for k in MAINTENANCE} == {k: jm[k] for k in MAINTENANCE}
        assert self.port._B == self.jax._B
        assert pm["occupancy"] == jm["occupancy"]


def pressure_log(cs) -> dict:
    """Every group's per-batch pressures [G, P, 2] as its last dispatch
    left them (a replay dispatches a group again), by dispatch order."""
    log, order = {}, itertools.count()
    real = cs._dispatch

    def dispatch(group):
        real(group)
        log[group.setdefault("seq", next(order))] = group["pressures"]

    cs._dispatch = dispatch
    return log


def pressures(log) -> np.ndarray:
    return np.concatenate([np.asarray(log[n]) for n in sorted(log)])


@pytest.mark.parametrize("n_reads", [2, 3])
def test_mesh_backend_on_a_data_grid_overflows_grows_and_replays_as_jax(n_reads):
    """tests/test_sharded_grid.py:127's concentrated traffic over a tiny
    grid, in groups of two: overflow replays, device and host reshards,
    growth and proactive rebalances, at KR 2 and 3 (which both encodes pad
    to 4)."""
    rnd = random.Random(13 + n_reads)
    pair = DataPair(key_width=8, capacity=1 << 7)
    ks = 4000
    for g in range(4):
        pair.group([
            (_txns(rnd, 128, ks, 2 * g + j, n_reads=n_reads, span=2), 2 * g + j + 20, max(2 * g + j - 4, 0))
            for j in range(2)
        ])
    pair.assert_same_state()
    snap = pair.port.metrics.snapshot()
    for name in ("overflowReplays", "reshardsDevice", "capacityGrowths"):
        assert snap[name] > 0, (name, snap)
    assert all(n > 0 for n in snap["occupancy"]["liveRowsPerPartition"])


@pytest.mark.parametrize("n_reads", [2, 3])
def test_mesh_backend_on_a_data_grid_crosses_the_rebase_as_jax(n_reads):
    """Versions that cross the int32 rebase threshold: every replica is
    rebased, and batches on top agree with the JAX data mesh."""
    rnd = random.Random(21 + n_reads)
    pair = DataPair(key_width=8, capacity=1 << 10)
    v0 = (1 << 30) - 6
    for i in range(8):
        txs = []
        for _ in range(24):
            reads = []
            for _r in range(n_reads):
                a = rnd.randrange(3000)
                reads.append((_key(a, 3000), _key(a + 3, 3000)))
            c = rnd.randrange(3000)
            txs.append(CommitTransaction(v0 + i - rnd.randrange(4), reads, [(_key(c, 3000), _key(c + 2, 3000))]))
        pair.group([(txs, v0 + i + 5, v0 + i - 3)])
    pair.assert_same_state()
    assert pair.port.metrics.snapshot()["rebases"] >= 1


def test_kr_1_on_data_2_the_jax_mesh_refuses_and_the_port_pads():
    """The divergence kept on purpose: the JAX data mesh cannot shard one
    read slot over two replicas and raises; the port pads the slots with
    an inactive one and gives the oracle's verdicts and the state of the
    same partitions with ``data`` = 1."""
    rnd = random.Random(5)
    batches = [_txns(rnd, 48, 3000, i) for i in range(4)]
    jmesh = MeshConflictSet(key_width=12, capacity=1 << 12, mesh=jax_mesh(4, 2))
    with pytest.raises(ValueError):
        jmesh.detect_batch(_jtxs(batches[0]), 20, 0)
    port = TorchMeshConflictSet(key_width=12, capacity=1 << 12, devices=cpu_rows(4, 2))
    flat = TorchMeshConflictSet(key_width=12, capacity=1 << 12, devices=["cpu"] * 4)
    oracle = OracleConflictSet()
    for i, txs in enumerate(batches):
        got = port.detect_batch(txs, i + 20, i)
        assert got == oracle.detect_batch(txs, i + 20, i) == flat.detect_batch(txs, i + 20, i)
    assert port._n_data == 2 and port._n_parts == 4
    for field, a, b in zip(G.GridState._fields, TS.gather_to_numpy(flat._spread), TS.gather_to_numpy(port._spread)):
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert port._spread.replicas_equal()


def test_every_maintenance_path_reaches_every_replica():
    """The device reshard of one partition, the host reshard, the device
    repivot among the replayed writes, growth, the rebase, a pipelined
    group's snapshot and replay, clone and clear each leave every replica
    equal; ``close()`` drops every replica's tensors."""
    rnd = random.Random(41)
    cs = TorchMeshConflictSet(key_width=8, capacity=1 << 10, devices=cpu_rows(2, 3), n_parts=4)
    assert (cs._spread.n_rows, cs._spread.n_data, cs._spread.per_entry) == (2, 3, 2)
    for i in range(3):
        cs.detect_batch(_txns(rnd, 48, 3000, i, n_reads=2), i + 20, i)
    assert cs._spread.replicas_equal()
    steps = {
        "device reshard": lambda: cs._reshard_device(1),
        "host reshard": lambda: cs._host_reshard_partition(2),
        "growth": cs._grow,
        "rebase": lambda: setattr(cs, "_spread", TS.rebase_spread(cs._spread, 2)),
        "clone": lambda: setattr(cs, "_spread", cs._spread.clone()),
    }
    for name, step in steps.items():
        step()
        assert cs._spread.replicas_equal(), name
    cs.detect_batch(_txns(rnd, 48, 3000, 5, n_reads=2), 25, 3)
    handle = cs.detect_many_encoded_async([(cs.encode(_txns(rnd, 16, 3000, 5)), 26, 3)])
    assert len(cs._inflight) == 1  # the repivot reads the in-flight group's writes
    cs._merge_partition(3)
    assert cs._spread.replicas_equal()
    handle()
    assert cs._spread.replicas_equal()
    # a replica that differs is seen
    e = cs._spread.entries[1]
    e.states.count[0] += 1
    assert not cs._spread.replicas_equal()
    e.states.count[0] -= 1
    cs.clear(100)
    assert cs._spread.replicas_equal() and cs._spread.n_data == 3
    refs = [weakref.ref(t) for e in cs._spread.entries for t in (*e.states, e.plo, e.phi)]
    cs.close()
    gc.collect()
    assert cs._spread is None and not [r for r in refs if r() is not None]


def test_overflow_replay_restores_every_replica_from_the_snapshot():
    """An overflow replays from the pre-group snapshot: every replica's
    state after the replay is the JAX mesh's, not only replica 0's."""
    rnd = random.Random(43)
    pair = DataPair(n_part=2, n_data=2, key_width=8, capacity=1 << 6)
    for g in range(3):
        pair.group([(_txns(rnd, 128, 2000, g, n_reads=2, span=2), g + 20, max(g - 2, 0))])
    assert pair.port.metrics.snapshot()["overflowReplays"] > 0
    pair.assert_same_state()


def test_data_grid_layout_and_defaults():
    cs = TorchMeshConflictSet(key_width=8, capacity=1 << 12, devices=cpu_rows(4, 2))
    assert cs._n_parts == 4 and cs._n_data == 2
    assert [e.replica for e in cs._spread.entries] == [0, 1] * 4
    assert cs._spread.entry_of(3) == (6, 0)
    assert [e.states.grid.shape[0] for e in cs._spread.leads()] == [1] * 4
    cs = TorchMeshConflictSet(key_width=8, capacity=1 << 12, devices=cpu_rows(2, 2), n_parts=4)
    assert cs._spread.entry_of(3) == (2, 1)
    # a flat list keeps its meaning: data = 1
    flat = TorchMeshConflictSet(key_width=8, capacity=1 << 12, devices=["cpu"] * 2, n_parts=4)
    assert flat._n_data == 1 and flat._spread.entry_of(3) == (1, 1)
    built = new_conflict_set("torch_mesh", device="cpu", devices=cpu_rows(2, 4), capacity=1 << 12)
    assert isinstance(built, TorchMeshConflictSet) and (built._n_parts, built._n_data) == (2, 4)
    with pytest.raises(ValueError, match="rows of one length"):
        TorchMeshConflictSet(capacity=1 << 12, devices=[["cpu", "cpu"], ["cpu"]])
    with pytest.raises(ValueError, match="do not split"):
        TorchMeshConflictSet(capacity=1 << 12, devices=cpu_rows(3, 2), n_parts=4)


def test_the_upgrade_stays_one_partition_a_card_with_data_1(monkeypatch):
    """The reference's upgrade builds ``reshape(n_parts, 1)``
    (foundationdb_tpu/conflict/mesh_backend.py:108-114)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    spread = api.mesh_upgrade()
    assert [len(TS.device_grid(spread["devices"])[r]) for r in range(4)] == [1] * 4
