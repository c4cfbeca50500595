"""The port's partitioned backend (TorchMeshConflictSet on the CPU) held
against the JAX package's MeshConflictSet on a CPU device mesh and against
the port's oracle: identical verdicts and per-batch pressures on every
batch, identical gathered grid state, occupancy and maintenance (replays,
reshards, growth, rebases) on the shapes of tests/test_mesh_backend.py and
tests/test_sharded_grid.py, each in three layouts of the partitions: one
stack (``devices=None``), one entry a partition (``["cpu"] * n_parts``,
the reference's mesh) and two partitions an entry.
"""

import gc
import itertools
import random
import weakref

import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict.api import CommitTransaction as JTxn
from foundationdb_tpu.conflict.mesh_backend import MeshConflictSet
from foundationdb_tpu.conflict.sharded import make_sharded_states as j_make_sharded_states
from foundationdb_tpu_torch.conflict import sharded as TS
from foundationdb_tpu_torch.conflict.api import CommitTransaction, Verdict, new_conflict_set
from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

END = b"\xff" * 40
MAINTENANCE = (
    "overflowReplays", "reshardsDevice", "reshardsHost", "reshardsProactive",
    "capacityGrowths", "rebases",
)


def _jtxs(txs):
    return [
        JTxn(t.read_snapshot, list(t.read_conflict_ranges), list(t.write_conflict_ranges))
        for t in txs
    ]


# the layouts of the port's partitions: one stack, one entry a partition,
# two partitions an entry
LAYOUTS = ("stack", "each", "pairs")


def layout_devices(layout, n_parts):
    return {"stack": None, "each": ["cpu"] * n_parts, "pairs": ["cpu"] * (n_parts // 2)}[layout]


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


class Pair:
    """The port's mesh backend (its partitions in ``layout``), the JAX mesh
    backend and the port's oracle, fed the same batches; every call
    asserts identical verdicts."""

    def __init__(self, layout="stack", **kw):
        devices = layout_devices(layout, kw["n_parts"])
        self.port = new_conflict_set("torch_mesh", device="cpu", devices=devices, **kw)
        self.jax = MeshConflictSet(**kw)
        self.oracle = new_conflict_set("oracle")
        self.logs = (pressure_log(self.port), pressure_log(self.jax))

    def batch(self, txs, now, oldest):
        got = self.port.detect_batch(txs, now, oldest)
        want_j = [Verdict(int(v)) for v in self.jax.detect_batch(_jtxs(txs), now, oldest)]
        assert got == want_j, (got, want_j)
        assert got == self.oracle.detect_batch(txs, now, oldest)
        return got

    def assert_same_state(self):
        for field, a, b in zip(
            TS.G.GridState._fields, self.jax._states, TS.gather_to_numpy(self.port._spread)
        ):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=field)
        np.testing.assert_array_equal(*map(pressures, self.logs))
        pm, jm = self.port.metrics.snapshot(), self.jax.metrics.snapshot()
        assert {k: pm[k] for k in MAINTENANCE} == {k: jm[k] for k in MAINTENANCE}
        assert self.port._B == self.jax._B
        assert pm["occupancy"] == jm["occupancy"]


def make_batches(n_batches, n_txns, keyspace=2000, seed=0):
    rnd = random.Random(seed)
    batches = []
    for i in range(n_batches):
        txs = []
        for _ in range(n_txns):
            a = rnd.randrange(keyspace)
            c = rnd.randrange(keyspace)
            txs.append(
                CommitTransaction(
                    read_snapshot=i,
                    read_conflict_ranges=[(b"%06d" % a, b"%06d" % (a + 1 + rnd.randrange(8)))],
                    write_conflict_ranges=[(b"%06d" % c, b"%06d" % (c + 1 + rnd.randrange(8)))],
                )
            )
        batches.append(txs)
    return batches


def test_factory_builds_the_mesh_backend():
    cs = new_conflict_set("torch_mesh", device="cpu", n_parts=2, capacity=1 << 10)
    assert isinstance(cs, TorchMeshConflictSet)
    assert cs._states.grid.shape == (2, 32, 32, 9)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n_parts", [2, 4])
def test_mesh_matches_jax_mesh(n_parts, layout):
    """tests/test_mesh_backend.py:48 — ASCII keys, all in partition 0."""
    pair = Pair(layout, key_width=12, capacity=1 << 12, n_parts=n_parts)
    for i, txs in enumerate(make_batches(8, 48, seed=3)):
        pair.batch(txs, now=i + 20, oldest=i)
    pair.assert_same_state()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_matches_jax_mesh_wide_ranges(layout):
    """tests/test_mesh_backend.py:59 — clears spanning partitions and
    point writes."""
    rnd = random.Random(9)
    pair = Pair(layout, key_width=12, capacity=1 << 12, n_parts=4)
    for i in range(6):
        txs = []
        for _ in range(24):
            if rnd.random() < 0.3:
                a = bytes([rnd.randrange(0, 200)])
                b = bytes([rnd.randrange(a[0] + 1, 255)]) if rnd.random() < 0.8 else END
            else:
                k = rnd.randrange(3000)
                a, b = b"%06d" % k, b"%06d" % (k + 1)
            read = rnd.random() < 0.7
            write = rnd.random() < 0.7 or not read
            txs.append(
                CommitTransaction(
                    read_snapshot=max(0, i - rnd.randrange(3)),
                    read_conflict_ranges=[(a, b)] if read else [],
                    write_conflict_ranges=[(a, b)] if write else [],
                )
            )
        pair.batch(txs, now=i + 20, oldest=i)
    pair.assert_same_state()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_pipelined_async_and_clear(layout):
    """tests/test_mesh_backend.py:90 — three groups dispatched before any
    is collected, then clear()."""
    batches = make_batches(6, 32, seed=5)
    port = TorchMeshConflictSet(key_width=12, capacity=1 << 12, n_parts=2, device="cpu",
                                devices=layout_devices(layout, 2))
    jmesh = MeshConflictSet(key_width=12, capacity=1 << 12, n_parts=2)
    oracle = new_conflict_set("oracle")
    logs = (pressure_log(port), pressure_log(jmesh))
    got, want = [], []
    for cs, out, wrap in ((port, got, list), (jmesh, want, _jtxs)):
        handles = [
            cs.detect_many_encoded_async(
                [(cs.encode(wrap(batches[i])), i + 20, i) for i in range(g, g + 2)]
            )
            for g in range(0, 6, 2)
        ]
        for h in handles:
            out.extend([int(v) for v in vs] for vs in h())
    assert got == want
    np.testing.assert_array_equal(*map(pressures, logs))
    for i, txs in enumerate(batches):
        assert [Verdict(v) for v in got[i]] == oracle.detect_batch(txs, i + 20, i)
    port.clear(100)
    jmesh.clear(100)
    t = CommitTransaction(read_snapshot=50, read_conflict_ranges=[(b"a", b"b")])
    assert port.detect_batch([t], now=101, new_oldest_version=100) == [Verdict.TOO_OLD]
    assert int(jmesh.detect_batch(_jtxs([t]), now=101, new_oldest_version=100)[0]) == 2


def _spread_key(i, keyspace):
    # tests/test_sharded_grid.py:48: keys over the whole first-byte range
    return bytes([int(255 * i / (keyspace + 64)) % 256]) + (b"%06d" % i)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_reshard_on_overflow_matches_jax(layout):
    """tests/test_sharded_grid.py:127 — concentrated traffic over a tiny
    grid overflows the staging planes: the replay ladder (device
    rebalance, host reshard from the key sample, growth) and the
    proactive rebalances must run exactly as in the reference."""
    rnd = random.Random(13)
    pair = Pair(layout, key_width=8, capacity=1 << 7, n_parts=2)
    ks = 4000
    for i in range(10):
        txs = []
        for _ in range(128):
            a, c = rnd.randrange(ks), rnd.randrange(ks)
            txs.append(
                CommitTransaction(
                    read_snapshot=i,
                    read_conflict_ranges=[(_spread_key(a, ks), _spread_key(a + 1 + rnd.randrange(2), ks))],
                    write_conflict_ranges=[(_spread_key(c, ks), _spread_key(c + 1 + rnd.randrange(2), ks))],
                )
            )
        pair.batch(txs, now=i + 20, oldest=max(i - 4, 0))
    pair.assert_same_state()
    snap = pair.port.metrics.snapshot()
    for name in ("overflowReplays", "reshardsDevice", "reshardsHost", "reshardsProactive", "capacityGrowths"):
        assert snap[name] > 0, (name, snap)
    assert all(n > 0 for n in snap["occupancy"]["liveRowsPerPartition"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_rebase_across_partitions_matches_jax(layout):
    """Versions that cross the int32 rebase threshold: the stacked grid is
    rebased over every partition at once, as the reference's vmap does."""
    rnd = random.Random(21)
    pair = Pair(layout, key_width=8, capacity=1 << 10, n_parts=4)
    v0 = (1 << 30) - 6
    for i in range(10):
        txs = []
        for _ in range(24):
            a, c = rnd.randrange(3000), rnd.randrange(3000)
            txs.append(
                CommitTransaction(
                    read_snapshot=v0 + i - rnd.randrange(4),
                    read_conflict_ranges=[(_spread_key(a, 3000), _spread_key(a + 3, 3000))],
                    write_conflict_ranges=[(_spread_key(c, 3000), _spread_key(c + 2, 3000))],
                )
            )
        pair.batch(txs, now=v0 + i + 5, oldest=v0 + i - 3)
    pair.assert_same_state()
    assert pair.port.metrics.snapshot()["rebases"] >= 1


def _spread_batches(n_batches, n_txns, keyspace, seed):
    """Batches of ranges over the whole first-byte range (every partition
    gets keys), read at snapshot i, as the overflow case draws them."""
    rnd = random.Random(seed)
    out = []
    for i in range(n_batches):
        txs = []
        for _ in range(n_txns):
            a, c = rnd.randrange(keyspace), rnd.randrange(keyspace)
            txs.append(CommitTransaction(
                read_snapshot=i,
                read_conflict_ranges=[(_spread_key(a, keyspace), _spread_key(a + 2, keyspace))],
                write_conflict_ranges=[(_spread_key(c, keyspace), _spread_key(c + 1, keyspace))],
            ))
        out.append(txs)
    return out


@pytest.mark.parametrize("layout", ["each", "pairs"])
def test_host_reshard_of_a_partition_whose_neighbour_is_on_another_entry(layout):
    """The host reshard of partition 1 bounds its candidates by partition
    2's first pivot: on another entry in both layouts (and a forced one,
    then batches on top, equal the reference's)."""
    pair = Pair(layout, key_width=8, capacity=1 << 10, n_parts=4)
    assert pair.port._spread.entry_of(1)[0] != pair.port._spread.entry_of(2)[0]
    batches = _spread_batches(8, 64, 3000, seed=17)
    for i, txs in enumerate(batches[:4]):
        pair.batch(txs, now=i + 20, oldest=max(i - 3, 0))
    pair.port._host_reshard_partition(1)
    pair.jax._host_reshard_partition(1)
    pair.jax._states = pair.jax._jax.device_put(pair.jax._states, pair.jax._sharding)
    for i, txs in enumerate(batches[4:], start=4):
        pair.batch(txs, now=i + 20, oldest=max(i - 3, 0))
    pair.assert_same_state()
    assert pair.port.metrics.snapshot()["reshardsHost"] >= 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_growth_reshards_every_entry(layout):
    """Growth doubles every partition's buckets on every entry, the live
    rows rebalanced as the reference's vmap does; batches on top agree."""
    pair = Pair(layout, key_width=8, capacity=1 << 10, n_parts=4)
    batches = _spread_batches(6, 64, 3000, seed=23)
    for i, txs in enumerate(batches[:3]):
        pair.batch(txs, now=i + 20, oldest=max(i - 3, 0))
    pair.port._grow()
    pair.jax._grow()
    assert all(e.states.grid.shape[1] == pair.port._B for e in pair.port._spread.entries)
    for i, txs in enumerate(batches[3:], start=3):
        pair.batch(txs, now=i + 20, oldest=max(i - 3, 0))
    pair.assert_same_state()
    assert pair.port.metrics.snapshot()["capacityGrowths"] == 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_close_drops_every_entrys_tensors(layout):
    cs = TorchMeshConflictSet(key_width=8, capacity=1 << 10, n_parts=4, device="cpu",
                              devices=layout_devices(layout, 4))
    for i, txs in enumerate(_spread_batches(3, 32, 3000, seed=29)):
        cs.detect_batch(txs, i + 20, i)
    handle = cs.detect_many_encoded_async([(cs.encode(_spread_batches(1, 8, 3000, seed=31)[0]), 30, 3)])
    refs = [weakref.ref(t) for e in cs._spread.entries for t in (*e.states, e.plo, e.phi)]
    occupancy = cs.metrics.snapshot()["occupancy"]
    cs.close()
    del handle
    gc.collect()
    assert cs._spread is None and cs._states is None
    assert not [r for r in refs if r() is not None]
    assert cs.metrics.snapshot()["occupancy"] == occupancy


@pytest.mark.parametrize("n_entries", [1, 2, 4])
def test_spread_from_numpy_then_gather_is_the_identity(n_entries):
    """A JAX mesh state carried into a spread and read back, bit for bit."""
    jmesh = MeshConflictSet(key_width=8, capacity=1 << 10, n_parts=4)
    for i, txs in enumerate(_spread_batches(3, 32, 3000, seed=37)):
        jmesh.detect_batch(_jtxs(txs), i + 20, i)
    for want in (jmesh._states, j_make_sharded_states(4, 16, 8, 3)):
        arrays = tuple(np.asarray(x) for x in want)
        spread = TS.spread_from_numpy(*arrays, ["cpu"] * n_entries)
        assert len(spread.entries) == n_entries and spread.n_parts == 4
        for a, b in zip(arrays, TS.gather_to_numpy(spread)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
