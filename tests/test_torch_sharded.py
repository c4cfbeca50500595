"""The port's partitioned resolver (foundationdb_tpu_torch/conflict/sharded.py)
held against the JAX package's sharded resolver on a CPU device mesh, with
exact equality.

Every value is an integer or a bool, so the tolerance is 0: verdicts, the
per-batch [G, P, 2] pressures and every stacked GridState array must be
identical after every group. Inputs are made from seeded ``random``: ASCII
keys (whose first uint32 lane is 0x3030_3030-0x3939_3939, so all land in
partition 0 of the uniform first-lane split) and keys spread over the
first lane. The verdicts are also held to the port's oracle.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from foundationdb_tpu.conflict import grid as JG
from foundationdb_tpu.conflict import sharded as JS
from foundationdb_tpu_torch.conflict import sharded as TS
from foundationdb_tpu_torch.conflict import torch_backend as TB
from foundationdb_tpu_torch.conflict.api import CommitTransaction, Verdict, new_conflict_set

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

CPU = torch.device("cpu")
END = b"\xff" * 40  # encodes to the all-0xFF sentinel code
WIDTH, LANES = 12, 3


def _mesh(n_parts):
    return Mesh(
        np.array(jax.devices()[:n_parts]).reshape(n_parts, 1),
        axis_names=("part", "data"),
    )


def _key(i, keys):
    if keys == "ascii":
        return b"%08d" % i
    # first byte spread over 0-255: every partition owns some traffic
    return bytes([i * 256 // 3000 % 256]) + b"%06d" % i


def _batch(rnd, n, snap, keys, wide=0.0):
    txs = []
    for _ in range(n):
        a, c = rnd.randrange(3000), rnd.randrange(3000)
        rr = [(_key(a, keys), _key(a + 1 + rnd.randrange(6), keys))]
        wr = [(_key(c, keys), _key(c + 1 + rnd.randrange(6), keys))]
        if rnd.random() < wide:  # a clear across partitions, or to the end
            lo = bytes([rnd.randrange(200)])
            wr.append((lo, END if rnd.random() < 0.3 else bytes([rnd.randrange(lo[0] + 1, 256)])))
        if rnd.random() < wide:
            rr.append((bytes([rnd.randrange(256)]), END))
        txs.append(CommitTransaction(snap - rnd.randrange(16), rr, wr))
    return txs


def _jstates(states_np, n_parts):
    spec = jax.tree.map(
        lambda _: NamedSharding(_mesh(n_parts), P("part")), JG.GridState(0, 0, 0, 0, 0)
    )
    return jax.device_put(JG.GridState(*(jnp.asarray(x) for x in states_np)), spec)


def _assert_states_equal(jstates, tstates):
    for field, a, b in zip(JG.GridState._fields, jstates, TS.states_to_numpy(tstates)):
        a = np.asarray(a)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("n_parts", [2, 3, 4])
def test_states_and_bounds_match_jax(n_parts):
    _assert_states_equal(
        JS.make_sharded_states(n_parts, 16, 8, LANES),
        TS.make_sharded_states(n_parts, 16, 8, LANES, CPU),
    )
    plo, phi = TS.partition_bounds(LANES, n_parts, CPU)
    for p in range(n_parts):
        jlo, jhi = JS._partition_bounds(LANES, n_parts, jnp.int32(p))
        np.testing.assert_array_equal(np.asarray(jlo), plo[p].numpy().view(np.uint32))
        np.testing.assert_array_equal(np.asarray(jhi), phi[p].numpy().view(np.uint32))


def test_clip_matches_jax():
    rnd = np.random.default_rng(0)
    b = rnd.integers(0, 2**32, (64, 2, LANES), dtype=np.uint64).astype(np.uint32)
    e = rnd.integers(0, 2**32, (64, 2, LANES), dtype=np.uint64).astype(np.uint32)
    e[::5] = 0xFFFFFFFF
    plo, phi = TS.partition_bounds(LANES, 4, CPU)
    for p in range(4):
        jb, je = JS._clip(jnp.asarray(b), jnp.asarray(e), *JS._partition_bounds(LANES, 4, jnp.int32(p)))
        tb, te = TS.clip(torch.from_numpy(b.view(np.int32)), torch.from_numpy(e.view(np.int32)), plo[p], phi[p])
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy().view(np.uint32))
        np.testing.assert_array_equal(np.asarray(je), te.numpy().view(np.uint32))


def _groups(keys, seed, n_groups=4, per_group=3, n_txns=24, wide=0.0):
    rnd = random.Random(seed)
    out, i = [], 0
    for _ in range(n_groups):
        grp = []
        for _ in range(per_group):
            grp.append((_batch(rnd, n_txns, 20 + i, keys, wide), 40 + i, max(i - 3, 0)))
            i += 1
        out.append(grp)
    return out


@pytest.mark.parametrize("keys", ["ascii", "spread"])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_resolve_many_sharded_matches_jax_and_oracle(n_parts, keys):
    """Group after group, with a partition reshard and a rebase between
    groups: verdicts, per-batch pressures and all stacked arrays equal."""
    B, S = 16, 32
    step = JS.build_sharded_resolver_many(_mesh(n_parts), lanes=LANES)
    init = TS.states_to_numpy(TS.make_sharded_states(n_parts, B, S, LANES, CPU))
    jstates = _jstates(init, n_parts)
    tstates = TS.states_from_numpy(*init, CPU)
    oracle = new_conflict_set("oracle")
    base, horizon = 0, 0
    for gi, grp in enumerate(_groups(keys, 11 + n_parts, wide=0.2)):
        hb = TB.stack_batches([TB.encode_transactions(t, WIDTH, base) for t, _n, _o in grp], LANES)
        cols = [[], [], []]
        for _t, now, old in grp:
            post = max(horizon, old)
            for c, v in zip(cols, (now - base, max(horizon - base, 0), max(post - base, 0))):
                c.append(v)
            horizon = post
        cols = [np.asarray(c, np.int32) for c in cols]
        jstates, jv, jp = step(jstates, JG.Batch(*(jnp.asarray(x) for x in hb)), *cols)
        tstates, tv, tp = TS.resolve_many_sharded(tstates, TB.upload(hb, CPU), *cols)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        assert tp.shape == (len(grp), n_parts, 2)
        _assert_states_equal(jstates, tstates)
        for g, (txs, now, old) in enumerate(grp):
            want = oracle.detect_batch(txs, now, old)
            got = [Verdict(int(v)) for v in tv[g, : len(txs)]]
            assert got == want, (gi, g)
        if gi == 1:
            jstates, jpr = JS.reshard_partition(jstates, n_parts - 1, B, S)
            tstates, tpr = TS.reshard_partition(tstates, n_parts - 1, B, S)
            assert jpr == tpr
            _assert_states_equal(jstates, tstates)
        if gi == 2:
            # the vmapped rebase of MeshConflictSet._maybe_rebase
            delta = horizon - 1 - base  # the backends' new base: horizon - 1
            jstates = jax.vmap(JG.rebase.__wrapped__, in_axes=(0, None))(jstates, np.int32(delta))
            tstates = TS.rebase_parts(tstates, delta)
            base += delta
            _assert_states_equal(jstates, tstates)
    if keys == "spread":
        occ = TS.stacked_occupancy_stats(tstates)
        assert all(n > n_parts for n in occ["liveRowsPerPartition"]), occ
        assert occ == JS.stacked_occupancy_stats(jstates)


def _captured_pji(batch, H):
    seen = []
    JG.intra_batch_commits(batch, H, combine_pji=lambda p: seen.append(np.asarray(p)) or p)
    return seen[0]


@pytest.mark.parametrize("n_parts", [2, 4])
def test_or_of_clipped_pji_equals_unclipped(n_parts):
    """The reason the port runs K2 once on the unclipped ranks: the
    reference's per-partition clipped overlap matrices, OR-ed, equal the
    unclipped one — wide ranges across partition bounds and ranges ending
    at the all-0xFF code included."""
    rnd = random.Random(7)
    for seed_keys in ("ascii", "spread"):
        txs = _batch(rnd, 48, 5, seed_keys, wide=0.5)
        txs.append(CommitTransaction(5, [(b"\x00", END)], [(b"\x7f", END)]))
        hb = TB.encode_transactions(txs, WIDTH, 0)
        jb = JG.Batch(*(jnp.asarray(x) for x in hb))
        H = jnp.zeros(hb.t_snap.shape, bool)
        whole = _captured_pji(jb, H)
        ored = np.zeros_like(whole)
        for p in range(n_parts):
            plo, phi = JS._partition_bounds(LANES, n_parts, jnp.int32(p))
            rb, re = JS._clip(jb.rb, jb.re, plo, phi)
            wb, we = JS._clip(jb.wb, jb.we, plo, phi)
            ored |= _captured_pji(jb._replace(rb=rb, re=re, wb=wb, we=we), H)
        np.testing.assert_array_equal(ored, whole)
        assert whole.sum() > 0


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_history_straddling_reads_match_jax_per_partition(n_parts):
    """K6 history's plain version against the reference's own per-partition
    check (``_clip`` of the reads, ``history_conflicts`` on each partition's
    grid, OR over the partitions) on reads straddling every partition bound,
    reads across several partitions and the whole keyspace, over a stacked
    state with history in every partition."""
    rnd = random.Random(20 + n_parts)
    B, S = 16, 32
    tstates = TS.make_sharded_states(n_parts, B, S, LANES, CPU)
    for grp in _groups("spread", 5 + n_parts, n_groups=2, wide=0.3):
        hb = TB.stack_batches([TB.encode_transactions(t, WIDTH, 0) for t, _n, _o in grp], LANES)
        cols = [np.asarray([n for _t, n, _o in grp], np.int32)] + [np.zeros(len(grp), np.int32)] * 2
        tstates, _v, _p = TS.resolve_many_sharded(tstates, TB.upload(hb, CPU), *cols)
    assert bool((tstates.bmax.amax(dim=1) > 0).all())  # writes landed in every partition
    txs = _batch(rnd, 48, 30, "spread", wide=0.5)
    for p in range(1, n_parts):
        edge = p * 256 // n_parts  # the first byte of partition p's low bound
        txs.append(CommitTransaction(20 + p, [(bytes([edge - 1, 200]), bytes([edge, 9]))], []))
        txs.append(CommitTransaction(25 + p, [(bytes([edge - 1]), bytes([min(edge + 256 // n_parts, 255)]))], []))
    txs.append(CommitTransaction(20, [(b"", END)], []))
    txs.append(CommitTransaction(60, [(b"", END)], []))
    hb = TB.encode_transactions(txs, WIDTH, 0)
    jb = JG.Batch(*(jnp.asarray(x) for x in hb))
    host = TS.states_to_numpy(tstates)
    want = np.zeros(hb.t_snap.shape, bool)
    for p in range(n_parts):
        plo, phi = JS._partition_bounds(LANES, n_parts, jnp.int32(p))
        rb, re = JS._clip(jb.rb, jb.re, plo, phi)
        shard = JG.GridState(*(jnp.asarray(x[p]) for x in host))
        want |= np.asarray(JG.history_conflicts(shard, jb._replace(rb=rb, re=re)))
    got = TS.history_conflicts_sharded(tstates, TB.upload(hb, CPU), *TS.partition_bounds(LANES, n_parts, CPU))
    np.testing.assert_array_equal(want, got.numpy())
    assert want.any() and not want.all()


@pytest.mark.parametrize("n_buckets", [16, 32])
def test_reshard_parts_matches_jax_vmap(n_buckets):
    """K7a: the reference's vmap of reshard_device in MeshConflictSet._grow,
    on a mid-run stacked state."""
    import functools

    step = JS.build_sharded_resolver_many(_mesh(4), lanes=LANES)
    init = TS.states_to_numpy(TS.make_sharded_states(4, 16, 32, LANES, CPU))
    jstates = _jstates(init, 4)
    for grp in _groups("spread", 3, n_groups=2):
        hb = TB.stack_batches([TB.encode_transactions(t, WIDTH, 0) for t, _n, _o in grp], LANES)
        cols = [np.asarray([n for _t, n, _o in grp], np.int32)] + [
            np.asarray([o for _t, _n, o in grp], np.int32)
        ] * 2
        jstates, _v, _p = step(jstates, JG.Batch(*(jnp.asarray(x) for x in hb)), *cols)
    host = tuple(np.asarray(x) for x in jstates)
    grown, jpr = jax.vmap(
        functools.partial(JG.reshard_device.__wrapped__, n_buckets=n_buckets, n_slots=32)
    )(JG.GridState(*(jnp.asarray(x) for x in host)))
    tgrown, tpr = TS.reshard_parts(TS.states_from_numpy(*host, CPU), n_buckets, 32)
    np.testing.assert_array_equal(np.asarray(jpr), tpr.numpy())
    _assert_states_equal(grown, tgrown)


def test_staging_hard_cases_on_four_partitions_match_jax():
    """The staging launch's hard cases over P = 4 partitions, where the
    carry restarts at each partition: more than S2 distinct codes in one
    bucket (the pressure word the replay ladder reads), clears to the
    all-0xFF end spanning partitions, and a hot key (5000 endpoint rows of
    one code)."""
    n_parts, B, S = 4, 16, 32
    step = JS.build_sharded_resolver_many(_mesh(n_parts), lanes=LANES)
    init = TS.states_to_numpy(TS.make_sharded_states(n_parts, B, S, LANES, CPU))
    jstates = _jstates(init, n_parts)
    tstates = TS.states_from_numpy(*init, CPU)
    overflow = [CommitTransaction(1, [], [(bytes([70, i]), bytes([70, i, 1]))]) for i in range(20)]
    clears = [CommitTransaction(1, [(bytes([i * 50]), bytes([i * 50 + 3]))], [(bytes([i * 60 + 1]), END)])
              for i in range(4)]
    hot = [CommitTransaction(1, [], [(b"\xc0hot", b"\xc0hot\x00")]) for _ in range(2500)]
    grp = [(overflow, 10, 0), (clears, 11, 0), (hot, 12, 0)]
    hb = TB.stack_batches([TB.encode_transactions(t, WIDTH, 0) for t, _n, _o in grp], LANES)
    cols = [np.asarray([n for _t, n, _o in grp], np.int32)] + [np.zeros(3, np.int32)] * 2
    jstates, jv, jp = step(jstates, JG.Batch(*(jnp.asarray(x) for x in hb)), *cols)
    tstates, tv, tp = TS.resolve_many_sharded(tstates, TB.upload(hb, CPU), *cols)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    _assert_states_equal(jstates, tstates)
    assert int(tp[0, 1, 0]) > JG.staging_slots(S)  # the overflow, in partition 1
