"""The PyTorch port's grid (foundationdb_tpu_torch/conflict/grid.py) held
against the JAX package's grid on the CPU, with exact equality.

Every value is an integer or a bool, so the tolerance is 0: verdicts,
pressure and all five GridState arrays must be identical. Inputs are made
from a seed — a JAX ``TpuConflictSet`` is driven mid-run over the shapes of
tests/test_conflict_tpu.py and tests/test_reshard_device.py, and its
state and the next encoded batches (numpy) go to both sides.
"""

import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict import grid as JG
from foundationdb_tpu.conflict import tpu_backend as JB
from foundationdb_tpu.conflict.api import CommitTransaction
from foundationdb_tpu.conflict.tpu_backend import TpuConflictSet
from foundationdb_tpu_torch.conflict import grid as TG
from foundationdb_tpu_torch.conflict import torch_backend as TB

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

CPU = torch.device("cpu")
END = b"\xff" * 40  # encodes to the all-0xFF sentinel code at any width


def _rand_txs(rnd, keyspace, n, snap_lo, snap_hi, maxlen=10):
    def rng():
        a = rnd.randrange(keyspace)
        return (b"k%08d" % a, b"k%08d" % (a + 1 + rnd.randrange(maxlen)))

    txs = []
    for _ in range(n):
        tr = CommitTransaction(read_snapshot=rnd.randrange(snap_lo, snap_hi + 1))
        for _ in range(rnd.randrange(0, 3)):
            tr.read_conflict_ranges.append(rng())
        for _ in range(rnd.randrange(0, 3)):
            tr.write_conflict_ranges.append(rng())
        txs.append(tr)
    return txs


def _random_work(seed, keyspace, n, batches, maxlen=10, v0=100):
    rnd = random.Random(seed)
    out, v = [], v0
    for _ in range(batches):
        txs = _rand_txs(rnd, keyspace, n, max(0, v - 60), v, maxlen)
        out.append((txs, v + 10, max(0, v - 40)))
        v += 10
    return out


def _mk_reshard_batch(rnd, n_txns, keyspace, snap):
    txs = []
    for _ in range(n_txns):
        a, c = rnd.randrange(keyspace), rnd.randrange(keyspace)
        txs.append(
            CommitTransaction(
                read_snapshot=snap,
                read_conflict_ranges=[(b"%06d" % a, b"%06d" % (a + 1 + rnd.randrange(5)))],
                write_conflict_ranges=[(b"%06d" % c, b"%06d" % (c + 1 + rnd.randrange(5)))],
            )
        )
    return txs


def _scenario(name):
    """(width, capacity, warm-up work, 3 probe batches, force_reshard)."""
    if name == "high":
        w = _random_work(0, 30, 12, 28)
        return 32, 256, w[:25], w[25:], False
    if name == "low":
        w = _random_work(100, 100000, 16, 13)
        return 32, 256, w[:10], w[10:], False
    if name == "wide":
        # long ranges over a small grid: spanned buckets (floors) and
        # between-bucket bmax maxima
        w = _random_work(5, 2000, 12, 18, maxlen=300)
        return 12, 256, w[:15], w[15:], False
    if name == "hot_key":
        point = [(b"counter", b"counter\x00")]
        hot = [CommitTransaction(0, [], list(point)) for _ in range(40)]
        rw = [CommitTransaction(5, list(point), list(point)) for _ in range(40)]
        w = _random_work(3, 50, 10, 3)
        return 32, 256, w[:2], [(hot, 130, 0), (rw, 140, 0), w[2]], False
    if name == "clear_end":
        w = _random_work(4, 50, 10, 2)
        probes = [
            ([CommitTransaction(100, [], [(b"m", END)])], 130, 0),
            ([CommitTransaction(105, [(b"z", END)], [])], 131, 0),
            ([CommitTransaction(112, [(b"a", b"b")], [(b"q", b"r")]),
              CommitTransaction(112, [(b"n", END)], [])], 132, 0),
        ]
        return 32, 64, w, probes, False
    if name == "sentinel_hot":
        w = _random_work(6, 50, 10, 2)
        hot = [CommitTransaction(100, [], [(b"h%02d" % i, END)]) for i in range(20)]
        probe = [CommitTransaction(103, [(b"h05", b"h06")], [])]
        return 32, 64, w, [(hot, 130, 0), (probe, 131, 0), (hot[:3] + probe, 132, 0)], False
    if name == "reshard":
        rnd = random.Random(9)
        work = [(_mk_reshard_batch(rnd, 30, 2000, i), i + 30, max(i - 8, 0)) for i in range(15)]
        return 8, 1 << 10, work[:12], work[12:], True
    raise KeyError(name)


SCENARIOS = ["high", "low", "wide", "hot_key", "clear_end", "sentinel_hot", "reshard"]
_CACHE = {}


def _setup(name):
    """Drive the JAX backend through the warm-up, then encode the probes
    against its version base. Returns the JAX state (numpy), the probes'
    numpy Batches and their relative (now, oldest_pre, oldest_post)."""
    if name in _CACHE:
        return _CACHE[name]
    width, cap, warm, probes, force_reshard = _scenario(name)
    cs = TpuConflictSet(key_width=width, capacity=cap)
    for txs, now, old in warm:
        cs.detect_batch(txs, now, old)
    if force_reshard:
        cs._reshard(cs._state)  # device rebalance mid-run
    state = tuple(np.asarray(x) for x in cs._state)
    base, horizon = cs._base, cs.oldest_version
    batches, vers = [], []
    for txs, now, old in probes:
        batches.append(JB.encode_transactions(txs, width, base))
        post = max(horizon, old)
        vers.append((now - base, max(horizon - base, 0), max(post - base, 0)))
        horizon = post
    _CACHE[name] = (state, batches, vers)
    return _CACHE[name]


def _jstate(state):
    return JG.GridState(*(jnp.asarray(x) for x in state))


def _tstate(state):
    return TG.state_from_numpy(*state, CPU)


def _jbatch(b):
    return JG.Batch(*(jnp.asarray(x) for x in b))


def _assert_state_equal(jstate, tstate):
    for field, a, b in zip(JG.GridState._fields, jstate, TG.state_to_numpy(tstate)):
        a = np.asarray(a)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("name", SCENARIOS)
def test_k1_history_conflicts_matches_jax(name):
    state, batches, _ = _setup(name)
    for b in batches:
        want = np.asarray(JG.history_conflicts(_jstate(state), _jbatch(b)))
        got = TG.history_conflicts(_tstate(state), TB.upload(b, CPU)).numpy()
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("name", ["wide", "low", "reshard"])
def test_k1_keyspace_wide_reads_match_jax(name):
    """Reads over the whole keyspace, from a pivot to the all-0xFF end, and
    across every whole superblock between two pivots, on a grid with
    B2 > 1 buckets per superblock: the paths the card's kernel takes
    through its edge superblocks and superblock maxima. Snapshots run from
    below every version to above them, so both verdicts occur."""
    state, batches, _ = _setup(name)
    pivots, grid = state[0], state[1]
    B, _S, Lp1 = grid.shape
    L = Lp1 - 1
    n_used = int((pivots != 0xFFFFFFFF).any(axis=1).sum())
    B1, B2 = TG._split_factors(B)
    assert B2 > 1 and n_used > 2 * B2 + 1
    T = 48
    rb = np.zeros((T, 3, L), np.uint32)
    re = np.full((T, 3, L), 0xFFFFFFFF, np.uint32)  # read 0: the whole keyspace
    rb[:, 1] = pivots[1]  # read 1: a pivot to the end
    rb[:, 2], re[:, 2] = pivots[1], pivots[n_used - 1]  # read 2: whole superblocks between
    rb[T // 3 :, 0] = re[T // 3 :, 0] = 0xFFFFFFFF  # padding, so reads 1 and 2 decide
    rb[2 * T // 3 :, 1] = re[2 * T // 3 :, 1] = 0xFFFFFFFF
    top = int(max(grid[..., L].max(), state[4].max()))
    snap = np.linspace(-1, top + 1, T).astype(np.int32)
    no_writes = np.full((T, 1, L), 0xFFFFFFFF, np.uint32)
    b = JG.Batch(rb, re, no_writes, no_writes, snap, np.ones(T, bool))
    want = np.asarray(JG.history_conflicts(_jstate(state), _jbatch(b)))
    got = TG.history_conflicts(_tstate(state), TB.upload(b, CPU)).numpy()
    np.testing.assert_array_equal(want, got)
    assert want.any() and not want.all()


def _jax_H(state, b, vers):
    jb = _jbatch(b)
    too_old = jb.t_has_reads & (jb.t_snap < vers[1])
    return JG.history_conflicts(_jstate(state), jb) | too_old


@pytest.mark.parametrize("name", SCENARIOS)
def test_k2_intra_batch_commits_matches_jax(name):
    state, batches, vers = _setup(name)
    for b, v in zip(batches, vers):
        H = _jax_H(state, b, v)
        want = np.asarray(JG.intra_batch_commits(_jbatch(b), H))
        got = TG.intra_batch_commits(TB.upload(b, CPU), torch.from_numpy(np.array(H)))
        np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("name", SCENARIOS)
def test_k3_merge_writes_matches_jax(name):
    state, batches, vers = _setup(name)
    for b, v in zip(batches, vers):
        jb = _jbatch(b)
        commit = JG.intra_batch_commits(jb, _jax_H(state, b, v))
        js, jp = JG.merge_writes(
            _jstate(state), jb, commit, jnp.int32(v[0]), jnp.int32(v[2])
        )
        ts, tp = TG.merge_writes(
            _tstate(state), TB.upload(b, CPU),
            torch.from_numpy(np.asarray(commit)), v[0], v[2],
        )
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        _assert_state_equal(js, ts)


@pytest.mark.parametrize("name", SCENARIOS)
def test_k4a_reshard_device_matches_jax(name):
    state, _, _ = _setup(name)
    B, S = state[1].shape[:2]
    for n_buckets in (B, 2 * B, max(B // 2, 8)):
        js, jp = JG.reshard_device(_jstate(state), n_buckets, S)
        ts, tp = TG.reshard_device(_tstate(state), n_buckets, S)
        assert int(jp) == int(tp)
        _assert_state_equal(js, ts)


@pytest.mark.parametrize("name", SCENARIOS)
def test_k4b_rebase_matches_jax(name):
    state, _, vers = _setup(name)
    for delta in (1, max(vers[0][0] // 2, 1), vers[0][0] + 5):
        js = JG.rebase(_jstate(state), jnp.int32(delta))
        ts = TG.rebase(_tstate(state), delta)
        _assert_state_equal(js, ts)


def _resolve_both(state, batches, vers):
    width_lanes = batches[0].rb.shape[-1]
    stacked = JB.stack_batches(batches, width_lanes)
    cols = [np.asarray([v[i] for v in vers], np.int32) for i in range(3)]
    js, jv, jp = JG.resolve_many(
        _jstate(state), JG.Batch(*(jnp.asarray(x) for x in stacked)), *cols
    )
    ts, tv, tp = TG.resolve_many(
        _tstate(state), TB.upload(TB.stack_batches(batches, width_lanes), CPU), *cols
    )
    return (js, jv, jp), (ts, tv, tp)


@pytest.mark.parametrize("name", SCENARIOS)
def test_resolve_many_group_of_three_matches_jax(name):
    state, batches, vers = _setup(name)
    (js, jv, jp), (ts, tv, tp) = _resolve_both(state, batches, vers)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    _assert_state_equal(js, ts)


def test_state_carried_across_mid_run_continues_identically():
    """A JAX GridState taken mid-run and loaded with state_from_numpy
    continues batch for batch exactly as the JAX grid does."""
    work = _random_work(21, 40, 12, 17)
    cs = TpuConflictSet(key_width=32, capacity=256)
    for txs, now, old in work[:12]:
        cs.detect_batch(txs, now, old)
    jstate = cs._state
    tstate = TG.state_from_numpy(*(np.asarray(x) for x in jstate), CPU)
    _assert_state_equal(jstate, tstate)
    base, horizon = cs._base, cs.oldest_version
    for txs, now, old in work[12:]:
        b = JB.encode_transactions(txs, 32, base)
        post = max(horizon, old)
        v = [now - base, max(horizon - base, 0), max(post - base, 0)]
        horizon = post
        cols = [np.asarray([x], np.int32) for x in v]
        jstate, jv, jp = JG.resolve_many(
            jstate, JG.Batch(*(jnp.asarray(x[None]) for x in b)), *cols
        )
        tstate, tv, tp = TG.resolve_many(
            tstate, TB.upload(TB.stack_batches([b], 8), CPU), *cols
        )
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        _assert_state_equal(jstate, tstate)


def test_host_reshard_and_live_rows_match_jax():
    state, _, _ = _setup("wide")
    jcodes, jvers = JG.live_rows(_jstate(state))
    tcodes, tvers = TG.live_rows(_tstate(state))
    np.testing.assert_array_equal(jcodes, tcodes)
    np.testing.assert_array_equal(jvers, tvers)
    B, S = state[1].shape[:2]
    cands = jcodes[jcodes.any(axis=1)]
    piv = JB._pick_pivots(cands, B, jcodes.shape[1])
    np.testing.assert_array_equal(piv, TB._pick_pivots(cands, B, jcodes.shape[1]))
    _assert_state_equal(
        JG.reshard_host(_jstate(state), piv, B, S),
        TG.reshard(_tstate(state), piv, B, S),
    )
    assert JG.occupancy_stats(_jstate(state)) == TG.occupancy_stats(_tstate(state))


# ---------------------------------------------------------------------------
# K2 and K3 scenarios of the redesigned kernels' hard cases: the port's
# CPU path against the JAX package, exactly


def _key(i):
    return b"k%04d" % i


def _k2_txs(name):
    rnd = random.Random(zlib.crc32(name.encode()))
    if name.startswith("random_"):
        n = int(name.split("_")[1])
        txs = []
        for _ in range(n):
            tr = CommitTransaction(read_snapshot=0)
            for _ in range(rnd.randrange(0, 3)):
                a = rnd.randrange(60)
                tr.read_conflict_ranges.append((_key(a), _key(a + rnd.randrange(0, 6))))
            for _ in range(rnd.randrange(0, 3)):
                a = rnd.randrange(60)
                tr.write_conflict_ranges.append((_key(a), _key(a + 1 + rnd.randrange(6))))
            txs.append(tr)
        return txs
    if name == "chain":  # txn j reads what txn j - 1 wrote
        return [CommitTransaction(0, [(_key(j - 1), _key(j))], [(_key(j), _key(j + 1))])
                for j in range(1, 100)]
    if name == "hot_key":  # every txn reads and writes one key
        return [CommitTransaction(0, [(b"hot", b"hot\x00")], [(b"hot", b"hot\x00")]) for _ in range(70)]
    if name == "empty_read":  # empty reads inside an earlier write, and at its ends
        txs = [CommitTransaction(0, [], [(_key(10), _key(20))])]
        txs += [CommitTransaction(0, [(_key(k), _key(k))], []) for k in (5, 10, 15, 20, 25)]
        return txs
    if name == "kr3_kw2":
        return [CommitTransaction(
            0,
            [(_key(a), _key(a + rnd.randrange(1, 4))) for a in rnd.sample(range(80), 3)],
            [(_key(a), _key(a + rnd.randrange(1, 4))) for a in rnd.sample(range(80), 2)],
        ) for _ in range(40)]
    raise KeyError(name)


K2_SCENARIOS = ["random_1", "random_31", "random_32", "random_33", "random_545",
                "chain", "hot_key", "empty_read", "kr3_kw2"]


@pytest.mark.parametrize("name", K2_SCENARIOS)
def test_k2_scenarios_match_jax(name):
    txs = _k2_txs(name)
    b = JB.encode_transactions(txs, 12, 0)
    T = b.t_snap.shape[0]
    if name == "kr3_kw2":
        assert b.rb.shape[1:] == (4, 3) and b.wb.shape[1] == 2
    rnd = np.random.default_rng(len(name))
    for H in (np.zeros(T, bool), rnd.random(T) < 0.2):
        want = np.asarray(JG.intra_batch_commits(_jbatch(b), jnp.asarray(H)))
        got = TG.intra_batch_commits(TB.upload(b, CPU), torch.from_numpy(H)).numpy()
        np.testing.assert_array_equal(want, got)
        if name == "chain" and not H.any():
            assert got[: len(txs)].tolist() == [j % 2 == 0 for j in range(len(txs))]


def _k3_case(name):
    """(state, batch, commit, now, oldest): a fresh or mid-run grid and a
    write batch that stresses the staging."""
    if name == "overflow":  # 30 distinct codes land in bucket 0 of a fresh grid
        txs = [CommitTransaction(0, [], [(_key(3 * i), _key(3 * i + 1))]) for i in range(15)]
        state = tuple(np.asarray(x) for x in JG.make_state(64, 32, 3))
    elif name == "clear_end":  # valid ends at the all-0xFF code
        state = _setup("clear_end")[0]
        txs = [CommitTransaction(0, [], [(b"m%d" % i, END)]) for i in range(6)]
        txs += [CommitTransaction(0, [], [(b"a", b"b")])]
    elif name == "hot_key":  # 5000 endpoint rows on one key
        state = _setup("hot_key")[0]
        txs = [CommitTransaction(0, [], [(b"counter", b"counter\x00")]) for _ in range(2500)]
    else:
        raise KeyError(name)
    width = 12 if name == "overflow" else 32
    b = JB.encode_transactions(txs, width, 0)
    commit = np.random.default_rng(len(name)).random(b.t_snap.shape[0]) < 0.9
    return state, b, commit, 150, 3


@pytest.mark.parametrize("name", ["overflow", "clear_end", "hot_key"])
def test_k3_staging_cases_match_jax(name):
    state, b, commit, now, oldest = _k3_case(name)
    js, jp = JG.merge_writes(_jstate(state), _jbatch(b), jnp.asarray(commit), jnp.int32(now), jnp.int32(oldest))
    ts, tp = TG.merge_writes(_tstate(state), TB.upload(b, CPU), torch.from_numpy(commit), now, oldest)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    _assert_state_equal(js, ts)
    if name == "overflow":
        assert int(tp[0]) > TG.staging_slots(32)
