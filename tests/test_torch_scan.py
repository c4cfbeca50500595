"""The group scan's plain version (``grid.resolve_many_plain``) held against
the JAX package's ``resolve_many`` on one grid and its
``build_sharded_resolver_many`` on a ``part = 4`` mesh of conftest's 8
virtual CPU devices, and the scan's launch planner (``kernels.scan_plan``).

Every output is an integer or a bool, so the tolerance is 0: verdicts, the
per-batch pressures, their maxima over the group and every GridState array
must be identical. Inputs are made from seeds: a JAX ``TpuConflictSet``
driven over random work and resharded gives the one grid (the sharded
cases start from the even split), and the groups mix random transactions
with the writes that overflow one bucket's staging planes or its slots,
reads below the MVCC horizon (TOO_OLD) and versions just below the int32
rebase threshold. The scan kernel itself runs only on a card
(tests/test_torch_cuda.py)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from foundationdb_tpu.conflict import grid as JG
from foundationdb_tpu.conflict import sharded as JS
from foundationdb_tpu.conflict.api import CommitTransaction
from foundationdb_tpu.conflict.tpu_backend import TpuConflictSet
from foundationdb_tpu_torch.conflict import grid as TG
from foundationdb_tpu_torch.conflict import keys as K
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict import sharded as TS
from foundationdb_tpu_torch.conflict import torch_backend as TB

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

CPU = torch.device("cpu")
WIDTH, LANES, T = 12, 3, 32
S, S2 = 32, TG.staging_slots(32)
NEAR_REBASE = (1 << 30) - 8  # the backends rebase the int32 origin at 1 << 30


def _key(n: int) -> bytes:
    return b"k%06d" % n


def _random_txns(rnd, n, snap_lo, snap_hi, keyspace=2000):
    txs = []
    for _ in range(n):
        tr = CommitTransaction(read_snapshot=rnd.randrange(snap_lo, snap_hi + 1))
        for _ in range(rnd.randrange(0, 3)):
            a = rnd.randrange(keyspace)
            tr.read_conflict_ranges.append((_key(a), _key(a + 1 + rnd.randrange(12))))
        for _ in range(rnd.randrange(0, 3)):
            a = rnd.randrange(keyspace)
            tr.write_conflict_ranges.append((_key(a), _key(a + 1 + rnd.randrange(12))))
        txs.append(tr)
    return txs


_WARM = {}


def _warm():
    """A JAX grid driven over 14 random batches and resharded: (state as
    numpy, version base, horizon)."""
    if not _WARM:
        rnd = random.Random(5)
        cs = TpuConflictSet(key_width=WIDTH, capacity=512)
        v = 100
        for _ in range(14):
            cs.detect_batch(_random_txns(rnd, 24, max(0, v - 60), v), v + 10, max(0, v - 40))
            v += 10
        cs._reshard(cs._state)
        _WARM.update(state=tuple(np.asarray(x) for x in cs._state), base=cs._base, horizon=cs.oldest_version)
    return _WARM["state"], _WARM["base"], _WARM["horizon"]


def _bucket_of(pivots, key: bytes) -> int:
    code = tuple(K.encode_keys([key], WIDTH)[0].tolist())
    return sum(tuple(p.tolist()) <= code for p in pivots) - 1


def _one_bucket_run(pivots, n: int) -> int:
    """The first key number a such that keys a .. a + n (and a + n's point
    write end) lie in one bucket of ``pivots``."""
    for a in range(0, 1900):
        if _bucket_of(pivots, _key(a)) == _bucket_of(pivots, _key(a + n) + b"\x00"):
            return a
    raise AssertionError("no bucket holds the run")


def _group(name: str):
    """(work [(txs, now, oldest)], versions base) of the named group on
    the warm grid."""
    state, base, _horizon = _warm()
    pivots = state[0]
    rnd = random.Random(name)
    v = 260  # above every version of the warm grid
    if name == "one":
        return [(_random_txns(rnd, T, v - 60, v), v + 10, v - 40)], base
    if name == "staging":  # the middle batch writes 40 ranges, 41 distinct codes, into one bucket
        a = _one_bucket_run(pivots, 41)
        run = [CommitTransaction(v, [], [(_key(a + i), _key(a + i + 1))]) for i in range(40)]
        return [(_random_txns(rnd, T, v - 60, v), v + 10, v - 40), (run, v + 20, v - 30),
                (_random_txns(rnd, T, v - 40, v + 20), v + 30, v - 20)], base
    if name == "bucket":  # 16 new rows in one bucket twice: staged in full, kept past S
        a = _one_bucket_run(pivots, 18) + 1  # past the bucket's first key, which may be its pivot
        first = [CommitTransaction(v, [], [(_key(a + 2 * i), _key(a + 2 * i) + b"\x00")]) for i in range(8)]
        second = [CommitTransaction(v, [], [(_key(a + 2 * i + 1), _key(a + 2 * i + 1) + b"\x00")])
                  for i in range(8)]
        return [(first, v + 10, v - 40), (second, v + 20, v - 30),
                (_random_txns(rnd, T, v - 40, v + 20), v + 30, v - 20)], base
    if name == "too_old_near_rebase":  # snapshots below the horizon; now just under 1 << 30
        hi = NEAR_REBASE + base
        work = []
        for g in range(5):
            now = hi + g
            txs = _random_txns(rnd, T, hi - 80, now - 1)
            work.append((txs, now, hi - 40 + 5 * g))
        return work, base
    raise KeyError(name)


def _encoded(work, base, horizon):
    """The group's host batches, stacked, and its relative (now,
    oldest_pre, oldest_post) columns, as the backend encodes them."""
    batches, cols = [], [[], [], []]
    for txs, now, old in work:
        batches.append(TB.encode_transactions(txs, WIDTH, base))
        post = max(horizon, old)
        for c, x in zip(cols, (now - base, max(horizon - base, 0), max(post - base, 0))):
            c.append(x)
        horizon = post
    # padded to at least T transactions and 2 slots, so that groups share their JAX programs
    stacked = TB.stack_batches(batches + [TB.sentinel_batch(T, 2, 2, LANES)], LANES)
    return TG.Batch(*(x[:-1] for x in stacked)), [np.asarray(c, np.int32) for c in cols]


def _assert_state_equal(jstate, tstate):
    for field, a, b in zip(JG.GridState._fields, jstate, TG.state_to_numpy(tstate)):
        a = np.asarray(a)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


GROUPS = [("one", 1), ("staging", 3), ("bucket", 3), ("too_old_near_rebase", 5)]


@pytest.mark.parametrize("name,G", GROUPS, ids=[g[0] for g in GROUPS])
def test_plain_scan_matches_jax_resolve_many(name, G):
    state, base, horizon = _warm()
    work, base = _group(name)
    assert len(work) == G
    stacked, cols = _encoded(work, base, horizon)
    jbatches = JG.Batch(*(jnp.asarray(x) for x in stacked))
    js, jv, jp = JG.resolve_many(JG.GridState(*(jnp.asarray(x) for x in state)), jbatches, *cols)
    # the per-batch pressures, batch by batch
    jper, jstate = [], JG.GridState(*(jnp.asarray(x) for x in state))
    for g in range(G):
        jstate, _v, p = JG.resolve_batch(jstate, JG.Batch(*(x[g] for x in jbatches)), *(c[g] for c in cols))
        jper.append(np.asarray(p))

    ts = TG.state_from_numpy(*state, CPU)
    tv, tp = TG.resolve_many_plain(ts, TB.upload(stacked, CPU), *cols)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert tp.shape == (G, 1, 2)
    np.testing.assert_array_equal(np.stack(jper), tp[:, 0].numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.amax(dim=0)[0].numpy())
    _assert_state_equal(js, ts)

    # the entry point on the CPU, and the loop of the per-batch dispatchers
    for fn in (lambda s: TG.resolve_many(s, TB.upload(stacked, CPU), *cols)[1:],
               lambda s: TG.resolve_many_loop(s, TB.upload(stacked, CPU), *cols)):
        ts2 = TG.state_from_numpy(*state, CPU)
        v2, p2 = fn(ts2)
        assert torch.equal(v2, tv)
        assert torch.equal(p2, tp.amax(dim=0).reshape(2) if p2.dim() == 1 else tp)
        _assert_state_equal(js, ts2)

    jp_per = np.stack(jper)
    if name == "staging":
        assert jp_per[1, 0] > S2 and jp_per[0, 0] <= S2  # the middle batch dropped staged rows
    if name == "bucket":
        assert jp_per[0, 0] <= S2 and jp_per[1, 0] <= S2 and jp_per[1, 1] > S  # a bucket dropped rows
    if name == "too_old_near_rebase":
        assert (np.asarray(jv) == TG.TOO_OLD).any() and (np.asarray(jv) == TG.COMMITTED).any()


def _mesh(n_parts):
    return Mesh(np.array(jax.devices()[:n_parts]).reshape(n_parts, 1), axis_names=("part", "data"))


def _spread_key(i: int, prefix: int | None = None) -> bytes:
    """First byte over 0-255 (every partition owns traffic), or ``prefix``."""
    first = i * 256 // 3000 % 256 if prefix is None else prefix
    return bytes([first]) + b"%06d" % i


def _sharded_groups():
    rnd = random.Random(44)
    end = b"\xff" * 40  # encodes to the all-0xFF code

    def txns(n, snap):
        out = []
        for _ in range(n):
            a, c = rnd.randrange(3000), rnd.randrange(3000)
            rr = [(_spread_key(a), _spread_key(a + 1 + rnd.randrange(6)))]
            wr = [(_spread_key(c), _spread_key(c + 1 + rnd.randrange(6)))]
            if rnd.random() < 0.2:  # a clear across partitions, or to the end
                lo = bytes([rnd.randrange(200)])
                wr.append((lo, end if rnd.random() < 0.3 else bytes([rnd.randrange(lo[0] + 1, 256)])))
            out.append(CommitTransaction(snap - rnd.randrange(16), rr, wr))
        return out

    # 40 ranges into one bucket of partition 2 (first byte 0x90 of its
    # 0x80-0xBF), beside random batches
    run = [CommitTransaction(30, [], [(_spread_key(i, 0x90), _spread_key(i + 1, 0x90))]) for i in range(40)]
    hi = NEAR_REBASE
    return [
        [(txns(24, 20), 40, 0), (run, 41, 0), (txns(24, 22), 42, 1)],
        [(txns(24, hi - 20 + g), hi + g, hi - 30 + 4 * g) for g in range(5)],
    ]


def test_plain_scan_over_four_partitions_matches_jax_sharded_resolver_many():
    n_parts, B = 4, 16
    step = JS.build_sharded_resolver_many(_mesh(n_parts), lanes=LANES)
    init = TS.states_to_numpy(TS.make_sharded_states(n_parts, B, S, LANES, CPU))
    spec = jax.tree.map(lambda _: NamedSharding(_mesh(n_parts), P("part")), JG.GridState(0, 0, 0, 0, 0))
    jstates = jax.device_put(JG.GridState(*(jnp.asarray(x) for x in init)), spec)
    tstates = TS.states_from_numpy(*init, CPU)
    other = TS.states_from_numpy(*init, CPU)
    bounds = TS.partition_bounds(LANES, n_parts, CPU)
    horizon, overflowed = 0, False
    for grp in _sharded_groups():
        stacked, cols = _encoded(grp, 0, horizon)
        horizon = max([horizon] + [old for _t, _n, old in grp])
        jstates, jv, jp = step(jstates, JG.Batch(*(jnp.asarray(x) for x in stacked)), *cols)
        tv, tp = TG.resolve_many_plain(tstates, TB.upload(stacked, CPU), *cols, bounds)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        assert tp.shape == (len(grp), n_parts, 2)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        _assert_state_equal(jstates, tstates)
        # the one-entry dispatcher on the CPU takes the same plain loop
        _s, ov, op = TS.resolve_many_sharded(other, TB.upload(stacked, CPU), *cols)
        assert torch.equal(ov, tv) and torch.equal(op, tp)
        overflowed |= bool((tp[..., 0] > S2).any())
    assert overflowed  # the run of 40 ranges overflowed partition 2's staging


# --- the launch planner ------------------------------------------------------

def _words(n: int) -> int:
    return -(-n // 4) * 4


def test_scan_plan_at_the_bench_shape():
    """40 × 2560 × (1, 1) at L = 3 on 32768 × 32: 8192 staging rows in
    sort tiles of 1024 (CTAs sort them side by side, then merge passes), a
    tile's records set the shared memory; one CTA an SM on 132 SMs; K2's
    overlap items of 32 readers; the merge's rows in shared memory; two
    record buffers; the aggregation's 16 chunk totals."""
    plan = kernels.scan_plan(40, 2560, 1, 1, 3, 1, 32768, 32, 16, n_sms=132)
    assert plan.blocks == 132
    assert plan.n2pad == 8192 and plan.tile == kernels.SCAN_TILE_ROWS == 1024
    assert plan.smem == 1024 * (5 * 4 + 6) == 26_624
    assert plan.overlap == (32, 1)
    assert plan.rows_in_smem and plan.U == 5120
    sizes = {k: n for k, (_o, n) in plan.offsets.items()}
    assert sizes == {"bmax_sup": 256, "H": 640, "commit": 640, "pt": 32 * 80 * 80, "st_code": 5120 * 16 * 3,
                     "st_ev": 5120 * 16, "tid": 5120, "carry": 5120, "rec_a": 8192 * 5, "rec_b": 8192 * 5,
                     "rows": 0, "agg": 8192 // kernels.SCAN_THREADS * 8, "counters": 3 * 40}
    assert plan.words == sum(_words(n) for n in sizes.values())
    offs = [o for o, _n in plan.offsets.values()]
    assert offs == sorted(offs) and all(o % 4 == 0 for o in offs)  # 16-byte aligned pieces


def test_scan_plan_at_the_commit_paths_shape():
    """A group of one at the commit path's widest batch (T = 64, KR = 8,
    KW = 1, L = 8) on a resolver's 512 × 32 grid: 128 staging rows in one
    tile, which its CTA sorts and aggregates (one record buffer); one
    reader an overlap item, as the 96 (reader, word) pairs give the grid's
    2112 warps fewer than one each; the merge's rows, payloads and order in
    shared memory set it (16 warps × 64 × 10 words)."""
    plan = kernels.scan_plan(1, 64, 8, 1, 8, 1, 512, 32, 16, n_sms=132)
    assert plan.n2pad == plan.tile == 128 and plan.offsets["rec_b"][1] == 0
    assert plan.overlap == (1, 1)
    assert plan.rows_in_smem and plan.smem == 16 * 64 * 10 * 4
    assert plan.U == 128 and plan.offsets["pt"][1] == 32 * 2 * 2


def test_scan_plan_slices_the_soaks_write_slots():
    """The soak's widest batch (T = 8, KR = 1, KW = 16): 8 (reader, word)
    pairs, each lane's 16 slot pairs past SCAN_SLICE_WORK, so the write
    slots are sliced 16 ways (an item a slot, ORed into the bitset); a
    bulk load's 2048 write slots in 256 slices (the grid's 2112 warps over
    its 8 pairs)."""
    assert kernels.scan_plan(1, 8, 1, 16, 8, 1, 512, 32, 16, n_sms=132).overlap == (1, 16)
    assert kernels.scan_plan(1, 8, 1, 2048, 8, 1, 512, 32, 16, n_sms=132).overlap == (1, 256)
    assert kernels.scan_plan(1, 8, 1, 8, 8, 1, 512, 32, 16, n_sms=132).overlap == (1, 1)  # 8 pairs a lane


def test_scan_phase_ms_sums_each_phase_over_the_group():
    """The timer's host side on synthetic stamps: ms a group a phase (the
    mean over stacked runs), from stamps near 2^61 ns as the card's clock
    gives them, exact to the nanosecond."""
    n = len(kernels.SCAN_PHASES)
    t0 = 1_760_000_000_000_000_000  # ns since the epoch: above float64's 2^53
    steps = torch.tensor([1000, 2000, 3000, 4000, 5000, 6000, 7000, 8000][:n], dtype=torch.int64)
    one = torch.cat([torch.zeros(1, dtype=torch.int64), steps.cumsum(0)])
    group = torch.stack([t0 + one, t0 + one[-1] + one + 7])  # two batches, back to back
    out = kernels.scan_phase_ms(group)
    assert out["batches"] == 2 and list(out["phases"]) == list(kernels.SCAN_PHASES)
    assert [round(v, 9) for v in out["phases"].values()] == [2 * x / 1e6 for x in steps.tolist()]
    assert out["total_ms"] == pytest.approx(2 * steps.sum().item() / 1e6, abs=1e-9)
    twice = torch.stack([group, group + torch.cat([torch.zeros(1), steps]).to(torch.int64).cumsum(0)])
    again = kernels.scan_phase_ms(twice)
    assert [round(v, 9) for v in again["phases"].values()] == [3 * x / 1e6 for x in steps.tolist()]
    with pytest.raises(ValueError):
        kernels.scan_phase_ms(torch.zeros((2, n), dtype=torch.int64))


def test_scan_plan_over_partitions_and_occupancy():
    plan = kernels.scan_plan(40, 2560, 1, 1, 3, 4, 8192, 32, 16, n_sms=132, blocks_per_sm=2)
    assert plan.blocks == 264
    assert plan.U == 4 * 5120
    sizes = {k: n for k, (_o, n) in plan.offsets.items()}
    assert sizes["rec_a"] == sizes["rec_b"] == 4 * 8192 * 5  # four partitions sort apart
    assert sizes["bmax_sup"] == 4 * 128 and sizes["counters"] == 3 * 40 * 4


def test_scan_plan_takes_the_whole_sort_tile():
    """At L = 109 a staging record and its sort key are 450 bytes: 512 of
    them fill the tile's 230,400 bytes, the most a scan CTA takes; the
    merge's rows go to global scratch, one plane a warp of the grid."""
    plan = kernels.scan_plan(2, 4096, 1, 1, 109, 1, 1024, 32, 16, n_sms=132)
    assert plan.tile == 512 and plan.smem == kernels.SCAN_SMEM == 230_400
    assert plan.n2pad == 8192 and plan.offsets["rec_b"][1] == 8192 * 111
    assert not plan.rows_in_smem
    assert plan.offsets["rows"][1] == min(plan.U, 132 * 16) * 64 * 111
    assert plan.overlap == (32, 1)  # 32 readers an item: the codes are compared in memory, any L


def test_scan_plan_past_112_lanes_and_many_slots():
    """L = 128 (keys of 512 bytes) with 100 reads and 130 writes: K2's
    overlap items slice the 130 write slots 16 ways (its codes are compared
    in memory, so no slot count is refused), the merge's rows are in global
    scratch."""
    plan = kernels.scan_plan(1, 64, 100, 130, 128, 4, 1024, 32, 16, n_sms=132)
    assert plan.overlap == (1, 16)
    assert not plan.rows_in_smem and plan.offsets["rows"][1] == min(plan.U, 132 * 16) * 64 * 130
    assert plan.U == 4 * min(2 * 64 * 130, 1024)


@pytest.mark.parametrize("T,KR,KW,L,want", [
    (8, 1, 2048, 8, (1, 256)),  # a bulk load's batch: 8 (reader, word) pairs, its 2048 slots in 256 slices
    (64, 8, 1, 8, (1, 1)),  # the commit path's widest: 96 pairs, a reader an item
    (100, 1, 1, 3, (1, 1)),  # 208 pairs, a reader an item
    (2560, 1, 1, 3, (32, 1)),  # 103,680 pairs: 32 readers an item still give every warp one
])
def test_scan_plan_tiles_no_wider_than_the_batch(T, KR, KW, L, want):
    """K2's overlap items (R readers, NS write-slot slices) no larger than
    the batch leaves work for every warp of the grid."""
    assert kernels.scan_plan(1, T, KR, KW, L, 1, 1024, 32, 16, n_sms=132).overlap == want


def test_scan_plan_at_the_transaction_limit():
    plan = kernels.scan_plan(1, kernels.MAX_TXNS, 1, 1, 3, 1, 1024, 32, 16, n_sms=132)
    assert plan.offsets["pt"][1] * 4 == 512 << 20  # K2's bitset: 512 MiB
    assert plan.n2pad == 1 << 17 and plan.tile == 1024  # staging's merge passes
    for bad in (dict(T=kernels.MAX_TXNS + 1), dict(S2=33), dict(B=1000)):
        args = dict(G=1, T=64, KR=1, KW=1, L=3, P=1, B=1024, S=32, S2=16, n_sms=132)
        args.update(bad)
        with pytest.raises(ValueError):
            kernels.scan_plan(**args)
