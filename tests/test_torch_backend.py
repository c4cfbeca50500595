"""The PyTorch port's backend (TorchConflictSet on the CPU) held against the
JAX package's TpuConflictSet and against the port's own oracle: the
tests/test_conflict_tpu.py battery, three ways, with identical verdicts."""

import random

import pytest
import torch

from foundationdb_tpu.conflict.api import CommitTransaction as JTxn
from foundationdb_tpu.conflict.tpu_backend import TpuConflictSet
from foundationdb_tpu.conflict.tpu_backend import KernelMetrics as JKernelMetrics
from foundationdb_tpu_torch.conflict import torch_backend as TB
from foundationdb_tpu_torch.conflict.api import CommitTransaction, Verdict, new_conflict_set
from foundationdb_tpu_torch.conflict.errors import StaleEncodingError

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

END = b"\xff" * 40


def _torch(**kw):
    return new_conflict_set("torch", device="cpu", **kw)


def _jtxs(txs):
    return [
        JTxn(t.read_snapshot, list(t.read_conflict_ranges), list(t.write_conflict_ranges))
        for t in txs
    ]


class Three:
    """The port, the JAX backend and the port's oracle, fed the same
    batches; every call asserts identical verdicts."""

    def __init__(self, capacity=1 << 8, key_width=32):
        self.port = _torch(capacity=capacity, key_width=key_width)
        self.jax = TpuConflictSet(capacity=capacity, key_width=key_width)
        self.oracle = new_conflict_set("oracle")

    def batch(self, txs, now, oldest):
        got = self.port.detect_batch(txs, now, oldest)
        want_j = [Verdict(int(v)) for v in self.jax.detect_batch(_jtxs(txs), now, oldest)]
        want_o = self.oracle.detect_batch(txs, now, oldest)
        assert got == want_o, (got, want_o)
        assert got == want_j, (got, want_j)
        return got


def _random_range(rnd, keyspace):
    a = rnd.randrange(keyspace)
    return (b"k%08d" % a, b"k%08d" % (a + 1 + rnd.randrange(10)))


def _random_batch(rnd, keyspace, n_txns, snap_lo, snap_hi):
    txs = []
    for _ in range(n_txns):
        tr = CommitTransaction(read_snapshot=rnd.randrange(snap_lo, snap_hi + 1))
        for _ in range(rnd.randrange(0, 3)):
            tr.read_conflict_ranges.append(_random_range(rnd, keyspace))
        for _ in range(rnd.randrange(0, 3)):
            tr.write_conflict_ranges.append(_random_range(rnd, keyspace))
        txs.append(tr)
    return txs


def _run_differential(seed, batches, keyspace, n_txns, capacity=1 << 8):
    rnd = random.Random(seed)
    three = Three(capacity=capacity)
    version = 100
    seen = set()
    for _ in range(batches):
        oldest = max(0, version - 40)
        txs = _random_batch(rnd, keyspace, n_txns, max(0, version - 60), version)
        seen.update(three.batch(txs, version + 10, oldest))
        version += 10
    return three, seen


@pytest.mark.parametrize(
    "seed,batches,keyspace,n_txns,capacity",
    [(s, 25, 30, 12, 1 << 8) for s in range(4)]  # high contention
    + [(s + 100, 10, 100000, 16, 1 << 8) for s in range(2)]  # low contention
    + [(7, 20, 500, 10, 16)],  # growth from tiny capacity
)
def test_differential_three_ways(seed, batches, keyspace, n_txns, capacity):
    _run_differential(seed, batches, keyspace, n_txns, capacity)


def test_history_outgrowing_tiny_capacity_grows_the_grid():
    """No GC horizon: ~2K live boundaries pile into a 256-slot grid, so
    the backend must grow (replay ladder and proactive reshards) exactly
    as the JAX backend does."""
    rnd = random.Random(8)
    three = Three(capacity=16)
    for i in range(12):
        three.batch(_random_batch(rnd, 100000, 40, 0, 100 + i), 110 + i, 0)
    snap = three.port.metrics.snapshot()
    assert snap["capacityGrowths"] > 0
    assert three.port._B == three.jax._B


def test_verdict_mix_under_contention():
    _, seen = _run_differential(3, 30, 30, 12)
    assert seen == {Verdict.COMMITTED, Verdict.CONFLICT, Verdict.TOO_OLD}


def test_point_and_edge_semantics():
    three = Three(capacity=1 << 6)
    t0 = CommitTransaction(0, [], [(b"k", b"k\x00")])
    assert three.batch([t0], 10, 0) == [Verdict.COMMITTED]
    r_hit = CommitTransaction(5, [(b"k", b"k\x00")], [])
    r_miss = CommitTransaction(5, [(b"k\x00", b"k\x00\x00")], [])
    assert three.batch([r_hit, r_miss], 11, 0) == [Verdict.CONFLICT, Verdict.COMMITTED]
    weird = CommitTransaction(5, [(b"z", b"a")], [(b"q", b"q")])
    assert three.batch([weird], 12, 0) == [Verdict.COMMITTED]
    c0 = CommitTransaction(12, [], [(b"a", b"b")])
    c1 = CommitTransaction(12, [(b"a", b"b")], [(b"b", b"c")])
    c2 = CommitTransaction(12, [(b"b", b"c")], [])
    assert three.batch([c0, c1, c2], 13, 0) == [
        Verdict.COMMITTED,
        Verdict.CONFLICT,
        Verdict.COMMITTED,
    ]


def test_clear_resets_history():
    cs = _torch(capacity=1 << 6)
    cs.detect_batch([CommitTransaction(0, [], [(b"a", b"b")])], 10, 0)
    cs.clear(20)
    out = cs.detect_batch([CommitTransaction(25, [(b"a", b"b")], [])], 30, 20)
    assert out == [Verdict.COMMITTED]


def test_detect_many_matches_sequential():
    rnd = random.Random(11)
    seq = _torch(capacity=1 << 8)
    piped = _torch(capacity=1 << 8)
    jax_piped = TpuConflictSet(capacity=1 << 8)
    version = 100
    work, expected = [], []
    for _ in range(8):
        oldest = max(0, version - 40)
        txs = _random_batch(rnd, 40, 10, max(0, version - 60), version)
        work.append((txs, version + 10, oldest))
        expected.append(seq.detect_batch(txs, version + 10, oldest))
        version += 10
    assert piped.detect_many(work) == expected
    jwork = [(_jtxs(t), n, o) for t, n, o in work]
    assert [[Verdict(int(v)) for v in vs] for vs in jax_piped.detect_many(jwork)] == expected


def test_long_key_point_write_not_dropped():
    k = b"p" * 40  # longer than the 31-byte exact window
    three = Three(capacity=1 << 6)
    three.batch([CommitTransaction(0, [], [(k, k + b"\x00")])], 10, 0)
    assert three.batch([CommitTransaction(5, [(k, k + b"\x00")], [])], 11, 0) == [
        Verdict.CONFLICT
    ]


def test_pre_encoded_too_old_tracks_horizon():
    cs = _torch(capacity=1 << 8)
    stale = cs.encode([CommitTransaction(5, [(b"a", b"b")], [])])
    filler = cs.encode([CommitTransaction(55, [], [(b"x", b"y")])])
    outs = cs.detect_many_encoded([(filler, 60, 50), (stale, 100, 50)])
    assert outs[1] == [Verdict.TOO_OLD]


def test_stale_encoding_after_rebase_raises():
    cs = _torch(capacity=1 << 8)
    enc = cs.encode([CommitTransaction(5, [(b"a", b"b")], [])])
    cs.clear(10)  # moves the version base: encodings are now stale
    with pytest.raises(StaleEncodingError):
        cs.detect_many_encoded([(enc, 20, 10)])


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_encoding_made_before_a_rebase_is_carried_across_it(backend):
    """A payload encoded before the int32 rebase dispatches after it with
    the verdicts of a fresh encoding and of the oracle (exact equality);
    one encoded before a ``clear`` stays stale."""
    kw = {"n_parts": 4} if backend == "torch_mesh" else {}
    base = (1 << 30) - 40
    rnd = random.Random(5)
    batches = [_random_batch(rnd, 60, 24, base + 10 * i - 30, base + 10 * i) for i in range(6)]
    carried = new_conflict_set(backend, device="cpu", capacity=1 << 8, **kw)
    fresh = new_conflict_set(backend, device="cpu", capacity=1 << 8, **kw)
    oracle = new_conflict_set("oracle")
    for i, txs in enumerate(batches):
        now, old = base + 10 * i + 10, base + 10 * i - 30
        early = carried.encode(txs)  # before this batch's prepare rebases
        carried.prepare(now)
        fresh.prepare(now)
        got = carried.detect_many_encoded([(early, now, old)])[0]
        assert got == fresh.detect_many_encoded([(fresh.encode(txs), now, old)])[0]
        assert got == oracle.detect_batch(txs, now, old)
    assert carried.metrics.snapshot()["rebases"] == 1
    stale = carried.encode(batches[0])
    carried.clear(base + 100)
    with pytest.raises(StaleEncodingError):
        carried.detect_many_encoded([(stale, base + 110, 0)])


def test_hot_key_batch_exceeding_slot_capacity():
    three = Three(capacity=1 << 8)
    point = [(b"counter", b"counter\x00")]
    three.batch([CommitTransaction(0, [], list(point)) for _ in range(40)], 10, 0)
    three.batch([CommitTransaction(5, list(point), list(point)) for _ in range(40)], 20, 0)


def test_clear_to_end_of_keyspace_boundary():
    three = Three(capacity=1 << 6)
    batches = [
        [CommitTransaction(0, [], [(b"m", END)])],
        [CommitTransaction(5, [(b"z", END)], [])],
        [CommitTransaction(12, [(b"a", b"b")], [(b"q", b"r")])],
        [CommitTransaction(12, [(b"n", END)], [])],
    ]
    for v, txs in enumerate(batches, start=10):
        three.batch(txs, v, 0)


def test_many_hot_writes_to_sentinel_key():
    three = Three(capacity=1 << 6)
    hot = [CommitTransaction(0, [], [(b"h%02d" % i, END)]) for i in range(20)]
    three.batch(hot, 10, 0)
    three.batch([CommitTransaction(3, [(b"h05", b"h06")], [])], 11, 0)


def _mk_batch(rnd, n_txns, keyspace, snap):
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


def test_reshard_device_mid_run_keeps_verdict_parity():
    rnd = random.Random(9)
    three = Three(capacity=1 << 10, key_width=8)
    for i in range(20):
        three.batch(_mk_batch(rnd, 30, 2000, i), i + 30, max(i - 8, 0))
        if i % 5 == 4:
            three.port._reshard(three.port._state)
            three.jax._reshard(three.jax._state)
    assert three.port.metrics.snapshot()["reshardsDevice"] >= 4


def test_append_workload_floods_one_gap_and_recovers():
    three = Three(capacity=256, key_width=8)

    def batch(keys, snap):
        return [CommitTransaction(snap, [], [(k, k + b"\x00")]) for k in keys]

    S = three.port._S
    b1 = batch([b"a%02d" % i for i in range(20)], 0)
    b2 = batch([b"z%02d" % i for i in range(2 * S)], 1)
    b3 = batch([b"z%02d" % i for i in range(2 * S)], 1)
    b3[0].read_conflict_ranges = [(b"z00", b"z99")]
    for i, b in enumerate((b1, b2, b3)):
        three.batch(b, i + 2, 0)
    assert three.port.metrics.snapshot()["overflowReplays"] > 0


def test_forced_rebase_keeps_verdicts(monkeypatch):
    """With the rebase threshold lowered, the port moves its int32 version
    origin several times mid-run; verdicts still match the oracle and the
    JAX backend (which never rebases here)."""
    monkeypatch.setattr(TB, "_INT32_REBASE_THRESHOLD", 60)
    three, _ = _run_differential(2, 20, 30, 12)
    assert three.port.metrics.snapshot()["rebases"] >= 3


def test_async_pipeline_depth_three_matches_sequential():
    rnd = random.Random(17)
    seq = _torch(capacity=1 << 8)
    piped = _torch(capacity=1 << 8)
    version, expected, handles, got = 100, [], [], []
    groups = []
    for _ in range(5):
        grp = []
        for _ in range(3):
            oldest = max(0, version - 40)
            txs = _random_batch(rnd, 40, 10, max(0, version - 60), version)
            grp.append((txs, version + 10, oldest))
            expected.append(seq.detect_batch(txs, version + 10, oldest))
            version += 10
        groups.append(grp)
    for grp in groups:
        if len(handles) >= 3:
            got.extend(handles.pop(0)())
        handles.append(
            piped.detect_many_encoded_async([(piped.encode(t), n, o) for t, n, o in grp])
        )
    for h in handles:
        got.extend(h())
    assert got == expected


def test_metrics_counter_names_match_the_jax_backend():
    assert list(TB.KernelMetrics().collection.counters) == list(
        JKernelMetrics().collection.counters
    )
    assert list(TB.KernelMetrics().collection.samples) == list(
        JKernelMetrics().collection.samples
    )
    snap = _torch().metrics.snapshot()
    assert snap["occupancy"]["bucketCount"] == 1024


class _GrowingKeys(list):
    """A key list that another thread appends to while it is read: each
    pass over it sees one key more than its length said, as when the
    resolver's encode thread adds a key while the device thread reshards
    from the sample."""

    def __iter__(self):
        it = list.__iter__(self)  # a live iterator: it yields the key added next
        self.append(b"k99999")
        return it


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_reshard_reads_a_copy_of_the_key_sample(backend):
    kw = {"n_parts": 2} if backend == "torch_mesh" else {}
    cs = new_conflict_set(backend, device="cpu", capacity=1 << 8, **kw)
    oracle = new_conflict_set("oracle")
    rnd = random.Random(3)
    for now in (10, 20):
        cs._sample.keys = _GrowingKeys(b"k%05d" % i for i in range(50))
        if backend == "torch_mesh" and now == 20:
            cs._host_reshard_partition(0)  # a partition's host reshard reads the sample
        # the first group of one grid reshards from the sample; a read of
        # the live list would outgrow the array sized for it
        txs = _random_batch(rnd, 80, 16, 0, now - 5)
        assert cs.detect_batch(txs, now, 0) == oracle.detect_batch(txs, now, 0)
