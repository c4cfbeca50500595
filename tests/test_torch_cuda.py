"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the card, with exact equality (integer and bool outputs).

Needs an NVIDIA card: every test is marked ``cuda`` and skips without one.
Imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import random
import time
import zlib

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.conflict import grid as G
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict import sharded as SH
from foundationdb_tpu_torch.conflict import torch_backend as TB
from foundationdb_tpu_torch.conflict.api import CommitTransaction, new_conflict_set
from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet
from foundationdb_tpu_torch.device import ordered
from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex

pytestmark = pytest.mark.cuda
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


def _work(seed, keyspace=300, n=64, batches=12, maxlen=40, spread=False):
    rnd = random.Random(seed)
    out, v = [], 100

    def key(a):
        # spread: the first byte covers 0-255, so every partition has keys
        return bytes([a * 256 // (keyspace + maxlen)]) + b"%06d" % a if spread else b"k%06d" % a

    for _ in range(batches):
        txs = []
        for _ in range(n):
            tr = CommitTransaction(read_snapshot=rnd.randrange(max(0, v - 60), v + 1))
            for _ in range(rnd.randrange(0, 3)):
                a = rnd.randrange(keyspace)
                tr.read_conflict_ranges.append((key(a), key(a + 1 + rnd.randrange(maxlen))))
            for _ in range(rnd.randrange(0, 3)):
                a = rnd.randrange(keyspace)
                tr.write_conflict_ranges.append((key(a), key(a + 1 + rnd.randrange(maxlen))))
            txs.append(tr)
        out.append((txs, v + 10, max(0, v - 40)))
        v += 10
    return out


def _mid_run(seed):
    """A CPU backend driven mid-run: its state and the next batch."""
    work = _work(seed)
    cs = TB.TorchConflictSet(key_width=12, capacity=1 << 10, device=CPU)
    for txs, now, old in work[:-1]:
        cs.detect_batch(txs, now, old)
    txs, now, old = work[-1]
    batch = TB.encode_transactions(txs, 12, cs._base)
    post = max(cs.oldest_version, old)
    vers = (now - cs._base, max(cs.oldest_version - cs._base, 0), max(post - cs._base, 0))
    return cs._state, batch, vers


def _to(state, dev):
    return G.GridState(*(x.to(dev) for x in state))


def _eq(a, b):
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("seed", range(3))
def test_kernels_match_plain_versions(cuda, seed):
    state, hb, (now, old_pre, old_post) = _mid_run(seed)
    gs, cb = _to(state, cuda), TB.upload(hb, cuda)
    pb = TB.upload(hb, CPU)

    H = G.history_conflicts(gs, cb)
    _eq(H, G.history_conflicts_plain(state, pb))

    H = H | (cb.t_has_reads & (cb.t_snap < old_pre))
    commit = G.intra_batch_commits(cb, H)
    _eq(commit, G.intra_batch_commits_plain(*G._endpoint_ranks(pb), H.cpu()))

    ks, kp = G.merge_writes(G.clone_state(gs), cb, commit, now, old_post)
    ps, pp = G.merge_writes(G.clone_state(state), pb, commit.cpu(), now, old_post)
    _eq(kp, pp)
    for a, b in zip(ks, ps):
        _eq(a, b)

    B, S = state.grid.shape[:2]
    for nb in (B, 2 * B):
        ks, kp = G.reshard_device(gs, nb, S)
        ps, pp = G.reshard_device(state, nb, S)
        _eq(kp, pp)
        for a, b in zip(ks, ps):
            _eq(a, b)

    for a, b in zip(G.rebase(gs, now // 2), G.rebase(state, now // 2)):
        _eq(a, b)
    torch.cuda.synchronize()
    assert all(kernels.launch_counts()[n] > 0 for n in
               ("history", "intra_batch", "merge", "maint_reshard", "maint_rebase"))


def test_backend_on_card_matches_cpu_backend(cuda):
    work = _work(7, batches=20)
    on_card = TB.TorchConflictSet(key_width=12, capacity=1 << 10)
    on_cpu = TB.TorchConflictSet(key_width=12, capacity=1 << 10, device=CPU)
    for txs, now, old in work:
        assert on_card.detect_batch(txs, now, old) == on_cpu.detect_batch(txs, now, old)


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
@pytest.mark.parametrize("key_width", [128, 512, 2048])
def test_backend_on_card_matches_cpu_backend_at_wide_keys(cuda, backend, key_width):
    """Key widths past 64 bytes through a whole backend: codes compared in
    memory (K1, K6 history), the merge's rows in opt-in shared memory
    (L = 32) or global scratch (L > 112), K2's endpoints in global memory
    (L = 512)."""
    work = _work(11, batches=8, spread=backend == "torch_mesh")
    kw = {"n_parts": 4} if backend == "torch_mesh" else {}
    on_card = new_conflict_set(backend, key_width=key_width, capacity=1 << 10, **kw)
    on_cpu = new_conflict_set(backend, key_width=key_width, capacity=1 << 10, device=CPU, **kw)
    for txs, now, old in work:
        assert on_card.detect_batch(txs, now, old) == on_cpu.detect_batch(txs, now, old)


@pytest.mark.parametrize("seed", range(2))
def test_partitioned_kernels_match_plain_versions(cuda, seed):
    """K6 history and merge over 4 partitions, K7 reshard and rebase over
    partitions, against their plain versions on the CPU."""
    work = _work(seed, spread=True)
    cs = TorchMeshConflictSet(key_width=12, capacity=1 << 12, n_parts=4, device=CPU)
    for txs, now, old in work[:-1]:
        cs.detect_batch(txs, now, old)
    states = cs._states
    txs, now, old = work[-1]
    hb = TB.encode_transactions(txs, 12, cs._base)
    now, old_pre = now - cs._base, max(cs.oldest_version - cs._base, 0)
    old_post = max(max(cs.oldest_version, old) - cs._base, 0)
    gs, cb, pb = _to(states, cuda), TB.upload(hb, cuda), TB.upload(hb, CPU)
    bounds = SH.partition_bounds(3, 4, cuda)
    pbounds = SH.partition_bounds(3, 4, CPU)
    kernels.reset_launch_counts()

    H = SH.history_conflicts_sharded(gs, cb, *bounds)
    _eq(H, SH.history_conflicts_sharded(states, pb, *pbounds))
    commit = G.intra_batch_commits(cb, H | (cb.t_has_reads & (cb.t_snap < old_pre)))
    ks, ps = G.clone_state(gs), G.clone_state(states)
    _eq(SH.merge_writes_sharded(ks, cb, commit, now, old_post, *bounds),
        SH.merge_writes_sharded(ps, pb, commit.cpu(), now, old_post, *pbounds))
    for a, b in zip(ks, ps):
        _eq(a, b)

    B, S = states.grid.shape[1:3]
    for nb in (B, 2 * B):
        kr, kp = SH.reshard_parts(gs, nb, S)
        pr, pp = SH.reshard_parts(states, nb, S)
        _eq(kp, pp)
        for a, b in zip(kr, pr):
            _eq(a, b)
    kr, kp = SH.reshard_partition(gs, 2, B, S)
    pr, pp = SH.reshard_partition(states, 2, B, S)
    assert kp == pp
    for a, b in zip(kr, pr):
        _eq(a, b)
    for a, b in zip(SH.rebase_parts(gs, now // 2), SH.rebase_parts(states, now // 2)):
        _eq(a, b)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert all(counts[n] > 0 for n in
               ("history_parts", "merge_parts", "maint_reshard_parts", "maint_rebase_parts"))


def test_search_kernel_matches_plain_version(cuda):
    rnd = np.random.default_rng(0)
    for P in (1, 8, 1000, 1 << 14):
        codes = np.sort(rnd.integers(0, 1 << 40, P, dtype=np.uint64))
        rows = np.stack([codes >> 32, codes & 0xFFFFFFFF], axis=1).astype(np.uint32)
        q = np.concatenate([rows[rnd.integers(0, P, 256)],
                            rnd.integers(0, 300, (256, 2), dtype=np.uint32),
                            np.full((1, 2), 0xFFFFFFFF, np.uint32)])
        rt, qt = (torch.from_numpy(x.view(np.int32)) for x in (rows, q))
        for k, p in zip(G.search_both(rt.to(cuda), qt.to(cuda)), G.search_both(rt, qt)):
            _eq(k, p)


def test_mesh_backend_on_card_matches_cpu_backend(cuda):
    work = _work(9, batches=16, spread=True)
    on_card = TorchMeshConflictSet(key_width=12, capacity=1 << 10, n_parts=4)
    on_cpu = TorchMeshConflictSet(key_width=12, capacity=1 << 10, n_parts=4, device=CPU)
    for txs, now, old in work:
        assert on_card.detect_batch(txs, now, old) == on_cpu.detect_batch(txs, now, old)
    for a, b in zip(on_card._states, on_cpu._states):
        _eq(a, b)


def test_spread_over_one_card_equals_the_one_stack(cuda):
    """The spread mesh over ``[cuda:0] * 4`` (placement, exchange,
    maintenance, replay) gives the one stack's verdicts and, gathered, its
    state tensor for tensor; every dispatched group is one launch of the
    spread's group scan on the card, and no per-batch resolve kernel runs."""
    work = _work(11, batches=16, spread=True)
    kw = dict(key_width=12, capacity=1 << 10, n_parts=4)
    stack = TorchMeshConflictSet(**kw)
    spread = TorchMeshConflictSet(devices=[cuda] * 4, **kw)
    want = [stack.detect_batch(txs, now, old) for txs, now, old in work]
    kernels.reset_launch_counts()
    assert [spread.detect_batch(txs, now, old) for txs, now, old in work] == want
    for a, b in zip(spread._states, stack._states):
        _eq(a, b)
    assert len(spread._spread.entries) == 4 and spread._targets == [torch.device("cuda", 0)]
    counts = kernels.launch_counts()
    dispatched = spread.metrics.snapshot()["deviceDispatches"]
    assert counts["resolve_many_spread"] == dispatched > 0, counts
    for name in ("history_parts", "intra_batch", "stage_parts", "merge_parts"):
        assert counts[name] == 0, (name, counts)
    assert spread.metrics.snapshot()["occupancy"] == stack.metrics.snapshot()["occupancy"]


@pytest.mark.parametrize("rows,n_data", [(4, 2), (2, 4)])
def test_data_spread_over_one_card_equals_the_one_stack(cuda, rows, n_data):
    """The ``part`` × ``data`` spread over ``[[cuda:0] * data] * rows`` (the
    read slots split and padded, every replica merging) gives the one
    stack's verdicts and state; every replica stays equal; a group is one
    launch of the spread's group scan, with no per-batch resolve kernel."""
    work = _work(13, batches=16, spread=True)
    kw = dict(key_width=12, capacity=1 << 10, n_parts=4)
    stack = TorchMeshConflictSet(**kw)
    spread = TorchMeshConflictSet(devices=[[cuda] * n_data for _ in range(rows)], **kw)
    want = [stack.detect_batch(txs, now, old) for txs, now, old in work]
    kernels.reset_launch_counts()
    assert [spread.detect_batch(txs, now, old) for txs, now, old in work] == want
    for a, b in zip(spread._states, stack._states):
        _eq(a, b)
    assert spread._spread.replicas_equal()
    counts = kernels.launch_counts()
    dispatched = spread.metrics.snapshot()["deviceDispatches"]
    assert counts["resolve_many_spread"] == dispatched > 0, counts
    for name in ("history_parts", "intra_batch", "stage_parts", "merge_parts"):
        assert counts[name] == 0, (name, counts)


def test_data_spread_over_every_card_equals_the_one_stack(cuda):
    """One partition a row over pairs of cards (``part`` = cards / 2 ×
    ``data`` = 2): the stack's verdicts and state, every replica equal."""
    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        pytest.skip("needs an even number of cards, more than one")
    devs = [torch.device("cuda", i) for i in range(n)]
    work = _work(14, batches=8, spread=True)
    kw = dict(key_width=12, capacity=1 << 10, n_parts=n // 2)
    stack = TorchMeshConflictSet(device=CPU, **kw)
    spread = TorchMeshConflictSet(devices=[devs[r * 2 : r * 2 + 2] for r in range(n // 2)], **kw)
    for txs, now, old in work:
        assert spread.detect_batch(txs, now, old) == stack.detect_batch(txs, now, old)
    for a, b in zip(spread._states, stack._states):
        _eq(a, b)
    assert spread._spread.replicas_equal() and spread._targets == devs


def test_wrappers_launch_on_their_tensors_card(cuda):
    """K6 history and K5 on the last card, with the current device left at
    card 0, equal their plain versions; the spread over every card equals
    the one stack."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs more than one card")
    last = torch.device("cuda", n - 1)
    assert torch.cuda.current_device() == 0
    work = _work(12, batches=8, spread=True)
    kw = dict(key_width=12, capacity=1 << 10, n_parts=n)
    stack = TorchMeshConflictSet(device=CPU, **kw)
    spread = TorchMeshConflictSet(devices=[torch.device("cuda", i) for i in range(n)], **kw)
    for txs, now, old in work:
        assert spread.detect_batch(txs, now, old) == stack.detect_batch(txs, now, old)
    for a, b in zip(spread._states, stack._states):
        _eq(a, b)
    states = stack._states
    hb = TB.encode_transactions(work[-1][0], 12, stack._base)
    pb = TB.upload(hb, CPU)
    bounds = SH.partition_bounds(3, n, CPU)
    _eq(kernels.history_parts(*_to(states, last), *(b.to(last) for b in bounds), *(
        x.to(last) for x in (pb.rb, pb.re, pb.t_snap))), SH.history_conflicts_sharded_plain(states, pb, *bounds))
    rnd = np.random.default_rng(1)
    codes = np.sort(rnd.integers(0, 1 << 40, 5000, dtype=np.uint64))
    rows = np.stack([codes >> 32, codes & 0xFFFFFFFF], axis=1).astype(np.uint32)
    q = np.concatenate([rows[rnd.integers(0, 5000, 256)], rnd.integers(0, 300, (256, 2), dtype=np.uint32)])
    rt, qt = (torch.from_numpy(x.view(np.int32)) for x in (rows, q))
    for k, p in zip(G.search_both(rt.to(last), qt.to(last)), G.search_both(rt, qt)):
        assert k.device == last
        _eq(k, p)


def test_range_index_on_card_matches_cpu(cuda):
    rnd = random.Random(1)
    keys = sorted({b"%012d" % rnd.randrange(10**9) for _ in range(5000)})
    queries = [rnd.choice(keys) if rnd.random() < 0.7 else b"%012d" % rnd.randrange(10**9)
               for _ in range(1000)]
    on_card, on_cpu = TorchRangeIndex(keys), TorchRangeIndex(keys, device=CPU)
    for a, b in zip(on_card.batch_lookup(queries), on_cpu.batch_lookup(queries)):
        assert (a == b).all()
    for a, b in zip(on_card.batch_range(queries, queries[::-1]), on_cpu.batch_range(queries, queries[::-1])):
        assert (a == b).all()


# ---------------------------------------------------------------------------
# K2 and the K3 staging/merge kernels on synthetic codes, against their
# plain versions: the shapes the backends dispatch and the hard cases

SENT = 0xFFFFFFFF


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _ranges(rnd, shape, L, span=60, width=8):
    """uint32 (begin, end) lanes [*shape, L] over a small keyspace: empty,
    inverted, padding (all-0xFF) slots and ranges ending at the all-0xFF
    code among them."""
    b = rnd.integers(0, span, (*shape, L)).astype(np.uint32)
    b[..., 1:] = rnd.integers(0, 2, (*shape, L - 1))
    e = b.copy()
    e[..., 0] += rnd.integers(0, width, shape).astype(np.uint32)
    inv = rnd.random(shape) < 0.05
    e[inv, 0] = np.maximum(b[inv, 0], 1) - 1
    e[rnd.random(shape) < 0.05] = SENT
    pad = rnd.random(shape) < 0.2
    b[pad] = SENT
    e[pad] = SENT
    return b, e


def _k2_inputs(case):
    rnd = np.random.default_rng(zlib.crc32(repr(case).encode()))
    name, T, KR, KW, L = case
    rb, re = _ranges(rnd, (T, KR), L)
    wb, we = _ranges(rnd, (T, KW), L)
    j = np.arange(T, dtype=np.uint32)
    if name == "chain":  # txn j reads what j - 1 wrote
        wb[:, 0, 0], we[:, 0, 0] = j + 1, j + 2
        rb[:, 0, 0], re[:, 0, 0] = j, j + 1
        wb[:, 0, 1:] = we[:, 0, 1:] = rb[:, 0, 1:] = re[:, 0, 1:] = 0
    elif name == "hot":  # every txn reads and writes one key
        wb[:, 0], we[:, 0], rb[:, 0], re[:, 0] = 7, 7, 7, 7
        we[:, 0, -1] = re[:, 0, -1] = 8
    elif name == "empty_read":  # an empty read range inside an earlier write
        rb[:, 0, 0] = re[:, 0, 0] = 30
        rb[:, 0, 1:] = re[:, 0, 1:] = 0
    elif name == "sparse":  # few live slots, anywhere: overlaps found in any chunk
        for lo, hi in ((rb, re), (wb, we)):
            pad = rnd.random(lo.shape[:2]) < 0.97
            lo[pad] = SENT
            hi[pad] = SENT
    H = rnd.random(T) < 0.1
    return rb, re, wb, we, H


K2_CASES = [
    ("random", 1, 1, 1, 3), ("random", 31, 1, 1, 3), ("random", 32, 1, 1, 3),
    ("random", 33, 3, 2, 3), ("random", 545, 3, 2, 3), ("random", 2560, 1, 1, 3),
    ("random", 300, 2, 2, 8), ("random", 64, 1, 1, 1), ("chain", 545, 1, 1, 3),
    ("hot", 545, 1, 1, 3), ("empty_read", 545, 3, 2, 3), ("random", 4096, 2, 8, 3),
    # the commit path's and the soak's widest batches: overlap items of
    # several readers, and of one reader with the write slots sliced
    ("random", 64, 8, 1, 8), ("random", 8, 1, 16, 8), ("chain", 8, 1, 16, 8),
]


# (KR, KW, L) with many read and write slots, the shapes an older K2 staged
# in chunks; codes of up to 16 lanes are held in registers, wider ones
# (L = 32, 512) compared in memory
K2_CHUNK_SHAPES = [(128, 1, 8), (64, 64, 8), (64, 32, 16), (256, 1, 3), (512, 2, 3), (16, 16, 32)]
K2_CHUNK_CASES = [(name, 300, *shape) for shape in K2_CHUNK_SHAPES
                  for name in ("random", "chain", "hot", "sparse")]
K2_CHUNK_CASES += [("random", 100, 2, 2, 512), ("sparse", 100, 4, 4, 512)]


@pytest.mark.parametrize("case", K2_CHUNK_CASES, ids=lambda c: "-".join(map(str, c)))
def test_intra_batch_kernel_in_chunks_matches_plain_version(cuda, case):
    """K2 at many read and write slots and wide keys (chunks of read and
    write slots, or global memory) against the plain version, which runs
    on the card too at these sizes."""
    rb, re, wb, we, H = _k2_inputs(case)
    T, KR, L = rb.shape
    KW = wb.shape[1]
    codes = [_i32(x).to(cuda) for x in (rb, re, wb, we)]
    Hc = torch.from_numpy(H).to(cuda)
    batch = G.Batch(*codes, torch.zeros(T, dtype=torch.int32, device=cuda), Hc)
    want = G.intra_batch_commits_plain(*G._endpoint_ranks(batch), Hc)
    _eq(kernels.intra_batch(*codes, Hc), want)
    assert 0 < int(want.sum()) < T


@pytest.mark.parametrize("case", K2_CASES, ids=lambda c: "-".join(map(str, c)))
def test_intra_batch_kernel_matches_plain_version(cuda, case):
    rb, re, wb, we, H = _k2_inputs(case)
    T = rb.shape[0]
    cpu = G.Batch(*(_i32(x) for x in (rb, re, wb, we)), torch.zeros(T, dtype=torch.int32),
                  torch.zeros(T, dtype=torch.bool))
    want = G.intra_batch_commits_plain(*G._endpoint_ranks(cpu), torch.from_numpy(H))
    got = kernels.intra_batch(*(x.to(cuda) for x in cpu[:4]), torch.from_numpy(H).to(cuda))
    _eq(got, want)


def test_intra_batch_kernel_at_its_limit(cuda):
    """T = 65536: 64 panels of 1024 rows, each starting with a fold of its
    rows' words below it, and a 512 MiB bitset. A read-after-write chain
    with random H has a known answer: commit[j] = !H[j] and not
    commit[j - 1]."""
    T, L = kernels.MAX_TXNS, 3
    rb, re, wb, we, H = _k2_inputs(("chain", T, 1, 1, L))
    want = np.zeros(T, bool)
    for j in range(T):
        want[j] = not H[j] and not (j and want[j - 1])
    got = kernels.intra_batch(*(_i32(x).to(cuda) for x in (rb, re, wb, we)), torch.from_numpy(H).to(cuda))
    assert np.array_equal(got.cpu().numpy(), want)
    with pytest.raises(ValueError, match="exceeds"):
        kernels.intra_batch(*(_i32(x).to(cuda) for x in (np.zeros((T + 1, 1, L)),) * 4),
                            torch.zeros(T + 1, dtype=torch.bool, device=cuda))


def _pivots(rnd, P, B, L, n_live, span):
    """[P, B, L] sorted pivots: row 0 the zero code, up to n_live - 1
    distinct random codes after it, the rest unused (all-0xFF)."""
    piv = np.full((P, B, L), SENT, np.uint32)
    for p in range(P):
        codes = np.unique(rnd.integers(1, span, n_live))[: n_live - 1]
        piv[p, 0] = 0
        piv[p, 1 : len(codes) + 1, 0] = np.sort(codes)
        piv[p, 1 : len(codes) + 1, 1:] = 0
    return piv


def _plain_stage(wb, we, commit, pivots, S):
    P, B, L = pivots.shape
    codes, evs, okok = G._write_events(wb, we, commit)
    bkt = G._rank(ordered(codes), ordered(pivots), strict=False)
    offs = torch.arange(P, dtype=torch.int32, device=pivots.device)[:, None] * B
    bkt = torch.where(okok, bkt + offs, torch.full_like(bkt, P * B))
    n2w = codes.shape[1]
    return G._stage(codes.reshape(P * n2w, L), evs.reshape(-1), bkt.reshape(-1),
                    P * B, P, S, P * min(n2w, B))


STAGE_CASES = [  # (name, P, T, KW, L, B, live pivots, key span)
    ("bench", 1, 2560, 1, 3, 32768, 20000, 1_000_000),
    ("hot_key", 1, 2500, 1, 3, 64, 40, 60),
    ("overflow", 1, 512, 2, 3, 8, 3, 60),  # > S2 distinct codes in a bucket
    ("clear_end", 1, 300, 2, 3, 64, 30, 60),
    ("partitions", 4, 2560, 1, 3, 8192, 5000, 1_000_000),
    ("wide_lanes", 1, 2560, 1, 8, 4096, 3000, 100_000),  # two sort tiles on one grid
    ("global", 1, 4096, 8, 3, 32768, 20000, 1_000_000),  # 65,536 rows: sorted through global memory
    # 2^23 rows: 4 partitions at MAX_BATCH_TXNS, one txn of 129+ writes
    # (KW = 256); the plain version runs on the card
    ("rows_2^23", 4, 4096, 256, 8, 8192, 5000, 1_000_000),
]


@pytest.mark.parametrize("case", STAGE_CASES, ids=lambda c: c[0])
def test_stage_kernel_matches_plain_version(cuda, case):
    name, P, T, KW, L, B, n_live, span = case
    rnd = np.random.default_rng(len(name) * 1000 + T)
    wb, we = _ranges(rnd, (P, T, KW), L, span=span)
    if name == "hot_key":
        wb[..., :] = 7
        we[..., :] = 7
        we[..., -1] = 8
    if name == "clear_end":
        we[:, ::3] = SENT
    piv = _pivots(rnd, P, B, L, n_live, span)
    commit = torch.from_numpy(rnd.random(T) < 0.8)
    S = 32
    args = (_i32(wb), _i32(we), commit, _i32(piv))
    if name == "rows_2^23":
        args = tuple(a.to(cuda) for a in args)
    want = _plain_stage(*args, S)
    fn = kernels.stage if P == 1 else kernels.stage_parts
    got = G.Staged(*fn(*(a.to(cuda) for a in args), G.staging_slots(S)))
    live = want.tid < P * B
    for a, b in zip(got, want):
        _eq(a, b)
    if name == "overflow":
        assert int(want.max_staged.max()) > G.staging_slots(S)
    if name == "hot_key":
        assert int(live.sum()) == 1


@pytest.mark.parametrize("seed", range(3))
def test_merge_kernel_matches_plain_version(cuda, seed):
    """K3 merge with the floor raise of spanned buckets in the same launch,
    on a mid-run state and its staged rows (wide ranges over a small
    grid, so writes span untouched buckets)."""
    state, hb, (now, old_pre, old_post) = _mid_run(seed)
    pb = TB.upload(hb, CPU)
    H = G.history_conflicts_plain(state, pb) | (pb.t_has_reads & (pb.t_snap < old_pre))
    commit = G.intra_batch_commits_plain(*G._endpoint_ranks(pb), H)
    st = G._stage_writes(state, pb, commit)
    ps = G.clone_state(state)
    want = G.merge_staged(ps, st, now, old_post, 1)
    ks = _to(state, cuda)
    got = kernels.merge(*ks[1:], *(x.to(cuda) for x in st[:4]), now, old_post)
    _eq(got, want)
    for a, b in zip(ks, ps):
        _eq(a, b)
    assert int(G.spanned_buckets(st, state.grid.shape[0]).sum()) > 0  # the floor raise ran


@pytest.mark.parametrize("n_parts", [1, 4])
def test_merge_kernel_raises_a_keyspace_wide_clear(cuda, n_parts):
    """One committed clear over the whole keyspace of each partition, on
    the bench grid (32768 buckets of S = 32 in all): two touched buckets
    per partition, every bucket between them floor-raised by the same
    launch."""
    rnd = np.random.default_rng(n_parts)
    B, S, L = 32768 // n_parts, 32, 3
    piv = torch.from_numpy(_pivots(rnd, n_parts, B, L, B, 1 << 31).view(np.int32))
    state = G.GridState(
        piv.reshape(n_parts * B, L),
        torch.full((n_parts * B, S, L + 1), -1, dtype=torch.int32),
        torch.zeros(n_parts * B, dtype=torch.int32),
        torch.from_numpy(rnd.integers(0, 50, n_parts * B).astype(np.int32)),
        torch.from_numpy(rnd.integers(0, 50, n_parts * B).astype(np.int32)),
    )
    state.grid[..., L] = 0
    wb = np.zeros((n_parts, 1, 1, L), np.uint32)
    we = np.full((n_parts, 1, 1, L), SENT, np.uint32)
    st = _plain_stage(_i32(wb), _i32(we), torch.ones(1, dtype=torch.bool), piv.reshape(n_parts, B, L), S)
    now, oldest = 100, 10
    ps = G.clone_state(state)
    want = G.merge_staged(ps, st, now, oldest, n_parts)
    ks = _to(state, cuda)
    args = (*ks[1:], *(x.to(cuda) for x in st[:4]), now, oldest)
    got = kernels.merge(*args) if n_parts == 1 else kernels.merge_parts(*args, n_parts)
    _eq(got, want)
    for a, b in zip(ks, ps):
        _eq(a, b)
    assert int(G.spanned_buckets(st, n_parts * B, n_parts).sum()) > n_parts * B // 2


# ---------------------------------------------------------------------------
# K1 and K6 history on synthetic states, against their plain versions

SHIFT = 6  # a key number x is the code (x >> SHIFT, 0, ..., 0, x & 63)


def _codes(x, L):
    """uint32 lanes [..., L] of key numbers ``x`` (int64 < 2^38), in key
    order; the middle lanes are 0, so compares run through every lane."""
    out = np.zeros((*x.shape, L), np.uint32)
    out[..., 0] = x >> SHIFT if L > 1 else x
    if L > 1:
        out[..., -1] = x & ((1 << SHIFT) - 1)
    return out


def _history_state(rnd, P, B, S, L):
    """A stacked [P, B, ...] grid with each partition's invariants: pivot 0
    at the partition's low bound, sorted pivots, unused all-0xFF pivots in
    the tail, each used bucket's rows sorted from its pivot, below the next
    one. Key numbers span [0, 2^38) (the first lane over 2^32)."""
    span = 1 << (32 + SHIFT) if L > 1 else 1 << 32
    step = ((1 << 32) // P) * (span >> 32)  # partition p starts at its plo, code for code
    pivots = np.full((P, B, L), SENT, np.uint32)
    grid = np.full((P, B, S, L + 1), SENT, np.uint32)
    grid[..., L] = 0
    count = np.zeros((P, B), np.int32)
    live = []
    for p in range(P):
        nb = B if rnd.random() < 0.5 else int(rnd.integers(max(B // 2, 1), B + 1))
        gap = step // nb
        px = p * step + np.arange(nb, dtype=np.int64) * gap
        px[1:] += rnd.integers(0, max(gap // 4, 1), nb - 1)
        cnt = rnd.integers(1, S + 1, nb)
        offs = np.concatenate([np.zeros((nb, 1), np.int64),
                               np.cumsum(rnd.integers(1, max(gap // (2 * S), 2), (nb, S - 1)), axis=1)], 1)
        rx = px[:, None] + offs
        used = np.arange(S)[None, :] < cnt[:, None]
        pivots[p, :nb] = _codes(px, L)
        grid[p, :nb, :, :L] = np.where(used[..., None], _codes(rx, L), SENT)
        grid[p, :nb, :, L] = np.where(used, rnd.integers(0, 100, (nb, S)), 0)
        count[p, :nb] = cnt
        live.append(rx[used])
    floor = np.where(rnd.random((P, B)) < 0.1, rnd.integers(0, 100, (P, B)), 0).astype(np.int32)
    bmax = np.maximum(grid[..., L].astype(np.int32).max(axis=2), floor)
    return (pivots, grid, count, bmax, floor), np.concatenate(live), span


def _history_reads(rnd, T, KR, L, live, span, gap, wide=False):
    """Read ranges [T, KR, L] of every kind: short, across buckets, across
    whole superblocks, keyspace-wide, ending at the all-0xFF code, empty,
    inverted and padding; endpoints on live rows too (<= vs < at a row)."""
    a = rnd.integers(0, span, (T, KR))
    on_row = rnd.random((T, KR)) < 0.15
    a[on_row] = rnd.choice(live, int(on_row.sum()))
    kind = rnd.random((T, KR))
    length = np.where(kind < 0.4, rnd.integers(1, max(gap, 2), (T, KR)),
                      np.where(kind < 0.6, rnd.integers(gap, 64 * gap + 1, (T, KR)),
                               rnd.integers(64 * gap, span // 4 + 64 * gap + 1, (T, KR))))
    e = np.minimum(a + length, span - 1)
    e_on_row = rnd.random((T, KR)) < 0.15
    e[e_on_row] = np.maximum(rnd.choice(live, int(e_on_row.sum())), a[e_on_row])
    inv = (kind > 0.7) & (kind < 0.75)
    e[inv] = np.maximum(a[inv] - rnd.integers(0, gap + 1, int(inv.sum())), 0)  # inverted, or empty
    rb, re = _codes(a, L), _codes(e, L)
    re[(kind > 0.75) & (kind < 0.8)] = SENT  # ending at the all-0xFF code
    whole = (kind > 0.8) & (kind < 0.85) if not wide else np.ones((T, KR), bool)
    rb[whole], re[whole] = 0, SENT  # keyspace-wide
    pad = (kind > 0.9) & ~whole
    rb[pad], re[pad] = SENT, SENT
    return rb, re


HISTORY_CASES = [  # (name, P, B, S, L, T, KR)
    ("width8", 1, 1024, 32, 2, 2500, 2),
    ("width12_b2", 1, 2, 8, 3, 1, 1),  # B2 = 1: superblocks of one bucket
    ("width12_b8", 1, 8, 32, 3, 31, 3),
    ("width12_b65536", 1, 1 << 16, 32, 3, 2500, 1),
    ("width12_b131072_s8", 1, 1 << 17, 8, 3, 300, 2),  # two doublings past 32768: a fifth step, B1 = 512
    ("width12_b1m_s8", 1, 1 << 20, 8, 3, 300, 2),  # 2^20, as far as growth is checked
    ("width32_s64", 1, 1024, 64, 8, 33, 2),
    ("width64_s8", 1, 1 << 16, 8, 16, 33, 3),
    ("bench_wide", 1, 32768, 32, 3, 2500, 1),  # every read keyspace-wide
    ("parts2", 2, 8, 32, 3, 33, 3),
    ("parts4", 4, 8192, 32, 3, 2500, 1),
    ("parts8_s64", 8, 1024, 64, 8, 31, 2),
    ("parts4_wide", 4, 8192, 32, 3, 2500, 1),
    ("parts40", 40, 8, 8, 3, 33, 3),  # more partitions than lanes: the ballot in chunks of 32
    # wider than 16 lanes: codes compared in memory
    ("width80", 1, 1024, 32, 20, 300, 2),
    ("width128", 1, 4096, 32, 32, 300, 2),
    ("width256_s8", 1, 1 << 16, 8, 64, 300, 2),
    ("parts4_width80", 4, 256, 16, 20, 100, 3),
    ("parts4_width128", 4, 1024, 32, 32, 300, 2),
    ("parts8_width256", 8, 512, 8, 64, 100, 2),
]


def _history_inputs(case):
    name, P, B, S, L, T, KR = case
    rnd = np.random.default_rng(zlib.crc32(repr(case).encode()))
    state, live, span = _history_state(rnd, P, B, S, L)
    rb, re = _history_reads(rnd, T, KR, L, live, span, span // (P * B), wide=name.endswith("wide"))
    snap = rnd.integers(-5, 130, T).astype(np.int32)
    return tuple(_i32(x) for x in state), _i32(rb), _i32(re), torch.from_numpy(snap)


@pytest.mark.parametrize("case", HISTORY_CASES, ids=lambda c: c[0])
def test_history_kernels_match_plain_versions(cuda, case):
    """K1 (one partition) or K6 history (P partitions, reads straddling
    their bounds) against the plain version, bit for bit."""
    state, rb, re, snap = _history_inputs(case)
    P, L = case[1], case[4]
    batch = G.Batch(rb, re, rb, re, snap, torch.ones(len(snap), dtype=torch.bool))
    on_card = [x.to(cuda) for x in (rb, re, snap)]
    if P == 1:
        flat = G.GridState(*(x[0] for x in state))
        want = G.history_conflicts_plain(flat, batch)
        got = kernels.history(*(x.to(cuda) for x in flat), *on_card)
    else:
        bounds = SH.partition_bounds(L, P, CPU)
        want = SH.history_conflicts_sharded_plain(G.GridState(*state), batch, *bounds)
        got = kernels.history_parts(*(x.to(cuda) for x in state), *(x.to(cuda) for x in bounds), *on_card)
    _eq(got, want)
    assert 0 < int(want.sum()) < len(want) or case[0].endswith("wide") or len(want) == 1


# ---------------------------------------------------------------------------
# K5 at the edges of its 16-ary steps and of the shared-memory levels

SEARCH_PS = [1, 2, 15, 16, 17, 257, 1000, 1 << 16, (1 << 20) - 3, 1 << 20]


@pytest.mark.parametrize("L", [2, 3, 8, 16, 20, 32, 64])
@pytest.mark.parametrize("P", SEARCH_PS)
def test_search_kernel_at_the_step_edges(cuda, P, L):
    """K5 against ``searchsorted_lex`` on the card, both sides: duplicate
    rows, a tail of all-0xFF rows (the range index's padding), queries equal
    to rows, between rows, below every row and the all-0xFF query (a count
    of P, which the reference ends at P + 1); Q = 1 and a Q that is not a
    multiple of a block's 16 warps."""
    rnd = np.random.default_rng(P * 17 + L)
    rows = np.zeros((P, L), np.uint32)
    rows[:, 0] = rnd.integers(1, max(P // 2, 2), P)  # duplicates; all above the zero query
    rows[:, -1] = rnd.integers(0, 3, P) * 0x7FFFFFFF if L > 1 else rows[:, 0]
    rows = rows[np.lexsort(rows.T[::-1])]
    if P > 16:
        rows[-(P // 7):] = SENT
    q = np.concatenate([
        rows[rnd.integers(0, P, 3000)],
        rows[rnd.integers(0, P, 1000)] + np.uint32(1),
        rnd.integers(0, 2**32, (100, L), dtype=np.uint64).astype(np.uint32),
        np.zeros((1, L), np.uint32), np.full((1, L), SENT, np.uint32),
    ])
    codes = _i32(rows).to(cuda)
    for qq in (q[-1:], q):
        qt = _i32(qq).to(cuda)
        want = torch.stack([G.searchsorted_lex(codes, qt, "left"), G.searchsorted_lex(codes, qt, "right")])
        _eq(kernels.search(codes, qt), want)
    assert int(want[1, -1]) == P + (P >= 2)


# ---------------------------------------------------------------------------
# K4a / K7a: the reshard from the bucket counts, against the plain versions

RESHARD_CASES = [  # (name, P, B, S, L, n_buckets / B)
    ("bench", 1, 32768, 32, 3, 1),
    ("grow", 1, 1024, 32, 3, 2),
    ("shrink", 1, 1024, 32, 3, 0.5),
    ("bucket0", 1, 1024, 32, 3, 1),  # only bucket 0 live
    ("overflow", 1, 64, 32, 3, 0.25),  # q > n_slots: rows dropped
    ("sentinel_row", 1, 256, 32, 3, 1),  # the last live row's code is all 0xFF
    ("sparse", 1, 1 << 16, 32, 3, 1),  # 1 bucket in 512 live: windows span empty buckets
    ("b1m", 1, 1 << 20, 8, 3, 1),
    ("width8", 1, 1024, 8, 2, 2),
    ("width32", 1, 512, 64, 8, 0.5),
    ("width64", 1, 256, 16, 16, 1),
    ("parts4", 4, 256, 32, 3, 2),
    ("parts4_half", 4, 256, 32, 3, 0.5),
    ("parts4_empty", 4, 8192, 32, 3, 1),  # partition 1 holds no row
]


def _reshard_state(case):
    """A stacked state with each partition's invariants (``_history_state``:
    floors non-zero in 10 % of the buckets), then the case's counts."""
    name, P, B, S, L, _f = case
    rnd = np.random.default_rng(zlib.crc32(repr(case).encode()))
    (pivots, grid, count, bmax, floor), _live, _span = _history_state(rnd, P, B, S, L)
    if name == "bucket0":
        count[:, 1:] = 0
    if name == "sparse":
        count[:, np.arange(B) % 512 != 0] = 0
    if name == "parts4_empty":
        count[1] = 0
    if name == "sentinel_row":
        b = int(np.nonzero(count[0])[0][-1])
        grid[0, b, count[0, b] - 1, :L] = SENT
    return G.GridState(*(_i32(x) if x.dtype == np.uint32 else torch.from_numpy(x)
                         for x in (pivots, grid, count, bmax, floor)))


@pytest.mark.parametrize("case", RESHARD_CASES, ids=lambda c: c[0])
def test_reshard_kernels_match_plain_versions(cuda, case):
    """``maint_reshard_parts`` (and, on one partition, ``maint_reshard``)
    against the plain versions on the same inputs on the card, bit for bit:
    pivots, grid, count, bmax, floor and pressure."""
    name, P, B, S, L, f = case
    states = _to(_reshard_state(case), cuda)
    nb = int(B * f)
    used = (torch.arange(S, device=cuda) < states.count[..., None]).reshape(P, B * S)
    want_state, want_p = SH.reshard_parts_plain(states, used, nb, S)
    got = kernels.maint_reshard_parts(states.grid, states.count, states.floor, nb, S)
    for a, b in zip(got, (*want_state, want_p)):
        _eq(a, b)
    if P == 1:
        one = SH.partition(states, 0)
        got = kernels.maint_reshard(one.grid, one.count, one.floor, nb, S)
        for a, b in zip(got, (*SH.partition(want_state, 0), want_p[0])):
            _eq(a, b)
    live = used.sum(dim=1)
    if name == "overflow":
        assert int(want_p.max()) > S
    if name == "sentinel_row":
        assert int(want_state.count.sum()) == int(live.sum()) - 1
    if name == "parts4_empty":
        assert int(want_p[1]) == 0 and int(want_state.count[1].sum()) == 0
    assert int(states.floor.max()) > 0


# ---------------------------------------------------------------------------
# K4b / K7b: the rebase, against the plain versions

REBASE_CASES = [(f"L{L}_S{S}", L, S, 4099) for L in (1, 2, 3, 7, 8, 16, 32) for S in (1, 7, 32)]
REBASE_CASES += [
    ("bench", 3, 32, 32768),
    ("b1m_s8", 3, 8, 1 << 20),
    ("b1m_s1_l1", 1, 1, 1 << 20),
    ("misaligned", 3, 32, 1000),  # a grid at a 4-byte offset: 4-byte accesses
    ("misaligned_l2", 2, 7, 1001),
]


def _rebase_state(case, P, device):
    """[P, B, S, L + 1] grid of arbitrary words: keys that are not sentinels
    in unused slots too, versions of any sign, counts below 0 and above S
    (the slot mask clamps them), floors of any sign."""
    name, L, S, B = case
    rnd = np.random.default_rng(zlib.crc32(repr(case).encode()) + P)
    words = rnd.integers(0, 2**32, (P, B, S, L + 1), dtype=np.uint64).astype(np.uint32)
    ver = rnd.integers(0, 1 << 30, (P, B, S))
    odd = rnd.random((P, B, S)) < 0.05
    ver[odd] = rnd.integers(-(1 << 31), 1 << 31, int(odd.sum()))
    words[..., L] = ver.astype(np.int64).astype(np.uint32)
    count = rnd.integers(-2, S + 3, (P, B)).astype(np.int32)
    floor = rnd.integers(-(1 << 20), 1 << 30, (P, B)).astype(np.int32)
    grid = _i32(words)
    if name.startswith("misaligned"):
        flat = torch.empty(grid.numel() + 1, dtype=torch.int32, device=device)[1:]
        grid = flat.copy_(grid.reshape(-1).to(device)).view(grid.shape)
        assert grid.data_ptr() % 16
    out = G.GridState(torch.zeros((P, B, L), dtype=torch.int32), grid, torch.from_numpy(count),
                      torch.zeros((P, B), dtype=torch.int32), torch.from_numpy(floor))
    return G.GridState(*(x.to(device) for x in out))


@pytest.mark.parametrize("case", REBASE_CASES, ids=lambda c: c[0])
def test_rebase_kernels_match_plain_versions(cuda, case):
    """``maint_rebase`` on one grid and ``maint_rebase_parts`` on four
    stacked ones against the plain versions on the same inputs, bit for
    bit (grid, bmax, floor), with a delta inside the versions' range and
    one above every non-negative version (negative ones wrap as int32, in
    both); the inputs are left intact."""
    one = G.GridState(*(x[0] for x in _rebase_state(case, 1, cuda)))
    parts = _rebase_state(case, 4, cuda)
    for delta in (12345, (1 << 31) - 1):
        keep = one.grid.clone()
        want = G.rebase_plain(one, delta)
        got = kernels.maint_rebase(one.grid, one.count, one.floor, delta)
        for a, b in zip(got, (want.grid, want.bmax, want.floor)):
            _eq(a, b)
        _eq(one.grid, keep)
        want = SH.rebase_parts_plain(parts, delta)
        got = kernels.maint_rebase_parts(parts.grid, parts.count, parts.floor, delta)
        for a, b in zip(got, (want.grid, want.bmax, want.floor)):
            _eq(a, b)


# ---------------------------------------------------------------------------
# The resolver role on the card against its CPU path


def _resolver_requests(seed, n_batches=12, n_txns=96):
    """Seeded requests for the resolver: versions step by 1000 from just
    below the int32 rebase threshold, snapshots 1-5 batches old under a
    3-batch MVCC window, 0-2 read and write ranges over 400 keys."""
    from foundationdb_tpu_torch.server.interfaces import ResolveBatchRequest, TransactionData

    rnd = random.Random(seed)
    v0 = (1 << 30) - 4000
    reqs = []
    for i in range(n_batches):
        version = v0 + 1000 * (i + 1)

        def ranges():
            out = []
            for _ in range(rnd.randrange(3)):
                a = rnd.randrange(400)
                out.append((b"r%04d" % a, b"r%04d" % (a + 1 + rnd.randrange(6))))
            return out

        tds = [TransactionData(read_snapshot=version - 1000 * rnd.randrange(1, 6),
                               read_conflict_ranges=ranges(), write_conflict_ranges=ranges())
               for _ in range(n_txns)]
        reqs.append(ResolveBatchRequest(prev_version=version - 1000 if i else 0, version=version,
                                        last_receive_version=0, requesting_proxy="px",
                                        transactions=tds))
    return reqs


def _resolve_all(backend, device, seed, threads, injector=None, lose_at=None):
    """All requests spawned at once through ``Resolver`` on a RealLoop;
    returns the verdict lists and the guard's health snapshot."""
    from foundationdb_tpu_torch.runtime.futures import delay, spawn
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.runtime.loop import RealLoop, set_loop
    from foundationdb_tpu_torch.server.resolver import Resolver

    loop = RealLoop(seed)
    set_loop(loop)
    knobs = Knobs(MAX_READ_TRANSACTION_LIFE_VERSIONS=3000, CONFLICT_ENCODE_THREADS=threads,
                  CONFLICT_DISPATCH_DEADLINE=60.0, CONFLICT_FAILOVER_STRIKES=2,
                  CONFLICT_REPROBE_INTERVAL=0.2)
    kw = {"n_parts": 4} if backend == "torch_mesh" else {}
    r = Resolver(knobs=knobs, backend=backend, uid="r0", device=device,
                 fault_injector=injector, **kw)
    try:
        reqs = _resolver_requests(seed)

        async def one(q, i):
            if i == lose_at:
                injector.lose_device(0.3)
            return await r.resolve(q)

        async def chain():  # one batch at a time, a pause after the loss
            out = []
            for i, q in enumerate(reqs):
                out.append(await one(q, i))
                if i == lose_at + 2:
                    await delay(0.5)
            return out

        futs = ([spawn(chain())] if lose_at is not None
                else [spawn(one(q, i)) for i, q in enumerate(reqs)])
        loop.run(until=300.0, stop_when=lambda: all(f.is_ready() for f in futs))
        reps = futs[0].get() if lose_at is not None else [f.get() for f in futs]
        return [list(rep.committed) for rep in reps], r.cs.health_snapshot()
    finally:
        r.close()
        set_loop(None)
        loop.close()


@pytest.mark.parametrize("threads", [0, 1])
@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_resolver_on_the_card_equals_its_cpu_path(cuda, backend, threads):
    got, health = _resolve_all(backend, None, 5, threads)
    want, cpu_health = _resolve_all(backend, "cpu", 5, threads)
    assert got == want
    assert {v for vs in got for v in vs} == {0, 1, 2}
    assert health["state"] == "HEALTHY" and health["failovers"] == health["faults"] == 0
    assert health["backend"] == cpu_health["backend"]


def test_resolver_on_the_card_fails_over_to_native_and_promotes_back(cuda):
    from foundationdb_tpu_torch.conflict.faults import KernelFaultInjector
    from foundationdb_tpu_torch.runtime.rng import DeterministicRandom

    inj = KernelFaultInjector(DeterministicRandom(1), p_dispatch_error=0, p_device_loss=0,
                              p_hang=0, p_compile_stall=0, p_encode_error=0, p_encode_hang=0)
    got, health = _resolve_all("torch", None, 6, 1, injector=inj, lose_at=4)
    want, _h = _resolve_all("torch", "cpu", 6, 1)
    # a failover may abort conservatively, never commit what the CPU path aborts
    assert not [(a, b) for g, w in zip(got, want) for a, b in zip(g, w) if a == 0 and b != 0]
    assert health["failovers"] >= 1 and health["promotions"] >= 1
    assert health["state"] == "HEALTHY" and health["backend"] == "TorchConflictSet"


@pytest.mark.parametrize("chaos", [False, True], ids=["calm", "chaos"])
def test_storage_slice_on_the_card_equals_its_cpu_run(cuda, chaos):
    """The tlog → storage run of tests/test_torch_storage.py with the index
    on the card: every reply, the index codes after each durability epoch,
    the counters and the sim clock equal the CPU run's, and K5 served the
    reads."""
    from storage_slice import run_storage

    kernels.reset_launch_counts()
    got = run_storage("foundationdb_tpu_torch", seed=2, chaos=chaos, device="cuda")
    assert kernels.launch_counts()["search"] > 0
    want = run_storage("foundationdb_tpu_torch", seed=2, chaos=chaos, device="cpu")
    assert got == want
    assert got["counters"]["multiGetIndexKeys"] > 0


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_commit_path_on_the_card_equals_its_cpu_run(cuda, backend):
    """The commit path scenarios of tests/test_torch_commit_path.py in a
    small static Cluster (2 proxies, 2 resolvers, 2 durable storage servers
    with a 0.2 s MVCC window, the resolution balancer on) with the
    resolvers' conflict sets and the storage index on the card: the whole
    transcript (every read value, commit version and error, the roles'
    counters, the sim clock) equals the same seed's run with
    ``device="cpu"``, and the path's kernels launched."""
    from commit_slice import SCENARIOS, run_commit

    kw = dict(seed=6, backend=backend, shape={"n_proxies": 2, "n_resolvers": 2, "n_storage": 2},
              balancer=True,
              knobs={"MAX_READ_TRANSACTION_LIFE_VERSIONS": 200_000, "RESOLUTION_BALANCE_MIN_OPS": 20},
              scenarios=tuple(SCENARIOS))
    if backend == "torch_mesh":
        kw["resolver_kw"] = {"n_parts": 4}
    kernels.reset_launch_counts()
    got = run_commit("foundationdb_tpu_torch", device="cuda", **kw)
    launches = kernels.launch_counts()
    want = run_commit("foundationdb_tpu_torch", device="cpu", **kw)
    assert got == want
    # one card: either backend resolves a group in one launch of the scan
    assert launches["resolve_many"] > 0 and launches["search"] > 0, launches
    assert sum(dict(s)["multiGetIndexKeys"] for s in got["storages"]) > 0


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_empty_and_bulk_load_batches_on_the_card(cuda, backend):
    """The commit path's extremes through the conflict set on the card and
    on the CPU: an idle proxy's empty batch (T = 0: no verdicts, the horizon
    still advances) and a bulk-load transaction of 2000 write ranges, then
    readers of those keys. The verdicts and the horizon are equal."""
    rs = np.random.RandomState(4)
    load = [(b"rw/%08d" % i, b"rw/%08d\x00" % i) for i in range(2000)]
    readers = [CommitTransaction(read_snapshot=int(s), read_conflict_ranges=[load[int(i)]],
                                 write_conflict_ranges=[(b"z%d" % j, b"z%d\x00" % j)])
               for j, (s, i) in enumerate(zip(rs.choice([50, 150], 64), rs.randint(0, 2000, 64)))]
    work = [([], 20, 15),
            ([CommitTransaction(read_snapshot=30, write_conflict_ranges=load)], 100, 15),
            ([], 110, 16),
            (readers, 200, 20)]
    kw = {"n_parts": 4} if backend == "torch_mesh" else {}
    got = []
    for dev in ("cuda", "cpu"):
        cs = new_conflict_set(backend, device=dev, capacity=1 << 12, **kw)
        got.append([[int(v) for v in cs.detect_batch(*w)] for w in work] + [cs.oldest_version])
    assert got[0] == got[1]
    assert got[0][0] == [] and got[0][1] == [0] and got[0][-1] == 20
    assert 0 < sum(got[0][3]) < 64


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_sequential_bulk_load_on_the_card(cuda, monkeypatch, backend):
    """The bulk load's replay ladder on the card: batches of sequential
    keys past every live boundary, repivoted on the device among their own
    endpoints once the key sample is full (the single grid's second step,
    the mesh's after the reference's steps); the verdicts equal the CPU
    run's and the oracle's."""
    from foundationdb_tpu_torch.conflict import torch_backend

    monkeypatch.setattr(torch_backend, "_SAMPLE_CAP", 512)
    kw = {"n_parts": 2} if backend == "torch_mesh" else {}

    def load(cs):
        out = []
        for b in range(8):
            writes = [(b"rw/%08d" % i, b"rw/%08d\x00" % i) for i in range(b * 200, (b + 1) * 200)]
            reads = [(b"rw/%08d" % (b * 200 - 1), b"rw/%08d\x00" % (b * 200 - 1))] if b else []
            txs = [CommitTransaction(read_snapshot=100 * b, write_conflict_ranges=writes),
                   CommitTransaction(read_snapshot=100 * b - 50, read_conflict_ranges=reads)]
            out.append([int(v) for v in cs.detect_batch(txs, 100 * (b + 1), 0)])
        return out

    card = new_conflict_set(backend, device="cuda", capacity=1 << 10, **kw)
    got = load(card)
    assert got == load(new_conflict_set(backend, device="cpu", capacity=1 << 10, **kw))
    assert got == load(new_conflict_set("oracle"))
    assert card.metrics.snapshot()["overflowReplays"] >= 7


# -- the dynamic cluster on the card --------------------------------------------


def _dynamic(scenario, backend, device, **kw):
    from dynamic_slice import run_dynamic

    if backend == "torch_mesh":
        kw["resolver_kw"] = {"n_parts": 4}
    return run_dynamic("foundationdb_tpu_torch", [scenario], backend, device=device, **kw)[scenario]


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_dynamic_cluster_on_the_card_survives_a_master_kill(cuda, backend):
    """tests/dynamic_slice.py's master kill on the card: the whole
    transcript equals the same seed's run with ``device="cpu"``; what the
    clients saw, the recoveries, the shard map and the sim clock equal the
    oracle cluster's; both generations' resolvers launched their kernels."""
    kernels.reset_launch_counts()
    card = _dynamic("kill_master", backend, "cuda")
    launches = kernels.launch_counts()
    assert card == _dynamic("kill_master", backend, "cpu")
    oracle = _dynamic("kill_master", "oracle", "cpu")
    for part in ("client", "recoveries", "shards", "now"):
        assert card[part] == oracle[part], part
    assert max(rc for _a, _i, rc, _rv in card["recoveries"]) >= 2
    assert launches["resolve_many"] > 0 and launches["search"] > 0, launches  # one card: the scan
    want = "TorchMeshConflictSet" if backend == "torch_mesh" else "TorchConflictSet"
    assert card["guards"] and all(g[2:] == ("HEALTHY", 0, 0, want) for g in card["guards"])


def test_rebooted_storage_servers_index_on_the_card_matches_its_plain_version(cuda):
    """tests/dynamic_slice.py's storage reboot on the card: the rebooted
    server rebuilds its range index from the engine it recovered from its
    disk; once the scenario's keys have left the MVCC window for the
    engine, K5's answers over that index equal the plain version's over
    the same codes, and a CPU index over the same keys."""
    from foundationdb_tpu_torch.conflict import grid as G

    from foundationdb_tpu_torch.runtime.futures import delay, spawn

    async def idle():
        await delay(8.0)

    def probe(sim):
        # past the 5 s MVCC window: the scenario's keys are in the engine
        sim.run_until_done(spawn(idle()), limit=60.0)
        ss = next(h.obj for p in sim.processes.values() if getattr(p, "worker", None) is not None
                  and p.alive for h in p.worker.roles.values() if h.kind == "storage")
        idx = ss._range_index
        assert idx is not None and idx._codes.is_cuda
        keys = list(ss.engine._keys)
        queries = keys + [k + b"\x00" for k in keys] + [b"", b"s", b"s99", b"\xff"]
        q = TorchRangeIndex(queries, device="cuda")._codes
        got = kernels.search(idx._codes, q)
        plain = torch.stack([G.searchsorted_lex(idx._codes, q, "left"),
                             G.searchsorted_lex(idx._codes, q, "right")])
        cpu = TorchRangeIndex(keys, device="cpu")
        return (ss.stats.snapshot()["multiGetFallbackKeys"], len(keys), torch.equal(got, plain),
                [list(x) for x in idx.batch_lookup(queries)] == [list(x) for x in cpu.batch_lookup(queries)])

    kernels.reset_launch_counts()
    card = _dynamic("storage_reboot", "torch", "cuda", probe=probe)
    assert kernels.launch_counts()["search"] > 0
    fallback, n_keys, same_as_plain, same_as_cpu = card["probe"]
    assert n_keys >= 25 and same_as_plain and same_as_cpu and fallback == 0
    card.pop("probe")
    assert card == _dynamic("storage_reboot", "torch", "cpu")


def test_destroyed_resolvers_free_their_grids_on_the_card(cuda):
    """A master kill on the card: each old-generation resolver the
    surviving workers destroy takes at least its grid's bytes off the card
    (``torch.cuda.memory_allocated()`` drops by them at the destruction),
    with the collector frozen as ``chip_smoke.py`` freezes it."""
    from test_torch_resolver_close import _grid_tensors, _master_kill

    drops = []

    def measured(h, destroy):
        grid = None
        if h is not None and h.kind == "resolver":
            grid = sum(t.numel() * t.element_size() for t in _grid_tensors(h.obj.cs))
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        destroy()
        torch.cuda.synchronize()
        if grid is not None:
            drops.append((grid, m0 - torch.cuda.memory_allocated()))

    old, master, _new, _sim = _master_kill("torch", freeze=True, device=None, on_destroy=measured)
    assert [o for o in old if o[0] != master] and drops
    for grid, drop in drops:
        assert grid > 0 and drop >= grid, drops


def test_soak_seed_on_the_card_equals_its_cpu_twin(cuda):
    """``tools.soak.run_one`` on the card gives the summary of the same
    seed on the CPU (seed 0 draws ``torch``), and the resolve path and K5
    launched on the card."""
    import gc

    from foundationdb_tpu_torch.runtime.loop import set_loop
    from foundationdb_tpu_torch.tools.soak import run_one

    kernels.reset_launch_counts()
    card = run_one(0, device=None)
    launches = kernels.launch_counts()
    set_loop(None)
    gc.collect()
    assert card == run_one(0, device="cpu")
    set_loop(None)
    assert card["config"]["conflict_backend"] == "torch"
    assert all(launches[k] > 0 for k in ("resolve_many", "search")), launches


def test_bindingtester_streams_on_the_card_equal_the_model(cuda):
    """The bindingtester streams through a ``Cluster`` on the card: the
    same data and stack log as the port's model database, and the
    resolve path launched."""
    import gc
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from foundationdb_tpu_torch.runtime.loop import set_loop

    out = chip_smoke.run_bindings("test", device=None, seeds=range(3), chaos=(3,))
    set_loop(None)
    gc.collect()
    assert out["identical"] == out["streams"] == 5
    assert out["launches"].get("resolve_many", 0) > 0


def test_tcp_inproc_cluster_on_the_card(cuda):
    """``perf --mode tcp-inproc`` on the card at a small size, over loopback
    and sockets: the resolvers stay HEALTHY on the card, the scan and K5
    launch, and K1-K3, the scan and K5 equal their plain versions on the
    widest batch and search."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    out, rows = chip_smoke.run_tcp_inproc("test", device="cuda", n_keys=4000, mix_s=2.0)
    assert {r["max_abs_err"] for r in rows} == {0} and len(rows) == 6
    assert all(out["launches"].get(k, 0) > 0 for k in ("resolve_many", "search"))


# ---------------------------------------------------------------------------
# The group scan (csrc/scan.cu) against the loop of the standalone kernels
# and against the plain loop, on groups built in code space

# (name, G, T, KR, KW, L, P, B): one grid (P = 1) or stacked partitions
SCAN_CASES = [
    ("one_txn", 1, 1, 1, 1, 3, 1, 64),
    ("bench_group", 40, 2500, 1, 1, 3, 1, 32768),
    ("many_small", 40, 33, 1, 1, 3, 1, 1024),
    ("reads_8", 3, 33, 8, 1, 8, 1, 1024),
    ("writes_16", 3, 33, 1, 16, 3, 4, 256),
    ("slots_100_130", 1, 33, 100, 130, 8, 1, 1024),
    ("keys_512_bytes", 3, 33, 1, 1, 128, 1, 256),
    ("bench_parts", 3, 2500, 1, 1, 3, 4, 8192),
    ("commit_path_parts", 3, 2500, 8, 1, 8, 4, 8192),
    ("above_one_tile", 3, 2500, 2, 4, 3, 1, 32768),
    ("staging_overflow_mid", 3, 33, 1, 2, 3, 1, 64),
    ("bucket_overflow_mid", 3, 33, 1, 1, 3, 4, 64),
    ("too_old", 3, 2500, 1, 1, 8, 1, 4096),
    ("txn_limit", 1, kernels.MAX_TXNS, 1, 1, 3, 1, 4096),
    # groups of one at the widest batch shapes of the commit path, the
    # dynamic cluster and the soak, on a resolver's 2^14 / 32 buckets
    ("commit_path_one", 1, 64, 8, 1, 8, 1, 512),
    ("dynamic_cluster_one", 1, 64, 16, 1, 8, 1, 512),
    ("soak_one", 1, 8, 1, 16, 8, 1, 512),
    # K2's overlap items of 2 and 16 readers, and the key widths of the
    # scan's 4- and 16-lane register codes with every lane in use
    ("readers_2", 3, 600, 1, 1, 3, 1, 1024),
    ("readers_16", 2, 1500, 1, 1, 3, 1, 4096),
    ("keys_16_bytes", 3, 100, 2, 2, 4, 1, 256),
    ("keys_64_bytes", 3, 100, 3, 2, 16, 4, 256),
]


def _scan_inputs(case, dev):
    """(state on ``dev`` after a warm-up group through the plain loop,
    bounds or None, the group as a Batch on ``dev``, its version columns)
    of a SCAN_CASES case. Codes are uniform over the first lane (every
    partition and bucket gets rows), ranges a few buckets wide; the
    overflow cases aim the middle batch's writes at one bucket."""
    name, G_, T, KR, KW, L, P, B = case
    rnd = np.random.default_rng(zlib.crc32(name.encode()))
    S = 32
    arrays = SH._sharded_arrays(P, B, S, L)
    width = (1 << 32) // (P * B) * 3
    if P == 1:
        state = G.state_from_numpy(*(a[0] for a in arrays), dev)
        bounds = None
    else:
        state = SH.states_from_numpy(*arrays, dev)
        bounds = SH.partition_bounds(L, P, dev)

    def group(n_groups, v0):
        rb, re = _ranges(rnd, (n_groups, T, KR), L, span=1 << 32, width=width)
        wb, we = _ranges(rnd, (n_groups, T, KW), L, span=1 << 32, width=width)
        if name in ("staging_overflow_mid", "bucket_overflow_mid") and n_groups > 1:
            # one bucket of the first partition: 40 distinct codes in the
            # middle batch (past S2), or 16 in each of the first two (past S)
            lo = int(arrays[0][0, 5, 0])
            wb[:2], we[:2] = SENT, SENT
            k = np.arange(T, dtype=np.uint32)
            if name == "staging_overflow_mid":
                wb[1, :20, 0, 0], we[1, :20, 0, 0] = lo + 2 * k[:20] + 1, lo + 2 * k[:20] + 2
            else:
                for g in range(2):
                    wb[g, :8, 0, 0], we[g, :8, 0, 0] = lo + 4 * k[:8] + 2 * g + 1, lo + 4 * k[:8] + 2 * g + 2
            for x in (wb, we):
                x[:2, :20, 0, 1:] = 0
            rb[:2, :20], re[:2, :20] = SENT, SENT  # read nothing: they commit
        nows = v0 + 10 * np.arange(1, n_groups + 1)
        snap = (nows[:, None] - rnd.integers(5, 60, (n_groups, T))).astype(np.int32)
        has_reads = ((rb != SENT).any(axis=-1).any(axis=-1))
        olds = np.maximum(nows - (30 if name == "too_old" else 200), 0)
        cols = [nows.astype(np.int32), np.r_[0, olds[:-1]].astype(np.int32), olds.astype(np.int32)]
        batch = G.Batch(*(_i32(x).to(dev) for x in (rb, re, wb, we)), torch.from_numpy(snap).to(dev),
                        torch.from_numpy(has_reads).to(dev))
        return batch, cols

    warm, warm_cols = group(min(G_, 3), 100)
    if T == kernels.MAX_TXNS:  # the plain K2's [T, T] matrices: the loop of kernels warms it
        G.resolve_many_loop(state, warm, *warm_cols, bounds)
    else:
        G.resolve_many_plain(state, warm, *warm_cols, bounds)
    batch, cols = group(G_, 100 + 10 * min(G_, 3))
    cols[1][0] = warm_cols[2][-1]
    return state, bounds, batch, cols


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: c[0])
def test_scan_matches_the_loop_of_kernels_and_the_plain_loop(cuda, case):
    """One launch of the scan a group: its verdicts, per-batch pressures,
    group maxima and every state array equal the loop of the standalone
    kernels' and the plain loop's (run on the card; at T = 65,536 the
    standalone K2 stands for the plain one, which is held to it at that
    size by test_intra_batch_kernel_at_its_limit)."""
    name, G_, T, KR, KW, L, P, B = case
    state, bounds, batch, cols = _scan_inputs(case, cuda)
    vers = G.version_rows(*cols, cuda)
    got = G.clone_state(state)
    kernels.reset_launch_counts()
    v, p, gm = kernels.resolve_many(*got, bounds, *batch, vers, G.staging_slots(32))
    assert kernels.launch_counts()["resolve_many"] == 1
    assert v.shape == (G_, T) and p.shape == (G_, P, 2) and gm.shape == (P, 2)
    runs = [G.resolve_many_loop]
    if T < kernels.MAX_TXNS:
        runs.append(G.resolve_many_plain)
    for run in runs:
        want = G.clone_state(state)
        wv, wp = run(want, batch, *cols, bounds)
        _eq(v, wv)
        _eq(p, wp)
        _eq(gm, wp.amax(dim=0))
        for a, b in zip(got, want):
            _eq(a, b)
    S2 = G.staging_slots(32)
    if name == "staging_overflow_mid":
        assert int(p[1, :, 0].max()) > S2 >= int(p[0, :, 0].max())
    if name == "bucket_overflow_mid":
        assert int(p[1, :, 1].max()) > 32 and int(p[:2, :, 0].max()) <= S2
    if name == "too_old":
        assert (v == G.TOO_OLD).any() and (v == G.COMMITTED).any()


@pytest.mark.parametrize("case", [c for c in SCAN_CASES if c[0] in ("bench_parts", "commit_path_one")],
                         ids=lambda c: c[0])
def test_scan_timer_stamps_every_phase_and_leaves_the_results(cuda, case):
    """The per-phase timer: with ``phase_ns`` the launch writes a clock
    stamp at every phase boundary of every batch, in order, and returns
    what the launch without it returns; ``scan_phase_ms`` sums the phases
    to the first stamp's distance from the last."""
    _name, G_, T, KR, KW, L, P, B = case
    state, bounds, batch, cols = _scan_inputs(case, cuda)
    vers = G.version_rows(*cols, cuda)
    S2 = G.staging_slots(32)
    want = G.clone_state(state)
    w = kernels.resolve_many(*want, bounds, *batch, vers, S2)
    got = G.clone_state(state)
    stamps = torch.zeros((G_, len(kernels.SCAN_PHASES) + 1), dtype=torch.int64, device=cuda)
    g = kernels.resolve_many(*got, bounds, *batch, vers, S2, phase_ns=stamps)
    for a, b in zip((*g, *got), (*w, *want)):
        _eq(a, b)
    flat = stamps.cpu().flatten()
    assert (flat > 0).all() and (flat[1:] >= flat[:-1]).all()
    out = kernels.scan_phase_ms(stamps)
    assert out["batches"] == G_
    assert abs(out["total_ms"] - sum((s[-1] - s[0]).item() for s in stamps.cpu()) / 1e6) < 1e-6


@pytest.mark.parametrize("backend", ["torch1", "torch_mesh"])
def test_backends_resolve_a_group_in_one_launch(cuda, backend):
    """Through the backends: every group (and every replay of one) is one
    launch of the scan, and no standalone resolve kernel runs."""
    work = _work(21, batches=12, spread=backend == "torch_mesh")
    kw = {"n_parts": 4} if backend == "torch_mesh" else {}
    on_card = new_conflict_set(backend, key_width=12, capacity=1 << 10, **kw)
    on_cpu = new_conflict_set(backend, key_width=12, capacity=1 << 10, device=CPU, **kw)
    kernels.reset_launch_counts()
    for g in range(0, len(work), 3):
        group = work[g : g + 3]
        assert on_card.detect_many(group) == on_cpu.detect_many(group)
    counts = kernels.launch_counts()
    assert counts["resolve_many"] == on_card.metrics.snapshot()["deviceDispatches"] >= 4
    assert not any(counts[k] for k in ("history", "history_parts", "intra_batch", "stage", "stage_parts",
                                       "merge", "merge_parts")), counts


# --- the spread's group scan: one launch a card ----------------------------

SPREAD_LAYOUTS = [(4, 1), (4, 2)]  # part x data rows on one card: [cuda:0] * 4 and 4 x 2 over [cuda:0] * 8


def _spread_groups(seed):
    """Two groups of spread keys at (T, KR, KW) = (64, 2, 2), base 0: a
    warm-up of 3 random batches, then 4 batches whose second writes 40
    ranges into one bucket (first byte 0x90) of a 16-bucket partition,
    past its staging slots. Each: (stacked host Batch, version columns)."""
    rnd = random.Random(seed)

    def key(i, prefix=None):
        return bytes([i * 256 // 3000 % 256 if prefix is None else prefix]) + b"%06d" % i

    def txns(n, snap):
        out = []
        for _ in range(n):
            a, c = rnd.randrange(3000), rnd.randrange(3000)
            reads = [(key(a), key(a + 1 + rnd.randrange(6)))][: rnd.randrange(0, 2)]
            out.append(CommitTransaction(snap - rnd.randrange(16), reads, [(key(c), key(c + 1 + rnd.randrange(6)))]))
        return out

    run = [CommitTransaction(30, [], [(key(i, 0x90), key(i + 1, 0x90))]) for i in range(40)]
    works = [[(txns(60, 10 + g), 20 + g, 0) for g in range(3)],
             [(txns(60, 25), 40, 0), (run, 41, 0), (txns(60, 27), 42, 1), (txns(60, 30), 43, 2)]]
    out, horizon = [], 0
    for work in works:
        batches, cols = [], [[], [], []]
        for txs, now, old in work:
            batches.append(TB.encode_transactions(txs, 12, 0))
            post = max(horizon, old)
            for c, x in zip(cols, (now, horizon, post)):
                c.append(x)
            horizon = post
        stacked = TB.stack_batches(batches + [TB.sentinel_batch(64, 2, 2, 3)], 3)
        out.append((G.Batch(*(x[:-1] for x in stacked)), [np.asarray(c, np.int32) for c in cols]))
    return out


def _spread_run(spread, stacked, cols, fn, **kw):
    dev = spread.entries[0].device
    batch = TB.upload(stacked, dev)
    reads = None
    if spread.n_data > 1:
        slices = SH.split_reads(batch.rb, batch.re, spread.n_data)
        reads = [slices[e.replica] for e in spread.entries]
    return fn(spread, [batch] * len(spread.entries), *cols, reads, **kw)


@pytest.mark.parametrize("rows,n_data", SPREAD_LAYOUTS, ids=["4x1", "4x2"])
def test_spread_scan_matches_the_loop_of_kernels_and_the_plain_loop(cuda, rows, n_data):
    """One launch of the spread's group scan on the card (every entry of
    ``[cuda:0] * 4`` or of 4 x 2 over ``[cuda:0] * 8``): its verdicts,
    per-batch pressures and every replica's state equal, array by array,
    those of the loop of standalone kernels on the card and of the plain
    loop on the CPU, through a group that overflows a partition's staging;
    no standalone resolve kernel runs on its path."""
    (warm, warm_cols), (group, cols) = _spread_groups(rows * 10 + n_data)
    plain = SH.make_spread(rows, 16, 32, 3, [[CPU] * n_data for _ in range(rows)])
    _spread_run(plain, warm, warm_cols, SH.resolve_many_spread)
    start = SH.gather_to_numpy(plain)
    devices = [[cuda] * n_data for _ in range(rows)]
    got, loop = (SH.spread_from_numpy(*start, devices) for _ in range(2))
    kernels.reset_launch_counts()
    v, p, status = _spread_run(got, group, cols, SH.resolve_many_spread)
    counts = kernels.launch_counts()
    assert status is None and counts["resolve_many_spread"] == 1, counts
    assert not any(counts[k] for k in ("history_parts", "intra_batch", "stage_parts", "merge_parts")), counts
    lv, lp = _spread_run(loop, group, cols, SH.resolve_many_spread_loop)
    pv, pp, _ = _spread_run(plain, group, cols, SH.resolve_many_spread)
    for want_v, want_p, want in ((lv, lp, loop), (pv, pp, plain)):
        _eq(v, want_v)
        _eq(p, want_p)
        for a, b in zip(got.entries, want.entries):
            for x, y in zip(a.states, b.states):
                _eq(x, y)
    assert got.replicas_equal()
    assert int(p[1, :, 0].max()) > G.staging_slots(32)  # the run overflowed staging: the host replays


def _two_logical_cards(cuda):
    """A 4 x 1 spread on the card planned as two cards (entries 0-1 and
    2-3: card ids 0 and 1, both this card), its group and inputs."""
    (warm, warm_cols), (group, cols) = _spread_groups(7)
    plain = SH.make_spread(4, 16, 32, 3, [CPU] * 4)
    _spread_run(plain, warm, warm_cols, SH.resolve_many_spread)
    spread = SH.spread_from_numpy(*SH.gather_to_numpy(plain), [cuda] * 4)
    batch = TB.upload(group, cuda)
    plan = kernels.spread_plan([0, 0, 1, 1], 1, len(cols[0]), batch.rb.shape[1])
    entries = [(*e.states, e.plo, e.phi) for e in spread.entries]
    reads = [(batch.rb, batch.re)] * 4
    vers = G.version_rows(*cols, cuda)
    return spread, plan, entries, reads, tuple(batch), vers, (group, cols)


def test_spread_exchange_gives_up_on_a_missing_card_and_the_card_serves_on(cuda):
    """A two-card plan with only card 0's launch queued: its wait for card
    1's H ends at the bound given, the launch sets its status and leaves,
    ``check_spread_status`` raises the exchange timeout (a kernel fault),
    and the card then serves the next launch."""
    spread, plan, entries, reads, batch, vers, (group, cols) = _two_logical_cards(cuda)
    exchange = kernels.SpreadExchange()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = kernels.spread_launch(plan, 0, entries, reads, batch, vers, G.staging_slots(32), exchange,
                                    exchange.next_epoch(), timeout_s=0.05)
        torch.cuda.synchronize()
        waited = time.perf_counter() - t0
        assert int(out.status) == 1 and 0.05 <= waited < 5.0, waited
        with pytest.raises(kernels.ExchangeTimeoutError):
            kernels.check_spread_status(out.status)
    finally:
        exchange.close()
    fresh = SH.spread_from_numpy(*SH.gather_to_numpy(spread), [cuda] * 4)
    v, p, status = _spread_run(fresh, group, cols, SH.resolve_many_spread)
    torch.cuda.synchronize()
    assert status is None and v.shape == (len(cols[0]), 64)


def test_spread_exchange_between_two_launches_on_one_card(cuda, monkeypatch):
    """The exchange itself, on one card: the two halves of a 4 x 1 spread
    as two cards, each launch on its own stream with half the SMs, so both
    are resident together; they publish and read each other's H through
    the mapped host buffer and give the one launch's verdicts, pressures
    and states, status clear."""
    spread, plan, entries, reads, batch, vers, _ = _two_logical_cards(cuda)
    one = SH.spread_from_numpy(*SH.gather_to_numpy(spread), [cuda] * 4)
    one_plan = kernels.spread_plan([cuda] * 4, 1, vers.shape[1], batch[0].shape[1])
    want = kernels.resolve_many_spread(one_plan, [(*e.states, e.plo, e.phi) for e in one.entries], reads,
                                       [batch], [vers], G.staging_slots(32))[0]
    half = torch.cuda.get_device_properties(cuda).multi_processor_count // 2
    plan_on = kernels._plan_on  # each launch on half the SMs, so both are resident together
    monkeypatch.setattr(kernels, "_plan_on", lambda *a, **kw: plan_on(*a, **kw)._replace(blocks=half))
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    exchange = kernels.SpreadExchange()
    try:
        torch.cuda.synchronize()
        epoch = exchange.next_epoch()
        outs = []
        for c in range(2):
            with torch.cuda.stream(streams[c]):
                outs.append(kernels.spread_launch(plan, c, entries, reads, batch, vers, G.staging_slots(32),
                                                  exchange, epoch, timeout_s=2.0))
        torch.cuda.synchronize()
    finally:
        exchange.close()
    assert [int(o.status) for o in outs] == [0, 0]
    for o in outs:
        _eq(o.verdicts, want.verdicts)
    _eq(torch.cat([o.pressures for o in outs]), want.pressures)
    for a, b in zip(spread.entries, one.entries):
        for x, y in zip(a.states, b.states):
            _eq(x, y)
