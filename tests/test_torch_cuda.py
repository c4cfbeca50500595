"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on the card, with exact equality (integer and bool outputs).

Needs an NVIDIA card: every test is marked ``cuda`` and skips without one.
Imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import random

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.conflict import grid as G
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict import sharded as SH
from foundationdb_tpu_torch.conflict import torch_backend as TB
from foundationdb_tpu_torch.conflict.api import CommitTransaction
from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet
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
