"""The shapes the card path must take, checked on the CPU: K2's overlap
plan for any read and write slot counts and key widths, the port against
the JAX package on batches with many conflict ranges (K2's wide items, wide
staging) and wide keys, and the batch size the card refuses before any
state changes."""

import random

import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict.api import CommitTransaction as JTxn
from foundationdb_tpu.conflict.mesh_backend import MeshConflictSet
from foundationdb_tpu.conflict.tpu_backend import TpuConflictSet
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict import sharded as TS
from foundationdb_tpu_torch.conflict.api import CommitTransaction, Verdict, new_conflict_set
from foundationdb_tpu_torch.conflict.errors import BatchTooLargeError

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

POW2 = [1 << i for i in range(11)]  # 1 .. 1024


@pytest.mark.parametrize("L", [2, 3, 8, 16, 32, 64, 512])
def test_intra_batch_plan_fits_shared_memory(L):
    """For every power-of-two KR, KW <= 1024 the standalone K2's plan is
    the scan's overlap items on the same card (R readers a power of two up
    to 32, the write slots sliced only for items of one reader), and a
    block of the standalone K2 stages its readers within the default 48 KB
    of shared memory at any key width (none past 16 lanes: those codes are
    compared in memory)."""
    for T in (1, 8, 64, 2500):
        for KR in POW2:
            for KW in POW2:
                R, NS = kernels.intra_batch_plan(T, KR, KW, 132)
                assert (R, NS) == kernels.overlap_items(T, KR, KW, 132 * kernels.SCAN_THREADS // 32)
                assert R in (1, 2, 4, 8, 16, 32)
                assert NS in POW2 and NS <= KW and (NS == 1 or R == 1)
    assert kernels.overlap_smem(8, L) <= 48 * 1024
    assert (kernels.overlap_smem(8, L) == 0) == (L > 16)
    assert kernels.intra_batch_plan(2500, 1, 1, 132) == (32, 1)  # the bench shape
    assert kernels.intra_batch_plan(8, 1, 16, 132) == (1, 16)  # the soak's widest


def _jtxs(txs):
    return [JTxn(t.read_snapshot, list(t.read_conflict_ranges), list(t.write_conflict_ranges)) for t in txs]


def _key(rnd, keyspace, width):
    """A key of width - 8 bytes: its first byte spreads keys over the
    partitions, a common run of width - 20 bytes follows (at width 128 the
    codes first differ past lane 16), then the key number."""
    a = rnd.randrange(keyspace)
    return bytes([a * 256 // keyspace]) + b"/" * (width - 20) + b"key/%07d" % a


def _ranges(rnd, n, keyspace, width):
    out = []
    for _ in range(n):
        a = _key(rnd, keyspace, width)
        out.append((a, a + b"\x00") if rnd.random() < 0.5 else tuple(sorted((a, _key(rnd, keyspace, width)))))
    return out


def _batches(seed, n_batches, n_txns, wide_reads, wide_writes, width=32, keyspace=400):
    """Batches whose first transactions have ``wide_reads`` reads (a
    (lo, hi) range of counts) and ``wide_writes`` writes, the rest one or
    two of each; read snapshots inside the MVCC window."""
    rnd = random.Random(seed)
    out, v = [], 100
    for _ in range(n_batches):
        txs = []
        for t in range(n_txns):
            wide = t < 3
            nr = rnd.randint(*wide_reads) if wide else rnd.randint(0, 2)
            nw = rnd.randint(*wide_writes) if wide else rnd.randint(0, 2)
            txs.append(CommitTransaction(read_snapshot=rnd.randrange(max(0, v - 30), v + 1),
                                         read_conflict_ranges=_ranges(rnd, nr, keyspace, width),
                                         write_conflict_ranges=_ranges(rnd, nw, keyspace, width)))
        rnd.shuffle(txs)
        out.append((txs, v + 10, max(0, v - 40)))
        v += 10
    return out


WIDE = {  # (reads, writes) of the wide transactions
    "65-100 reads": ((65, 100), (1, 3)),
    "33-64 of each": ((33, 64), (33, 64)),
}


@pytest.mark.parametrize("key_width", [32, 128])
@pytest.mark.parametrize("wide", list(WIDE))
def test_torch_matches_jax_on_many_ranges(key_width, wide):
    """A transaction of 65+ reads, or 33+ reads and writes, pads the batch to
    KR = 128 or KR = KW = 64: shapes K2 stages in chunks on the card. The
    port on the CPU equals the JAX backend and the oracle, verdict for
    verdict, at key width 32 (L = 8) and 128 (L = 32)."""
    port = new_conflict_set("torch", device="cpu", key_width=key_width, capacity=1 << 10)
    jax_cs = TpuConflictSet(key_width=key_width, capacity=1 << 10)
    oracle = new_conflict_set("oracle")
    seen = set()
    for txs, now, old in _batches(key_width + len(wide), 3, 48, *WIDE[wide], width=key_width):
        got = port.detect_batch(txs, now, old)
        assert got == [Verdict(int(v)) for v in jax_cs.detect_batch(_jtxs(txs), now, old)]
        assert got == oracle.detect_batch(txs, now, old)
        seen.update(got)
    assert Verdict.COMMITTED in seen and Verdict.CONFLICT in seen


def test_mesh_matches_jax_with_a_wide_write_transaction():
    """One transaction of 129+ write ranges pads KW to 256 over four
    partitions (the staging's rows grow with P·T·KW): the port's mesh
    backend on the CPU equals the JAX MeshConflictSet and the oracle, and
    their stacked states agree."""
    port = new_conflict_set("torch_mesh", device="cpu", key_width=32, capacity=1 << 12, n_parts=4)
    jax_cs = MeshConflictSet(key_width=32, capacity=1 << 12, n_parts=4)
    oracle = new_conflict_set("oracle")
    for txs, now, old in _batches(5, 3, 32, (1, 3), (129, 140)):
        got = port.detect_batch(txs, now, old)
        assert got == [Verdict(int(v)) for v in jax_cs.detect_batch(_jtxs(txs), now, old)]
        assert got == oracle.detect_batch(txs, now, old)
    assert max(len(t.write_conflict_ranges) for t in txs) > 128
    for field, a, b in zip(TS.G.GridState._fields, jax_cs._states, TS.states_to_numpy(port._states)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=field)
    assert all(n > 0 for n in port.metrics.snapshot()["occupancy"]["liveRowsPerPartition"])


def _state_of(cs):
    grid = cs._states if hasattr(cs, "_states") else cs._state
    return [x.clone() for x in grid]


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_oversized_batch_raises_before_any_state_change(backend):
    """On the card a batch of more than kernels.MAX_TXNS transactions is
    refused where the backend takes it, before the version rebase it would
    trigger, the encode, the state, the snapshot or the metrics change.
    Here the CPU backend is given the card's limit; on the CPU it has none."""
    cs = new_conflict_set(backend, device="cpu", key_width=12, capacity=1 << 10)
    assert cs._max_txns is None
    txs, now, old = _batches(1, 1, 16, (1, 2), (1, 2))[0]
    cs.detect_batch(txs, now, old)
    cs._max_txns = kernels.MAX_TXNS
    big = [CommitTransaction(read_snapshot=now, read_conflict_ranges=[(b"a", b"b")],
                             write_conflict_ranges=[(b"c", b"d")])
           for _ in range(kernels.MAX_TXNS + 1)]
    before = (_state_of(cs), cs.metrics.snapshot(), cs.oldest_version, cs._base, cs._base_epoch,
              list(cs._sample.keys))
    # now - base crosses the int32 rebase threshold: a rebase would run
    # first if the size were checked after it
    far = cs._base + (1 << 30) + 5
    with pytest.raises(BatchTooLargeError, match=str(kernels.MAX_TXNS)):
        cs.detect_batch(big, far, now)
    with pytest.raises(BatchTooLargeError, match=str(kernels.MAX_TXNS)):
        cs.encode(big)
    after = (_state_of(cs), cs.metrics.snapshot(), cs.oldest_version, cs._base, cs._base_epoch,
             list(cs._sample.keys))
    for a, b in zip(before[0], after[0]):
        assert torch.equal(a, b)
    assert before[1:] == after[1:]
    assert not cs._inflight
    assert len(cs.detect_batch(txs, now + 10, old)) == len(txs)  # and it goes on resolving
