"""The port's storage range index (foundationdb_tpu_torch/ops/range_index.py,
over the K5 search of foundationdb_tpu_torch/conflict/grid.py) held against
the JAX package's TpuRangeIndex and searchsorted_lex on the CPU, with exact
equality: insertion points, rows, found flags, range bounds and the codes
array after a delta. Inputs are made from seeded ``random``/numpy.
"""

import bisect
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict.grid import searchsorted_lex as jax_search
from foundationdb_tpu.ops.range_index import TpuRangeIndex
from foundationdb_tpu_torch.conflict import grid as TG
from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

CPU = torch.device("cpu")


def _lanes(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("P", [1, 2, 5, 8, 64, 100])
def test_searchsorted_lex_matches_jax_both_sides(P):
    """Both sides, with duplicate rows, queries equal to rows, below and
    above every row, and the all-0xFF code — including a count of P, where
    the reference's fixed-step search ends at P + 1 for every P >= 2."""
    rnd = np.random.default_rng(P)
    rows = rnd.integers(0, 6, (P, 2), dtype=np.uint32) * np.uint32(0x40000000)
    rows = rows[np.lexsort(rows.T[::-1])]
    q = np.concatenate([
        rows[rnd.integers(0, P, 16)],
        rnd.integers(0, 2**32, (16, 2), dtype=np.uint64).astype(np.uint32),
        np.array([[0, 0], [0xFFFFFFFF, 0xFFFFFFFF], [0xFFFFFFFF, 0]], np.uint32),
    ])
    lo, hi = TG.search_both(_lanes(rows), _lanes(q))
    for side, got in (("left", lo), ("right", hi)):
        want = np.asarray(jax_search(jnp.asarray(rows), jnp.asarray(q), side))
        np.testing.assert_array_equal(want, got.numpy(), err_msg=side)


@pytest.mark.parametrize("P", [*range(1, 71), 128, 256, 1024, 4096])
def test_searchsorted_lex_is_the_count_plus_one_at_p(P):
    """The rule the K5 kernel computes instead of replaying the reference's
    fixed steps: count + (count == P and P >= 2), the count taken by
    ``bisect`` over the byte codes, equals the JAX ``searchsorted_lex`` on
    both sides — duplicate rows, queries equal to rows, below and above
    every row, and the all-0xFF code among them."""
    rnd = np.random.default_rng(1000 + P)
    rows = rnd.integers(0, 4, (P, 2), dtype=np.uint32) * np.uint32(0x55555555)
    rows[:, 0] += np.uint32(1)  # every row above the all-zero query
    rows = rows[np.lexsort(rows.T[::-1])]
    q = np.concatenate([
        rows[rnd.integers(0, P, 8)],
        rnd.integers(0, 2**32, (8, 2), dtype=np.uint64).astype(np.uint32),
        np.array([[0, 0], [0xFFFFFFFF, 0xFFFFFFFF], [rows[-1, 0], 0xFFFFFFFF]], np.uint32),
    ])
    keys = [bytes(k) for k in TG.codes_to_bytes(rows)]
    for side, count in (("left", bisect.bisect_left), ("right", bisect.bisect_right)):
        n = np.array([count(keys, bytes(k)) for k in TG.codes_to_bytes(q)])
        want = n + ((n == P) & (P >= 2))
        got = np.asarray(jax_search(jnp.asarray(rows), jnp.asarray(q), side))
        np.testing.assert_array_equal(got, want, err_msg=side)


def _assert_same_index(tidx, jidx):
    assert tidx.n == jidx.n
    np.testing.assert_array_equal(tidx._codes_np, jidx._codes_np)
    np.testing.assert_array_equal(tidx._codes.numpy().view(np.uint32), np.asarray(jidx._codes))


def _assert_same_lookup(tidx, jidx, queries):
    rows, found = tidx.batch_lookup(queries)
    jrows, jfound = jidx.batch_lookup(queries)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(found, jfound)
    return rows, found


def test_batch_lookup_matches_jax_and_bisect():
    """tests/test_range_index.py:10 — keys of 1-19 random bytes."""
    rnd = random.Random(3)
    keys = sorted({bytes(rnd.randrange(256) for _ in range(rnd.randrange(1, 20)))
                   for _ in range(3000)})
    tidx = TorchRangeIndex(keys, device="cpu")
    jidx = TpuRangeIndex(keys)
    _assert_same_index(tidx, jidx)
    queries = [rnd.choice(keys) if rnd.random() < 0.5
               else bytes(rnd.randrange(256) for _ in range(rnd.randrange(1, 20)))
               for _ in range(500)]
    rows, found = _assert_same_lookup(tidx, jidx, queries)
    for q, r, f in zip(queries, rows, found):
        i = bisect.bisect_left(keys, q)
        assert bool(f) == (i < len(keys) and keys[i] == q)
        if f:
            assert keys[int(r)] == q


def test_batch_range_matches_jax_and_bisect():
    """tests/test_range_index.py:27 — 200 intervals over 2000 keys."""
    rnd = random.Random(4)
    keys = sorted({b"%06d" % rnd.randrange(100000) for _ in range(2000)})
    tidx = TorchRangeIndex(keys, device="cpu")
    jidx = TpuRangeIndex(keys)
    begins, ends = [], []
    for _ in range(200):
        a, b = sorted((b"%06d" % rnd.randrange(100000), b"%06d" % rnd.randrange(100000)))
        begins.append(a)
        ends.append(b)
    los, his = tidx.batch_range(begins, ends)
    jlos, jhis = jidx.batch_range(begins, ends)
    np.testing.assert_array_equal(los, jlos)
    np.testing.assert_array_equal(his, jhis)
    for a, b, lo, hi in zip(begins, ends, los, his):
        assert (int(lo), int(hi)) == (bisect.bisect_left(keys, a), bisect.bisect_left(keys, b))


def test_apply_delta_matches_jax_and_rebuild():
    """tests/test_range_index.py:95 — five delta rounds: the codes array
    equals the reference's delta and a from-scratch rebuild."""
    rnd = random.Random(5)
    keys = sorted({b"%08d" % rnd.randrange(10**8) for _ in range(2000)})
    tidx = TorchRangeIndex(keys, width=16, device="cpu")
    jidx = TpuRangeIndex(keys, width=16)
    live = set(keys)
    for _round in range(5):
        added = {b"%08d" % rnd.randrange(10**8) for _ in range(100)} - live
        removed = set(rnd.sample(sorted(live), 50)) | {b"%08d" % 10**8}  # one missing
        live = (live - removed) | added
        tidx = tidx.apply_delta(sorted(added), sorted(removed))
        jidx = jidx.apply_delta(sorted(added), sorted(removed))
        _assert_same_index(tidx, jidx)
        _assert_same_index(TorchRangeIndex(sorted(live), width=16, device="cpu"), jidx)
        probe = rnd.sample(sorted(live), 40) + [b"%08d" % rnd.randrange(10**8) for _ in range(10)]
        _assert_same_lookup(tidx, jidx, probe)


def test_colliding_long_keys_match_jax():
    """Keys longer than the 32-byte code width share one truncated code:
    lookups, ranges and a delta removing one of them match the reference."""
    p = b"p" * 40
    keys = sorted([p + s for s in (b"a", b"b", b"c", b"d", b"e")] + [b"a", b"q", b"z" * 33])
    tidx = TorchRangeIndex(keys, device="cpu")
    jidx = TpuRangeIndex(keys)
    _assert_same_index(tidx, jidx)
    queries = [p + b"c", p, p + b"zz", b"q", b"z" * 40, b"0"]
    _assert_same_lookup(tidx, jidx, queries)
    begins, ends = [p + b"b", p, b"a"], [p + b"d", p + b"z", b"z" * 40]
    for a, b in zip(tidx.batch_range(begins, ends), jidx.batch_range(begins, ends)):
        np.testing.assert_array_equal(a, b)
    tidx = tidx.apply_delta([], [p + b"c"])
    jidx = jidx.apply_delta([], [p + b"c"])
    _assert_same_index(tidx, jidx)
    assert tidx.n == len(keys) - 1
    _assert_same_lookup(tidx, jidx, queries)


def test_empty_index_and_empty_queries():
    for keys in ([], [b"k"]):
        tidx = TorchRangeIndex(keys, device="cpu")
        jidx = TpuRangeIndex(keys)
        for q in ([], [b"k", b"x"]):
            for a, b in zip(tidx.batch_lookup(q), jidx.batch_lookup(q)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(tidx.batch_range(q, q), jidx.batch_range(q, q)):
                np.testing.assert_array_equal(a, b)
