"""The PyTorch port's key codes and lane convention, held against the JAX
package's conflict/keys.py with exact equality."""

import random

import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict import keys as JK
from foundationdb_tpu_torch.conflict import keys as TK
from foundationdb_tpu_torch.device import (
    SENTINEL,
    lanes_to_numpy,
    lanes_to_torch,
    ordered,
)

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


def _fuzz_keys(seed, n=400):
    rnd = random.Random(seed)
    alphabet = [0, 1, 0x7F, 0x80, 0xFE, 0xFF] + list(range(0x30, 0x3A))
    keys = [b"", b"\x00", b"\xff" * 40, b"p" * 31, b"p" * 32, b"p" * 31 + b"z"]
    for _ in range(n):
        ln = rnd.choice([rnd.randrange(0, 8), rnd.randrange(0, 50)])
        keys.append(bytes(rnd.choice(alphabet) for _ in range(ln)))
    return keys


@pytest.mark.parametrize("width", [8, 12, 32])
@pytest.mark.parametrize("round_up", [False, True])
def test_encode_keys_matches_jax(width, round_up):
    keys = _fuzz_keys(width * 2 + round_up)
    want = JK.encode_keys(keys, width, round_up=round_up)
    got = TK.encode_keys(keys, width, round_up=round_up)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("width", [8, 12, 32])
def test_sentinel_and_lanes_match_jax(width):
    np.testing.assert_array_equal(JK.max_sentinel(width), TK.max_sentinel(width))
    assert TK.lanes_for_width(width) == JK.lanes_for_width(width)
    # the all-0xFF key encodes (rounded up) to the sentinel itself
    np.testing.assert_array_equal(
        TK.encode_keys([b"\xff" * 40], width, round_up=True)[0], TK.max_sentinel(width)
    )
    with pytest.raises(ValueError):
        TK.lanes_for_width(width + 2)


def test_lane_view_round_trips_and_keeps_unsigned_order():
    codes = TK.encode_keys(_fuzz_keys(99), 12)
    t = lanes_to_torch(codes)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(lanes_to_numpy(t), codes)
    # the sentinel is -1 in the int32 view
    assert int(lanes_to_torch(TK.max_sentinel(12))[0]) == SENTINEL
    # ordered() maps uint32 order onto signed int32 order, lane by lane
    for lane in range(codes.shape[1]):
        want = np.argsort(codes[:, lane], kind="stable")
        got = torch.sort(ordered(t[:, lane]), stable=True).indices.numpy()
        np.testing.assert_array_equal(want, got)
