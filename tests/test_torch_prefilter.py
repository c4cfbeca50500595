"""The port's proxy conflict pre-filter (foundationdb_tpu_torch/conflict/
prefilter.py) held against the JAX package's: seeded sequences of resolver
feedback, checks, floor advances, bucket and wide-list eviction and resets
give the same answer to every check, the same summary (buckets in LRU
order, their entries and ceilings, the wide list, floor and max version)
after every step, and the same counters at the end. The tolerance is
exact. Each check is also held to the exact answer over everything fed
above the floor: the filter may miss a conflict, never invent one."""

import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict.prefilter import ConflictPrefilter as JPrefilter
from foundationdb_tpu.conflict.prefilter import _strinc as j_strinc
from foundationdb_tpu.runtime.knobs import Knobs as JKnobs
from foundationdb_tpu_torch.conflict.prefilter import ConflictPrefilter, _strinc
from foundationdb_tpu_torch.runtime.knobs import Knobs

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


def test_strinc_equals_the_jax_package():
    for p in (b"a", b"ab", b"a\xff", b"\xff\xff", b"\x00", b"z\xff\xff", b""):
        assert _strinc(p) == j_strinc(p)


def _key(rs, hot):
    """Keys over a few hot prefixes and a cold spread, 1-6 bytes."""
    if rs.rand() < hot:
        return b"h%d/" % rs.randint(3) + bytes(rs.randint(0, 256, rs.randint(0, 3)).astype(np.uint8))
    return bytes(rs.randint(0, 256, rs.randint(1, 6)).astype(np.uint8))


def _range(rs, hot):
    a, b = sorted((_key(rs, hot), _key(rs, hot)))
    if rs.rand() < 0.6 or a == b:
        b = a + b"\x00"  # a point range, as most conflict ranges are
    return a, b


def _ops(seed, n=600, hot=0.7):
    rs = np.random.RandomState(seed)
    ops, v = [], 0
    for _ in range(n):
        k = rs.choice(["feed", "check", "check", "floor", "reset"], p=[0.4, 0.35, 0.15, 0.08, 0.02])
        if k == "feed":
            batch = []
            for _ in range(rs.randint(1, 4)):
                v += int(rs.randint(1, 50))
                batch.append((v, [_range(rs, hot) for _ in range(rs.randint(0, 5))]))
            ops.append(("feed", batch, int(rs.choice([0, 0, 0, max(v - 300, 0)]))))
        elif k == "check":
            ops.append(("check", int(rs.randint(max(v - 400, 0), v + 2)),
                        [_range(rs, hot) for _ in range(rs.randint(0, 4))]))
        elif k == "floor":
            ops.append(("floor", int(rs.randint(max(v - 500, 0), v + 1))))
        else:
            ops.append(("reset", int(rs.randint(0, v + 1))))
    return ops


def _state(pf):
    return (
        [(p, list(b.entries), b.ceiling, b.touched) for p, b in pf.buckets.items()],
        list(pf.wide), pf.floor, pf.max_version,
    )


def _run(cls, knobs, ops):
    pf = cls(knobs, "p0")
    fed = []  # every (begin, end, version) above the floor: the exact answer
    trace = []
    for op in ops:
        if op[0] == "feed":
            trace.append(pf.feed(op[1], op[2]))
            fed += [(b, e, v) for v, rs in op[1] for b, e in rs]
        elif op[0] == "check":
            got = pf.check(op[1], op[2])
            exact = any(v > op[1] and v > pf.floor and b < re_ and rb < e
                        for b, e, v in fed for rb, re_ in op[2])
            assert not got or exact, "the filter rejected a transaction the resolver commits"
            trace.append((got, exact))
        elif op[0] == "floor":
            pf.note_floor(op[1])
        else:
            pf.reset(op[1])
            fed = []
        trace.append(_state(pf))
    return trace, pf.stats.snapshot()


KNOBS = [
    {},
    {"PREFILTER_PREFIX_LEN": 2, "PREFILTER_BUCKET_ENTRIES": 3, "PREFILTER_MAX_BUCKETS": 4,
     "PREFILTER_WIDE_RANGES": 2},
    {"PREFILTER_PREFIX_LEN": 1, "PREFILTER_BUCKET_ENTRIES": 64, "PREFILTER_MAX_BUCKETS": 2,
     "PREFILTER_WIDE_RANGES": 16},
]


@pytest.mark.parametrize("knob_kw", KNOBS, ids=["default", "tiny", "one-byte-prefix"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefilter_sequence_equals_the_jax_package(seed, knob_kw):
    ops = _ops(seed)
    port, port_stats = _run(ConflictPrefilter, Knobs(**knob_kw), ops)
    ref, ref_stats = _run(JPrefilter, JKnobs(**knob_kw), ops)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, f"step {i} ({ops[min(i, len(ops) - 1)][0]}) differs"
    assert port_stats == ref_stats
    hits = [t for t in port if isinstance(t, tuple) and len(t) == 2 and t[0] is True]
    assert hits, "no check was rejected: the sequence does not reach the filter's answer"
    if knob_kw:  # the small summaries forget: evictions and decay ran
        assert port_stats["bucketsEvicted"] > 0 or port_stats["rangesDecayed"] > 0
