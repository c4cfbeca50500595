"""The port's bindings (``foundationdb_tpu_torch/bindings/``) held to the JAX
package's: every case of ``tests/test_bindingtester.py``, run in both
packages on the same seed (the port's static cluster on the CPU, its
resolvers on ``torch``), must give the same instruction stream, the same
logged stack rows and the same final data, byte for byte; and each
package's run must equal its own model database, as the reference case
asks."""

import pytest
import torch

from bindings_slice import DATA_PREFIX, INS_PREFIX, PORT, REFERENCE, RESULT_PREFIX
from bindings_slice import package, run_model, run_real, run_stream

torch.set_num_threads(1)  # the suite runs in several xdist workers


def both(fn, *a, **kw):
    return fn(REFERENCE, *a, **kw), fn(PORT, *a, **kw)


def assert_conformant(ref, port):
    """Stream, data and log equal across the packages, and each package's
    real run equal to its model's."""
    (r_stream, r_data, r_log), (p_stream, p_data, p_log) = ref, port
    assert p_stream == r_stream, "the generators drew different streams"
    assert p_data == r_data, f"final data: port {len(p_data)} rows, reference {len(r_data)}"
    assert p_log == r_log, f"logged stacks: port {len(p_log)} items, reference {len(r_log)}"
    assert (p_data, p_log) == run_model(PORT, p_stream)
    assert (r_data, r_log) == run_model(REFERENCE, r_stream)


@pytest.mark.parametrize("seed", range(50))
def test_conformance_seeded_streams(seed):
    assert_conformant(*both(run_real, seed, 1000))


def test_conformance_long_stream():
    """One 1K-op stream, multi-proxy multi-resolver cluster."""
    assert_conformant(*both(run_real, 99, 1000, n_proxies=2, n_resolvers=2))


def test_conformance_commit_path_knobs_both_ways():
    """The commit-path fast paths (compiled wire codec, slab-settled
    futures, pipelined tlog fsync) forced on and off in each package: four
    runs of one stream, one result."""
    results = {}
    for pkg in (REFERENCE, PORT):
        P = package(pkg)
        for legacy in (False, True):
            P.wire.set_compiled_codec(not legacy)
            P.futures.set_slab_settle(not legacy)
            try:
                results[pkg, legacy] = run_real(pkg, 7, 600, knob_overrides=dict(
                    WIRE_COMPILED_CODEC=not legacy, FUTURE_SLAB_SETTLE=not legacy,
                    TLOG_FSYNC_PIPELINE=not legacy))
            finally:
                P.wire.set_compiled_codec(True)
                P.futures.set_slab_settle(True)
    first = results[REFERENCE, False]
    assert all(r == first for r in results.values())
    assert_conformant(results[REFERENCE, True], results[PORT, True])


def test_error_tuples_surface_conflicts():
    """A forced conflict between two named transactions surfaces as the
    packed ('ERROR', '1020') tuple at the same stream position in both
    packages and in the models."""
    stream = [
        ("NEW_TRANSACTION",),
        ("PUSH", DATA_PREFIX + b"k"), ("GET",), ("POP",),
        ("PUSH", b"trB"), ("USE_TRANSACTION",),
        ("PUSH", b"vB"), ("PUSH", DATA_PREFIX + b"k"), ("SET",), ("COMMIT",), ("POP",),
        ("PUSH", INS_PREFIX), ("USE_TRANSACTION",),
        ("PUSH", b"vA"), ("PUSH", DATA_PREFIX + b"k"), ("SET",), ("COMMIT",),
        ("PUSH", RESULT_PREFIX), ("LOG_STACK",),
    ]
    ref, port = both(run_stream, stream, 7)
    assert port == ref
    _data, log_model = run_model(PORT, stream)
    assert [v for _k, v in port] == [v for _k, v in log_model]
    T = package(PORT).T
    assert T.unpack(T.unpack(port[-1][1])[0]) == (b"ERROR", b"1020")


def test_selector_ops_in_generated_streams():
    """The two generators draw the same streams, and those streams hold
    the selector ops."""
    ops = set()
    gens = [package(pkg).generator for pkg in (REFERENCE, PORT)]
    for seed in range(10):
        ref, port = (g.StreamGenerator(seed, data_prefix=DATA_PREFIX).generate(1000) for g in gens)
        assert port == ref
        ops |= {ins[0].removesuffix("_SNAPSHOT").removesuffix("_DATABASE") for ins in port}
    assert {"GET_KEY", "GET_RANGE_SELECTOR", "GET_RANGE_STARTS_WITH"} <= ops


def directed_selector_stream():
    """``tests/test_bindingtester.py``'s hand-written GET_KEY /
    GET_RANGE_SELECTOR edge cases."""
    k = lambda i: DATA_PREFIX + b"%03d" % i  # noqa: E731
    stream = [("NEW_TRANSACTION",)]
    for i in (2, 5, 9):
        stream += [("PUSH", b"v%d" % i), ("PUSH", k(i)), ("SET",)]
    stream += [("COMMIT",), ("NEW_TRANSACTION",)]
    for anchor in (k(0), k(2), k(4), k(5), k(9), k(10)):
        for or_equal in (0, 1):
            for offset in (-3, -1, 0, 1, 2, 30):
                stream += [("PUSH", DATA_PREFIX), ("PUSH", offset), ("PUSH", or_equal),
                           ("PUSH", anchor), ("GET_KEY",)]
    for b_off, e_off, limit, reverse in ((0, 1, 0, 0), (1, 3, 2, 0), (-2, 2, 0, 1), (2, -2, 0, 0)):
        stream += [("PUSH", DATA_PREFIX), ("PUSH", 0), ("PUSH", reverse), ("PUSH", limit),
                   ("PUSH", e_off), ("PUSH", 1), ("PUSH", k(9)), ("PUSH", b_off), ("PUSH", 0),
                   ("PUSH", k(2)), ("GET_RANGE_SELECTOR",)]
    stream += [("PUSH", 0), ("PUSH", 0), ("PUSH", 0), ("PUSH", DATA_PREFIX),
               ("GET_RANGE_STARTS_WITH",), ("COMMIT",), ("PUSH", RESULT_PREFIX), ("LOG_STACK",)]
    return stream


def test_directed_selector_stream():
    stream = directed_selector_stream()
    ref, port = both(run_stream, stream, 23, store=True, n_storage=4, replication=2)
    assert port == ref
    _data, log_model = run_model(PORT, stream)
    assert [v for _k, v in port] == [v for _k, v in log_model]
    assert len(port) > 70


@pytest.mark.parametrize("seed", [3, 17, 29, 41])
def test_streams_survive_chaos(seed):
    """Under buggify the machine completes with a well-formed state, and
    one seed's chaos draws the same faults in both packages: the same
    stream, data and log."""
    ref, port = both(run_real, seed, 250, chaos=True)
    assert port == ref
    for k, v in port[1]:
        assert k.startswith(DATA_PREFIX) and isinstance(v, bytes)
