"""The port's ``tools/perf.py`` held to the JAX package's: the sim,
overload, codec-micro and keyspace-micro modes, run in each package through
``perf.main`` with the same flags (the port with ``--device cpu``), print
reports with the same keys and the same counts, sim-time latencies and
status sections. Only what the host's clock measures differs: the wall
time and the rates over it, the run-loop profile and the codec's
messages a second."""

import contextlib
import importlib
import io
import json

import pytest
import torch

REFERENCE = "foundationdb_tpu"
PORT = "foundationdb_tpu_torch"

torch.set_num_threads(1)  # the suite runs in several xdist workers

# what the host's clock measures: rates over the wall time, the run-loop
# profile, and baseline ratios of those rates
WALL = {"wall_s", "ops_per_s", "reads_per_s", "writes_per_s", "txn_per_s", "vs_baseline", "run_loop"}


def run(pkg: str, argv: list) -> dict:
    """``perf.main(argv)`` in ``pkg``, its report; no loop, trace log or
    armed buggify of the run left behind."""
    perf = importlib.import_module(f"{pkg}.tools.perf")
    trace = importlib.import_module(f"{pkg}.runtime.trace")
    buggify = importlib.import_module(f"{pkg}.runtime.buggify")
    saved = trace.trace_log()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert perf.main(argv) == 0
    finally:
        importlib.import_module(f"{pkg}.runtime.loop").set_loop(None)
        trace.set_trace_log(saved)
        buggify.set_buggify(buggify.Buggify(None))
    return json.loads(out.getvalue().strip().splitlines()[-1])


def both(argv: list) -> tuple:
    return run(REFERENCE, argv), run(PORT, argv + ["--device", "cpu"])


def without_wall(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in WALL}


@pytest.mark.parametrize(
    "argv",
    [
        ["--mode", "sim", "--actors", "4", "--txns", "5", "--keyspace", "200"],
        ["--mode", "sim", "--workload", "write", "--actors", "3", "--txns", "4", "--keyspace", "100"],
        ["--mode", "sim", "--workload", "bulkload", "--actors", "3", "--txns", "3", "--keys-per-txn", "20"],
        ["--mode", "sim", "--actors", "4", "--txns", "4", "--keyspace", "200", "--parallel-reads",
         "--trace-sample", "0.5"],
    ],
    ids=["90_10", "write", "bulkload", "parallel_traced"],
)
def test_sim_mode_reports_equal(argv):
    ref, port = both(argv)
    assert set(port) == set(ref)
    assert without_wall(port) == without_wall(ref)
    assert port["commits"] > 0 and port["ops"] == port["reads"] + port["writes"]


def test_overload_mode_reports_equal():
    """The admission-control A/B on a DynamicCluster (the port's resolvers
    on ``torch``, the reference's on its default ``oracle``): capacity,
    goodput, the admitted and flood latencies and the cluster's qos,
    workload and latency-probe sections are the same."""
    ref, port = both(["--overload-factor", "2", "--duration", "1", "--actors", "4"])
    assert set(port) == set(ref)
    assert without_wall(port) == without_wall(ref)
    assert port["goodput_txn_s"] > 0 and port["admission"] == "on"


def test_codec_micro_reports_equal():
    ref, port = both(["--codec-micro", "--duration", "0.02"])
    assert set(port) == set(ref)
    for k in ("workload", "mode", "messages_per_round", "bytes_per_round", "byte_identical"):
        assert port[k] == ref[k], k
    assert port["byte_identical"] and port["messages_per_round"] == 10
    for path in ("compiled", "interpretive"):
        assert set(port[path]) == set(ref[path])
        assert all(v > 0 for v in port[path].values())


def test_keyspace_micro_reports_equal():
    ref, port = both(["--keyspace-micro"])
    assert port == ref
    assert port["wait_metrics_pushed"] and port["hot_top1_is_hot_prefix"]


def test_hot_message_set_encodes_to_the_jax_bytes():
    """``_hot_message_set`` is the port's own: built from its classes, it
    encodes to the JAX package's bytes."""
    ref = importlib.import_module(f"{REFERENCE}.tools.perf")._hot_message_set()
    port = importlib.import_module(f"{PORT}.tools.perf")._hot_message_set()
    r_wire = importlib.import_module(f"{REFERENCE}.net.wire")
    p_wire = importlib.import_module(f"{PORT}.net.wire")
    assert [type(m).__module__.split(".")[0] for m in port] == [PORT] * len(port)
    assert [p_wire.encode_value(m) for m in port] == [r_wire.encode_value(m) for m in ref]


def test_sim_mode_on_the_card_by_default_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs on it")
    from foundationdb_tpu_torch.conflict.errors import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError):
        run(PORT, ["--mode", "sim", "--actors", "1", "--txns", "1", "--keyspace", "10"])
