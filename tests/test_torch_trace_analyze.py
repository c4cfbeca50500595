"""The port's trace consumer (``foundationdb_tpu_torch/tools/trace_analyze.py``)
held against the JAX package's on the same event files: the cases of
``tests/test_trace_roll.py:45``, ``tests/test_storage_metrics.py:376``,
``tests/test_tracing.py:384`` and ``tests/test_profiler.py:412``, and the
span layer (critical path, waterfall, summary) over the trace of a sampled
read mix on the port's dynamic cluster. Every return value and every
rendered text is equal."""

import json

import pytest
import torch

from foundationdb_tpu.runtime.trace import SevInfo, SevWarn, TraceLog
from foundationdb_tpu.tools import trace_analyze as ref
from foundationdb_tpu_torch.tools import trace_analyze as port

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


def _both(fn):
    out = fn(port)
    assert out == fn(ref)
    return out


def test_summary_of_a_rolled_trace(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    log = TraceLog(path, max_file_bytes=1 << 20, keep_files=2)
    for i in range(30):
        log.log(SevInfo, "Spam", float(i) / 10, "p0", Fill="x" * 40, Seq=i)
    for i in range(5):
        log.log(SevWarn, "SlowTask", float(i) / 10, "p0", Fill="x" * 40, Seq=i)
    log.log(SevInfo, "ProxyMetrics", 1.0, "p0", ID="px0", txnCommitOut=10, Elapsed=5.0)
    log.log(SevInfo, "ProxyMetrics", 6.0, "p0", ID="px0", txnCommitOut=25, Elapsed=5.0)
    log.close()

    def run(ta):
        summary = ta.analyze(ta.load_events(path), top=5)
        return summary, ta.format_summary(summary)

    summary, text = _both(run)
    assert summary["events"] == 37 and summary["top_types"][0] == ("Spam", 30)
    assert "SlowTask" in text and "ProxyMetrics#px0" in text


def test_timeline_series_and_sparkline():
    events = [
        {"Type": "StorageMetrics", "ID": "ss0", "Time": 1.0, "epochsApplied": 1, "Severity": 10,
         "flag": True, "name": "x"},
        {"Type": "StorageMetrics", "ID": "ss0", "Time": 2.0, "epochsApplied": 3},
        {"Type": "GetValue", "Time": 1.5, "n": 9},
        {"Type": "ProxyMetrics", "Machine": "p0", "Time": 1.0, "commits": 2},
    ]

    def run(ta):
        tls = ta.timeline_series(events)
        only = ta.timeline_series(events, counter="commits")
        return (tls, only, ta.format_timeline(tls), ta.format_timeline({}),
                [ta.sparkline(v) for v in ([], [7, 7], [0, 1, 2, 3], [5, 1, 9, 2, 2])])

    tls, only, _text, _empty, sparks = _both(run)
    assert tls["StorageMetrics#ss0"]["epochsApplied"] == [(1.0, 1), (2.0, 3)]
    assert list(only) == ["ProxyMetrics#p0"] and sparks[1] == "▁▁"


def test_files_merge_in_time_order(tmp_path):
    f1, f2 = tmp_path / "proc1.jsonl", tmp_path / "proc2.jsonl"
    f1.write_text("\n".join(json.dumps({"Type": "X", "Time": t, "Machine": "p1"}) for t in (0.1, 0.3, 0.5)) + "\n")
    f2.write_text("\n".join(json.dumps({"Type": "X", "Time": t, "Machine": "p2"}) for t in (0.2, 0.4)) + "\n")
    merged, single = _both(lambda ta: (ta.load_events([str(f1), str(f2)]), ta.load_events(str(f1))))
    assert [e["Time"] for e in merged] == [0.1, 0.2, 0.3, 0.4, 0.5]
    assert [e["Time"] for e in single] == [0.1, 0.3, 0.5]


def test_slow_tasks_table(tmp_path):
    def slow(actor, ms, machine, t):
        return {"Severity": "Warn", "Type": "SlowTask", "Time": t, "Machine": machine, "Actor": actor,
                "BusyMs": ms, "Priority": 7500, "Band": "default"}

    f1, f2 = tmp_path / "s1.jsonl", tmp_path / "s2.jsonl"
    f1.write_text("\n".join(json.dumps(e) for e in [
        slow("Proxy.commit_batch", 120.0, "127.0.0.1:1", 1.0),
        {"Severity": "Info", "Type": "Span", "Time": 1.5},
        slow("Proxy.commit_batch", 80.0, "127.0.0.1:1", 2.0),
    ]) + "\n")
    f2.write_text(json.dumps(slow("Resolver.resolve", 60.0, "127.0.0.1:2", 1.2)) + "\n")

    def run(ta):
        st = ta.slow_tasks(ta.load_events([str(f1), str(f2)]))
        return st, ta.format_slow_tasks(st), ta.format_slow_tasks(ta.slow_tasks([]))

    st, text, _none = _both(run)
    assert st["events"] == 3 and st["actors"][0]["count"] == 2 and "Resolver.resolve" in text


@pytest.fixture(scope="module")
def read_mix_trace(tmp_path_factory):
    """The trace of a sampled 90/10 read mix on the port's dynamic cluster
    (tests/test_tracing.py's read waterfall run), written to a file."""
    from foundationdb_tpu_torch.client.database import Database
    from foundationdb_tpu_torch.net.sim import Sim
    from foundationdb_tpu_torch.runtime import loop, trace
    from foundationdb_tpu_torch.runtime.futures import spawn
    from foundationdb_tpu_torch.server.cluster import ClusterConfig, DynamicCluster

    path = str(tmp_path_factory.mktemp("trace") / "trace.jsonl")
    saved = trace.trace_log()
    trace.set_trace_log(trace.TraceLog(path))
    try:
        sim = Sim(seed=41)
        sim.activate()
        sim.knobs.TRACE_SAMPLE_RATE = 1.0
        cluster = DynamicCluster(sim, ClusterConfig(n_storage=2), n_coordinators=1, device="cpu")
        db = Database.from_coordinators(sim, cluster.coordinators)

        async def go():
            async def seed_rows(tr):
                for i in range(20):
                    tr.set(b"rw%03d" % i, b"v%d" % i)

            await db.run(seed_rows)
            for n in range(10):
                async def mix(tr, n=n):
                    for i in range(9):
                        await tr.get(b"rw%03d" % ((n * 9 + i) % 20))
                    tr.set(b"rw%03d" % (n % 20), b"w%d" % n)

                await db.run(mix)
            return True

        assert sim.run_until_done(spawn(go()), 600.0)
        trace.trace_log().close()
    finally:
        trace.set_trace_log(saved)
        loop.set_loop(None)
    return path


def test_span_layer_of_a_read_mix(read_mix_trace):
    def run(ta):
        events = ta.load_events(read_mix_trace)
        cp = ta.critical_path(events, root_prefix="Client.get")
        traces = ta.spans_by_trace(events)
        first = sorted(tid for tid, spans in traces.items() if any(s["Name"] == "Client.get" for s in spans))[0]
        summary = ta.analyze(events, top=8)
        return cp, ta.format_waterfall(events, first), summary, ta.format_summary(summary)

    cp, waterfall, _summary, _text = _both(run)
    assert cp["Client.get"]["traces"] >= 50 and cp["Client.get"]["coverage"] >= 0.9
    assert "Client.get" in waterfall
