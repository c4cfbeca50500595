"""The port's ``cli`` (``foundationdb_tpu_torch/tools/cli.py``) and
``commit_chain`` held to the JAX package's: each cli and status case of the
reference's tests (``tests/cli_slice.py``) runs in both packages on the
same seeded Sim, the port's resolvers on ``torch`` on the CPU and the
reference's on ``tpu1``, and the transcripts (every cli output and status
document, with the fields ``cli_slice`` lists taken out) are equal. Then
the reference case's own checks hold on the port's run, without its
wall-clock thresholds: where the reference asserts one, the twin holds the
events and their attribution. ``lint`` runs the port's flowlint over the
port's tree, as a subcommand and in the shell; and the TCP personality's
profiler case runs on the port's RealWorlds."""

import json
import socket
import time

import pytest
import torch

from cli_slice import CASES, PORT, REFERENCE, run_cli

torch.set_num_threads(1)  # the suite runs in several xdist workers


def check_vocabulary(r):
    assert r["set hello world"] == "Committed"
    assert "not found" in r["get missing"]
    assert "hello" in r["getrange hello hellp 10"] and "hello2" in r["getrange hello hellp 10"]
    assert r["clear hello"] == "Committed" and "not found" in r["get hello"]
    assert "Cluster controller" in r["status"] and "Recovered: True" in r["status"]
    assert "unknown command" in r["bogus"]
    # the port names each resolver's device in the status pull
    d = json.loads(r["status json"])
    assert [res["kernel"]["device"] for res in d["resolvers"].values()] == ["cpu"]


def check_status_document(r):
    c = r["doc"]["cluster"]
    assert c["recovered"] is True and c["recovery_count"] >= 1
    assert len(c["workers"]) >= 4 and c["logs"]["epoch"] >= 1
    assert len(r["doc"]["client"]["proxies"]) == 2


def check_configure(r):
    assert r["configure n_proxies=2 n_resolvers=2"] == "Configuration changed; recovery triggered"
    assert len(r["after"]["client"]["proxies"]) == 2
    assert "`2'" in r["get b"]


def check_exclude(r):
    excluded = [line for line in r if line.startswith("exclude ")]
    assert r[excluded[0]].startswith("Excluded 1 server(s)")
    assert r["include"] == "Included" and r["exclude"] == "Excluded: (none)"


def check_machine_process_sections(r):
    d = r["doc"]
    assert d["processes"] and d["machines"]
    for sm in d["processes"].values():
        assert "RunLoopLag" in sm and "Actors" in sm
    assert next(iter(d["machines"].values()))["processes"] >= 1
    assert "machines:" in r["status details"] and "processes:" in r["status details"]


def check_blocking_actor(r):
    """The reference's attribution, without its 0.12 s spin ranking first:
    the blocking actor is in ``top`` and in the folded stacks, starvation
    shows per band, and ``process.metrics`` serves the sim personality."""
    assert "sampling loop thread" in r["profile start 250"]
    top = r["top"].splitlines()
    assert "hot actors by run-loop busy time" in top[0]
    assert any(line.split()[-1].endswith("loop_hog") for line in top[2:]), r["top"]
    folded = r["folded"]
    assert folded.strip() and not folded.startswith("(no samples") and "loop_hog" in folded
    first = folded.splitlines()[0]
    assert ";" in first and first.rsplit(" ", 1)[1].isdigit()
    assert "Run loop:" in r["status"] and "starvation [default]" in r["status"]
    assert "starvation [max]" in r["status"]
    for snap in r["direct"].values():
        assert snap["personality"] == "sim" and snap["steps"] > 0
        assert snap["bands"]["default"]["starvation"]["count"] > 0
        assert any(a["name"].endswith("loop_hog") for a in snap["hot_actors"])


def check_watches_surface(r):
    wa = r["doc"]["workload"]["watches"]
    assert wa["registered"]["counter"] >= 5 and wa["fired"]["counter"] >= 5
    assert wa["fanout_batches"]["counter"] >= 1
    assert "Watches:" in r["status"] and "fan-out batches" in r["status"]


def check_hot_range_surface(r):
    hot = r["doc"]["workload"]["hot_ranges"]
    r0 = hot[0]
    assert r0["begin"] < "hot0" and r0["end"] > "hot/", hot
    assert r0["density"] >= 2.0 and r0["read_bytes"] > 0 and r0["storage"]
    bs = r["doc"]["workload"]["byte_sampling"]
    assert bs["sample_entries"] > 0 and bs["bytes_sampled"]["counter"] > 0
    assert bs["hot_range_checks"]["counter"] > 0
    assert "Hot ranges:" in r["status"]
    assert "hot range" in r["hotranges"] and "Byte sample:" in r["hotranges"]
    assert "storage" in r["metrics"]
    assert "storage.epochsApplied over" in r["metrics storage epochsApplied"]
    # the port names each storage server's index device in the status pull
    storage = [s for w in r["doc"]["cluster"]["workers"].values() for s in (w.get("metrics") or {}).values()
               if s["kind"] == "storage"]
    assert [(s["indexDevice"], s["indexCurrent"], s["cardMemory"]) for s in storage] == [("cpu", True, None)]


def check_prefilter_surface(r):
    assert "abort rate" in r["status"]
    assert "Prefilter:" in r["status"] and "pre-rejected" in r["status"]


def check_kernel_failover_surface(r):
    h = r["health"]
    assert h["state"] == "HEALTHY" and h["failovers"] >= 1 and h["promotions"] >= 1
    assert r["mid"]["kernel"]["state"] == "FAILED_OVER" and r["mid"]["kernel"]["failovers"] >= 1
    (rsnap,) = r["after"]["resolvers"].values()
    assert rsnap["kernel"]["health"]["state"] == "HEALTHY"
    assert r["after"]["kernel"]["state"] == "HEALTHY" and r["after"]["kernel"]["promotions"] >= 1
    assert "Conflict kernel: HEALTHY" in r["status"] and "failovers" in r["status"]
    assert "health: HEALTHY on TorchConflictSet" in r["status details"]


def check_storage_engine_surface(r):
    se = r["doc"]["workload"]["storage_engine"]
    assert se["epochs_applied"]["counter"] > 0 and se["epoch_mutations"]["counter"] >= 12
    assert se["range_tombstones"]["counter"] >= 1 and se["snapshots_pinned"]["counter"] > 0
    assert "Storage engine:" in r["status"] and "range tombstones" in r["status"]


CHECKS = {name: globals().get(f"check_{name}") for name in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_transcript_equals_the_reference(name):
    ref, _ = run_cli(REFERENCE, name)
    port, results = run_cli(PORT, name)
    assert port == ref
    if CHECKS[name] is not None:
        CHECKS[name](results)


def test_commit_debug_chain_covers_every_stage():
    port, _ = run_cli(PORT, "commit_debug_chain")
    rec = dict((r[0], r[1:]) for r in port)
    stages = [dict(e)["Event"] for e in rec["chain"][0]]
    for must in ("ClientCommitStart", "ProxyReceived", "GotCommitVersion", "Resolving", "Resolved", "Logged",
                 "Replied", "ClientCommitDone"):
        assert must in stages, (must, stages)
    times = [dict(e)["Time"] for e in rec["chain"][0]]
    assert times == sorted(times) and times[-1] > times[0]
    assert "ms total" in rec["format"][0] and "Logged" in rec["format"][0]
    assert "probe-1" in rec["ids"][0]


def test_commit_sampling_knob_tags_every_commit():
    port, _ = run_cli(PORT, "commit_sampling")
    rec = dict((r[0], r[1:]) for r in port)
    (ids,), (chains,) = rec["ids"], rec["chains"]
    assert len(ids) >= 3 and all("Replied" in stages for stages in chains)


def test_lint_subcommand_and_shell_command_run_the_ports_flowlint(capsys):
    """``cli lint`` prints the port's flowlint table and exits 0 on the
    clean tree; ``lint --json`` in the shell gives the same document as
    ``_run_lint``, every rule counted, the port's files and baseline."""
    import asyncio

    from foundationdb_tpu_torch.tools import cli
    from foundationdb_tpu_torch.tools.flowlint import all_rules

    assert cli.main(["lint"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("flowlint: ") and "clean: no unsuppressed findings" in out
    assert "foundationdb_tpu_torch/conflict/kernels/build.py" in out  # the host-only manifest
    shell = cli.FdbCli.__new__(cli.FdbCli)
    doc = json.loads(asyncio.run(shell._cmd_lint(["--json"])))
    assert doc["clean"] and doc["files"] > 100
    assert set(doc["per_rule"]) == {r.id for r in all_rules()}
    assert {f["path"] for f in doc["baselined"]} == {"foundationdb_tpu_torch/workloads/readwrite.py"}
    assert all(f["path"].startswith("foundationdb_tpu_torch/") for f in doc["disabled"])


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_tcp_cluster_slowtask_top_profile_and_status(tmp_path):
    """The TCP personality of the profiler case, on the port: coordinator,
    two workers (``device="cpu"``) and a client as RealWorlds over real
    sockets on one RealLoop. The blocking actor yields a SlowTask trace
    event attributed to it, shows in ``cli top`` and ``cli profile``,
    starvation shows per band in ``cli status``, and ``process.metrics``
    answers over the wire with the real personality. Where the reference
    asserts one SlowTask of at least 90 ms and the actor first in ``top``,
    this holds its events and attribution."""
    from foundationdb_tpu_torch.client import management
    from foundationdb_tpu_torch.client.database import Database
    from foundationdb_tpu_torch.net.sim import Endpoint
    from foundationdb_tpu_torch.net.tcp import RealWorld
    from foundationdb_tpu_torch.runtime.futures import delay, spawn
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.runtime.loop import RealLoop, set_loop
    from foundationdb_tpu_torch.runtime.trace import TraceLog, set_trace_log, trace_log
    from foundationdb_tpu_torch.server.coordination import CoordinatorServer
    from foundationdb_tpu_torch.server.worker import Worker
    from foundationdb_tpu_torch.tools import trace_analyze as ta
    from foundationdb_tpu_torch.tools.cli import FdbCli

    saved = trace_log()
    log = TraceLog()
    set_trace_log(log)
    knobs = Knobs()
    loop = RealLoop(seed=47)
    cport, w1, w2 = free_ports(3)
    coord = f"127.0.0.1:{cport}"
    worlds = []
    try:
        cw = RealWorld(coord, knobs=knobs, data_dir=str(tmp_path / "c"), loop=loop)
        cw.activate()
        CoordinatorServer(disk=cw.disk("coordination")).register(cw.node)
        worlds.append(cw)
        cfg = dict(n_storage=1, replication=1, n_tlogs=1, n_proxies=1, n_resolvers=1)
        for i, port in enumerate((w1, w2)):
            ww = RealWorld(f"127.0.0.1:{port}", knobs=knobs, data_dir=str(tmp_path / f"w{i}"), loop=loop)
            Worker(ww.node, [coord], process_class="unset", initial_config=cfg, knobs=knobs, device="cpu").start()
            worlds.append(ww)
        client = RealWorld("127.0.0.1:0", knobs=knobs, data_dir=str(tmp_path / "cl"), loop=loop)
        worlds.append(client)
        db = Database.from_coordinators(client, [coord])
        cli = FdbCli(db, [coord])

        async def tcp_loop_hog():
            await delay(0.05)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.1:
                pass
            return True

        async def body():
            async def w(tr):
                tr.set(b"tcp-prof", b"v")

            await db.run(w)
            start = await cli.execute("profile start 250")
            await client.node.spawn(tcp_loop_hog())
            folded = await cli.execute("profile stop")
            top = await cli.execute("top 50")
            status = await cli.execute("status")
            doc = await management.get_status([coord], db.client)
            workers = list((doc.get("cluster") or {}).get("workers") or {})
            direct = await db.client.request(Endpoint(workers[0], "process.metrics"), None)
            return start, folded, top, status, doc, direct

        start, folded, top, status, doc, direct = client.run_until_done(spawn(body()), 180.0)
        assert "sampling loop thread" in start
        slow = [e for e in log.events if e["Type"] == "SlowTask"]
        assert any(e["Actor"].endswith("tcp_loop_hog") for e in slow), slow
        st = ta.slow_tasks(log.events)
        assert st["events"] == len(slow)
        assert any(a["actor"].endswith("tcp_loop_hog") for a in st["actors"])
        assert any(line.split()[-1].endswith("tcp_loop_hog") for line in top.splitlines()[2:]), top
        assert folded.strip() and "tcp_loop_hog" in folded
        assert "Run loop:" in status and "slow tasks" in status and "starvation [default]" in status
        assert doc["run_loop"] and all(s["personality"] == "real" for s in doc["run_loop"].values())
        assert direct["personality"] == "real"
        assert direct["bands"]["default"]["starvation"]["count"] > 0
        assert direct["select_seconds"]["count"] > 0
    finally:
        for w in worlds:
            w.close()
        set_loop(None)
        loop.close()
        set_trace_log(saved)
