"""perf: measured throughput/latency for the cluster, sim and real TCP.

The driver behind the repo's analog of the reference's published
benchmarks (documentation/sphinx/source/benchmarking.rst:22-97). Runs the
ReadWrite / BulkLoad / Throughput workloads (workloads/readwrite.py)
against either:

  --mode sim   one in-process simulated cluster (wall-clock = the Python
               pipeline's own cost; latencies reported in sim time = the
               protocol's model cost)
  --mode tcp   a real multi-process TCP cluster (tools/tcp_soak.TcpCluster)
               with --client-procs parallel OS-process clients

Prints ONE JSON line per run:
  {"workload": ..., "mode": ..., "ops_per_s": ..., "vs_baseline": ...}

vs_baseline compares against the matching benchmarking.rst row:
  write (0r+10w, 100 clients) : 46,000 writes/s   (rst:53)
  read  (10r+0w)              : 305,000 reads/s   (rst:67)
  90_10 (9r+1w)               : 107,000 ops/s     (rst:83)
  50_50 (5r+5w)               : 107,000 ops/s     (closest published row)
  bulkload                    : 46,000 writes/s   (write-rate row)

The port's copy of ``foundationdb_tpu/tools/perf.py``: every mode, preset
and flag default is the reference's, plus ``--device {cuda,cpu}``
(default ``cuda``): the device of the resolvers and storage servers of
the cluster a mode builds (sim, overload, keyspace-micro, tcp-inproc) or
spawns (tcp, through each worker's ``--device``). A tcp-client process
hosts no role and needs no device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

PRESETS = {
    # name: (reads_per_txn, writes_per_txn, baseline_ops_per_s, baseline_metric)
    "write": (0, 10, 46_000.0, "writes_per_s"),
    "read": (10, 0, 305_000.0, "reads_per_s"),
    "90_10": (9, 1, 107_000.0, "ops_per_s"),
    "50_50": (5, 5, 107_000.0, "ops_per_s"),
}


def run_sim(args) -> dict:
    from ..client.database import Database
    from ..net.sim import Sim
    from ..runtime.futures import spawn
    from ..runtime.rng import DeterministicRandom
    from ..server import Cluster, ClusterConfig
    from ..workloads import run_workloads

    from ..runtime.trace import TraceLog, set_trace_log, trace_log

    sim = Sim(seed=args.seed)
    sim.activate()
    # benchmark network profile (bench.py's e2e rationale): the published
    # numbers come from real clusters with ~0.1-0.25 ms hops
    sim.knobs.SIM_FAST_LATENCY = 0.00025
    sim.knobs.SIM_MAX_LATENCY = 0.001
    if args.no_read_coalescing:
        sim.knobs.CLIENT_READ_COALESCING = False
    if args.storage_legacy_engine:
        sim.knobs.STORAGE_EPOCH_BATCHING = False
    if args.commit_path_legacy:
        # pin all three commit-path mechanisms off for the A/B leg. The
        # codec/slab toggles are process-wide module state (sim transport
        # passes objects by reference, so only slab settling and the tlog
        # fsync pipeline are actually load-bearing here)
        from ..net import wire as _wire
        from ..runtime import futures as _rt_futures

        sim.knobs.WIRE_COMPILED_CODEC = False
        sim.knobs.FUTURE_SLAB_SETTLE = False
        sim.knobs.TLOG_FSYNC_PIPELINE = False
        _wire.set_compiled_codec(False)
        _rt_futures.set_slab_settle(False)
    if args.trace_sample > 0:
        # span tracing for stage attribution: a fresh TraceLog so the
        # breakdown covers exactly this run
        sim.knobs.TRACE_SAMPLE_RATE = args.trace_sample
        set_trace_log(TraceLog())
    cluster = Cluster(
        sim,
        ClusterConfig(
            n_proxies=2, n_resolvers=2, conflict_backend=args.backend
        ),
        device=role_device(args),
    )
    db = Database(sim, cluster.proxy_addrs)
    w = make_workload(args, db, DeterministicRandom(args.seed))

    async def go():
        await run_workloads([w])
        return True

    sim.run_until_done(spawn(go()), 36000.0)
    report = w.rec.report()
    if args.trace_sample > 0:
        # aggregate read/commit critical-path breakdown (sim-time ms),
        # embedded next to the throughput numbers so BENCH JSONs carry
        # stage attribution (tools/trace_analyze span mode)
        from .trace_analyze import critical_path

        report["trace_breakdown"] = critical_path(
            trace_log().events, root_prefix="Client."
        )
    # run-loop profiler snapshot (runtime/profiler.py): WHO held the loop
    # during the run, next to the kernel snapshot and trace breakdown —
    # the before-evidence for loop-starvation claims
    prof = getattr(sim.loop, "profiler", None)
    if prof is not None:
        report["run_loop"] = prof.snapshot(top=5)
    # transport counters (net/metrics.py): message/frame totals and the
    # coalescing ratio ride in every BENCH JSON so batching regressions
    # show up next to the throughput numbers
    report["transport"] = sim.transport_metrics.snapshot()
    return report


def run_overload(args) -> dict:
    """--overload-factor N: the admission-control overload A/B.

    One simulated DynamicCluster (master-hosted Ratekeeper + CC status):
    phase A calibrates peak capacity with a default-class Throughput run,
    then RK_MAX_TPS pins to that capacity and phase B offers ~N× the
    load (mixed batch/default across tenants, plus a default-class
    goodput probe population). Reports goodput vs peak, shed counts, and
    admitted-traffic p95 — with the cluster's qos / workload /
    latency_probe status sections embedded as evidence.

    --no-admission runs the B leg with shedding disabled (an effectively
    unbounded, deadline-free queue — the park-forever gate without admission)
    for the collapse side of the A/B."""
    from ..client.database import Database
    from ..client import management
    from ..net.sim import Sim
    from ..runtime.futures import spawn
    from ..runtime.rng import DeterministicRandom
    from ..server.cluster import ClusterConfig, DynamicCluster
    from ..workloads import run_workloads
    from ..workloads.readwrite import ThroughputWorkload

    sim = Sim(seed=args.seed)
    sim.activate()
    sim.knobs.SIM_FAST_LATENCY = 0.00025
    sim.knobs.SIM_MAX_LATENCY = 0.001
    cluster = DynamicCluster(
        sim,
        ClusterConfig(n_proxies=2, n_resolvers=1, n_tlogs=1, n_storage=1),
        device=role_device(args),
    )
    db = Database.from_coordinators(sim, cluster.coordinators)
    rng = DeterministicRandom(args.seed)
    duration = args.duration if args.duration > 0 else 3.0
    # bound the sim-side keyspace population cost: overload measures the
    # admission path, not bulk ingest
    ks = min(args.keyspace, 2000)
    from ..runtime.loop import now as sim_now

    def sim_run(workloads, limit=36000.0):
        async def go():
            await run_workloads(workloads)
            return True

        sim.run_until_done(spawn(go()), limit)

    # phase A: peak capacity, default class, modest concurrency
    w_cal = ThroughputWorkload(
        db, rng.fork(), duration=duration, actors=args.actors,
        reads_per_txn=1, writes_per_txn=1, keyspace=ks,
        now_fn=sim_now,
    )
    t0 = sim_now()
    sim_run([w_cal])
    cal_elapsed = max(sim_now() - t0, 1e-9)
    capacity = w_cal.rec.commits / cal_elapsed
    # pin the Ratekeeper to defend the measured capacity WITH headroom
    # (the reference grants below saturation so admitted traffic keeps
    # its latency inside bands); proxies pick the new grant up within
    # one poll interval. Let the smoothed rates settle onto the pinned
    # ceiling before the overload leg starts.
    # 0.5x: decisively below the cluster's latency-backpressure point, so
    # the GATE (not commit-path queueing) is what the overload leg hits —
    # the A/B then measures admission behavior, not batching elasticity
    defended = capacity * 0.5
    sim.knobs.RK_MAX_TPS = max(defended, 1.0)
    from ..runtime.futures import delay as _delay

    async def settle():
        await _delay(5.0)
        return True

    sim.run_until_done(spawn(settle()), 600.0)
    if args.no_admission:
        # the collapse leg: no deadline, no bound — waiters park forever
        sim.knobs.RK_GRV_QUEUE_TIMEOUT = 1e9
        sim.knobs.RK_GRV_QUEUE_MAX = 1 << 30

    # phase B: ~factor× offered load. Scale offered load by actor count
    # (each calibration actor saturated its pipeline depth already)
    factor = max(args.overload_factor, 1.0)
    n_flood = max(int(args.actors * factor) - args.actors, 1)
    # floods carry one read each: a write-only transaction never takes
    # a GRV (read_snapshot=0), so it would bypass admission entirely
    flood_batch = ThroughputWorkload(
        db, rng.fork(), duration=duration, actors=(n_flood + 1) // 2,
        reads_per_txn=1, writes_per_txn=1, keyspace=ks,
        now_fn=sim_now, priority="batch", tenant="flood-batch",
        prefix=b"ovb/",
    )
    flood_default = ThroughputWorkload(
        db, rng.fork(), duration=duration, actors=n_flood // 2 or 1,
        reads_per_txn=1, writes_per_txn=1, keyspace=ks,
        now_fn=sim_now, priority="default", tenant="flood-default",
        prefix=b"ovd/",
    )
    # the admitted-traffic population whose goodput/p95 the acceptance
    # criteria cite: default class, its own tenant
    w_load = ThroughputWorkload(
        db, rng.fork(), duration=duration, actors=args.actors,
        reads_per_txn=1, writes_per_txn=1, keyspace=ks,
        now_fn=sim_now, priority="default", tenant="app",
    )
    t0 = sim_now()
    sim_run([w_load, flood_batch, flood_default])
    b_elapsed = max(sim_now() - t0, 1e-9)
    goodput = (
        w_load.rec.commits + flood_batch.rec.commits + flood_default.rec.commits
    ) / b_elapsed

    # cluster-side evidence: qos (throttled/released per class), workload
    # (latency bands), latency_probe (immediate-class probe percentiles)
    async def fetch_status():
        return await management.get_status(cluster.coordinators, db.client)

    status_fut = spawn(fetch_status())
    sim.run_until_done(status_fut, 600.0)
    doc = status_fut.get() or {}
    cl = sorted(w_load.rec.commit_lat)
    fl = sorted(flood_batch.rec.commit_lat + flood_default.rec.commit_lat)
    # each flood txn's FIRST read pays the GRV (admission) wait — this is
    # where an unbounded park shows up as latency collapse
    fr = sorted(flood_batch.rec.read_lat + flood_default.rec.read_lat)
    report = {
        "workload": "overload",
        "overload_factor": round(factor, 2),
        "capacity_txn_s": round(capacity, 1),
        "defended_txn_s": round(defended, 1),
        "goodput_txn_s": round(goodput, 1),
        "goodput_ratio": round(goodput / max(defended, 1e-9), 3),
        "admitted_commit_p50_ms": round(_w_pct(cl, 0.50) * 1000, 3),
        "admitted_commit_p95_ms": round(_w_pct(cl, 0.95) * 1000, 3),
        "admitted_commits": w_load.rec.commits,
        "flood_commits": flood_batch.rec.commits + flood_default.rec.commits,
        # the flood population is where the OFF leg's collapse shows:
        # parked-forever GRVs turn into unbounded commit latency here
        "flood_commit_p50_ms": round(_w_pct(fl, 0.50) * 1000, 3),
        "flood_commit_p95_ms": round(_w_pct(fl, 0.95) * 1000, 3),
        "flood_read_p50_ms": round(_w_pct(fr, 0.50) * 1000, 3),
        "flood_read_p95_ms": round(_w_pct(fr, 0.95) * 1000, 3),
        "batch_flood_commits": flood_batch.rec.commits,
        "admission": "off" if args.no_admission else "on",
        "status": {
            k: doc.get(k) for k in ("qos", "workload", "latency_probe")
        },
    }
    prof = getattr(sim.loop, "profiler", None)
    if prof is not None:
        report["run_loop"] = prof.snapshot(top=5)
    report["transport"] = sim.transport_metrics.snapshot()
    return report


def role_device(args):
    """The roles' device in the port's convention: None is the card."""
    return None if args.device == "cuda" else "cpu"


def _w_pct(sorted_vals, p):
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * p))]


def _hot_message_set():
    """The commit/read-path messages a loaded cluster actually moves:
    GRV, point reads, coalesced multi-gets, a mutation-carrying commit,
    the proxy→resolver batch and the proxy→tlog push."""
    from ..kv.mutations import Mutation, MutationType
    from ..server import interfaces as it

    muts = [
        Mutation(MutationType.SET_VALUE, b"key/%06d" % i, b"v" * 64)
        for i in range(10)
    ]
    txn = it.TransactionData(
        read_snapshot=1_000_000,
        read_conflict_ranges=[(b"key/000000", b"key/000010")],
        write_conflict_ranges=[
            (m.param1, m.param1 + b"\x00") for m in muts
        ],
        mutations=muts,
    )
    return [
        it.GetReadVersionRequest(priority=1, tenant="", count=4),
        it.GetReadVersionReply(version=1_000_000),
        it.GetValueRequest(key=b"key/000001", version=1_000_000),
        it.GetValueReply(value=b"v" * 64),
        it.MultiGetRequest(
            keys=[b"key/%06d" % i for i in range(16)], version=1_000_000
        ),
        it.MultiGetReply(values=[b"v" * 64] * 16),
        it.CommitRequest(transaction=txn),
        it.CommitReply(version=1_000_123, versionstamp=b"\x00" * 10),
        it.ResolveBatchRequest(
            prev_version=999_000,
            version=1_000_123,
            last_receive_version=999_000,
            requesting_proxy="127.0.0.1:4500",
            transactions=[txn] * 4,
        ),
        it.TLogCommitRequest(
            prev_version=999_000,
            version=1_000_123,
            messages={0: muts, 1: muts[:5]},
            epoch=2,
            known_committed=999_000,
        ),
    ]


def run_codec_micro(args) -> dict:
    """--codec-micro: standalone encode/decode micro-bench over the hot
    message set, both codec paths, no cluster. Isolates the
    schema-compiled codec's contribution (wire.py) from the e2e rows:
    msgs/s + bytes/s per (path, direction), plus the byte-identity check
    the compiled path is contractually held to. bench_capture embeds
    this next to the kernel/run_loop snapshots."""
    from ..net import wire

    msgs = _hot_message_set()
    # contract first: identical bytes both ways, decode round-trips
    wire.set_compiled_codec(True)
    compiled = [wire.encode_value(m) for m in msgs]
    wire.set_compiled_codec(False)
    interp = [wire.encode_value(m) for m in msgs]
    wire.set_compiled_codec(True)
    identical = compiled == interp
    per_round = sum(len(b) for b in compiled)
    budget = args.duration if args.duration > 0 else 0.4
    report = {
        "workload": "codec_micro",
        "mode": "micro",
        "messages_per_round": len(msgs),
        "bytes_per_round": per_round,
        "byte_identical": identical,
        "compiled": {},
        "interpretive": {},
    }
    # host-side timing loop by construction (no sim, no event loop): the
    # micro-bench times raw codec throughput on the wall clock
    def _leg(fn, items):
        n = 0
        t0 = time.perf_counter()  # flowlint: disable=det-wall-clock
        while time.perf_counter() - t0 < budget:  # flowlint: disable=det-wall-clock
            for x in items:
                fn(x)
            n += 1
        return n * len(items) / (time.perf_counter() - t0)  # flowlint: disable=det-wall-clock

    # interleave the paths and keep best-of-N per leg: on a noisy shared
    # box a single timing leg swings +/-20%, which would drown the codec
    # delta; best-of measures the unpreempted rate each path can reach
    best = {p: {"enc": 0.0, "dec": 0.0} for p in ("compiled", "interpretive")}
    try:
        for _ in range(3):
            for path in ("compiled", "interpretive"):
                wire.set_compiled_codec(path == "compiled")
                for m in msgs:  # warm caches / dispatch tables
                    wire.decode_value(wire.encode_value(m))
                b = best[path]
                b["enc"] = max(b["enc"], _leg(wire.encode_value, msgs))
                b["dec"] = max(b["dec"], _leg(wire.decode_value, compiled))
    finally:
        wire.set_compiled_codec(True)
    for path, b in best.items():
        report[path] = {
            "encode_msgs_per_s": round(b["enc"], 1),
            "encode_mb_per_s": round(b["enc"] * per_round / len(msgs) / 1e6, 2),
            "decode_msgs_per_s": round(b["dec"], 1),
            "decode_mb_per_s": round(b["dec"] * per_round / len(msgs) / 1e6, 2),
        }
    c, i = report["compiled"], report["interpretive"]
    report["encode_speedup"] = round(
        c["encode_msgs_per_s"] / max(i["encode_msgs_per_s"], 1e-9), 2
    )
    report["decode_speedup"] = round(
        c["decode_msgs_per_s"] / max(i["decode_msgs_per_s"], 1e-9), 2
    )
    return report


def run_keyspace_micro(args) -> dict:
    """--keyspace-micro: skewed-keyspace probe of the keyspace telemetry
    (server/storage_metrics.py), no DD — one static sim cluster, a bulk
    cold/ prefix plus a small hot/ prefix taking ~90% of reads, then:
    sampled per-prefix byte estimates vs the driver's exact counts, the
    read-hot-range verdict (hot/ must rank top-1), a waitMetrics band
    armed over hot/ that the write load must push across, and the
    storage metrics-history ring depth. bench_capture embeds this next
    to the codec/kernel snapshots."""
    from ..client.database import Database
    from ..net.sim import Endpoint, Sim
    from ..runtime.futures import spawn, timeout
    from ..runtime.rng import DeterministicRandom
    from ..server import Cluster, ClusterConfig
    from ..server.interfaces import Tokens, WaitMetricsRequest

    sim = Sim(seed=args.seed)
    sim.activate()
    cluster = Cluster(
        sim, ClusterConfig(n_proxies=1, n_resolvers=1), device=role_device(args)
    )
    db = Database(sim, cluster.proxy_addrs)
    ss = cluster.storages[0]
    rng = DeterministicRandom(args.seed)
    exact = {"hot": 0, "cold": 0}
    report: dict = {"workload": "keyspace_micro", "mode": "sim"}

    async def write_batch(items):
        async def body(tr):
            for k, v in items:
                tr.set(k, v)

        await db.run(body)
        for k, v in items:
            pfx = "hot" if k.startswith(b"hot/") else "cold"
            exact[pfx] += len(k) + len(v)

    async def go():
        from ..runtime.futures import delay

        # arm a waitMetrics band over hot/ BEFORE the load: the write
        # traffic must push the estimate across without any scan
        wait_fut = spawn(
            timeout(
                db.client.request(
                    Endpoint(ss.process.address, Tokens.WAIT_METRICS),
                    WaitMetricsRequest(b"hot/", b"hot0", 0, 512),
                ),
                60.0,
            )
        )
        hot_keys = [f"hot/{i:03d}".encode() for i in range(8)]
        for base in range(0, 600, 20):
            await write_batch(
                [
                    (f"cold/{base + i:06d}".encode(), bytes(64))
                    for i in range(20)
                ]
            )
        await write_batch([(k, bytes(256)) for k in hot_keys])
        # 90%-hot read skew
        for _ in range(400):
            key = (
                rng.random_choice(hot_keys)
                if rng.random01() < 0.9
                else f"cold/{rng.random_int(0, 600):06d}".encode()
            )

            async def body(tr, key=key):
                return await tr.get(key)

            await db.run(body)
        push = await wait_fut
        report["wait_metrics_pushed"] = push is not None and not (
            push or {}
        ).get("unsupported")
        report["wait_metrics_reply"] = push
        await delay(3 * sim.knobs.METRICS_HISTORY_INTERVAL)  # ring fills
        return True

    sim.run_until_done(spawn(go()), 36000.0)
    est = {
        "hot": ss.metrics.sample_bytes(b"hot/", b"hot0"),
        "cold": ss.metrics.sample_bytes(b"cold/", b"cold0"),
    }
    report["byte_sample"] = {
        "entries": ss.metrics.sample_entries(),
        "estimate": est,
        "exact": exact,
        "error_pct": {
            p: round(100.0 * abs(est[p] - exact[p]) / max(exact[p], 1), 2)
            for p in exact
        },
    }
    hot_ranges = ss.metrics.hot_ranges_status(5)
    report["hot_ranges"] = hot_ranges
    report["hot_top1_is_hot_prefix"] = bool(
        hot_ranges and hot_ranges[0]["begin"].startswith("hot/")
    )
    hist = ss.stats.history
    report["metrics_history_points"] = len(hist) if hist is not None else 0
    report["wait_metrics_fired"] = ss.stats.counters["waitMetricsFired"].value
    return report


def make_workload(args, db, rng, now_fn=None):
    from ..workloads.readwrite import (
        BulkLoadWorkload,
        ReadWriteWorkload,
        ThroughputWorkload,
    )

    if args.workload == "bulkload":
        return BulkLoadWorkload(
            db,
            rng,
            actors=args.actors,
            txns_per_actor=args.txns,
            keys_per_txn=args.keys_per_txn,
            now_fn=now_fn,
            client_id=args.client_id,
            client_count=max(args.client_procs, 1),
        )
    r, w, _base, _metric = PRESETS[args.workload]
    if args.duration > 0:
        return ThroughputWorkload(
            db,
            rng,
            duration=args.duration,
            actors=args.actors,
            reads_per_txn=r,
            writes_per_txn=w,
            keyspace=args.keyspace,
            now_fn=now_fn,
            parallel_reads=args.parallel_reads,
        )
    return ReadWriteWorkload(
        db,
        rng,
        actors=args.actors,
        txns_per_actor=args.txns,
        reads_per_txn=r,
        writes_per_txn=w,
        keyspace=args.keyspace,
        now_fn=now_fn,
        parallel_reads=args.parallel_reads,
    )


def run_tcp_client(args, coordinators) -> dict:
    """One OS-process client against a running TCP cluster."""
    from ..client.database import Database
    from ..net.tcp import RealWorld
    from ..runtime.futures import spawn
    from ..runtime.rng import DeterministicRandom
    from ..workloads import run_workloads

    from ..runtime.knobs import Knobs

    knobs = Knobs()
    if args.commit_path_legacy:
        # client-side halves of the commit-path A/B: interpretive codec,
        # per-waiter settling (RealWorld wires the module globals from
        # its knobs at construction)
        knobs.WIRE_COMPILED_CODEC = False
        knobs.FUTURE_SLAB_SETTLE = False
    world = RealWorld("127.0.0.1:0", knobs=knobs)
    world.activate()
    if args.no_read_coalescing:
        world.knobs.CLIENT_READ_COALESCING = False  # client-side knob
    db = Database.from_coordinators(world, coordinators.split(","))
    w = make_workload(
        args, db, DeterministicRandom(args.seed), now_fn=time.perf_counter
    )

    async def go():
        await run_workloads([w])
        return True

    world.run_until_done(spawn(go()), 36000.0)
    report = w.rec.report()
    prof = getattr(world.loop, "profiler", None)
    if prof is not None:
        report["run_loop"] = prof.snapshot(top=5)
    report["transport"] = world.transport_metrics.snapshot()
    return report


def run_tcp(args) -> dict:
    from .tcp_soak import TcpCluster, fdbcli, wait_for

    with tempfile.TemporaryDirectory(prefix="fdbtpu-perf-") as datadir:
        cluster = TcpCluster(
            datadir,
            config=args.tcp_config,
            classes=tuple(args.tcp_classes.split(",")),
            device=args.device,
            knobs=tuple(
                (
                    ("STORAGE_EPOCH_BATCHING=false",)
                    if args.storage_legacy_engine
                    else ()
                )
                + (
                    (
                        "WIRE_COMPILED_CODEC=false",
                        "FUTURE_SLAB_SETTLE=false",
                        "TLOG_FSYNC_PIPELINE=false",
                    )
                    if args.commit_path_legacy
                    else ()
                )
            ),
        )
        try:
            wait_for(
                lambda: (
                    fdbcli(cluster.coord, "set perfboot ok", timeout=30)[0]
                    == 0,
                    "boot",
                ),
                180,
                "cluster never formed",
                cluster,
            )
            procs = []
            child_args = [
                sys.executable,
                "-m",
                "foundationdb_tpu_torch.tools.perf",
                "--workload", args.workload,
                "--mode", "tcp-client",
                "--coordinators", cluster.coord,
                "--actors", str(args.actors),
                "--txns", str(args.txns),
                "--keyspace", str(args.keyspace),
                "--keys-per-txn", str(args.keys_per_txn),
                "--duration", str(args.duration),
                "--client-procs", str(args.client_procs),
            ]
            if args.parallel_reads:
                child_args.append("--parallel-reads")
            if args.no_read_coalescing:
                child_args.append("--no-read-coalescing")
            if args.commit_path_legacy:
                child_args.append("--commit-path-legacy")
            for p in range(args.client_procs):
                procs.append(
                    subprocess.Popen(
                        child_args
                        + ["--seed", str(args.seed + p), "--client-id", str(p)],
                        stdout=subprocess.PIPE,
                        text=True,
                    )
                )
            reports = []
            for p in procs:
                out, _ = p.communicate(timeout=3600)
                line = [l for l in out.splitlines() if l.startswith("{")][-1]
                reports.append(json.loads(line))
            report = aggregate(reports)
            if args.status_json:
                # cluster-side evidence next to the client-side rates:
                # workload counters (reads_batched), latency_probe
                # percentiles, qos — the sections bench rows cite
                rc, out = fdbcli(cluster.coord, "status json", timeout=60)
                if rc == 0:
                    try:
                        doc = json.loads(out[out.index("{"):])
                        report["status"] = {
                            k: doc.get(k)
                            for k in ("workload", "latency_probe", "qos")
                        }
                    except (ValueError, KeyError):
                        pass
            return report
        finally:
            cluster.stop()


def run_tcp_inproc(args) -> dict:
    """--mode tcp-inproc: the whole cluster — coordinator, workers, client
    — as RealWorlds on ONE RealLoop in THIS OS process. This is the
    colocated shape the loopback transport exists for (the bench box runs
    everything on one core anyway, so loopback TCP syscalls are pure
    waste), and the transport A/B driver: --transport-legacy pins the
    gen-6-shaped path (per-message frames, sockets) on the SAME topology.
    The report embeds the loop's run_loop snapshot, the per-world
    transport counters, and (with --trace-sample) the span breakdown."""
    from ..client.database import Database
    from ..device import resolve_device
    from ..net.tcp import RealWorld
    from ..runtime.futures import spawn
    from ..runtime.knobs import Knobs
    from ..runtime.loop import RealLoop, set_loop
    from ..runtime.rng import DeterministicRandom
    from ..runtime.trace import TraceLog, set_trace_log, trace_log
    from ..server.coordination import CoordinatorServer
    from ..server.worker import Worker
    from ..workloads import run_workloads
    from .fdbserver import parse_config
    from .tcp_soak import free_ports

    # the workers' roles run on the card: none, no cluster (a worker
    # recruited without one would refuse its roles, never fall back)
    resolve_device(role_device(args))
    knobs = Knobs()
    if args.transport_legacy:
        knobs.TRANSPORT_FRAME_BATCHING = False
        knobs.TRANSPORT_LOOPBACK = False
    if args.no_loopback:
        knobs.TRANSPORT_LOOPBACK = False
    if args.no_read_coalescing:
        knobs.CLIENT_READ_COALESCING = False
    if args.storage_legacy_engine:
        knobs.STORAGE_EPOCH_BATCHING = False
    if args.commit_path_legacy:
        # all three commit-path mechanisms off on every world (RealWorld
        # wires the codec/slab module globals from these at construction;
        # tlogs read TLOG_FSYNC_PIPELINE per commit)
        knobs.WIRE_COMPILED_CODEC = False
        knobs.FUTURE_SLAB_SETTLE = False
        knobs.TLOG_FSYNC_PIPELINE = False
    if args.trace_sample > 0:
        knobs.TRACE_SAMPLE_RATE = args.trace_sample
        set_trace_log(TraceLog())
    cfg = parse_config(args.tcp_config)
    cfg.setdefault("conflict_backend", args.backend)
    classes = args.tcp_classes.split(",")
    loop = RealLoop(args.seed)
    worlds = []
    with tempfile.TemporaryDirectory(prefix="fdbtpu-inproc-") as datadir:
        try:
            cport, *wports = free_ports(1 + len(classes))
            coord = f"127.0.0.1:{cport}"
            cw = RealWorld(
                coord, knobs=knobs, data_dir=f"{datadir}/c", loop=loop
            )
            cw.activate()  # actors spawned below need the loop current
            CoordinatorServer(disk=cw.disk("coordination")).register(cw.node)
            worlds.append(cw)
            for i, (port, pclass) in enumerate(zip(wports, classes)):
                ww = RealWorld(
                    f"127.0.0.1:{port}",
                    knobs=knobs,
                    data_dir=f"{datadir}/w{i}",
                    loop=loop,
                )
                Worker(
                    ww.node, [coord], process_class=pclass,
                    initial_config=cfg, knobs=knobs, device=role_device(args),
                ).start()
                worlds.append(ww)
            client = RealWorld(
                "127.0.0.1:0", knobs=knobs, data_dir=f"{datadir}/cl", loop=loop
            )
            worlds.append(client)
            client.activate()
            db = Database.from_coordinators(client, [coord])
            w = make_workload(
                args, db, DeterministicRandom(args.seed),
                now_fn=time.perf_counter,
            )

            async def settle(tr):
                tr.set(b"perfboot", b"ok")

            async def go():
                await db.run(settle)  # cluster formed end-to-end
                await run_workloads([w])
                return True

            client.run_until_done(spawn(go()), 36000.0)
            report = w.rec.report()
            if args.trace_sample > 0:
                from .trace_analyze import critical_path

                report["trace_breakdown"] = critical_path(
                    trace_log().events, root_prefix="Client."
                )
            prof = getattr(loop, "profiler", None)
            if prof is not None:
                report["run_loop"] = prof.snapshot(top=8)
            report["transport"] = {
                wd.node.address: wd.transport_metrics.snapshot()
                for wd in worlds
            }
            report["transport_knobs"] = {
                "frame_batching": bool(knobs.TRANSPORT_FRAME_BATCHING),
                "loopback": bool(knobs.TRANSPORT_LOOPBACK),
            }
            return report
        finally:
            for wd in worlds:
                wd.close()
            set_loop(None)
            loop.close()


def aggregate(reports: list[dict]) -> dict:
    """Sum rates across concurrent client processes; max the percentiles
    (conservative)."""
    out = dict(reports[0])
    for r in reports[1:]:
        for k in (
            "ops", "reads", "writes", "commits", "conflicts",
            "ops_per_s", "reads_per_s", "writes_per_s", "txn_per_s",
        ):
            out[k] = round(out.get(k, 0) + r.get(k, 0), 1)
        for k in (
            "read_p50_ms", "read_p95_ms", "commit_p50_ms", "commit_p95_ms",
            "wall_s",
        ):
            out[k] = max(out.get(k, 0), r.get(k, 0))
    out["client_procs"] = len(reports)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perf")
    ap.add_argument(
        "--workload",
        default="90_10",
        choices=[*PRESETS, "bulkload"],
    )
    ap.add_argument(
        "--mode",
        default="sim",
        choices=["sim", "tcp", "tcp-client", "tcp-inproc"],
    )
    ap.add_argument("--backend", default="oracle", help="sim conflict backend")
    ap.add_argument("--actors", type=int, default=20)
    ap.add_argument("--txns", type=int, default=50)
    ap.add_argument("--keyspace", type=int, default=10_000)
    ap.add_argument("--keys-per-txn", type=int, default=50, dest="keys_per_txn")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="> 0: time-bounded ThroughputWorkload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--trace-sample", type=float, default=0.0, dest="trace_sample",
        help="> 0: sample this fraction of txns into spans and embed the "
             "read/commit critical-path breakdown in the report (sim mode)",
    )
    ap.add_argument(
        "--parallel-reads", action="store_true", dest="parallel_reads",
        help="issue each txn's reads concurrently (feeds the read "
             "coalescer's same-tick multiGet batching)",
    )
    ap.add_argument(
        "--no-read-coalescing", action="store_true", dest="no_read_coalescing",
        help="force CLIENT_READ_COALESCING off (baseline A/B)",
    )
    ap.add_argument(
        "--status-json", action="store_true", dest="status_json",
        help="tcp mode: embed the cluster's workload/latency_probe/qos "
             "status sections in the report",
    )
    ap.add_argument(
        "--overload-factor", type=float, default=0.0, dest="overload_factor",
        help="> 0: admission-control overload driver (sim DynamicCluster "
             "with a live Ratekeeper): calibrate peak capacity, offer "
             "~N x that load mixed across classes/tenants, embed "
             "qos/workload/latency_probe status evidence",
    )
    ap.add_argument(
        "--no-admission", action="store_true", dest="no_admission",
        help="overload driver: disable shedding (unbounded deadline-free "
             "queue — the pre-admission park-forever gate) for the "
             "collapse leg of the A/B",
    )
    ap.add_argument(
        "--storage-legacy-engine", action="store_true",
        dest="storage_legacy_engine",
        help="pin STORAGE_EPOCH_BATCHING off cluster-wide (the per-"
             "mutation apply path) for the storage-engine A/B leg",
    )
    ap.add_argument(
        "--commit-path-legacy", action="store_true",
        dest="commit_path_legacy",
        help="pin the legacy commit path (interpretive codec, "
             "per-waiter future settling, serialized tlog fsync) "
             "cluster-wide for the commit-path A/B leg",
    )
    ap.add_argument(
        "--codec-micro", action="store_true", dest="codec_micro",
        help="standalone encode/decode micro-bench over the hot message "
             "set, both codec paths (no cluster); --duration bounds each "
             "timing leg (default 0.4s)",
    )
    ap.add_argument(
        "--keyspace-micro", action="store_true", dest="keyspace_micro",
        help="skewed-keyspace telemetry probe: sampled byte "
             "estimates vs exact, hot-range verdict, waitMetrics push, "
             "metrics-history depth (one static sim cluster)",
    )
    ap.add_argument(
        "--transport-legacy", action="store_true", dest="transport_legacy",
        help="tcp-inproc: pin the gen-6-shaped transport (per-message "
             "frames, no loopback) for the A/B leg",
    )
    ap.add_argument(
        "--no-loopback", action="store_true", dest="no_loopback",
        help="tcp-inproc: keep super-frame batching but force sockets "
             "(isolates batching from loopback in the A/B)",
    )
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device of the cluster's resolvers and storage servers "
             "(cuda: the card)",
    )
    ap.add_argument("--client-procs", type=int, default=2, dest="client_procs")
    ap.add_argument("--client-id", type=int, default=0, dest="client_id")
    ap.add_argument("--coordinators", default=None)
    ap.add_argument(
        "--tcp-config",
        default="n_storage=2,replication=1,n_tlogs=1",
        dest="tcp_config",
    )
    ap.add_argument(
        "--tcp-classes",
        default="storage,storage,transaction,stateless",
        dest="tcp_classes",
    )
    args = ap.parse_args(argv)

    if args.codec_micro:
        print(json.dumps(run_codec_micro(args)), flush=True)
        return 0
    if args.keyspace_micro:
        print(json.dumps(run_keyspace_micro(args)), flush=True)
        return 0
    if args.overload_factor > 0:
        report = run_overload(args)
        report["mode"] = "sim"
        print(json.dumps(report), flush=True)
        return 0
    if args.mode == "sim":
        report = run_sim(args)
    elif args.mode == "tcp":
        report = run_tcp(args)
    elif args.mode == "tcp-inproc":
        report = run_tcp_inproc(args)
    else:
        report = run_tcp_client(args, args.coordinators)

    if args.workload == "bulkload":
        base, metric = 46_000.0, "writes_per_s"
    else:
        _r, _w, base, metric = PRESETS[args.workload]
    report["workload"] = args.workload
    report["mode"] = args.mode
    report["vs_baseline"] = round(report.get(metric, 0.0) / base, 4)
    report["baseline_metric"] = metric
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
