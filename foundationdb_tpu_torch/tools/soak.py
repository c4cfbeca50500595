"""Seeded chaos soak — the randomized-simulation runner.

The analog of running the reference's `-r simulation` specs across seeds
(SimulatedCluster.actor.cpp:886 setupSimulatedSystem picks a random
cluster shape; knobs and BUGGIFY sites randomize per run; fault workloads
run during correctness workloads; ConsistencyCheck runs after —
tester.actor.cpp:740). A failing seed reproduces exactly.

Run: python -m foundationdb_tpu_torch.tools.soak [n_seeds] [first_seed]

The port's copy of ``foundationdb_tpu/tools/soak.py``: every draw, shape,
workload and check is the reference's. Each run builds its cluster on the
CUDA card named by ``device`` (``None`` = the card, which raises
``DeviceUnavailableError`` when there is none; ``"cpu"`` runs the kernels'
plain versions). The reference's backend draws (``tpu``, ``tpu1``) are
kept, so one seed draws the same shape in both packages, and are then
mapped to the port's names by ``port_backend``.
"""

from __future__ import annotations

import os
import sys

from ..client.database import Database
from ..device import resolve_device
from ..net.sim import Sim
from ..runtime.futures import spawn
from ..runtime.knobs import Knobs
from ..server.cluster import ClusterConfig, DynamicCluster
from ..workloads import (
    ApiCorrectnessWorkload,
    AtomicOpsWorkload,
    AttritionWorkload,
    BackupWorkload,
    ChangeConfigWorkload,
    ConflictRangeWorkload,
    ConsistencyCheckWorkload,
    CycleWorkload,
    DiskFailureWorkload,
    KernelChaosWorkload,
    RandomCloggingWorkload,
    RandomMoveKeysWorkload,
    RollbackWorkload,
    RywFuzzWorkload,
    SelectorFuzzWorkload,
    SerializabilityWorkload,
    SidebandWorkload,
    WatchesWorkload,
    WatchSemanticsWorkload,
    WatchStormWorkload,
    run_workloads,
)


def random_config(rng) -> tuple[ClusterConfig, int, int]:
    """A random legal cluster shape (setupSimulatedSystem:886)."""
    replication = rng.random_choice([1, 2])
    n_teams = rng.random_choice([1, 2, 3])
    cfg = ClusterConfig(
        n_proxies=rng.random_choice([1, 2]),
        n_resolvers=rng.random_choice([1, 2]),
        n_tlogs=rng.random_choice([1, 2, 3]),
        tlog_replication=1 if rng.coinflip(0.5) else min(2, 2),
        n_storage=replication * n_teams,
        replication=replication,
        conflict_backend=rng.random_choice(["oracle", "oracle", "tpu"]),
    )
    if cfg.tlog_replication > cfg.n_tlogs:
        cfg.tlog_replication = cfg.n_tlogs
    n_coordinators = rng.random_choice([1, 3])
    n_zones = rng.random_choice([0, 3])
    return cfg, n_coordinators, n_zones


def port_backend(name: str) -> str:
    """The port's conflict backend for a name the reference's draws give:
    ``tpu`` and ``tpu1`` are one grid on one card, as the reference builds
    them on one device."""
    return "torch" if name in ("tpu", "tpu1") else name


def run_one(
    seed: int,
    verbose: bool = False,
    force_kernel_faults: bool = False,
    force_overload: bool = False,
    device=None,
) -> dict:
    """One randomized chaos run; raises on any check failure. ``device``
    is the card's (``None``) or ``"cpu"``."""
    knobs = Knobs()
    sim = Sim(seed=seed, knobs=knobs, chaos=True)
    sim.activate()
    shape_rng = sim.loop.random.fork()
    knobs.randomize(shape_rng)
    cfg, n_coordinators, n_zones = random_config(shape_rng)
    # device-fault injection at the conflict seam (conflict/faults.py):
    # device-backed shapes arm it half the time — the kernel-fault buggify
    # sites then fire through the run's seeded chaos machinery.
    # force_kernel_faults pins the single-grid backend ("tpu1"): the pinned
    # coverage seed must dispatch on a device backend whatever its draw
    if force_kernel_faults:
        cfg.conflict_backend = "tpu1"
    if cfg.conflict_backend in ("tpu", "tpu1") and (
        force_kernel_faults or shape_rng.coinflip(0.5)
    ):
        knobs.CONFLICT_FAULT_INJECTION = True
    cfg.conflict_backend = port_backend(cfg.conflict_backend)
    cluster = DynamicCluster(
        sim, cfg, n_coordinators=n_coordinators, n_zones=n_zones, device=device
    )
    db = Database.from_coordinators(sim, cluster.coordinators)
    rng = sim.loop.random

    kills = int(shape_rng.random_choice([0, 1, 2]))
    workloads = [
        CycleWorkload(db, rng.fork(), nodes=10, transactions=25),
        SidebandWorkload(db, rng.fork(), messages=25),
        RandomCloggingWorkload(db, rng.fork(), duration=4.0),
        # the API-fuzz battery (oracle-checked) rotates in per seed
        ApiCorrectnessWorkload(db, rng.fork(), transactions=15, client_id=0),
        RywFuzzWorkload(db, rng.fork(), transactions=8, client_id=0),
        # key-selector navigation (getKey walks + RYW overlay resolution)
        # runs every seed: cross-shard continuation is shape-dependent
        SelectorFuzzWorkload(db, rng.fork(), transactions=6, client_id=0),
    ]
    if shape_rng.coinflip(0.5):
        workloads += [
            SerializabilityWorkload(
                db, rng.fork(), transactions=10, client_id=i, client_count=2
            )
            for i in range(2)
        ]
    if shape_rng.coinflip(0.5):
        workloads += [
            AtomicOpsWorkload(
                db, rng.fork(), transactions=12, client_id=i, client_count=2
            )
            for i in range(2)
        ]
    if shape_rng.coinflip(0.4):
        workloads.append(WatchesWorkload(db, rng.fork(), changes=8))
    if shape_rng.coinflip(0.3):
        workloads.append(BackupWorkload(db, rng.fork(), sim=sim, writes=15))
    if kills and cfg.replication > 1:
        workloads.append(
            AttritionWorkload(
                db,
                rng.fork(),
                sim=sim,
                kills=kills,
                interval=4.0,
                protect=set(cluster.coordinators),
            )
        )
    # the second chaos set (Rollback / RandomMoveKeys / ChangeConfig / disk
    # faults, fdbserver/workloads analogs) rotates in per seed
    if shape_rng.coinflip(0.4):
        workloads.append(
            RollbackWorkload(db, rng.fork(), sim=sim, clogs=2, duration=1.5)
        )
    if shape_rng.coinflip(0.3):
        workloads.append(
            RandomMoveKeysWorkload(db, rng.fork(), sim=sim, moves=2)
        )
    if shape_rng.coinflip(0.25):
        workloads.append(
            ChangeConfigWorkload(
                db, rng.fork(), coordinators=cluster.coordinators, changes=1
            )
        )
    if knobs.CONFLICT_FAULT_INJECTION:
        # oracle-parity ledger under kernel faults: exact-tally increments
        # must survive failover/journal-replay cycles (zero false commits)
        workloads.append(
            KernelChaosWorkload(db, rng.fork(), actors=2, increments=5)
        )
    if shape_rng.coinflip(0.3) and cfg.replication > 1:
        workloads.append(
            DiskFailureWorkload(
                db,
                rng.fork(),
                sim=sim,
                episodes=1,
                duration=1.5,
                p=0.03,
                disk_full=shape_rng.coinflip(0.3),
            )
        )
    workloads.append(
        ConsistencyCheckWorkload(db, rng.fork(), replication=cfg.replication)
    )
    # read-pipeline knobs draw LAST so the pinned seeds' shapes/workload
    # rotation above reproduce exactly; client knobs are consulted at
    # read time, so setting them after cluster construction is live
    knobs.randomize_read_pipeline(shape_rng)
    # admission-control draws ride at the very END of the sequence for
    # the same pinned-seed reason: overload burst arm +
    # queue/shed/tenant knob randomization. Admission knobs
    # are consulted live by proxies/ratekeeper at poll time. The
    # composition case — attrition + kernel fault injection + overload —
    # falls out whenever the earlier draws armed those too.
    overload = force_overload or shape_rng.coinflip(0.3)
    if overload:
        from ..workloads import OverloadBurstWorkload

        # insert BEFORE the trailing ConsistencyCheck (it must stay last)
        workloads.insert(
            len(workloads) - 1,
            OverloadBurstWorkload(db, rng.fork(), actors=4, txns=5),
        )
    knobs.randomize_admission(shape_rng)
    # transport draws ride at the VERY end of the sequence,
    # after the admission draws, for the same pinned-seed reason. When the
    # fault site arms, it rolls on a DEDICATED forked rng — the main chaos
    # stream stays byte-identical, so arming cannot reshuffle the run
    knobs.randomize_transport(shape_rng)
    if knobs.TRANSPORT_FAULT_INJECTION:
        # bounded chaos episodes (clogging-style): sustained loss on
        # recovery-critical RPCs would hold the epoch in a recovery storm
        # forever, a regime a real torn flush cannot produce
        trng = shape_rng.fork()
        windows = []
        t = 4.0
        for _ in range(2):
            t += trng.random01() * 15.0
            windows.append((t, t + 2.5))
            t += 10.0
        sim.arm_transport_faults(trng, p=0.02, windows=windows)
    # storage-engine draws are the NEW end of the sequence —
    # appended after every earlier draw so pinned seeds reproduce exactly.
    # STORAGE_EPOCH_BATCHING is consulted when a StorageServer CONSTRUCTS,
    # which in this soak happens inside the sim run (worker recruitment,
    # after these draws land) — so both engine personalities, the scan
    # leases, the pin-lag cap, and the storage-epoch-stall chaos site
    # (armed through the ordinary buggify machinery) all get exercised
    knobs.randomize_storage_engine(shape_rng)
    # watch/feed draws are the NEW end of the sequence — the
    # semantics oracle (zero lost/phantom triggers, feed byte-match) and
    # the fan-out storm rotate in against whatever chaos the earlier
    # draws armed (attrition/rollback/movekeys compose for free), and the
    # watch knob shrink (tiny watch limits / retention floors) draws
    # after every prior knob so pinned seeds reproduce exactly
    if shape_rng.coinflip(0.35):
        workloads.insert(
            len(workloads) - 1,
            WatchSemanticsWorkload(db, rng.fork(), actors=2, changes=6),
        )
    if shape_rng.coinflip(0.3):
        workloads.insert(
            len(workloads) - 1,
            WatchStormWorkload(db, rng.fork(), watchers=48, keys=6),
        )
    knobs.randomize_watches(shape_rng)
    # prefilter draws are the NEW end of the sequence. The
    # conservativeness oracle rides everywhere for free (every sim has a
    # PrefilterOracle; every pre-rejection is differentially re-proven),
    # but two dedicated rotations sharpen it: ConflictRangeWorkload
    # asserts EXACT conflict counts (a false rejection = hard failure,
    # a missed conflict too), and a hot-keyspace readwrite mix drives
    # the abort rate up so the filter actually fires under chaos. Knob
    # draws go both ways (on AND off legs in the matrix) with tiny-cap
    # shapes forcing the decay/eviction paths.
    if shape_rng.coinflip(0.35):
        workloads.insert(
            len(workloads) - 1,
            ConflictRangeWorkload(db, rng.fork(), rounds=10, keyspace=16),
        )
    if shape_rng.coinflip(0.3):
        from ..workloads.readwrite import ReadWriteWorkload

        workloads.insert(
            len(workloads) - 1,
            ReadWriteWorkload(
                db, rng.fork(), actors=6, txns_per_actor=10,
                reads_per_txn=4, writes_per_txn=2, keyspace=12,
                prefix=b"hot/",
            ),
        )
    knobs.randomize_prefilter(shape_rng)
    # commit-path draws are the NEW end of the sequence — after
    # randomize_prefilter, so every pinned seed's earlier draws reproduce
    # byte-identically. The codec and slab knobs toggle process-global
    # module state (net/wire.py, runtime/futures.py): the sim transport
    # passes objects by reference so the codec is inert here, but slab
    # settling regroups GRV/commit fan-out wakeups inside the sim, and the
    # fsync pipeline reorders the tlog's gate release — both must hold
    # their contracts (no early ack, no lost wakeups) under kill/rollback
    # chaos. Restored to defaults after the run so soak state never leaks
    # into the next seed or test.
    knobs.randomize_commit_path(shape_rng)
    # keyspace-telemetry draws are the NEW end of the sequence
    # — after randomize_commit_path, same pinned-seed rationale. Sampling
    # goes both ways so DD's waitMetrics sizing AND its range-scan
    # fallback both run under chaos; tiny sample factors densify the
    # byte sample, tiny history rings force eviction.
    knobs.randomize_storage_metrics(shape_rng)
    from ..net import wire as _wire
    from ..runtime import futures as _futures

    _wire.set_compiled_codec(bool(knobs.WIRE_COMPILED_CODEC))
    _futures.set_slab_settle(bool(knobs.FUTURE_SLAB_SETTLE))

    try:
        sim.run_until_done(spawn(run_workloads(workloads)), 1800.0)
    finally:
        _wire.set_compiled_codec(True)
        _futures.set_slab_settle(True)
    # zero false rejections: the prefilter oracle raises at
    # the offending rejection already; this catches a swallowed raise
    pf_oracle = sim.prefilter_oracle
    assert not pf_oracle.violations, pf_oracle.violations
    fired = len(sim.buggify.fired)
    sites = buggify_site_names(sim.buggify.fired)
    if verbose:
        print(
            f"seed {seed}: shape p{cfg.n_proxies} r{cfg.n_resolvers} "
            f"t{cfg.n_tlogs} s{cfg.n_storage}x{cfg.replication} "
            f"zones={n_zones} coords={n_coordinators} kills={kills} "
            f"backend={cfg.conflict_backend}"
            f"{' faults=on' if knobs.CONFLICT_FAULT_INJECTION else ''}"
            f"{' overload=on' if overload else ''} "
            f"buggify_fired={fired}"
        )
        kernel = [s for s in sites if s.startswith("kernel-")]
        if kernel:
            print(f"  kernel-fault sites fired: {', '.join(kernel)}")
    return {
        "seed": seed,
        "buggify_fired": fired,
        "buggify_sites": sites,
        "kernel_faults_armed": bool(knobs.CONFLICT_FAULT_INJECTION),
        "overload_armed": bool(overload),
        "prefilter_armed": bool(knobs.PROXY_CONFLICT_PREFILTER),
        "prefilter_rejections_checked": pf_oracle.rejections_checked,
        "commit_path_armed": {
            "compiled_codec": bool(knobs.WIRE_COMPILED_CODEC),
            "slab_settle": bool(knobs.FUTURE_SLAB_SETTLE),
            "fsync_pipeline": bool(knobs.TLOG_FSYNC_PIPELINE),
        },
        "storage_metrics_armed": {
            "sampling": bool(knobs.STORAGE_METRICS_SAMPLING),
            "byte_sample_factor": int(knobs.STORAGE_BYTE_SAMPLE_FACTOR),
            "wait_metrics_sizing": bool(knobs.DD_WAIT_METRICS_SIZING),
            "history_interval": float(knobs.METRICS_HISTORY_INTERVAL),
            "history_samples": int(knobs.METRICS_HISTORY_SAMPLES),
        },
        "workloads": [type(w).__name__ for w in workloads],
        "config": cfg.as_dict(),
    }


def mixed_soak(
    seed: int = 0,
    duration: float = 30.0,
    verbose: bool = False,
    epoch_batching=None,
    device=None,
) -> dict:
    """Sustained mixed soak: readwrite clients, bulk
    ingest, and a backup run CONCURRENTLY against a durable-engine sim
    cluster while the CC latency probe keeps timing reads. The claim under
    test is FLATNESS — reads pin O(1) snapshots and the epoch drain never
    blocks them, so the read-probe p95 of the run's last third must not
    grow away from the first third while ingest runs hot. Returns the
    per-third probe p95s plus the cluster's storage_engine roll-up.

    Run: python -m foundationdb_tpu_torch.tools.soak --mixed [duration] [seed]
    """
    from ..client import management
    from ..runtime.futures import delay
    from ..runtime.loop import Cancelled, now as model_now
    from ..workloads.readwrite import BulkLoadWorkload, ThroughputWorkload

    knobs = Knobs(LATENCY_PROBE_INTERVAL=0.25)
    if epoch_batching is not None:
        knobs.STORAGE_EPOCH_BATCHING = epoch_batching
    sim = Sim(seed=seed, knobs=knobs)
    sim.activate()
    cluster = DynamicCluster(
        sim, ClusterConfig(n_proxies=1, n_tlogs=1, n_storage=2), device=device
    )
    db = Database.from_coordinators(sim, cluster.coordinators)
    rng = sim.loop.random

    samples: list = []  # (model_time, latest read-probe seconds)
    last_status = [{}]
    done = [False]

    async def sampler():
        while not done[0]:
            await delay(0.25)
            try:
                doc = await management.get_status(
                    cluster.coordinators, db.client
                )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                continue
            last_status[0] = doc
            rp = (doc.get("latency_probe") or {}).get("read_seconds")
            if rp is not None:
                samples.append((model_now(), rp))

    clients = ThroughputWorkload(
        db,
        rng.fork(),
        duration=duration,
        actors=8,
        reads_per_txn=5,
        writes_per_txn=5,
        parallel_reads=True,
    )
    # ingest sized to the run length so the apply path stays hot end-to-end
    bulk = BulkLoadWorkload(
        db,
        rng.fork(),
        actors=4,
        txns_per_actor=max(10, int(duration * 6)),
        keys_per_txn=50,
    )
    backup = BackupWorkload(db, rng.fork(), sim=sim, writes=20)

    async def go():
        s = spawn(sampler())
        try:
            await run_workloads([clients, bulk, backup])
        finally:
            done[0] = True
            s.cancel()
        return True

    assert sim.run_until_done(spawn(go()), 36000.0)

    def p95(vals):
        if not vals:
            return None
        vals = sorted(vals)
        return round(vals[min(len(vals) - 1, int(len(vals) * 0.95))], 6)

    thirds: list = [[], [], []]
    if samples:
        t0, t1 = samples[0][0], samples[-1][0]
        span = (t1 - t0) or 1.0
        for t, v in samples:
            thirds[min(2, int((t - t0) / span * 3))].append(v)
    doc = last_status[0]
    se = (doc.get("workload") or {}).get("storage_engine") or {}
    out = {
        "seed": seed,
        "duration_model_s": duration,
        "probe_samples": len(samples),
        "read_p95_by_third": [p95(t) for t in thirds],
        "read_p95_overall": p95([v for t in thirds for v in t]),
        "epoch_batching": bool(knobs.STORAGE_EPOCH_BATCHING),
        "clients": clients.rec.report(),
        "bulkload_keys": bulk.rec.writes,
        "storage_engine": {
            k: (v.get("counter") if isinstance(v, dict) else v)
            for k, v in se.items()
        },
    }
    if verbose:
        print(
            f"mixed soak seed {seed}: {len(samples)} probe samples, read "
            f"p95 by third {out['read_p95_by_third']}, "
            f"{out['bulkload_keys']} bulk keys ingested, storage engine "
            f"{out['storage_engine']}"
        )
    return out


def watch_storm(
    watchers: int = 100_000,
    keys: int = 1_000,
    seed: int = 0,
    verbose: bool = False,
    device=None,
) -> dict:
    """The watch fan-out run: park ``watchers`` watches
    across ``keys`` keys from one client, read the parked-memory gauges
    off the status document, release every key, and require every watch
    to fire in version order. Evidence captured:

    - bounded memory: workload.watches parked_now/watch_bytes_now while
      fully parked (bytes/watch must stay O(key+value), not O(clients));
    - fan-out batching: watchesFired vs watchFanoutBatches (whole
      versions fire as one batch) and the transport messagesPerFrame
      ratio (same-tick replies to one client share super-frames);
    - notification latency: Client.watch / Storage.watchFire span p50/p99
      via tools/trace_analyze.critical_path on the sampled traces.

    Run: python -m foundationdb_tpu_torch.tools.soak --watch-storm [n] [seed]
    """
    from ..client import management
    from ..runtime.futures import wait_for_all
    from ..runtime.trace import trace_log
    from . import trace_analyze as ta

    # sample ~1k watch lifecycles: enough traces for a p99 without the
    # trace log dwarfing the run
    knobs = Knobs(TRACE_SAMPLE_RATE=min(1.0, 1000.0 / max(watchers, 1)))
    sim = Sim(seed=seed, knobs=knobs)
    sim.activate()
    cluster = DynamicCluster(
        sim, ClusterConfig(n_proxies=1, n_tlogs=1, n_storage=2), device=device
    )
    db = Database.from_coordinators(sim, cluster.coordinators)
    out: dict = {"watchers": watchers, "keys": keys, "seed": seed}

    def key(j: int) -> bytes:
        return b"storm/k%06d" % (j % keys)

    async def go():
        futs = []
        # register in batches: one transaction per 5k watchers (a single
        # 100k-watch txn would park the whole registration burst behind
        # one commit)
        for lo in range(0, watchers, 5000):
            hi = min(lo + 5000, watchers)

            async def park(tr, lo=lo, hi=hi):
                return [tr.watch(key(j)) for j in range(lo, hi)]

            futs.extend(await db.run(park))
        # let the registration actors drain (every future parked
        # server-side), then read the parked gauges off the status doc
        from ..runtime.futures import delay

        target = len(futs)
        while True:
            await delay(1.0)
            doc = await management.get_status(cluster.coordinators, db.client)
            wa = (doc.get("workload") or {}).get("watches") or {}
            parked = wa.get("parked_now") or 0
            if parked >= target:
                break
        out["parked_now"] = parked
        out["watch_bytes_now"] = wa.get("watch_bytes_now") or 0
        out["bytes_per_watch"] = round(out["watch_bytes_now"] / parked, 1)

        async def release(tr):
            for j in range(keys):
                tr.set(key(j), b"released")

        await db.run(release)
        await wait_for_all(futs)
        vals = {f.get() for f in futs}
        assert vals == {b"released"}, f"wrong fire values: {vals!r}"
        doc = await management.get_status(cluster.coordinators, db.client)
        wa = (doc.get("workload") or {}).get("watches") or {}
        out["fired"] = (wa.get("fired") or {}).get("counter")
        out["fanout_batches"] = (wa.get("fanout_batches") or {}).get("counter")
        out["registered"] = (wa.get("registered") or {}).get("counter")
        return True

    assert sim.run_until_done(spawn(go()), 7200.0)
    tm = sim.transport_metrics.snapshot()
    out["transport"] = {
        k: tm.get(k)
        for k in ("messagesSent", "framesSent", "messagesPerFrame")
    }
    cp = ta.critical_path(trace_log().events)
    for name in ("Client.watch", "Storage.watchFire"):
        agg = cp.get(name)
        if agg:
            out[name] = {
                "traces": agg["traces"],
                "p50_ms": agg["p50_ms"],
                "p99_ms": agg["p99_ms"],
            }
    if verbose:
        import json

        print(json.dumps(out, default=str, indent=1))
    return out


def buggify_site_names(fired) -> list:
    """Human-readable fired-site names for the coverage report: code sites
    render as `file.py:line`, named sites (the kernel-fault injector's)
    keep their tag."""
    names = []
    for site in fired:
        f, tag = site
        if isinstance(tag, int):
            names.append(f"{os.path.basename(str(f))}:{tag}")
        else:
            names.append(str(tag))
    return sorted(names)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    resolve_device()  # the soak runs on the card: none, no run
    if argv and argv[0] == "--mixed":
        import json

        duration = float(argv[1]) if len(argv) > 1 else 30.0
        seed = int(argv[2]) if len(argv) > 2 else 0
        out = mixed_soak(seed=seed, duration=duration, verbose=True)
        print(json.dumps(out, default=str))
        thirds = [p for p in out["read_p95_by_third"] if p is not None]
        # flatness gate: the last third must not run away from the first
        return 0 if (len(thirds) < 2 or thirds[-1] <= 3 * thirds[0]) else 1
    if argv and argv[0] == "--watch-storm":
        watchers = int(argv[1]) if len(argv) > 1 else 100_000
        seed = int(argv[2]) if len(argv) > 2 else 0
        out = watch_storm(watchers=watchers, seed=seed, verbose=True)
        return 0 if out.get("fired") else 1
    n = int(argv[0]) if argv else 20
    first = int(argv[1]) if len(argv) > 1 else 0
    failures = []
    coverage: dict[str, int] = {}  # fired site → runs that hit it
    for seed in range(first, first + n):
        try:
            out = run_one(seed, verbose=True)
        except Exception as e:  # noqa: BLE001 — report and continue
            failures.append((seed, repr(e)))
            print(f"seed {seed}: FAILED {e!r}")
        else:
            for s in set(out["buggify_sites"]):
                coverage[s] = coverage.get(s, 0) + 1
    print(f"{n - len(failures)}/{n} seeds green")
    if coverage:
        print(f"buggify coverage ({len(coverage)} sites fired):")
        for s, runs in sorted(coverage.items(), key=lambda kv: (-kv[1], kv[0])):
            print(f"  {s}: {runs}/{n} runs")
    for seed, err in failures:
        print(f"  repro: seed={seed} {err}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
