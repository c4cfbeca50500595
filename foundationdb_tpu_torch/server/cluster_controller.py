"""ClusterController: the elected singleton that owns cluster membership.

The analog of fdbserver/ClusterController.actor.cpp: worker registry with
lease-based failure detection (registrations double as heartbeats —
registrationClient re-registers every HEARTBEAT_INTERVAL and an entry
expires after FAILURE_TIMEOUT), master recruitment + respawn
(clusterWatchDatabase:985), ServerDBInfo broadcast to every worker, and the
client-facing openDatabase long-poll that serves the proxy list.

The CC runs *inside* a worker that won the coordinators' leader election
(coordination.try_become_leader); losing the leadership shuts it down.

The port's copy of ``foundationdb_tpu/server/cluster_controller.py``;
the status document's kernel-health roll-up ranks the guards with the
port's ``conflict/failover.py`` ``health_rank``.
"""

from __future__ import annotations

from ..net.sim import Endpoint
from ..runtime.futures import AsyncVar, delay, timeout
from ..runtime.knobs import Knobs
from ..runtime.buggify import buggify
from ..runtime.loop import Cancelled, now
from ..runtime.stats import CounterCollection
from ..runtime.trace import SevInfo, SevWarn, trace
from .interfaces import (
    ClientDBInfo,
    CommitRequest,
    GetKeyServersRequest,
    GetReadVersionRequest,
    GetValueRequest,
    GetWorkersReply,
    GetWorkersRequest,
    OpenDatabaseRequest,
    RecruitRoleRequest,
    RegisterWorkerRequest,
    ServerDBInfo,
    SetDBInfoRequest,
    Tokens,
    TransactionData,
    WorkerDetails,
)


class ClusterController:
    def __init__(self, process, coordinators, initial_config=None, knobs=None):
        self.process = process
        self.coordinators = coordinators
        self.initial_config = initial_config or {}
        self.knobs = knobs or Knobs()
        self.workers: dict[str, tuple[WorkerDetails, float]] = {}  # addr → (d, seen)
        self.db_info = AsyncVar(None)  # AsyncVar[ServerDBInfo]
        self._actors = []
        self._master_n = 0
        self._master_at: tuple = None  # (worker address, uid) of current master
        # forced region failover (force_recovery_with_data_loss analog):
        # sticky until a recovery under the override publishes its dbinfo,
        # so a master dying MID-failover-recovery doesn't lose the intent
        self._failover_to: str = None
        self._failover_master_uid: str = None  # recruited with the override
        # latency probes (Status.actor.cpp's latencyProbe: timed GRV, read,
        # and commit transactions against the live cluster, feeding the
        # status document's `latency_probe` section)
        self.probe_stats = CounterCollection("LatencyProbe", process.address)
        self._l_probe_grv = self.probe_stats.latency("grv")
        self._l_probe_read = self.probe_stats.latency("read")
        self._l_probe_commit = self.probe_stats.latency("commit")
        self._c_probe_ok = self.probe_stats.counter("probesCompleted")
        self._c_probe_err = self.probe_stats.counter("probeErrors")
        self._probe_latest: dict = {}
        self._probe_n = 0

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        p = self.process
        p.register(Tokens.CC_REGISTER_WORKER, self.register_worker)
        p.register(Tokens.CC_GET_WORKERS, self.get_workers)
        p.register(Tokens.CC_OPEN_DATABASE, self.open_database)
        p.register(Tokens.CC_SET_DB_INFO, self.set_db_info)
        p.register(Tokens.CC_GET_DB_INFO, self.get_db_info)
        p.register(Tokens.CC_GET_STATUS, self.get_status)
        p.register(Tokens.CC_FORCE_RECOVERY, self.force_recovery)
        p.register(Tokens.CC_FORCE_FAILOVER, self.force_failover)
        self._actors.append(p.spawn(self.cluster_watch_database()))
        self._actors.append(p.spawn(self._broadcast_loop()))
        self._actors.append(p.spawn(self._latency_probe_loop()))
        self._actors.append(
            p.spawn(
                self.probe_stats.trace_loop(
                    self.knobs.METRICS_TRACE_INTERVAL, p.address
                )
            )
        )

    def shutdown(self) -> None:
        for t in (
            Tokens.CC_REGISTER_WORKER,
            Tokens.CC_GET_WORKERS,
            Tokens.CC_OPEN_DATABASE,
            Tokens.CC_SET_DB_INFO,
            Tokens.CC_GET_DB_INFO,
            Tokens.CC_GET_STATUS,
            Tokens.CC_FORCE_RECOVERY,
            Tokens.CC_FORCE_FAILOVER,
        ):
            self.process.endpoints.pop(t, None)
        for a in self._actors:
            a.cancel()
        self._actors.clear()

    # -- worker registry --------------------------------------------------------

    async def register_worker(self, req: RegisterWorkerRequest):
        if buggify():
            await delay(0.01)  # slow registry (recruitment sees stale sets)
        self.workers[req.address] = (
            WorkerDetails(
                address=req.address,
                process_class=req.process_class,
                roles=req.roles,
                machine=getattr(req, "machine", ""),
                zone=getattr(req, "zone", ""),
                dc=getattr(req, "dc", "dc0"),
            ),
            now(),
        )
        return None

    def _alive_workers(self) -> list[WorkerDetails]:
        cutoff = now() - self.knobs.FAILURE_TIMEOUT
        return [d for d, seen in self.workers.values() if seen >= cutoff]

    async def get_workers(self, _req: GetWorkersRequest) -> GetWorkersReply:
        return GetWorkersReply(workers=self._alive_workers())

    # -- master recruitment + respawn (clusterWatchDatabase:985) ----------------

    async def cluster_watch_database(self):
        while True:
            workers = self._alive_workers()
            if not workers:
                await delay(self.knobs.HEARTBEAT_INTERVAL)
                continue
            # prefer: the primary region (the configured remote dc hosts
            # the master only when a failover targets it or nothing else
            # is left), then a stateless-class worker not already running
            # roles
            rdc = str(self.initial_config.get("remote_dc", "") or "")
            pref_dc = self._failover_to

            def in_secondary(w):
                if pref_dc:
                    return getattr(w, "dc", "") != pref_dc
                return bool(rdc) and getattr(w, "dc", "") == rdc

            workers.sort(
                key=lambda w: (
                    in_secondary(w),
                    w.process_class != "stateless",
                    len(w.roles),
                )
            )
            target = workers[0]
            self._master_n += 1
            uid = f"master-{self._master_n}-{self.process.sim.loop.random.random_int(0, 1 << 20)}"
            try:
                await timeout(
                    self.process.request(
                        Endpoint(target.address, Tokens.WORKER_RECRUIT),
                        RecruitRoleRequest(
                            role="master",
                            uid=uid,
                            params=dict(
                                coordinators=self.coordinators,
                                cc_address=self.process.address,
                                initial_config=dict(
                                    self.initial_config,
                                    **(
                                        {"failover_to": self._failover_to}
                                        if self._failover_to
                                        else {}
                                    ),
                                ),
                            ),
                        ),
                    ),
                    2.0,
                )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                await delay(self.knobs.HEARTBEAT_INTERVAL)
                continue
            trace(
                SevInfo,
                "RecruitedMaster",
                self.process.address,
                Worker=target.address,
                Uid=uid,
            )
            self._master_at = (target.address, uid)
            if self._failover_to:
                self._failover_master_uid = uid
            # watch it: the master's ping endpoint vanishes when it dies
            ping = Endpoint(target.address, f"master.ping#{uid}")
            misses = 0
            while misses < 3:
                await delay(self.knobs.HEARTBEAT_INTERVAL)
                try:
                    r = await timeout(
                        self.process.request(ping, None),
                        self.knobs.HEARTBEAT_INTERVAL * 3,
                    )
                    misses = 0 if r is not None else misses + 1
                except Cancelled:
                    raise  # actor-cancelled-swallow
                except Exception:
                    misses += 1
            trace(SevWarn, "MasterFailed", self.process.address, Uid=uid)

    # -- ServerDBInfo plumbing ---------------------------------------------------

    async def set_db_info(self, req: SetDBInfoRequest):
        cur = self.db_info.get()
        if cur is None or req.info.id > cur.id:
            self.db_info.set(req.info)
        if (
            self._failover_to is not None
            and req.info.master_uid == self._failover_master_uid
        ):
            # a recovery recruited WITH the override completed: done.
            # (An unrelated recovery finishing must NOT clear the intent.)
            self._failover_to = None
            self._failover_master_uid = None
        return None

    async def get_db_info(self, _req) -> ServerDBInfo:
        return self.db_info.get()

    async def _broadcast_loop(self):
        """Push ServerDBInfo to every live worker on change and on every
        heartbeat — a rebooted worker re-registers under the same address
        and must get the current info again (workers dedupe by id), so no
        per-address sent-cache here."""
        async def send_one(address, info):
            try:
                await timeout(
                    self.process.request(
                        Endpoint(address, Tokens.WORKER_SET_DB_INFO),
                        SetDBInfoRequest(info=info),
                    ),
                    1.0,
                )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                pass

        while True:
            info = self.db_info.get()
            if info is not None:
                # parallel: a dead-but-registered worker's timeout must not
                # serially delay everyone listed after it
                from ..runtime.futures import wait_for_all

                await wait_for_all(
                    [
                        self.process.spawn(send_one(d.address, info))
                        for d in self._alive_workers()
                    ]
                )
            change = self.db_info.on_change()
            await_any = [change, delay(self.knobs.HEARTBEAT_INTERVAL)]
            from ..runtime.futures import wait_for_any

            await wait_for_any(await_any)

    # -- operator actions --------------------------------------------------------

    async def force_failover(self, dc):
        """Forced region failover (fdbcli force_recovery_with_data_loss,
        fdbclient/ManagementAPI forceRecovery): promote the region ``dc``
        to primary. The next master recovery skips locking the (dead)
        primary tlog generation, determines the epoch end from the
        surviving LogRouters' relayed frontiers, and promotes the storage
        mirror — anything acked but never relayed is LOST, which is the
        operation's documented contract."""
        self._failover_to = str(dc)
        trace(
            SevInfo, "ForcedFailover", self.process.address, To=str(dc)
        )
        await self.force_recovery(None)
        return True

    async def force_recovery(self, _req):
        """Kill the current master role; the watch loop recruits a fresh
        one, which runs a full recovery (picking up config changes)."""
        if self._master_at is None:
            return False
        addr, uid = self._master_at
        try:
            await timeout(
                self.process.request(
                    Endpoint(addr, Tokens.WORKER_DESTROY_ROLE), uid
                ),
                2.0,
            )
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception:
            pass
        trace(SevInfo, "ForcedRecovery", self.process.address, Master=uid)
        return True

    # -- latency probes (Status.actor.cpp latencyProbe) --------------------------

    async def _latency_probe_loop(self):
        """Timed GRV / read / commit probes against the live cluster,
        round-robined over the current proxy set. Each leg is bounded;
        failures count (a stalled cluster shows up as probe_errors rising
        while the *_seconds numbers go stale) and never wedge the loop."""
        from ..kv.mutations import Mutation, MutationType

        probe_key = b"\xff\x02/status/probe/" + self.process.address.encode()
        while True:
            await delay(self.knobs.LATENCY_PROBE_INTERVAL)
            info = self.db_info.get()
            proxies = (
                list(info.client_info.proxies)
                if info is not None and info.client_info is not None
                else []
            )
            if not proxies:
                continue
            proxy = proxies[self._probe_n % len(proxies)]
            self._probe_n += 1
            budget = max(self.knobs.LATENCY_PROBE_INTERVAL, 1.0)
            latest = {}
            try:
                # GRV probe (the reference's transaction_start_seconds) at
                # IMMEDIATE priority: the probe is the evidence source for
                # overload behavior, so it must keep measuring while lower
                # classes are being shed (not be shed itself)
                from .admission import PRIORITY_IMMEDIATE

                t0 = now()
                grv = await timeout(
                    self.process.request(
                        proxy.ep("grv"),
                        GetReadVersionRequest(
                            priority=PRIORITY_IMMEDIATE, tenant=""
                        ),
                    ),
                    budget,
                )
                if grv is None:
                    raise TimeoutError("grv probe timed out")
                latest["grv_seconds"] = round(now() - t0, 6)
                self._l_probe_grv.add(now() - t0)
                version = grv.version

                # read probe: locate the probe key's team, read at the GRV
                # version (a missing key exercises the same path)
                t0 = now()
                loc = await timeout(
                    self.process.request(
                        proxy.ep("keyServers"),
                        GetKeyServersRequest(key=probe_key),
                    ),
                    budget,
                )
                if loc is None or not loc.team:
                    raise TimeoutError("key-location probe timed out")
                val = await timeout(
                    self.process.request(
                        Endpoint(loc.team[0], Tokens.GET_VALUE),
                        GetValueRequest(key=probe_key, version=version),
                    ),
                    budget,
                )
                if val is None:
                    raise TimeoutError("read probe timed out")
                latest["read_seconds"] = round(now() - t0, 6)
                self._l_probe_read.add(now() - t0)

                # commit probe: a blind write (no read conflict ranges →
                # never conflicts) of the probe key in the \xff\x02
                # keyspace — system-prefixed but NOT metadata, so it rides
                # the normal commit path end to end
                t0 = now()
                rep = await timeout(
                    self.process.request(
                        proxy.ep("commit"),
                        CommitRequest(
                            transaction=TransactionData(
                                read_snapshot=version,
                                read_conflict_ranges=[],
                                write_conflict_ranges=[
                                    (probe_key, probe_key + b"\x00")
                                ],
                                mutations=[
                                    Mutation(
                                        MutationType.SET_VALUE,
                                        probe_key,
                                        b"%d" % version,
                                    )
                                ],
                            )
                        ),
                    ),
                    budget,
                )
                if rep is None:
                    raise TimeoutError("commit probe timed out")
                latest["commit_seconds"] = round(now() - t0, 6)
                self._l_probe_commit.add(now() - t0)
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception as e:
                self._c_probe_err.add()
                trace(
                    SevWarn,
                    "LatencyProbeFailed",
                    self.process.address,
                    Err=repr(e),
                )
                continue
            self._c_probe_ok.add()
            latest["at"] = round(now(), 3)
            self._probe_latest = latest

    async def get_status(self, _req) -> dict:
        """The cluster status document (Status.actor.cpp's aggregation):
        topology from the registry, per-role metrics pulled from every
        worker's CounterCollections (workerEvents), qos from the master's
        ratekeeper, data/log health from role gauges."""
        info = self.db_info.get()
        workers = {}
        for d in self._alive_workers():
            workers[d.address] = {
                "class": d.process_class,
                "roles": list(d.roles),
                "machine": d.machine,
                "zone": d.zone,
                "dc": d.dc,
            }
        doc = {
            "cluster": {
                "controller": self.process.address,
                "recovery_count": info.recovery_count if info else 0,
                "recovered": info is not None,
                "master": info.master_address if info else None,
                "workers": workers,
                "coordinators": list(self.coordinators),
            },
            "data": {},
            "qos": {},
        }
        if info is not None and info.log_system is not None:
            ls = info.log_system
            doc["cluster"]["logs"] = {
                "epoch": ls.epoch,
                "current": [log.log_id for log in ls.current.logs],
                "old_generations": len(ls.old),
            }
            doc["client"] = {
                "proxies": [p.address for p in info.client_info.proxies]
            }

        # per-process role metrics (parallel pulls; a dead worker times out
        # without stalling the document)
        async def pull_one(address, token):
            try:
                return await timeout(
                    self.process.request(Endpoint(address, token), None), 1.0
                )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                return None

        async def pull(address):
            # concurrent + independent: one endpoint failing/slow must not
            # discard the other's answer
            mf = self.process.spawn(pull_one(address, "worker.metrics"))
            sf = self.process.spawn(
                pull_one(address, "worker.systemMetrics")
            )
            pf = self.process.spawn(pull_one(address, "process.metrics"))
            tf = self.process.spawn(pull_one(address, "transport.metrics"))
            return address, await mf, await sf, await pf, await tf

        from ..runtime.futures import wait_for_all

        pulls = await wait_for_all(
            [self.process.spawn(pull(a)) for a in workers]
        )
        # machine/process sections (Status.actor.cpp processStatus /
        # machineStatus): the SystemMonitor vitals per process, rolled up
        # per machine — plus the run-loop profiler snapshot per process
        # (slow tasks, per-priority starvation, hot actors; consumers
        # dedupe shared loops on `loop_id` — every sim process reports the
        # one loop they all share)
        processes = {}
        run_loop = {}
        transport = {}
        for address, metrics, sysm, proc, tm in pulls:
            if metrics:
                workers[address]["metrics"] = metrics
            if sysm:
                processes[address] = sysm
            if proc:
                run_loop[address] = proc
            if tm:
                transport[address] = tm
        doc["processes"] = processes
        doc["run_loop"] = run_loop
        # transport section: per-process counter snapshots plus
        # a cluster total — messages vs frames is the super-frame
        # coalescing ratio, loopback vs tcp the colocated-path split.
        # Sim processes share ONE world: dedupe identical snapshots by the
        # collection ident before summing (same move as run_loop loop_id)
        total = {
            k: 0
            for k in (
                "messagesSent",
                "messagesReceived",
                "framesSent",
                "framesReceived",
                "bytesSent",
                "bytesReceived",
                "loopbackMessages",
                "tcpMessages",
                "truncationFaults",
            )
        }
        seen_worlds = set()
        for snap in transport.values():
            ident = snap.get("id") or id(snap)
            if ident in seen_worlds:
                continue
            seen_worlds.add(ident)
            for k in total:
                total[k] += snap.get(k) or 0
        total["messagesPerFrame"] = (
            round(total["messagesSent"] / total["framesSent"], 2)
            if total["framesSent"]
            else 0.0
        )
        doc["transport"] = {"processes": transport, "total": total}
        machines: dict = {}
        for address, sysm in processes.items():
            mkey = workers[address].get("machine") or address
            m = machines.setdefault(
                mkey, {"processes": 0, "memory_kb": 0, "worst_run_loop_lag": 0.0}
            )
            m["processes"] += 1
            m["memory_kb"] += sysm.get("MemoryKB") or 0
            m["worst_run_loop_lag"] = max(
                m["worst_run_loop_lag"], sysm.get("RunLoopLag") or 0.0
            )
        doc["machines"] = machines

        # aggregate sections (Status.actor.cpp's qos/data summaries and the
        # workload section's started/committed/conflicted tps + ops/sec).
        # Gauges may snapshot as None on a transient error — treat as 0.
        def agg(kind: str, key: str) -> float:
            total = 0
            for w in workers.values():
                for snap in (w.get("metrics") or {}).values():
                    if snap.get("kind") == kind:
                        total += snap.get(key) or 0
            return total

        committed, durable = [], []
        resolvers = {}
        for addr, w in workers.items():
            for uid, snap in (w.get("metrics") or {}).items():
                kind = snap.get("kind")
                if kind == "storage":
                    committed.append(snap.get("version") or 0)
                    durable.append(snap.get("durableVersion") or 0)
                elif kind == "resolver":
                    # per-resolver section incl. the device kernel counters
                    # (occupancy / overflow replays / transfer bytes)
                    resolvers[uid] = dict(snap, address=addr)
        doc["resolvers"] = resolvers
        # conflict-kernel health roll-up (worst state wins): failover is an
        # operator-page event, so it surfaces at the top level instead of
        # only inside per-resolver kernel sections
        from ..conflict.failover import health_rank

        kernel = {
            "state": "HEALTHY",
            "failovers": 0,
            "retries": 0,
            "deadline_hits": 0,
            "promotions": 0,
            "device_rebuilds": 0,
        }
        saw_kernel = False
        for snap in resolvers.values():
            h = (snap.get("kernel") or {}).get("health") or {}
            if not h:
                continue
            saw_kernel = True
            if health_rank(h.get("state")) > health_rank(kernel["state"]):
                kernel["state"] = h.get("state")
            kernel["failovers"] += h.get("failovers") or 0
            kernel["retries"] += h.get("retries") or 0
            kernel["deadline_hits"] += h.get("deadlineHits") or 0
            kernel["promotions"] += h.get("promotions") or 0
            kernel["device_rebuilds"] += h.get("deviceRebuilds") or 0
        if saw_kernel:
            doc["kernel"] = kernel
        if committed:
            doc["data"] = {
                "max_storage_version": max(committed),
                "min_durable_version": min(durable),
                "storage_version_spread": max(committed) - min(committed),
            }

        def tx(key: str) -> dict:
            return {
                "counter": agg("proxy", key),
                "hz": round(agg("proxy", key + "_hz"), 2),
            }

        def sq(key: str) -> dict:
            return {
                "counter": agg("storage", key),
                "hz": round(agg("storage", key + "_hz"), 2),
            }

        # per-endpoint latency-band histograms (FDB's LatencyBands),
        # summed across every role of a kind (stats.LatencyBands.merge)
        from ..runtime.stats import LatencyBands

        def band_agg(kind: str, key: str) -> dict:
            snaps = []
            for w in workers.values():
                for snap in (w.get("metrics") or {}).values():
                    if snap.get("kind") == kind:
                        snaps.append(snap.get(key))
            return LatencyBands.merge(snaps)

        # commit abort rate: conflicts as a share of
        # resolved commit attempts — the contention signal the prefilter
        # bench sweeps used to be the only witness of. Prefiltered txns
        # count in txnConflicts too (same client-visible not_committed).
        _committed = agg("proxy", "txnCommitOut")
        _conflicted = agg("proxy", "txnConflicts")
        doc["workload"] = {
            "transactions": {
                "started": tx("txnStartIn"),
                "committed": tx("txnCommitOut"),
                "conflicted": tx("txnConflicts"),
                "too_old": tx("txnTooOld"),
                "commit_batches": tx("commitBatchesOut"),
            },
            "abort_rate": (
                round(_conflicted / (_committed + _conflicted), 4)
                if (_committed + _conflicted) > 0
                else 0.0
            ),
            # conflict pre-filter: doomed txns rejected at the
            # proxy before the batch; checks/feedback are the probe and
            # learning rates
            "prefiltered": tx("prefiltered"),
            "prefilter": {
                "checks": tx("prefilterChecks"),
                "feedback_ranges": tx("prefilterFeedbackRanges"),
            },
            "operations": {
                "reads": sq("finishedQueries"),
                "rows_read": sq("rowsQueried"),
                "bytes_read": sq("bytesQueried"),
                "writes": tx("mutations"),
                "bytes_written": tx("mutationBytes"),
                # read pipeline: reads that arrived batched
                # (multiGet/multiGetRange entries) and the batch rate —
                # reads_batched/reads is the coalescing ratio
                "reads_batched": sq("multiGetKeys"),
                "multiget_batches": sq("multiGetBatches"),
                "multiget_range_batches": sq("multiGetRangeBatches"),
                "index_reads": sq("multiGetIndexKeys"),
                "index_fallbacks": sq("multiGetFallbackKeys"),
            },
            # epoch-batched storage engine: batch-apply and
            # snapshot-pin evidence; oldest_pinned_age_seconds is the
            # WORST across storages (one overstaying pin is the signal)
            "storage_engine": {
                "epochs_applied": sq("epochsApplied"),
                "epoch_mutations": sq("epochMutations"),
                "range_tombstones": sq("rangeTombstones"),
                "snapshots_pinned": sq("snapshotsPinned"),
                "pinned_now": agg("storage", "pinnedSnapshots"),
                "oldest_pinned_age_seconds": max(
                    (
                        snap.get("oldestPinnedAgeSeconds") or 0
                        for w in workers.values()
                        for snap in (w.get("metrics") or {}).values()
                        if snap.get("kind") == "storage"
                    ),
                    default=0,
                ),
            },
            # tlog durability: physical fsync rounds vs group
            # joins is the write-coalescing ratio ((rounds+joins)/rounds
            # commits per physical fsync); pipeline_depth is the high-water
            # count of commits overlapped behind an in-flight fsync round
            "tlog": {
                "fsync_rounds": agg("tlog", "fsyncRounds"),
                "group_joins": agg("tlog", "groupJoins"),
                "fsync_seconds": round(agg("tlog", "fsyncSeconds"), 3),
                "pipeline_depth": agg("tlog", "pipelineDepth"),
            },
            # watches + change feeds: fan-out evidence.
            # parked/bytes are CURRENT totals across storages (gauges);
            # fired/batches ratio is the per-version fan-out batching
            "watches": {
                "registered": sq("watchesRegistered"),
                "fired": sq("watchesFired"),
                "cancelled": sq("watchesCancelled"),
                "fanout_batches": sq("watchFanoutBatches"),
                "feed_entries_streamed": sq("feedEntriesStreamed"),
                "parked_now": agg("storage", "watchesParked"),
                "watch_bytes_now": agg("storage", "watchBytes"),
            },
            "latency_bands": {
                "grv": band_agg("proxy", "grvLatencyBands"),
                "commit": band_agg("proxy", "commitLatencyBands"),
                "read": band_agg("storage", "readLatencyBands"),
                "resolve": band_agg("resolver", "resolveLatencyBands"),
            },
            # keyspace telemetry: cluster-wide hottest ranges
            # (each storage's hotRanges gauge is its local top-N; merged
            # and re-ranked by read÷size density here) plus byte-sample
            # and waitMetrics-subscription evidence
            "hot_ranges": sorted(
                (
                    dict(r, storage=uid)
                    for w in workers.values()
                    for uid, snap in (w.get("metrics") or {}).items()
                    if snap.get("kind") == "storage"
                    for r in (snap.get("hotRanges") or [])
                ),
                key=lambda r: r.get("density") or 0,
                reverse=True,
            )[:5],
            "byte_sampling": {
                "bytes_sampled": sq("bytesSampled"),
                "sample_entries": agg("storage", "sampleEntries"),
                "hot_range_checks": sq("hotRangeChecks"),
                "wait_metrics_active": agg("storage", "waitMetricsActive"),
                "wait_metrics_fired": sq("waitMetricsFired"),
            },
        }
        txn_out = _committed
        conflicts = _conflicted
        ops = agg("storage", "finishedQueries")
        doc["qos"] = {
            "transactions_committed_total": txn_out,
            "conflicts_total": conflicts,
            "storage_finished_queries_total": ops,
            # admission control: total GRVs shed with
            # grv_throttled, plus the per-class admitted traffic
            "throttled_total": agg("proxy", "grvThrottled"),
            "throttled_per_class": {
                c: agg("proxy", "grvThrottled" + c.capitalize())
                for c in ("batch", "default", "immediate")
            },
            "admitted_per_class": {
                c: {
                    "counter": agg("proxy", "txnStart" + c.capitalize()),
                    "hz": round(
                        agg("proxy", "txnStart" + c.capitalize() + "_hz"), 2
                    ),
                }
                for c in ("batch", "default", "immediate")
            },
        }
        # per-tenant admission roll-up (top-N by traffic across proxies)
        tenants: dict = {}
        for w in workers.values():
            for snap in (w.get("metrics") or {}).values():
                if snap.get("kind") != "proxy":
                    continue
                for tenant, s in (snap.get("tenants") or {}).items():
                    agg_t = tenants.setdefault(
                        tenant, {"admitted": 0, "throttled": 0}
                    )
                    agg_t["admitted"] += s.get("admitted") or 0
                    agg_t["throttled"] += s.get("throttled") or 0
        if tenants:
            top = sorted(
                tenants.items(),
                key=lambda kv: -(kv[1]["admitted"] + kv[1]["throttled"]),
            )[: self.knobs.RK_STATUS_TENANTS]
            doc["qos"]["tenants"] = dict(top)
        if committed:
            worst_lag = max(v - d for v, d in zip(committed, durable))
            doc["qos"]["worst_storage_durability_lag_versions"] = worst_lag
            doc["qos"]["limiting"] = (
                "storage_durability_lag"
                if worst_lag > self.knobs.RK_LAG_TARGET
                else "workload"
            )
        # ratekeeper's released per-class rates (master.getRate#uid); its
        # limiting factor (the multi-signal controller's) wins over the
        # local lag heuristic above
        if info is not None and info.master_address:
            try:
                rate = await timeout(
                    self.process.request(
                        Endpoint(
                            info.master_address,
                            f"master.getRate#{info.master_uid}",
                        ),
                        None,
                    ),
                    1.0,
                )
                if isinstance(rate, dict):
                    doc["qos"]["released_transactions_per_second"] = rate.get(
                        "released"
                    )
                    doc["qos"]["released_per_class"] = {
                        k: round(v, 2)
                        for k, v in (rate.get("cluster") or {}).items()
                    }
                    if rate.get("limiting"):
                        doc["qos"]["limiting"] = rate["limiting"]
                elif rate is not None:
                    doc["qos"]["released_transactions_per_second"] = rate
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                pass

        # latency probes: freshest timed GRV/read/commit plus percentile
        # stats over the probe history (Status.actor.cpp latency_probe)
        probe = dict(self._probe_latest)
        probe["probes_completed"] = self._c_probe_ok.value
        probe["probe_errors"] = self._c_probe_err.value
        for pname, sample in self.probe_stats.samples.items():
            probe[pname + "_stats"] = sample.snapshot()
        doc["latency_probe"] = probe
        return doc

    # -- client openDatabase -----------------------------------------------------

    async def open_database(self, req: OpenDatabaseRequest) -> ClientDBInfo:
        while True:
            info = self.db_info.get()
            if info is not None and info.client_info.id != req.known_id:
                return info.client_info
            await self.db_info.on_change()
