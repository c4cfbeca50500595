"""Worker: the process shell that hosts roles on recruitment.

The analog of fdbserver/worker.actor.cpp: every fdbd process runs a worker
that (a) campaigns for cluster controllership (tryBecomeLeader — in the
reference the worker's monitorLeader/candidacy split), (b) registers itself
with the elected CC and keeps the registration alive (registrationClient:253
— the lease doubles as failure detection), (c) instantiates roles when the
CC or master asks (workerServer:481, role dispatch :693-794), and (d)
receives ServerDBInfo broadcasts, garbage-collecting role instances from
dead epochs.

Storage roles are immortal here (they carry data); everything else belongs
to an epoch and is destroyed once the recovery_count moves past it — except
tlogs, which live until no generation in the log-system config references
them (old generations serve storage catch-up after recovery).

The port's copy of ``foundationdb_tpu/server/worker.py``. The device is
the worker's: ``Worker(..., device=None)`` passes it to every resolver
and storage server it recruits (``None`` = the CUDA card), since it is a
property of the machine and no recruitment message carries it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..net.sim import Endpoint
from ..runtime.futures import AsyncVar, delay, timeout
from ..runtime.knobs import Knobs
from ..runtime.buggify import buggify
from ..runtime.trace import SevInfo, SevWarn, trace
from .coordination import LeaderInfo, monitor_leader, try_become_leader
from .interfaces import (
    RecruitRoleReply,
    RecruitRoleRequest,
    RegisterWorkerRequest,
    SetDBInfoRequest,
    Tokens,
)
from ..runtime.loop import Cancelled


@dataclass
class _RoleHandle:
    kind: str
    uid: str
    epoch: int = 0
    tokens: list = field(default_factory=list)
    actors: list = field(default_factory=list)
    obj: object = None


def _note_device(h, snap: dict) -> None:
    """Name the device a role's kernels run on in its status snapshot: a
    resolver's conflict backend in its ``kernel`` section (``device``:
    ``cuda``, ``cpu``, or ``host`` for a backend without one, such as
    ``native`` after a failover), a storage server's range index as
    ``indexDevice`` (None while it has no index) and whether that index
    has caught up with its engine's keys (``indexCurrent``: the test by
    which ``StorageServer._multi_get_at`` answers from the index rather
    than the engine, false while it has none or mid-rebuild, as after a
    restart until its first durability advance); and this process's
    kernel launches since it started (``launches`` of the resolver's
    section, the K5 ``indexLaunches`` of a storage server), which count
    only on the card; and, where the role is on the card, the card memory
    this process's tensors hold (``cardMemory``: the allocator's
    ``allocated`` and ``reserved`` bytes, without the CUDA context), else
    None. Only the status pull carries them; the role's counters and trace
    events are the reference's."""
    from ..conflict.kernels import launch_counts

    if h.kind == "resolver" and isinstance(snap.get("kernel"), dict):
        primary = getattr(h.obj.cs, "primary", None)
        dev = getattr(primary, "_device", None)
        kind = getattr(dev, "type", "host")
        devices = getattr(primary, "_devices", [dev] if dev is not None else [])
        snap["kernel"] = dict(snap["kernel"], device=kind, launches=launch_counts(),
                              cardMemory=_card_memory(devices))
    elif h.kind == "storage":
        index = getattr(h.obj, "_range_index", None)
        snap["indexDevice"] = None if index is None else index._codes.device.type
        engine = getattr(h.obj, "engine", None)
        snap["indexCurrent"] = index is not None and engine is not None and index.n == len(engine._keys)
        snap["indexLaunches"] = launch_counts()["search"]
        snap["cardMemory"] = _card_memory([] if index is None else [index._codes.device])


def _card_memory(devices) -> dict:
    """The card memory this process's tensors hold on the cards among
    ``devices`` (a spread resolver's are several), summed over the
    distinct cards; None where none is a card."""
    import torch

    cards = {torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
             for d in devices if d.type == "cuda"}
    if not cards:
        return None
    return {"allocated": sum(torch.cuda.memory_allocated(d) for d in cards),
            "reserved": sum(torch.cuda.memory_reserved(d) for d in cards)}


class Worker:
    def __init__(
        self,
        process,
        coordinators: list[str],
        process_class: str = "unset",
        initial_config: dict = None,
        can_be_cc: bool = True,
        knobs: Knobs = None,
        device=None,  # every resolver's and storage server's: None = the card
    ):
        self.process = process
        self.device = device
        self.coordinators = coordinators
        self.process_class = process_class
        self.initial_config = initial_config or {}
        self.can_be_cc = can_be_cc
        self.knobs = knobs or process.sim.knobs
        self.db_info = AsyncVar(None)  # ServerDBInfo broadcast
        self.log_config = AsyncVar(None)  # LogSystemConfig for storage roles
        self.router_config = AsyncVar(None)  # router set for REMOTE storage
        self.leader = AsyncVar(None)  # LeaderInfo of the current CC
        self.roles: dict[str, _RoleHandle] = {}
        self._cc = None  # ClusterController when we hold the leadership

    # -- boot ------------------------------------------------------------------

    def start(self) -> None:
        p = self.process
        p.worker = self  # test/ops introspection (the worker IS the process)
        self.disk = p.sim.disk(p.machine)
        p.register(Tokens.WORKER_RECRUIT, self.recruit)
        p.register(Tokens.WORKER_SET_DB_INFO, self.set_db_info)
        p.register(Tokens.WORKER_PING, self._ping)
        p.register(Tokens.WORKER_DESTROY_ROLE, self._destroy_role_req)
        p.register("worker.metrics", self._role_metrics)
        p.register("worker.metricsHistory", self._metrics_history)
        p.register("worker.systemMetrics", self._system_metrics)
        p.register("process.metrics", self._process_metrics)
        p.register("transport.metrics", self._transport_metrics)
        p.spawn(self._history_loop())
        from ..runtime.loop import current_loop
        from ..runtime.monitor import system_monitor

        p.spawn(system_monitor(p, interval=2.0))
        prof = getattr(current_loop(), "profiler", None)
        if prof is not None:
            # periodic RunLoopMetrics trace events; the profiler hands the
            # loop to exactly ONE worker (sim processes share a loop)
            p.spawn(
                prof.ensure_trace_loop(
                    self.knobs.METRICS_TRACE_INTERVAL, p.address
                )
            )
        p.spawn(self._rescan_disk())  # reboot: resurrect durable roles
        p.spawn(monitor_leader(p, self.coordinators, self.leader))
        p.spawn(self._registration_client())
        if self.can_be_cc:
            p.spawn(self._cc_campaign())

    # -- durable-role resurrection (worker.actor.cpp's data-dir scan) -----------

    async def _rescan_disk(self):
        import json

        for name in self.disk.list():
            if not name.startswith("manifest-"):
                continue
            f = self.disk.open(name)
            try:
                m = json.loads((await f.read(0, f.size())).decode())
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                continue
            if m["uid"] in self.roles:
                continue
            params = dict(m["params"])
            params["recover"] = True
            trace(
                SevInfo,
                "ResurrectingRole",
                self.process.address,
                Kind=m["kind"],
                Uid=m["uid"],
            )
            await self.recruit(
                RecruitRoleRequest(role=m["kind"], uid=m["uid"], params=params)
            )

    async def _write_manifest(self, kind: str, uid: str, params: dict):
        import json

        f = self.disk.open(f"manifest-{uid}")
        blob = json.dumps({"kind": kind, "uid": uid, "params": params}).encode()
        await f.truncate(0)
        await f.write(0, blob)
        await f.sync()

    async def _ping(self, _req):
        return "pong"

    async def _process_metrics(self, _req) -> dict:
        """Run-loop profiler snapshot for this process's loop (the
        `process.metrics` endpoint behind the status document's `run_loop`
        section and `cli top`) — per-actor busy attribution, per-priority
        starvation bands, slow-task counts."""
        from ..runtime.loop import current_loop

        prof = getattr(current_loop(), "profiler", None)
        return prof.snapshot() if prof is not None else {}

    async def _transport_metrics(self, _req) -> dict:
        """This process's transport counters (net/metrics.py): messages vs
        frames (the super-frame coalescing ratio), loopback/tcp split,
        buffer compaction — the status document's `transport` section and
        the `cli status` Transport line."""
        tm = getattr(self.process.sim, "transport_metrics", None)
        return tm.snapshot() if tm is not None else {}

    async def _system_metrics(self, _req) -> dict:
        """The SystemMonitor's latest ProcessMetrics sample (status's
        machine/process sections, Status.actor.cpp's processStatus)."""
        return dict(getattr(self.process, "last_process_metrics", {}) or {})

    async def _role_metrics(self, _req) -> dict:
        """Snapshot every hosted role's CounterCollection — the status
        aggregator's per-process pull (Status.actor.cpp's workerEvents).
        Counters also report `*_hz` interval rates over the current
        metric-trace interval (the status document's tps/ops-per-second
        workload section divides nothing itself), once enough of the
        interval has elapsed for the rate to mean anything."""
        from ..runtime.loop import now

        out = {}
        for uid, h in self.roles.items():
            stats = getattr(h.obj, "stats", None)
            if stats is not None:
                elapsed = None
                last = getattr(stats, "_last_trace", None)
                if last is not None:
                    dt = now() - last
                    if dt > 0.5:
                        elapsed = dt
                snap = stats.snapshot(elapsed)
                snap["kind"] = h.kind
                _note_device(h, snap)
                out[uid] = snap
        return out

    async def _history_loop(self):
        """Feed every hosted role's metrics-history ring
        (runtime/timeseries.py) at the knob-set cadence. One loop covers
        all roles — roles recruited later simply gain their ring on the
        next tick (worker-hosted storage runs via run(), not register(),
        so there is no double-recording)."""
        from ..runtime.futures import delay
        from ..runtime.loop import now

        if not getattr(self.knobs, "METRICS_HISTORY_ENABLED", True):
            return
        interval = float(self.knobs.METRICS_HISTORY_INTERVAL)
        capacity = int(self.knobs.METRICS_HISTORY_SAMPLES)
        while True:
            await delay(interval)
            t = now()
            for h in self.roles.values():
                stats = getattr(h.obj, "stats", None)
                if stats is not None:
                    stats.ensure_history(capacity)
                    stats.record_history(t)

    async def _metrics_history(self, _req) -> dict:
        """Every hosted role's metrics-history ring: uid → {kind, points}
        (the timeline source behind `cli metrics` and trace_analyze
        --timeline's live mode)."""
        out = {}
        for uid, h in self.roles.items():
            stats = getattr(h.obj, "stats", None)
            hist = getattr(stats, "history", None) if stats is not None else None
            if hist is None:
                continue
            d = hist.to_dict()
            d["kind"] = h.kind
            out[uid] = d
        return out

    async def _destroy_role_req(self, uid: str):
        """Operator-driven role destruction (the CC's forceRecovery)."""
        self._destroy(uid)
        return True

    # -- registration (registrationClient, worker.actor.cpp:253) ---------------

    async def _registration_client(self):
        registered_with = None  # CC address we last confirmed registration to
        while True:
            leader = self.leader.get()
            if leader is not None:
                try:
                    await timeout(
                        self.process.request(
                            Endpoint(leader.address, Tokens.CC_REGISTER_WORKER),
                            RegisterWorkerRequest(
                                address=self.process.address,
                                process_class=self.process_class,
                                roles=tuple(h.kind for h in self.roles.values()),
                                machine=self.process.locality.machine,
                                zone=self.process.locality.zone,
                                dc=self.process.locality.dc,
                            ),
                        ),
                        self.knobs.HEARTBEAT_INTERVAL * 2,
                    )
                    if registered_with != leader.address:
                        registered_with = leader.address
                        trace(
                            SevInfo,
                            "WorkerRegistered",
                            self.process.address,
                            CC=leader.address,
                            Class=self.process_class,
                        )
                except Cancelled:
                    raise  # actor-cancelled-swallow
                except Exception:
                    pass
            await delay(
                self.knobs.HEARTBEAT_INTERVAL * (2 if buggify() else 1)
            )  # missed heartbeats: flirt with the failure detector

    # -- CC candidacy ----------------------------------------------------------

    async def _cc_campaign(self):
        from .cluster_controller import ClusterController

        change_id = 0
        while True:
            change_id += 1
            info = LeaderInfo(
                address=self.process.address,
                priority=1 if self.process_class == "stateless" else 0,
                change_id=self.process.sim.loop.random.random_int(1, 1 << 30)
                * 4
                + self.process.reboots % 4,
            )
            leadership = await try_become_leader(
                self.process, self.coordinators, info
            )
            trace(SevInfo, "BecameClusterController", self.process.address)
            cc = ClusterController(
                self.process,
                self.coordinators,
                initial_config=self.initial_config,
                knobs=self.knobs,
            )
            self._cc = cc
            cc.start()
            await leadership.lost
            trace(SevWarn, "LostClusterControllership", self.process.address)
            cc.shutdown()
            self._cc = None

    # -- ServerDBInfo broadcast -------------------------------------------------

    async def set_db_info(self, req: SetDBInfoRequest):
        info = req.info
        cur = self.db_info.get()
        if cur is not None and info.id <= cur.id:
            return None
        self.db_info.set(info)
        self.log_config.set(info.log_system)
        if info.log_routers is not None:
            self.router_config.set(info.log_routers)
        self._gc_roles(info)
        return None

    def _gc_roles(self, info) -> None:
        """Destroy role instances from epochs before info.recovery_count;
        tlogs live while any generation references their log_id."""
        live_logs = set()
        for cfg in (info.log_system, info.log_routers):
            if cfg is not None:
                for log in cfg.current.logs:
                    live_logs.add(log.log_id)
                for old in cfg.old:
                    for log in old.set.logs:
                        live_logs.add(log.log_id)
        for uid, h in list(self.roles.items()):
            if h.kind == "storage":
                continue
            if h.kind in ("tlog", "log_router"):
                if h.uid not in live_logs and h.epoch < info.recovery_count:
                    self._destroy(uid)
            elif h.epoch < info.recovery_count:
                self._destroy(uid)

    def _destroy(self, uid: str) -> None:
        h = self.roles.pop(uid, None)
        if h is None:
            return
        for token in h.tokens:
            self.process.endpoints.pop(token, None)
        # roles may register uid-suffixed endpoints asynchronously after
        # recruitment returned (the master does, mid-recovery) — sweep them
        for token in [t for t in self.process.endpoints if t.endswith(f"#{uid}")]:
            self.process.endpoints.pop(token, None)
        if getattr(self, "disk", None) is not None:
            # a destroyed role's durable state must not be resurrected on
            # the next reboot (a leftover storage manifest would make the
            # reboot's _rescan_disk recruit TWO storage roles and fail)
            self.disk.remove(f"manifest-{uid}")
            if h.kind == "tlog":
                for name in list(self.disk.list()):
                    if name.startswith(f"tlog-{uid}."):
                        self.disk.remove(name)
        for a in h.actors:
            a.cancel()
        close = getattr(h.obj, "close", None)
        if close is not None:
            try:
                close()  # release non-actor resources (device threads)
            except Exception:
                pass
        trace(
            SevInfo, "RoleDestroyed", self.process.address, Kind=h.kind, Uid=h.uid
        )

    # -- recruitment (workerServer role dispatch :693-794) ----------------------

    async def recruit(self, req: RecruitRoleRequest) -> RecruitRoleReply:
        if buggify():
            await delay(0.01)  # slow recruitment (stretches recovery)
        if req.uid in self.roles:
            return RecruitRoleReply(address=self.process.address, uid=req.uid)
        maker = getattr(self, f"_make_{req.role}", None)
        assert maker is not None, f"unknown role {req.role!r}"
        before = set(self.process.endpoints)
        h = _RoleHandle(kind=req.role, uid=req.uid)
        self.roles[req.uid] = h
        maker(h, **req.params)
        h.tokens = [t for t in self.process.endpoints if t not in before]
        trace(
            SevInfo,
            "RoleRecruited",
            self.process.address,
            Kind=req.role,
            Uid=req.uid,
        )
        return RecruitRoleReply(address=self.process.address, uid=req.uid)

    # one _make_* per role kind; each registers endpoints + spawns actors
    # into the handle so _destroy can unwind them.

    def _spawn(self, h: _RoleHandle, coro):
        fut = self.process.spawn(coro)
        h.actors.append(fut)
        return fut

    def _make_tlog(
        self,
        h,
        epoch=0,
        tags=None,
        first_version=0,
        recover=False,
        consumers=("ss",),
    ):
        from .tlog import TLog

        if isinstance(tags, list):
            tags = frozenset(tags)
        tl = TLog(
            self.knobs,
            tags=tags,
            epoch=epoch,
            log_id=h.uid,
            first_version=first_version,
            disk=self.disk,
            consumers=tuple(consumers),
        )
        h.epoch, h.obj = epoch, tl
        self._spawn(
            h,
            tl.stats.trace_loop(
                self.knobs.METRICS_TRACE_INTERVAL, self.process.address
            ),
        )
        if recover:
            # serve only after the DiskQueue replay: a peek against an
            # empty index would understate this replica's durable version
            async def recover_then_serve():
                await tl.recover()
                tl.register_instance(self.process)

            self._spawn(h, recover_then_serve())
        else:
            # the manifest must be durable BEFORE the tlog can ack a
            # commit — otherwise a kill in the window leaves acked data
            # on disk that reboot never resurrects (no manifest, no role)
            async def manifest_then_serve():
                await self._write_manifest(
                    "tlog",
                    h.uid,
                    dict(
                        epoch=epoch,
                        tags=sorted(tags) if tags is not None else None,
                        first_version=first_version,
                        consumers=list(consumers),
                    ),
                )
                tl.register_instance(self.process)

            self._spawn(h, manifest_then_serve())

    def _make_log_router(self, h, tags=(), epoch=0, first_version=0):
        from .log_router import LogRouter

        lr = LogRouter(
            self.knobs,
            tags=tuple(tags),
            epoch=epoch,
            uid=h.uid,
            log_config=self.log_config,
            first_version=first_version,
        )
        h.epoch, h.obj = epoch, lr
        lr.register_instance(self.process)
        for t in lr.tags:
            self._spawn(h, lr._pull(t))
        self._spawn(
            h,
            lr.stats.trace_loop(
                self.knobs.METRICS_TRACE_INTERVAL, self.process.address
            ),
        )

    def _make_resolver(self, h, backend="torch", first_version=0, epoch=0):
        from .resolver import Resolver

        r = Resolver(
            self.knobs,
            backend=backend,
            first_version=first_version,
            uid=h.uid,
            device=self.device,
        )
        h.epoch, h.obj = epoch, r
        r.register_instance(self.process)
        self._spawn(
            h,
            r.stats.trace_loop(
                self.knobs.METRICS_TRACE_INTERVAL, self.process.address
            ),
        )

    def _make_proxy(
        self,
        h,
        master=None,
        resolver_map=None,
        log_system=None,
        shards=None,
        epoch=0,
        recovery_version=0,
        log_ranges=None,
        peers=None,
    ):
        from .proxy import Proxy

        pr = Proxy(
            master=master,
            resolver_map=resolver_map,
            log_system=log_system,
            shards=shards,
            knobs=self.knobs,
            epoch=epoch,
            recovery_version=recovery_version,
            uid=h.uid,
            log_ranges=log_ranges,
            peers=peers,
        )
        h.epoch, h.obj = epoch, pr
        pr.register_instance(self.process)
        self._spawn(h, pr.batcher_loop())
        self._spawn(h, pr.rate_poller())
        self._spawn(h, pr.admission.pump())
        self._spawn(
            h,
            pr.stats.trace_loop(
                self.knobs.METRICS_TRACE_INTERVAL, self.process.address
            ),
        )

    def _make_storage(
        self, h, tag=0, ranges=None, recover=False, seed=False, remote=False
    ):
        from .storage import StorageServer

        # storage keeps well-known data tokens: strictly one per process
        # (a second would shadow the first's endpoints)
        others = [x for x in self.roles.values() if x.kind == "storage" and x is not h]
        if others and seed:
            # first-recovery seeding displaces a stale seed role left by a
            # racing same-generation master — but ONLY a role that has
            # never applied a mutation (version 0): a delayed seed recruit
            # arriving after the racing winner's recovery completed must
            # not destroy a storage that holds live data. (A full fix
            # would thread the master's coordination generation through
            # recruitment; version-0 covers the bug class determinedly
            # hit in sim — both losers die before any commit lands.)
            empty = [
                x
                for x in others
                if getattr(getattr(x.obj, "version", None), "get", lambda: 1)() == 0
                and getattr(x.obj, "durable_version", 1) == 0
            ]
            if len(empty) == len(others):
                for x in others:
                    trace(
                        SevWarn,
                        "SeedStorageDisplaced",
                        self.process.address,
                        Old=x.uid,
                        New=h.uid,
                    )
                    self._destroy(x.uid)
                others = []
        if others:
            del self.roles[h.uid]
            raise RuntimeError(f"{self.process.address} already hosts storage")
        if ranges is not None and ranges and isinstance(ranges[0][0], str):
            ranges = [
                (
                    bytes.fromhex(b),
                    bytes.fromhex(e) if e is not None else None,
                )
                for b, e in ranges
            ]
        def peer_for_tag(t):
            info = self.db_info.get()
            if info is None:
                return None
            for s in info.remote_storage:
                if s.tag == t:
                    return s.address
            return None

        ss = StorageServer(
            tag=tag,
            # a REMOTE-region storage follows the LogRouter set (tlog-
            # shaped relays of the primary's streams) instead of the
            # primary tlogs directly (LogRouter.actor.cpp topology)
            log_config=self.router_config if remote else self.log_config,
            knobs=self.knobs,
            uid=h.uid,
            owned_ranges=ranges if ranges is not None else [],
            disk=self.disk,
            peer_for_tag=peer_for_tag if remote else None,
            device=self.device,
        )
        h.obj = ss
        ss.register_endpoints(self.process)
        self._spawn(
            h,
            ss.stats.trace_loop(
                self.knobs.METRICS_TRACE_INTERVAL, self.process.address
            ),
        )
        if recover:
            self._spawn(h, ss.run())
        else:
            # manifest first: once running, a durability advance pops the
            # tlogs — data a reboot could only recover through the manifest
            async def manifest_then_run():
                await self._write_manifest(
                    "storage",
                    h.uid,
                    dict(
                        tag=tag,
                        remote=remote,
                        ranges=[
                            [b.hex(), e.hex() if e is not None else None]
                            for b, e in (ranges or [])
                        ],
                    ),
                )
                await ss.run()

            self._spawn(h, manifest_then_run())

    def _make_master(self, h, coordinators=None, cc_address="", initial_config=None):
        from .master import MasterTerminated, master_core

        async def run():
            try:
                await master_core(
                    self.process,
                    h.uid,
                    coordinators or self.coordinators,
                    cc_address,
                    initial_config or self.initial_config,
                )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception as e:
                trace(
                    SevWarn,
                    "MasterTerminated",
                    self.process.address,
                    Uid=h.uid,
                    Reason=repr(e),
                )
            finally:
                # master endpoints must vanish so the CC's ping sees death
                self._destroy(h.uid)

        h.epoch = 1 << 60  # destroyed by its own exit or GC on recovery bump
        self._spawn(h, run())
