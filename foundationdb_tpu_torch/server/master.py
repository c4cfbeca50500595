"""Master role: version assignment, committed-version tracking, and the
recovery state machine.

The analog of fdbserver/masterserver.actor.cpp. Two halves:

- ``Master`` — the version authority (getVersion:763 / provideVersions:830
  and liveCommittedVersion bookkeeping): hands out strictly increasing
  (prev_version, version) pairs per commit batch; the prev→version chain is
  what lets resolvers and tlogs apply batches in version order with no
  other coordination (Resolver.actor.cpp:104-122). Versions advance with
  wall (virtual) time at VERSIONS_PER_SECOND so they double as coarse
  timestamps, like the reference.

- ``master_core`` — the recovery state machine (masterCore:1077-1240):
    READING_CSTATE    read prior DBCoreState via coordinator majority
    LOCKING_CSTATE    lock the prior tlog generation; its epoch-end
                      version (min durable over locked replicas) becomes
                      the recovery version
    RECRUITING        new tlogs/resolvers/proxies on workers from the CC
                      (+ seed storage servers on a brand-new database)
    RECOVERY_TXN      initialize the new systems at the recovery version
    WRITING_CSTATE    fence: write the new generation into the coordinated
                      state (a newer recovery attempt wins here)
    FULLY_RECOVERED   publish ServerDBInfo through the CC; then keep
                      watching role failures (any death ⇒ master dies ⇒
                      the CC recruits a successor ⇒ recovery again) and
                      dropping old tlog generations once every storage
                      server has caught up (trackTlogRecovery:1009).

The port's copy of ``foundationdb_tpu/server/master.py``, with every
draw, buggify site, trace event and reply the same. One default differs:
a configuration without ``conflict_backend`` recruits ``torch``
resolvers (the card), as the port's ``ClusterConfig`` does, where the
reference falls back to the host ``oracle``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..kv.keyrange_map import KeyRangeMap
from ..runtime.futures import delay, wait_for_all
from ..runtime.loop import Cancelled, now
from ..runtime.buggify import buggify
from ..runtime.trace import SevInfo, SevWarn, trace
from .coordination import ClusterStateChanged, CoordinatedState
from .interfaces import (
    ClientDBInfo,
    GetCommitVersionReply,
    GetCommitVersionRequest,
    GetReadVersionReply,
    GetWorkersRequest,
    MasterInterface,
    ProxyInterface,
    RecruitRoleRequest,
    ReportRawCommittedVersionRequest,
    ResolverInterface,
    ServerDBInfo,
    SetDBInfoRequest,
    StorageInterface,
    Tokens,
)
from .log_system import (
    LogSystemConfig,
    OldTLogSet,
    TLogInterface,
    TLogSet,
    assign_tags,
    epoch_end_version,
    lock_tlog_set,
)
from ..net.sim import Endpoint

VERSIONS_PER_SECOND = 1_000_000
MAX_VERSION_JUMP = 10 * VERSIONS_PER_SECOND


class Master:
    def __init__(self, first_version: int = 0, uid: str = "", knobs=None):
        self.uid = uid
        self.knobs = knobs
        self.last_assigned = first_version
        self.last_assigned_at = 0.0
        self.live_committed = first_version
        # per-proxy requestNum sequencing (masterserver.actor.cpp:316
        # getVersion): a proxy pipelines several version requests; the
        # network may reorder them, but versions must be assigned in
        # submission order or the proxy's batch-order/version-order
        # invariant (phase 3) breaks
        self._req_seq: dict[str, int] = {}
        self._parked: dict[tuple, object] = {}  # (proxy, num) → Future
        # resolutionBalancing (masterserver.actor.cpp:216,806): pending
        # boundary moves, attached to every proxy's version grants until
        # the proxy ACKS the changes version in a later request — a lost
        # grant reply must not lose the delivery
        self._resolver_changes: tuple = ()
        self._resolver_changes_version: int = 0
        self._changes_proxy_ids: list = []
        self._changes_acked: dict[str, int] = {}

    def set_resolver_changes(self, moves, proxy_ids) -> bool:
        """Record boundary moves [(begin, end, iface)]; they reach every
        proxy piggybacked on version grants and apply from the next
        version. Refused (False) while a previous set is still being
        delivered — the balancer retries next interval."""
        if self._resolver_changes and any(
            self._changes_acked.get(p, 0) < self._resolver_changes_version
            for p in self._changes_proxy_ids
        ):
            return False
        self._changes_proxy_ids = list(proxy_ids)
        self._resolver_changes = tuple(moves)
        self._resolver_changes_version = self.last_assigned + 1
        return True

    # -- handlers --------------------------------------------------------------

    async def get_commit_version(
        self, req: GetCommitVersionRequest
    ) -> GetCommitVersionReply:
        if buggify():
            await delay(0.001)  # slow version assignment (phase-1 stall)
        if req.request_num >= 0:
            from ..runtime.futures import Future, timeout as _timeout

            expected = self._req_seq.get(req.requesting_proxy, 0)
            if req.request_num < expected:
                # a predecessor was skipped after its request was lost
                # (partition drops requests on the floor); assigning now
                # would violate the proxy's version-order invariant
                raise RuntimeError(
                    f"stale version request {req.request_num} < {expected}"
                )
            if req.request_num != expected:
                # arrived early: park until predecessors are assigned —
                # bounded, because a partition may have dropped a
                # predecessor outright; on expiry, abandon the gap (the
                # proxy's batch for the lost request fails on its own)
                gate: Future = Future()
                key = (req.requesting_proxy, req.request_num)
                self._parked[key] = gate
                fired = await _timeout(
                    gate,
                    getattr(
                        self.knobs, "MASTER_VERSION_GAP_TIMEOUT", 4.0
                    ),
                )
                self._parked.pop(key, None)
                if fired is None and self._req_seq.get(
                    req.requesting_proxy, 0
                ) > req.request_num:
                    raise RuntimeError("superseded while parked")
            self._req_seq[req.requesting_proxy] = req.request_num + 1
        prev = self.last_assigned
        t = now()
        advance = int((t - self.last_assigned_at) * VERSIONS_PER_SECOND)
        advance = max(1, min(advance, MAX_VERSION_JUMP))
        self.last_assigned = prev + advance
        self.last_assigned_at = t
        if req.request_num >= 0:
            nxt = self._parked.pop(
                (req.requesting_proxy, req.request_num + 1), None
            )
            if nxt is not None:
                nxt._set(True)  # truthy: distinguishes wake from timeout
        changes, changes_v = (), 0
        if req.requesting_proxy:
            acked = self._changes_acked.get(req.requesting_proxy, 0)
            if req.applied_changes_version > acked:
                acked = self._changes_acked[req.requesting_proxy] = (
                    req.applied_changes_version
                )
            if self._resolver_changes and acked < self._resolver_changes_version:
                changes = self._resolver_changes
                changes_v = self._resolver_changes_version
        return GetCommitVersionReply(
            prev_version=prev,
            version=self.last_assigned,
            resolver_changes=changes,
            resolver_changes_version=changes_v,
        )

    async def report_committed(self, req: ReportRawCommittedVersionRequest):
        if req.version > self.live_committed:
            self.live_committed = req.version
        return None

    async def get_live_committed(self, _req) -> GetReadVersionReply:
        return GetReadVersionReply(version=self.live_committed)

    async def _ping(self, _req):
        return "pong"

    # -- wiring ----------------------------------------------------------------

    def register(self, process) -> None:
        process.register(Tokens.GET_COMMIT_VERSION, self.get_commit_version)
        process.register(Tokens.REPORT_COMMITTED, self.report_committed)
        process.register(Tokens.GET_LIVE_COMMITTED, self.get_live_committed)

    def register_instance(self, process) -> None:
        process.register(
            f"{Tokens.GET_COMMIT_VERSION}#{self.uid}", self.get_commit_version
        )
        process.register(f"{Tokens.REPORT_COMMITTED}#{self.uid}", self.report_committed)
        process.register(
            f"{Tokens.GET_LIVE_COMMITTED}#{self.uid}", self.get_live_committed
        )
        process.register(f"master.ping#{self.uid}", self._ping)


# -- the coordinated core state (DBCoreState, fdbserver/DBCoreState.h) ---------


@dataclass
class DBCoreState:
    recovery_count: int = 0
    tlog_set: TLogSet = None  # current generation
    old_tlog_sets: tuple = ()  # tuple[OldTLogSet]
    recovery_version: int = 0  # current generation starts above this
    storage: tuple = ()  # tuple[StorageInterface]
    shards: tuple = ()  # tuple[(begin, end, addrs, tags)]
    config: dict = field(default_factory=dict)  # cluster shape knobs
    log_ranges: dict = field(default_factory=dict)  # active backup captures
    # multi-region: the remote region's router generation + its immortal
    # remote storage mirrors (seeded once, like primary storage)
    router_set: TLogSet = None
    old_router_sets: tuple = ()  # tuple[OldTLogSet]
    remote_storage: tuple = ()  # tuple[StorageInterface]


class MasterTerminated(Exception):
    """This master's tenure is over (fenced, or a role it recruited died)."""


async def _router_frontier(process, router_set: TLogSet) -> int:
    """Failover epoch end: min over every surviving router's relayed
    frontier — every tag has relayed through at least that version, so
    the promoted mirror's history (routers + applied state) is complete
    below it. Retries until every router answers (they live in the
    surviving region; one mid-restart must not lose its tags' tail)."""
    if router_set is None:
        raise MasterTerminated("failover without a router generation")
    for _ in range(40):
        try:
            versions = []
            for log in router_set.logs:
                v = await process.request(
                    Endpoint(log.address, f"router.version#{log.log_id}"),
                    None,
                )
                versions.append(int(v))
            return min(versions)
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception:
            await delay(0.5)
    # a surviving-region router is permanently gone: die so the CC
    # recruits a successor (the failover override is sticky there) —
    # wedging here would leave a master that pings healthy forever
    raise MasterTerminated("failover: router frontier unreachable")


async def master_core(process, uid: str, coordinators, cc_address, initial_config):
    """The whole master lifetime: recovery, then service until failure.
    Raises MasterTerminated/ClusterStateChanged when a successor must be
    recruited; the worker deregisters our endpoints then."""
    from .proxy import Proxy, ShardMap
    from .log_system import LogSystem
    from .interfaces import TLogPeekRequest
    from .systemdata import TXS_TAG, apply_metadata_mutations

    # the CC failure-detects us from the moment of recruitment — the ping
    # endpoint must exist before any slow recovery step, or a recovery
    # taking longer than the CC's miss budget looks like a dead master
    async def _pong(_req):
        return "pong"

    process.register(f"master.ping#{uid}", _pong)

    # READING_CSTATE
    cs = CoordinatedState(process, coordinators)
    prev: DBCoreState = await cs.read()
    recovery_count = (prev.recovery_count + 1) if prev else 1
    config = dict(initial_config or {})
    if prev:
        config = dict(prev.config)
    # forced region failover (force_recovery_with_data_loss): the CC
    # passes the surviving dc; this recovery promotes it to primary
    failover_to = str((initial_config or {}).get("failover_to", "") or "")
    if failover_to and prev and prev.remote_storage:
        config["remote_dc"] = ""
        config["primary_dc"] = failover_to
        # sticky: every later epoch publishes log_routers mirroring the
        # primary log system, because the promoted (remote-wired) storage
        # follows router_config forever
        config["failover_promoted"] = "1"
    else:
        failover_to = ""
    trace(
        SevInfo,
        "MasterRecoveryState",
        process.address,
        State="reading_cstate_done",
        RecoveryCount=recovery_count,
        Failover=failover_to,
    )

    # LOCKING_CSTATE: fence the prior generation, find the recovery version
    old_sets: list[OldTLogSet] = []
    recovery_version = 0
    locks: dict = {}
    if prev and failover_to:
        # the primary region (its tlogs included) is presumed dead: the
        # epoch end comes from the surviving LogRouters' relayed
        # frontiers instead of tlog locks. Anything acked at the primary
        # but never relayed is LOST — the operation's documented
        # contract; the failover drill converges the mirror first so the
        # sim durability oracle still passes.
        recovery_version = await _router_frontier(process, prev.router_set)
        oracle = getattr(getattr(process, "sim", None), "validation", None)
        if oracle is not None:
            # data-loss failover: acked commits the routers never relayed
            # are FORFEITED by contract — record that instead of asserting
            # (the drill proves the converged case separately)
            oracle.forfeit_above(recovery_version)
            oracle.check_recovery(recovery_version, recovery_count)
        # the promoted epoch's history lives in the routers: they serve
        # tlog-shaped peeks for everything the mirror hasn't applied yet
        old_sets = [o for o in prev.old_router_sets]
        if prev.router_set is not None:
            old_sets.append(
                OldTLogSet(set=prev.router_set, end_version=recovery_version)
            )
        trace(
            SevInfo,
            "MasterRecoveryState",
            process.address,
            State="failover_frontier",
            RecoveryVersion=recovery_version,
        )
    elif prev:
        locks = await lock_tlog_set(process, prev.tlog_set, recovery_count)
        recovery_version = epoch_end_version(locks)
        known = max(r.known_committed for r in locks.values())
        assert recovery_version >= known, "epoch end below a committed version"
        # sim-only durability oracle: the end version must cover every
        # commit ever ACKED to a client (sim_validation.h:38
        # debug_checkMinCommittedVersion analog)
        oracle = getattr(getattr(process, "sim", None), "validation", None)
        if oracle is not None:
            oracle.check_recovery(recovery_version, recovery_count)
        old_sets = [o for o in prev.old_tlog_sets]
        old_sets.append(OldTLogSet(set=prev.tlog_set, end_version=recovery_version))
        trace(
            SevInfo,
            "MasterRecoveryState",
            process.address,
            State="locked",
            RecoveryVersion=recovery_version,
        )

    # RECRUITING — wait for the worker registry to stabilize (registration
    # is lease-based; right after CC election it is still filling up)
    workers, prev_count = [], -1
    while True:
        reply = await process.request(
            Endpoint(cc_address, Tokens.CC_GET_WORKERS), GetWorkersRequest()
        )
        workers = [w for w in reply.workers if w.address != ""]
        enough = prev and workers
        if not prev:
            enough = len(workers) >= int(config.get("n_storage", 1))
        if enough and len(workers) == prev_count:
            break
        prev_count = len(workers)
        await delay(0.6)
    # primary roles never land in the remote dc (the remote region hosts
    # only routers + the storage mirror)
    _rdc = str(config.get("remote_dc", "") or "")
    _pdc = str(config.get("primary_dc", "") or "")
    if _pdc:
        # post-failover: transaction roles live in the promoted region
        primary_workers = [
            w for w in workers if getattr(w, "dc", "") == _pdc
        ] or workers
    elif _rdc:
        primary_workers = [w for w in workers if getattr(w, "dc", "") != _rdc]
    else:
        primary_workers = workers
    picker = _RolePicker(primary_workers, avoid={process.address})

    # storage: seeded once on a brand-new database, then immortal.
    # The live shard map = the coordinated-state snapshot + the txs-tag
    # deltas logged since (readTransactionSystemState — the reference's
    # txnStateStore recovery from the log system). Conf mutations in the
    # same stream update `config` — so this must run BEFORE the shape
    # counts below are read (configure → forced recovery → new shape).
    log_ranges: dict = {}
    if prev:
        storage = list(prev.storage)
        shard_map = ShardMap.from_list(prev.shards)
        log_ranges = dict(prev.log_ranges)
        from .systemdata import CONF_PREFIX
        from ..kv.mutations import MutationType

        for log in prev.tlog_set.logs:
            if log.log_id not in locks:
                continue
            try:
                reply = await process.request(
                    log.ep("peek"), TLogPeekRequest(tag=TXS_TAG, begin=1)
                )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                continue
            from .systemdata import apply_log_range_mutations

            for v, muts in reply.messages:
                if v <= recovery_version:
                    apply_metadata_mutations(shard_map, muts)
                    apply_log_range_mutations(log_ranges, muts)
                    for m in muts:
                        # configuration changes committed since the last
                        # recovery shape THIS one (configure → recovery)
                        if (
                            m.type == MutationType.SET_VALUE
                            and m.param1.startswith(CONF_PREFIX)
                            and not m.param1.startswith(CONF_PREFIX + b"excluded/")
                        ):
                            name = m.param1[len(CONF_PREFIX) :].decode()
                            config[name] = m.param2.decode()
            break  # txs rides every tlog; any locked one is complete
        shards = shard_map.to_list()
        if failover_to:
            # promote the mirror: the remote storage interfaces become
            # THE storage. The shard map is rebuilt from the MIRRORS' OWN
            # applied ownership, not the coordinated snapshot — shard
            # moves committed since the last recovery relayed to the
            # mirrors with the data, and the stale snapshot would point
            # moved ranges at the wrong tag.
            by_tag = {s.tag: s for s in prev.remote_storage}
            storage = [by_tag[t] for t in sorted(by_tag)]
            promoted_shards = []
            from ..kv.keyrange_map import KeyRangeMap as _KRM

            cover = _KRM(default=None)
            for t in sorted(by_tag):
                s = by_tag[t]
                owned = await process.request(
                    Endpoint(s.address, f"storage.ownedRanges#{s.uid}"),
                    None,
                )
                for b, e in owned:
                    cover.insert(b, e, ((s.address,), (t,)))
            # gaps (a move mid-flight when the region died) fall back to
            # the snapshot's assignment, re-pointed tag-for-tag
            for b, e, _addrs, tags in shards:
                for gb, ge, v in cover.intersecting(b, e):
                    if v is None:
                        cover.insert(
                            gb,
                            ge,
                            (
                                tuple(by_tag[t].address for t in tags),
                                tags,
                            ),
                        )
            for b, e, v in cover.ranges():
                if v is not None:
                    promoted_shards.append((b, e, v[0], v[1]))
            shards = promoted_shards
            shard_map = ShardMap.from_list(shards)

    n_storage = int(config.get("n_storage", 1))
    n_tlogs = int(config.get("n_tlogs", 1))
    n_resolvers = int(config.get("n_resolvers", 1))
    n_proxies = int(config.get("n_proxies", 1))
    replication = int(config.get("replication", 1))
    tlog_replication = int(config.get("tlog_replication", 1))
    backend = config.get("conflict_backend", "torch")

    if not prev:
        storage, shards = await _seed_storage(
            process, picker, n_storage, replication, uid
        )
        shard_map = ShardMap.from_list(shards)

    remote_dc = _rdc
    # more routers than storage tags would leave tagless routers whose
    # relayed version never advances — clamp
    n_routers = max(1, min(int(config.get("n_log_routers", 1)), n_storage))

    # new tlog generation (uids carry the master uid: a failed prior
    # attempt at this recovery_count must not collide)
    tlog_workers = picker.pick("tlog", n_tlogs)
    log_ids = [f"log-{recovery_count}-{i}-{uid}" for i in range(n_tlogs)]
    logs = assign_tags(
        [w.address for w in tlog_workers],
        log_ids,
        n_storage,
        tlog_replication,
        zones=[getattr(w, "zone", "") for w in tlog_workers],
    )
    await wait_for_all(
        [
            process.request(
                Endpoint(log.address, Tokens.WORKER_RECRUIT),
                RecruitRoleRequest(
                    role="tlog",
                    uid=log.log_id,
                    params=dict(
                        epoch=recovery_count,
                        tags=frozenset(log.tags),
                        first_version=recovery_version,
                        # router pops keep an independent frontier so a
                        # lagging remote region pins tlog data
                        consumers=("ss", "router") if remote_dc else ("ss",),
                    ),
                ),
            )
            for log in logs
        ]
    )
    tlog_set = TLogSet(
        epoch=recovery_count, logs=tuple(logs), replication=tlog_replication
    )

    # resolvers
    resolver_workers = picker.pick("resolver", n_resolvers)
    resolver_ifaces = []
    for i, w in enumerate(resolver_workers):
        r_uid = f"res-{recovery_count}-{i}-{uid}"
        await process.request(
            Endpoint(w.address, Tokens.WORKER_RECRUIT),
            RecruitRoleRequest(
                role="resolver",
                uid=r_uid,
                params=dict(
                    backend=backend,
                    first_version=recovery_version,
                    epoch=recovery_count,
                ),
            ),
        )
        resolver_ifaces.append(ResolverInterface(address=w.address, uid=r_uid))

    # RECOVERY_TXN: initialize version authority at the recovery version
    master = Master(
        first_version=recovery_version, uid=uid, knobs=process.sim.knobs
    )
    master.register_instance(process)
    master_iface = MasterInterface(address=process.address, uid=uid)

    # proxies (they need everything above; each copies the shard map)
    resolver_map = KeyRangeMap()
    rbounds = [b""] + _split_points(n_resolvers) + [None]
    for i, iface in enumerate(resolver_ifaces):
        resolver_map.insert(rbounds[i], rbounds[i + 1], iface)

    proxy_workers = picker.pick("proxy", n_proxies)
    proxy_ifaces = []
    # full peer list up front: every proxy confirms GRVs against every
    # other proxy's raw committed version (getLiveCommittedVersion,
    # MasterProxyServer.actor.cpp:875-885)
    peer_list = [
        (w.address, f"proxy-{recovery_count}-{i}-{uid}")
        for i, w in enumerate(proxy_workers)
    ]
    for i, w in enumerate(proxy_workers):
        p_uid = peer_list[i][1]
        await process.request(
            Endpoint(w.address, Tokens.WORKER_RECRUIT),
            RecruitRoleRequest(
                role="proxy",
                uid=p_uid,
                params=dict(
                    master=master_iface,
                    resolver_map=resolver_map,
                    log_system=LogSystem(tlog_set),
                    shards=shard_map,
                    epoch=recovery_count,
                    recovery_version=recovery_version,
                    log_ranges=log_ranges,
                    peers=peer_list,
                ),
            ),
        )
        proxy_ifaces.append(ProxyInterface(address=w.address, uid=p_uid))

    # multi-region: recruit this epoch's LogRouter set on remote-dc
    # workers; seed the remote storage mirror on first recovery
    # (LogRouter.actor.cpp:391 topology — remote region pulls the
    # primary's streams asynchronously through routers)
    router_set = None
    old_router_sets: tuple = ()
    remote_storage: tuple = ()
    if remote_dc:
        if prev:
            remote_storage = tuple(prev.remote_storage)
        remote_workers = [w for w in workers if getattr(w, "dc", "") == remote_dc]
        if len(remote_workers) < max(n_routers, 1):
            raise MasterTerminated(
                f"remote dc {remote_dc!r} has too few workers"
            )
        rpicker = _RolePicker(remote_workers, avoid={process.address})
        router_workers = rpicker.pick("tlog", n_routers)
        router_logs = []
        for i, w in enumerate(router_workers):
            r_uid = f"router-{recovery_count}-{i}-{uid}"
            rtags = tuple(t for t in range(n_storage) if t % n_routers == i)
            await process.request(
                Endpoint(w.address, Tokens.WORKER_RECRUIT),
                RecruitRoleRequest(
                    role="log_router",
                    uid=r_uid,
                    params=dict(
                        tags=rtags,
                        epoch=recovery_count,
                        # start from 0, not the recovery version: the
                        # primary tlogs retain exactly what the remote
                        # region hasn't acked (the router consumer pop
                        # frontier), so a replacement router backfills
                        # everything a dead predecessor relayed-but-
                        # unapplied or never relayed — starting at the
                        # recovery version would skip commits made
                        # between the old router's death and the fence
                        first_version=0,
                    ),
                ),
            )
            router_logs.append(
                TLogInterface(address=w.address, log_id=r_uid, tags=rtags)
            )
        router_set = TLogSet(
            epoch=recovery_count, logs=tuple(router_logs), replication=1
        )
        # "old" router generations exist only so remote storage learns
        # rollback boundaries and the cursor clamps at epoch ends —
        # routers are STATELESS relays (replacements backfill from the
        # primary's router-consumer retention), so every old entry points
        # at the NEW router logs. A dead old router can never wedge the
        # mirror the way a dead old tlog generation would.
        if prev:
            prior = list(prev.old_router_sets) + (
                [OldTLogSet(set=prev.router_set, end_version=recovery_version)]
                if prev.router_set is not None
                else []
            )
            old_router_sets = tuple(
                OldTLogSet(
                    set=TLogSet(
                        epoch=o.set.epoch,
                        logs=tuple(router_logs),
                        replication=1,
                    ),
                    end_version=o.end_version,
                )
                for o in prior
            )
        if not remote_storage:
            # first recovery: seed the remote mirror — storage tag t in
            # the remote dc owns the same ranges as primary tag t
            storage_workers = sorted(
                (w for w in remote_workers if w.process_class == "storage"),
                key=lambda w: w.address,
            )
            assert len(storage_workers) >= n_storage, (
                "remote dc needs n_storage storage-class workers"
            )
            seeded = []
            for t in range(n_storage):
                w = storage_workers[t]
                s_uid = f"rss-{t}"
                ranges = [
                    (b, e) for b, e, _a, tags in shards if t in tags
                ]
                await process.request(
                    Endpoint(w.address, Tokens.WORKER_RECRUIT),
                    RecruitRoleRequest(
                        role="storage",
                        uid=s_uid,
                        params=dict(
                            tag=t, ranges=ranges, seed=True, remote=True
                        ),
                    ),
                )
                seeded.append(
                    StorageInterface(address=w.address, uid=s_uid, tag=t)
                )
            remote_storage = tuple(seeded)

    # WRITING_CSTATE: fence. After this, the new generation is THE database.
    core = DBCoreState(
        recovery_count=recovery_count,
        tlog_set=tlog_set,
        old_tlog_sets=tuple(old_sets),
        recovery_version=recovery_version,
        storage=tuple(storage),
        shards=tuple(shards),
        config=config,
        log_ranges=dict(log_ranges),
        router_set=router_set,
        old_router_sets=old_router_sets,
        remote_storage=remote_storage,
    )
    await cs.write(core)  # raises ClusterStateChanged if a successor fenced us

    # The cstate snapshot now subsumes the old generations' txs streams
    # (shards/config were rebuilt from them above), so release them: pop
    # TXS_TAG on every old tlog — the analog of the reference popping the
    # txnStateStore tag once the recovered state is durably coordinated.
    # Best-effort: a dead old tlog's txs data dies with it anyway.
    from .interfaces import TLogPopRequest

    if not failover_to:  # failover old sets are routers: no txs stream
        for old in old_sets:
            for log in old.set.logs:
                process.spawn(
                    _pop_quietly(
                        process,
                        log.ep("pop"),
                        TLogPopRequest(tag=TXS_TAG, upto=recovery_version),
                    )
                )

    # FULLY_RECOVERED: publish
    info = ServerDBInfo(
        id=recovery_count * 1000,
        recovery_count=recovery_count,
        master_address=process.address,
        master_uid=uid,
        client_info=ClientDBInfo(
            id=recovery_count * 1000, proxies=list(proxy_ifaces)
        ),
        log_system=LogSystemConfig(
            epoch=recovery_count, current=tlog_set, old=tuple(old_sets)
        ),
        recovery_version=recovery_version,
        log_routers=(
            LogSystemConfig(
                epoch=recovery_count,
                current=router_set,
                old=old_router_sets,
            )
            if router_set is not None
            # promoted (remote-wired) storage follows router_config
            # forever: every post-failover epoch mirrors the primary log
            # system there
            else (
                LogSystemConfig(
                    epoch=recovery_count,
                    current=tlog_set,
                    old=tuple(old_sets),
                )
                if config.get("failover_promoted")
                else None
            )
        ),
        remote_storage=tuple(remote_storage),
    )
    await process.request(
        Endpoint(cc_address, Tokens.CC_SET_DB_INFO), SetDBInfoRequest(info=info)
    )
    trace(
        SevInfo,
        "MasterFullyRecovered",
        process.address,
        RecoveryCount=recovery_count,
        RecoveryVersion=recovery_version,
    )

    # service: watch for role failure; drop old tlog generations when safe;
    # run DataDistribution + Ratekeeper (hosted in the master, as in 6.0)
    from ..client.database import Database
    from .data_distribution import DataDistributor, Ratekeeper

    knobs = process.sim.knobs
    dd_db = Database(
        process.sim, client_addr=process.address, proxy_ifaces=list(proxy_ifaces)
    )
    # system traffic: DD repair/tracker transactions ride the IMMEDIATE
    # admission class — shard repair must keep running while client load
    # is being shed (server/admission.py)
    from .admission import PRIORITY_IMMEDIATE

    dd_db.default_priority = PRIORITY_IMMEDIATE
    addr_zone = {
        w.address: (getattr(w, "zone", "") or w.address) for w in workers
    }
    dd = DataDistributor(
        process,
        dd_db,
        storage,
        knobs,
        int(config.get("replication", 1)),
        uid=f"dd-{uid}-{recovery_count}",
        zones={s.tag: addr_zone.get(s.address, s.address) for s in storage},
    )
    rk = Ratekeeper(
        process,
        master,
        storage,
        knobs,
        uid,
        cc_address=cc_address,  # live membership: poll the CC registry
        n_proxies=len(proxy_ifaces),
    )
    watched = (
        [(i.ep("ping"), "proxy") for i in proxy_ifaces]
        + [(i.ep("ping"), "resolver") for i in resolver_ifaces]
        + [(log.ep("ping"), "tlog") for log in tlog_set.logs]
        + (
            [(log.ep("ping"), "log_router") for log in router_set.logs]
            if router_set is not None
            else []
        )
    )
    from .resolution_balance import ResolutionBalancer

    balancer = ResolutionBalancer(
        knobs, resolver_map, master, [i.uid for i in proxy_ifaces]
    )
    aux = [
        process.spawn(
            _track_tlog_recovery(process, cs, core, info, cc_address, storage)
        ),
        process.spawn(dd.run()),
        process.spawn(rk.run()),
        process.spawn(
            rk.stats.trace_loop(knobs.METRICS_TRACE_INTERVAL, process.address)
        ),
        process.spawn(balancer.run(process)),
    ]
    try:
        await _wait_failure(process, watched)
    finally:
        for a in aux:
            a.cancel()
    raise MasterTerminated("a recruited role failed")


# -- recruitment helpers -------------------------------------------------------


_CLASS_FOR_ROLE = {
    "storage": "storage",
    "tlog": "transaction",
    "proxy": "stateless",
    "resolver": "resolver",
    "master": "stateless",
}


class _RolePicker:
    """Fitness-based worker choice (getWorkerForRoleInDatacenter:388),
    simplified: prefer matching process class, then least-loaded."""

    def __init__(self, workers, avoid=frozenset()):
        self.workers = workers
        self.load = {w.address: len(w.roles) for w in workers}
        self.avoid = avoid

    def pick(self, role: str, n: int) -> list:
        want = _CLASS_FOR_ROLE.get(role, "stateless")
        zones_used: dict = {}

        def fitness(w):
            return (
                w.process_class != want,  # matching class first
                w.address in self.avoid,
                # spread one pick-call across zones (so e.g. the tlog set
                # spans failure domains and policy tag assignment works)
                zones_used.get(getattr(w, "zone", "") or w.address, 0),
                self.load[w.address],
            )

        chosen = []
        for _ in range(n):
            w = min(self.workers, key=fitness)
            chosen.append(w)
            self.load[w.address] += 1
            z = getattr(w, "zone", "") or w.address
            zones_used[z] = zones_used.get(z, 0) + 1
        return chosen


async def _pop_quietly(process, ep, req):
    try:
        await process.request(ep, req)
    except Cancelled:
        raise  # actor-cancelled-swallow
    except Exception:
        pass  # popping a dead tlog is moot


def _split_points(n: int) -> list[bytes]:
    return [bytes([(256 * i) // n]) for i in range(1, n)]


async def _seed_storage(process, picker: _RolePicker, n_storage, replication, m_uid):
    """First-recovery storage seeding (the reference's seedShardServers):
    one storage role per chosen worker, teams of `replication`, even key
    split across teams.

    Deterministic choice + deterministic uids ("ss-<tag>") make seeding
    idempotent across fenced master attempts: a re-seed lands on the same
    workers and adopts the roles the failed attempt already created."""
    assert n_storage % replication == 0, "storage must fill teams"
    pool = sorted(
        picker.workers,
        key=lambda w: (w.process_class != "storage", w.address),
    )
    workers = pool[:n_storage]
    assert len({w.address for w in workers}) == len(workers), (
        "storage roles need distinct workers (one per process)"
    )
    n_teams = n_storage // replication
    # zone-aware team formation (DDTeamCollection + ReplicationPolicy.h:119
    # PolicyAcross): each team spans `replication` distinct zones when the
    # topology allows it — a "2-replica" cluster must survive losing a
    # whole zone. Deterministic: round-robin over zones sorted by size.
    def zkey(w):
        return w.zone or w.address

    by_zone: dict = {}
    for i, w in enumerate(workers):
        by_zone.setdefault(zkey(w), []).append(i)
    zones = sorted(by_zone, key=lambda z: (-len(by_zone[z]), z))
    teams = []
    if len(zones) >= replication:
        cursors = {z: 0 for z in zones}
        for t in range(n_teams):
            members = []
            for j in range(replication):
                # find a zone with spare workers, starting at the rotation
                for probe in range(len(zones)):
                    zz = zones[(t + j + probe) % len(zones)]
                    if cursors[zz] < len(by_zone[zz]) and not any(
                        zkey(workers[m]) == zz for m in members
                    ):
                        members.append(by_zone[zz][cursors[zz]])
                        cursors[zz] += 1
                        break
                else:
                    # zones exhausted under distinctness: take any spare
                    for zz in zones:
                        if cursors[zz] < len(by_zone[zz]):
                            members.append(by_zone[zz][cursors[zz]])
                            cursors[zz] += 1
                            break
            teams.append(sorted(members))
    else:
        teams = [
            list(range(t * replication, (t + 1) * replication))
            for t in range(n_teams)
        ]
    bounds = [b""] + _split_points(n_teams) + [None]
    shards = []
    for team in range(n_teams):
        members = teams[team]
        addrs = tuple(workers[t].address for t in members)
        shards.append((bounds[team], bounds[team + 1], addrs, tuple(members)))
    storage = []
    for tag, w in enumerate(workers):
        s_uid = f"ss-{tag}"
        ranges = [(b, e) for b, e, _a, tags in shards if tag in tags]
        await process.request(
            Endpoint(w.address, Tokens.WORKER_RECRUIT),
            RecruitRoleRequest(
                role="storage",
                uid=s_uid,
                # seed=True: displace a stale seed role from a racing
                # first-recovery attempt (two same-generation masters can
                # seed concurrently with divergent worker registries; only
                # one survives the cstate write, and until that write
                # nothing is durable, so the loser's roles are garbage)
                params=dict(tag=tag, ranges=ranges, seed=True),
            ),
        )
        storage.append(StorageInterface(address=w.address, uid=s_uid, tag=tag))
    return storage, shards


# -- ongoing service actors ----------------------------------------------------


async def _wait_failure(process, watched, interval=0.3, misses_allowed=4):
    """waitFailureClient over every recruited role; returns when one dies."""
    misses = {ep.address + ep.token: 0 for ep, _ in watched}
    while True:
        await delay(interval)
        for ep, kind in watched:
            key = ep.address + ep.token
            try:
                from ..runtime.futures import timeout as _timeout
                from ..net.sim import BrokenPromise

                r = await _timeout(process.request(ep, None), interval * 2)
                if r is None:
                    raise BrokenPromise("ping timeout")
                misses[key] = 0
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                misses[key] += 1
                if misses[key] >= misses_allowed:
                    trace(
                        SevWarn,
                        "MasterSawRoleFailure",
                        process.address,
                        Role=kind,
                        Endpoint=str(ep),
                    )
                    return


async def _track_tlog_recovery(process, cs, core, info, cc_address, storage):
    """Once every storage server's version passed the recovery version, the
    old tlog generations are no longer needed: rewrite the cstate without
    them and republish (trackTlogRecovery, masterserver.actor.cpp:1009).
    With a remote region, the ROUTERS must also have relayed past the
    recovery version — an old generation a router still needs must not be
    dropped out from under the remote mirror."""
    if not core.old_tlog_sets and not core.old_router_sets:
        return
    from ..runtime.futures import settled, wait_for_any

    async def _poll(eps):
        futs = [process.request(ep, None) for ep in eps]
        deadline = delay(2.0)
        replies = []
        for f in futs:
            await wait_for_any([settled(f), deadline])
            if f.is_ready() and not f.is_error():
                replies.append(f.get())
        return replies

    while True:
        await delay(1.0)
        replies = await _poll([s.ep("version") for s in storage])
        # a server counts as caught up only once it follows THIS epoch AND
        # has PERSISTED past the recovery version: before that its version
        # may contain a discarded pre-recovery tail it hasn't rolled back
        # yet, and a reboot would still need the old generation's data.
        # An UNREACHABLE server pins the old generations too: at
        # replication=1 its acked-but-unpersisted tail exists ONLY there —
        # dropping them while it reboots destroys acknowledged commits
        # (found by the TCP kill/restart soak). A permanently-dead server
        # thus pins old tlogs until exclusion removes it; the reference's
        # per-tag pop-on-removal is the eventual cleanup path.
        ok = len(replies) == len(storage) and all(
            epoch == core.recovery_count and durable > core.recovery_version
            for _version, durable, epoch in replies
        )
        if ok and core.router_set is not None:
            router_eps = [
                Endpoint(log.address, f"router.version#{log.log_id}")
                for log in core.router_set.logs
            ]
            r_replies = await _poll(router_eps)
            ok = len(r_replies) == len(router_eps) and all(
                v > core.recovery_version for v in r_replies
            )
        if ok and core.remote_storage:
            # the remote mirror must have PERSISTED past the recovery
            # version too: a router's relay buffer is memory — if the
            # router died after relaying but before the mirror applied,
            # only the old generations still hold that data
            rs_replies = await _poll(
                [s.ep("version") for s in core.remote_storage]
            )
            # the mirror must FOLLOW this epoch too: durable progress made
            # while still on the old router generation may contain a
            # discarded pre-recovery tail it hasn't rolled back yet
            ok = len(rs_replies) == len(core.remote_storage) and all(
                epoch == core.recovery_count
                and durable > core.recovery_version
                for _v, durable, epoch in rs_replies
            )
        if ok:
            break
    new_core = DBCoreState(
        recovery_count=core.recovery_count,
        tlog_set=core.tlog_set,
        old_tlog_sets=(),
        recovery_version=core.recovery_version,
        storage=core.storage,
        shards=core.shards,
        config=core.config,
        log_ranges=core.log_ranges,
        router_set=core.router_set,
        old_router_sets=(),
        remote_storage=core.remote_storage,
    )
    try:
        await cs.write(new_core)
    except ClusterStateChanged:
        return  # a successor owns the state now; it will handle cleanup
    new_info = ServerDBInfo(
        id=info.id + 1,
        recovery_count=info.recovery_count,
        master_address=info.master_address,
        master_uid=info.master_uid,
        client_info=info.client_info,
        log_system=LogSystemConfig(
            epoch=core.recovery_count, current=core.tlog_set, old=()
        ),
        recovery_version=core.recovery_version,
        log_routers=(
            LogSystemConfig(
                epoch=core.recovery_count, current=core.router_set, old=()
            )
            if core.router_set is not None
            else (
                LogSystemConfig(
                    epoch=core.recovery_count, current=core.tlog_set, old=()
                )
                if core.config.get("failover_promoted")
                else None
            )
        ),
        remote_storage=tuple(core.remote_storage),
    )
    await process.request(
        Endpoint(cc_address, Tokens.CC_SET_DB_INFO), SetDBInfoRequest(info=new_info)
    )
    trace(SevInfo, "OldTLogGenerationsDropped", process.address)
