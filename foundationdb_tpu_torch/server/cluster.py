"""Cluster assembly: build a full database in the simulator.

Two forms:

- ``Cluster`` — static wiring (the analog of a hand-built
  setupSimulatedSystem, SimulatedCluster.actor.cpp:886): one process per
  role, fixed epoch-0 log system, no recovery. Fast to build; used by the
  commit-path tests.

- ``DynamicCluster`` — the real thing: coordinator processes + worker
  processes only. Workers campaign for cluster controllership through the
  coordinators' leader election, the winning CC recruits a master, and the
  master's recovery state machine (master.master_core) recruits every other
  role and seeds storage. Kill the master/proxies/tlogs and the cluster
  re-forms itself — the full §3.3 recovery loop of SURVEY.md.

Layout rules:
- storage server i carries tag i (fdbclient/FDBTypes.h:39 Tag)
- storage servers group into teams of `replication` size; the key space is
  split evenly (by first byte) across teams — the static form of the
  shard map kept in \\xff/keyServers/ (fdbclient/SystemData.cpp:33)
- each tag lives on `tlog_replication` tlogs of the current generation
- the conflict-resolution key space splits evenly across resolvers
  (the keyResolvers map, MasterProxyServer.actor.cpp:233)

The port's copy of ``foundationdb_tpu/server/cluster.py``. Either cluster
runs on the CUDA card named by ``device``: every resolver's conflict set
and every storage server's range index is built there (``None`` = the
card, which raises ``DeviceUnavailableError`` before any process is made
when there is none; ``"cpu"`` runs the kernels' plain versions, as the
tests do). ``conflict_backend`` defaults to ``"torch"``; the device
backends are named ``torch`` and ``torch_mesh`` where the JAX package says
``tpu1`` and ``mesh``. Each storage server has a ``SimDisk``: a durable
engine under the MVCC window and, with the index knob on (its default in
the Sim), the range index that engine reads go through (the K5 kernel).
The reference's static cluster keeps its storage in memory only, so its
reads never leave the window; a storage server of the dynamic cluster has
its worker's disk in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..device import resolve_device
from ..kv.keyrange_map import KeyRangeMap
from ..net.sim import Sim
from ..runtime.futures import AsyncVar
from ..runtime.knobs import Knobs
from .interfaces import MasterInterface, ResolverInterface
from .log_system import LogSystem, LogSystemConfig, TLogSet, assign_tags
from .coordination import CoordinatorServer
from .master import Master, _split_points
from .proxy import Proxy, ShardMap
from .resolver import Resolver
from .storage import StorageServer
from .tlog import TLog
from .worker import Worker


@dataclass
class ClusterConfig:
    n_proxies: int = 1
    n_resolvers: int = 1
    n_tlogs: int = 1
    n_storage: int = 1
    replication: int = 1  # storage replicas per shard (team size)
    tlog_replication: int = 1  # tlog replicas per tag
    conflict_backend: str = "torch"
    # multi-region: a remote dc gets a LogRouter set + a storage mirror
    # (regions config, fdbclient/DatabaseConfiguration.h:52)
    remote_dc: str = ""
    n_log_routers: int = 1

    def as_dict(self) -> dict:
        return dict(
            n_proxies=self.n_proxies,
            n_resolvers=self.n_resolvers,
            n_tlogs=self.n_tlogs,
            n_storage=self.n_storage,
            replication=self.replication,
            tlog_replication=self.tlog_replication,
            conflict_backend=self.conflict_backend,
            remote_dc=self.remote_dc,
            n_log_routers=self.n_log_routers,
        )




class Cluster:
    """Statically wired single-epoch cluster (no recovery machinery)."""

    def __init__(
        self,
        sim: Sim,
        config: ClusterConfig = None,
        knobs: Knobs = None,
        device=None,  # every resolver's and storage server's: None = the card
    ):
        # no card, no cluster: nothing is built on the host in its place
        resolve_device(device)
        self.sim = sim
        self.config = cfg = config or ClusterConfig()
        self.knobs = knobs or sim.knobs
        assert cfg.n_storage % cfg.replication == 0, "storage must fill teams"

        # master
        self.master = Master(knobs=self.knobs)
        p = sim.new_process("master")
        self.master.register(p)

        # tlogs (epoch 0)
        self.tlogs: list[TLog] = []
        addrs = [f"tlog{i}" for i in range(cfg.n_tlogs)]
        log_ids = [f"tlog{i}" for i in range(cfg.n_tlogs)]
        logs = assign_tags(addrs, log_ids, cfg.n_storage, cfg.tlog_replication)
        for log in logs:
            tl = TLog(self.knobs, tags=frozenset(log.tags), epoch=0, log_id=log.log_id)
            tl.register_instance(sim.new_process(log.address))
            self.tlogs.append(tl)
        tlog_set = TLogSet(epoch=0, logs=tuple(logs), replication=cfg.tlog_replication)
        self.log_config = AsyncVar(
            LogSystemConfig(epoch=0, current=tlog_set, old=())
        )

        # storage: teams of `replication` servers; even key split across teams
        self.storages: list[StorageServer] = []
        shards = ShardMap()
        n_teams = cfg.n_storage // cfg.replication
        bounds = [b""] + _split_points(n_teams) + [None]
        for team in range(n_teams):
            members = range(team * cfg.replication, (team + 1) * cfg.replication)
            addrs = [f"ss{t}" for t in members]
            shards.set_shard(bounds[team], bounds[team + 1], addrs, list(members))
        for t in range(cfg.n_storage):
            ss = StorageServer(
                tag=t,
                log_config=self.log_config,
                knobs=self.knobs,
                disk=sim.disk(f"ss{t}"),
                device=device,
            )
            ss.register(sim.new_process(f"ss{t}"))
            self.storages.append(ss)
        self.shards = shards

        # resolvers: even key split
        self.resolvers: list[Resolver] = []
        resolver_map = KeyRangeMap()
        rbounds = [b""] + _split_points(cfg.n_resolvers) + [None]
        for i in range(cfg.n_resolvers):
            r = Resolver(self.knobs, backend=cfg.conflict_backend, device=device)
            addr = f"resolver{i}"
            r.register(sim.new_process(addr))
            self.resolvers.append(r)
            resolver_map.insert(rbounds[i], rbounds[i + 1], ResolverInterface(addr))

        # proxies (full peer list so GRVs confirm against every proxy's
        # raw committed version instead of a master round trip)
        self.proxies: list[Proxy] = []
        self.proxy_addrs: list[str] = []
        peer_list = [(f"proxy{i}", f"p{i}") for i in range(cfg.n_proxies)]
        for i in range(cfg.n_proxies):
            pr = Proxy(
                master=MasterInterface("master"),
                resolver_map=resolver_map,
                log_system=LogSystem(tlog_set),
                shards=shards,
                knobs=self.knobs,
                uid=f"p{i}",
                peers=peer_list,
            )
            addr = f"proxy{i}"
            pr.register(sim.new_process(addr))
            self.proxies.append(pr)
            self.proxy_addrs.append(addr)
        self.resolver_map = resolver_map
        self.master_process = p
        self.balancer = None

    def start_resolution_balancer(self):
        """Opt-in for the static cluster (the recovery master always runs
        one): load-driven resolver-boundary moves."""
        from .resolution_balance import ResolutionBalancer

        self.balancer = ResolutionBalancer(
            self.knobs,
            self.resolver_map,
            self.master,
            [p.uid for p in self.proxies],
        )
        self.master_process.spawn(self.balancer.run(self.master_process))
        return self.balancer

    # -- test/ops helpers ------------------------------------------------------

    def storage_for_tag(self, tag: int) -> StorageServer:
        return self.storages[tag]

    def quiesce_version(self) -> int:
        """Highest committed version (for draining in tests — QuietDatabase)."""
        return self.master.live_committed


class DynamicCluster:
    """Coordinators + workers; everything else recruits itself (§3.3)."""

    def __init__(
        self,
        sim: Sim,
        config: ClusterConfig = None,
        n_coordinators: int = 1,
        n_workers: int = None,
        knobs: Knobs = None,
        prefix: str = "",  # distinct prefixes let several clusters share a sim
        n_zones: int = 0,  # >0: spread workers over failure domains
        device=None,  # every worker's: None = the card
    ):
        # no card, no cluster: checked before any process is made, since a
        # recruitment that raised inside a worker would only be traced and
        # the master would retry it forever
        resolve_device(device)
        self.sim = sim
        self.config = cfg = config or ClusterConfig()
        self.knobs = knobs or sim.knobs

        def zone_of(i: int):
            return f"{prefix}z{i % n_zones}" if n_zones else None

        self.coordinators = [f"{prefix}coord{i}" for i in range(n_coordinators)]
        for i, addr in enumerate(self.coordinators):
            sim.new_process(addr, boot=_boot_coordinator, zone=zone_of(i))

        # worker fleet: storage-class + transaction-class + stateless
        if n_workers is None:
            n_workers = (
                cfg.n_storage
                + cfg.n_tlogs
                + cfg.n_proxies
                + cfg.n_resolvers
                + 2  # master + CC headroom
            )
        n_stateless = max(
            2, n_workers - cfg.n_storage - cfg.n_tlogs
        )
        classes = (
            ["storage"] * cfg.n_storage
            + ["transaction"] * cfg.n_tlogs
            + ["stateless"] * n_stateless
        )
        self.worker_addrs = []
        # zone assignment strides WITHIN each class so every class spans
        # all zones (e.g. 6 storage workers over 3 zones = 2 per zone)
        per_class_idx: dict = {}
        for i, pclass in enumerate(classes):
            j = per_class_idx.get(pclass, 0)
            per_class_idx[pclass] = j + 1
            addr = f"{prefix}worker{i}"
            self.worker_addrs.append(addr)
            sim.new_process(
                addr,
                boot=_make_worker_boot(
                    self.coordinators, pclass, cfg.as_dict(), self.knobs, device=device
                ),
                zone=zone_of(j),
            )

        # remote region: storage mirror workers + router hosts in a
        # second dc. In NORMAL operation the primary region runs the
        # transaction subsystem (master_core restricts primary roles to
        # it), but remote workers stay CC-eligible: after a region
        # failover they are the only processes left to elect one
        # (the reference's CC can run in any region).
        if cfg.remote_dc:
            r_classes = ["storage"] * cfg.n_storage + ["transaction"] * max(
                cfg.n_log_routers, 1
            ) + ["stateless"]
            for i, pclass in enumerate(r_classes):
                addr = f"{prefix}remote{i}"
                self.worker_addrs.append(addr)
                sim.new_process(
                    addr,
                    boot=_make_worker_boot(
                        self.coordinators,
                        pclass,
                        cfg.as_dict(),
                        self.knobs,
                        device=device,
                    ),
                    zone=f"{prefix}{cfg.remote_dc}-z{i}",
                    dc=cfg.remote_dc,
                )


def _boot_coordinator(process):
    async def run():
        CoordinatorServer(disk=process.sim.disk(process.machine)).register(
            process
        )

    return run()


def _make_worker_boot(coordinators, pclass, config, knobs, can_be_cc=True, device=None):
    def boot(process):
        async def run():
            Worker(
                process,
                coordinators,
                process_class=pclass,
                initial_config=config,
                knobs=knobs,
                can_be_cc=can_be_cc,
                device=device,
            ).start()

        return run()

    return boot
