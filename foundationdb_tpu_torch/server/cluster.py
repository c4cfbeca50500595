"""Cluster assembly: build a full database in the simulator.

``Cluster`` is the static wiring (the analog of a hand-built
setupSimulatedSystem, SimulatedCluster.actor.cpp:886): one process per
role, fixed epoch-0 log system, no recovery. Fast to build; used by the
commit-path and workload tests.

Layout rules:
- storage server i carries tag i (fdbclient/FDBTypes.h:39 Tag)
- storage servers group into teams of `replication` size; the key space is
  split evenly (by first byte) across teams — the static form of the
  shard map kept in \\xff/keyServers/ (fdbclient/SystemData.cpp:33)
- each tag lives on `tlog_replication` tlogs of the current generation
- the conflict-resolution key space splits evenly across resolvers
  (the keyResolvers map, MasterProxyServer.actor.cpp:233)

The port's copy of ``ClusterConfig`` and the static ``Cluster`` of
``foundationdb_tpu/server/cluster.py``. The cluster runs on the CUDA card
named by ``device``: every resolver's conflict set and every storage
server's range index is built there (``None`` = the card, which raises
``DeviceUnavailableError`` when there is none; ``"cpu"`` runs the kernels'
plain versions, as the tests do). ``conflict_backend`` defaults to
``"torch"``; the device backends are named ``torch`` and ``torch_mesh``
where the JAX package says ``tpu1`` and ``mesh``. Each storage server has
its own ``SimDisk``: a durable engine under the MVCC window and, with the
index knob on (its default in the Sim), the range index that engine reads
go through (the K5 kernel). The reference's static cluster keeps its
storage in memory only, so its reads never leave the window; a storage
server of the dynamic cluster has its worker's disk in both packages.
``DynamicCluster`` and its boot helpers need the coordinators and the
workers, and come with them (ROADMAP queue A, item 9); the reference's
multi-region options (``remote_dc``, ``n_log_routers``), which only the
dynamic cluster reads, come with ``log_router.py``.
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
from .master import Master, _split_points
from .proxy import Proxy, ShardMap
from .resolver import Resolver
from .storage import StorageServer
from .tlog import TLog


@dataclass
class ClusterConfig:
    n_proxies: int = 1
    n_resolvers: int = 1
    n_tlogs: int = 1
    n_storage: int = 1
    replication: int = 1  # storage replicas per shard (team size)
    tlog_replication: int = 1  # tlog replicas per tag
    conflict_backend: str = "torch"


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
