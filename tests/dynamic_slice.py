"""Seeded runs of the dynamic cluster, the same in either package.

``run_dynamic(pkg, scenarios, backend, seed)`` builds, for each named
scenario, the ``DynamicCluster`` of the package named by ``pkg``
(``"foundationdb_tpu"`` or ``"foundationdb_tpu_torch"``) on that
package's ``Sim`` with one ``Database.from_coordinators`` client, runs
the scenario's client actions and failures, and returns a transcript of
plain Python values: every value a client read, every commit version and
error class of every attempt, the roles every live worker hosts with their
counters, each live resolver's guard, the recovery count and version each live
worker was last told,
the shard map as the proxies serve it, the trace events of the run and the
sim clock. Two packages' runs of the same seed compare with ``==``.

The scenarios are those of ``tests/test_recovery.py``,
``tests/test_tpu_in_cluster.py``, ``tests/test_data_distribution.py``,
``tests/test_movekeys.py``, ``tests/test_restart.py``,
``tests/test_multi_region.py`` and ``tests/test_management.py``, with their
asserts turned into records, each with the seed and shape of its test.

Imports neither package at module level: the card tests import it on a
machine without JAX.
"""

from __future__ import annotations

import gc
import importlib
from dataclasses import dataclass
from types import SimpleNamespace

from commit_slice import plain


def package(pkg: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    futures = mod("runtime.futures")
    return SimpleNamespace(
        Sim=mod("net.sim").Sim, Endpoint=mod("net.sim").Endpoint,
        spawn=futures.spawn, delay=futures.delay, cluster=mod("server.cluster"),
        resolver=mod("server.resolver"), interfaces=mod("server.interfaces"),
        movekeys=mod("server.movekeys"), management=mod("client.management"),
        Database=mod("client.database").Database, trace=mod("runtime.trace"),
        set_loop=mod("runtime.loop").set_loop,
    )


@dataclass
class Scenario:
    body: object  # async (Ctx) -> None
    seed: int
    shape: dict  # ClusterConfig's fields
    n_coordinators: int = 1


class Ctx:
    """What a scenario sees: the package, its sim, cluster and database,
    ``rec`` to add a value to the transcript and the client and failure
    helpers of the reference's tests, each recording what it saw."""

    def __init__(self, P, sim, cluster, db, out):
        self.P, self.sim, self.cluster, self.db, self._out = P, sim, cluster, db, out

    def rec(self, *values):
        self._out.append(plain(values))

    async def _run(self, label, key, body, db=None):
        """``Database.run`` with every attempt recorded: the commit version
        or the error class, then the body's result."""
        tr = (db or self.db).transaction()
        while True:
            try:
                result = await body(tr)
                v = await tr.commit()
                self.rec(label, key, result, v)
                return result
            except Exception as e:  # the error is part of the transcript
                self.rec(label, key, plain(e))
                await tr.on_error(e)

    async def put(self, key, value):
        async def body(tr):
            tr.set(key, value)
            return value

        await self._run("put", key, body)

    async def get(self, key, db=None):
        async def body(tr):
            return await tr.get(key)

        return await self._run("get", key, body, db)

    def workers_hosting(self, kind):
        return [
            addr for addr, p in self.sim.processes.items()
            if getattr(p, "worker", None) is not None and p.alive
            and any(h.kind == kind for h in p.worker.roles.values())
        ]

    def kill(self, kind, reboot_in=None):
        victims = self.workers_hosting(kind)
        self.rec("kill", kind, victims[:1], reboot_in)
        self.sim.kill_process(victims[0], reboot_in=reboot_in)
        return victims[0]

    def storage_worker(self, tag):
        return next(
            addr for addr, p in self.sim.processes.items()
            if getattr(p, "worker", None) is not None and p.alive
            for h in p.worker.roles.values() if h.kind == "storage" and h.obj.tag == tag
        )

    def storage_ifaces(self):
        StorageInterface = self.P.interfaces.StorageInterface
        out = [
            StorageInterface(address=addr, uid=h.uid, tag=h.obj.tag)
            for addr, p in self.sim.processes.items()
            if getattr(p, "worker", None) is not None and p.alive
            for h in p.worker.roles.values() if h.kind == "storage"
        ]
        return sorted(out, key=lambda s: s.tag)

    async def walk_shards(self):
        I = self.P.interfaces
        out, key = [], b""
        while True:
            r = await self.db._proxy_request(I.Tokens.GET_KEY_SERVERS, I.GetKeyServersRequest(key=key))
            out.append((r.begin, r.end, tuple(r.tags)))
            if r.end is None:
                return out
            key = r.end

    def fresh_locations(self):
        self.db.invalidate_cache(b"\x00")
        self.db._locations = type(self.db._locations)(default=None)


# -- scenarios -------------------------------------------------------------------

RECOVERY_SHAPE = dict(n_proxies=2, n_resolvers=1, n_tlogs=2, n_storage=2, replication=2, tlog_replication=2)


async def forms_and_serves(c):
    await c.put(b"hello", b"world")
    await c.get(b"hello")
    db2 = c.P.Database.from_coordinators(c.sim, c.cluster.coordinators, client_addr="client2")
    await c.get(b"hello", db2)


def _kill_role(kind):
    async def body(c):
        for i in range(10):
            await c.put(b"pre%02d" % i, b"v%d" % i)
        c.kill(kind)
        for i in range(10):
            await c.put(b"post%02d" % i, b"v%d" % i)
        for i in range(10):
            await c.get(b"pre%02d" % i)
        for i in range(10):
            await c.get(b"post%02d" % i)

    body.__name__ = f"kill_{kind}"
    return body


async def repeated_master_kills(c):
    for round_no in range(3):
        await c.put(b"k%d" % round_no, b"v%d" % round_no)
        if c.workers_hosting("master"):
            c.kill("master")
        await c.P.delay(1.0)
    for round_no in range(3):
        await c.get(b"k%d" % round_no)


async def cc_reelected(c):
    await c.put(b"a", b"1")
    cc = [addr for addr, p in c.sim.processes.items()
          if getattr(p, "worker", None) is not None and p.alive and p.worker._cc is not None]
    c.rec("cc", cc)
    c.sim.kill_process(cc[0])
    await c.put(b"b", b"2")
    await c.get(b"a")
    await c.get(b"b")


async def device_survives_recovery(c):
    """test_tpu_backend_survives_recovery, plus a transaction whose read
    version is from the killed generation, below a later commit of it: it
    commits after the recovery, where its snapshot lies below the new
    resolvers' first version (TOO_OLD)."""
    tr = c.db.transaction()
    for i in range(10):
        tr.set(b"r%02d" % i, b"v%d" % i)
    c.rec("fill", await tr.commit())
    stale = c.db.transaction()
    c.rec("stale read", await stale.get(b"r00"))
    await c.put(b"r01", b"later")
    c.kill("master")
    await c.put(b"post-recovery", b"ok")
    stale.set(b"r00", b"stale")
    try:
        c.rec("stale commit", await stale.commit())
    except Exception as e:
        c.rec("stale commit", plain(e))
    db2 = c.P.Database.from_coordinators(c.sim, c.cluster.coordinators, client_addr="c2")

    async def check(tr):
        return [await tr.get(b"r%02d" % i) for i in range(10)] + [await tr.get(b"post-recovery")]

    await c._run("check", b"", check, db2)


async def dd_rereplicates(c):
    for i in range(40):
        await c.put(b"%02x-key" % (i * 6), b"v%d" % i)
    victim = c.storage_worker(3)
    c.rec("kill storage", victim)
    c.sim.kill_process(victim)
    start = c.sim.loop.now()
    while True:
        await c.P.delay(2.0)
        shards = await c.walk_shards()
        c.rec("shards", shards)
        if all(3 not in tags and len(tags) == 2 for _b, _e, tags in shards):
            break
        if c.sim.loop.now() - start > 60.0:
            c.rec("not re-replicated")
            break
    c.fresh_locations()
    for i in range(40):
        await c.get(b"%02x-key" % (i * 6))


async def ratekeeper(c):
    await c.put(b"a", b"1")
    await c.P.delay(2.0)
    c.rec("rates", [
        h.obj.admission.rates for p in c.sim.processes.values() if getattr(p, "worker", None)
        for h in p.worker.roles.values() if h.kind == "proxy" and not h.obj.failed
    ])
    await c.get(b"a")


async def move_shard(c):
    for i in range(30):
        await c.put(b"\x90k%02d" % i, b"v%d" % i)
    storage = c.storage_ifaces()
    stop = [False]

    async def writer():
        i = 30
        while not stop[0]:
            await c.put(b"\x90k%02d" % i, b"v%d" % i)
            i += 1
            await c.P.delay(0.05)
        return i

    wfut = c.P.spawn(writer())
    await c.P.movekeys.move_shard(c.db, b"\x80", None, [storage[0], storage[1]])
    stop[0] = True
    total = await wfut
    c.db.invalidate_cache(b"\x90")
    for i in range(total):
        await c.get(b"\x90k%02d" % i)
    I = c.P.interfaces
    for _ in range(20):
        reply = await c.db._proxy_request(I.Tokens.GET_KEY_SERVERS, I.GetKeyServersRequest(key=b"\x90"))
        if set(reply.tags) == {0, 1}:
            break
        await c.P.delay(0.1)
    c.rec("tags", reply.tags)
    src = next(h.obj for p in c.sim.processes.values() if getattr(p, "worker", None)
               for h in p.worker.roles.values() if h.kind == "storage" and h.obj.tag == 2)
    c.rec("source owns", src.owned[b"\x90"])


async def move_survives_recovery(c):
    for i in range(10):
        await c.put(b"\x90m%02d" % i, b"v%d" % i)
    storage = c.storage_ifaces()
    await c.P.movekeys.move_shard(c.db, b"\x80", None, [storage[0], storage[1]])
    c.kill("master")
    for i in range(10, 20):
        await c.put(b"\x90m%02d" % i, b"v%d" % i)
    c.db.invalidate_cache(b"\x90")
    for i in range(20):
        await c.get(b"\x90m%02d" % i)


async def tlog_reboot(c):
    for i in range(20):
        await c.put(b"t%02d" % i, b"v%d" % i)
    c.kill("tlog", reboot_in=1.5)
    for i in range(20, 30):
        await c.put(b"t%02d" % i, b"v%d" % i)
    for i in range(30):
        await c.get(b"t%02d" % i)


async def storage_reboot(c):
    for i in range(20):
        await c.put(b"s%02d" % i, b"v%d" % i)
    await c.P.delay(2.0)
    c.kill("storage", reboot_in=1.0)
    for i in range(20):
        await c.get(b"s%02d" % i)
    for i in range(20, 25):
        await c.put(b"s%02d" % i, b"v%d" % i)
    for i in range(25):
        await c.get(b"s%02d" % i)


async def full_restart(c):
    for i in range(25):
        await c.put(b"r%02d" % i, b"v%d" % i)
    rng = c.sim.loop.random
    for addr, p in list(c.sim.processes.items()):
        if getattr(p, "worker", None) is not None and p.alive:
            c.sim.kill_process(addr, reboot_in=1.0 + rng.random01() * 2.0)
    for i in range(25):
        await c.get(b"r%02d" % i)
    for i in range(25, 30):
        await c.put(b"r%02d" % i, b"v%d" % i)
    for i in range(30):
        await c.get(b"r%02d" % i)


async def log_routers(c):
    """test_remote_mirror_converges: the remote mirrors, fed by the log
    routers, converge on the primary's rows, clears included."""
    I = c.P.interfaces

    async def converged(expected, begin, end):
        for _ in range(120):
            await c.P.delay(0.5)
            remotes = [(addr, h.obj) for addr, p in c.sim.processes.items()
                       if getattr(p, "worker", None) is not None and p.alive
                       for h in p.worker.roles.values() if h.kind == "storage" and h.uid.startswith("rss-")]
            merged, ok = {}, bool(remotes)
            for addr, ss in remotes:
                v = ss.version.get()
                if v <= 0:
                    ok = False
                    break
                for b, e, state in ss.owned.intersecting(begin, end):
                    if state is None or state[0] != "owned":
                        continue
                    req = I.GetKeyValuesRequest(begin=max(b, begin), end=end if e is None else min(e, end),
                                                version=v, limit=1000)
                    try:
                        reply = await c.db.client.request(c.P.Endpoint(addr, I.Tokens.GET_KEY_VALUES), req)
                    except Exception:
                        ok = False
                        break
                    merged.update(dict(reply.data))
                if not ok:
                    break
            if ok and merged == expected:
                return True
        return False

    expected = {}
    for i in range(30):
        await c.put(b"mr%02d" % i, b"v%d" % i)
        expected[b"mr%02d" % i] = b"v%d" % i
    c.rec("converged", await converged(expected, b"mr", b"ms"))

    async def clear(tr):
        tr.clear_range(b"mr00", b"mr10")

    await c._run("clear", b"mr00", clear)
    for i in range(10):
        del expected[b"mr%02d" % i]
    c.rec("converged", await converged(expected, b"mr", b"ms"))


async def exclude(c):
    M = c.P.management
    for i in range(20):
        await c.put(b"x%02d" % i, b"v%d" % i)
    victim = c.storage_worker(0)
    await M.exclude_servers(c.db, [victim])
    await M.wait_for_excluded(c.db, [victim])
    c.rec("excluded", await M.get_excluded(c.db))
    for i in range(20):
        await c.get(b"x%02d" % i)
    await M.include_servers(c.db)
    c.rec("excluded", await M.get_excluded(c.db))


async def configure(c):
    M = c.P.management
    await c.put(b"a", b"1")
    await M.configure(c.db, c.cluster.coordinators, c.db.client, n_proxies=2, n_resolvers=2)
    deadline = c.sim.loop.now() + 60.0
    while True:
        await c.P.delay(1.0)
        doc = await M.get_status(c.cluster.coordinators, c.db.client)
        proxies = doc.get("client", {}).get("proxies", [])
        if len(proxies) == 2 or c.sim.loop.now() > deadline:
            break
    c.rec("status", proxies, doc.get("kernel"), doc.get("data"))
    await c.get(b"a")
    await c.put(b"b", b"2")
    await c.get(b"b")


SCENARIOS = {
    "forms_and_serves": Scenario(forms_and_serves, 0, dict(
        n_proxies=2, n_resolvers=2, n_tlogs=2, n_storage=2, replication=2, tlog_replication=2)),
    "kill_master": Scenario(_kill_role("master"), 7, RECOVERY_SHAPE),
    "kill_proxy": Scenario(_kill_role("proxy"), 7, RECOVERY_SHAPE),
    "kill_tlog": Scenario(_kill_role("tlog"), 7, RECOVERY_SHAPE),
    "repeated_master_kills": Scenario(repeated_master_kills, 3, dict(
        n_proxies=1, n_resolvers=1, n_tlogs=2, n_storage=2, replication=2, tlog_replication=2), 3),
    "cc_reelected": Scenario(cc_reelected, 11, dict(n_proxies=1, n_resolvers=1, n_tlogs=1, n_storage=1), 3),
    "device_survives_recovery": Scenario(device_survives_recovery, 33, dict(n_storage=2, n_resolvers=2), 3),
    "dd_rereplicates": Scenario(dd_rereplicates, 31, dict(
        n_proxies=1, n_resolvers=1, n_tlogs=2, n_storage=4, replication=2, tlog_replication=2)),
    "ratekeeper": Scenario(ratekeeper, 32, dict(n_proxies=1, n_resolvers=1, n_tlogs=1, n_storage=1)),
    "move_shard": Scenario(move_shard, 21, dict(
        n_proxies=2, n_resolvers=2, n_tlogs=2, n_storage=4, replication=2, tlog_replication=2)),
    "move_survives_recovery": Scenario(move_survives_recovery, 22, dict(
        n_proxies=1, n_resolvers=1, n_tlogs=2, n_storage=4, replication=2, tlog_replication=2)),
    "tlog_reboot": Scenario(tlog_reboot, 41, dict(n_proxies=1, n_resolvers=1, n_tlogs=1, n_storage=1)),
    "storage_reboot": Scenario(storage_reboot, 42, dict(
        n_proxies=1, n_resolvers=1, n_tlogs=2, n_storage=1, tlog_replication=2)),
    "full_restart": Scenario(full_restart, 43, dict(
        n_proxies=2, n_resolvers=1, n_tlogs=2, n_storage=2, replication=2, tlog_replication=2), 3),
    "log_routers": Scenario(log_routers, 81, dict(n_storage=2, n_tlogs=2, n_log_routers=2, remote_dc="dc1"), 3),
    "exclude": Scenario(exclude, 51, dict(
        n_proxies=1, n_resolvers=1, n_tlogs=2, n_storage=4, replication=2, tlog_replication=2)),
    "configure": Scenario(configure, 52, dict(n_proxies=1, n_resolvers=1, n_tlogs=1, n_storage=1)),
}

RESOLVER_KEYS = ("resolveBatchIn", "transactions", "conflicts", "tooOld", "version")
# trace fields read from the host (memory, the run-loop profiler), not the
# sim, and the backtraces, which name each package's own files and lines
HOST_FIELDS = ("MemoryKB", "PeakMemoryKB", "LoopSteps", "SlowTasks", "LoopBusyFraction", "Backtrace")


# the device backends' class names, the port's for the JAX package's
BACKEND_NAMES = {"TpuConflictSet": "TorchConflictSet", "MeshConflictSet": "TorchMeshConflictSet"}


def kernel_section(kernel: dict) -> dict:
    """A resolver's kernel metrics without the host-timed ones (every
    ``*Seconds`` sample), the guard's backend under the port's name."""
    out = {k: v for k, v in kernel.items() if not k.endswith("Seconds")}
    if isinstance(out.get("health"), dict):
        backend = out["health"].get("backend")
        out["health"] = {**out["health"], "backend": BACKEND_NAMES.get(backend, backend)}
    return out


def roles(sim):
    """Every live worker's roles: (address, kind, uid, epoch, counters),
    the resolvers' counters those the backends share."""
    out = []
    for addr, p in sorted(sim.processes.items()):
        w = getattr(p, "worker", None)
        if w is None or not p.alive:
            continue
        for uid, h in sorted(w.roles.items()):
            stats = getattr(h.obj, "stats", None)
            snap = stats.snapshot() if stats is not None else {}
            if h.kind == "resolver":
                snap = {k: snap[k] for k in RESOLVER_KEYS}
            out.append((addr, h.kind, uid, h.epoch, plain(snap)))
    return out


def guards(sim):
    """(address, uid, state, faults, failovers, backend) of the conflict-set
    guard of every live resolver (the backend under the port's name)."""
    out = []
    for addr, p in sorted(sim.processes.items()):
        w = getattr(p, "worker", None)
        if w is None or not p.alive:
            continue
        for uid, h in sorted(w.roles.items()):
            if h.kind == "resolver":
                g = h.obj.cs.health_snapshot()
                out.append((addr, uid, g["state"], g["faults"], g["failovers"],
                            BACKEND_NAMES.get(g["backend"], g["backend"])))
    return out


def recoveries(sim):
    """(address, info id, recovery count, recovery version) of the
    ServerDBInfo each live worker was last told."""
    out = []
    for addr, p in sorted(sim.processes.items()):
        w = getattr(p, "worker", None)
        if w is not None and p.alive and w.db_info.get() is not None:
            info = w.db_info.get()
            out.append((addr, info.id, info.recovery_count, info.recovery_version))
    return out


def collect_garbage(pkg: str) -> None:
    """Free an abandoned run's actors with no loop current and into a
    trace log nobody reads: a freed actor runs its ``finally`` blocks (a
    worker's role handle traces ``RoleDestroyed``, settles futures), which
    must reach neither the next run's loop nor its log."""
    P = package(pkg)
    saved = P.trace.trace_log()
    P.set_loop(None)
    P.trace.set_trace_log(P.trace.TraceLog())
    try:
        gc.collect()
    finally:
        P.trace.set_trace_log(saved)


def run_dynamic(pkg: str, scenarios=tuple(SCENARIOS), backend: str = "oracle", seed: int = None,
                resolver_kw: dict = None, probe=None, **cluster_kw) -> dict:
    """The transcript of each scenario (see the module docstring), each on
    its own ``Sim`` of the scenario's seed (or ``seed``). ``cluster_kw``
    goes to ``DynamicCluster`` (the port takes ``device``); ``resolver_kw``
    to every ``Resolver`` a worker recruits (the mesh's ``n_parts``);
    ``probe(sim)``, when given, runs after each scenario and its result is
    the transcript's ``"probe"``."""
    P = package(pkg)
    out = {}
    saved_log = P.trace.trace_log()
    real_resolver = P.resolver.Resolver
    if resolver_kw:
        P.resolver.Resolver = lambda *a, **kw: real_resolver(*a, **{**kw, **resolver_kw})
    try:
        collect_garbage(pkg)
        for name in scenarios:
            sc = SCENARIOS[name]
            log = P.trace.TraceLog()
            P.trace.set_trace_log(log)
            sim = P.Sim(sc.seed if seed is None else seed)
            sim.activate()
            cfg = P.cluster.ClusterConfig(**{"conflict_backend": backend, **sc.shape})
            cluster = P.cluster.DynamicCluster(sim, cfg, n_coordinators=sc.n_coordinators, **cluster_kw)
            db = P.Database.from_coordinators(sim, cluster.coordinators)
            rec: list = []

            async def main():
                await sc.body(Ctx(P, sim, cluster, db, rec))
                return True

            sim.run_until_done(P.spawn(main()), limit=600.0)
            c = Ctx(P, sim, cluster, db, [])
            shards = sim.run_until_done(P.spawn(c.walk_shards()), limit=600.0)
            events = [
                sorted((k, plain(kernel_section(v) if k == "kernel" else v))
                       for k, v in e.items() if k not in HOST_FIELDS)
                for e in log.events
            ]
            out[name] = {
                "client": rec, "roles": roles(sim), "guards": guards(sim), "recoveries": recoveries(sim),
                "shards": shards, "events": events, "now": sim.loop.now(),
            }
            if probe is not None:
                out[name]["probe"] = probe(sim)
            del sim, cluster, db, c, main
            collect_garbage(pkg)
        return out
    finally:  # leave no loop, no trace log and no patched class behind
        P.resolver.Resolver = real_resolver
        P.trace.set_trace_log(saved_log)
        P.set_loop(None)
