"""The ``cli`` and ``status`` cases of the reference's tests, in either package.

``run_cli(pkg, name)`` builds the case's ``DynamicCluster`` on the
package's ``Sim`` (the case's seed, shape and knobs; the port's on the CPU),
with one ``Database.from_coordinators`` client and one ``FdbCli``, runs the
case's client actions and cli commands, and returns a transcript: every
cli output (``text``), every status document (``doc``) and the case's own
records, normalized as below. Two packages' transcripts of one case
compare with ``==``.

The cases are the cli and status cases of ``tests/test_management.py``,
``test_debug_chains.py``, ``test_profiler.py``, ``test_watches.py``,
``test_storage_metrics.py``, ``test_prefilter.py``,
``test_kernel_faults.py`` and ``test_storage_engine.py``. Their resolvers
run the device backend: ``torch`` in the port, ``tpu1`` in the reference.

What the normalization takes out, each field listed:

- the conflict backend's name (``BACKEND_NAMES``): the ``health: ... on
  <backend>`` of ``status details`` and every ``backend`` of a status
  document's kernel sections;
- the device the port's roles name in the status pull (``DEVICE_KEYS``):
  a resolver kernel section's ``device``, ``launches`` and
  ``cardMemory`` and a storage server's ``indexDevice``,
  ``indexCurrent``, ``indexLaunches`` and ``cardMemory``, which the
  reference does not report;
- the reshard counts' split (``reshards``): the port's single grid
  reshards on the device where the reference's replay ladder reshards on
  the host (ROADMAP §C), so ``reshardsDevice`` and ``reshardsHost`` of a
  kernel section, and the ``D+H reshards`` of ``status details``, are
  compared as their sum;
- what the host's clock or memory measures, not the sim (``HOST_TEXT``,
  ``HOST_KEYS``): the run-loop profiler's busy share, busy and max
  milliseconds and its hot-actor ranking by them (``cli top`` is compared
  by the blocking actor's row), each process's and machine's memory, the
  resolvers' host-timed samples (every ``*Seconds`` of a kernel section,
  the encode overlap of ``status details``) and the profiler's loop ids.

Imports neither package at module level.
"""

from __future__ import annotations

import importlib
import json
import re
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

from dynamic_slice import BACKEND_NAMES, HOST_FIELDS, collect_garbage

REFERENCE = "foundationdb_tpu"
PORT = "foundationdb_tpu_torch"

# (pattern, replacement) over cli text: the host-measured fields
HOST_TEXT = (
    (re.compile(r"(busiest \S+ at )[\d.]+(% busy)"), r"\1<host>\2"),  # the run-loop profiler
    (re.compile(r"\d+ MB"), "<host> MB"),  # process memory (status details)
    (re.compile(r"(enc overlap p50 )[\d.]+( ms)"), r"\1<host>\2"),  # the resolver's encode overlap
)
RESHARDS_TEXT = re.compile(r"(\d+)\+(\d+) reshards")
# the device the port's worker names in each role's status snapshot
DEVICE_KEYS = {"device", "launches", "indexDevice", "indexCurrent", "indexLaunches", "cardMemory"}
# status-document keys read from the host: memory, the run-loop profiler's
# wall-timed figures and ranking, its loop ids; every ``*Seconds`` sample
HOST_KEYS = set(HOST_FIELDS) | {
    "loop_id", "busy_seconds", "busy_fraction", "elapsed_seconds", "max_ms", "hot_actors",
    "select_seconds", "memory_kb",
}


def package(pkg: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    futures = mod("runtime.futures")
    return SimpleNamespace(
        pkg=pkg, Sim=mod("net.sim").Sim, Endpoint=mod("net.sim").Endpoint, spawn=futures.spawn,
        delay=futures.delay, timeout=futures.timeout, cluster=mod("server.cluster"),
        management=mod("client.management"), Database=mod("client.database").Database,
        trace=mod("runtime.trace"), set_loop=mod("runtime.loop").set_loop, cli=mod("tools.cli"),
        commit_chain=mod("tools.commit_chain"), rng=mod("runtime.rng"), workloads=mod("workloads"),
        readwrite=mod("workloads.readwrite"), failover=mod("conflict.failover"),
    )


def text(out: str) -> str:
    for pattern, repl in HOST_TEXT:
        out = pattern.sub(repl, out)
    for name, port_name in BACKEND_NAMES.items():
        out = out.replace(f"on {name}", f"on {port_name}")
    return RESHARDS_TEXT.sub(lambda m: f"{int(m[1]) + int(m[2])} reshards", out)


def doc(d):
    """A status document without the host-measured keys and the device
    keys, the backends under the port's names."""
    if isinstance(d, dict):
        out = {k: doc(v) for k, v in d.items()
               if k not in HOST_KEYS and k not in DEVICE_KEYS and not k.endswith("Seconds")}
        if "reshardsDevice" in out:
            out["reshards"] = out.pop("reshardsDevice") + out.pop("reshardsHost")
        return out
    if isinstance(d, (list, tuple)):
        return [doc(v) for v in d]
    if isinstance(d, str):
        return BACKEND_NAMES.get(d, d)
    return d


def top_rows(out: str, actor: str) -> list:
    """``cli top``'s rows of ``actor`` as (actor, steps): the busy columns,
    the order and so which other actors make the list are the host
    clock's."""
    rows = []
    for line in out.splitlines()[2:]:
        parts = line.split()
        if parts[-1].endswith(actor):
            rows.append((parts[-1], int(parts[1])))
    return rows


@dataclass
class Case:
    body: object  # async (Ctx) -> None
    seed: int
    shape: dict
    knobs: dict = field(default_factory=dict)
    n_coordinators: int = 1


class Ctx:
    def __init__(self, P, sim, cluster, db, cli, out, log):
        self.P, self.sim, self.cluster, self.db, self.cli, self._out, self.log = P, sim, cluster, db, cli, out, log
        self.results: dict = {}  # raw values the tests' own asserts read

    def rec(self, *values):
        self._out.append(values)

    async def cli_text(self, line):
        out = await self.cli.execute(line)
        self.results[line] = out
        self.rec("cli", line, text(out))
        return out

    async def status(self, label="doc"):
        d = await self.P.management.get_status(self.cluster.coordinators, self.db.client)
        self.results[label] = d
        self.rec("doc", label, doc(json.loads(json.dumps(d, default=str))))
        return d

    async def put(self, key, value):
        async def body(tr):
            tr.set(key, value)

        await self.db.run(body)

    async def get(self, key):
        async def body(tr):
            return await tr.get(key)

        return await self.db.run(body)

    def workers(self):
        return [(a, p) for a, p in sorted(self.sim.processes.items())
                if getattr(p, "worker", None) is not None and p.alive]

    def resolvers(self):
        return [h.obj for _a, p in self.workers() for h in p.worker.roles.values() if h.kind == "resolver"]


# -- test_management.py -----------------------------------------------------------


async def vocabulary(c):
    for line in ("set hello world", "get hello", "get missing", "set hello2 there", "getrange hello hellp 10",
                 "clear hello", "get hello", "status", "status details", "bogus", "exclude", "metrics",
                 "hotranges", "trace"):
        await c.cli_text(line)
    c.results["status json"] = await c.cli.execute("status json")
    c.rec("status json", doc(json.loads(c.results["status json"])))


async def status_document(c):
    await c.put(b"s", b"1")
    await c.status()


async def configure(c):
    await c.put(b"a", b"1")
    await c.cli_text("configure n_proxies=2 n_resolvers=2")
    deadline = c.sim.loop.now() + 60.0
    while True:
        await c.P.delay(1.0)
        d = await c.P.management.get_status(c.cluster.coordinators, c.db.client)
        if len(d.get("client", {}).get("proxies", [])) == 2 or c.sim.loop.now() > deadline:
            break
    await c.status("after")
    c.rec("a", await c.get(b"a"))
    await c.cli_text("set b 2")
    await c.cli_text("get b")


async def exclude(c):
    for i in range(20):
        await c.put(b"x%02d" % i, b"v%d" % i)
    victim = next(a for a, p in c.workers() for h in p.worker.roles.values()
                  if h.kind == "storage" and h.obj.tag == 0)
    await c.cli_text(f"exclude {victim}")
    await c.cli_text("exclude")
    c.rec("after exclude", [await c.get(b"x%02d" % i) for i in range(20)])
    await c.cli_text("include")
    await c.cli_text("exclude")


# -- test_debug_chains.py -------------------------------------------------------


def chain_events(P, debug_id, log):
    return [sorted((k, v) for k, v in e.items() if k not in HOST_FIELDS)
            for e in P.commit_chain.chain(debug_id, log.events)]


async def commit_debug_chain(c):
    tr = c.db.transaction()
    tr.set_debug_id("probe-1")
    await tr.get(b"warm")
    tr.set(b"dbg", b"v")
    c.rec("commit", await tr.commit())
    c.rec("chain", chain_events(c.P, "probe-1", c.log))
    c.rec("format", c.P.commit_chain.format_chain("probe-1", c.log.events))
    c.rec("full", [e["Event"] for e in c.P.commit_chain.full_chain("probe-1", c.log.events)])
    c.rec("ids", c.P.commit_chain.sampled_ids(c.log.events))


async def commit_sampling(c):
    for i in range(3):
        await c.put(b"s%d" % i, b"v")
    ids = [i for i in c.P.commit_chain.sampled_ids(c.log.events) if i.startswith("txn-")]
    c.rec("ids", ids)
    c.rec("chains", [[e["Event"] for e in c.P.commit_chain.chain(i, c.log.events)] for i in ids[:3]])


async def machine_process_sections(c):
    await c.put(b"x", b"1")
    await c.P.delay(5.0)
    d = await c.status()
    c.rec("processes", sorted(d["processes"]), "machines", sorted(d["machines"]))
    await c.cli_text("status details")


# -- test_profiler.py -------------------------------------------------------------


def _spin(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


async def blocking_actor(c):
    """The reference's blocking actor (a 0.12 s spin inside one step)
    under ``cli profile`` and ``cli top``. Its wall-clock ranking is not
    compared; the steps of every actor ``top`` shows, the profile's
    answers and the status lines are."""

    async def loop_hog():
        await c.P.delay(0.5)
        _spin(0.12)
        return True

    for i in range(5):
        await c.put(b"top%02d" % i, b"v")
    await c.cli_text("profile start 250")
    await c.db.client.spawn(loop_hog())
    folded = await c.cli.execute("profile stop")
    c.results["folded"] = folded
    await c.P.delay(6.0)
    top = await c.cli.execute("top 50")
    c.results["top"] = top
    c.rec("top", top.splitlines()[0], top_rows(top, "loop_hog"))
    await c.cli_text("status")
    direct = {}
    for addr, _p in c.workers():
        direct[addr] = await c.db.client.request(c.P.Endpoint(addr, "process.metrics"), None)
    c.results["direct"] = direct
    c.rec("direct", {a: (s["personality"], s["steps"]) for a, s in direct.items()})
    c.rec("RunLoopMetrics", sum(e["Type"] == "RunLoopMetrics" for e in c.log.events))


# -- the surfaces -----------------------------------------------------------------


async def watches_surface(c):
    async def register(tr):
        return [tr.watch(b"st/%d" % i) for i in range(5)]

    futs = await c.db.run(register)

    async def release(tr):
        for i in range(5):
            tr.set(b"st/%d" % i, b"go")

    await c.db.run(release)
    for f in futs:
        await c.P.timeout(f, 60.0)
    await c.P.delay(6.0)
    await c.status()
    await c.cli_text("status")


async def hot_range_surface(c):
    rng = c.P.rng.DeterministicRandom(3)
    hot_keys = [b"hot/%03d" % i for i in range(6)]
    for base in range(0, 200, 20):
        async def w(tr, base=base):
            for i in range(20):
                tr.set(b"cold/%05d" % (base + i), bytes(100))

        await c.db.run(w)

    async def wh(tr):
        for k in hot_keys:
            tr.set(k, bytes(256))

    await c.db.run(wh)
    for _ in range(300):
        key = rng.random_choice(hot_keys) if rng.random01() < 0.9 else b"cold/%05d" % rng.random_int(0, 200)
        await c.get(key)
    await c.P.delay(6.0)
    await c.status()
    for line in ("status", "hotranges", "hotranges 2", "metrics", "metrics storage",
                 "metrics storage epochsApplied", "metrics storage nosuch", "metrics nosuch"):
        await c.cli_text(line)


async def prefilter_surface(c):
    wl = c.P.readwrite.ReadWriteWorkload(
        c.db, c.sim.loop.random.fork(), actors=8, txns_per_actor=25, reads_per_txn=4, writes_per_txn=2,
        keyspace=10, prefix=b"hot/")
    await c.P.workloads.run_workloads([wl])
    await c.cli_text("status")


async def kernel_failover_surface(c):
    for i in range(5):
        await c.put(b"k%02d" % i, b"v")
    (res,) = c.resolvers()
    c.rec("health", res.cs.health, res.cs._injector is not None)
    res.cs._injector.lose_device(2.0)
    for i in range(5):
        await c.put(b"f%02d" % i, b"v")
    c.rec("health", res.cs.health)
    await c.status("mid")
    await c.P.delay(3.0)
    for i in range(5):
        await c.put(b"h%02d" % i, b"v")
    c.rec("health", res.cs.health)
    await c.status("after")
    await c.cli_text("status")
    await c.cli_text("status details")
    c.results["health"] = res.stats.snapshot()["kernel"]["health"]


async def storage_engine_surface(c):
    for i in range(12):
        async def body(tr, i=i):
            tr.set(b"s%03d" % i, b"v")
            if i == 5:
                tr.clear_range(b"s000", b"s003")

        await c.db.run(body)
    c.rec("read", await c.get(b"s011"))
    await c.P.delay(6.0)
    await c.status()
    await c.cli_text("status")


ONE = dict(n_proxies=1, n_resolvers=1, n_tlogs=1, n_storage=1)
CASES = {
    "vocabulary": Case(vocabulary, 54, ONE),
    "status_document": Case(status_document, 53, dict(n_proxies=2, n_resolvers=1, n_tlogs=2, n_storage=2,
                                                      replication=2, tlog_replication=2)),
    "configure": Case(configure, 52, ONE),
    "exclude": Case(exclude, 51, dict(n_proxies=1, n_resolvers=1, n_tlogs=2, n_storage=4, replication=2,
                                      tlog_replication=2)),
    "commit_debug_chain": Case(commit_debug_chain, 51, dict(n_proxies=2, n_resolvers=2)),
    "commit_sampling": Case(commit_sampling, 52, {}, knobs=dict(CLIENT_COMMIT_SAMPLE=1.0)),
    "machine_process_sections": Case(machine_process_sections, 53, {}),
    "blocking_actor": Case(blocking_actor, 37, dict(n_proxies=1, n_resolvers=1, n_storage=2),
                           knobs=dict(STORAGE_TPU_INDEX=False)),
    "watches_surface": Case(watches_surface, 3, dict(n_storage=1, n_tlogs=1, n_proxies=1)),
    "hot_range_surface": Case(hot_range_surface, 3, dict(n_storage=1, n_tlogs=1, n_proxies=1)),
    "prefilter_surface": Case(prefilter_surface, 1701, dict(n_proxies=2, n_resolvers=2, n_tlogs=1, n_storage=2)),
    "kernel_failover_surface": Case(kernel_failover_surface, 71, ONE, knobs=dict(
        CONFLICT_FAULT_INJECTION=True, CONFLICT_FAILOVER_STRIKES=2, CONFLICT_REPROBE_INTERVAL=0.5)),
    "storage_engine_surface": Case(storage_engine_surface, 2, dict(n_storage=1, n_tlogs=1, n_proxies=1)),
}


def run_cli(pkg: str, name: str) -> tuple[list, dict]:
    """The case's transcript, and the raw outputs its test asserts on."""
    P = package(pkg)
    case = CASES[name]
    saved = P.trace.trace_log()
    collect_garbage(pkg)
    log = P.trace.TraceLog()
    P.trace.set_trace_log(log)
    try:
        sim = P.Sim(seed=case.seed)
        sim.activate()
        for k, v in case.knobs.items():
            setattr(sim.knobs, k, v)
        backend = "torch" if pkg == PORT else "tpu1"
        cfg = P.cluster.ClusterConfig(**{**case.shape, "conflict_backend": backend})
        kw = {"device": "cpu"} if pkg == PORT else {}
        cluster = P.cluster.DynamicCluster(sim, cfg, n_coordinators=case.n_coordinators, **kw)
        db = P.Database.from_coordinators(sim, cluster.coordinators)
        out: list = []
        ctx = Ctx(P, sim, cluster, db, P.cli.FdbCli(db, cluster.coordinators), out, log)

        async def main():
            await case.body(ctx)
            return True

        sim.run_until_done(P.spawn(main()), 1800.0)
        out.append(("now", sim.loop.now()))
        return out, ctx.results
    finally:
        P.trace.set_trace_log(saved)
        P.set_loop(None)
