"""Seeded runs of the layers, backup and workloads, the same in either package.

``run_case(pkg, name, backend)`` runs the case ``CASES[name]`` in the
package named by ``pkg`` (``"foundationdb_tpu"`` or
``"foundationdb_tpu_torch"``; the port on the CPU) and returns a transcript
of plain Python values: what the case recorded (the values clients read,
commit versions and error classes, each workload's results after its
check: its attributes that are plain data), the sim clock at the end of
each run and every trace event. Two packages' runs of the same case
compare with ``==``.

The cases are those of ``tests/test_layers.py``, ``tests/test_backup.py``,
``tests/test_blobstore.py`` (but the one that needs ``net/tcp.py``),
``tests/test_workloads.py``, ``tests/test_api_fuzz.py`` and
``tests/test_chaos_extra.py`` (but the one that runs real processes),
with their asserts turned into records. ``backend`` names the port's
conflict backend (``oracle`` or ``torch``); the reference runs ``tpu1``
where the port runs ``torch``.

Differences taken out of the comparison, each a documented one:

- the watches of one key fire in the reference in the order of their
  entries' addresses (a ``set``), so two runs of one seed may differ; the
  port fires them in registration order, and the reference's run is given
  the same order (``OrderedBucket`` in place of its ``set``);
- the kernel sections carry ``reshardsDevice + reshardsHost`` as one
  ``reshards`` count: the port's single grid reshards on the device where
  the reference's replay ladder reshards on the host (ROADMAP §C, "A
  sequential bulk load converges");
- the device backends' class names are the port's in every event;
- the reference's static cluster keeps its storage in memory: here its
  storage servers get the disks the port's have (as ``commit_slice``).

Imports neither package at module level.
"""

from __future__ import annotations

import importlib
from contextlib import contextmanager

import numpy as np

from commit_slice import plain
from dynamic_slice import BACKEND_NAMES, HOST_FIELDS, collect_garbage, kernel_section

REFERENCE = "foundationdb_tpu"
PORT = "foundationdb_tpu_torch"


class OrderedBucket(dict):
    """A set that iterates in insertion order: the reference's watch
    buckets, as the port keeps them."""

    def add(self, x):
        self[x] = None

    def discard(self, x):
        self.pop(x, None)


def ref_backend(backend: str) -> str:
    """The reference's name for the port's single-grid device backend."""
    return {"torch": "tpu1", "torch_mesh": "mesh"}.get(backend, backend)


def event_fields(e: dict) -> list:
    """One trace event as sorted plain items, without the host fields,
    with the backends under the port's names and one reshard count."""
    out = []
    for k, v in e.items():
        if k in HOST_FIELDS:
            continue
        if k == "kernel":
            v = kernel_section(v)
            if "reshardsDevice" in v:
                v = dict(v)
                v["reshards"] = v.pop("reshardsDevice") + v.pop("reshardsHost")
        out.append((k, plain(BACKEND_NAMES.get(v, v) if isinstance(v, str) else v)))
    return sorted(out)


def _is_plain(x) -> bool:
    if isinstance(x, (list, tuple)):
        return all(_is_plain(v) for v in x)
    return x is None or isinstance(x, (bool, int, float, str, bytes))


def workload_state(w) -> list:
    """A workload's attributes that are plain data, sorted by name."""
    out = []
    for k, v in sorted(vars(w).items()):
        p = plain(v)
        if _is_plain(p):
            out.append((k, p))
    return out


@contextmanager
def pinned(pkg: str):
    """Run in ``pkg`` on a fresh trace log with no ambient span, the
    abandoned runs collected first, the reference's watch buckets in
    registration order; leave no loop, log, span, armed chaos or patch
    behind. Yields the log."""
    trace = importlib.import_module(f"{pkg}.runtime.trace")
    loop = importlib.import_module(f"{pkg}.runtime.loop")
    buggify = importlib.import_module(f"{pkg}.runtime.buggify")
    watches = importlib.import_module(f"{pkg}.server.watches")
    saved = trace.trace_log()
    collect_garbage(pkg)
    if pkg == REFERENCE:
        watches.set = OrderedBucket  # the module's one ``set()`` is a watch bucket
    log = trace.TraceLog()
    trace.set_trace_log(log)
    span = trace.swap_active_span(None)
    try:
        yield log
    finally:
        watches.__dict__.pop("set", None)
        trace.swap_active_span(span)
        trace.set_trace_log(saved)
        loop.set_loop(None)
        buggify.set_buggify(buggify.Buggify(None))
        collect_garbage(pkg)


class Run:
    """What a case sees: ``m(name)`` a module of the package, ``rec`` to add
    to the transcript, and the reference tests' builders, each on the
    case's backend (and, in the port, on the CPU)."""

    def __init__(self, pkg: str, backend: str):
        self.pkg = pkg
        self.port = pkg == PORT
        self.backend = backend if self.port else ref_backend(backend)
        self.out: list = []

    def m(self, name: str):
        return importlib.import_module(f"{self.pkg}.{name}")

    def rec(self, *values):
        self.out.append(plain(values))

    def _device(self) -> dict:
        return {"device": "cpu"} if self.port else {}

    def sim(self, seed: int, chaos: bool = False):
        sim = self.m("net.sim").Sim(seed=seed, chaos=chaos)
        sim.activate()
        return sim

    def static(self, seed: int = 0, chaos: bool = False, **shape):
        """Sim, static ``Cluster`` and ``Database`` (test_layers' make_db)."""
        sim = self.sim(seed, chaos)
        cluster_mod = self.m("server.cluster")
        real = cluster_mod.StorageServer
        if not self.port:
            cluster_mod.StorageServer = lambda **kw: real(disk=sim.disk(f"ss{kw['tag']}"), **kw)
        try:
            cluster = cluster_mod.Cluster(
                sim, cluster_mod.ClusterConfig(conflict_backend=self.backend, **shape), **self._device()
            )
        finally:
            cluster_mod.StorageServer = real
        db = self.m("client.database").Database(sim, cluster.proxy_addrs)
        return sim, cluster, db

    def dynamic(self, seed: int = 0, chaos: bool = False, n_coordinators: int = 1,
                prefix: str = "", client: str = "client", sim=None, **shape):
        """Sim, ``DynamicCluster`` and ``Database.from_coordinators``."""
        sim = sim or self.sim(seed, chaos)
        cluster_mod = self.m("server.cluster")
        cluster = cluster_mod.DynamicCluster(
            sim, cluster_mod.ClusterConfig(conflict_backend=self.backend, **shape),
            n_coordinators=n_coordinators, prefix=prefix, **self._device(),
        )
        db = self.m("client.database").Database.from_coordinators(
            sim, cluster.coordinators, client_addr=client
        )
        return sim, cluster, db

    def drive(self, sim, coro, limit: float = 600.0):
        result = sim.run_until_done(self.m("runtime.futures").spawn(coro), limit)
        self.rec("now", sim.loop.now())
        return result

    def spec(self, sim, workloads, limit: float = 600.0):
        """Run the workloads (setup, start, check) and record each one's
        results."""
        self.drive(sim, self.m("workloads").run_workloads(workloads), limit)
        for w in workloads:
            self.rec(type(w).__name__, workload_state(w))


def run_case(pkg: str, name: str, backend: str = "oracle") -> dict:
    """The transcript of ``CASES[name]`` in ``pkg`` (see the module
    docstring)."""
    with pinned(pkg) as log:
        run = Run(pkg, backend)
        CASES[name](run)
        return {"rec": run.out, "events": [event_fields(e) for e in log.events]}


# -- cases: the layers (tests/test_layers.py) ----------------------------------


def seeded_tuples(seed: int, n: int) -> list:
    """Nested tuples of every element type the tuple layer packs."""
    rs = np.random.RandomState(seed)

    def element(depth):
        kind = rs.randint(8 if depth < 2 else 7)
        if kind == 0:
            return None
        if kind == 1:
            return bytes(rs.randint(0, 256, rs.randint(0, 9)).astype(np.uint8))
        if kind == 2:
            return "".join(chr(c) for c in rs.randint(0, 0x2FF, rs.randint(0, 6)))
        if kind == 3:
            return int(rs.randint(-(2**31), 2**31)) * int(rs.choice([1, 1 << 31]))
        if kind == 4:
            return float(rs.standard_normal() * 10.0 ** rs.randint(-5, 6))
        if kind == 5:
            return bool(rs.randint(2))
        if kind == 6:
            return int(rs.randint(-300, 300))
        return tuple(element(depth + 1) for _ in range(rs.randint(0, 4)))

    return [tuple(element(0) for _ in range(rs.randint(0, 5))) for _ in range(n)]


def tuple_pack(r: Run):
    T = r.m("layers.tuple")
    cases = [
        (), (None,), (b"bytes", "string", 0, 1, -1, 255, -255, 65536, -65536),
        (1.5, -1.5, 0.0, float(10**10)), (True, False), (b"a\x00b", "emb\x00str"),
        (("nested", (1, None, b"x")), 2), (2**63 - 1, -(2**63) + 1),
    ] + seeded_tuples(11, 300)
    for t in cases:
        packed = T.pack(t)
        r.rec(t, packed, T.unpack(packed), T.range_of(t))


def tuple_ordering(r: Run):
    import random

    T = r.m("layers.tuple")
    rnd = random.Random(5)
    vals = []
    for _ in range(200):
        kind = rnd.randrange(3)
        if kind == 0:
            vals.append((rnd.randrange(-10**9, 10**9),))
        elif kind == 1:
            vals.append((rnd.randrange(-10**9, 10**9), rnd.random()))
        else:
            vals.append((rnd.randrange(-100, 100), bytes(rnd.randrange(256) for _ in range(rnd.randrange(8)))))
    packed = sorted(T.pack(v) for v in vals)
    r.rec(packed, [T.unpack(p) for p in packed])


def subspace(r: Run):
    app = r.m("layers").Subspace(("app",))
    users = app["users"]
    k = users.pack((42, "alice"))
    r.rec(k, users.contains(k), app.contains(k), users.unpack(k), users.range(), app.key())


def directory_layer(r: Run):
    sim, _cluster, db = r.static()
    d = r.m("layers").DirectoryLayer()

    async def body():
        async def create(tr):
            users = await d.create_or_open(tr, ("app", "users"))
            tr.set(users.pack((1,)), b"alice")
            return users.raw_prefix

        prefix = await db.run(create)

        async def reopen(tr):
            users = await d.open(tr, ("app", "users"))
            return users.raw_prefix, await tr.get(users.pack((1,)))

        async def listing(tr):
            return await d.list(tr, ("app",))

        async def second(tr):
            other = await d.create_or_open(tr, ("app", "events"))
            return other.raw_prefix, sorted(await d.list(tr, ("app",)))

        async def remove(tr):
            await d.remove(tr, ("app", "users"))

        async def gone(tr):
            return await d.exists(tr, ("app", "users"))

        r.rec(prefix, await db.run(reopen), await db.run(listing), await db.run(second))
        await db.run(remove)
        r.rec(await db.run(gone))

    r.drive(sim, body(), 120.0)


def _watch_case(r: Run, body):
    sim, _cluster, db = r.static()
    F = r.m("runtime.futures")
    r.drive(sim, body(db, F), 120.0)


def watch_fires_on_change(r: Run):
    async def body(db, F):
        async def setup(tr):
            tr.set(b"watched", b"v0")

        await db.run(setup)
        fired = db.watch(b"watched")
        await F.delay(0.5)
        r.rec(fired.is_ready())

        async def change(tr):
            tr.set(b"watched", b"v1")

        await db.run(change)
        r.rec(await F.timeout(fired, 10.0, default="TIMEOUT"))

    _watch_case(r, body)


def transaction_watch_after_commit(r: Run):
    async def body(db, F):
        tr = db.transaction()
        tr.set(b"k", b"a")
        w = tr.watch(b"k")
        r.rec(await tr.commit())
        await F.delay(0.5)
        r.rec(w.is_ready())

        async def change(tr2):
            tr2.set(b"k", b"b")

        await db.run(change)
        r.rec(await F.timeout(w, 10.0, default="TIMEOUT"))

    _watch_case(r, body)


def set_then_watch_baseline(r: Run):
    async def body(db, F):
        async def setup(tr):
            tr.set(b"other", b"x")

        await db.run(setup)
        tr = db.transaction()
        r.rec(await tr.get(b"other"))
        tr.set(b"k", b"mine")
        w = tr.watch(b"k")
        r.rec(await tr.commit())
        await F.delay(0.5)
        r.rec(w.is_ready())

        async def change(tr2):
            tr2.set(b"k", b"theirs")

        await db.run(change)
        r.rec(await F.timeout(w, 10.0, default="TIMEOUT"))

    _watch_case(r, body)


def clear_then_watch(r: Run):
    async def body(db, F):
        async def setup(tr):
            tr.set(b"c", b"x")

        await db.run(setup)
        tr = db.transaction()
        r.rec(await tr.get(b"c"))
        tr.clear(b"c")
        w = tr.watch(b"c")
        r.rec(await tr.commit())
        await F.delay(0.5)
        r.rec(w.is_ready())

        async def change(tr2):
            tr2.set(b"c", b"back")

        await db.run(change)
        r.rec(await F.timeout(w, 10.0, default="TIMEOUT"))

    _watch_case(r, body)


def watch_on_clear(r: Run):
    async def body(db, F):
        async def setup(tr):
            tr.set(b"todel", b"x")

        await db.run(setup)
        w = db.watch(b"todel")

        async def clear(tr):
            tr.clear(b"todel")

        await F.delay(0.2)
        await db.run(clear)
        r.rec(await F.timeout(w, 10.0, default="TIMEOUT"))

    _watch_case(r, body)


# -- cases: backup (tests/test_backup.py) --------------------------------------


async def _put(db, key, value):
    async def body(tr):
        tr.set(key, value)

    await db.run(body)


async def _get_all(db, begin=b"", end=b"\xff"):
    async def body(tr):
        return await tr.get_range(begin, end)

    return await db.run(body)


def taskbucket(r: Run):
    sim, _cluster, db = r.dynamic(61, n_storage=1, n_tlogs=1)
    TB = r.m("layers.taskbucket")
    F = r.m("runtime.futures")

    async def body():
        tb = TB.TaskBucket(r.m("layers").Subspace(("tb",)), lease=2.0)

        async def add(tr):
            await tb.add_task(tr, "work", n=1)
            await tb.add_task(tr, "work", n=2)

        await db.run(add)
        first = await tb.claim_one(db)
        second = await tb.claim_one(db)
        r.rec(first, second, await tb.claim_one(db))
        await tb.finish(db, first[0])
        await F.delay(2.5)  # the unfinished claim re-queues after its lease
        again = await tb.claim_one(db)
        r.rec(again)
        await tb.finish(db, again[0])
        r.rec(await tb.is_empty(db))

    r.drive(sim, body())


def backup_restore_roundtrip(r: Run):
    sim, _cluster, db = r.dynamic(62, n_proxies=2, n_tlogs=2, n_storage=2, replication=2, tlog_replication=2)
    B = r.m("backup")

    async def body():
        for i in range(40):
            await _put(db, b"base%03d" % i, b"v%d" % i)
        container = B.BackupContainer(sim.disk("backup-store"), "b1")
        agent = B.BackupAgent(db, container, uid="b1")
        await agent.submit()
        for i in range(40, 60):  # writes during the backup reach the log
            await _put(db, b"base%03d" % i, b"v%d" % i)

        async def extra(tr):
            tr.clear(b"base000")
            tr.set(b"base001", b"overwritten")

        await db.run(extra)
        await agent.wait_snapshot_complete()
        await agent.discontinue()
        source = await _get_all(db)
        n = await r.m("backup.agent").restore(db, container)
        r.rec(source, n, await _get_all(db))

    r.drive(sim, body())


def dr_second_cluster(r: Run):
    sim = r.sim(63)
    _, _a, db_a = r.dynamic(sim=sim, prefix="a-", client="ca", n_proxies=1, n_tlogs=2, n_storage=2,
                            replication=2, tlog_replication=2)
    _, _b, db_b = r.dynamic(sim=sim, prefix="b-", client="cb", n_proxies=1, n_tlogs=1, n_storage=1)
    F = r.m("runtime.futures")

    async def body():
        for i in range(30):
            await _put(db_a, b"k%03d" % i, b"v%d" % i)
        dr = r.m("backup").DrAgent(db_a, db_b, uid="dr1")
        await dr.start()
        for i in range(30, 50):
            await _put(db_a, b"k%03d" % i, b"v%d" % i)

        async def mutate(tr):
            tr.clear(b"k000")
            tr.set(b"k001", b"changed")

        await db_a.run(mutate)
        await F.delay(3.0)
        await dr.stop()
        r.rec(await _get_all(db_a, b"k", b"l"), await _get_all(db_b, b"k", b"l"))

    r.drive(sim, body())


# -- cases: the blob store (tests/test_blobstore.py) ---------------------------


def http_framing(r: Run):
    http = r.m("net.http")
    raw = http.encode_request("PUT", "/b/x/k", b"hello", {"X-Extra": "1"})
    resp = http.encode_response(200, b"world")
    r.rec(raw, http.parse_request(raw), resp, http.parse_response(resp),
          http.parse_request(raw[:10]), http.parse_response(resp[:-2]))


def url_parse(r: Run):
    bs = r.m("backup.blobstore")
    r.rec(bs.parse_blobstore_url("blobstore://bh:80/bucket/a/b"))
    try:
        bs.parse_blobstore_url("blobstore://bh:80/bucketonly")
    except ValueError as e:
        r.rec(str(e))


def blob_crud_over_sim(r: Run):
    bs, http = r.m("backup.blobstore"), r.m("net.http")
    sim = r.sim(1)
    bs.BlobStoreServer().mount_sim(sim.new_process("blobhost"))
    cl = bs.BlobStoreClient(http.SimHttpTransport(sim.new_process("blobclient"), "blobhost"), "bkt")

    async def go():
        await cl.put("a/1", b"one")
        await cl.put("a/2", b"two")
        await cl.put("b/1", b"three")
        r.rec(await cl.get("a/1"), await cl.get("missing"), await cl.list("a/"), await cl.list())
        await cl.delete("a/1")
        r.rec(await cl.get("a/1"), await cl.list("a/"))

    r.drive(sim, go(), 60.0)


def _blob_backup(r: Run, seed: int, chaos: bool):
    bs = r.m("backup.blobstore")
    sim, _cluster, db = r.static(seed, chaos=chaos)
    bs.BlobStoreServer().mount_sim(sim.new_process("blobhost"))
    w = r.m("workloads.backup_workload").BackupWorkload(
        db, r.m("runtime.rng").DeterministicRandom(seed), sim=sim, writes=25,
        container_url=f"blobstore://blobhost:80/backups/{'chaos' if chaos else 'soak'}",
    )
    F = r.m("runtime.futures")

    async def go():
        t = F.spawn(r.m("workloads").run_workloads([w]))
        if chaos:
            await F.delay(0.3)
            sim.clog_pair("client", "blobhost", 1.0)
        await t

    r.drive(sim, go())
    r.rec("BackupWorkload", workload_state(w))


def backup_through_blobstore(r: Run):
    _blob_backup(r, 2, chaos=False)


def backup_through_blobstore_under_chaos(r: Run):
    _blob_backup(r, 3, chaos=True)


def container_log_seq(r: Run):
    bs, http = r.m("backup.blobstore"), r.m("net.http")
    sim = r.sim(4)
    bs.BlobStoreServer().mount_sim(sim.new_process("blobhost"))
    proc = sim.new_process("c")

    def container():
        return bs.BlobStoreContainer(bs.BlobStoreClient(http.SimHttpTransport(proc, "blobhost"), "bkt"), "name")

    async def go():
        c1 = container()
        await c1.reset()
        await c1.append_log_chunk([(b"k1", b"m1")])
        await container().append_log_chunk([(b"k2", b"m2")])
        r.rec(await c1.read_log())

    r.drive(sim, go(), 60.0)


def open_container_dispatch(r: Run):
    bs = r.m("backup.blobstore")
    sim = r.sim(5)
    bs.BlobStoreServer().mount_sim(sim.new_process("blobhost"))
    c = bs.open_container("blobstore://blobhost:80/bkt/nm", sim=sim, process=sim.new_process("c"))
    c2 = bs.open_container("file://store/nm", sim=sim)
    r.rec(type(c).__name__, type(c2).__name__, isinstance(c2, r.m("backup.container").BackupContainer))


# -- cases: the workloads (tests/test_workloads.py, tests/test_api_fuzz.py) ----


def _w(r: Run):
    return r.m("workloads")


def cycle(seed):
    def case(r: Run):
        sim, _cluster, db = r.static(seed)
        r.spec(sim, [_w(r).CycleWorkload(db, sim.loop.random.fork(), nodes=15, transactions=40)])

    return case


def cycle_with_clogging(r: Run):
    sim, _cluster, db = r.static(3, n_proxies=2, n_storage=2, replication=2)
    rng, W = sim.loop.random, _w(r)
    r.spec(sim, [W.CycleWorkload(db, rng.fork(), nodes=12, transactions=30),
                 W.RandomCloggingWorkload(db, rng.fork(), duration=3.0)])


def write_during_read(seed):
    def case(r: Run):
        sim, _cluster, db = r.static(seed)
        r.spec(sim, [_w(r).WriteDuringReadWorkload(db, sim.loop.random.fork(), rounds=8)])

    return case


def conflict_range(seed):
    def case(r: Run):
        sim, _cluster, db = r.static(seed, n_resolvers=2)
        r.spec(sim, [_w(r).ConflictRangeWorkload(db, sim.loop.random.fork(), rounds=25)])

    return case


def sideband_causality(r: Run):
    sim, cluster, db = r.static(4, n_proxies=3)
    db2 = r.m("client.database").Database(sim, cluster.proxy_addrs, client_addr="client2")
    W = _w(r)
    r.spec(sim, [W.SidebandWorkload(db, sim.loop.random.fork(), messages=20, checker_db=db2),
                 W.RandomCloggingWorkload(db, sim.loop.random.fork(), duration=2.0)])


def combined_spec(seed):
    def case(r: Run):
        sim, _cluster, db = r.static(seed, n_proxies=2, n_resolvers=2)
        rng, W = sim.loop.random, _w(r)
        r.spec(sim, [W.CycleWorkload(db, rng.fork(), nodes=10, transactions=20),
                     W.RandomCloggingWorkload(db, rng.fork(), duration=2.0)])

    return case


def api_correctness(seed):
    def case(r: Run):
        sim, _cluster, db = r.static(seed)
        rng, W = sim.loop.random, _w(r)
        r.spec(sim, [W.ApiCorrectnessWorkload(db, rng.fork(), transactions=30, client_id=i) for i in range(2)],
               900.0)

    return case


def serializability(seed):
    def case(r: Run):
        sim, _cluster, db = r.static(seed, n_proxies=2, n_resolvers=2)
        rng, W = sim.loop.random, _w(r)
        r.spec(sim, [W.SerializabilityWorkload(db, rng.fork(), transactions=25, client_id=i, client_count=4)
                     for i in range(4)], 900.0)

    return case


def ryw_fuzz(seed):
    def case(r: Run):
        sim, _cluster, db = r.static(seed)
        r.spec(sim, [_w(r).RywFuzzWorkload(db, sim.loop.random.fork(), transactions=20, client_id=0)], 900.0)

    return case


def fuzz_battery_under_clogging(r: Run):
    sim, _cluster, db = r.static(5, n_proxies=2, n_resolvers=2, n_storage=2, replication=2)
    rng, W = sim.loop.random, _w(r)
    r.spec(sim, [
        W.ApiCorrectnessWorkload(db, rng.fork(), transactions=20, client_id=0),
        W.SerializabilityWorkload(db, rng.fork(), transactions=15, client_id=0, client_count=2),
        W.SerializabilityWorkload(db, rng.fork(), transactions=15, client_id=1, client_count=2),
        W.RywFuzzWorkload(db, rng.fork(), transactions=12, client_id=1),
        W.RandomCloggingWorkload(db, rng.fork(), duration=4.0),
    ], 900.0)


def _kill_master(r: Run, sim, after: float):
    F = r.m("runtime.futures")

    async def killer():
        await F.delay(after)
        for addr, p in list(sim.processes.items()):
            w = getattr(p, "worker", None)
            if w and p.alive and any(h.kind == "master" for h in w.roles.values()):
                r.rec("kill", addr)
                sim.kill_process(addr)
                return

    F.spawn(killer())


def fuzz_battery_across_recovery(seed):
    def case(r: Run):
        sim, _cluster, db = r.dynamic(seed, n_coordinators=3, n_storage=2, n_tlogs=2, tlog_replication=2)
        rng, W = sim.loop.random, _w(r)
        _kill_master(r, sim, 2.0)
        r.spec(sim, [
            W.ApiCorrectnessWorkload(db, rng.fork(), transactions=25, client_id=0),
            W.SerializabilityWorkload(db, rng.fork(), transactions=20, client_id=0, client_count=2),
            W.SerializabilityWorkload(db, rng.fork(), transactions=20, client_id=1, client_count=2),
        ], 900.0)

    return case


# -- cases: the second chaos set (tests/test_chaos_extra.py) -------------------


def disk_io_error_injection(r: Run):
    files = r.m("net.files")
    sim = r.sim(1)
    disk = files.SimDisk(sim, "m1")
    disk.inject_io_errors(1.0)
    f = disk.open("x")

    async def go():
        try:
            await f.write(0, b"data")
        except files.DiskFault as e:
            r.rec(plain(e), str(e))
        disk.inject_io_errors(0.0)
        await f.write(0, b"data")
        await f.sync()
        r.rec(await f.read(0, 4))

    r.drive(sim, go(), 10.0)


def disk_full(r: Run):
    files = r.m("net.files")
    sim = r.sim(2)
    disk = files.SimDisk(sim, "m2")
    f = disk.open("x")

    async def go():
        await f.write(0, b"a" * 100)
        await f.sync()
        disk.set_capacity(disk.total_bytes() + 10)
        await f.write(100, b"b" * 10)  # exactly fits
        try:
            await f.write(110, b"c" * 50)
        except files.DiskFault as e:
            r.rec(plain(e), str(e))
        disk.set_capacity(None)
        await f.write(110, b"c" * 50)
        r.rec(disk.total_bytes())

    r.drive(sim, go(), 10.0)


def _under_load(r: Run, seed: int, fault, **shape):
    sim, cluster, db = r.dynamic(seed, chaos=True, n_coordinators=3, **shape)
    rng, W = sim.loop.random, _w(r)
    spec = [W.CycleWorkload(db, rng.fork(), nodes=10, transactions=20),
            fault(W, sim, cluster, db, rng),
            W.ConsistencyCheckWorkload(db, rng.fork(), replication=2)]
    r.spec(sim, spec, 1200.0)


def rollback_under_load(r: Run):
    _under_load(r, 11, lambda W, sim, c, db, rng: W.RollbackWorkload(db, rng.fork(), sim=sim, clogs=2, duration=1.5),
                n_proxies=2, n_tlogs=2, n_storage=2, replication=2, tlog_replication=2)


def random_move_keys_under_load(r: Run):
    _under_load(r, 12, lambda W, sim, c, db, rng: W.RandomMoveKeysWorkload(db, rng.fork(), sim=sim, moves=3),
                n_storage=4, replication=2, n_tlogs=2, tlog_replication=2)


def change_config_under_load(r: Run):
    _under_load(r, 13, lambda W, sim, c, db, rng: W.ChangeConfigWorkload(
        db, rng.fork(), coordinators=c.coordinators, changes=1, choices=[{"n_proxies": 2}]),
        n_proxies=1, n_resolvers=1, n_storage=2, replication=2, n_tlogs=2, tlog_replication=2)


def disk_failure_under_load(r: Run):
    _under_load(r, 14, lambda W, sim, c, db, rng: W.DiskFailureWorkload(
        db, rng.fork(), sim=sim, episodes=1, duration=1.5, p=0.05),
        n_storage=2, replication=2, n_tlogs=2, tlog_replication=2)


def kernel_chaos(r: Run):
    """tests/test_kernel_faults.py's chaos composition: kernel-fault
    injection, clogging and attrition, the exact ledger and a
    ConsistencyCheck."""
    sim = r.sim(23, chaos=True)
    sim.knobs.CONFLICT_FAULT_INJECTION = True
    _, cluster, db = r.dynamic(sim=sim, n_proxies=1, n_resolvers=1, n_tlogs=2, n_storage=2, replication=2)
    rng, W = sim.loop.random, _w(r)
    r.spec(sim, [
        W.KernelChaosWorkload(db, rng.fork(), actors=2, increments=5),
        W.RandomCloggingWorkload(db, rng.fork(), duration=3.0),
        W.AttritionWorkload(db, rng.fork(), sim=sim, kills=1, interval=3.0, protect=set(cluster.coordinators)),
        W.ConsistencyCheckWorkload(db, rng.fork(), replication=2),
    ], 1200.0)


CASES = {
    "tuple_pack": tuple_pack,
    "tuple_ordering": tuple_ordering,
    "subspace": subspace,
    "directory_layer": directory_layer,
    "watch_fires_on_change": watch_fires_on_change,
    "transaction_watch_after_commit": transaction_watch_after_commit,
    "set_then_watch_baseline": set_then_watch_baseline,
    "clear_then_watch": clear_then_watch,
    "watch_on_clear": watch_on_clear,
    "taskbucket": taskbucket,
    "backup_restore_roundtrip": backup_restore_roundtrip,
    "dr_second_cluster": dr_second_cluster,
    "http_framing": http_framing,
    "url_parse": url_parse,
    "blob_crud_over_sim": blob_crud_over_sim,
    "backup_through_blobstore": backup_through_blobstore,
    "backup_through_blobstore_under_chaos": backup_through_blobstore_under_chaos,
    "container_log_seq": container_log_seq,
    "open_container_dispatch": open_container_dispatch,
    **{f"cycle_{s}": cycle(s) for s in (0, 1, 2)},
    "cycle_with_clogging": cycle_with_clogging,
    **{f"write_during_read_{s}": write_during_read(s) for s in (0, 1)},
    **{f"conflict_range_{s}": conflict_range(s) for s in (0, 1)},
    "sideband_causality": sideband_causality,
    **{f"combined_spec_{s}": combined_spec(s) for s in (7, 8)},
    **{f"api_correctness_{s}": api_correctness(s) for s in (0, 1, 2)},
    **{f"serializability_{s}": serializability(s) for s in (0, 1, 2)},
    **{f"ryw_fuzz_{s}": ryw_fuzz(s) for s in (0, 1, 2)},
    "fuzz_battery_under_clogging": fuzz_battery_under_clogging,
    **{f"fuzz_battery_across_recovery_{s}": fuzz_battery_across_recovery(s) for s in (11, 12)},
    "disk_io_error_injection": disk_io_error_injection,
    "disk_full": disk_full,
    "rollback_under_load": rollback_under_load,
    "random_move_keys_under_load": random_move_keys_under_load,
    "change_config_under_load": change_config_under_load,
    "disk_failure_under_load": disk_failure_under_load,
    "kernel_chaos": kernel_chaos,
}
