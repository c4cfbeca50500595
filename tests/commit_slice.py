"""Seeded runs of the commit path, the same in either package.

``run_commit(pkg, scenarios, ...)`` builds the static ``Cluster`` of the
package named by ``pkg`` (``"foundationdb_tpu"`` or
``"foundationdb_tpu_torch"``) on that package's ``Sim`` with one
``Database``, runs the named client scenarios one after another, and
returns a transcript of plain Python values: per scenario every read value,
commit version, versionstamp and error class the client saw, then the
proxies' counters and latency samples, the resolvers' counters, the storage
servers' counters, the master's versions and the sim clock. Two packages'
runs of the same seed compare with ``==``.

The scenarios are those of ``tests/test_commit_path.py`` and
``tests/test_tpu_in_cluster.py`` with their asserts turned into records,
each on its own key prefix, plus a few for the client's API.

Imports neither package at module level: the card tests import it on a
machine without JAX.
"""

from __future__ import annotations

import dataclasses
import importlib
import random
import struct
from types import SimpleNamespace


def package(pkg: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    futures = mod("runtime.futures")
    return SimpleNamespace(
        Sim=mod("net.sim").Sim, Knobs=mod("runtime.knobs").Knobs,
        spawn=futures.spawn, wait_for_all=futures.wait_for_all, delay=futures.delay,
        server=mod("server"), cluster=mod("server.cluster"), Database=mod("client").Database,
        MT=mod("kv.mutations").MutationType, KeySelector=mod("client").KeySelector,
        set_loop=mod("runtime.loop").set_loop,
        set_buggify=mod("runtime.buggify").set_buggify, Buggify=mod("runtime.buggify").Buggify,
    )


def plain(x):
    """A value as plain data: dataclasses become (class name, fields),
    exceptions their class name, dicts sorted item lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, plain(getattr(x, f.name))) for f in dataclasses.fields(x)
        )
    if isinstance(x, dict):
        return sorted((str(k), plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, BaseException):
        return ("error", type(x).__name__)
    return x


class Ctx:
    """What a scenario sees: the package, its cluster and database, and
    ``rec`` to add a value to the transcript."""

    def __init__(self, P, sim, cluster, db, out):
        self.P, self.sim, self.cluster, self.db, self._out = P, sim, cluster, db, out

    def rec(self, *values):
        self._out.append(plain(values))

    async def commit(self, tr):
        """Commit and record the version, or the error class."""
        try:
            v = await tr.commit()
        except Exception as e:  # the error is part of the transcript
            self.rec("commit", plain(e))
            return None
        self.rec("commit", v)
        return v


# -- scenarios (test_commit_path.py, test_tpu_in_cluster.py) -------------------


async def set_commit_get(c):
    tr = c.db.transaction()
    tr.set(b"scg/hello", b"world")
    await c.commit(tr)
    tr2 = c.db.transaction()
    c.rec(await tr2.get(b"scg/hello"), await tr2.get(b"scg/missing"))


async def read_your_writes(c):
    MT = c.P.MT
    tr0 = c.db.transaction()
    tr0.set(b"ryw/a", b"committed")
    tr0.set(b"ryw/gone", b"x")
    await c.commit(tr0)
    tr = c.db.transaction()
    c.rec(await tr.get(b"ryw/a"))
    tr.set(b"ryw/a", b"mine")
    c.rec(await tr.get(b"ryw/a"))
    tr.clear(b"ryw/gone")
    c.rec(await tr.get(b"ryw/gone"))
    tr.atomic_op(MT.APPEND_IF_FITS, b"ryw/a", b"!")
    c.rec(await tr.get(b"ryw/a"))
    tr.atomic_op(MT.ADD, b"ryw/ctr", b"\x05")
    c.rec(await tr.get(b"ryw/ctr"))
    await c.commit(tr)
    tr2 = c.db.transaction()
    c.rec(await tr2.get(b"ryw/a"), await tr2.get(b"ryw/gone"), await tr2.get(b"ryw/ctr"))


async def conflicts(c):
    setup = c.db.transaction()
    setup.set(b"cf/k", b"0")
    await c.commit(setup)
    a, b = c.db.transaction(), c.db.transaction()
    c.rec(await a.get(b"cf/k"), await b.get(b"cf/k"))
    a.set(b"cf/k", b"a")
    b.set(b"cf/k", b"b")
    await c.commit(a)
    await c.commit(b)  # NotCommitted
    x, y = c.db.transaction(), c.db.transaction()
    await x.get(b"cf/x")
    await y.get(b"cf/y")
    x.set(b"cf/x", b"1")
    y.set(b"cf/y", b"1")
    await c.commit(x)
    await c.commit(y)


async def blind_writes(c):
    trs = [c.db.transaction() for _ in range(8)]
    for i, tr in enumerate(trs):
        tr.set(b"bw/same", b"%d" % i)
    got = await c.P.wait_for_all([c.P.spawn(tr.commit()) for tr in trs])
    c.rec("versions", got)
    c.rec(await c.db.transaction().get(b"bw/same"))


async def causal(c):
    for i in range(10):
        tr = c.db.transaction()
        tr.set(b"ca/seq", b"%03d" % i)
        await c.commit(tr)
        c.rec(await c.db.transaction().get(b"ca/seq"))


async def ranges(c):
    tr = c.db.transaction()
    for i in range(10):
        tr.set(b"rg/%02d" % i, b"v%d" % i)
    await c.commit(tr)
    tr = c.db.transaction()
    c.rec(await tr.get_range(b"rg/", b"rg0"))
    c.rec(await tr.get_range(b"rg/", b"rg0", limit=3))
    c.rec(await tr.get_range(b"rg/", b"rg0", limit=2, reverse=True))
    tr.clear_range(b"rg/03", b"rg/07")
    tr.set(b"rg/05", b"resurrected")
    c.rec(await tr.get_range(b"rg/", b"rg0"))
    await c.commit(tr)
    c.rec(await c.db.transaction().get_range(b"rg/", b"rg0"))


async def range_conflict(c):
    a = c.db.transaction()
    c.rec(await a.get_range(b"rc/", b"rc0"))
    a.set(b"rc/result", b"empty")
    b = c.db.transaction()
    b.set(b"rc/item", b"new")
    await c.commit(b)
    await c.commit(a)  # NotCommitted


async def versionstamps(c):
    tr = c.db.transaction()
    tr.set_versionstamped_key(b"vs/log/" + b"\x00" * 10 + struct.pack("<I", 7), b"entry-1")
    tr.set_versionstamped_value(b"vs/val", b"pre" + b"\x00" * 10 + struct.pack("<I", 3))
    await c.commit(tr)
    c.rec(tr.get_versionstamp())
    tr2 = c.db.transaction()
    c.rec(await tr2.get_range(b"vs/log/", b"vs/log0"), await tr2.get(b"vs/val"))


async def overlay_limits(c):
    MT = c.P.MT
    tr = c.db.transaction()
    for i in range(10):
        tr.set(b"ol/%02d" % i, b"v%d" % i)
    await c.commit(tr)
    tr = c.db.transaction()
    tr.clear_range(b"ol/00", b"ol/04")
    c.rec(await tr.get_range(b"ol/", b"ol0", limit=5))
    tr.atomic_op(MT.APPEND_IF_FITS, b"ol/09", b"+")
    c.rec(await tr.get_range(b"ol/", b"ol0", limit=6))


async def atomics(c):
    """Every atomic op on a stored base and on a missing one, read back in
    the transaction and after the commit; then ADDs that sum exactly."""
    MT = c.P.MT
    ops = [MT.ADD, MT.AND, MT.OR, MT.XOR, MT.APPEND_IF_FITS, MT.MAX, MT.MIN,
           MT.BYTE_MIN, MT.BYTE_MAX, MT.COMPARE_AND_CLEAR]
    base = c.db.transaction()
    for op in ops:
        base.set(b"at/%02d" % int(op), struct.pack("<q", 1000 + int(op)))
    await c.commit(base)
    tr = c.db.transaction()
    for op in ops:
        param = struct.pack("<q", 1000 + int(op)) if op == MT.COMPARE_AND_CLEAR else struct.pack("<q", 77)
        tr.atomic_op(op, b"at/%02d" % int(op), param)
        tr.atomic_op(op, b"at/new/%02d" % int(op), param)
        c.rec(int(op), await tr.get(b"at/%02d" % int(op)))
    await c.commit(tr)
    c.rec(await c.db.transaction().get_range(b"at/", b"at0"))
    for _ in range(10):
        tr = c.db.transaction()
        tr.atomic_op(MT.ADD, b"at/counter", b"\x01\x00")
        await c.commit(tr)
    c.rec(await c.db.transaction().get(b"at/counter"))


async def atomic_then_snapshot(c):
    MT = c.P.MT
    init = c.db.transaction()
    init.set(b"as/ctr", struct.pack("<q", 5))
    await c.commit(init)
    tr = c.db.transaction()
    await tr.get_read_version()
    tr.atomic_op(MT.ADD, b"as/ctr", struct.pack("<q", 1))
    c.rec(await tr.get(b"as/ctr", snapshot=True), await tr.get(b"as/ctr"))
    other = c.db.transaction()
    other.set(b"as/ctr", struct.pack("<q", 100))
    await c.commit(other)
    await c.commit(tr)  # NotCommitted


async def shard_spread(c):
    """Writes over every first byte (every shard and resolver), reads and a
    cross-shard conflict (test_cluster_shapes)."""
    firsts = (0x00, 0x40, 0x80, 0xC0, 0xFF)
    tr = c.db.transaction()
    for f in firsts:
        tr.set(bytes([f]) + b"sp", b"v%d" % f)
    await c.commit(tr)
    tr = c.db.transaction()
    c.rec([await tr.get(bytes([f]) + b"sp") for f in firsts])
    a = c.db.transaction()
    await a.get(b"\x00sp")
    a.set(b"\xc0sp", b"a")
    b = c.db.transaction()
    b.set(b"\x00sp", b"b")
    await c.commit(b)
    await c.commit(a)  # NotCommitted


async def reverse_across_shards(c):
    """Forward, reverse and limited ranges over keys in every shard, under
    an overlay of uncommitted writes and clears (test_reverse_range_*)."""
    rnd = random.Random(7)
    keys = [bytes([b]) + b"rv%02d" % i for i in range(6) for b in (0x10, 0x50, 0x90, 0xD0)]
    tr0 = c.db.transaction()
    for i, k in enumerate(keys):
        tr0.set(k, b"v%d" % i)
    await c.commit(tr0)
    tr = c.db.transaction()
    c.rec(await tr.get_range(b"\x10rv", b"\xd1", limit=100, reverse=True))
    c.rec(await tr.get_range(b"\x10rv", b"\xd1", limit=7, reverse=True))
    c.rec(await tr.get_range(b"\x11", b"\xd0rv03", limit=100, reverse=True))
    for i in range(10):
        k = rnd.choice(keys)
        if rnd.random() < 0.3:
            tr.clear_range(k, bytes([min(k[0] + 1, 255)]))
        else:
            tr.set(k[:1] + b"rw%02d" % i, b"w%d" % i)
    for _ in range(12):
        a, b = sorted((bytes([rnd.randrange(0x10, 0xE0)]), bytes([rnd.randrange(0x10, 0xE0)]) + b"\xff"))
        c.rec(await tr.get_range(a, b, limit=rnd.choice([1, 3, 10, 1000]), reverse=rnd.random() < 0.5))
    c.rec(await tr.get_key(c.P.KeySelector.first_greater_than(b"\x50rv02")))
    c.rec(await tr.get_key(c.P.KeySelector.last_less_than(b"\x90rv00")))


async def grv_batching(c):
    async def one():
        return await c.db.transaction().get_read_version()

    c.rec(await c.P.wait_for_all([c.P.spawn(one()) for _ in range(30)]))


async def contention(c):
    """Concurrent increments with on_error retries: exactly the committed
    ones apply (test_tpu_backend_concurrent_contention)."""
    init = c.db.transaction()
    for k in (b"ct/x", b"ct/y"):
        init.set(k, b"0")
    await c.commit(init)

    async def incr(key):
        tries = []
        for _ in range(30):
            tr = c.db.transaction()
            try:
                v = int(await tr.get(key))
                tr.set(key, b"%d" % (v + 1))
                tries.append(await tr.commit())
                return tries
            except Exception as e:
                tries.append(plain(e))
                await tr.on_error(e)
        return tries

    c.rec(await c.P.wait_for_all([c.P.spawn(incr(k)) for k in [b"ct/x"] * 6 + [b"ct/y"] * 6]))
    tr = c.db.transaction()
    c.rec(await tr.get(b"ct/x"), await tr.get(b"ct/y"))


async def coalesced_reads(c):
    """Same-tick gets of many transactions at one read version: the read
    coalescer sends them as storage multiGets."""
    tr = c.db.transaction()
    for i in range(40):
        tr.set(b"co/%03d" % i, b"v%d" % i)
    await c.commit(tr)
    v = await c.db.transaction().get_read_version()
    trs = [c.db.transaction() for _ in range(5)]
    for t in trs:
        t.set_read_version(v)
    futs = [c.P.spawn(t.get(b"co/%03d" % ((7 * j + i) % 45))) for i, t in enumerate(trs) for j in range(9)]
    c.rec(await c.P.wait_for_all(futs))


async def durable_reads(c):
    """Keys written, then left until they are durable (with a short MVCC
    window the engine holds them and the range index answers): same-tick
    gets, present and absent, and ranges."""
    tr = c.db.transaction()
    for i in range(0, 240, 2):
        tr.set(b"du/%04d" % i, b"d%d" % i)
    await c.commit(tr)
    await c.P.delay(1.5)
    tr = c.db.transaction()
    c.rec(await c.P.wait_for_all([c.P.spawn(tr.get(b"du/%04d" % (7 * j % 240))) for j in range(60)]))
    c.rec(await tr.get_range(b"du/0100", b"du/0131"), await tr.get_range(b"du/", b"du0", limit=5, reverse=True))
    c.rec(await tr.get_key(c.P.KeySelector.first_greater_or_equal(b"du/0101")))


async def run_mix(c):
    """bench_e2e's shape at toy size: actors of transactions of parallel
    gets and one set over a small keyspace, every outcome recorded."""
    rnd = random.Random(11)
    tr = c.db.transaction()
    for i in range(64):
        tr.set(b"mx/%04d" % i, b"%016d" % i)
    await c.commit(tr)

    async def actor(a):
        seen = []
        for _ in range(4):
            keys = [b"mx/%04d" % rnd.randrange(64) for _ in range(5)]
            for _ in range(10):
                tr = c.db.transaction()
                try:
                    vals = await c.P.wait_for_all([c.P.spawn(tr.get(k)) for k in keys])
                    tr.set(keys[0], b"a%d" % a)
                    seen.append((vals, await tr.commit()))
                    break
                except Exception as e:
                    seen.append(plain(e))
                    await tr.on_error(e)
        return seen

    c.rec(await c.P.wait_for_all([c.P.spawn(actor(a)) for a in range(8)]))


async def bulk_load(c):
    """ReadWriteWorkload.setup's shape at toy size: transactions of 200
    sequential sets, one after another, each past every key before it;
    then every key read back."""
    for b in range(8):
        tr = c.db.transaction()
        for i in range(b * 200, (b + 1) * 200):
            tr.set(b"rw/%08d" % i, b"%016d" % i)
        await c.commit(tr)
    tr = c.db.transaction()
    c.rec(await tr.get_range(b"rw/", b"rw0", limit=10_000))


LOAD_SCENARIOS = {"bulk_load": bulk_load}  # not among SCENARIOS: run on its own

SCENARIOS = {f.__name__: f for f in (
    set_commit_get, read_your_writes, conflicts, blind_writes, causal, ranges,
    range_conflict, versionstamps, overlay_limits, atomics, atomic_then_snapshot,
    shard_spread, reverse_across_shards, grv_batching, contention, coalesced_reads,
    durable_reads, run_mix,
)}

RESOLVER_KEYS = ("resolveBatchIn", "transactions", "conflicts", "tooOld", "version")


def run_commit(pkg: str, scenarios=tuple(SCENARIOS), seed: int = 0, backend: str = "oracle",
               shape: dict = None, balancer: bool = False, buggify: bool = False,
               resolver_kw: dict = None, knobs: dict = None, **cluster_kw) -> dict:
    """The transcript of one run (see the module docstring). ``cluster_kw``
    goes to ``Cluster`` (the port takes ``device``); ``resolver_kw`` to every
    ``Resolver`` the cluster builds (the mesh's ``n_parts``). The port's
    static cluster gives each storage server its own ``SimDisk``; the JAX
    one keeps storage in memory, so its ``StorageServer`` gets the same
    disk here."""
    P = package(pkg)
    sim = P.Sim(seed, knobs=P.Knobs(**(knobs or {})), chaos=buggify)
    sim.activate()
    cluster_mod = P.cluster
    real_resolver, real_storage = cluster_mod.Resolver, cluster_mod.StorageServer
    if resolver_kw:
        cluster_mod.Resolver = lambda *a, **kw: real_resolver(*a, **{**kw, **resolver_kw})
    if pkg == "foundationdb_tpu":
        cluster_mod.StorageServer = lambda **kw: real_storage(disk=sim.disk(f"ss{kw['tag']}"), **kw)
    try:
        cluster = P.server.Cluster(
            sim, P.server.ClusterConfig(conflict_backend=backend, **(shape or {})), **cluster_kw
        )
        cluster_mod.Resolver, cluster_mod.StorageServer = real_resolver, real_storage
        if balancer:
            cluster.start_resolution_balancer()
        db = P.Database(sim, cluster.proxy_addrs)
        out = {"scenarios": {}}

        async def main():
            for name in scenarios:
                rec = out["scenarios"][name] = []
                await {**SCENARIOS, **LOAD_SCENARIOS}[name](Ctx(P, sim, cluster, db, rec))
            await P.delay(1.0)  # idle proxies commit empty batches meanwhile
            return True

        sim.run_until_done(P.spawn(main()), limit=600.0)
        out["proxies"] = [plain(p.stats.snapshot()) for p in cluster.proxies]
        out["resolvers"] = [
            {k: r.stats.snapshot()[k] for k in RESOLVER_KEYS} for r in cluster.resolvers
        ]
        out["storages"] = [plain(s.stats.snapshot()) for s in cluster.storages]
        out["guards"] = [(r.cs.health, r.cs.c_failovers) for r in cluster.resolvers]
        out["ladders"] = [{k: r.cs.metrics.snapshot().get(k) for k in ("overflowReplays", "capacityGrowths")}
                          for r in cluster.resolvers]
        out["master"] = (cluster.master.last_assigned, cluster.master.live_committed)
        out["resolver_map"] = [(b, e, r.address) for b, e, r in cluster.resolver_map.ranges()]
        if cluster.balancer is not None:  # the boundaries it moved
            out["resolver_map"] = [(b, e, r.address) for b, e, r in cluster.balancer.map.ranges()]
        out["now"] = sim.loop.now()
        return out
    finally:  # leave no loop and no armed chaos behind for the next test
        cluster_mod.Resolver, cluster_mod.StorageServer = real_resolver, real_storage
        P.set_loop(None)
        P.set_buggify(P.Buggify(None))
