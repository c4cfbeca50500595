"""The bindingtester runs of ``tests/test_bindingtester.py``, in either package.

``run_real(pkg, seed, n_ops, ...)`` generates the seeded stream with the
package's ``StreamGenerator``, stores it in a static ``Cluster`` on the
package's ``Sim``, runs the package's ``StackMachine`` over it and returns
the stream with the final data rows and the logged stack rows.
``run_model(pkg, stream)`` runs the same stream through the package's
``ModelDatabase``. ``run_stream(pkg, stream, seed, ...)`` runs a hand-made
stream (no generator) and returns the logged rows. Each package runs its
own default conflict backend (``oracle`` in the reference, ``torch`` in
the port, here on the CPU), so two packages' runs of one seed compare
with ``==``.

Imports neither package at module level.
"""

from __future__ import annotations

import importlib
from contextlib import contextmanager
from types import SimpleNamespace

REFERENCE = "foundationdb_tpu"
PORT = "foundationdb_tpu_torch"

INS_PREFIX = b"bt/i"
DATA_PREFIX = b"bt/d/"
RESULT_PREFIX = b"bt/r/"


def package(pkg: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg,
        bindings=mod("bindings"), generator=mod("bindings.generator"),
        Database=mod("client").Database, T=mod("layers.tuple"), Sim=mod("net.sim").Sim,
        spawn=mod("runtime.futures").spawn, server=mod("server"),
        Knobs=mod("runtime.knobs").Knobs, wire=mod("net.wire"), futures=mod("runtime.futures"),
        set_loop=mod("runtime.loop").set_loop, buggify=mod("runtime.buggify"),
    )


@contextmanager
def sim_of(P, seed, chaos=False, knobs=None):
    """The package's activated ``Sim``; no loop and no armed buggify left
    behind (a chaos Sim arms the package's global buggify, which later
    code in the process would otherwise draw from)."""
    sim = P.Sim(seed=seed, chaos=chaos, knobs=knobs)
    sim.activate()
    try:
        yield sim
    finally:
        P.buggify.set_buggify(P.buggify.Buggify(None))
        P.set_loop(None)


def cluster(P, sim, **cfg):
    """The package's static cluster; the port's on the CPU."""
    kw = {"device": "cpu"} if P.pkg == PORT else {}
    return P.server.Cluster(sim, P.server.ClusterConfig(**cfg), **kw)


def knobs(P, **overrides):
    k = P.Knobs()
    for name, value in overrides.items():
        setattr(k, name, value)
    return k


def run_real(pkg, seed, n_ops, chaos=False, knob_overrides=None, **cfg):
    P = package(pkg)
    with sim_of(P, seed, chaos, knobs(P, **knob_overrides) if knob_overrides else None) as sim:
        return _run_real(P, sim, seed, n_ops, **cfg)


def _run_real(P, sim, seed, n_ops, **cfg):
    c = cluster(P, sim, **cfg)
    db = P.Database(sim, c.proxy_addrs)
    gen = P.generator.StreamGenerator(seed, data_prefix=DATA_PREFIX)
    stream = gen.generate(n_ops, result_prefix=RESULT_PREFIX, machine_prefix=INS_PREFIX)

    async def go():
        await P.generator.store_instructions(db, INS_PREFIX, stream)
        machine = P.bindings.StackMachine(db, INS_PREFIX)
        await machine.run_from_db()

        async def read_all(tr):
            data = await tr.get_range(DATA_PREFIX, DATA_PREFIX + b"\xff")
            log = await tr.get_range(RESULT_PREFIX, RESULT_PREFIX + b"\xff")
            return data, log

        return await db.run(read_all)

    data, log = sim.run_until_done(P.spawn(go()), 3600.0)
    return stream, list(data), list(log)


def run_model(pkg, stream):
    """The oracle side: same machine, the package's model database, with
    the instruction rows stored in the model too (selector walks navigate
    the whole keyspace)."""
    P = package(pkg)
    with sim_of(P, 0) as sim:  # an event loop for the async surface
        return _run_model(P, sim, stream)


def _run_model(P, sim, stream):
    db = P.bindings.ModelDatabase()

    async def go():
        await P.generator.store_instructions(db, INS_PREFIX, stream)
        machine = P.bindings.StackMachine(db, INS_PREFIX)
        await machine.run_stream(stream)
        data = sorted((k, v) for k, v in db.data.items() if k.startswith(DATA_PREFIX))
        log = sorted((k, v) for k, v in db.data.items() if k.startswith(RESULT_PREFIX))
        return data, log

    data, log = sim.run_until_done(P.spawn(go()), 3600.0)
    return list(data), list(log)


def run_stream(pkg, stream, seed, store=False, **cfg):
    """A hand-made stream through the real client: the logged rows."""
    P = package(pkg)
    with sim_of(P, seed) as sim:
        return _run_stream(P, sim, stream, store, **cfg)


def _run_stream(P, sim, stream, store, **cfg):
    c = cluster(P, sim, **cfg)
    db = P.Database(sim, c.proxy_addrs)

    async def go():
        if store:
            await P.generator.store_instructions(db, INS_PREFIX, stream)
        machine = P.bindings.StackMachine(db, INS_PREFIX)
        await machine.run_stream(stream)

        async def read_log(tr):
            return await tr.get_range(RESULT_PREFIX, RESULT_PREFIX + b"\xff")

        return await db.run(read_log)

    return list(sim.run_until_done(P.spawn(go()), 600.0))
