"""Seeded chaos-soak runs, the same in either package.

``run_soak(pkg, fn, seed, mesh=False, **kw)`` runs ``tools.soak.<fn>`` of
the package named by ``pkg`` (``"foundationdb_tpu"`` or
``"foundationdb_tpu_torch"``; the port on the CPU) on a fresh trace log and
returns a transcript of plain Python values: what the run returned, with
each fired buggify site named by its file, the stripped text of its line
and that text's occurrence in the file (the packages' line numbers
differ) and the drawn backend under the port's name; every trace event of
the run; the roles, guards and recovery each live worker holds at the end;
the sim clock; and the database the ConsistencyCheck read at the end (its
rows, or None where the run has no ConsistencyCheck). Two packages' runs
of the same seed compare with ``==``, with the differences
``tests/workload_slice.py`` takes out.

The reference's ``tpu`` draw is its mesh when JAX shows several devices
and one grid otherwise. ``mesh`` picks one for both packages: the
reference's mesh on ``tests/conftest.py``'s 8 virtual devices against the
port's ``torch_mesh`` with 8 partitions (the port's ``tools.soak`` maps
``tpu`` to one grid, so the run patches its ``port_backend``), or the
reference's ``tpu1`` against the port's ``torch``. ``mixed_soak`` and ``watch_storm`` build
their cluster with the default backend, ``torch`` in the port and
``oracle`` in the reference: both run ``oracle`` here. Their subject is
the storage engine and the watches, and with ``tpu1`` the reference's
mixed soak resolves its 2,372 batches through JAX on the CPU for minutes.

Imports neither package at module level: the card tests import it on a
machine without JAX.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import os

from commit_slice import plain
from dynamic_slice import guards, recoveries, roles
from workload_slice import PORT, REFERENCE, event_fields, pinned

MESH_PARTS = 8  # tests/conftest.py's virtual devices: the reference mesh's partitions


def site_name(site) -> str:
    """A fired buggify site as ``file:occurrence:text`` (code sites) or its
    tag (named sites)."""
    f, tag = site
    if not isinstance(tag, int):
        return str(tag)
    with open(f) as fh:
        lines = fh.read().splitlines()
    text = lines[tag - 1].strip()
    occurrence = sum(1 for line in lines[: tag - 1] if line.strip() == text)
    return f"{os.path.basename(f)}:{occurrence}:{text}"


def backend_name(name: str, mesh: bool = False) -> str:
    """A conflict backend under the port's name: ``tpu1`` is one grid
    (``torch``); ``tpu`` is one grid too, or with ``mesh`` the 8-partition
    ``torch_mesh`` the reference's mesh stands against."""
    if name == "tpu" and mesh:
        return "torch_mesh"
    return "torch" if name in ("tpu", "tpu1") else name


@contextlib.contextmanager
def consistency_image(pkg: str):
    """Yields a dict whose ``"image"`` becomes, once ``pkg``'s
    ConsistencyCheck passes, the sorted ``(key, value)`` rows it read from
    the replicas: the database at the end of the run. The rows are taken
    from the replies the check already gets; nothing is sent."""
    cc = importlib.import_module(f"{pkg}.workloads.consistency_check")
    real = cc.ConsistencyCheckWorkload._check_once
    seen = {"image": None}

    async def check_once(self):
        rows, client = set(), self.db.client
        request = client.request

        def record(reply):
            if not reply.is_error():
                rows.update((bytes(key), bytes(value)) for key, value in reply.get().data)

        def recording(endpoint, req, *a, **k):
            reply = request(endpoint, req, *a, **k)
            if isinstance(req, cc.GetKeyValuesRequest):
                reply.add_callback(record)
            return reply

        client.request = recording
        try:
            out = await real(self)
        finally:
            del client.request
        seen["image"] = sorted(rows)
        return out

    cc.ConsistencyCheckWorkload._check_once = check_once
    try:
        yield seen
    finally:
        cc.ConsistencyCheckWorkload._check_once = real


def run_soak(pkg: str, fn: str, seed: int, mesh: bool = False, **kw) -> dict:
    """The transcript of ``tools.soak.<fn>(seed, **kw)`` in ``pkg`` (see the
    module docstring)."""
    soak = importlib.import_module(f"{pkg}.tools.soak")
    resolver = importlib.import_module(f"{pkg}.server.resolver")
    real_sim, real_resolver, real_config = soak.Sim, resolver.Resolver, soak.ClusterConfig
    real_port_backend = getattr(soak, "port_backend", None)
    sims = []
    soak.Sim = lambda *a, **k: sims.append(real_sim(*a, **k)) or sims[-1]
    if pkg == REFERENCE:
        if mesh:
            import jax

            jax.devices()  # the reference's ``tpu`` is its mesh once JAX is up
        else:
            resolver.Resolver = lambda *a, backend="oracle", **k: real_resolver(
                *a, backend="tpu1" if backend == "tpu" else backend, **k)
    else:
        if mesh:
            soak.port_backend = functools.partial(backend_name, mesh=True)
            resolver.Resolver = lambda *a, backend="oracle", **k: real_resolver(
                *a, backend=backend, **({"n_parts": MESH_PARTS} if backend == "torch_mesh" else {}), **k)
        kw = {"device": "cpu", **kw}
    if fn != "run_one":
        soak.ClusterConfig = functools.partial(real_config, conflict_backend="oracle")
    try:
        with pinned(pkg) as log, consistency_image(pkg) as image:
            out = getattr(soak, fn)(seed=seed, **kw)
            (sim,) = sims
            if fn == "run_one":
                out = dict(out)
                out["buggify_sites"] = sorted(site_name(s) for s in sim.buggify.fired)
                cfg = dict(out["config"])
                cfg["conflict_backend"] = backend_name(cfg["conflict_backend"], mesh)
                out["config"] = cfg
            transcript = {
                "summary": plain(out), "events": [event_fields(e) for e in log.events],
                "roles": roles(sim), "guards": guards(sim), "recoveries": recoveries(sim),
                "now": sim.loop.now(), "image": image["image"],
            }
            del sim, sims[:]
        return transcript
    finally:  # leave no patched class behind
        soak.Sim, resolver.Resolver, soak.ClusterConfig = real_sim, real_resolver, real_config
        if real_port_backend is not None:
            soak.port_backend = real_port_backend
