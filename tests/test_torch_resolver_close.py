"""A destroyed resolver frees its conflict set's device memory.

At a recovery the surviving workers destroy the old generation's
resolvers (``worker._gc_roles`` → ``_destroy`` → ``Resolver.close``). The
resolver's actors hold it in reference cycles, which only the collector
frees, and never while the collector is frozen (``gc.freeze``, as
``chip_smoke.py`` does after its loads). ``close`` drops the guard's
backend and the backend drops its grid and in-flight groups, so the
tensors are freed at destruction whatever still holds the resolver. The
roles of the killed process stay alive by design: the Sim keeps its
``Worker``.

What holds a destroyed resolver for a while, besides a frozen collector:
its metrics actor, cancelled while parked on ``delay``, leaves its wake
callback on that timer, and the task's ``Cancelled`` keeps the actor's
frame (and through it the resolver) until the timer fires, one
``METRICS_TRACE_INTERVAL`` later."""

import gc
import threading
import weakref

import pytest
import torch

from foundationdb_tpu_torch.client.database import Database
from foundationdb_tpu_torch.conflict import failover
from foundationdb_tpu_torch.conflict.api import CommitTransaction, new_conflict_set
from foundationdb_tpu_torch.conflict.errors import ConflictSetClosedError, KernelDeviceLostError
from foundationdb_tpu_torch.conflict.failover import HEALTHY, GuardedConflictSet
from foundationdb_tpu_torch.conflict.faults import FaultInjectingConflictSet, KernelFaultInjector
from foundationdb_tpu_torch.net.sim import Sim
from foundationdb_tpu_torch.runtime.futures import delay, spawn
from foundationdb_tpu_torch.runtime.knobs import Knobs
from foundationdb_tpu_torch.runtime.loop import EventLoop, RealLoop, set_loop
from foundationdb_tpu_torch.runtime.rng import DeterministicRandom
from foundationdb_tpu_torch.server import interfaces as ifs
from foundationdb_tpu_torch.server.cluster import ClusterConfig, DynamicCluster
from foundationdb_tpu_torch.server.resolver import Resolver
from foundationdb_tpu_torch.server.worker import Worker

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


def _grid_tensors(cs):
    """The device tensors of a guard's backend (one grid or the stack)."""
    inner = getattr(cs.primary, "inner", cs.primary)
    return list(inner._state if hasattr(inner, "_state") else inner._states)


def _batches(n=6):
    out = []
    for i in range(n):
        txs = [CommitTransaction(read_snapshot=10 * i, read_conflict_ranges=[(b"k%03d" % j, b"k%03d" % (j + 2))],
                                 write_conflict_ranges=[(b"k%03d" % (j + 1), b"k%03d" % (j + 3))])
               for j in range(0, 40, 3)]
        out.append((txs, 10 * (i + 1), 0))
    return out


def _master_kill(backend, freeze, settle=0.0, device="cpu", on_destroy=None):
    """A two-resolver dynamic cluster through a master kill: the first
    generation's resolvers with weak references to each one, its guard,
    backend and grid tensors, and the killed worker's address.
    ``on_destroy(role handle, destroy)``, when given, runs each role's
    destruction."""
    sim = Sim(7)
    sim.activate()
    cluster = DynamicCluster(sim, ClusterConfig(n_resolvers=2, n_storage=2, conflict_backend=backend),
                             n_coordinators=3, device=device)
    db = Database.from_coordinators(sim, cluster.coordinators)

    def resolvers():
        return [(addr, h.obj) for addr, p in sim.processes.items() if getattr(p, "worker", None) is not None
                for h in p.worker.roles.values() if h.kind == "resolver"]

    async def put(lo, hi, idle=1.0):
        for i in range(lo, hi):
            async def body(tr, i=i):
                tr.set(b"k%04d" % i, b"v")
            await db.run(body)
        await delay(idle)
        return True

    sim.run_until_done(spawn(put(0, 30)), 300)
    old = [(addr, weakref.ref(r), weakref.ref(r.cs), weakref.ref(r.cs.primary),
            [weakref.ref(t) for t in _grid_tensors(r.cs)]) for addr, r in resolvers()]
    master = next(a for a, p in sim.processes.items() if getattr(p, "worker", None) is not None
                  and any(h.kind == "master" for h in p.worker.roles.values()))
    if freeze:
        gc.collect()
        gc.freeze()
    destroy = Worker._destroy
    if on_destroy is not None:
        Worker._destroy = lambda self, uid: on_destroy(self.roles.get(uid), lambda: destroy(self, uid))
    try:
        sim.kill_process(master)
        sim.run_until_done(spawn(put(30, 60, 1.0 + settle)), 300)
        new = {id(r) for _a, r in resolvers()}
        gc.collect()
        return old, master, new, sim
    finally:
        Worker._destroy = destroy
        if freeze:
            gc.unfreeze()


@pytest.fixture(autouse=True)
def _no_loop_left():
    yield
    set_loop(None)
    gc.collect()


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_destroyed_resolvers_grids_are_freed_at_once(backend):
    old, master, new, _sim = _master_kill(backend, freeze=False)
    destroyed = [o for o in old if o[0] != master]
    assert destroyed, "every old resolver was on the killed worker"
    for _addr, resolver, guard, backend_ref, tensors in destroyed:
        assert all(t() is None for t in tensors)


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_destroyed_resolvers_are_collected_once_their_timers_fire(backend):
    old, master, new, _sim = _master_kill(backend, freeze=False, settle=11.0)
    destroyed = [o for o in old if o[0] != master]
    assert destroyed
    for _addr, resolver, guard, backend_ref, tensors in destroyed:
        assert resolver() is None and guard() is None and backend_ref() is None


def test_frozen_destroyed_resolvers_free_their_grids_at_destruction():
    old, master, new, _sim = _master_kill("torch", freeze=True)
    destroyed = [o for o in old if o[0] != master]
    assert destroyed
    for _addr, resolver, guard, _backend, tensors in destroyed:
        # the frozen collector keeps the role itself; its grid is gone
        assert resolver() is not None and id(resolver()) not in new
        assert all(t() is None for t in tensors)
        # what it measured stays readable
        kernel = resolver().stats.snapshot()["kernel"]
        assert kernel["occupancy"]["bucketCount"] > 0 and kernel["health"]["backend"].startswith("Torch")
    for addr, resolver, _guard, _backend, tensors in old:
        if addr == master:  # the killed worker keeps its roles
            assert resolver() is not None and all(t() is not None for t in tensors)


@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
@pytest.mark.parametrize("injected", [False, True])
def test_close_drops_every_grid_tensor(backend, injected):
    set_loop(EventLoop(1))  # the injector reads the loop's clock
    cs = new_conflict_set(backend, device="cpu", capacity=256)
    if injected:
        cs = FaultInjectingConflictSet(cs, KernelFaultInjector(DeterministicRandom(1), 0, 0, 0, 0, 0, 0))
    guard = GuardedConflictSet("oracle")
    guard._cs = cs
    for txs, now, old in _batches():
        cs.detect_batch(txs, now, old)
    tensors = [weakref.ref(t) for t in _grid_tensors(guard)]
    occupancy = guard.metrics.snapshot()["occupancy"]
    guard.close()
    assert all(t() is None for t in tensors)
    assert guard.metrics.snapshot()["occupancy"] == occupancy


def _quiet_injector(loop):
    return KernelFaultInjector(loop.random.fork(), 0, 0, 0, 0, 0, 0)


def _counting_builds(monkeypatch) -> list:
    """Every backend the guards build from now on (rebuild, failover,
    re-probe), by kind."""
    built, build = [], failover.new_conflict_set
    monkeypatch.setattr(failover, "new_conflict_set", lambda kind, **kw: built.append(kind) or build(kind, **kw))
    return built


def test_a_closed_guard_builds_no_backend_and_raises_closed(monkeypatch):
    loop = EventLoop(3)
    set_loop(loop)
    guard = GuardedConflictSet("torch", uid="r0", fault_injector=_quiet_injector(loop), device="cpu", capacity=256)
    (txs, now, old), later = _batches(2)
    guard.detect_batch(txs, now, old)
    tensors = [weakref.ref(t) for t in _grid_tensors(guard)]
    built = _counting_builds(monkeypatch)
    guard.close()
    assert all(t() is None for t in tensors)
    for call in (lambda: guard.recover_resolve(later[0], later[1], 0, err=KernelDeviceLostError("lost")),
                 lambda: guard.detect_batch(*later),
                 lambda: guard.detect_many_encoded_async([((guard.generation, None), later[1], 0)]),
                 lambda: guard.encode(later[0]),
                 lambda: guard.clear(later[1])):
        with pytest.raises(ConflictSetClosedError):
            call()
    assert built == [] and guard.health == HEALTHY and guard.c_faults == 0


def test_a_batch_in_flight_at_close_frees_its_grid_and_rebuilds_nothing(monkeypatch):
    """A batch submitted through the resolver is on its device thread, under
    the guard's lock, when the role is destroyed; the injector then raises a
    device loss. ``close`` returns at once, the dispatch frees the grid as
    it leaves, and the recovery the fault asks for raises
    ``ConflictSetClosedError`` instead of building a backend."""
    loop = RealLoop(5)
    set_loop(loop)
    inj = _quiet_injector(loop)
    r = Resolver(knobs=Knobs(CONFLICT_DISPATCH_DEADLINE=60.0), backend="torch", uid="r0", device="cpu",
                 fault_injector=inj, capacity=256)
    inner = r.cs.primary
    entered, release = threading.Event(), threading.Event()

    def on_dispatch():
        entered.set()
        release.wait(30)
        raise KernelDeviceLostError("injected device loss")

    inj.on_dispatch = on_dispatch
    built = _counting_builds(monkeypatch)
    txs = [(5, [(b"a", b"b")], [(b"c", b"d")])]
    req = ifs.ResolveBatchRequest(
        version=10, prev_version=0, last_receive_version=0, requesting_proxy="px",
        transactions=[ifs.TransactionData(read_snapshot=s, read_conflict_ranges=rd, write_conflict_ranges=wr,
                                          mutations=[]) for s, rd, wr in txs])
    held = {}

    async def destroy_mid_dispatch():
        while not entered.is_set():
            await delay(0.001)
        r.close()
        held["grid"] = inner._state is not None  # the dispatch holds the lock: freed later
        release.set()

    fut = spawn(r.resolve(req))
    spawn(destroy_mid_dispatch())
    loop.run(until=60.0, stop_when=fut.is_ready)
    try:
        assert fut.is_ready()
        with pytest.raises(ConflictSetClosedError):
            fut.get()
        assert held == {"grid": True}
        assert inner._state is None and built == []
        assert r.cs.c_failovers == 0 and r.cs.c_rebuilds == 0
    finally:
        r.close()  # stops the executor the recovery's job started
        loop.close()
