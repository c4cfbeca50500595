"""A resolve in flight when its resolver is retired ends in BrokenPromise.

At a recovery the surviving workers destroy the old generation's
resolvers (``worker._destroy`` → ``Resolver.close``), and the closed
guard raises ``ConflictSetClosedError`` into any resolve still running
there. The resolver answers such a request as a destroyed role's endpoint
does, with ``BrokenPromise`` (``server.resolver.ResolverRetired``): the
proxy fails the batch with it, the client maps it to
``commit_unknown_result`` and retries, and over TCP it travels as
``broken_promise``, never as a ``RemoteError``. The guard itself still
raises ``ConflictSetClosedError`` (tests/test_torch_resolver_close.py).
The JAX package's retired resolver answers instead: it has no closed
guard, so there is no reference transcript to hold this to."""

import gc
import socket

import pytest
import torch

from foundationdb_tpu_torch.client.database import Database
from foundationdb_tpu_torch.conflict.errors import ConflictSetClosedError
from foundationdb_tpu_torch.errors import CommitUnknownResult, FdbError
from foundationdb_tpu_torch.net.sim import BrokenPromise, Endpoint, Sim
from foundationdb_tpu_torch.net.tcp import RealWorld, RemoteError
from foundationdb_tpu_torch.runtime import trace
from foundationdb_tpu_torch.runtime.futures import spawn
from foundationdb_tpu_torch.runtime.knobs import Knobs
from foundationdb_tpu_torch.runtime.loop import RealLoop, set_loop
from foundationdb_tpu_torch.server import interfaces as ifs
from foundationdb_tpu_torch.server.cluster import ClusterConfig, DynamicCluster
from foundationdb_tpu_torch.server.resolver import Resolver, ResolverRetired

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


@pytest.fixture(autouse=True)
def _fresh_trace_log():
    saved = trace.trace_log()
    log = trace.TraceLog()
    trace.set_trace_log(log)
    yield log
    trace.set_trace_log(saved)
    set_loop(None)
    gc.collect()


def _retire_first_busy_resolve(monkeypatch, hosts: dict) -> list:
    """From now on, the first resolve that carries transactions retires its
    resolver (``Worker._destroy`` of its role, found in ``hosts``: id of
    the resolver → (worker, uid)) once it has started, then runs on. Returns
    the list that receives the retired resolver's uid."""
    retired, resolve = [], Resolver._resolve_traced

    async def retiring(self, req, rsp, t_total):
        if not retired and req.transactions and id(self) in hosts:
            worker, uid = hosts[id(self)]
            retired.append(uid)
            worker._destroy(uid)
        return await resolve(self, req, rsp, t_total)

    monkeypatch.setattr(Resolver, "_resolve_traced", retiring)
    return retired


def test_a_resolve_in_flight_at_retirement_ends_in_broken_promise_and_the_client_commits(
        monkeypatch, _fresh_trace_log):
    """On the port's Sim: a resolver retired while it resolves a commit
    batch. The proxy's batch fails with ``BrokenPromise`` (not the closed
    guard's error, which it would pass on to the client as it is), the
    client sees ``commit_unknown_result``, retries through ``on_error`` and
    commits once the master has recovered from the role's death; the write
    reads back."""
    sim = Sim(11)
    sim.activate()
    cluster = DynamicCluster(sim, ClusterConfig(n_resolvers=2, n_storage=2, conflict_backend="torch"),
                             n_coordinators=3, device="cpu")
    db = Database.from_coordinators(sim, cluster.coordinators)

    async def put(key, value):
        async def body(tr):
            tr.set(key, value)
        await db.run(body)
        return True

    sim.run_until_done(spawn(put(b"c10/warm", b"v")), 300)
    hosts = {id(h.obj): (p.worker, uid) for p in sim.processes.values() if getattr(p, "worker", None) is not None
             for uid, h in p.worker.roles.items() if h.kind == "resolver"}
    assert len(hosts) == 2
    retired = _retire_first_busy_resolve(monkeypatch, hosts)

    async def commit_loop():
        codes = []
        tr = db.transaction()
        while True:
            try:
                tr.set(b"c10/key", b"after-retirement")
                await tr.commit()
                return codes
            except FdbError as e:
                codes.append(type(e))
                await tr.on_error(e)

    codes = sim.run_until_done(spawn(commit_loop()), 300)

    async def read():
        async def body(tr):
            return await tr.get(b"c10/key")
        return await db.run(body)

    assert sim.run_until_done(spawn(read()), 300) == b"after-retirement"
    assert len(retired) == 1 and CommitUnknownResult in codes, (retired, codes)
    # the proxy retransmits a resolve that ends in BrokenPromise, then fails
    # the batch with the last one (the destroyed endpoint's, by then)
    failed = [e["Err"] for e in _fresh_trace_log.events if e["Type"] == "CommitBatchFailed"]
    assert any(retired[0] in err for err in failed), failed
    assert all(err.startswith(("BrokenPromise(", "ResolverRetired(")) for err in failed), failed


def _free_addr() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def test_a_retired_resolvers_answer_over_tcp_is_broken_promise_not_remote_error():
    """Over a loopback socket (two RealWorlds on one RealLoop): a proxy-side
    world asks a resolver world to resolve a batch, and the resolver is
    retired while the request runs. The caller gets ``BrokenPromise``
    naming the resolver, as from a dead endpoint, and no ``RemoteError``;
    the closed guard's own error stays ``ConflictSetClosedError``."""
    loop = RealLoop(seed=4)
    knobs = Knobs(TRANSPORT_LOOPBACK=False)
    caller = RealWorld(_free_addr(), knobs=knobs, loop=loop)
    host = RealWorld(_free_addr(), knobs=knobs, loop=loop)
    try:
        caller.activate()
        r = Resolver(backend="torch", uid="res-tcp", device="cpu", capacity=256)
        calls = []

        async def resolve(req):
            if not calls:
                r.close()  # retired while its resolve runs
            calls.append(req.version)
            return await r.resolve(req)

        host.node.register("resolve#res-tcp", resolve)

        def request(version):
            return ifs.ResolveBatchRequest(
                version=version, prev_version=0, last_receive_version=0, requesting_proxy="px",
                transactions=[ifs.TransactionData(read_snapshot=1, read_conflict_ranges=[(b"a", b"b")],
                                                  write_conflict_ranges=[(b"c", b"d")], mutations=[])])

        async def body():
            try:
                await caller.node.request(Endpoint(host.node.address, "resolve#res-tcp"), request(10))
            except RemoteError as e:
                return ("RemoteError", str(e))
            except BrokenPromise as e:
                return (type(e).__name__, str(e))
            return ("answered", "")

        kind, msg = caller.run_until_done(spawn(body()), 30.0)
        assert kind == "BrokenPromise" and "res-tcp" in msg and "retired" in msg, (kind, msg)
        with pytest.raises(ConflictSetClosedError):
            r.cs.detect_batch([], 20, 0)
        assert issubclass(ResolverRetired, BrokenPromise) and issubclass(ResolverRetired, ConflictSetClosedError)
    finally:
        caller.close()
        host.close()
        loop.close()
