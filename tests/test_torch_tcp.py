"""The port's real TCP transport (``foundationdb_tpu_torch/net/tcp.py``) held
to the JAX package's: the cases of ``tests/test_tcp.py`` run in both
packages with the same outcome, and a port world and a JAX-package world
talk to each other over a real socket (each on its own loop and thread)."""

import socket
import threading
from types import SimpleNamespace

import importlib

import pytest

REFERENCE = "foundationdb_tpu"
PORT = "foundationdb_tpu_torch"


def package(pkg: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    sim, tcp = mod("net.sim"), mod("net.tcp")
    return SimpleNamespace(
        pkg=pkg, wire=mod("net.wire"), tcp=tcp, RealWorld=tcp.RealWorld, RemoteError=tcp.RemoteError,
        BrokenPromise=sim.BrokenPromise, Endpoint=sim.Endpoint, spawn=mod("runtime.futures").spawn,
        RealLoop=mod("runtime.loop").RealLoop, set_loop=mod("runtime.loop").set_loop,
        Knobs=mod("runtime.knobs").Knobs, errors=mod("errors"),
    )


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def make_world(P, loop):
    # real sockets: colocated worlds would otherwise take the loopback
    return P.RealWorld(f"127.0.0.1:{free_port()}", knobs=P.Knobs(TRANSPORT_LOOPBACK=False), loop=loop)


def run_worlds(P, main_world, coro, limit=20.0):
    main_world.activate()
    try:
        return main_world.run_until_done(P.spawn(coro), limit)
    finally:
        P.set_loop(None)


def test_wire_roundtrip_rich_values():
    """The rich metadata values that cross processes at recruitment round
    trip through the port's codec and encode to the JAX package's bytes."""
    outs = {}
    for pkg in (REFERENCE, PORT):
        P = package(pkg)
        KeyRangeMap = importlib.import_module(f"{pkg}.kv.keyrange_map").KeyRangeMap
        mt = importlib.import_module(f"{pkg}.kv.mutations")
        it = importlib.import_module(f"{pkg}.server.interfaces")
        ls = importlib.import_module(f"{pkg}.server.log_system")
        m = KeyRangeMap(default=None)
        m.insert(b"a", b"m", ("team", 1))
        m.insert(b"m", None, ("team", 2))
        tl = ls.TLogSet(epoch=3, logs=(ls.TLogInterface(address="h:1", log_id="l0", tags=(0, 1)),),
                        replication=1)
        vals = [
            None, True, -(1 << 80), 3.5, b"\x00\xff", "héllo",
            (1, [2, {b"k": "v"}], frozenset({1, 2})),
            mt.Mutation(mt.MutationType.SET_VALUE, b"k", b"v"),
            it.CommitRequest(transaction=it.TransactionData(
                read_snapshot=7, mutations=[mt.Mutation(mt.MutationType.SET_VALUE, b"a", b"1")],
                read_conflict_ranges=[(b"a", b"b")], write_conflict_ranges=[(b"a", b"b")])),
            it.ProxyInterface("1.2.3.4:100", "uid-1"),
            ls.LogSystemConfig(epoch=3, current=tl, old=(ls.OldTLogSet(set=tl, end_version=9),)),
            ls.LogSystem(tl),
            P.Knobs(MAX_BATCH_TXNS=7),
        ]
        encoded = []
        for v in vals:
            enc = P.wire.encode_value(v)
            out = P.wire.decode_value(enc)
            if isinstance(v, ls.LogSystem):
                assert out.tlog_set == v.tlog_set
            elif isinstance(v, P.Knobs):
                assert out.as_dict() == v.as_dict()
            else:
                assert out == v or repr(out) == repr(v), (v, out)
            encoded.append(enc)
        enc = P.wire.encode_value(m)
        assert list(P.wire.decode_value(enc).ranges()) == list(m.ranges())
        outs[pkg] = encoded + [enc]
    # the knobs differ in one default only: the port's device backend is
    # named ``torch`` (ROADMAP §C, "No tpu name")
    r_knobs, p_knobs = outs[REFERENCE].pop(-2), outs[PORT].pop(-2)
    assert outs[PORT] == outs[REFERENCE]
    r_knobs = package(REFERENCE).wire.decode_value(r_knobs).as_dict()
    p_knobs = package(PORT).wire.decode_value(p_knobs).as_dict()
    assert {k for k in p_knobs if p_knobs[k] != r_knobs.get(k)} == {"CONFLICT_SET_BACKEND"}
    assert set(p_knobs) == set(r_knobs)


def test_frame_checksum_rejected():
    for pkg in (REFERENCE, PORT):
        wire = package(pkg).wire
        f = bytearray(wire.encode_frame(b"hello"))
        f[-1] ^= 0xFF
        with pytest.raises(wire.WireError):
            wire.decode_frames(f)


def request_reply_and_errors(P, seed):
    loop = P.RealLoop(seed=seed)
    a, b = make_world(P, loop), make_world(P, loop)

    async def echo(x):
        return ("echo", x)

    async def boom(_x):
        raise ValueError("kapow")

    b.node.register("echo", echo)
    b.node.register("boom", boom)

    async def body():
        out = [await a.node.request(P.Endpoint(b.node.address, "echo"), {"n": 1})]
        try:  # unknown token
            await a.node.request(P.Endpoint(b.node.address, "nope"), None)
            out.append("no error")
        except P.BrokenPromise:
            out.append("BrokenPromise")
        try:  # a remote exception outside the named registry
            await a.node.request(P.Endpoint(b.node.address, "boom"), None)
            out.append("no error")
        except P.RemoteError as e:
            out.append(("RemoteError", "kapow" in str(e)))
        a.node.register("self", echo)  # a request to the local node
        out.append(await a.node.request(P.Endpoint(a.node.address, "self"), 5))
        return out

    try:
        return run_worlds(P, a, body())
    finally:
        a.close()
        b.close()
        loop.close()


def test_request_reply_and_errors():
    ref, port = (request_reply_and_errors(package(p), 1) for p in (REFERENCE, PORT))
    assert port == ref == [("echo", {"n": 1}), "BrokenPromise", ("RemoteError", True), ("echo", 5)]


def dead_peer_and_reconnect(P, seed):
    loop = P.RealLoop(seed=seed)
    a = make_world(P, loop)

    async def body():
        out = []
        try:
            await a.node.request(P.Endpoint(f"127.0.0.1:{free_port()}", "x"), None)
            out.append("no error")
        except P.BrokenPromise:
            out.append("dead peer")
        b = make_world(P, loop)  # the peer comes up afterwards: a fresh connect

        async def pong(_x):
            return "pong"

        b.node.register("ping", pong)
        out.append(await a.node.request(P.Endpoint(b.node.address, "ping"), None))
        b.close()  # the peer dies: the next request breaks
        try:
            await a.node.request(P.Endpoint(b.node.address, "ping"), None)
            out.append("no error")
        except P.BrokenPromise:
            out.append("peer closed")
        return out

    try:
        return run_worlds(P, a, body())
    finally:
        a.close()
        loop.close()


def test_dead_peer_and_reconnect():
    ref, port = (dead_peer_and_reconnect(package(p), 2) for p in (REFERENCE, PORT))
    assert port == ref == ["dead peer", "pong", "peer closed"]


def fdb_error_by_class(P, seed):
    loop = P.RealLoop(seed=seed)
    a, b = make_world(P, loop), make_world(P, loop)

    async def conflicted(_x):
        raise P.errors.NotCommitted("conflict")

    b.node.register("c", conflicted)

    async def body():
        try:
            await a.node.request(P.Endpoint(b.node.address, "c"), None)
            return "no error"
        except P.errors.NotCommitted as e:
            return type(e).__module__.split(".")[0]

    try:
        return run_worlds(P, a, body())
    finally:
        a.close()
        b.close()
        loop.close()


def test_fdb_error_propagates_by_class():
    """A remote FdbError comes back as the caller's own package's class."""
    assert [fdb_error_by_class(package(p), 3) for p in (REFERENCE, PORT)] == [REFERENCE, PORT]


def test_named_errors_are_the_ports_own():
    """``TLogStopped`` and ``MoveKeysError`` cross the wire by name and come
    back as the port's classes (the proxy catches them by type)."""
    from foundationdb_tpu_torch.net.tcp import RealWorld, _named_errors
    from foundationdb_tpu_torch.server.movekeys import MoveKeysError
    from foundationdb_tpu_torch.server.tlog import TLogStopped

    assert _named_errors() == {"TLogStopped": TLogStopped, "MoveKeysError": MoveKeysError}
    exc = RealWorld._reply_exc("named", ("TLogStopped", "epoch 3"))
    assert type(exc) is TLogStopped and str(exc) == "epoch 3"
    assert type(RealWorld._reply_exc("fdb", "NotCommitted")).__module__ == "foundationdb_tpu_torch.errors"


def test_a_port_world_and_a_jax_world_talk_over_a_socket():
    """Interop on the wire: a JAX-package world serves on its own loop in a
    thread; the port's world calls it (echo, a typed FdbError, an unknown
    token), and the JAX world calls the port's back."""
    R, P = package(REFERENCE), package(PORT)
    r_port, p_port = free_port(), free_port()
    r_addr, p_addr = f"127.0.0.1:{r_port}", f"127.0.0.1:{p_port}"
    ready, stop, result = threading.Event(), threading.Event(), {}

    def serve_reference():
        loop = R.RealLoop(seed=5)
        world = R.RealWorld(r_addr, knobs=R.Knobs(TRANSPORT_LOOPBACK=False), loop=loop)

        async def echo(x):
            return ("ref-echo", x)

        async def conflicted(_x):
            raise R.errors.NotCommitted("conflict")

        world.node.register("echo", echo)
        world.node.register("conflict", conflicted)

        async def call_port():
            result["from_ref"] = await world.node.request(R.Endpoint(p_addr, "echo"), [1, b"x"])
            return True

        world.activate()
        ready.set()
        try:
            fut = None
            while not stop.is_set():
                if fut is None and "port_up" in result:
                    fut = R.spawn(call_port())
                world.run(until=loop.now() + 0.05)
        finally:
            world.close()
            R.set_loop(None)
            loop.close()

    t = threading.Thread(target=serve_reference, daemon=True)
    t.start()
    assert ready.wait(30)
    loop = P.RealLoop(seed=6)
    world = P.RealWorld(p_addr, knobs=P.Knobs(TRANSPORT_LOOPBACK=False), loop=loop)

    async def echo(x):
        return ("port-echo", x)

    world.node.register("echo", echo)

    async def body():
        out = [await world.node.request(P.Endpoint(r_addr, "echo"), {"k": (1, 2)})]
        try:
            await world.node.request(P.Endpoint(r_addr, "conflict"), None)
        except P.errors.NotCommitted:
            out.append("NotCommitted")
        try:
            await world.node.request(P.Endpoint(r_addr, "nope"), None)
        except P.BrokenPromise:
            out.append("BrokenPromise")
        result["port_up"] = True
        from foundationdb_tpu_torch.runtime.futures import delay

        for _ in range(200):
            if "from_ref" in result:
                break
            await delay(0.05)
        return out

    try:
        out = run_worlds(P, world, body(), 30.0)
    finally:
        stop.set()
        t.join(30)
        world.close()
        loop.close()
    assert out == [("ref-echo", {"k": (1, 2)}), "NotCommitted", "BrokenPromise"]
    assert result["from_ref"] == ("port-echo", [1, b"x"])



_ACTOR_ERRORS = r"""
import random
import socket
import sys
from types import SimpleNamespace
sys.path.insert(0, {repo!r})
from {pkg}.client.loadbalance import QueueModel, load_balanced_request
from {pkg}.errors import FutureVersion
from {pkg}.net.tcp import RealWorld
from {pkg}.runtime.futures import delay, spawn


def free_addr():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{{port}}"


world = RealWorld(free_addr(), die_on_actor_error=True)
replicas = [RealWorld(free_addr(), loop=world.loop) for _ in range(2)]


async def lagging(_req):
    await delay(0.05)
    raise FutureVersion()


for r in replicas:
    r.node.register("read", lagging)
world.activate()
db = SimpleNamespace(client=world.node, queue_model=QueueModel(), rng=random.Random(0))


async def hedged_read():
    try:
        await load_balanced_request(db, [r.node.address for r in replicas], "read", None)
    except FutureVersion:
        return "read FutureVersion"


print(world.run_until_done(spawn(hedged_read()), 5.0), flush=True)
world.run(until=world.loop.now() + 0.3)
print("alive after the hedged read", flush=True)


async def ends_with(err):
    await delay(0.01)
    raise err


world.node.spawn(ends_with(FutureVersion()))
world.run(until=world.loop.now() + 0.3)
print("alive after FutureVersion", flush=True)
"""


def actor_errors(pkg: str):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _ACTOR_ERRORS.format(repo=repo, pkg=pkg)],
                         capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout.splitlines()


def test_a_hedged_reads_losing_entrant_kills_no_server():
    """A server process (``die_on_actor_error``) survives a hedged read
    whose entrants end with FutureVersion, as when the storage servers lag:
    the race reads their error (ROADMAP §C). The JAX package's process dies
    of it. An actor of its own that ends with FutureVersion kills the
    port's process as it kills the reference's."""
    assert actor_errors(REFERENCE) == (44, [])
    assert actor_errors(PORT) == (44, ["read FutureVersion", "alive after the hedged read"])


_LOCKED_PUSH = r"""
import socket
import sys
sys.path.insert(0, {repo!r})
from {pkg}.net.tcp import RealWorld
from {pkg}.runtime.futures import spawn
from {pkg}.server.log_system import LogSystem, TLogInterface, TLogSet
from {pkg}.server.tlog import TLogStopped


def free_addr():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{{port}}"


world = RealWorld(free_addr(), die_on_actor_error=True)
tlogs = [RealWorld(free_addr(), loop=world.loop) for _ in range(2)]
logs = []
for i, t in enumerate(tlogs):
    log = TLogInterface(t.node.address, f"log-{{i}}", (i,))

    async def locked(_req, log=log):
        raise TLogStopped(f"tlog {{log.log_id}} locked at 2")

    t.node.register(f"tlog.commit#{{log.log_id}}", locked)
    logs.append(log)
world.activate()
log_system = LogSystem(TLogSet(epoch=1, logs=tuple(logs), replication=1))


async def push():
    try:
        await log_system.push(world.node, 0, 1, {{0: [b"m"], 1: [b"m"]}})
    except TLogStopped:
        return "push TLogStopped"


print(world.run_until_done(spawn(push()), 5.0), flush=True)
world.run(until=world.loop.now() + 0.3)
print("alive after the locked push", flush=True)
"""


def test_a_push_to_locked_tlogs_kills_no_server():
    """A server process (``die_on_actor_error``) that hosts a proxy survives
    a tlog push that a recovering master's lock answers with TLogStopped:
    the push reads each entrant's error and the proxy ends its epoch
    (ROADMAP §C). The JAX package's process dies of it, as a port server
    did when the master's host was killed under load on the H100."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(pkg):
        out = subprocess.run(
            [sys.executable, "-c", _LOCKED_PUSH.format(repo=repo, pkg=pkg)],
            capture_output=True, text=True, timeout=120,
        )
        return out.returncode, out.stdout.splitlines()

    assert run(REFERENCE) == (44, [])
    assert run(PORT) == (0, ["push TLogStopped", "alive after the locked push"])



_CLOSED_RESOLVER = r"""
import socket
import sys
sys.path.insert(0, {repo!r})
from {pkg}.net.tcp import RealWorld
from {pkg}.runtime.futures import spawn, wait_for_all
from {pkg}.server.interfaces import ResolverInterface
from {pkg}.server.proxy import Proxy


def free_addr():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{{port}}"


world = RealWorld(free_addr(), die_on_actor_error=True)
resolver = RealWorld(free_addr(), loop=world.loop)
iface = ResolverInterface(resolver.node.address, "res-1-0")


async def closed(_req):
    raise RuntimeError("conflict set of resolver 'res-1-0' is closed")


resolver.node.register(iface.ep("resolve").token, closed)
world.activate()


class OldProxy:  # what Proxy._send_resolve reads of a proxy with one resolver
    _all_resolvers = [iface]
    _resolver_index = {{}}
    key_resolvers = None
    process = world.node
    last_resolver_versions = 0
    uid = "p0"


async def resolve():
    futs, _meta = Proxy._send_resolve(OldProxy(), 0, 1, [])
    try:
        await wait_for_all(futs)
    except Exception as e:
        return "resolve " + type(e).__name__


print(world.run_until_done(spawn(resolve()), 5.0), flush=True)
world.run(until=world.loop.now() + 0.3)
print("alive after the closed resolver's answer", flush=True)
"""


def test_a_resolve_a_closed_resolver_answers_kills_no_server():
    """A server process (``die_on_actor_error``) that hosts a proxy of a
    generation whose resolvers were destroyed survives their answer to a
    resolve in flight (a closed conflict set's error): the batch reads
    each entrant's error (ROADMAP §C). The JAX package's process dies of
    it, as a port server did when the real-process cluster on the H100
    recovered while it formed."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(pkg):
        out = subprocess.run(
            [sys.executable, "-c", _CLOSED_RESOLVER.format(repo=repo, pkg=pkg)],
            capture_output=True, text=True, timeout=120,
        )
        return out.returncode, out.stdout.splitlines(), out.stderr[-2000:]

    assert run(REFERENCE)[:2] == (44, [])
    port = run(PORT)
    assert port[:2] == (0, ["resolve RemoteError", "alive after the closed resolver's answer"]), port[2]