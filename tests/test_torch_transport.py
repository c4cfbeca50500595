"""The port's transport v2 held to the JAX package's: the cases of
``tests/test_transport.py`` run in both packages with the same outcome and
counters (the two flowlint ones on each package's analyzer); the send and receive buffers move the same bytes; and the bytes a
port world puts on a socket (handshake, gen-6 frames, gen-7 super-frames)
are the JAX package's for the same messages, byte for byte."""

import importlib
import socket
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from bindings_slice import run_model, run_real

REFERENCE = "foundationdb_tpu"
PORT = "foundationdb_tpu_torch"
BOTH = (REFERENCE, PORT)

torch.set_num_threads(1)  # the suite runs in several xdist workers


def package(pkg: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    sim, futures, tcp = mod("net.sim"), mod("runtime.futures"), mod("net.tcp")
    return SimpleNamespace(
        pkg=pkg, wire=mod("net.wire"), RealWorld=tcp.RealWorld, RemoteError=tcp.RemoteError,
        BrokenPromise=sim.BrokenPromise, Endpoint=sim.Endpoint, Sim=sim.Sim,
        TransportTruncated=sim.TransportTruncated, spawn=futures.spawn, settled=futures.settled,
        wait_for_all=futures.wait_for_all, RealLoop=mod("runtime.loop").RealLoop,
        set_loop=mod("runtime.loop").set_loop, Knobs=mod("runtime.knobs").Knobs, errors=mod("errors"),
    )


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def make_world(P, loop, port=None, **knob_overrides):
    return P.RealWorld(f"127.0.0.1:{port or free_port()}", knobs=P.Knobs(**knob_overrides), loop=loop)


def closing(P, loop, *worlds):
    for w in worlds:
        w.close()
    P.set_loop(None)
    loop.close()


# -- wire buffers --------------------------------------------------------------


def send_buffer_burst(P):
    sb = P.wire.SendBuffer(watermark=1 << 12)
    total = 0
    for i in range(1000):
        frame = P.wire.encode_frame(b"m" * 100 + str(i).encode())
        sb.append(frame)
        total += len(frame)
    drained = 0
    while len(sb):
        n = min(137, len(sb))  # worst-case fragmented sends
        drained += n
        sb.consume(n)
    assert drained == total
    assert sb.bytes_moved <= 2 * total, (sb.bytes_moved, total)
    return total, sb.bytes_moved


def test_send_buffer_linear_copying_on_1000_message_burst():
    """O(total) copying under a drained burst, and the port's compaction
    moves exactly the JAX package's bytes."""
    assert send_buffer_burst(package(PORT)) == send_buffer_burst(package(REFERENCE))


def recv_buffer_burst(P):
    rb = P.wire.RecvBuffer(size=4096, watermark=1 << 12)
    payloads = [b"x" * 80 + str(i).encode() for i in range(1000)]
    stream = b"".join(P.wire.encode_frame(p) for p in payloads)
    got, pos = [], 0
    while pos < len(stream):
        chunk = stream[pos : pos + 333]
        pos += len(chunk)
        rb.feed(chunk)
        views, consumed, _n = P.wire.parse_frames(rb)
        got.extend(bytes(v) for v in views)
        del views
        rb.consume(consumed)
    assert got == payloads
    assert rb.bytes_moved <= 2 * len(stream), (rb.bytes_moved, len(stream))
    return stream, rb.bytes_moved


def test_recv_buffer_linear_copying_and_compaction():
    assert recv_buffer_burst(package(PORT)) == recv_buffer_burst(package(REFERENCE))


def test_super_frame_roundtrip_mixed_with_legacy():
    msgs1, msgs2 = [b"alpha", b"b" * 500, b""], [b"gamma"]
    streams = {}
    for pkg in BOTH:
        wire = package(pkg).wire
        stream = (b"".join(wire.encode_super_frame(msgs1)) + wire.encode_frame(b"legacy-single")
                  + b"".join(wire.encode_super_frame(msgs2 * 3)))
        rb = wire.RecvBuffer()
        got = []
        for i in range(len(stream)):  # byte by byte: reassembly never mis-frames
            rb.feed(stream[i : i + 1])
            views, consumed, _n = wire.parse_frames(rb)
            got.extend(bytes(v) for v in views)
            del views
            rb.consume(consumed)
        assert got == msgs1 + [b"legacy-single"] + msgs2 * 3
        streams[pkg] = stream
    assert streams[PORT] == streams[REFERENCE]


def test_super_frame_checksum_and_truncation_rejected():
    import struct
    import zlib

    wire = package(PORT).wire
    frame = b"".join(wire.encode_super_frame([b"one", b"two"]))
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    rb = wire.RecvBuffer()
    rb.feed(bytes(bad))
    with pytest.raises(wire.WireError):
        wire.parse_frames(rb)
    lying = bytearray(frame)  # an entry table whose count lies
    struct.pack_into("<I", lying, 8, 5)
    struct.pack_into("<I", lying, 4, zlib.crc32(frame[12:]))
    rb2 = wire.RecvBuffer()
    rb2.feed(bytes(lying))
    with pytest.raises(wire.WireError):
        wire.parse_frames(rb2)


def test_decode_value_from_memoryview_zero_copy_slices():
    wire = package(PORT).wire
    v = (1, "abc", b"\x00\xff" * 50, [True, None, 3.5], {"k": -7})
    enc = wire.encode_value(v)
    assert wire.decode_value(memoryview(enc)) == v
    with pytest.raises(wire.WireError):
        wire.decode_value(memoryview(enc)[: len(enc) - 3])


# -- the bytes on the socket ---------------------------------------------------


def wire_capture(P, client_port: int, batching: bool) -> bytes:
    """Every byte a world of ``P`` on ``client_port`` writes to a raw peer
    that answers the handshake and never replies: one request, then a
    same-tick burst of 40, then one more."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    peer = f"127.0.0.1:{srv.getsockname()[1]}"
    got = bytearray()
    done = threading.Event()

    def serve():
        conn, _ = srv.accept()
        conn.sendall(P.wire.handshake_bytes(peer))
        conn.settimeout(0.5)
        try:
            while not done.is_set():
                try:
                    data = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                if not data:
                    break
                got.extend(data)
        finally:
            conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    loop = P.RealLoop(seed=41)
    a = make_world(P, loop, port=client_port, TRANSPORT_LOOPBACK=False, TRANSPORT_FRAME_BATCHING=batching)
    ep = P.Endpoint(peer, "echo")

    async def body():
        from importlib import import_module

        delay = import_module(f"{P.pkg}.runtime.futures").delay
        a.node.request(ep, ("first", b"\x00" * 3))
        await delay(0.2)
        for i in range(40):
            a.node.request(ep, (i, "p" * i, {b"k": [i, None]}))
        await delay(0.2)
        a.node.request(ep, "last")
        await delay(0.2)
        return True

    try:
        a.activate()
        assert a.run_until_done(P.spawn(body()), 30.0)
        deadline = time.time() + 5
        while time.time() < deadline and not got.endswith(P.wire.encode_frame(P.wire.encode_value(
                ("req", 42, "echo", "last", P.wire.pack_span_context(None))))):
            time.sleep(0.05)
    finally:
        done.set()
        closing(P, loop, a)
        t.join(10)
        srv.close()
    return bytes(got)


@pytest.mark.parametrize("batching", [True, False], ids=["super_frames", "per_message"])
def test_the_bytes_on_the_socket_are_the_jax_packages(batching):
    port = free_port()
    ref = wire_capture(package(REFERENCE), port, batching)
    got = wire_capture(package(PORT), port, batching)
    assert got == ref
    wire = package(PORT).wire
    hs = wire.handshake_bytes(f"127.0.0.1:{port}")
    assert got.startswith(hs)
    rb = wire.RecvBuffer()
    rb.feed(got[len(hs):])
    views, consumed, n_frames = wire.parse_frames(rb)
    msgs = [wire.decode_value(v) for v in views]
    assert consumed == len(got) - len(hs) and len(msgs) == 42
    assert [m[1] for m in msgs] == list(range(1, 43))  # request ids in order
    assert n_frames == (3 if batching else 42)  # the burst is one super-frame


# -- real sockets: differential and metrics ------------------------------------


def rpc_battery(P, a, b):
    async def echo(x):
        return ("echo", x)

    async def conflicted(_x):
        raise P.errors.NotCommitted("conflict")

    b.node.register("echo", echo)
    b.node.register("conflict", conflicted)

    async def body():
        out = []
        futs = [a.node.request(P.Endpoint(b.node.address, "echo"), (i, "p" * i)) for i in range(40)]
        out.append(await P.wait_for_all(futs))
        try:
            await a.node.request(P.Endpoint(b.node.address, "nope"), None)
            out.append("no-bp")
        except P.BrokenPromise:
            out.append("bp")
        try:
            await a.node.request(P.Endpoint(b.node.address, "conflict"), None)
            out.append("no-nc")
        except P.errors.NotCommitted:
            out.append("nc")
        except P.RemoteError:
            out.append("re")
        return out

    return a.run_until_done(P.spawn(body()), 30.0)


def socket_differential(P):
    results, frames = {}, {}
    for batching in (True, False):
        loop = P.RealLoop(seed=11)
        a = make_world(P, loop, TRANSPORT_FRAME_BATCHING=batching, TRANSPORT_LOOPBACK=False)
        b = make_world(P, loop, TRANSPORT_FRAME_BATCHING=batching, TRANSPORT_LOOPBACK=False)
        try:
            a.activate()
            results[batching] = rpc_battery(P, a, b)
            snap = a.transport_metrics.snapshot()
            frames[batching] = (snap["framesSent"], snap["messagesSent"])
            assert snap["tcpMessages"] > 0 and snap["loopbackMessages"] == 0
        finally:
            closing(P, loop, a, b)
    assert results[True] == results[False]
    (f_on, m_on), (f_off, m_off) = frames[True], frames[False]
    assert m_on == m_off and f_off == m_off and f_on < m_on
    return results[True], m_on


def test_batched_vs_legacy_socket_differential():
    """Gen-7 super-frames vs gen-6 per-message frames over real sockets:
    identical results, fewer frames than messages when batching; the same
    results and message counts as the JAX package's."""
    assert socket_differential(package(PORT)) == socket_differential(package(REFERENCE))


def test_flush_truncation_fault_degrades_per_request_and_reconnects():
    P = package(PORT)
    loop = P.RealLoop(seed=13)
    a = make_world(P, loop, TRANSPORT_LOOPBACK=False)
    b = make_world(P, loop, TRANSPORT_LOOPBACK=False)

    async def echo(x):
        return x

    b.node.register("echo", echo)
    fired = []

    def tear_once(conn):
        if not fired:
            fired.append(conn)
            return True
        return False

    async def body():
        assert await a.node.request(P.Endpoint(b.node.address, "echo"), 0) == 0
        a._flush_fault = tear_once
        futs = [a.node.request(P.Endpoint(b.node.address, "echo"), i) for i in range(10)]
        await P.wait_for_all([P.settled(f) for f in futs])
        outcomes = []
        for f in futs:
            try:
                outcomes.append(("ok", f.get()))
            except P.BrokenPromise:
                outcomes.append(("broken", None))
        assert fired and all(k == "broken" for k, _v in outcomes), outcomes
        a._flush_fault = None
        return await a.node.request(P.Endpoint(b.node.address, "echo"), "again")

    try:
        a.activate()
        assert a.run_until_done(P.spawn(body()), 30.0) == "again"
        assert a.transport_metrics.snapshot()["truncationFaults"] == 1
    finally:
        closing(P, loop, a, b)


# -- loopback ------------------------------------------------------------------


def loopback_battery(P):
    loop = P.RealLoop(seed=17)
    a, b = make_world(P, loop), make_world(P, loop)
    try:
        a.activate()
        out = rpc_battery(P, a, b)
        snap = a.transport_metrics.snapshot()
        assert snap["loopbackMessages"] > 0 and snap["tcpMessages"] == 0
        assert snap["framesSent"] < snap["messagesSent"]
        return out, {k: snap[k] for k in ("messagesSent", "framesSent", "loopbackMessages", "bytesSent")}
    finally:
        closing(P, loop, a, b)


def test_loopback_auto_selected_for_colocated_worlds():
    """Colocated worlds never touch a socket; the port's loopback moves
    the JAX package's messages, frames and bytes."""
    port, ref = loopback_battery(package(PORT)), loopback_battery(package(REFERENCE))
    assert port == ref
    assert port[0][1:] == ["bp", "nc"]


def test_loopback_codec_parity_no_aliasing_and_unserializable_errors():
    P = package(PORT)
    loop = P.RealLoop(seed=19)
    a, b = make_world(P, loop), make_world(P, loop)
    seen = []

    async def keep(x):
        seen.append(x)
        return len(seen)

    b.node.register("keep", keep)

    async def body():
        payload = {"k": [1, 2, 3]}
        f = a.node.request(P.Endpoint(b.node.address, "keep"), payload)
        payload["k"].append(99)  # mutate after send, before delivery
        await f
        assert seen[0] == {"k": [1, 2, 3]}, seen
        try:
            await a.node.request(P.Endpoint(b.node.address, "keep"), object())
            return "accepted-unserializable"
        except P.wire.WireError:
            return "rejected"

    try:
        a.activate()
        assert a.run_until_done(P.spawn(body()), 30.0) == "rejected"
    finally:
        closing(P, loop, a, b)


def test_loopback_close_semantics_match_dead_peer():
    P = package(PORT)
    loop = P.RealLoop(seed=23)
    a = make_world(P, loop)

    async def body():
        b = make_world(P, loop)

        async def pong(_x):
            return "pong"

        b.node.register("ping", pong)
        assert (await a.node.request(P.Endpoint(b.node.address, "ping"), None)) == "pong"
        assert a.transport_metrics.snapshot()["loopbackMessages"] > 0
        addr = b.node.address
        b.close()
        try:
            await a.node.request(P.Endpoint(addr, "ping"), None)
            return "no-break"
        except P.BrokenPromise:
            return "broke"

    try:
        a.activate()
        assert a.run_until_done(P.spawn(body()), 30.0) == "broke"
    finally:
        closing(P, loop, a)


def test_tls_worlds_never_loop_back(tmp_path):
    """Colocated TLS worlds talk TLS over sockets, super-framed."""
    from test_tls import gen_ca_and_cert

    P = package(PORT)
    crt, key, ca = gen_ca_and_cert(str(tmp_path))
    tls = dict(certfile=crt, keyfile=key, cafile=ca)
    loop = P.RealLoop(seed=29)
    a = P.RealWorld(f"127.0.0.1:{free_port()}", knobs=P.Knobs(), loop=loop, tls=tls)
    b = P.RealWorld(f"127.0.0.1:{free_port()}", knobs=P.Knobs(), loop=loop, tls=tls)

    async def echo(x):
        return x

    b.node.register("echo", echo)

    async def body():
        return await P.wait_for_all([a.node.request(P.Endpoint(b.node.address, "echo"), i) for i in range(20)])

    try:
        a.activate()
        assert a.run_until_done(P.spawn(body()), 60.0) == list(range(20))
        snap = a.transport_metrics.snapshot()
        assert snap["loopbackMessages"] == 0 and snap["tcpMessages"] > 0
        assert snap["framesSent"] < snap["messagesSent"]
    finally:
        closing(P, loop, a, b)


# -- sim parity: the transport-truncate chaos site -----------------------------


def sim_transport_fault(P):
    sim = P.Sim(seed=31)
    sim.activate()
    p = sim.new_process("1.1.1.1:1")
    q = sim.new_process("2.2.2.2:2")

    async def echo(x):
        return x

    q.register("echo", echo)

    class _AlwaysOnce:
        def __init__(self):
            self.rolls = 0

        def coinflip(self, _p):
            self.rolls += 1
            return self.rolls == 1

    sim.arm_transport_faults(_AlwaysOnce(), p=1.0)

    async def body():
        try:
            await p.request(P.Endpoint(q.address, "echo"), "first")
            return "no-fault"
        except P.TransportTruncated as e:
            assert isinstance(e, P.BrokenPromise)
        return await p.request(P.Endpoint(q.address, "echo"), "second")

    try:
        return sim.run_until_done(P.spawn(body()), 60.0), sim.transport_metrics.snapshot()
    finally:
        P.set_loop(None)


def test_sim_transport_fault_fails_only_faulted_request_typed():
    port, ref = sim_transport_fault(package(PORT)), sim_transport_fault(package(REFERENCE))
    assert port[0] == "second" and port[1]["truncationFaults"] == 1
    assert port == ref


def truncation_burst(P):
    cluster_mod = importlib.import_module(f"{P.pkg}.server.cluster")
    Database = importlib.import_module(f"{P.pkg}.client.database").Database
    sim = P.Sim(seed=53)
    sim.activate()
    kw = {"device": "cpu"} if P.pkg == PORT else {}
    cluster = cluster_mod.DynamicCluster(
        sim, cluster_mod.ClusterConfig(n_proxies=1, n_resolvers=2, n_tlogs=2, n_storage=2),
        n_coordinators=1, **kw)
    db = Database.from_coordinators(sim, cluster.coordinators)

    class _Rng:
        def __init__(self, seed):
            import random

            self._r = random.Random(seed)

        def coinflip(self, p):
            return self._r.random() < p

    async def go():
        async def w(tr, i):
            tr.set(b"tw%03d" % i, b"v%d" % i)

        await db.run(lambda tr: w(tr, 999))
        t0 = sim.loop.now()
        sim.arm_transport_faults(_Rng(1), p=0.08, windows=[(t0, t0 + 3.0)])
        for i in range(40):
            await db.run(lambda tr, i=i: w(tr, i))

        async def check(tr):
            return len(await tr.get_range(b"tw", b"tx"))

        return await db.run(check)

    try:
        return sim.run_until_done(P.spawn(go()), 600.0), sim.transport_metrics.snapshot()["truncationFaults"]
    finally:
        P.set_loop(None)


def test_commit_pipeline_survives_truncation_burst():
    """A fault burst over live commits costs retries, never the epoch: the
    port's cluster (resolvers on ``torch``, on the CPU) commits all 41, and
    its faults fall where the JAX package's do."""
    port = truncation_burst(package(PORT))
    assert port[0] == 41 and port[1] > 0
    assert port == truncation_burst(package(REFERENCE))


@pytest.mark.parametrize("batching", [True, False])
def test_bindingtester_oracle_with_transport_knob(batching):
    """The transport knob reshapes framing, never results: the port's run
    equals its model and the JAX package's run."""
    knobs = dict(TRANSPORT_FRAME_BATCHING=batching)
    port = run_real(PORT, 47, 300, knob_overrides=knobs)
    assert (port[1], port[2]) == run_model(PORT, port[0])
    assert port == run_real(REFERENCE, 47, 300, knob_overrides=knobs)


# -- flowlint: the worker must register transport.metrics ----------------------


def _lint_worker(tmp_path, pkg, worker_src):
    lint = importlib.import_module(f"{pkg}.tools.flowlint").lint
    d = tmp_path / pkg / "server"
    d.mkdir(parents=True)
    (d / "worker.py").write_text(worker_src)
    config = {
        "include": [pkg],
        "exclude": [],
        "sim_scope": [],
        "host_only": {},
        "baseline": "baseline.json",
        "worker_module": f"{pkg}/server/worker.py",
        "role_exempt": [],
        "span_roles": [],
        "transport_metrics_endpoint": "transport.metrics",
    }
    res = lint(root=tmp_path, config=config)
    return [(f.rule, f.detail, f.line, f.message) for f in res.failing]


@pytest.mark.parametrize("pkg", BOTH)
def test_flowlint_worker_without_transport_metrics_flagged(tmp_path, pkg):
    failing = _lint_worker(
        tmp_path, pkg,
        "class Worker:\n"
        "    def start(self, process):\n"
        '        process.register("worker.metrics", self._rm)\n',
    )
    assert any(r == "reg-role-metrics" and d == "worker-transport-metrics" for r, d, _l, _m in failing)


@pytest.mark.parametrize("pkg", BOTH)
def test_flowlint_worker_with_transport_metrics_clean(tmp_path, pkg):
    assert not _lint_worker(
        tmp_path, pkg,
        "class Worker:\n"
        "    def start(self, process):\n"
        '        process.register("transport.metrics", self._tm)\n',
    )
