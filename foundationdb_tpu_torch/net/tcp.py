"""Real TCP transport: the non-simulated network personality.

The analog of fdbrpc/FlowTransport.actor.cpp: token-addressed endpoints,
length+CRC framed messages (net/wire.py), a protocol-version handshake on
connect, automatic reconnection, and BrokenPromise semantics for requests
to dead peers — behind the exact ``request()``/``register()`` surface of
the simulator (net/sim.py), so every role runs unmodified as a real OS
process.

Transport v2: the wire path is frame-batched and zero-copy —
preallocated receive buffers filled by ``recv_into`` and parsed as
``memoryview`` slices (wire.RecvBuffer), send queues with consumed-offset
compaction instead of per-send ``del buf[:n]`` (wire.SendBuffer), and ONE
gen-7 super-frame per connection per loop tick carrying every message
coalesced in that tick, flushed with a vectored ``sendmsg`` when the
socket allows. Inbound super-frames batch-dispatch: one loop step drains
every request in the frame (futures.start_batch) instead of scheduling a
wakeup per request. Colocated worlds in the same OS process short-circuit
onto the in-process loopback transport (net/loopback.py) automatically.
The ``TRANSPORT_*`` knobs keep the gen-6-shaped path (per-message frames,
sockets everywhere) available for A/B.

Topology objects:

- ``RealWorld`` — one OS process's view of the cluster. Mirrors ``Sim``'s
  surface (``knobs``, ``loop``, ``disk()``, ``processes``/``new_process``)
  so code written against the simulator runs over TCP untouched.
- ``RealNode`` — the local process (mirrors ``SimProcess``): registers
  endpoint handlers, originates requests. One listener per process;
  request/reply frames multiplex over one connection per peer.

Failure semantics match the sim: a request to an unreachable/reset peer
errors with BrokenPromise (flow's broken_promise); callers retry through
their existing failover paths. Errors raised by remote handlers propagate
with their FdbError code; everything else surfaces as RemoteError.

The port's copy of ``foundationdb_tpu/net/tcp.py``: the same frames,
handshake, batching and error mapping (the named errors are the port's own
``TLogStopped`` and ``MoveKeysError``), on the port's ``RealLoop``, whose
self-pipe wakes the loop when a resolver's device thread finishes. A port
process and a JAX-package process speak the same bytes. One difference: a
hedged request's entrant that ends with an error its race has read kills no
server process here (``RealNode._on_actor_error``); the reference's dies
of it.
"""

from __future__ import annotations

import socket
from typing import Any, Callable, Optional

from ..errors import FdbError
from ..runtime.futures import (
    ActorCollection,
    Cancelled,
    Future,
    Task,
    settle_batch,
    spawn,
    start_batch,
)
from ..runtime.knobs import Knobs
from ..runtime.loop import RealLoop, TaskPriority, set_loop
from ..runtime.trace import SevError, SevInfo, SevWarn, trace
from . import loopback, wire
from .metrics import TransportMetrics
from .sim import BrokenPromise, Endpoint


class RemoteError(Exception):
    """A remote handler raised an exception outside the named registry."""


def _named_errors() -> dict:
    """Framework exception classes reconstructed BY NAME across the wire —
    server code catches these by type (e.g. the proxy's TLogStopped
    handling marks the epoch dead), so flattening them to RemoteError in
    the real-TCP personality would silently disable those paths (a
    TLogStopped that stays RemoteError left a fenced proxy serving
    forever — found by the TCP kill/restart soak)."""
    from ..server.tlog import TLogStopped
    from ..server.movekeys import MoveKeysError

    return {
        "TLogStopped": TLogStopped,
        "MoveKeysError": MoveKeysError,
    }


class _Conn:
    """One TCP connection (either direction) with framing + dispatch.

    With a TLS-enabled world the socket is an SSLSocket whose handshake is
    driven HERE, non-blocking (the reference's TLSConnection wraps its
    streams the same way, fdbrpc/TLSConnection.actor.cpp): until the
    handshake completes, reads/writes feed the handshake; the wire
    preamble and frames flow only after it."""

    def __init__(
        self,
        world: "RealWorld",
        sock: socket.socket,
        peer: Optional[str],
        preamble: bytes = b"",
    ):
        self.world = world
        self.sock = sock
        self.peer = peer  # peer's listen address (None until handshake)
        knobs = world.knobs
        self.metrics = world.transport_metrics
        self._rb = wire.RecvBuffer(
            knobs.TRANSPORT_RECV_BYTES, knobs.TRANSPORT_COMPACT_WATERMARK
        )
        # the wire preamble MUST be queued before the TLS drive below: a
        # handshake that completes synchronously flushes the send queue,
        # and bytes appended afterwards would strand with no writer
        self._out = wire.SendBuffer(knobs.TRANSPORT_COMPACT_WATERMARK)
        if preamble:
            self._out.append(preamble)
        self.metrics.track_buffer(self._rb)
        self.metrics.track_buffer(self._out)
        self.metrics.connections.add(1)
        # gen-7 frame batching: encoded messages collect here per tick and
        # flush as ONE super-frame (knob off = per-message gen-6 framing)
        self._batching = bool(knobs.TRANSPORT_FRAME_BATCHING)
        self._batch_cap = max(int(knobs.TRANSPORT_MAX_BATCH_MESSAGES), 1)
        self._pending_msgs: list[bytes] = []
        self.closed = False
        self.handshaken = peer is not None and False  # always expect preamble
        self._flush_scheduled = False
        import ssl as _ssl

        self._tls_handshaking = isinstance(sock, _ssl.SSLSocket)
        self._tls_write_wants_read = False
        # vectored flush only on plain sockets (SSLSocket *exposes*
        # sendmsg but raises NotImplementedError at call time)
        self._sendmsg = (
            None
            if isinstance(sock, _ssl.SSLSocket)
            else getattr(sock, "sendmsg", None)
        )
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        world.loop.add_reader(sock, self._on_readable)
        if self._tls_handshaking:
            self._drive_tls()

    def _drive_tls(self) -> None:
        import ssl as _ssl

        try:
            self.sock.do_handshake()
        except _ssl.SSLWantReadError:
            return  # reader is always registered
        except _ssl.SSLWantWriteError:
            self.world.loop.add_writer(self.sock, self._on_writable)
            return
        except (_ssl.SSLError, OSError) as e:
            trace(
                SevWarn,
                "TLSHandshakeFailed",
                self.world.node.address,
                Err=str(e)[:200],
            )
            self.close()
            return
        self._tls_handshaking = False
        if len(self._out):
            self._on_writable()
            if len(self._out) and not self.closed:
                self.world.loop.add_writer(self.sock, self._on_writable)
        # application bytes may have arrived WITH the handshake's last
        # flight and now sit decrypted inside the SSL object — the fd
        # will never signal readable for them again
        pending = getattr(self.sock, "pending", None)
        if not self.closed and pending is not None and pending():
            self._on_readable()

    def send(self, msg: Any) -> None:
        if self.closed:
            return
        payload = wire.encode_value(msg)
        m = self.metrics
        m.messages_sent.add(1)
        m.tcp_messages.add(1)
        if self._batching:
            self._pending_msgs.append(payload)
            if len(self._pending_msgs) >= self._batch_cap:
                self._emit()  # early flush; ordering preserved within the tick
        else:
            frame = wire.encode_frame(payload)
            self._out.append(frame)
            m.frames_sent.add(1)
            m.bytes_sent.add(len(frame))
        # coalesced flush: every message queued during THIS loop tick goes
        # out in one super-frame / one send() syscall (the flush runs at
        # ZERO priority after all same-time work — profiling the real
        # cluster put per-message syscalls at ~25% of client CPU). No
        # select() wait intervenes, so latency is unchanged.
        if not self._flush_scheduled and not self._tls_handshaking:
            self._flush_scheduled = True
            self.world.loop.call_soon(self._flush_tick, TaskPriority.ZERO)

    def _emit(self) -> None:
        """Package this tick's coalesced messages into one wire frame."""
        msgs = self._pending_msgs
        if not msgs:
            return
        self._pending_msgs = []
        m = self.metrics
        m.frames_sent.add(1)
        m.messages_per_flush.add(float(len(msgs)))
        if len(msgs) == 1:
            # a lone message rides the (smaller) gen-6 frame — both decode
            # paths stay exercised on every connection
            frame = wire.encode_frame(msgs[0])
            m.bytes_sent.add(len(frame))
            self._out.append(frame)
            return
        iov = wire.encode_super_frame(msgs)
        nbytes = sum(len(b) for b in iov)
        m.bytes_sent.add(nbytes)
        fault = self.world._flush_fault
        if fault is not None and fault(self):
            # injected partial flush (the sim's transport-truncate analog
            # for real sockets): half the super-frame hits the wire, then
            # the connection dies — the peer must discard the torn frame
            # and every in-flight request must fail typed, not hang
            m.truncation_faults.add(1)
            joined = b"".join(iov)
            try:
                self.sock.send(joined[: len(joined) // 2])
            except OSError:
                pass
            self.close()
            return
        if (
            not len(self._out)
            and self._sendmsg is not None
            and not self._tls_handshaking
            and len(iov) <= 1000  # IOV_MAX headroom
        ):
            # vectored fast path: the whole super-frame leaves in one
            # sendmsg with zero concatenation; a partial send spills the
            # tail into the send queue and the writer picks it up
            try:
                sent = self._sendmsg(iov)
            except (BlockingIOError, InterruptedError):
                sent = 0
            except OSError:
                self.close()
                return
            if sent >= nbytes:
                return
            for buf in iov:
                if sent >= len(buf):
                    sent -= len(buf)
                    continue
                self._out.append(buf[sent:] if sent else buf)
                sent = 0
            return
        for buf in iov:
            self._out.append(buf)

    def _flush_tick(self) -> None:
        self._flush_scheduled = False
        if self.closed or self._tls_handshaking:
            return
        self._emit()
        # always attempt the flush and (re)arm the writer on leftover:
        # assuming "non-empty send queue implies a registered writer" once
        # stranded a preamble queued right after a synchronously-
        # completing TLS handshake
        if len(self._out):
            self._on_writable()
            if len(self._out) and not self.closed:
                self.world.loop.add_writer(self.sock, self._on_writable)

    def _on_writable(self) -> None:
        if self._tls_handshaking:
            self.world.loop.remove_writer(self.sock)
            self._drive_tls()
            return
        import ssl as _ssl

        try:
            while len(self._out):
                n = self.sock.send(self._out.peek())
                if n <= 0:
                    break
                self._out.consume(n)
        except _ssl.SSLWantReadError:
            # the SSL layer must READ (a post-handshake record) before
            # this write can proceed; keeping the writer armed would
            # busy-spin on an always-writable fd — retry from the read
            # path instead
            self._tls_write_wants_read = True
            self.world.loop.remove_writer(self.sock)
            return
        except (BlockingIOError, InterruptedError, _ssl.SSLWantWriteError):
            pass
        except OSError:
            self.close()
            return
        if not len(self._out):
            self.world.loop.remove_writer(self.sock)

    def _on_readable(self) -> None:
        if self._tls_handshaking:
            self._drive_tls()
            if self._tls_handshaking or self.closed:
                return
        if self._tls_write_wants_read and not self.closed:
            # a stalled write was waiting on inbound TLS records
            self._tls_write_wants_read = False
            self._on_writable()
            if len(self._out) and not self.closed and not self._tls_write_wants_read:
                self.world.loop.add_writer(self.sock, self._on_writable)
            if self.closed:
                return
        import ssl as _ssl

        rb = self._rb
        try:
            n = self.sock.recv_into(rb.writable(1 << 16))
        except (BlockingIOError, InterruptedError, _ssl.SSLWantReadError):
            return
        except (_ssl.SSLWantWriteError,):
            self.world.loop.add_writer(self.sock, self._on_writable)
            return
        except OSError:
            self.close()
            return
        if not n:
            self.close()
            return
        rb.commit(n)
        self.metrics.bytes_received.add(n)
        # drain TLS-internal plaintext: decrypted bytes can sit in the SSL
        # buffer with no fd readiness to re-trigger select
        pending = getattr(self.sock, "pending", None)
        while pending is not None and pending():
            try:
                more = self.sock.recv_into(rb.writable(1 << 16))
            except (_ssl.SSLWantReadError, BlockingIOError):
                break
            if not more:
                break
            rb.commit(more)
            self.metrics.bytes_received.add(more)
        try:
            if not self.handshaken:
                hs = wire.parse_handshake(rb.view())
                if hs is None:
                    return
                addr, consumed = hs
                rb.consume(consumed)
                self.handshaken = True
                if self.peer is None:
                    self.peer = addr
                self.world._conn_ready(self)
            views, consumed, n_frames = wire.parse_frames(rb)
            # decode BEFORE consuming: the views alias buffer storage that
            # consumption may compact
            msgs = [wire.decode_value(v) for v in views]
            del views
            rb.consume(consumed)
            if msgs:
                m = self.metrics
                m.frames_received.add(n_frames)
                m.messages_received.add(len(msgs))
                m.tcp_messages.add(len(msgs))
                self.world._on_batch(self, msgs)
        except wire.WireError as e:
            trace(SevWarn, "WireError", self.world.node.address, Err=str(e))
            self.close()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._pending_msgs.clear()
        self.metrics.untrack_buffer(self._rb)
        self.metrics.untrack_buffer(self._out)
        self.metrics.connections_closed.add(1)
        self.world.loop.remove_reader(self.sock)
        self.world.loop.remove_writer(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass
        self.world._conn_closed(self)


class RealNode:
    """The local process — SimProcess-compatible surface."""

    def __init__(self, world: "RealWorld", address: str):
        from ..runtime.locality import Locality

        self.world = world
        self.sim = world  # roles access knobs/disk/loop through .sim
        self.address = address
        self.machine = address
        self.locality = Locality.of(address, zone=world.zone, dc=world.dc)
        self.endpoints: dict[str, Callable] = {}
        self.actors = ActorCollection(on_error=self._on_actor_error)
        self.alive = True
        # a real OS process always boots with a fresh memory image, so its
        # in-memory reboot counter is 0; role code may read it either way
        # (SimProcess counts sim reboots for change-id salting)
        self.reboots = 0

    def _on_actor_error(self, err: BaseException, observed: bool = False) -> None:
        """Unhandled actor death: SevError + traceback, and — when this
        process is a server (fdbserver sets die_on_actor_error) — process
        exit, so supervision/tests see the crash instead of a silent hang
        (the reference's criticalError path, flow/Error.cpp). An actor whose
        spawner reads its error (``observed``: a hedged request's entrant)
        is traced the same way but kills no process."""
        import sys
        import traceback as _tb

        tb = "".join(_tb.format_exception(type(err), err, err.__traceback__))
        # BrokenPromise (requests racing deaths) and propagated Cancelled
        # (awaiting a sibling being torn down) are routine — warn, no death
        benign = isinstance(err, (BrokenPromise, Cancelled))
        trace(
            SevWarn if benign else SevError,
            "UnhandledActorError",
            self.address,
            Err=repr(err),
            Backtrace=tb[-2000:],
        )
        if self.world.die_on_actor_error and not benign and not observed:
            print(
                f"fatal: unhandled actor error on {self.address}:\n{tb}",
                file=sys.stderr,
                flush=True,
            )
            import os

            os._exit(44)

    def register(self, token: str, handler: Callable) -> Endpoint:
        self.endpoints[token] = handler
        return Endpoint(self.address, token)

    def spawn(
        self, coro, priority: int = TaskPriority.DEFAULT, name: str = None
    ) -> Future:
        fut = spawn(coro, priority, name)
        self.actors.add(fut)
        return fut

    def request(self, ep: Endpoint, payload: Any) -> Future:
        return self.world.request(ep, payload)


class RealWorld:
    """One OS process's cluster world over TCP (Sim-compatible surface)."""

    def __init__(
        self,
        listen_addr: str,
        knobs: Optional[Knobs] = None,
        data_dir: Optional[str] = None,
        loop: Optional[RealLoop] = None,
        seed: Optional[int] = None,
        zone: Optional[str] = None,
        dc: str = "dc0",
        die_on_actor_error: bool = False,
        tls: Optional[dict] = None,  # {certfile, keyfile, cafile}
    ):
        self.loop = loop or RealLoop(seed)
        self.knobs = knobs or Knobs()
        self.die_on_actor_error = die_on_actor_error
        # mutual TLS (the reference's TLS plugin, fdbrpc/TLSConnection):
        # every connection in either direction presents the cluster cert
        # and verifies the peer against the cluster CA — plaintext peers
        # cannot join or talk to a TLS cluster
        self._tls_server_ctx = self._tls_client_ctx = None
        if tls:
            import ssl as _ssl

            sctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
            sctx.load_cert_chain(tls["certfile"], tls["keyfile"])
            sctx.load_verify_locations(tls["cafile"])
            sctx.verify_mode = _ssl.CERT_REQUIRED
            cctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_CLIENT)
            cctx.load_cert_chain(tls["certfile"], tls["keyfile"])
            cctx.load_verify_locations(tls["cafile"])
            cctx.check_hostname = False  # peers are addressed by ip:port
            cctx.verify_mode = _ssl.CERT_REQUIRED
            self._tls_server_ctx, self._tls_client_ctx = sctx, cctx
        self.data_dir = data_dir
        self.zone = zone
        self.dc = dc
        self.node = RealNode(self, listen_addr)
        # Sim-surface compatibility (Database, roles):
        self.processes = {listen_addr: self.node}
        self._disks: dict[str, Any] = {}
        self._conns: dict[str, Any] = {}  # peer listen addr → live conn
        self._connecting: dict[str, Future] = {}
        self._anon: list[_Conn] = []  # accepted, pre-handshake
        self._pending: dict[int, tuple[Future, str]] = {}  # id → (fut, peer)
        self._inflight: dict[str, int] = {}  # peer → requests in flight
        self._disconnect_watchers: list[Callable[[str], None]] = []
        self._next_id = 1
        self._listener: Optional[socket.socket] = None
        # transport counters (net/metrics.py): one collection per world,
        # fed by every connection and the loopback path; the worker's
        # transport.metrics endpoint and status `transport` section pull it
        self.transport_metrics = TransportMetrics(listen_addr)
        # test/chaos hook: callable(conn) -> bool deciding whether THIS
        # flush is torn mid-super-frame (partial flush + connection death)
        self._flush_fault: Optional[Callable[[_Conn], bool]] = None
        # in-process loopback (net/loopback.py): colocated worlds on the
        # same loop bypass sockets entirely. TLS worlds never loop back —
        # their peer-authentication story must not be silently bypassed.
        self._loopback_ok = bool(self.knobs.TRANSPORT_LOOPBACK) and tls is None
        # commit-path codec/settle modes. Both are process-wide
        # (the codec registry and the settle slab are module state), so
        # colocated worlds in one process follow the last world's knobs —
        # A/B runs configure every world identically.
        wire.set_compiled_codec(bool(getattr(self.knobs, "WIRE_COMPILED_CODEC", True)))
        from ..runtime import futures as _futures

        _futures.set_slab_settle(bool(getattr(self.knobs, "FUTURE_SLAB_SETTLE", True)))
        self._listen()
        self.transport_metrics.stats.id = self.node.address
        loopback.register(self)
        # run-loop profiler, REAL personality: wall busy/starvation + the
        # SlowTask trace events. Installed after _listen so the ident is
        # the node's final address (ephemeral ports are adopted there);
        # several worlds may share one loop — the first install wins
        from ..runtime import profiler as _profiler

        _profiler.install(
            self.loop, knobs=self.knobs, wall=True, ident=self.node.address
        )

    # -- Sim-compatible world surface -----------------------------------------

    def new_process(self, address: str, machine: str = None, boot=None) -> RealNode:
        """A real OS process hosts exactly one node; Database asks for a
        'client' process and gets the local one."""
        return self.node

    def disk(self, machine: str):
        from .files import RealDisk

        d = self._disks.get(machine)
        if d is None:
            import os

            root = self.data_dir or "fdbtpu-data"
            d = self._disks[machine] = RealDisk(os.path.join(root, machine))
        return d

    def activate(self) -> None:
        set_loop(self.loop)

    def run(self, until: float = float("inf"), stop_when=None) -> float:
        self.activate()
        return self.loop.run(until, stop_when)

    def run_until_done(self, fut: Future, limit: float = 1e9) -> Any:
        self.activate()
        t0 = self.loop.now()
        self.loop.run(until=t0 + limit, stop_when=fut.is_ready)
        if not fut.is_ready():
            raise TimeoutError(f"did not finish within {limit}s")
        return fut.get()

    def close(self) -> None:
        loopback.unregister(self)
        if self._listener is not None:
            self.loop.remove_reader(self._listener)
            self._listener.close()
            self._listener = None
        for c in list(self._conns.values()) + list(self._anon):
            c.close()

    # -- listening -------------------------------------------------------------

    def _listen(self) -> None:
        host, port = self.node.address.rsplit(":", 1)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, int(port)))
        if int(port) == 0:
            # ephemeral port (clients like fdbcli): adopt the real one as
            # this node's identity before anything handshakes with it
            real = s.getsockname()[1]
            addr = f"{host}:{real}"
            self.processes[addr] = self.processes.pop(self.node.address)
            self.node.address = addr
            self.node.machine = addr
        s.listen(128)
        s.setblocking(False)
        self._listener = s
        self.loop.add_reader(s, self._on_accept)
        trace(SevInfo, "TransportListening", self.node.address)

    def _on_accept(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if self._tls_server_ctx is not None:
                try:
                    sock.setblocking(False)
                    sock = self._tls_server_ctx.wrap_socket(
                        sock, server_side=True, do_handshake_on_connect=False
                    )
                except Exception as e:
                    trace(
                        SevWarn,
                        "TLSAcceptFailed",
                        self.node.address,
                        Err=str(e)[:200],
                    )
                    sock.close()
                    continue
            conn = _Conn(
                self, sock, None, preamble=wire.handshake_bytes(self.node.address)
            )
            if not conn._tls_handshaking and not conn.closed:
                conn._on_writable()
                if len(conn._out) and not conn.closed:
                    self.loop.add_writer(sock, conn._on_writable)
            if not conn.closed:
                self._anon.append(conn)

    # -- connections -----------------------------------------------------------

    def _conn_ready(self, conn: _Conn) -> None:
        if conn in self._anon:
            self._anon.remove(conn)
        # simultaneous connect: the newest handshaken connection wins the
        # routing slot; a displaced one still drains its in-flight replies
        # until either side closes it
        self._conns[conn.peer] = conn
        waiter = self._connecting.pop(conn.peer, None)
        if waiter is not None and not waiter.is_ready():
            waiter._set(None)

    def _conn_closed(self, conn) -> None:
        if conn in self._anon:
            self._anon.remove(conn)
        if conn.peer is not None and self._conns.get(conn.peer) is conn:
            del self._conns[conn.peer]
        # fail requests that were in flight on this connection
        dead = [
            rid
            for rid, (_fut, peer) in self._pending.items()
            if peer == conn.peer
        ]
        for rid in dead:
            ent = self._pending_pop(rid)
            if ent is not None and not ent[0].is_ready():
                ent[0]._set_error(BrokenPromise(f"connection to {conn.peer} lost"))
        waiter = self._connecting.pop(conn.peer, None) if conn.peer else None
        if waiter is not None and not waiter.is_ready():
            waiter._set_error(BrokenPromise(f"connect to {conn.peer} failed"))
        # failure-monitor hook (the reference wires connection failure into
        # SimpleFailureMonitor, FlowTransport.actor.cpp): subscribers learn
        # about a dead peer immediately instead of waiting out heartbeats
        if conn.peer is not None:
            for cb in list(self._disconnect_watchers):
                try:
                    cb(conn.peer)
                except Exception:
                    pass

    def on_peer_disconnect(self, cb: Callable[[str], None]) -> None:
        """Register a connection-failure callback (peer listen address)."""
        self._disconnect_watchers.append(cb)

    def _connect(self, peer: str) -> Future:
        """Future resolving when a connection to ``peer`` is live."""
        if peer in self._conns:
            f = Future()
            f._set(None)
            return f
        waiter = self._connecting.get(peer)
        if waiter is not None:
            return waiter
        waiter = self._connecting[peer] = Future()
        host, port = peer.rsplit(":", 1)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            sock.connect((host, int(port)))
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as e:
            sock.close()
            self._connecting.pop(peer, None)
            waiter._set_error(BrokenPromise(f"connect {peer}: {e}"))
            return waiter

        if self._tls_client_ctx is not None:
            # TLS: the _Conn (and its SSL wrap) exists only once the TCP
            # connect completes; until then failures resolve the waiter
            # directly
            def on_tcp_connected():
                self.loop.remove_writer(sock)
                err = sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
                if err:
                    sock.close()
                    self._connecting.pop(peer, None)
                    if not waiter.is_ready():
                        waiter._set_error(
                            BrokenPromise(f"connect to {peer} failed")
                        )
                    return
                try:
                    wrapped = self._tls_client_ctx.wrap_socket(
                        sock, do_handshake_on_connect=False
                    )
                except Exception as e:
                    sock.close()
                    self._connecting.pop(peer, None)
                    if not waiter.is_ready():
                        waiter._set_error(BrokenPromise(f"tls {peer}: {e}"))
                    return
                _Conn(
                    self,
                    wrapped,
                    peer,
                    preamble=wire.handshake_bytes(self.node.address),
                )

            self.loop.add_writer(sock, on_tcp_connected)
            return waiter

        # queue our preamble NOW: on localhost the peer's preamble can
        # arrive (and resolve the connect waiter) before the writability
        # callback below ever runs — a request sent at that moment must
        # find the handshake already ahead of it in the buffer, or the
        # first frame beats the preamble onto the wire
        conn = _Conn(
            self, sock, peer, preamble=wire.handshake_bytes(self.node.address)
        )

        def on_connected():
            if conn.closed:
                return  # read side already saw the failure in this batch
            self.loop.remove_writer(sock)
            err = sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                conn.close()
                return
            try:
                conn._on_writable()
                if len(conn._out):
                    self.loop.add_writer(sock, conn._on_writable)
            except OSError:
                conn.close()

        self.loop.add_writer(sock, on_connected)
        return waiter

    # -- RPC -------------------------------------------------------------------

    def _pending_add(self, rid: int, fut: Future, peer: str) -> None:
        self._pending[rid] = (fut, peer)
        self._inflight[peer] = self._inflight.get(peer, 0) + 1

    def _pending_pop(self, rid: int):
        ent = self._pending.pop(rid, None)
        if ent is not None:
            peer = ent[1]
            left = self._inflight.get(peer, 0) - 1
            if left > 0:
                self._inflight[peer] = left
            else:
                self._inflight.pop(peer, None)
        return ent

    def request(self, ep: Endpoint, payload: Any) -> Future:
        from ..runtime import trace as _trace

        reply: Future = Future()
        if ep.address == self.node.address:
            self._dispatch_local(ep.token, payload, reply)
            return reply
        rid = self._next_id
        self._next_id += 1
        # the caller's span context rides the request tuple (the analog of
        # FlowTransport's SpanContextMessage): the remote handler runs as a
        # child of the caller's span without the payload knowing
        msg = ("req", rid, ep.token, payload, wire.pack_span_context(_trace.active_span()))
        conn = self._conns.get(ep.address)
        if conn is None and self._loopback_ok:
            target = loopback.lookup(ep.address)
            if (
                target is not None
                and target is not self
                and getattr(target, "_loopback_ok", False)
                and target.loop is self.loop
                and target._listener is not None
            ):
                conn = loopback.connect(self, target)
        if conn is not None:
            # connection-level pipelining: requests never wait for replies;
            # the depth sample is the in-flight count this one joined
            self.transport_metrics.pipelined_depth.add(
                float(self._inflight.get(ep.address, 0))
            )
            self._pending_add(rid, reply, ep.address)
            conn.send(msg)
            return reply

        waiter = self._connect(ep.address)

        def on_conn():
            if waiter.is_error():
                if not reply.is_ready():
                    reply._set_error(waiter._error)
                return
            c = self._conns.get(ep.address)
            if c is None:
                if not reply.is_ready():
                    reply._set_error(BrokenPromise(f"no route to {ep.address}"))
                return
            self._pending_add(rid, reply, ep.address)
            c.send(msg)

        waiter.add_callback(lambda _f: on_conn())
        return reply

    def _dispatch_local(self, token: str, payload, reply: Future) -> None:
        handler = self.node.endpoints.get(token)
        if handler is None:
            reply._set_error(BrokenPromise(f"{self.node.address}:{token}"))
            return

        async def run_and_reply():
            try:
                result = await handler(payload)
            except Cancelled:
                if not reply.is_ready():
                    reply._set_error(BrokenPromise(token))
                return
            except BaseException as e:
                if not reply.is_ready():
                    reply._set_error(e)
                return
            if not reply.is_ready():
                reply._set(result)

        # profiler attribution names the handler, not the dispatch shim
        self.node.spawn(
            run_and_reply(), name=getattr(handler, "__qualname__", None)
        )

    async def _run_and_reply(self, conn, rid: int, token: str, handler, payload):
        try:
            result = await handler(payload)
        except Cancelled:
            conn.send(("err", rid, "broken_promise", token))
            return
        except FdbError as e:
            conn.send(("err", rid, "fdb", type(e).__name__))
            return
        except BrokenPromise as e:
            conn.send(("err", rid, "broken_promise", str(e)))
            return
        except BaseException as e:
            if type(e).__name__ in _named_errors():
                conn.send(("err", rid, "named", (type(e).__name__, str(e))))
                return
            conn.send(("err", rid, "remote", repr(e)))
            return
        conn.send(("ok", rid, result))

    def _on_batch(self, conn, msgs: list) -> None:
        """Batch dispatch for one inbound frame (or loopback drain):
        the frame's REQUESTS all start in a single loop step
        (futures.start_batch) — N handler wakeups collapse into one,
        which is where the per-request wakeup tax went (run-loop profiler
        evidence) — and the frame's REPLIES batch-settle the
        same way (futures.settle_batch): one super-frame of N reply
        payloads resumes its N waiter tasks via per-priority
        call_soon_batch entries instead of N individual wakeups."""
        from ..runtime import trace as _trace

        tasks: list[Task] = []
        settles: list = []  # (caller future, value, error)
        for msg in msgs:
            kind = msg[0]
            if kind == "req":
                _k, rid, token, payload, *rest = msg
                handler = self.node.endpoints.get(token)
                if handler is None:
                    conn.send(("err", rid, "broken_promise", token))
                    continue
                span_ctx = wire.unpack_span_context(rest[0]) if rest else None
                prev = _trace.swap_active_span(span_ctx)
                try:
                    # profiler attribution names the handler, not the shim
                    t = Task(
                        self._run_and_reply(conn, rid, token, handler, payload),
                        name=getattr(handler, "__qualname__", None),
                    )
                finally:
                    _trace.swap_active_span(prev)
                self.node.actors.add(t.future)
                tasks.append(t)
            elif kind == "ok":
                _k, rid, value = msg
                ent = self._pending_pop(rid)
                if ent is not None and not ent[0].is_ready():
                    settles.append((ent[0], value, None))
            elif kind == "err":
                _k, rid, etype, detail = msg
                ent = self._pending_pop(rid)
                if ent is not None and not ent[0].is_ready():
                    settles.append((ent[0], None, self._reply_exc(etype, detail)))
            else:
                trace(SevWarn, "WireBadKind", self.node.address, Kind=str(kind))
        start_batch(tasks)
        settle_batch(settles)

    def _on_message(self, conn, msg) -> None:
        self._on_batch(conn, [msg])

    @staticmethod
    def _reply_exc(etype, detail) -> BaseException:
        """Reconstruct the caller-side exception for an ``err`` reply."""
        if etype == "fdb":
            from .. import errors as _errors

            cls = getattr(_errors, str(detail), FdbError)
            if not (isinstance(cls, type) and issubclass(cls, FdbError)):
                cls = FdbError
            return cls(str(detail))
        if etype == "broken_promise":
            return BrokenPromise(str(detail))
        if etype == "named":
            name, text = detail
            cls = _named_errors().get(str(name), RemoteError)
            return cls(str(text))
        return RemoteError(str(detail))
