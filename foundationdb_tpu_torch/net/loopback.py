"""In-process loopback transport for colocated worlds.

The bench box (and every in-process test cluster) runs many ``RealWorld``
processes on one core, often on ONE RealLoop — yet every RPC between them
pays the full localhost TCP tax: connect, frame, CRC, two socket writes,
two selector wakeups. The reference short-circuits same-process traffic
inside FlowTransport (sendLocal — deliver() without ever touching a
connection); this module is that move for colocated *worlds*: a
per-OS-process registry of listening worlds, and a connection object that
carries frames between two of them with zero syscalls.

Semantics parity is deliberate: every message still round-trips through
the wire codec (``wire.encode_value``/``decode_value``), so loopback
peers exchange *copies* — unserializable payloads, schema drift, and
mutation-aliasing bugs surface exactly as they would over a socket.
(That round-trip is also why loopback benefits from the schema-compiled
codec: with WIRE_COMPILED_CODEC on, the per-message encode/decode here
runs the generated whole-struct pack/unpack instead of the per-field
interpretive walk.)
Delivery is scheduled (one ZERO-priority drain per tick per direction,
mirroring the TCP flush tick), so replies never resolve synchronously
and batches arrive as one batch-dispatch — same shape as a gen-7
super-frame landing.

Selection is automatic (``TRANSPORT_LOOPBACK`` knob, on by default):
``RealWorld.request`` consults the registry before dialing. Both worlds
must run on the SAME loop (cross-thread worlds keep using sockets) and
neither may be TLS-configured (a TLS cluster's authentication story must
not be silently bypassed). A closed world leaves the registry, so dead
peers keep their BrokenPromise semantics.

The port's copy of ``foundationdb_tpu/net/loopback.py``.
"""

from __future__ import annotations

from typing import Optional

from ..runtime.loop import TaskPriority
from . import wire

# listen address -> world, for THIS OS process only. Worlds register at
# listen time and deregister on close; a re-bound address overwrites.
_REGISTRY: dict[str, object] = {}


def register(world) -> None:
    _REGISTRY[world.node.address] = world


def unregister(world) -> None:
    if _REGISTRY.get(world.node.address) is world:
        del _REGISTRY[world.node.address]


def lookup(address: str) -> Optional[object]:
    return _REGISTRY.get(address)


def connect(world, peer_world) -> "LoopbackConn":
    """Create the conn PAIR between two colocated worlds and install both
    ends in their worlds' routing tables. Returns ``world``'s end."""
    a = LoopbackConn(world, peer_world)
    b = LoopbackConn(peer_world, world)
    a.reverse, b.reverse = b, a
    world._conns[peer_world.node.address] = a
    peer_world._conns[world.node.address] = b
    world.transport_metrics.connections.add(1)
    peer_world.transport_metrics.connections.add(1)
    return a


class LoopbackConn:
    """One direction of a colocated-world connection — duck-types the
    ``_Conn`` surface RealWorld routes through (``peer``/``closed``/
    ``send``/``close``)."""

    __slots__ = ("world", "peer_world", "peer", "closed", "reverse", "_pending", "_drain_scheduled")

    def __init__(self, world, peer_world):
        self.world = world  # the sending side
        self.peer_world = peer_world
        self.peer = peer_world.node.address
        self.closed = False
        self.reverse: Optional["LoopbackConn"] = None
        self._pending: list[bytes] = []  # encoded messages this tick
        self._drain_scheduled = False

    def send(self, msg) -> None:
        if self.closed:
            return
        # encode NOW (wire-format parity: the sender pays for — and
        # observes errors from — serialization exactly like TCP)
        self._pending.append(wire.encode_value(msg))
        m = self.world.transport_metrics
        m.messages_sent.add(1)
        m.loopback_messages.add(1)
        if not self._drain_scheduled:
            self._drain_scheduled = True
            # same coalescing window as the TCP flush tick: everything
            # queued during THIS loop tick arrives as one batch
            self.world.loop.call_soon(self._drain, TaskPriority.ZERO)

    def _drain(self) -> None:
        self._drain_scheduled = False
        if self.closed:
            return
        batch, self._pending = self._pending, []
        if not batch:
            return
        sm = self.world.transport_metrics
        sm.frames_sent.add(1)
        sm.messages_per_flush.add(float(len(batch)))
        rm = self.peer_world.transport_metrics
        rm.frames_received.add(1)
        msgs = []
        for payload in batch:
            sm.bytes_sent.add(len(payload))
            rm.bytes_received.add(len(payload))
            rm.messages_received.add(1)
            rm.loopback_messages.add(1)
            msgs.append(wire.decode_value(payload))
        # deliver as one batch through the receiver's batch-dispatch seam
        # (the same path a super-frame takes off a socket)
        self.peer_world._on_batch(self.reverse, msgs)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._pending.clear()
        self.world.transport_metrics.connections_closed.add(1)
        self.world._conn_closed(self)
        # a loopback conn dies as a pair: the peer observes the disconnect
        # immediately (there is no socket to half-close)
        if self.reverse is not None and not self.reverse.closed:
            self.reverse.close()
