"""Transport instrumentation — one CounterCollection per process world.

The analog of the reference's per-connection PacketBuffer/transport
counters (fdbrpc/FlowTransport.actor.cpp's TransportData counters and
the ``Net2Metrics`` frame/byte totals): every world (real TCP or sim)
owns exactly one ``TransportMetrics``; connections and the loopback path
feed it on the hot path, the worker's ``transport.metrics`` endpoint and
the status document's ``transport`` section pull it. The flowlint
registration rule (``transport_metrics_endpoint`` in config.json) keeps
the endpoint from silently disappearing.

Counter semantics:

- ``messagesSent/Received`` — logical RPC messages (requests + replies).
- ``framesSent/Received`` — wire frames; with gen-7 super-frame batching
  one frame carries many messages, so messages/frames is the coalescing
  ratio the bench rows cite.
- ``bytesSent/Received`` — payload + framing bytes on the wire.
- ``loopbackMessages`` vs ``tcpMessages`` — which path carried each
  message (colocated worlds ride the in-process loopback; everything
  else pays the socket).
- ``truncationFaults`` — injected super-frame truncation / partial-flush
  faults observed (sim chaos site + the real-TCP flush fault hook).
- ``messagesPerFlush`` — sample of messages coalesced into each flushed
  super-frame (the pipelining/batching depth evidence).
- ``pipelinedDepth`` — sample of requests already in flight on the
  connection when another was sent (connection-level pipelining).
- ``sendCompactionBytes/recvCompactionBytes`` — bytes moved by buffer
  compaction (the O(n)-copy guarantee the regression test pins).
"""

from __future__ import annotations

from ..runtime.stats import CounterCollection


class TransportMetrics:
    """Per-world transport counters (see module docstring)."""

    def __init__(self, ident: str = ""):
        self.stats = CounterCollection("Transport", ident)
        c = self.stats.counter
        self.messages_sent = c("messagesSent")
        self.messages_received = c("messagesReceived")
        self.frames_sent = c("framesSent")
        self.frames_received = c("framesReceived")
        self.bytes_sent = c("bytesSent")
        self.bytes_received = c("bytesReceived")
        self.loopback_messages = c("loopbackMessages")
        self.tcp_messages = c("tcpMessages")
        self.truncation_faults = c("truncationFaults")
        self.connections = c("connectionsOpened")
        self.connections_closed = c("connectionsClosed")
        self.messages_per_flush = self.stats.latency("messagesPerFlush")
        self.pipelined_depth = self.stats.latency("pipelinedDepth")
        # compaction byte totals are fed by the wire buffers (gauges so the
        # buffers stay dependency-free)
        self._compaction_sources: list = []  # objects with .bytes_moved
        self.stats.gauge("bufferCompactionBytes", self._compaction_bytes)

    def track_buffer(self, buf) -> None:
        """Register a Send/RecvBuffer whose ``bytes_moved`` counts toward
        the compaction gauge (dead connections' buffers are dropped by
        ``untrack_buffer``)."""
        self._compaction_sources.append(buf)

    def untrack_buffer(self, buf) -> None:
        try:
            self._compaction_sources.remove(buf)
        except ValueError:
            pass

    def _compaction_bytes(self) -> int:
        return sum(b.bytes_moved for b in self._compaction_sources)

    def snapshot(self, elapsed=None) -> dict:
        snap = self.stats.snapshot(elapsed)
        sent = snap.get("messagesSent") or 0
        frames = snap.get("framesSent") or 0
        snap["messagesPerFrame"] = round(sent / frames, 2) if frames else 0.0
        return snap
