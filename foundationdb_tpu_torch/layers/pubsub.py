"""Pub/sub layer: topics built on watches + change feeds.

The layer the notification subsystem exists for (the reference ships the
same shape as the old pubsub layer and, later, change-feed consumers):
publishers append messages to a topic subspace; subscribers either

- **tail** the topic with a change feed (every message, in publish
  order, resumable from a version cursor — the durable-consumer shape),
  or
- **wait** on a per-topic dirty key with a watch (the cheap wake-me
  shape for millions of mostly-idle subscribers: one parked watch each,
  no polling; on wake, the subscriber range-reads what it missed).

Messages are rows ``topic/<seq>`` with a transactional sequence counter,
so publish order IS key order and a subscriber's cursor is just the last
sequence it consumed. The dirty key is overwritten with the latest
sequence on every publish — watchers coalesce a burst into one wake,
exactly the semantics watches guarantee (at least one fire per change
from the watched value, not one per change).
"""

from __future__ import annotations

from .subspace import Subspace


class Topic:
    def __init__(self, subspace: Subspace, name: str):
        self.space = subspace[name]
        self.messages = self.space["m"]
        self.seq_key = self.space.pack(("seq",))
        self.dirty_key = self.space.pack(("dirty",))

    # -- publisher -------------------------------------------------------------

    async def publish(self, tr, payload: bytes) -> int:
        """Append one message inside the caller's transaction. Returns
        the message's sequence number."""
        raw = await tr.get(self.seq_key)
        n = int.from_bytes(raw, "big") if raw else 0
        tr.set(self.seq_key, (n + 1).to_bytes(8, "big"))
        tr.set(self.messages.pack((n,)), payload)
        # the watch target: one small key, last-writer-wins — a burst of
        # publishes coalesces into one fire for every parked subscriber
        tr.set(self.dirty_key, (n + 1).to_bytes(8, "big"))
        return n

    # -- watch-based subscriber (idle-cheap) -----------------------------------

    async def wait_for_messages(self, db, after_seq: int = -1) -> list:
        """Park until the topic has messages past ``after_seq``, then
        return [(seq, payload), ...] — the watch-based consumer: one
        parked future while idle, a range read on wake."""

        async def body(tr):
            _b, e = self.messages.range()
            rows = await tr.get_range(self.messages.pack((after_seq,)), e)
            fresh = [
                (self.messages.unpack(k)[0], v)
                for k, v in rows
                if self.messages.unpack(k)[0] > after_seq
            ]
            if fresh:
                return fresh, None
            return [], tr.watch(self.dirty_key)

        while True:
            fresh, fired = await db.run(body)
            if fresh:
                return fresh
            await fired  # parked: zero cost until somebody publishes

    # -- feed-based subscriber (durable tail) ----------------------------------

    def tail(self, db, from_version: int = 0):
        """A resumable change-feed tailer over the topic's message rows:
        yields every message exactly once in publish order, surviving
        client restarts via the (version, seq) cursor pair."""
        b, e = self.messages.range()
        return _Tail(self, db.change_feed(b, e, from_version))


class _Tail:
    """Iterator state for Topic.tail: drains feed batches into (seq,
    payload) messages; ``feed.version`` is the resume cursor."""

    def __init__(self, topic: Topic, feed):
        self.topic = topic
        self.feed = feed

    async def next_messages(self) -> list:
        """Block until new messages commit; return [(seq, payload), ...]
        in publish order."""
        out = []
        for batch in await self.feed.next_batches():
            for k, v in batch.sets:
                out.append((self.topic.messages.unpack(k)[0], v))
        return out
