"""Change feeds: a resumable client cursor over a range's committed
mutations, in version order.

The analog of fdbclient change feeds (ChangeFeedData / getChangeFeedStream
in NativeAPI.actor.cpp), scoped to this repo's storage model: the storage
server keeps a bounded per-epoch diff log of COMMITTED mutations (see
server/watches.py), and the feed endpoint serves whole-version pages from
it, long-polling when the cursor is caught up. The client side here is a
thin cursor: it remembers the next version to ask for, carries a stable
``sub_id`` so the server can lease the retention floor to slow consumers,
and rides the standard load-balanced read path (location cache,
wrong_shard_server invalidation, broken-promise failover).

Scope: a feed streams from the ONE shard that owns its range. A feed over
a range spanning shard boundaries will be refused by every storage server
(wrong_shard_server from the ownership check) — open one feed per shard,
exactly as the reference opens one change-feed stream per storage range.

Resume semantics: ``from_version`` is exclusive — "I have everything
through from_version". Resuming below the server's retention floor raises
``TransactionTooOld`` (the feed analog of a too-old read): the caller must
re-scan the range to re-baseline, then resume from the scan's version.
"""

from __future__ import annotations

__all__ = ["ChangeFeed", "FeedBatch"]


class FeedBatch:
    """One committed version's mutations on the feed range.

    ``clears`` is the version's clear-ranges clipped to the feed range,
    sorted; ``sets`` the (key, value) pairs, sorted. Within a version
    clears apply before sets — the canonical order the storage apply path
    uses, so replaying batches in sequence reproduces the range
    byte-for-byte."""

    __slots__ = ("version", "clears", "sets")

    def __init__(self, version, clears, sets):
        self.version = version
        self.clears = clears
        self.sets = sets

    def __repr__(self):  # pragma: no cover - debugging aid
        return (
            f"FeedBatch(v={self.version}, clears={len(self.clears)},"
            f" sets={len(self.sets)})"
        )


class ChangeFeed:
    """Cursor over a single-shard range's committed-mutation log.

    ``next_batches()`` blocks (server-side long-poll, one parked RPC — no
    client polling) until the range has committed changes past the
    cursor, then returns them as whole-version ``FeedBatch``es and
    advances the cursor. The cursor survives failovers: every call
    re-resolves the shard's team and any replica can serve it, because
    the position lives client-side."""

    def __init__(self, db, begin: bytes, end: bytes, from_version: int = 0):
        if not begin < end:
            raise ValueError("change_feed: begin must sort below end")
        self.db = db
        self.begin = begin
        self.end = end
        #: next ask is "everything AFTER this version"
        self.version = from_version
        # stable subscriber id: the server leases its retention floor to
        # it so a briefly-slow consumer isn't garbage-collected mid-read
        self.sub_id = f"feed-{db.rng.random_unique_id()}"

    async def next_batches(self, limit: int = 0) -> list:
        """The next page of committed versions on the range (≥1 batch).

        ``limit`` caps mutation entries per page (0 = server default,
        STORAGE_FEED_BATCH_ENTRIES); pages always end on a version
        boundary so a batch is never split. Raises ``TransactionTooOld``
        when the cursor has fallen below the server's retention floor."""
        from ..server.interfaces import FeedReadRequest, Tokens
        from .loadbalance import load_balanced_read

        while True:
            req = FeedReadRequest(
                begin=self.begin,
                end=self.end,
                from_version=self.version,
                limit=limit,
                sub_id=self.sub_id,
            )
            reply = await load_balanced_read(
                self.db, self.begin, Tokens.FEED_READ, req
            )
            if reply.next_version > self.version:
                self.version = reply.next_version
            if reply.batches:
                return [
                    FeedBatch(v, list(clears), list(sets))
                    for v, clears, sets in reply.batches
                ]
            # progress-only page (the long-poll woke on commits outside
            # the range): cursor advanced above, park again
