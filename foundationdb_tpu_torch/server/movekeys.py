"""MoveKeys: the two-phase shard relocation protocol.

The analog of fdbserver/MoveKeys.actor.cpp: shard placement changes are
ordinary transactions on ``\\xff/keyServers/``, made safe by the metadata
machinery (every proxy applies them in version order; affected storage
servers get privatized copies in their streams):

- **start** (startMoveKeys): write the shard's entry with the *union* team
  (src ∪ dest), old_* = src. Destinations see their tag appear and begin
  fetchKeys from the sources; sources keep serving.
- wait until every destination reports the range readable
  (getShardState — waitForShardReady).
- **finish** (finishMoveKeys): write the entry with the dest team only.
  Sources see their tag removed and drop the range.

Availability holds throughout: reads go to the union team during the move;
destinations answer wrong_shard_server until ready and the client's load
balancer falls over to a source.

The port's copy of ``foundationdb_tpu/server/movekeys.py``.
"""

from __future__ import annotations

from ..net.sim import Endpoint
from ..runtime.futures import delay
from ..runtime.buggify import buggify
from .interfaces import GetKeyServersRequest, Tokens
from .systemdata import (
    MOVE_KEYS_LOCK_KEY,
    decode_key_servers_value,
    key_servers_key,
    key_servers_value,
)
from ..runtime.loop import Cancelled


class MoveKeysError(Exception):
    pass


async def walk_shards(db):
    """[(begin, end, team, tags)] — one boundary walk of the live shard
    map through the proxies (shared by DD, QuietDatabase, checks)."""
    out = []
    key = b""
    while True:
        reply = await db._proxy_request(
            Tokens.GET_KEY_SERVERS, GetKeyServersRequest(key=key)
        )
        out.append(
            (reply.begin, reply.end, tuple(reply.team), tuple(reply.tags))
        )
        if reply.end is None:
            return out
        key = reply.end


async def take_move_keys_lock(db, owner: str) -> None:
    """Claim shard-relocation ownership (takeMoveKeysLock in the
    reference's MoveKeys.actor.cpp): the new DD overwrites the lock, and
    any mover still holding the old owner id fails its next transaction."""

    async def body(tr):
        tr.set(MOVE_KEYS_LOCK_KEY, owner.encode())

    await db.run(body)


async def _check_move_keys_lock(tr, lock_owner) -> None:
    """Read (⇒ conflict-range) the lock inside a mover transaction; a
    mismatch means another DD took over — abort the move."""
    if lock_owner is None:
        return
    cur = await tr.get(MOVE_KEYS_LOCK_KEY)
    if cur is None or cur.decode() != lock_owner:
        raise MoveKeysError(
            f"moveKeysLock stolen: held by {cur!r}, we are {lock_owner!r}"
        )


async def move_shard(
    db,
    begin: bytes,
    end,
    dest,
    poll_interval: float = 0.2,
    ready_timeout: float = 60.0,
    lock_owner: str = None,
    rebuild_tags=(),
):
    """Move [begin, end) to the team ``dest`` ([StorageInterface]).
    The range must lie inside one current shard (DD moves shard by shard).
    Returns when the move is complete and sources have been released.
    Raises MoveKeysError if a destination never becomes ready (e.g. it
    died mid-move) — the caller (DD) re-plans with a healthy team; the
    union-team start state stays safe to re-move.

    Both phases read the keyServers row and the moveKeysLock inside their
    transactions (gaining read-conflict ranges), so concurrent movers —
    e.g. an old master's DD racing the new one during a fencing window —
    conflict and abort instead of interleaving start/finish writes
    (the reference's moveKeysLock + in-transaction reads,
    MoveKeys.actor.cpp startMoveKeys/finishMoveKeys)."""
    if buggify():
        poll_interval = 0.02  # aggressive polling races fetch completion
    reply = await db._proxy_request(
        Tokens.GET_KEY_SERVERS, GetKeyServersRequest(key=begin)
    )
    if reply.tags is None:
        raise MoveKeysError("proxy has no tag info for shard")
    if not (reply.begin <= begin) or not (
        reply.end is None or (end is not None and end <= reply.end)
    ):
        raise MoveKeysError("range crosses shard boundaries")
    src_addrs, src_tags = tuple(reply.team), tuple(reply.tags)
    dest_addrs = tuple(s.address for s in dest)
    dest_tags = tuple(s.tag for s in dest)
    if set(dest_tags) == set(src_tags) and not rebuild_tags:
        # rebuild_tags forces a same-team re-move: an alive-but-unready
        # member is rebuilt by re-running the protocol (its privatized
        # start mutation restarts the fetch from a healthy source)
        return

    union_addrs = tuple(dict.fromkeys(src_addrs + dest_addrs))
    union_tags = tuple(dict.fromkeys(src_tags + dest_tags))

    # phase 1: startMoveKeys — destinations begin fetching
    async def start(tr):
        await _check_move_keys_lock(tr, lock_owner)
        cur = await tr.get(key_servers_key(begin))
        cur_tags = (
            decode_key_servers_value(cur)["tags"] if cur is not None else None
        )
        if cur_tags is not None and set(cur_tags) == set(union_tags):
            return  # our start already committed (retry after unknown result)
        if cur_tags is not None and set(cur_tags) != set(src_tags):
            raise MoveKeysError(
                f"shard {begin!r} changed under us: {cur_tags} != {src_tags}"
            )
        tr.set(
            key_servers_key(begin),
            key_servers_value(
                union_addrs, union_tags, old_addrs=src_addrs, old_tags=src_tags,
                end=end,
            ),
        )

    await db.run(start)

    # wait for every (new) destination to become readable
    from ..runtime.loop import now

    new_tags = [t for t in dest_tags if t not in src_tags] + [
        t for t in rebuild_tags if t in dest_tags
    ]
    new_members = [s for s in dest if s.tag in new_tags]
    deadline = now() + ready_timeout
    for s in new_members:
        while True:
            try:
                ready = await db.client.request(
                    Endpoint(s.address, Tokens.GET_SHARD_STATE), (begin, end)
                )
                if ready:
                    break
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                pass
            if now() > deadline:
                raise MoveKeysError(
                    f"destination {s.address} (tag {s.tag}) never became ready"
                )
            await delay(poll_interval)

    # phase 2: finishMoveKeys — sources release the range
    async def finish(tr):
        await _check_move_keys_lock(tr, lock_owner)
        cur = await tr.get(key_servers_key(begin))
        info = decode_key_servers_value(cur) if cur is not None else None
        if (
            info is not None
            and set(info["tags"]) == set(dest_tags)
            and not info["old_tags"]
        ):
            return  # our finish already committed
        if info is not None and set(info["tags"]) != set(union_tags):
            raise MoveKeysError(
                f"shard {begin!r} changed mid-move: "
                f"{info['tags']} != {union_tags}"
            )
        # old_* EMPTY: the move is complete — a lingering old set would
        # make every later merge guard see a phantom in-flight move
        tr.set(
            key_servers_key(begin),
            key_servers_value(dest_addrs, dest_tags, end=end),
        )

    await db.run(finish)


async def split_shard(db, at: bytes, lock_owner: str = None) -> bool:
    """Split the shard containing ``at`` at that key — metadata only (the
    team keeps both halves; no data moves). The DD tracker's answer to a
    hot/large shard (shardSplitter, DataDistributionTracker.actor.cpp:340).
    Returns False when ``at`` is already a boundary."""
    reply = await db._proxy_request(
        Tokens.GET_KEY_SERVERS, GetKeyServersRequest(key=at)
    )
    if reply.begin == at:
        return False
    team, tags, end = tuple(reply.team), tuple(reply.tags), reply.end

    async def body(tr):
        await _check_move_keys_lock(tr, lock_owner)
        cur = await tr.get(key_servers_key(reply.begin))
        # an initial (seeded) shard has no row yet — its map entry comes
        # from the cstate snapshot; the read above still conflict-protects
        # the boundary against concurrent movers
        if cur is not None:
            info = decode_key_servers_value(cur)
            if set(info["tags"]) != set(tags) or info["end"] != end:
                raise MoveKeysError("shard changed under split")
            if info["old_tags"]:
                # mid-relocation: splitting now would drop the in-flight
                # move state and let finishMoveKeys leave overlapping rows
                raise MoveKeysError("shard is mid-move; split later")
        # two entries: [begin, at) keeps the row with a new end; [at, end)
        # is a new boundary with the same team
        tr.set(
            key_servers_key(reply.begin),
            key_servers_value(team, tags, end=at),
        )
        tr.set(key_servers_key(at), key_servers_value(team, tags, end=end))

    await db.run(body)
    return True


async def merge_shards(db, begin: bytes, lock_owner: str = None) -> bool:
    """Merge the shard starting at ``begin`` with its RIGHT neighbor —
    legal only when both are held by the same team (shardMerger,
    DataDistributionTracker.actor.cpp:429). Metadata only."""
    left = await db._proxy_request(
        Tokens.GET_KEY_SERVERS, GetKeyServersRequest(key=begin)
    )
    if left.begin != begin or left.end is None:
        return False
    right = await db._proxy_request(
        Tokens.GET_KEY_SERVERS, GetKeyServersRequest(key=left.end)
    )
    if set(right.tags) != set(left.tags):
        return False
    mid = left.end

    async def body(tr):
        await _check_move_keys_lock(tr, lock_owner)
        lrow = await tr.get(key_servers_key(begin))
        rrow = await tr.get(key_servers_key(mid))
        # absent rows = initial seeded boundaries (map from the cstate
        # snapshot); the reads conflict-protect both boundaries either way
        li = decode_key_servers_value(lrow) if lrow is not None else {
            "addrs": tuple(left.team),
            "tags": tuple(left.tags),
            "old_tags": (),
            "end": mid,
        }
        ri = decode_key_servers_value(rrow) if rrow is not None else {
            "addrs": tuple(right.team),
            "tags": tuple(right.tags),
            "old_tags": (),
            "end": right.end,
        }
        if (
            set(li["tags"]) != set(ri["tags"])
            or li["end"] != mid
            or li["old_tags"]
            or ri["old_tags"]
        ):
            raise MoveKeysError("shards changed under merge (or mid-move)")
        tr.clear(key_servers_key(mid))
        tr.set(
            key_servers_key(begin),
            key_servers_value(li["addrs"], li["tags"], end=ri["end"]),
        )

    await db.run(body)
    return True
