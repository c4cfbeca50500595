"""The \\xff system keyspace: schema, encoders, metadata-mutation helpers.

The analog of fdbclient/SystemData.cpp (keyServersKeys/serverListKeys at
:25-33) plus the pieces of fdbserver/ApplyMetadataMutation.h that interpret
keyServers changes:

- ``\\xff/keyServers/<begin>`` → the shard starting at <begin>: its team
  (storage addresses + tags) and, during a move, the old team that still
  holds the data (the source for the destination's fetchKeys).
- ``\\xff\\xff...`` — the *private* prefix: a copy of a metadata mutation
  delivered through a storage server's own tag stream so it learns about
  shard assignment changes in version order with its data
  (ApplyMetadataMutation's privatized mutations). Private rows are
  interpreted, never stored.
- ``TXS_TAG`` — the transaction-state tag: every metadata mutation is also
  pushed to every tlog under this tag, so a recovering master can rebuild
  the live shard map from the coordinated-state snapshot plus the tag's
  deltas (the reference's txnStateStore-in-the-log,
  LogSystemDiskQueueAdapter + readTransactionSystemState).
"""

from __future__ import annotations

import json

SYSTEM_PREFIX = b"\xff"
PRIVATE_PREFIX = b"\xff\xff"
KEY_SERVERS_PREFIX = b"\xff/keyServers/"
SERVER_LIST_PREFIX = b"\xff/serverList/"
CONF_PREFIX = b"\xff/conf/"
# active mutation-log captures (backup/DR): \xff/logRanges/<uid> →
# {begin, end, dest} — the reference's logRangesRange
# (SystemData.cpp logRangesRange + ApplyMetadataMutation's handling);
# committed mutations inside [begin, end) are duplicated by the proxies
# into the dest prefix (the \xff\x02 backup log keyspace)
LOG_RANGES_PREFIX = b"\xff/logRanges/"
BACKUP_LOG_PREFIX = b"\xff\x02/blog/"

TXS_TAG = -1  # the txnStateStore tag, on every tlog

# Ownership fence for shard relocation (the reference's moveKeysLockOwnerKey,
# SystemData.cpp): the current DD instance writes its uid here; every
# start/finish transaction re-reads it, so a superseded DD (an old master's,
# still running during a fencing window) conflicts instead of corrupting the
# keyServers bookkeeping mid-move.
MOVE_KEYS_LOCK_KEY = b"\xff/moveKeysLock"


def log_ranges_key(uid: str) -> bytes:
    return LOG_RANGES_PREFIX + uid.encode()


def log_ranges_value(begin: bytes, end, dest: bytes) -> bytes:
    return json.dumps(
        {
            "begin": begin.hex(),
            "end": end.hex() if end is not None else "inf",
            "dest": dest.hex(),
        }
    ).encode()


def decode_log_ranges_value(value: bytes) -> dict:
    d = json.loads(value.decode())
    return {
        "begin": bytes.fromhex(d["begin"]),
        "end": None if d["end"] == "inf" else bytes.fromhex(d["end"]),
        "dest": bytes.fromhex(d["dest"]),
    }


def key_servers_key(begin: bytes) -> bytes:
    return KEY_SERVERS_PREFIX + begin


def decode_key_servers_key(key: bytes) -> bytes:
    assert key.startswith(KEY_SERVERS_PREFIX)
    return key[len(KEY_SERVERS_PREFIX) :]


def key_servers_value(addrs, tags, old_addrs=(), old_tags=(), end=None) -> bytes:
    """Team for the shard; during a move old_* is the source team still
    holding the data (the reference encodes src/dest sets the same way).
    ``end`` makes the range explicit so a storage server can interpret its
    privatized copy without knowing the whole boundary set."""
    return json.dumps(
        {
            "addrs": list(addrs),
            "tags": list(tags),
            "old_addrs": list(old_addrs),
            "old_tags": list(old_tags),
            "end": end.hex() if end is not None else "inf",
        }
    ).encode()


def decode_key_servers_value(value: bytes) -> dict:
    d = json.loads(value.decode())
    end = d.get("end", "inf")
    return {
        "addrs": tuple(d["addrs"]),
        "tags": tuple(d["tags"]),
        "old_addrs": tuple(d.get("old_addrs", ())),
        "old_tags": tuple(d.get("old_tags", ())),
        "end": None if end == "inf" else bytes.fromhex(end),
    }


def apply_log_range_mutations(log_ranges: dict, mutations) -> None:
    """Track backup/DR capture registrations (\\xff/logRanges/) from a
    committed metadata-mutation stream into `log_ranges` (uid → decoded
    value). Shared by the proxies' live state application and the master's
    recovery replay — one format, one interpreter."""
    from ..kv.mutations import MutationType

    for m in mutations:
        if m.type == MutationType.SET_VALUE and m.param1.startswith(
            LOG_RANGES_PREFIX
        ):
            uid = m.param1[len(LOG_RANGES_PREFIX) :].decode()
            log_ranges[uid] = decode_log_ranges_value(m.param2)
        elif m.type == MutationType.CLEAR_RANGE:
            for uid in [
                u
                for u in log_ranges
                if m.param1 <= LOG_RANGES_PREFIX + u.encode() < m.param2
            ]:
                del log_ranges[uid]


def is_metadata_mutation(m) -> bool:
    """Does this mutation touch the transaction-state keyspace? (the
    proxy's isMetadataMutation test, MasterProxyServer.actor.cpp). The
    backup-log keyspace (\\xff\\x02) is system-prefixed but NOT state —
    it's bulk data the agents drain; forwarding it through the resolvers
    and the txs tag would pin the tlogs with it."""
    return (
        m.param1.startswith(SYSTEM_PREFIX)
        and not m.param1.startswith(PRIVATE_PREFIX)
        and not m.param1.startswith(b"\xff\x02")
    )


def apply_metadata_mutations(shard_map, mutations):
    """Apply committed metadata mutations to a proxy's keyInfo shard map
    (ApplyMetadataMutation.h). Returns the tagging plan: for each
    keyServers mutation, (mutation, private_tags) where private_tags are
    the storage tags (old ∪ new teams) that must see a privatized copy in
    their streams."""
    from ..kv.mutations import MutationType

    plan = []
    for m in mutations:
        if m.type != MutationType.SET_VALUE or not m.param1.startswith(
            KEY_SERVERS_PREFIX
        ):
            continue
        begin = decode_key_servers_key(m.param1)
        info = decode_key_servers_value(m.param2)
        end = info["end"]
        old_tags = set()
        for _b, _e, v in shard_map.map.intersecting(begin, end):
            if v is not None:
                old_tags.update(v[1])
        shard_map.set_shard(begin, end, info["addrs"], info["tags"])
        plan.append((m, tuple(old_tags | set(info["tags"]))))
    return plan
