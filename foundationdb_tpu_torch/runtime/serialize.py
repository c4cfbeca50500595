"""Binary serialization: length-prefixed, versioned archives.

The analog of flow/serialize.h (BinaryWriter/BinaryReader with
protocol-version stamps) — hand-rolled little-endian framing used by the
durable formats (DiskQueue entries, storage-engine snapshots, tlog
payloads). The simulator passes Python objects by reference, so this is
only on the durability path (and later the wire path of the C API).
"""

from __future__ import annotations

import struct

# fdb-tpu wire format generation. The codec decodes structs positionally
# (schema-by-convention), so ANY dataclass field change in a wire type
# MUST bump this — mixed-build processes then reject each other at the
# handshake instead of raising mid-stream.
# gen 2: GetCommitVersionRequest.applied_changes_version +
#        GetCommitVersionReply.resolver_changes[,_version]
# gen 3: TransactionData.debug_id (transaction debug chains)
# gen 4: request tuples carry a span-context envelope field
#        (distributed tracing; net/tcp.py "req" messages)
# gen 5: batched read pipeline — storage.multiGet / storage.multiGetRange
#        endpoints and their MultiGet*Request/Reply shapes
# gen 6: GRV priority/tenant envelope
# gen 7: super-frame batched framing (net/wire.py BATCH_BIT frames;
#        receivers accept gen-6-shaped per-message frames too, but a
#        gen-6 build must not peer with a gen-7 one — the handshake
#        rejects the mix)
# gen 8: watches + change feeds — storage.feedRead streaming envelope
#        (FeedReadRequest/Reply whole-version pages riding the super-
#        frame path) and the known_committed frontier piggybacked on
#        TLogPeekReply; a gen-7 peer would decode peek replies
#        positionally wrong, so the handshake must reject it
PROTOCOL_VERSION = 0x0FDB00B070010009  # gen-9: proxy conflict pre-filter —
#        ResolveBatchReply grows committed_ranges + version_floor
#        (resolver→proxy summary feedback); the codec is positional, so a
#        gen-8 peer would misparse the reply tail — handshake rejects it
#
# NOT a generation bump: the schema-compiled codec (net/wire.py,
# WIRE_COMPILED_CODEC) emits byte-identical gen-9 frames — it changes how
# structs are packed/unpacked, never what lands on the wire. The
# tests/golden_wire.json fixture plus the fuzzed compiled-vs-interpretive
# differential in tests/test_wire_codec.py enforce that equivalence; a
# real field change still bumps the generation as before.


class BinaryWriter:
    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list[bytes] = []

    def u8(self, v: int) -> "BinaryWriter":
        self._parts.append(struct.pack("<B", v))
        return self

    def u32(self, v: int) -> "BinaryWriter":
        self._parts.append(struct.pack("<I", v))
        return self

    def i64(self, v: int) -> "BinaryWriter":
        self._parts.append(struct.pack("<q", v))
        return self

    def u64(self, v: int) -> "BinaryWriter":
        self._parts.append(struct.pack("<Q", v))
        return self

    def bytes_(self, b: bytes) -> "BinaryWriter":
        """Length-prefixed byte string."""
        self._parts.append(struct.pack("<I", len(b)))
        self._parts.append(b)
        return self

    def raw(self, b: bytes) -> "BinaryWriter":
        self._parts.append(b)
        return self

    def data(self) -> bytes:
        return b"".join(self._parts)


class BinaryReader:
    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes):
        self._buf = buf
        self._pos = 0

    def u8(self) -> int:
        (v,) = struct.unpack_from("<B", self._buf, self._pos)
        self._pos += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self._buf, self._pos)
        self._pos += 4
        return v

    def i64(self) -> int:
        (v,) = struct.unpack_from("<q", self._buf, self._pos)
        self._pos += 8
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self._buf, self._pos)
        self._pos += 8
        return v

    def bytes_(self) -> bytes:
        n = self.u32()
        v = self._buf[self._pos : self._pos + n]
        assert len(v) == n, "truncated archive"
        self._pos += n
        return v

    def remaining(self) -> int:
        return len(self._buf) - self._pos


# -- mutation codec (CommitTransaction.h wire shape) ---------------------------


def write_mutation(w: BinaryWriter, m) -> None:
    w.u8(int(m.type)).bytes_(m.param1).bytes_(m.param2 or b"")


def read_mutation(r: BinaryReader):
    from ..kv.mutations import Mutation, MutationType

    t = MutationType(r.u8())
    p1 = r.bytes_()
    p2 = r.bytes_()
    return Mutation(t, p1, p2)


def write_tagged_messages(version: int, messages: dict) -> bytes:
    """One tlog entry: version + {tag: [mutations]}."""
    w = BinaryWriter()
    w.i64(version)
    w.u32(len(messages))
    for tag, muts in messages.items():
        w.i64(tag)
        w.u32(len(muts))
        for m in muts:
            write_mutation(w, m)
    return w.data()


def read_tagged_messages(buf: bytes):
    r = BinaryReader(buf)
    version = r.i64()
    n_tags = r.u32()
    messages = {}
    for _ in range(n_tags):
        tag = r.i64()
        n = r.u32()
        messages[tag] = [read_mutation(r) for _ in range(n)]
    return version, messages
