"""Wire format: framed, checksummed, self-describing binary messages.

The analog of the reference's packet framing + serialization
(fdbrpc/FlowTransport.actor.cpp packet framing with CRC32C; flow/serialize.h
BinaryWriter/Reader): every TCP message is

    [u32 length][u32 crc32][payload]

and the payload is a tagged binary value tree. Unlike the simulator (which
passes live Python objects — SURVEY.md weak spot: no wire format was
exercised), everything crossing a real process boundary round-trips through
this codec, including the interface dataclasses in server/interfaces.py and
the rich metadata types (KeyRangeMap, ShardMap, LogSystem, Knobs).

Dataclasses and IntEnums register by class name; the registry is seeded
from the interface modules at import. This is a schema-by-convention
format (field order of the dataclass), versioned by the protocol version
in the connection handshake (net/tcp.py) — the same place the reference
pins compatibility (connectPacket protocol version).

The port's copy of ``foundationdb_tpu/net/wire.py``: the same tags, frames
and registry, seeded from the port's own modules, so a value encodes to
the same bytes in either package (``tests/golden_wire.json``).
"""

from __future__ import annotations

import dataclasses
import enum
import struct
import zlib
from typing import Optional

from ..runtime.serialize import PROTOCOL_VERSION

_FRAME = struct.Struct("<II")  # length, crc32

# value tags
_NONE, _TRUE, _FALSE = 0, 1, 2
_INT, _FLOAT, _BYTES, _STR = 3, 4, 5, 6
_TUPLE, _LIST, _DICT, _SET, _FROZENSET = 7, 8, 9, 10, 11
_STRUCT, _ENUM = 12, 13

_struct_by_name: dict[str, type] = {}
_enum_by_name: dict[str, type] = {}
_packers: dict[type, tuple[str, callable, callable]] = {}


def register_struct(cls: type) -> type:
    """Register a dataclass for wire transport (by class name). Also
    code-gens the schema-compiled encoder/decoder pair for the class
    (see the compiled-codec section below) — registration IS the schema
    compilation step, so a class can never be reachable on the wire
    without a matching compiled codec."""
    assert dataclasses.is_dataclass(cls), cls
    _struct_by_name[cls.__name__] = cls
    _compile_struct_codec(cls)
    return cls


def register_enum(cls: type) -> type:
    _enum_by_name[cls.__name__] = cls
    return cls


def register_custom(cls: type, name: str, pack, unpack) -> None:
    """Register a non-dataclass type: pack(obj) -> value tree,
    unpack(value) -> obj."""
    _packers[cls] = (name, pack, unpack)
    _struct_by_name[name] = (pack, unpack)  # marker; resolved in decode


def register_module(mod) -> None:
    """Register every dataclass and IntEnum defined in a module."""
    for name in dir(mod):
        obj = getattr(mod, name)
        if isinstance(obj, type) and obj.__module__ == mod.__name__:
            if dataclasses.is_dataclass(obj):
                register_struct(obj)
            elif issubclass(obj, enum.Enum):
                register_enum(obj)


class WireError(Exception):
    pass


# -- value codec ---------------------------------------------------------------
#
# Hot path: messages are encoded/decoded once per RPC on every process,
# and profiling the real-TCP cluster put the naive isinstance-chain
# encoder at ~40% of client CPU. The format is UNCHANGED; the encoder
# dispatches on exact type (one dict hit for the common concrete types),
# caches per-int encodings for small ints, and precomputes each struct
# class's header bytes + field getter.

_B_NONE, _B_TRUE, _B_FALSE = bytes([_NONE]), bytes([_TRUE]), bytes([_FALSE])
_B_INT, _B_FLOAT, _B_BYTES = bytes([_INT]), bytes([_FLOAT]), bytes([_BYTES])
_B_STR, _B_TUPLE, _B_LIST = bytes([_STR]), bytes([_TUPLE]), bytes([_LIST])
_B_DICT, _B_SET, _B_FROZENSET = bytes([_DICT]), bytes([_SET]), bytes([_FROZENSET])
_B_STRUCT, _B_ENUM = bytes([_STRUCT]), bytes([_ENUM])
_U32 = struct.Struct("<I").pack
_F64 = struct.Struct("<d").pack


def _int_bytes(v: int) -> bytes:
    b = v.to_bytes((v.bit_length() + 8) // 8 or 1, "little", signed=True)
    return _B_INT + bytes([len(b)]) + b


_SMALL_INTS = [_int_bytes(v) for v in range(-128, 4096)]


def _enc_int(out, v):
    if -128 <= v < 4096:
        out.append(_SMALL_INTS[v + 128])
    else:
        out.append(_int_bytes(v))


def _enc_float(out, v):
    out.append(_B_FLOAT)
    out.append(_F64(v))


def _enc_bytes(out, v):
    out.append(_B_BYTES)
    out.append(_U32(len(v)))
    out.append(bytes(v))


# memoized whole encodings for short, recurring strings: message kinds
# ("req"/"ok"/"err"), endpoint tokens, and role uids repeat on every RPC —
# bounded cache so adversarial/unbounded string sets cannot grow it
_STR_CACHE: dict = {}


def _enc_str_v(out, v):
    enc = _STR_CACHE.get(v)
    if enc is not None:
        out.append(enc)
        return
    b = v.encode()
    if len(b) <= 64 and len(_STR_CACHE) < 4096:
        _STR_CACHE[v] = enc = _B_STR + _U32(len(b)) + b
        out.append(enc)
        return
    out.append(_B_STR)
    out.append(_U32(len(b)))
    out.append(b)


def _enc_tuple(out, v):
    out.append(_B_TUPLE)
    out.append(_U32(len(v)))
    for x in v:
        _enc(out, x)


def _enc_list(out, v):
    out.append(_B_LIST)
    out.append(_U32(len(v)))
    for x in v:
        _enc(out, x)


def _enc_dict(out, v):
    out.append(_B_DICT)
    out.append(_U32(len(v)))
    for k, x in v.items():
        _enc(out, k)
        _enc(out, x)


def _enc_set(out, v):
    out.append(_B_SET)
    out.append(_U32(len(v)))
    for x in sorted(v, key=repr):
        _enc(out, x)


def _enc_frozenset(out, v):
    out.append(_B_FROZENSET)
    out.append(_U32(len(v)))
    for x in sorted(v, key=repr):
        _enc(out, x)


_ENC_DISPATCH = {
    type(None): lambda out, v: out.append(_B_NONE),
    bool: lambda out, v: out.append(_B_TRUE if v else _B_FALSE),
    int: _enc_int,
    float: _enc_float,
    bytes: _enc_bytes,
    bytearray: _enc_bytes,
    memoryview: _enc_bytes,
    str: _enc_str_v,
    tuple: _enc_tuple,
    list: _enc_list,
    dict: _enc_dict,
    set: _enc_set,
    frozenset: _enc_frozenset,
}

def _struct_header(name: str) -> bytes:
    b = name.encode()
    return _B_STRUCT + struct.pack("<H", len(b)) + b


def _enc(out: list, v) -> None:
    f = _ENC_DISPATCH.get(type(v))
    if f is None:
        f = _resolve_encoder(type(v))
    f(out, v)


def _resolve_encoder(cls: type):
    """First sighting of a type outside the concrete-type table: build its
    encoder, REGISTER it in the dispatch table, return it. Registered
    dataclasses get a precomputed header + attrgetter; enums memoize the
    full per-member bytes (members are singletons)."""
    import operator

    if issubclass(cls, enum.Enum):
        name = cls.__name__
        if name not in _enum_by_name:
            raise WireError(f"unregistered enum {cls!r}")
        b = name.encode()
        pre = _B_ENUM + struct.pack("<H", len(b)) + b
        member_cache: dict = {}

        def f(out, v, _pre=pre, _cache=member_cache):
            enc = _cache.get(v)
            if enc is None:
                tmp = [_pre]
                _enc(tmp, v.value)
                enc = _cache[v] = b"".join(tmp)
            out.append(enc)

    elif cls in _packers:
        name, pack, _unpack = _packers[cls]
        header = _struct_header(name)

        def f(out, v, _h=header, _pack=pack):
            out.append(_h)
            _enc(out, _pack(v))

    elif dataclasses.is_dataclass(cls):
        name = cls.__name__
        if _struct_by_name.get(name) is not cls:
            raise WireError(f"unregistered struct {cls!r}")
        fields = [fl.name for fl in dataclasses.fields(cls)]
        if not fields:
            getter = lambda obj: ()  # noqa: E731
        elif len(fields) == 1:
            one = operator.attrgetter(fields[0])
            getter = lambda obj, _g=one: (_g(obj),)  # noqa: E731
        else:
            getter = operator.attrgetter(*fields)
        header = _struct_header(name)

        def f(out, v, _h=header, _g=getter):
            out.append(_h)
            _enc_tuple(out, _g(v))

        # prefer the schema-compiled encoder when the codec is on; the
        # interpretive closure above remains the set_compiled_codec(False)
        # path (the dispatch entry is evicted on toggle and re-resolved)
        if _COMPILED_ON:
            comp = _COMPILED_ENC.get(cls)
            if comp is not None:
                f = comp

    # subclasses of the concrete containers/scalars (NamedTuples, int
    # subclasses that are not IntEnum, ...) encode as their base type —
    # the format has no tag for them
    elif issubclass(cls, bool):
        f = _ENC_DISPATCH[bool]
    elif issubclass(cls, int):
        def f(out, v):
            _enc_int(out, int(v))
    elif issubclass(cls, (bytes, bytearray, memoryview)):
        f = _enc_bytes
    elif issubclass(cls, str):
        def f(out, v):
            _enc_str_v(out, str(v))
    elif issubclass(cls, tuple):
        f = _enc_tuple
    elif issubclass(cls, list):
        f = _enc_list
    elif issubclass(cls, dict):
        f = _enc_dict
    elif issubclass(cls, frozenset):
        f = _enc_frozenset
    elif issubclass(cls, set):
        f = _enc_set
    else:
        raise WireError(f"unserializable value {cls!r}")
    _ENC_DISPATCH[cls] = f
    return f


def _enc_str(out: list, s: str) -> None:
    b = s.encode()
    out.append(struct.pack("<H", len(b)))
    out.append(b)


class _Reader:
    __slots__ = ("buf", "pos", "_mv")

    def __init__(self, buf):
        # memoryview input = zero-copy decode straight out of the receive
        # ring (net/tcp.py): only leaf byte values are materialized (they
        # must own their bytes — decoded messages outlive the buffer)
        self.buf = buf
        self.pos = 0
        self._mv = isinstance(buf, memoryview)

    def take(self, n: int) -> bytes:
        v = self.buf[self.pos : self.pos + n]
        if len(v) != n:
            raise WireError("truncated message")
        self.pos += n
        return bytes(v) if self._mv else v

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        v = struct.unpack_from("<H", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v


_U32_UNPACK_FROM = struct.Struct("<I").unpack_from
_F64_UNPACK_FROM = struct.Struct("<d").unpack_from


def _dec_int(r):
    # direct-slice read (no take() call / no leaf copy): int.from_bytes
    # accepts memoryview slices; frames are CRC-verified before decode,
    # and decode_value's end-position check catches overruns
    buf = r.buf
    pos = r.pos
    n = buf[pos]
    end = pos + 1 + n
    r.pos = end
    return int.from_bytes(buf[pos + 1 : end], "little", signed=True)


def _dec_float(r):
    v = _F64_UNPACK_FROM(r.buf, r.pos)[0]
    r.pos += 8
    return v


def _dec_bytes(r):
    buf = r.buf
    pos = r.pos
    (n,) = _U32_UNPACK_FROM(buf, pos)
    end = pos + 4 + n
    v = buf[pos + 4 : end]
    if len(v) != n:
        raise WireError("truncated message")
    r.pos = end
    return bytes(v) if r._mv else v


def _dec_str(r):
    buf = r.buf
    pos = r.pos
    (n,) = _U32_UNPACK_FROM(buf, pos)
    end = pos + 4 + n
    v = buf[pos + 4 : end]
    if len(v) != n:
        raise WireError("truncated message")
    r.pos = end
    return str(v, "utf-8")


def _dec_enum(r):
    name = r.take(r.u16()).decode()
    cls = _enum_by_name.get(name)
    v = _dec(r)
    if cls is None:
        raise WireError(f"unknown enum {name!r}")
    return cls(v)


def _dec_struct(r):
    name = r.take(r.u16()).decode()
    if _COMPILED_ON:
        dec = _COMPILED_DEC.get(name)
        if dec is not None:
            return dec(r)
    entry = _struct_by_name.get(name)
    v = _dec(r)
    if entry is None:
        raise WireError(f"unknown struct {name!r}")
    if isinstance(entry, tuple):
        _pack, unpack = entry
        return unpack(v)
    return entry(*v)


_DEC_DISPATCH = [
    lambda r: None,  # _NONE
    lambda r: True,  # _TRUE
    lambda r: False,  # _FALSE
    _dec_int,  # _INT
    _dec_float,  # _FLOAT
    _dec_bytes,  # _BYTES
    _dec_str,  # _STR
    lambda r: tuple([_dec(r) for _ in range(r.u32())]),  # _TUPLE
    lambda r: [_dec(r) for _ in range(r.u32())],  # _LIST
    lambda r: {_dec(r): _dec(r) for _ in range(r.u32())},  # _DICT
    lambda r: {_dec(r) for _ in range(r.u32())},  # _SET
    lambda r: frozenset([_dec(r) for _ in range(r.u32())]),  # _FROZENSET
    _dec_struct,  # _STRUCT
    _dec_enum,  # _ENUM
]


def _dec(r: _Reader):
    buf = r.buf
    pos = r.pos
    tag = buf[pos]
    r.pos = pos + 1
    if tag >= len(_DEC_DISPATCH):
        raise WireError(f"bad tag {tag}")
    return _DEC_DISPATCH[tag](r)


_OUT_FREE: list = []


def encode_value(v) -> bytes:
    # chunk-list reuse: encoding is synchronous (no awaits anywhere under
    # _enc), so a small free pool of chunk lists is only ever touched
    # between top-level encodes; an encode that raises abandons its list
    out: list = _OUT_FREE.pop() if _OUT_FREE else []
    _enc(out, v)
    b = b"".join(out)
    out.clear()
    if len(_OUT_FREE) < 8:
        _OUT_FREE.append(out)
    return b


def decode_value(buf):
    r = _Reader(buf)
    try:
        v = _dec(r)
    except (IndexError, struct.error):
        # direct-slice readers surface truncation as index/struct errors;
        # normalize so connections drop with WireError like any bad frame
        raise WireError("truncated message")
    if r.pos != len(buf):
        raise WireError("trailing bytes in message")
    return v


# -- schema-compiled codec -----------------------------------------------------
#
# Second-generation hot path. The dispatch codec above still walks one
# Python frame per field of every struct (_enc_tuple -> _enc -> dict hit
# per field). Registered dataclasses ARE the schema (field order by
# convention), so register_struct() code-gens one specialized encode and
# one specialized decode function per class:
#
#   * the struct header, tuple tag and field count collapse into a single
#     precomputed prefix constant (one append instead of four);
#   * scalar fields (int/bytes/str/None/bool/float) inline their tag
#     handling behind EXACT-class guards (``x.__class__ is int``);
#   * anything that fails a guard — a subclass, a container, a nested
#     struct, an enum — falls through to the generic _enc/_dec walk.
#
# The fallback rule is what makes byte-identity with the interpretive
# codec structural rather than aspirational: every inline fast path is a
# transcription of the matching _ENC_DISPATCH/_DEC_DISPATCH entry, and
# everything else bottoms out in literally the same helpers. The wire
# format is UNCHANGED (gen-9, no protocol bump); tests/test_wire_codec.py
# proves identity by fuzzed differential plus a golden-bytes fixture.
#
# set_compiled_codec(False) (knob WIRE_COMPILED_CODEC) restores the
# interpretive path for A/B runs and the differential harness.

_COMPILED_ON = True
_COMPILED_ENC: dict = {}  # cls -> enc(out, v)
_COMPILED_DEC: dict = {}  # class name -> dec(reader)
_COMPILED_META: dict = {}  # class name -> (cls, field-name tuple)

_ENC_FIELD_TMPL = """\
    x = v.{fname}
    t = x.__class__
    if t is int:
        if -128 <= x < 4096:
            ap(_si[x + 128])
        else:
            ap(_ib(x))
    elif t is bytes:
        ap(_bb)
        ap(_u32(len(x)))
        ap(x)
    elif t is str:
        _es(out, x)
    elif t is _NT:
        ap(_bn)
    elif t is bool:
        ap(_bt if x else _bf)
    elif t is float:
        ap(_bfl)
        ap(_f64(x))
    else:
        _e(out, x)
"""

_DEC_FIELD_TMPL = """\
    tag = buf[pos]
    if tag == 3:
        ln = buf[pos + 1]
        end = pos + 2 + ln
        {f} = int.from_bytes(buf[pos + 2 : end], "little", signed=True)
        pos = end
    elif tag == 5:
        (ln,) = _u32f(buf, pos + 1)
        end = pos + 5 + ln
        x = buf[pos + 5 : end]
        if len(x) != ln:
            raise _we("truncated message")
        {f} = bytes(x) if mv else x
        pos = end
    elif tag == 6:
        (ln,) = _u32f(buf, pos + 1)
        end = pos + 5 + ln
        x = buf[pos + 5 : end]
        if len(x) != ln:
            raise _we("truncated message")
        {f} = str(x, "utf-8")
        pos = end
    elif tag == 0:
        {f} = None
        pos += 1
    elif tag == 1:
        {f} = True
        pos += 1
    elif tag == 2:
        {f} = False
        pos += 1
    else:
        r.pos = pos
        {f} = _d(r)
        pos = r.pos
"""


def _compile_struct_codec(cls: type) -> None:
    """Code-gen the specialized encoder/decoder pair for a registered
    dataclass and record the schema it was generated from (codec_audit
    checks the recorded field tuple against the live class)."""
    name = cls.__name__
    fields = tuple(fl.name for fl in dataclasses.fields(cls))
    pre = _struct_header(name) + _B_TUPLE + _U32(len(fields))

    src = ["def enc(out, v):", "    ap = out.append", "    ap(_pre)"]
    for fname in fields:
        src.append(_ENC_FIELD_TMPL.format(fname=fname))
    ens = {
        "_pre": pre,
        "_si": _SMALL_INTS,
        "_ib": _int_bytes,
        "_bb": _B_BYTES,
        "_u32": _U32,
        "_es": _enc_str_v,
        "_NT": type(None),
        "_bn": _B_NONE,
        "_bt": _B_TRUE,
        "_bf": _B_FALSE,
        "_bfl": _B_FLOAT,
        "_f64": _F64,
        "_e": _enc,
    }
    exec("\n".join(src), ens)

    fvars = [f"f{i}" for i in range(len(fields))]
    src = [
        "def dec(r):",
        "    buf = r.buf",
        "    pos = r.pos",
        # a payload that is not a tuple of exactly our arity (schema drift
        # from a same-version peer, or a hand-built message) takes the
        # generic walk — same constructor call, same errors
        "    if buf[pos] != 7:",
        "        return _cls(*_d(r))",
        "    (n,) = _u32f(buf, pos + 1)",
        f"    if n != {len(fields)}:",
        "        return _cls(*_d(r))",
        "    pos += 5",
        "    mv = r._mv",
    ]
    for f in fvars:
        src.append(_DEC_FIELD_TMPL.format(f=f))
    src.append("    r.pos = pos")
    src.append(f"    return _cls({', '.join(fvars)})")
    dns = {
        "_cls": cls,
        "_d": _dec,
        "_u32f": _U32_UNPACK_FROM,
        "_we": WireError,
    }
    exec("\n".join(src), dns)

    _COMPILED_ENC[cls] = ens["enc"]
    _COMPILED_DEC[name] = dns["dec"]
    _COMPILED_META[name] = (cls, fields)
    # a re-registered (reloaded) class must not keep serving a previously
    # resolved encoder
    _ENC_DISPATCH.pop(cls, None)


def set_compiled_codec(on: bool) -> None:
    """Select the compiled (True) or interpretive (False) struct codec.
    Evicts resolved dataclass encoders so _resolve_encoder re-binds under
    the new mode; decode consults the flag per struct header."""
    global _COMPILED_ON
    on = bool(on)
    if on == _COMPILED_ON:
        return
    _COMPILED_ON = on
    for cls in list(_COMPILED_ENC):
        _ENC_DISPATCH.pop(cls, None)


def compiled_codec_enabled() -> bool:
    return _COMPILED_ON


def codec_audit() -> list:
    """Staleness gate over the compiled codec (the collection-audit
    analog of flowlint's role_required_counters): every register_struct
    dataclass must have a compiled encoder/decoder generated from the
    class's CURRENT field list. Returns a list of problem strings —
    empty means clean. Catches registry pokes that bypass
    register_struct and field drift after generation."""
    problems = []
    for name, entry in sorted(_struct_by_name.items()):
        if isinstance(entry, tuple):
            continue  # register_custom: hand-written pack/unpack pair
        meta = _COMPILED_META.get(name)
        if meta is None:
            problems.append(f"{name}: registered struct has no compiled codec")
            continue
        cls, fields = meta
        if cls is not entry:
            problems.append(f"{name}: compiled codec bound to a stale class")
            continue
        current = tuple(fl.name for fl in dataclasses.fields(entry))
        if current != fields:
            problems.append(
                f"{name}: fields drifted since codec generation "
                f"({list(fields)} -> {list(current)}) — re-register to re-gen"
            )
            continue
        if entry not in _COMPILED_ENC or name not in _COMPILED_DEC:
            problems.append(f"{name}: compiled encoder/decoder missing")
    return problems


# -- frames --------------------------------------------------------------------
#
# Two wire framings share the stream (gen-7):
#
#   legacy frame      [u32 length][u32 crc32][payload]
#   super-frame       [u32 entries_len | BATCH_BIT][u32 crc32][u32 count]
#                     then count x ([u32 len][payload])
#
# The high bit of the length word marks a super-frame (legacy lengths are
# capped at 2^30, so the bit is unambiguous). A super-frame carries every
# message a connection coalesced in one loop tick — ONE frame header, ONE
# checksum, ONE receive-side dispatch for the whole batch. The CRC covers
# the entries region. Receivers accept both framings unconditionally;
# the TRANSPORT_FRAME_BATCHING knob only selects what a sender EMITS, so
# the gen-6-shaped path stays available for A/B within one build.

_BATCH_BIT = 0x8000_0000
_SUPER = struct.Struct("<III")  # entries_len|BATCH_BIT, crc32, count
_U32_AT = struct.Struct("<I").unpack_from


def encode_frame(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def encode_super_frame(payloads: list) -> list:
    """One super-frame as an iovec-style buffer list
    (``[header, len0, p0, len1, p1, ...]``) — built for vectored
    ``socket.sendmsg`` flushes, so the coalesced messages are never
    copied into a joined buffer on the fast path."""
    iov = [b""]
    elen = 0
    crc = 0
    for p in payloads:
        pfx = _U32(len(p))
        crc = zlib.crc32(p, zlib.crc32(pfx, crc))
        iov.append(pfx)
        iov.append(p)
        elen += 4 + len(p)
    if elen >= 1 << 30:
        raise WireError(f"oversized super-frame {elen}")
    iov[0] = _SUPER.pack(elen | _BATCH_BIT, crc, len(payloads))
    return iov


def decode_frames(buf: bytearray):
    """Consume complete frames from ``buf`` (mutates it); yields payloads.
    Raises WireError on a checksum mismatch (connection must drop)."""
    out = []
    pos = 0
    while len(buf) - pos >= _FRAME.size:
        length, crc = _FRAME.unpack_from(buf, pos)
        if length > 1 << 30:
            raise WireError(f"oversized frame {length}")
        if len(buf) - pos - _FRAME.size < length:
            break
        payload = bytes(buf[pos + _FRAME.size : pos + _FRAME.size + length])
        if zlib.crc32(payload) != crc:
            raise WireError("frame checksum mismatch")
        out.append(payload)
        pos += _FRAME.size + length
    del buf[:pos]
    return out


def parse_frames(rb: "RecvBuffer"):
    """Parse complete frames (legacy AND super) out of a receive buffer.
    Returns ``(payload_views, consumed, n_frames)`` where the views point
    INTO the buffer — decode them before calling ``rb.consume(consumed)``
    (consumption may compact the underlying storage)."""
    out = []
    frames = 0
    mv = rb.view()
    n = len(mv)
    pos = 0
    while n - pos >= _FRAME.size:
        length, crc = _FRAME.unpack_from(mv, pos)
        if length & _BATCH_BIT:
            elen = length & ~_BATCH_BIT
            if elen >= 1 << 30:
                raise WireError(f"oversized super-frame {elen}")
            if n - pos < _SUPER.size or n - pos - _SUPER.size < elen:
                break  # incomplete — wait for more bytes
            (count,) = _U32_AT(mv, pos + 8)
            entries = mv[pos + _SUPER.size : pos + _SUPER.size + elen]
            if zlib.crc32(entries) != crc:
                raise WireError("super-frame checksum mismatch")
            epos = 0
            for _ in range(count):
                if elen - epos < 4:
                    raise WireError("super-frame entry truncated")
                (plen,) = _U32_AT(entries, epos)
                if elen - epos - 4 < plen:
                    raise WireError("super-frame entry truncated")
                out.append(entries[epos + 4 : epos + 4 + plen])
                epos += 4 + plen
            if epos != elen:
                raise WireError("trailing bytes in super-frame")
            frames += 1
            pos += _SUPER.size + elen
        else:
            if length > 1 << 30:
                raise WireError(f"oversized frame {length}")
            if n - pos - _FRAME.size < length:
                break
            payload = mv[pos + _FRAME.size : pos + _FRAME.size + length]
            if zlib.crc32(payload) != crc:
                raise WireError("frame checksum mismatch")
            out.append(payload)
            frames += 1
            pos += _FRAME.size + length
    return out, pos, frames


# -- transport buffers ---------------------------------------------------------


class RecvBuffer:
    """Preallocated receive buffer: ``recv_into`` lands bytes directly in
    place, frames are parsed as zero-copy ``memoryview`` slices, and
    consumed space is reclaimed by watermark-triggered compaction — total
    copying over a connection's life is O(bytes received), not the
    O(n²) of per-message ``bytes +=`` / ``del buf[:n]`` churn.
    ``bytes_moved`` counts every byte compaction relocates (the
    regression test's accounting)."""

    __slots__ = ("_buf", "_pos", "_end", "watermark", "bytes_moved")

    def __init__(self, size: int = 1 << 16, watermark: int = 1 << 16):
        self._buf = bytearray(max(int(size), 4096))
        self._pos = 0  # consumed offset
        self._end = 0  # filled offset
        self.watermark = max(int(watermark), 1)
        self.bytes_moved = 0

    def __len__(self) -> int:
        return self._end - self._pos

    def writable(self, need: int = 1 << 16) -> memoryview:
        """A view of free tail space (at least ``need`` bytes): compacts
        first if the live region is offset, grows (doubles) only when the
        live bytes genuinely exceed capacity."""
        if len(self._buf) - self._end < need:
            if self._pos:
                self._compact()
            while len(self._buf) - self._end < need:
                self._buf.extend(bytes(len(self._buf)))
        return memoryview(self._buf)[self._end :]

    def commit(self, n: int) -> None:
        """Bytes were written into ``writable()`` space."""
        self._end += n

    def feed(self, data) -> None:
        """Copy-in path for tests and non-socket sources."""
        mv = self.writable(len(data))
        mv[: len(data)] = data
        del mv  # release the export before any later resize
        self._end += len(data)

    def view(self) -> memoryview:
        return memoryview(self._buf)[self._pos : self._end]

    def consume(self, n: int) -> None:
        self._pos += n
        if self._pos == self._end:
            self._pos = self._end = 0  # free reset — nothing to move
        elif self._pos >= self.watermark and self._pos >= self._end - self._pos:
            # compact only once the dead prefix outweighs the live bytes:
            # each surviving byte can then be moved O(1) times amortized
            # (dead-prefix-only watermarks re-move a large live tail per
            # small consume — the quadratic shape this class exists to kill)
            self._compact()

    def _compact(self) -> None:
        live = self._end - self._pos
        self._buf[0:live] = self._buf[self._pos : self._end]
        self.bytes_moved += live
        self._pos, self._end = 0, live


class SendBuffer:
    """Outbound byte queue with a consumed offset instead of per-send
    ``del buf[:n]``: partial sends advance the offset (O(1)), and the dead
    prefix is reclaimed in one move once it crosses the watermark —
    amortized O(1) per byte regardless of how the kernel fragments the
    sends. ``bytes_moved`` accounts compaction work."""

    __slots__ = ("_buf", "_pos", "watermark", "bytes_moved")

    def __init__(self, watermark: int = 1 << 16):
        self._buf = bytearray()
        self._pos = 0
        self.watermark = max(int(watermark), 1)
        self.bytes_moved = 0

    def __len__(self) -> int:
        return len(self._buf) - self._pos

    def append(self, data) -> None:
        self._buf += data

    def peek(self) -> memoryview:
        return memoryview(self._buf)[self._pos :]

    def consume(self, n: int) -> None:
        self._pos += n
        live = len(self._buf) - self._pos
        if not live:
            self._buf.clear()
            self._pos = 0
        elif self._pos >= self.watermark and self._pos >= live:
            # same amortization rule as RecvBuffer: reclaim only when the
            # dead prefix outweighs the live bytes
            del self._buf[: self._pos]
            self.bytes_moved += live
            self._pos = 0


def pack_span_context(ctx) -> Optional[tuple]:
    """Span context → wire shape (None when the caller is unsampled).
    The envelope field the real-TCP request tuple carries — the analog of
    FlowTransport's SpanContextMessage ahead of the request packet."""
    if ctx is None:
        return None
    return (ctx.trace_id, ctx.span_id)


def unpack_span_context(v):
    """Wire shape → SpanContext (tolerates None / malformed: tracing must
    never turn a valid request into an error)."""
    if not isinstance(v, (tuple, list)) or len(v) != 2:
        return None
    from ..runtime.trace import SpanContext

    return SpanContext(str(v[0]), str(v[1]))


def handshake_bytes(listen_addr: str) -> bytes:
    """Connection preamble: protocol version + the dialer's listen address
    (the reference's connectPacket)."""
    b = listen_addr.encode()
    return struct.pack("<QH", PROTOCOL_VERSION, len(b)) + b


def parse_handshake(buf: bytearray):
    """Returns (listen_addr, consumed) or None if incomplete."""
    if len(buf) < 10:
        return None
    ver, n = struct.unpack_from("<QH", buf, 0)
    if ver != PROTOCOL_VERSION:
        raise WireError(f"protocol version mismatch: {ver:#x}")
    if len(buf) < 10 + n:
        return None
    addr = bytes(buf[10 : 10 + n]).decode()
    return addr, 10 + n


# -- registry seeding ----------------------------------------------------------


def _seed_registry() -> None:
    from ..server import interfaces, log_system, coordination, master
    from ..kv import mutations
    from ..runtime import locality

    # every dataclass a role can hand to request()/CoordinatedState.write()
    # must be here — DBCoreState travels to coordinators over real TCP
    for mod in (interfaces, log_system, coordination, master, mutations, locality):
        register_module(mod)

    from ..kv.keyrange_map import KeyRangeMap

    register_custom(
        KeyRangeMap,
        "KeyRangeMap",
        lambda m: list(m.ranges()),
        lambda rs: _keyrange_map_from(rs),
    )

    from ..server.proxy import ShardMap

    register_custom(
        ShardMap,
        "ShardMap",
        lambda s: s.to_list(),
        lambda rs: ShardMap.from_list(rs),
    )

    from ..server.log_system import LogSystem

    register_custom(
        LogSystem,
        "LogSystem",
        lambda ls: ls.tlog_set,
        lambda ts: LogSystem(ts),
    )

    from ..runtime.knobs import Knobs

    register_custom(
        Knobs,
        "Knobs",
        lambda k: k.as_dict(),
        lambda d: Knobs(**d),
    )


def _keyrange_map_from(ranges):
    from ..kv.keyrange_map import KeyRangeMap

    m = KeyRangeMap()
    for b, e, v in ranges:
        m.insert(b, e, v)
    return m


_seed_registry()
