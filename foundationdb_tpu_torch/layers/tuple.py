"""Tuple layer: order-preserving encoding of typed tuples into keys.

The analog of the bindings' tuple encoding (bindings/python/fdb/tuple.py,
fdbclient/Tuple.cpp), byte-compatible for the core types so keys sort the
same way the reference's do:

  0x00 null | 0x01 bytes | 0x02 unicode | 0x05 nested tuple
  0x0c..0x1c integers (biased by byte length around 0x14 = zero)
  0x21 double (sign-flipped IEEE big-endian) | 0x26/0x27 false/true

Bytes/strings escape embedded NULs as 00 FF so ordering matches raw
byte-wise comparison of the packed form.
"""

from __future__ import annotations

import struct

NULL = 0x00
BYTES = 0x01
STRING = 0x02
NESTED = 0x05
INT_ZERO = 0x14
DOUBLE = 0x21
FALSE = 0x26
TRUE = 0x27


def _encode_bytes_like(code: int, b: bytes) -> bytes:
    return bytes([code]) + b.replace(b"\x00", b"\x00\xff") + b"\x00"


def _encode_one(v) -> bytes:
    if v is None:
        return bytes([NULL])
    if isinstance(v, bool):  # before int: bool is an int subclass
        return bytes([TRUE if v else FALSE])
    if isinstance(v, bytes):
        return _encode_bytes_like(BYTES, v)
    if isinstance(v, str):
        return _encode_bytes_like(STRING, v.encode("utf-8"))
    if isinstance(v, int):
        if not (-(1 << 64) < v < (1 << 64)):
            # the reference errors on ints beyond 8 bytes; larger would
            # emit typecodes outside 0x0c..0x1c and break ordering
            raise ValueError("tuple layer integers are limited to 8 bytes")
        if v == 0:
            return bytes([INT_ZERO])
        if v > 0:
            b = v.to_bytes((v.bit_length() + 7) // 8, "big")
            return bytes([INT_ZERO + len(b)]) + b
        n = -v
        size = (n.bit_length() + 7) // 8
        maxv = (1 << (8 * size)) - 1
        return bytes([INT_ZERO - size]) + (maxv - n).to_bytes(size, "big")
    if isinstance(v, float):
        raw = struct.pack(">d", v)
        if raw[0] & 0x80:  # negative: flip all bits
            raw = bytes(x ^ 0xFF for x in raw)
        else:  # positive: flip sign bit
            raw = bytes([raw[0] ^ 0x80]) + raw[1:]
        return bytes([DOUBLE]) + raw
    if isinstance(v, (tuple, list)):
        out = bytes([NESTED])
        for item in v:
            if item is None:
                out += bytes([NULL, 0xFF])  # escaped null inside nesting
            else:
                out += _encode_one(item)
        return out + b"\x00"
    raise TypeError(f"tuple layer can't encode {type(v).__name__}")


def pack(t) -> bytes:
    """Pack a tuple (or any iterable of supported values) into a key."""
    return b"".join(_encode_one(v) for v in t)


def _find_terminator(b: bytes, pos: int) -> int:
    """End of a 00-terminated, 00FF-escaped run starting at pos."""
    while True:
        i = b.index(b"\x00", pos)
        if i + 1 < len(b) and b[i + 1] == 0xFF:
            pos = i + 2
            continue
        return i


def _decode_one(b: bytes, pos: int):
    code = b[pos]
    if code == NULL:
        return None, pos + 1
    if code == BYTES or code == STRING:
        end = _find_terminator(b, pos + 1)
        raw = b[pos + 1 : end].replace(b"\x00\xff", b"\x00")
        return (raw if code == BYTES else raw.decode("utf-8")), end + 1
    if code == NESTED:
        out = []
        pos += 1
        while True:
            if b[pos] == 0x00:
                if pos + 1 < len(b) and b[pos + 1] == 0xFF:
                    out.append(None)
                    pos += 2
                    continue
                return tuple(out), pos + 1
            v, pos = _decode_one(b, pos)
            out.append(v)
    if 0x0C <= code <= 0x1C:
        size = code - INT_ZERO
        if size == 0:
            return 0, pos + 1
        if size > 0:
            raw = b[pos + 1 : pos + 1 + size]
            return int.from_bytes(raw, "big"), pos + 1 + size
        size = -size
        raw = b[pos + 1 : pos + 1 + size]
        maxv = (1 << (8 * size)) - 1
        return -(maxv - int.from_bytes(raw, "big")), pos + 1 + size
    if code == DOUBLE:
        raw = b[pos + 1 : pos + 9]
        if raw[0] & 0x80:  # was positive
            raw = bytes([raw[0] ^ 0x80]) + raw[1:]
        else:  # was negative
            raw = bytes(x ^ 0xFF for x in raw)
        return struct.unpack(">d", raw)[0], pos + 9
    if code == FALSE:
        return False, pos + 1
    if code == TRUE:
        return True, pos + 1
    raise ValueError(f"unknown tuple typecode 0x{code:02x} at {pos}")


def unpack(b: bytes) -> tuple:
    out = []
    pos = 0
    while pos < len(b):
        v, pos = _decode_one(b, pos)
        out.append(v)
    return tuple(out)


def range_of(t) -> tuple[bytes, bytes]:
    """(begin, end) spanning every key that extends tuple ``t`` —
    fdb.tuple.range()."""
    p = pack(t)
    return p + b"\x00", p + b"\xff"
