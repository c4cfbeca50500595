"""Atomic-op apply functions.

The analog of fdbclient/Atomic.h. Semantics (matching the reference's
current-generation ops, i.e. the V2 variants where the reference kept buggy
V1 compatibility shims):

- arithmetic/bitwise ops produce a result of the *operand's* length, with the
  existing value zero-extended or truncated to match;
- on a missing key, every op (including AND, per the reference's doAndV2)
  stores the operand;
- COMPARE_AND_CLEAR returns None (clear) iff the existing value equals the
  operand.

Every function takes (existing: bytes | None, param: bytes) and returns the
new value, or None meaning "key cleared".
"""

from __future__ import annotations

from typing import Callable, Optional

from .mutations import MutationType

APPEND_LIMIT = 131072  # value-size limit, matches reference VALUE_SIZE_LIMIT


def _fit(existing: Optional[bytes], n: int) -> bytes:
    e = existing or b""
    return e[:n].ljust(n, b"\x00")


def do_add(existing: Optional[bytes], param: bytes) -> bytes:
    if not param:
        return b""
    n = len(param)
    a = int.from_bytes(_fit(existing, n), "little")
    b = int.from_bytes(param, "little")
    return ((a + b) % (1 << (8 * n))).to_bytes(n, "little")


def do_and(existing: Optional[bytes], param: bytes) -> bytes:
    if existing is None:
        return param  # doAndV2: absent key stores the operand
    e = _fit(existing, len(param))
    return bytes(x & y for x, y in zip(e, param))


def do_or(existing: Optional[bytes], param: bytes) -> bytes:
    e = _fit(existing, len(param))
    return bytes(x | y for x, y in zip(e, param))


def do_xor(existing: Optional[bytes], param: bytes) -> bytes:
    e = _fit(existing, len(param))
    return bytes(x ^ y for x, y in zip(e, param))


def do_append_if_fits(existing: Optional[bytes], param: bytes) -> bytes:
    e = existing or b""
    return e + param if len(e) + len(param) <= APPEND_LIMIT else e


def do_max(existing: Optional[bytes], param: bytes) -> bytes:
    if existing is None:
        return param
    e = _fit(existing, len(param))
    a = int.from_bytes(e, "little")
    b = int.from_bytes(param, "little")
    return e if a > b else param


def do_min(existing: Optional[bytes], param: bytes) -> bytes:
    if existing is None:
        return param
    e = _fit(existing, len(param))
    a = int.from_bytes(e, "little")
    b = int.from_bytes(param, "little")
    return e if a < b else param


def do_byte_max(existing: Optional[bytes], param: bytes) -> bytes:
    if existing is None:
        return param
    return existing if existing > param else param


def do_byte_min(existing: Optional[bytes], param: bytes) -> bytes:
    if existing is None:
        return param
    return existing if existing < param else param


def do_compare_and_clear(
    existing: Optional[bytes], param: bytes
) -> Optional[bytes]:
    return None if existing == param else existing


APPLY: dict[MutationType, Callable[[Optional[bytes], bytes], Optional[bytes]]] = {
    MutationType.ADD: do_add,
    MutationType.AND: do_and,
    MutationType.OR: do_or,
    MutationType.XOR: do_xor,
    MutationType.APPEND_IF_FITS: do_append_if_fits,
    MutationType.MAX: do_max,
    MutationType.MIN: do_min,
    MutationType.BYTE_MIN: do_byte_min,
    MutationType.BYTE_MAX: do_byte_max,
    MutationType.COMPARE_AND_CLEAR: do_compare_and_clear,
}


def apply_atomic(
    op: MutationType, existing: Optional[bytes], param: bytes
) -> Optional[bytes]:
    return APPLY[op](existing, param)
