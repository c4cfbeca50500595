"""Mutation wire types.

The analog of the reference's ``MutationRef`` (fdbclient/CommitTransaction.h:27-60):
a transaction's effects are a list of typed mutations; SET_VALUE / CLEAR_RANGE
are the structural ones, the rest are atomic read-modify-write ops applied at
the storage server (and coalesced client-side for read-your-writes).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class MutationType(enum.IntEnum):
    SET_VALUE = 0
    CLEAR_RANGE = 1
    ADD = 2
    AND = 3
    OR = 4
    XOR = 5
    APPEND_IF_FITS = 6
    MAX = 7
    MIN = 8
    SET_VERSIONSTAMPED_KEY = 9
    SET_VERSIONSTAMPED_VALUE = 10
    BYTE_MIN = 11
    BYTE_MAX = 12
    COMPARE_AND_CLEAR = 13


ATOMIC_OPS = frozenset(
    {
        MutationType.ADD,
        MutationType.AND,
        MutationType.OR,
        MutationType.XOR,
        MutationType.APPEND_IF_FITS,
        MutationType.MAX,
        MutationType.MIN,
        MutationType.BYTE_MIN,
        MutationType.BYTE_MAX,
        MutationType.COMPARE_AND_CLEAR,
    }
)

VERSIONSTAMP_OPS = frozenset(
    {MutationType.SET_VERSIONSTAMPED_KEY, MutationType.SET_VERSIONSTAMPED_VALUE}
)


@dataclass(frozen=True)
class Mutation:
    """For SET_VALUE / atomic ops: (type, key, value-or-operand).
    For CLEAR_RANGE: (type, begin, end)."""

    type: MutationType
    param1: bytes
    param2: bytes

    def is_atomic(self) -> bool:
        return self.type in ATOMIC_OPS

    def __repr__(self) -> str:
        return f"Mutation({self.type.name}, {self.param1!r}, {self.param2!r})"
