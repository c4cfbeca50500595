"""Key selectors: offset-relative keyspace navigation.

The analog of the reference's KeySelectorRef (fdbclient/FDBTypes.h:462)
and the four standard constructors every binding exposes
(fdb_c's FDB_KEYSEL_* macros). A selector (key, or_equal, offset) names
a position in the ordered keyspace relative to existing keys:

    base  = the last key <  `key`   (or_equal=False)
            the last key <= `key`   (or_equal=True)
    result= the key `offset` positions after base (offset may be <= 0)

Resolution clamps to the navigable keyspace: a position before the first
key resolves to b"" and a position past the last key resolves to
SELECTOR_END (b"\\xff" — the reference's behavior without system-key
access, NativeAPI.actor.cpp getKey's maxKey clamp). Keys at or above
SELECTOR_END (the system keyspace) are invisible to selector walks.

The reference normalizes or_equal away before resolving
(KeySelectorRef::removeOrEqual: "<= k" is "< keyAfter(k)"); everything
past the client API boundary — the storage getKey endpoint, the model
oracle — works on the normalized (key, offset) form, where resolution
over a sorted key list K is simply K[bisect_left(K, key) - 1 + offset].
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Iterable

# resolution clamp / system-keyspace boundary (maxKey without system access)
SELECTOR_END = b"\xff"


@dataclass(frozen=True)
class KeySelector:
    key: bytes
    or_equal: bool = False
    offset: int = 1

    @classmethod
    def last_less_than(cls, key: bytes) -> "KeySelector":
        return cls(key, False, 0)

    @classmethod
    def last_less_or_equal(cls, key: bytes) -> "KeySelector":
        return cls(key, True, 0)

    @classmethod
    def first_greater_than(cls, key: bytes) -> "KeySelector":
        return cls(key, True, 1)

    @classmethod
    def first_greater_or_equal(cls, key: bytes) -> "KeySelector":
        return cls(key, False, 1)

    # offset arithmetic: fGoE(k) + 1 names the key after the one fGoE(k)
    # names, etc. — the binding idiom for paging through the keyspace
    def __add__(self, n: int) -> "KeySelector":
        return KeySelector(self.key, self.or_equal, self.offset + n)

    def __sub__(self, n: int) -> "KeySelector":
        return KeySelector(self.key, self.or_equal, self.offset - n)

    def normalized(self) -> tuple[bytes, int]:
        """(key, offset) with or_equal removed: "<= k" ≡ "< k+\\x00"."""
        if self.or_equal:
            return self.key + b"\x00", self.offset
        return self.key, self.offset

    def __repr__(self) -> str:  # readable in workload error reports
        return (
            f"KeySelector({self.key!r}, or_equal={self.or_equal}, "
            f"offset={self.offset})"
        )


def as_selector(x) -> KeySelector:
    """Coerce a bare key to the selector naming it (firstGreaterOrEqual —
    what every binding does when a key is passed where a selector is due)."""
    if isinstance(x, KeySelector):
        return x
    return KeySelector.first_greater_or_equal(x)


def resolve(keys: Iterable[bytes], sel) -> bytes:
    """Reference-exact resolution against a fully known key list (the
    model oracle's path; the real path walks shards server-side).
    ``sel`` is a KeySelector or a normalized (key, offset) pair. ``keys``
    need not be pre-filtered: system keys (>= SELECTOR_END) are dropped,
    then the list is sorted."""
    k, off = sel.normalized() if isinstance(sel, KeySelector) else sel
    ks = sorted(key for key in keys if key < SELECTOR_END)
    i = bisect.bisect_left(ks, k) - 1 + off
    if i < 0:
        return b""
    if i >= len(ks):
        return SELECTOR_END
    return ks[i]
