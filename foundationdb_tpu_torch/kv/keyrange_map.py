"""Key-range → value map.

The analog of the reference's KeyRangeMap (fdbclient/KeyRangeMap.h:36 over
fdbrpc/RangeMap.h): a total map over the key space [b"", ∞) represented as
sorted boundary keys, each owning the half-open range up to the next boundary.
Used for the shard map (key → storage team), the proxy's keyResolvers map,
and — stage 7 — batched as the device interval-query primitive on the read path.
"""

from __future__ import annotations

import bisect
from typing import Any, Iterator, Optional, Tuple


class KeyRangeMap:
    def __init__(self, default: Any = None) -> None:
        self._bounds: list[bytes] = [b""]
        self._vals: list[Any] = [default]

    def _idx(self, key: bytes) -> int:
        return bisect.bisect_right(self._bounds, key) - 1

    def __getitem__(self, key: bytes) -> Any:
        return self._vals[self._idx(key)]

    def range_for(self, key: bytes) -> Tuple[bytes, Optional[bytes], Any]:
        """(begin, end, value) of the range containing key; end=None is ∞."""
        i = self._idx(key)
        end = self._bounds[i + 1] if i + 1 < len(self._bounds) else None
        return self._bounds[i], end, self._vals[i]

    def range_before(self, key: bytes) -> Tuple[bytes, Optional[bytes], Any]:
        """(begin, end, value) of the range containing the keys immediately
        BELOW ``key`` (i.e. the predecessor's range). For key == b"" there is
        no predecessor; returns the first range."""
        i = self._idx(key)
        if self._bounds[i] == key and i > 0:
            i -= 1
        end = self._bounds[i + 1] if i + 1 < len(self._bounds) else None
        return self._bounds[i], end, self._vals[i]

    def insert(self, begin: bytes, end: Optional[bytes], value: Any) -> None:
        """Set value on [begin, end); end=None means to infinity."""
        if end is not None and begin >= end:
            return
        # value that resumes at `end`
        if end is not None:
            resume = self._vals[self._idx(end)]
        lo = bisect.bisect_left(self._bounds, begin)
        hi = bisect.bisect_left(self._bounds, end) if end is not None else len(self._bounds)
        new_bounds = [begin]
        new_vals = [value]
        if end is not None and (hi >= len(self._bounds) or self._bounds[hi] != end):
            new_bounds.append(end)
            new_vals.append(resume)
        self._bounds[lo:hi] = new_bounds
        self._vals[lo:hi] = new_vals

    def ranges(self) -> Iterator[Tuple[bytes, Optional[bytes], Any]]:
        """Yield (begin, end, value); final range has end=None (infinity)."""
        for i, b in enumerate(self._bounds):
            e = self._bounds[i + 1] if i + 1 < len(self._bounds) else None
            yield b, e, self._vals[i]

    def intersecting(
        self, begin: bytes, end: Optional[bytes]
    ) -> list[Tuple[bytes, Optional[bytes], Any]]:
        """Ranges overlapping [begin, end), clipped to it. O(log n + k):
        this sits on the proxy's per-conflict-range routing hot path."""
        out = []
        i = self._idx(begin)
        n = len(self._bounds)
        while i < n:
            b = self._bounds[i]
            if end is not None and b >= end:
                break
            e = self._bounds[i + 1] if i + 1 < n else None
            cb = max(b, begin)
            ce = e if end is None else (end if e is None else min(e, end))
            out.append((cb, ce, self._vals[i]))
            i += 1
        return out

    def _split_at(self, key: bytes) -> None:
        i = self._idx(key)
        if self._bounds[i] != key:
            self._bounds.insert(i + 1, key)
            self._vals.insert(i + 1, self._vals[i])

    def modify(self, begin: bytes, end: Optional[bytes], fn) -> None:
        """Apply ``fn(old_value) -> new_value`` to every piece of
        [begin, end), splitting boundaries at begin/end (RangeMap::modify)."""
        self._split_at(begin)
        if end is not None:
            self._split_at(end)
        lo = bisect.bisect_left(self._bounds, begin)
        hi = (
            bisect.bisect_left(self._bounds, end)
            if end is not None
            else len(self._bounds)
        )
        for i in range(lo, hi):
            self._vals[i] = fn(self._vals[i])

    def coalesce(self) -> None:
        """Merge adjacent ranges with equal values (CoalescedKeyRangeMap)."""
        bounds, vals = [self._bounds[0]], [self._vals[0]]
        for b, v in zip(self._bounds[1:], self._vals[1:]):
            if v != vals[-1]:
                bounds.append(b)
                vals.append(v)
        self._bounds, self._vals = bounds, vals
