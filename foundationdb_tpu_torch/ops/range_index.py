"""Batched point and interval queries over a sorted key snapshot on the CUDA
card — port of ``foundationdb_tpu/ops/range_index.py``.

Keys become fixed-width order-preserving lane codes (conflict/keys.py), the
snapshot is one lex-sorted [cap, L] int32 lane tensor on the device, padded
to a power of two with the all-0xFF sentinel, and a batch of queries is one
launch of the K5 binary-search kernel (``grid.search_both``), which gives
both insertion points of every query at once. Queries are not padded: the
kernel is not compiled per shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..conflict import grid as G
from ..conflict import keys as K
from ..device import lanes_to_torch, resolve_device


class TorchRangeIndex:
    """An immutable snapshot index over sorted keys: built once per
    durability epoch, queried many times in batches."""

    def __init__(self, keys: list, width: int = 32, device=None, _codes=None):
        self._device = resolve_device(device)
        self.width = width
        if _codes is not None:
            codes = _codes
        else:
            codes = K.encode_keys(list(keys), width=width)
        codes = np.asarray(codes)
        if codes.ndim != 2:  # empty key set
            codes = codes.reshape(0, width // 4)
        self.n = codes.shape[0]
        self._codes_np = codes
        # pad to a power of two with the sentinel, as the reference does
        cap = 1
        while cap < max(self.n, 1):
            cap <<= 1
        pad = np.tile(K.max_sentinel(width), (cap - self.n, 1))
        self._codes = lanes_to_torch(np.concatenate([codes, pad], axis=0), self._device)

    def apply_delta(self, added: list, removed: list) -> "TorchRangeIndex":
        """A NEW snapshot index with ``added`` keys inserted and ``removed``
        keys deleted; only the delta is encoded. Codes are truncated, so the
        index is a MULTISET of codes kept row for row parallel to the
        engine's sorted key list: removal deletes one row per removed key
        from its code's contiguous run (duplicate positions offset by
        occurrence rank), and adds insert unconditionally."""
        base = self._codes_np
        view = G.codes_to_bytes(base) if base.size else base.reshape(0)
        if removed:
            rc = K.encode_keys(sorted(removed), width=self.width)
            rv = G.codes_to_bytes(rc)
            pos = np.searchsorted(view, rv)
            # the i-th removal of a code deletes the i-th row of its run
            occ = np.arange(len(pos)) - np.searchsorted(pos, pos, side="left")
            target = pos + occ
            ok = target < len(view)
            ok[ok] = view[target[ok]] == rv[ok]
            if ok.any():
                base = np.delete(base, target[ok], axis=0)
                view = G.codes_to_bytes(base) if base.size else base.reshape(0)
        if added:
            ac = K.encode_keys(sorted(added), width=self.width)
            pos = np.searchsorted(view, G.codes_to_bytes(ac))
            base = np.insert(base, pos, ac, axis=0)
        return TorchRangeIndex(None, width=self.width, device=self._device, _codes=base)

    # -- queries ---------------------------------------------------------------

    def _search(self, qkeys: list):
        q = lanes_to_torch(K.encode_keys(list(qkeys), width=self.width), self._device)
        lo, hi = G.search_both(self._codes, q).cpu().numpy()  # one copy back
        return lo, hi

    def batch_lookup(self, qkeys: list):
        """(indices, found): for each query key, its row in the snapshot
        (or -1). One kernel launch for the whole batch."""
        if self.n == 0 or not qkeys:
            return np.full(len(qkeys), -1, np.int64), np.zeros(len(qkeys), bool)
        lo, hi = self._search(qkeys)
        found = (hi > lo) & (lo < self.n)
        return np.where(found, lo, -1), found

    def batch_range(self, begins: list, ends: list):
        """[(lo, hi)) row bounds per (begin, end) interval — the batched
        KeyRangeMap/readRange primitive. One launch for both ends."""
        if self.n == 0 or not begins:
            z = np.zeros(len(begins), np.int64)
            return z, z
        nq = len(begins)
        lo, _hi = self._search(list(begins) + list(ends))
        return np.minimum(lo[:nq], self.n), np.minimum(lo[nq:], self.n)
