"""Bucket-grid conflict index on the CUDA card — port of
``foundationdb_tpu/conflict/grid.py``.

State (lanes are int32 tensors carrying uint32 bits, see ``device.py``):

    pivots: int32[B, L]      — lower bound key of bucket b (pivots[0] = 0);
                               unused buckets are all-0xFF (-1 in the view)
    grid:   int32[B, S, L+1] — per bucket: S slots of (boundary key lanes,
                               gap version), sorted; slot 0 is the pivot
    count:  int32[B]         — used slots per bucket
    bmax:   int32[B]         — effective max gap version (includes floor)
    floor:  int32[B]         — every gap's effective version is
                               max(stored, floor)

The MVCC write history is the step function V(key) = version of the gap
containing key. Per batch: the history check (K1, ``history_conflicts``),
the intra-batch greedy commit (K2, ``intra_batch_commits``) and the merge
of committed writes with GC (K3, ``merge_writes``: a staging launch, then
the merge launch). A group of batches (``resolve_many``, the JAX
``lax.scan``) is ONE launch of the group scan on the card, which runs
those phases batch after batch with the state kept on the device; the
per-batch launches stay as its yardstick (``resolve_many_loop``) and as
the steps of a spread over several cards (``sharded.py``). Maintenance is
``reshard_device`` (K4a) and ``rebase`` (K4b). ``search_both`` (K5) is the
storage range index's binary search over a sorted code array. The
partitioned resolver (``sharded.py``) reuses the staging and merge steps
over the flat view of a stacked grid.

Every public device function dispatches on the device of its tensors: a
CUDA tensor launches the hand-written kernel (``conflict/kernels``) and
raises if it cannot; a CPU tensor runs the plain PyTorch version
(``*_plain``) beside it. The plain versions repeat the JAX package's
arithmetic step for step, so the CPU tests hold them to it exactly.

``merge_writes`` and ``resolve_many`` update the state's
grid/count/bmax/floor IN PLACE (JAX returned fresh arrays, donating the
state to its scan); callers that must keep a state intact (the backend's
pre-group snapshot) hand them a clone.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import SENTINEL, lanes_to_numpy, lanes_to_torch, ordered
from . import kernels
from .kernels import split_factors as _split_factors

COMMITTED, CONFLICT, TOO_OLD = 0, 1, 2

# offset keeping packed staged-event payloads nonnegative (|ev| ≤ 2·W·KW
# per batch, far below 2^20); see the per-bucket merge's packed payload
_EV_OFF = 1 << 20

_I32 = torch.int32


class GridState(NamedTuple):
    pivots: torch.Tensor  # int32[B, L]
    grid: torch.Tensor  # int32[B, S, L+1]; [..., :L] bounds, [..., L] version
    count: torch.Tensor  # int32[B]
    bmax: torch.Tensor  # int32[B]
    floor: torch.Tensor  # int32[B]


class Batch(NamedTuple):
    """One commit batch, padded per transaction to static shapes; inactive
    range slots have begin == end == SENTINEL."""

    rb: torch.Tensor  # int32[T, KR, L]
    re: torch.Tensor  # int32[T, KR, L]
    wb: torch.Tensor  # int32[T, KW, L]
    we: torch.Tensor  # int32[T, KW, L]
    t_snap: torch.Tensor  # int32[T]
    t_has_reads: torch.Tensor  # bool[T]


def clone_state(state: GridState) -> GridState:
    """A copy whose mutable arrays share no storage with ``state`` (pivots
    are never written in place, so they are shared)."""
    return GridState(
        state.pivots,
        state.grid.clone(),
        state.count.clone(),
        state.bmax.clone(),
        state.floor.clone(),
    )


# ---------------------------------------------------------------------------
# lex helpers over ORDERED lanes (``device.ordered``), trailing lane axis


def lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    lt = torch.zeros(shape, dtype=torch.bool, device=a.device)
    eq = torch.ones(shape, dtype=torch.bool, device=a.device)
    for i in range(a.shape[-1]):
        ai, bi = a[..., i], b[..., i]
        lt = lt | (eq & (ai < bi))
        eq = eq & (ai == bi)
    return lt


def lex_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ~lex_lt(b, a)


# ---------------------------------------------------------------------------
# K5: batched lexicographic binary search (the storage range index)


def search_both(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int32[2, Q]: ``searchsorted_lex`` of the query rows ``q`` [Q, L]
    over the lex-sorted ``codes`` [P, L], side "left" (row 0) and side
    "right" (row 1) — one kernel launch on the card for both."""
    if codes.is_cuda:
        return kernels.search(codes, q)
    return torch.stack([searchsorted_lex(codes, q, "left"), searchsorted_lex(codes, q, "right")])


def searchsorted_lex(sorted_arr: torch.Tensor, q: torch.Tensor, side: str) -> torch.Tensor:
    """Plain version (JAX grid.py:125): the fixed-step binary search.

    side='right': first index with sorted_arr[i] >  q  (#elements <= q)
    side='left' : first index with sorted_arr[i] >= q  (#elements <  q)

    Like the reference it runs ceil(log2 P) + 1 steps and probes row
    min(mid, P - 1), so for every P >= 2 a count of P ends at P + 1 (P = 1
    gives 1) and no other count differs: the result is
    count + (count == P and P >= 2). Callers clamp."""
    P = sorted_arr.shape[0]
    arr, qo = ordered(sorted_arr), ordered(q)
    lo = torch.zeros(q.shape[:-1], dtype=_I32, device=q.device)
    hi = torch.full(q.shape[:-1], P, dtype=_I32, device=q.device)
    for _ in range(kernels.search_steps(P)):
        mid = (lo + hi) >> 1
        row = arr[mid.clamp(max=P - 1).long()]
        go_right = lex_le(row, qo) if side == "right" else lex_lt(row, qo)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=-1, dtype=_I32)


def _rank(points: torch.Tensor, pivots: torch.Tensor, strict: bool) -> torch.Tensor:
    """#(pivots <= point) - 1 (``strict``: #(pivots < point) - 1) per point,
    over ordered lanes; two-level like the JAX ``_rank_le``/``_rank_lt``:
    rank against every B2-th pivot, then within the landing block. Points
    [N, L] over pivots [B, L], or [P, N, L] over [P, B, L] (each partition
    against its own pivots)."""
    cmp = lex_lt if strict else lex_le
    B, L = pivots.shape[-2:]
    B1, B2 = _split_factors(B)
    if B2 == 1:
        return _count(cmp(pivots.unsqueeze(-3), points.unsqueeze(-2))) - 1
    pb = pivots.reshape(*pivots.shape[:-2], B1, B2, L)
    s1 = _count(cmp(pb[..., 0, :].unsqueeze(-3), points.unsqueeze(-2))) - 1
    idx = s1.clamp(min=0).long()
    if pivots.dim() == 3:
        blk = pb[torch.arange(pb.shape[0], device=pb.device)[:, None], idx]
    else:
        blk = pb[idx]
    s2 = _count(cmp(blk, points.unsqueeze(-2))) - 1
    return s1 * B2 + s2


def _ffill(val: torch.Tensor, have: torch.Tensor) -> torch.Tensor:
    """Forward fill along the last axis: val where have, else the last
    earlier val where have, else 0 (the JAX ``_log_shift_fill`` on inputs
    that are 0 where not ``have``)."""
    n = val.shape[-1]
    pos = torch.arange(n, device=val.device).expand_as(val)
    idx = torch.where(have, pos, torch.full_like(pos, -1)).cummax(dim=-1).values
    out = val.gather(-1, idx.clamp(min=0))
    return torch.where(idx >= 0, out, torch.zeros_like(out))


def _lex_order(keys: list[torch.Tensor]) -> torch.Tensor:
    """Permutation along the last axis sorting by ``keys`` (equal shapes,
    most significant first): stable single-key passes from the least
    significant key up — ``torch.sort`` takes one key where ``lax.sort``
    took several."""
    k0 = keys[0]
    order = torch.arange(k0.shape[-1], device=k0.device).expand_as(k0)
    for key in reversed(keys):
        idx = torch.sort(key.gather(-1, order), dim=-1, stable=True).indices
        order = order.gather(-1, idx)
    return order


def staging_slots(n_slots: int) -> int:
    """Staging-plane width per touched bucket (distinct new boundaries a
    single batch may land in one bucket before the host must repivot)."""
    return max(4, n_slots // 2)


# ---------------------------------------------------------------------------
# K1: history check


def history_conflicts(state: GridState, batch: Batch) -> torch.Tensor:
    """bool[T]: some read range overlaps a gap with version > txn snapshot."""
    if batch.rb.is_cuda:
        return kernels.history(
            state.pivots, state.grid, state.count, state.bmax, state.floor,
            batch.rb, batch.re, batch.t_snap,
        )
    return history_conflicts_plain(state, batch)


def history_conflicts_plain(state: GridState, batch: Batch) -> torch.Tensor:
    T, KR, L = batch.rb.shape
    B, S, _ = state.grid.shape
    dev = batch.rb.device
    a = ordered(batch.rb.reshape(T * KR, L))
    e = ordered(batch.re.reshape(T * KR, L))
    active = lex_lt(a, e)
    snap = torch.repeat_interleave(batch.t_snap, KR)
    piv = ordered(state.pivots)

    # bucket containing a / bucket containing e⁻
    ba = _rank(a, piv, strict=False)
    be = _rank(e, piv, strict=True)

    Q = a.shape[0]
    idx = torch.cat([ba.clamp(min=0), be.clamp(min=0)]).long()
    win = state.grid[idx]  # [2Q, S, L+1]
    cnt = state.count[idx]
    slots = torch.arange(S, device=dev)
    used = slots[None, :] < cnt[:, None]
    win_a, win_e = win[:Q], win[Q:]
    used_a, used_e = used[:Q], used[Q:]
    bnd_a = ordered(win_a[..., :L])
    ver_a = win_a[..., L]
    zero = torch.zeros((), dtype=_I32, device=dev)

    # value at a: version of the last used slot <= a
    le_a = lex_le(bnd_a, a[:, None, :]) & used_a
    rank_a = _count(le_a) - 1
    onehot = slots[None, :] == rank_a[:, None]
    v_at_a = torch.where(onehot, ver_a, zero).amax(dim=1)

    # gaps starting strictly inside (a, e) within a's bucket
    inside_a = used_a & lex_lt(a[:, None, :], bnd_a) & lex_lt(bnd_a, e[:, None, :])
    v_in_a = torch.where(inside_a, ver_a, zero).amax(dim=1)

    # e's bucket (when different): gaps starting before e
    diff = be > ba
    bnd_e = ordered(win_e[..., :L])
    ver_e = win_e[..., L]
    in_e = used_e & lex_lt(bnd_e, e[:, None, :])
    v_in_e = torch.where(diff, torch.where(in_e, ver_e, zero).amax(dim=1), zero)

    # buckets strictly between ba and be: whole superblocks through the
    # superblock max, partial edge superblocks element by element
    B1, B2 = _split_factors(B)
    bmax_blk = state.bmax.reshape(B1, B2)
    bmax_sup = bmax_blk.amax(dim=1)
    s1a, s2a = torch.div(ba, B2, rounding_mode="floor"), torch.remainder(ba, B2)
    s1e, s2e = torch.div(be, B2, rounding_mode="floor"), torch.remainder(be, B2)
    ar1 = torch.arange(B1, dtype=_I32, device=dev)[None, :]
    full_sup = (ar1 > s1a[:, None]) & (ar1 < s1e[:, None])
    v_sup = torch.where(full_sup, bmax_sup[None, :], zero).amax(dim=1)
    ar2 = torch.arange(B2, dtype=_I32, device=dev)[None, :]
    blk = bmax_blk[torch.cat([s1a.clamp(min=0), s1e.clamp(min=0)]).long()]
    blk_a, blk_e = blk[:Q], blk[Q:]
    hi2 = torch.where(s1e == s1a, s2e, torch.full_like(s2e, B2))
    in_a = (ar2 > s2a[:, None]) & (ar2 < hi2[:, None])
    v_edge_a = torch.where(in_a, blk_a, zero).amax(dim=1)
    in_e2 = (s1e > s1a)[:, None] & (ar2 < s2e[:, None])
    v_edge_e = torch.where(in_e2, blk_e, zero).amax(dim=1)
    v_btw = torch.maximum(v_sup, torch.maximum(v_edge_a, v_edge_e))

    # bucket floors: a's gap always overlaps; e⁻'s bucket when later
    fl = state.floor[idx]
    fl_a = fl[:Q]
    fl_e = torch.where(diff, fl[Q:], zero)

    vmax = torch.maximum(torch.maximum(v_at_a, v_in_a), torch.maximum(v_in_e, v_btw))
    vmax = torch.maximum(vmax, torch.maximum(fl_a, fl_e))
    hit = active & (vmax > snap)
    return hit.reshape(T, KR).any(dim=1)


# ---------------------------------------------------------------------------
# K2: intra-batch greedy commit


def _endpoint_ranks(batch: Batch):
    """Dense int32 ranks over ALL of the batch's endpoint codes: equal codes
    share a rank and order is preserved, so every later lex compare on L
    lanes becomes ONE int32 compare. Returns (rb_r, re_r, wb_r, we_r) with
    the original [T, K] shapes. Torch glue on both paths (the JAX
    ``lax.sort`` was XLA glue too)."""
    T, KR, L = batch.rb.shape
    KW = batch.wb.shape[1]
    pts = torch.cat(
        [
            batch.rb.reshape(T * KR, L),
            batch.re.reshape(T * KR, L),
            batch.wb.reshape(T * KW, L),
            batch.we.reshape(T * KW, L),
        ]
    )
    P = pts.shape[0]
    po = ordered(pts)
    order = _lex_order([po[:, i] for i in range(L)])
    scode = pts[order]
    new = torch.ones(P, dtype=torch.bool, device=pts.device)
    new[1:] = (scode[1:] != scode[:-1]).any(dim=1)
    dense = torch.cumsum(new, dim=0, dtype=_I32) - 1
    ranks = torch.empty(P, dtype=_I32, device=pts.device)
    ranks[order] = dense
    a = T * KR
    b = 2 * T * KR
    c = b + T * KW
    return (
        ranks[:a].reshape(T, KR),
        ranks[a:b].reshape(T, KR),
        ranks[b:c].reshape(T, KW),
        ranks[c:].reshape(T, KW),
    )


def intra_batch_commits(batch: Batch, H: torch.Tensor) -> torch.Tensor:
    """bool[T]: the in-order greedy commit — txn j commits iff not H[j] and
    no read of j overlaps a write of an earlier COMMITTED txn i < j. On the
    card one launch from the key codes; the plain version takes dense
    endpoint ranks."""
    if H.is_cuda:
        return kernels.intra_batch(batch.rb, batch.re, batch.wb, batch.we, H)
    return intra_batch_commits_plain(*_endpoint_ranks(batch), H)


def intra_batch_commits_plain(rb_r, re_r, wb_r, we_r, H):
    """The JAX form: dense [T, T] overlap matrix, then the fixpoint of
    commit = ~H & ~(Pf · commit > 0). Pf is strictly lower triangular, so
    the fixpoint is unique and equals the sequential greedy pass."""
    T, KR = rb_r.shape
    Pji = torch.zeros((T, T), dtype=torch.bool, device=H.device)
    for ar in range(KR):
        rb = rb_r[:, ar, None, None]  # reads of j
        re = re_r[:, ar, None, None]
        # read j overlaps write i: rb_j < we_i and wb_i < re_j
        o = (rb < we_r[None]) & (wb_r[None] < re)  # [T, T, KW]
        Pji = Pji | o.any(dim=2)
    Pf = torch.tril(Pji, diagonal=-1).float()
    commit = ~H
    while True:
        # 0/1 entries and sums ≤ T: exact in float32
        blocked = (Pf @ commit.float()) > 0
        new = ~H & ~blocked
        if torch.equal(new, commit):
            return commit
        commit = new


# ---------------------------------------------------------------------------
# K3: merge committed writes + GC + coalesce


class Staged(NamedTuple):
    """The batch's committed write endpoints, staged per touched bucket."""

    st_code: torch.Tensor  # int32[U, S2, L]; SENTINEL = empty staging slot
    st_ev: torch.Tensor  # int32[U, S2]; aggregated +1/-1 events per code
    tid: torch.Tensor  # int32[U]; touched bucket ids, ascending, B = unused slot
    # int32[U]; Σ ev in the buckets before each touched bucket, within its
    # partition (0 at unused slots). Between two touched buckets the carry
    # is constant, so an untouched bucket's follows from the sorted ``tid``
    carry: torch.Tensor
    max_staged: torch.Tensor  # int32[P]; most staged rows in a bucket


def _write_events(wb: torch.Tensor, we: torch.Tensor, commit: torch.Tensor):
    """(codes [..., 2W, L], events [..., 2W], ok [..., 2W]) of the committed
    write ranges' endpoints, begins (+1) then ends (-1); an inactive range's
    rows are SENTINEL with event 0. ``wb``/``we`` are [..., T, KW, L]."""
    *lead, T, KW, L = wb.shape
    W = T * KW
    ok = (lex_lt(ordered(wb), ordered(we)) & commit[:, None]).reshape(*lead, W)
    okok = torch.cat([ok, ok], dim=-1)
    cd = torch.cat([wb.reshape(*lead, W, L), we.reshape(*lead, W, L)], dim=-2)
    codes = torch.where(okok[..., None], cd, torch.full_like(cd, SENTINEL))
    evs = torch.cat([ok.to(_I32), -ok.to(_I32)], dim=-1)
    return codes, evs, okok


def stage_writes(state: GridState, batch: Batch, commit: torch.Tensor) -> Staged:
    """Stage the committed writes of one grid (JAX grid.py:430-524): one
    kernel launch on the card, ``_stage_writes`` on the CPU."""
    if state.grid.is_cuda:
        S2 = staging_slots(state.grid.shape[1])
        return Staged(*kernels.stage(batch.wb[None], batch.we[None], commit, state.pivots[None], S2))
    return _stage_writes(state, batch, commit)


def _stage_writes(state: GridState, batch: Batch, commit: torch.Tensor) -> Staged:
    """Plain version for one grid: rank the write endpoints against the
    pivots, then ``_stage`` them."""
    B, S, _ = state.grid.shape
    codes, evs, okok = _write_events(batch.wb, batch.we, commit)
    bkt = _rank(ordered(codes), ordered(state.pivots), strict=False)
    bkt = torch.where(okok, bkt, torch.full_like(bkt, B))
    return _stage(codes, evs, bkt, B, 1, S, min(codes.shape[0], B))


def _stage(codes, evs, bkt, B: int, n_parts: int, S: int, U: int) -> Staged:
    """Sort the endpoint rows by (bucket, code), aggregate equal-code runs
    into one event each, scatter the run-last rows into [U, S2] staging
    planes, and carry per-bucket event sums across each partition's
    buckets. ``bkt`` holds bucket ids over all ``B`` buckets of the
    ``n_parts`` partitions (B = invalid row). Scatters keep the JAX
    ``mode="drop"`` meaning through a spare last row that is sliced off."""
    L = codes.shape[-1]
    dev = codes.device
    S2 = staging_slots(S)

    # bucket leads the keys: a valid endpoint at the all-0xFF code (a clear
    # to the end of the keyspace) must not interleave with padding rows
    co = ordered(codes)
    order = _lex_order([bkt] + [co[:, i] for i in range(L)])
    sb = bkt[order]
    scode = codes[order]
    sev = evs[order]

    valid = sb < B
    one = torch.ones(1, dtype=torch.bool, device=dev)
    bkt_change = sb[1:] != sb[:-1]
    code_new = torch.cat([one, (scode[1:] != scode[:-1]).any(dim=1) | bkt_change])
    code_last = torch.cat([code_new[1:], one])
    bkt_new = torch.cat([one, bkt_change])
    bkt_last = torch.cat([bkt_new[1:], one])

    zero = torch.zeros((), dtype=_I32, device=dev)
    pe = torch.cumsum(sev, 0, dtype=_I32)
    pe_prev = torch.cat([zero[None], pe[:-1]])
    agg_ev = pe - _ffill(torch.where(code_new, pe_prev, zero), code_new)
    bkt_ev = pe - _ffill(torch.where(bkt_new, pe_prev, zero), bkt_new)

    # touched-bucket ordinal u and distinct-code slot within the bucket
    ucum = torch.cumsum(bkt_new & valid, 0, dtype=_I32) - 1
    ccum = torch.cumsum(code_new & valid, 0, dtype=_I32)
    ccum_at_bkt = _ffill(torch.where(bkt_new, ccum - 1, zero), bkt_new)
    slot = ccum - 1 - ccum_at_bkt

    run_end = code_last & valid
    max_staged = _max_per_part(torch.where(run_end, slot + 1, zero), sb, B, n_parts)

    flat = torch.where(
        run_end & (slot < S2), ucum * S2 + slot, torch.full_like(slot, U * S2)
    ).long()
    st_code = torch.full((U * S2 + 1, L), SENTINEL, dtype=_I32, device=dev)
    st_code[flat] = scode
    st_ev = torch.zeros(U * S2 + 1, dtype=_I32, device=dev)
    st_ev[flat] = agg_ev

    first = bkt_new & valid
    tid = torch.full((U + 1,), B, dtype=_I32, device=dev)
    tid[torch.where(first, ucum, torch.full_like(ucum, U)).long()] = sb

    last = bkt_last & valid
    evsum = torch.zeros(B + 1, dtype=_I32, device=dev)
    evsum.index_add_(
        0,
        torch.where(last, sb, torch.full_like(sb, B)).long(),
        torch.where(last, bkt_ev, zero),
    )
    ev = evsum[:B].reshape(n_parts, B // n_parts)
    carry = (torch.cumsum(ev, 1, dtype=_I32) - ev).reshape(B)
    tid = tid[:U]
    carry_in = torch.where(tid < B, carry[tid.clamp(max=B - 1).long()], zero)
    return Staged(
        st_code[: U * S2].reshape(U, S2, L),
        st_ev[: U * S2].reshape(U, S2),
        tid,
        carry_in,
        max_staged,
    )


def _max_per_part(val, bkt, B: int, n_parts: int) -> torch.Tensor:
    """int32[n_parts]: max of the nonnegative ``val`` over the rows whose
    bucket id (over all ``B`` buckets; B = none) lies in each partition,
    0 where a partition has none."""
    part = torch.where(
        bkt < B, torch.div(bkt, B // n_parts, rounding_mode="floor"), n_parts
    ).long()
    out = torch.zeros(n_parts + 1, dtype=_I32, device=val.device)
    return out.scatter_reduce_(0, part, val.to(_I32), "amax")[:n_parts]


def merge_writes(
    state: GridState,
    batch: Batch,
    commit: torch.Tensor,
    now: int,
    oldest: int,
) -> tuple[GridState, torch.Tensor]:
    """Raise V(k) to max(V(k), now) over committed write ranges; GC below
    ``oldest``; coalesce equal steps. Updates ``state`` IN PLACE and
    returns it with ``pressure`` = int32[2]: [max staged rows in any bucket
    (overflow if > staging_slots(S)), max kept rows in any bucket (overflow
    if > S)]."""
    st = stage_writes(state, batch, commit)
    max_kept = merge_staged(state, st, now, oldest)
    return state, torch.stack([st.max_staged, max_kept], dim=-1).reshape(2)


def merge_staged(state: GridState, st: Staged, now: int, oldest: int, n_parts: int | None = None):
    """Merge staged rows into ``state`` IN PLACE — the per-bucket merge and
    the floor raise of buckets a committed write spans: one kernel launch
    on the card (K3, or with ``n_parts`` K6 over the flat [P·B] view of
    ``n_parts`` stacked partitions, one partition included),
    ``merge_staged_plain`` on the CPU. Returns int32[n_parts or 1]: the
    most rows any bucket of each partition kept."""
    if state.grid.is_cuda:
        args = (state.grid, state.count, state.bmax, state.floor,
                st.st_code, st.st_ev, st.tid, st.carry, now, oldest)
        if n_parts is None:
            return kernels.merge(*args)
        return kernels.merge_parts(*args, n_parts)
    return merge_staged_plain(state, st, now, oldest, n_parts or 1)


def merge_staged_plain(state: GridState, st: Staged, now: int, oldest: int, n_parts: int = 1):
    """Plain version of the merge kernel: the per-bucket merge, then the
    floor raise of the buckets a committed write spans."""
    max_kept = _merge_buckets_plain(state, st, now, oldest, n_parts)
    _raise_spanned_plain(state, st, now, n_parts)
    return max_kept


def spanned_buckets(st: Staged, B: int, n_parts: int = 1) -> torch.Tensor:
    """bool[B]: the untouched buckets that a committed write spans — those
    whose carry, the carry of the next touched bucket of their partition,
    is positive. Each partition's events sum to 0, so buckets after its
    last touched bucket are never spanned."""
    U = st.tid.shape[0]
    x = torch.arange(B, dtype=_I32, device=st.tid.device)
    nxt = torch.searchsorted(st.tid, x)  # first touched slot with tid >= x
    nc = nxt.clamp(max=U - 1)
    tb = st.tid[nc]
    part = B // n_parts
    same = (nxt < U) & (tb < B) & (tb != x) & (tb // part == x // part)
    return same & (st.carry[nc] > 0)


def _raise_spanned_plain(state: GridState, st: Staged, now: int, n_parts: int = 1) -> None:
    """Buckets a committed write spans without an endpoint inside: every
    gap's effective version becomes max(base, now) = now — a floor raise
    (JAX grid.py:635-642)."""
    covered = spanned_buckets(st, state.grid.shape[0], n_parts)
    state.floor.copy_(torch.where(covered, state.floor.clamp(min=now), state.floor))
    state.bmax.copy_(torch.where(covered, state.bmax.clamp(min=now), state.bmax))


def _merge_buckets_plain(
    state: GridState, st: Staged, now: int, oldest: int, n_parts: int = 1
) -> torch.Tensor:
    """Plain version of the per-bucket merge kernel (JAX grid.py:526-633):
    for each touched bucket, sort its S old rows and S2 staged rows by
    code, forward-fill gap bases, apply the coverage prefix, raise to
    ``now``, GC below ``oldest``, keep the last row of each equal-code run
    unless its value equals the previous run's, and compact stably to S
    rows. Writes the buckets back in place; returns int32[n_parts], the
    most rows a bucket of each partition kept."""
    B, S, Lp1 = state.grid.shape
    L = Lp1 - 1
    U, S2 = st.st_ev.shape
    dev = st.tid.device
    M = S + S2
    live = st.tid < B
    tid_c = st.tid.clamp(max=B - 1).long()
    zero = torch.zeros((), dtype=_I32, device=dev)

    old = state.grid[tid_c]  # [U, S, L+1]
    old_used = (torch.arange(S, device=dev)[None, :] < state.count[tid_c][:, None]) & live[:, None]
    old_code = torch.where(old_used[..., None], old[..., :L], torch.full_like(old[..., :L], SENTINEL))
    old_ver = torch.where(
        old_used, torch.maximum(old[..., L], state.floor[tid_c][:, None]), zero
    )
    # one int32 payload per row: bit 0 tags an old grid row (ver << 1 | 1)
    # or a staged event row ((ev + _EV_OFF) << 1); versions stay < 2^30
    # because the host rebases at 1 << 30
    packed_old = torch.where(old_used, (old_ver << 1) | 1, torch.full_like(old_ver, _EV_OFF << 1))
    packed_st = (st.st_ev + _EV_OFF) << 1
    m_code = torch.cat([old_code, st.st_code], dim=1)  # [U, M, L]
    m_pk = torch.cat([packed_old, packed_st], dim=1)

    # sort by code only: within an equal-code run only the run-last row is
    # kept and it sees the whole run, so tie order does not matter
    mo = ordered(m_code)
    order = _lex_order([mo[..., i] for i in range(L)])
    g_code = m_code.gather(1, order[..., None].expand(U, M, L))
    g_pk = m_pk.gather(1, order)
    g_old = (g_pk & 1) == 1
    g_ver = torch.where(g_old, g_pk >> 1, zero)
    g_ev = torch.where(g_old, zero, (g_pk >> 1) - _EV_OFF)

    base = _ffill(g_ver, g_old)
    cov = st.carry[:, None] + torch.cumsum(g_ev, dim=1, dtype=_I32)
    nv = torch.where(cov > 0, base.clamp(min=now), base)
    nv = torch.where(nv < oldest, zero, nv)

    is_sent = (g_code == SENTINEL).all(dim=-1)
    differs = (g_code[:, 1:] != g_code[:, :-1]).any(dim=-1)
    ones = torch.ones((U, 1), dtype=torch.bool, device=dev)
    keep = ~is_sent & torch.cat([differs, ones], dim=1)
    # coalesce: drop a run whose value equals the previous run's; the
    # first run of each bucket (its pivot) sees -1 and is always kept
    shifted = torch.cat([torch.full((U, 1), -1, dtype=_I32, device=dev), nv[:, :-1]], dim=1)
    first_of_run = torch.cat([ones, differs], dim=1)
    pval = _ffill(torch.where(first_of_run, shifted, zero), first_of_run)
    keep = keep & (nv != pval)

    kept_cnt = _count(keep)
    max_kept = _max_per_part(kept_cnt, st.tid, B, n_parts)

    # compact: stable sort by !keep, take the first S rows
    corder = torch.sort((~keep).to(_I32), dim=1, stable=True).indices[:, :S]
    out_code = g_code.gather(1, corder[..., None].expand(U, S, L))
    out_ver = nv.gather(1, corder)
    new_count = kept_cnt.clamp(max=S)
    used = torch.arange(S, device=dev)[None, :] < new_count[:, None]
    out_code = torch.where(used[..., None], out_code, torch.full_like(out_code, SENTINEL))
    out_ver = torch.where(used, out_ver, zero)
    out_rows = torch.cat([out_code, out_ver[..., None]], dim=-1)

    # write back the live buckets; their floor is folded into the rows
    t = st.tid[live].long()
    state.grid[t] = out_rows[live]
    state.count[t] = new_count[live]
    state.bmax[t] = out_ver.amax(dim=1)[live]
    state.floor[t] = 0
    return max_kept


# ---------------------------------------------------------------------------
# Full resolver step


def version_rows(nows, oldests_pre, oldests_post, device) -> torch.Tensor:
    """The group's versions as the scan reads them: int32 [3, G] (each
    batch's now, oldest version before it, oldest after it) on ``device``,
    one pinned copy to a card."""
    rows = torch.from_numpy(np.asarray([nows, oldests_pre, oldests_post], dtype=np.int32))
    device = torch.device(device)
    return rows.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else rows


def resolve_one(state, batch: Batch, now: int, oldest_pre: int, oldest_post: int):
    """One batch end-to-end (the JAX ``_resolve_one``): ``resolve_many`` on
    a group of one, so one launch of the scan on the card. Returns (state,
    verdicts int8[T], pressure int32[2])."""
    group = Batch(*(x[None] for x in batch))
    state, verdicts, pressure = resolve_many(state, group, [now], [oldest_pre], [oldest_post])
    return state, verdicts[0], pressure


def resolve_many(state, batches: Batch, nows, oldests_pre, oldests_post):
    """G batches in order with the state kept on the device (the JAX
    ``lax.scan``). ``batches`` carries a leading group axis G on every
    field; the version lists are host ints. On the card the whole group is
    ONE launch of the group scan (``kernels.resolve_many``, the versions
    one pinned copy, ``version_rows``), with no torch op between its
    batches; on the CPU ``resolve_many_plain``. Updates ``state`` in place.
    Returns (state, verdicts int8[G, T], pressure int32[2] = max over the
    group)."""
    if state.grid.is_cuda:
        vers = version_rows(nows, oldests_pre, oldests_post, state.grid.device)
        verdicts, _pressures, gmax = kernels.resolve_many(
            *state, None, *batches, vers, staging_slots(state.grid.shape[1])
        )
        return state, verdicts, gmax.reshape(2)
    verdicts, pressures = resolve_many_plain(state, batches, nows, oldests_pre, oldests_post)
    return state, verdicts, pressures.amax(dim=0).reshape(2)


def resolve_many_plain(state, batches: Batch, nows, oldests_pre, oldests_post, bounds=None):
    """Plain version of the group scan: the loop of the plain versions,
    batch by batch — on one grid, or with ``bounds`` (plo, phi) [P, L] over
    the P partitions stacked in ``state`` (history of each read clipped to
    each partition, K2 on the unclipped batch, the writes clipped and
    staged over the flat [P·B] view). Updates ``state`` IN PLACE; returns
    (verdicts int8[G, T], pressures int32[G, P, 2])."""
    return _resolve_loop(state, batches, (nows, oldests_pre, oldests_post), bounds, plain=True)


def resolve_many_loop(state, batches: Batch, nows, oldests_pre, oldests_post, bounds=None):
    """``resolve_many_plain``'s loop through the per-batch dispatchers: on
    the card the standalone kernels, eight launches a batch (K1 or K6
    history, K2, K3 or K6 staging and merge) with the torch glue between
    them — the path before the group scan, kept as its yardstick
    (``chip_smoke.py`` phase 5, the card tests). Same returns."""
    return _resolve_loop(state, batches, (nows, oldests_pre, oldests_post), bounds, plain=False)


def _resolve_loop(state, batches: Batch, versions, bounds, plain: bool):
    from . import sharded as SH  # sharded builds on this module

    verdicts, pressures = [], []
    for g in range(batches.rb.shape[0]):
        batch = Batch(*(x[g] for x in batches))
        now, old_pre, old_post = (int(v[g]) for v in versions)
        too_old = batch.t_has_reads & (batch.t_snap < old_pre)
        if bounds is None:
            hist = history_conflicts_plain if plain else history_conflicts
            H = hist(state, batch) | too_old
        else:
            hist = SH.history_conflicts_sharded_plain if plain else SH.history_conflicts_sharded
            H = hist(state, batch, *bounds) | too_old
        if plain:
            commit = intra_batch_commits_plain(*_endpoint_ranks(batch), H)
        else:
            commit = intra_batch_commits(batch, H)
        if bounds is None:
            st = _stage_writes(state, batch, commit) if plain else stage_writes(state, batch, commit)
            flat, n_parts = state, None
        else:
            plo, phi = bounds
            if plain:
                wb, we = SH.clip(batch.wb, batch.we, plo[:, None, None, :], phi[:, None, None, :])
                st = SH._stage_clipped_plain(state, wb, we, commit)
            else:
                st = SH.stage_writes_sharded(state, batch, commit, plo, phi)
            flat, n_parts = SH.flat_view(state), plo.shape[0]
        if plain:
            max_kept = merge_staged_plain(flat, st, now, old_post, n_parts or 1)
        else:
            max_kept = merge_staged(flat, st, now, old_post, n_parts)
        # COMMITTED = 0, CONFLICT = 1, TOO_OLD = 2
        verdicts.append((~commit).to(torch.int8).masked_fill(too_old, TOO_OLD))
        pressures.append(torch.stack([st.max_staged, max_kept], dim=-1))
    return torch.stack(verdicts), torch.stack(pressures)


# ---------------------------------------------------------------------------
# K4b: rebase


def rebase(state: GridState, delta: int) -> GridState:
    """Shift the version origin by ``delta`` (host advances its base)."""
    if state.grid.is_cuda:
        grid, bmax, floor = kernels.maint_rebase(
            state.grid, state.count, state.floor, delta
        )
        return GridState(state.pivots, grid, state.count, bmax, floor)
    return rebase_plain(state, delta)


def rebase_plain(state: GridState, delta: int) -> GridState:
    S = state.grid.shape[1]
    ver = state.grid[..., -1]
    used = torch.arange(S, device=ver.device)[None, :] < state.count[:, None]
    ver = torch.where(used, (ver - delta).clamp(min=0), torch.zeros_like(ver))
    grid = torch.cat([state.grid[..., :-1], ver[..., None]], dim=-1)
    floor = (state.floor - delta).clamp(min=0)
    bmax = torch.maximum(ver.amax(dim=1), floor)
    return GridState(state.pivots, grid, state.count, bmax, floor)


# ---------------------------------------------------------------------------
# K4a: on-device reshard


def reshard_device(
    state: GridState, n_buckets: int, n_slots: int
) -> tuple[GridState, torch.Tensor]:
    """Rebalance the grid on the device: fold the floors into the rows,
    compact the live rows in global key order, cut them into blocks of
    q = ceil(live / n_buckets) rows, take each bucket's pivot from its
    first row. Returns (new_state, pressure): pressure = max rows any new
    bucket needs; if > n_slots rows were dropped and the caller retries
    with more buckets."""
    if state.grid.is_cuda:
        out = kernels.maint_reshard(state.grid, state.count, state.floor, n_buckets, n_slots)
        return GridState(*out[:5]), out[5]
    B, S, Lp1 = state.grid.shape
    used = (torch.arange(S, device=state.grid.device)[None, :] < state.count[:, None]).reshape(B * S)
    return reshard_device_plain(state, used, n_buckets, n_slots)


def reshard_device_plain(state, used, n_buckets: int, n_slots: int):
    B, S, Lp1 = state.grid.shape
    L = Lp1 - 1
    N = B * S
    dev = state.grid.device
    code = torch.where(
        used[:, None], state.grid[..., :L].reshape(N, L), torch.full((N, L), SENTINEL, dtype=_I32, device=dev)
    )
    ver_f = torch.maximum(state.grid[..., L], state.floor[:, None]).reshape(N)
    ver = torch.where(used, ver_f, torch.zeros_like(ver_f))

    n_live = used.sum(dtype=_I32)
    dest = torch.where(used, torch.cumsum(used, 0, dtype=_I32) - 1, torch.full((N,), N, dtype=_I32, device=dev)).long()
    lcode = torch.full((N + 1, L), SENTINEL, dtype=_I32, device=dev)
    lcode[dest] = code
    lver = torch.zeros(N + 1, dtype=_I32, device=dev)
    lver[dest] = ver
    lcode, lver = lcode[:N], lver[:N]
    pos = torch.arange(N, dtype=_I32, device=dev)
    lused = pos < n_live

    q = torch.clamp(torch.div(n_live + n_buckets - 1, n_buckets, rounding_mode="floor"), min=1)
    nb = torch.where(lused, torch.div(pos, q, rounding_mode="floor"), torch.full_like(pos, n_buckets))
    slot = pos - torch.div(pos, q, rounding_mode="floor") * q
    pressure = torch.where(lused, slot + 1, torch.zeros_like(slot)).amax()

    pidx = torch.clamp(torch.arange(n_buckets, dtype=_I32, device=dev) * q, max=N)
    lpad = torch.cat([lcode, torch.full((1, L), SENTINEL, dtype=_I32, device=dev)])
    new_pivots = torch.where(
        (pidx < n_live)[:, None], lpad[pidx.long()], torch.full((n_buckets, L), SENTINEL, dtype=_I32, device=dev)
    )

    flat = torch.where(
        lused & (slot < n_slots), nb * n_slots + slot, torch.full_like(slot, n_buckets * n_slots)
    ).long()
    rows = torch.cat([lcode, lver[:, None]], dim=1)
    g = torch.full((n_buckets * n_slots + 1, Lp1), SENTINEL, dtype=_I32, device=dev)
    g[flat] = rows
    new_grid = g[: n_buckets * n_slots].reshape(n_buckets, n_slots, Lp1)
    is_row = (new_grid[..., :L] != SENTINEL).any(dim=-1)
    new_count = _count(is_row)
    out_ver = torch.where(is_row, new_grid[..., L], torch.zeros_like(new_grid[..., L]))
    new_grid = torch.cat([new_grid[..., :L], out_ver[..., None]], dim=-1)
    new_state = GridState(
        new_pivots,
        new_grid,
        new_count,
        out_ver.amax(dim=1),
        torch.zeros(n_buckets, dtype=_I32, device=dev),  # floors folded into rows
    )
    return new_state, pressure.to(_I32)


# ---------------------------------------------------------------------------
# Construction / conversion / resharding (rare)


def state_from_numpy(pivots, grid, count, bmax, floor, device) -> GridState:
    """GridState on ``device`` from numpy arrays (uint32 lanes, int32
    per-bucket arrays) — e.g. a JAX ``GridState`` passed through
    ``np.asarray``, which is how a state is carried across. The tensors
    own copies of the data (the state is later updated in place)."""
    lanes = [np.array(a, dtype=np.uint32) for a in (pivots, grid)]
    words = [np.array(a, dtype=np.int32) for a in (count, bmax, floor)]
    return GridState(
        *(lanes_to_torch(a, device) for a in lanes),
        *(torch.from_numpy(a).to(device) for a in words),
    )


def state_to_numpy(state: GridState) -> tuple:
    """(pivots uint32, grid uint32, count, bmax, floor int32) numpy arrays,
    in the JAX package's dtypes."""
    return (
        lanes_to_numpy(state.pivots),
        lanes_to_numpy(state.grid),
        state.count.cpu().numpy(),
        state.bmax.cpu().numpy(),
        state.floor.cpu().numpy(),
    )


def make_state(n_buckets: int, n_slots: int, lanes: int, device) -> GridState:
    """Fresh index: one live bucket [0, ∞) with version 0 everywhere."""
    pivots = np.full((n_buckets, lanes), 0xFFFFFFFF, dtype=np.uint32)
    pivots[0] = 0
    grid = np.full((n_buckets, n_slots, lanes + 1), 0xFFFFFFFF, dtype=np.uint32)
    grid[..., lanes] = 0
    grid[0, 0, :lanes] = 0
    count = np.zeros((n_buckets,), np.int32)
    count[0] = 1
    zeros = np.zeros((n_buckets,), np.int32)
    return state_from_numpy(pivots, grid, count, zeros, zeros, device)


def occupancy_stats(state: GridState) -> dict:
    """Bucket-occupancy / headroom gauges for the kernel's
    CounterCollection. Reads only the small per-bucket count array."""
    count = state.count.cpu().numpy()
    B, S, _ = state.grid.shape
    live = int(count.sum())
    worst = int(count.max(initial=0))
    return {
        "liveRows": live,
        "usedBuckets": int((count > 0).sum()),
        "bucketCount": int(B),
        "slotCapacity": int(S),
        "maxBucketRows": worst,
        "slotHeadroom": int(S - worst),
        "fillFraction": round(live / float(B * S), 6),
    }


def codes_to_bytes(codes: np.ndarray) -> np.ndarray:
    """uint32[N, L] lane codes → void-dtype byte keys whose memcmp order
    equals lane order (big-endian), for vectorized searchsorted."""
    n, L = codes.shape
    be = np.ascontiguousarray(codes.astype(">u4"))
    return be.view(np.dtype((np.void, 4 * L))).reshape(n)


def live_codes(state: GridState) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes int32[N, L], versions int64[N]) of all live boundaries, in
    global key order, on the state's device. Bucket floors are folded into
    the versions."""
    S_old, L = state.grid.shape[1], state.grid.shape[2] - 1
    used = torch.arange(S_old, device=state.grid.device)[None, :] < state.count[:, None]
    codes = state.grid[..., :L][used]
    vers = torch.maximum(state.grid[..., L], state.floor[:, None])[used].long()
    return codes, vers


def live_rows(state: GridState) -> tuple[np.ndarray, np.ndarray]:
    """``live_codes`` on the host: (codes uint32[N, L], versions int64[N])."""
    codes, vers = live_codes(state)
    return lanes_to_numpy(codes), vers.cpu().numpy()


def _same_as_previous(codes: torch.Tensor) -> torch.Tensor:
    """bool[N]: row i equals row i - 1 in every lane (False for row 0)."""
    out = torch.zeros(codes.shape[0], dtype=torch.bool, device=codes.device)
    if codes.shape[0] > 1:
        out[1:] = (codes[1:] == codes[:-1]).all(dim=1)
    return out


def sorted_unique(codes: torch.Tensor) -> torch.Tensor:
    """The distinct rows of int32[N, L] lane codes, in key order."""
    codes = codes[_lex_order([ordered(codes[:, i]) for i in range(codes.shape[1])])]
    return codes[~_same_as_previous(codes)]


def reshard(state: GridState, pivots, n_buckets: int, n_slots: int) -> GridState:
    """Rebuild the grid under new pivots (sorted lane codes, an int32
    tensor or uint32 numpy [P, L]; pivot 0 must equal the smallest live
    boundary) on the state's device (rare: init, growth, skew, a replay).
    Preserves the step function exactly: every live boundary is
    re-bucketed and each new pivot becomes a boundary inheriting the value
    of the gap containing it. Raises OverflowError when some bucket needs
    more than ``n_slots`` rows."""
    dev = state.grid.device
    Lp1 = state.grid.shape[-1]
    L = Lp1 - 1
    codes, vers = live_codes(state)
    if isinstance(pivots, np.ndarray):
        pivots = lanes_to_torch(pivots.reshape(-1, L))
    piv = pivots.to(dev).reshape(-1, L)
    if not torch.equal(piv[0], codes[0]):
        raise ValueError("pivot 0 must equal the smallest live boundary")
    P = piv.shape[0]
    if P > n_buckets:
        raise ValueError(f"{P} pivots for {n_buckets} buckets")

    # pivots and live rows in one order: by key, pivots first; a pivot row
    # inherits the value of the last live row at or below it (an equal live
    # row sorts after it and wins the dedupe below)
    all_codes = torch.cat([piv, codes])
    is_piv = torch.cat([torch.ones(P, dtype=torch.bool, device=dev),
                        torch.zeros(codes.shape[0], dtype=torch.bool, device=dev)])
    order = _lex_order([ordered(all_codes[:, i]) for i in range(L)] + [(~is_piv).to(_I32)])
    c_s, p_s = all_codes[order], is_piv[order]
    pos = torch.arange(c_s.shape[0], device=dev)
    live_pos = torch.cummax(torch.where(p_s, torch.full_like(pos, -1), pos), 0).values
    vers_all = torch.cat([torch.zeros(P, dtype=torch.long, device=dev), vers])[order]
    v_s = torch.where(p_s, vers_all[live_pos.clamp(min=0)], vers_all)
    b_s = torch.cumsum(p_s.long(), 0) - 1  # the bucket of the pivot at or before

    # dedupe equal keys keeping the LAST; a deduped-away pivot row passes
    # its pivot-ness to the kept row (runs have length 1 or 2)
    same_prev = _same_as_previous(c_s)
    last = torch.ones_like(p_s)
    last[:-1] = ~same_prev[1:]
    piv_kept = p_s.clone()
    piv_kept[1:] |= p_s[:-1] & same_prev[1:]
    v_d, b_d, c_d, p_d = v_s[last], b_s[last], c_s[last], piv_kept[last]

    # coalesce: drop rows whose value equals the previous row's value,
    # except pivot rows (slot 0 invariant); equality is transitive, so
    # comparing with the previous row is exact
    prev_val = torch.full_like(v_d, -1)
    prev_val[1:] = v_d[:-1]
    keep = p_d | (v_d != prev_val)
    v_k, b_k, c_k = v_d[keep], b_d[keep], c_d[keep]

    # slot index within bucket
    nkeep = v_k.shape[0]
    kpos = torch.arange(nkeep, device=dev)
    bucket_first = torch.ones(nkeep, dtype=torch.bool, device=dev)
    bucket_first[1:] = b_k[1:] != b_k[:-1]
    run_start = torch.cummax(torch.where(bucket_first, kpos, torch.zeros_like(kpos)), 0).values
    slot = kpos - run_start
    counts = torch.zeros(n_buckets, dtype=torch.long, device=dev)
    counts.scatter_add_(0, b_k, torch.ones_like(b_k))
    worst = int(counts.max()) if nkeep else 0
    if worst > n_slots:
        raise OverflowError(f"bucket {int(counts.argmax())} needs {worst} slots > {n_slots}")

    grid = torch.full((n_buckets, n_slots, Lp1), SENTINEL, dtype=_I32, device=dev)
    grid[..., L] = 0
    grid[b_k, slot, :L] = c_k
    grid[b_k, slot, L] = v_k.to(_I32)
    bmax = torch.zeros(n_buckets, dtype=torch.long, device=dev)
    bmax.scatter_reduce_(0, b_k, v_k, reduce="amax")
    new_pivots = torch.full((n_buckets, L), SENTINEL, dtype=_I32, device=dev)
    new_pivots[:P] = piv
    # the floors are folded into the versions by live_codes
    return GridState(new_pivots, grid, counts.to(_I32), bmax.to(_I32),
                     torch.zeros(n_buckets, dtype=_I32, device=dev))
