"""PyTorch wrappers of the hand-written CUDA kernels of the conflict grid.

Each wrapper checks the device, dtype, shape and contiguity of its inputs,
allocates its outputs with ``torch.empty`` on its inputs' card, launches
there, under ``torch.cuda.device(<that card>)`` on that card's current
stream (never the process's current device: a grid on ``cuda:1`` runs on
``cuda:1``), raises when the C entry point reports a CUDA error, and counts
its launches in ``<wrapper>.launches``. They take CUDA tensors of one card
only (``ValueError`` for tensors on two devices): ``conflict/grid.py`` runs
the plain PyTorch versions for tensors on the CPU. Lanes are int32 tensors
read by the kernels as uint32. ``resolve_many`` is the group scan: a whole
group of batches through K1/K6 history, K2 and K3 in one cooperative
launch (``csrc/scan.cu``), planned by ``scan_plan``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..errors import cuda_fault_class
from . import build

_I32 = torch.int32


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _device(*tensors: torch.Tensor) -> torch.device:
    """The one device every tensor of a launch lies on; ``ValueError`` for
    tensors on two devices, or for a device that is not a CUDA card."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"the tensors of one launch lie on {len(devices)} devices: "
                         f"{sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}")
    return dev


def _check(t: torch.Tensor, what: str, dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(fn_name: str, dev: torch.device, *args) -> None:
    """Launch ``fn_name`` on card ``dev`` under its device guard, on its
    current stream (the entry points take the stream last; ``search.cu``
    reads the SM count of the current device)."""
    with torch.cuda.device(dev):
        _run(fn_name, *args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))


def _run(fn_name: str, *args) -> None:
    err = build.load()[fn_name](*args)
    if err != 0:
        # a lost or silent card is a kernel fault (failover); any other
        # error is a defect and leaves the resolver as raised
        cls = cuda_fault_class(err) or RuntimeError
        raise cls(f"{fn_name}: CUDA error {err} at launch")


def _counted(fn):
    fn.launches = 0
    return fn


def split_factors(n: int) -> tuple[int, int]:
    """The bucket grid's superblock split: n = B1 * B2 with both powers of
    two, B1 >= B2 (the plain versions in ``grid`` use it too)."""
    lg = n.bit_length() - 1
    b1 = 1 << ((lg + 1) // 2)
    return b1, n // b1


def _history(fn_name, pivots, grid, count, bmax, floor, bounds, rb, re, t_snap) -> torch.Tensor:
    """Checks and launch shared by K1 (``grid`` [B, S, L+1]) and K6 history
    (``grid`` [P, B, S, L+1], ``bounds`` = (plo, phi) [P, L])."""
    *lead, B, S, Lp1 = grid.shape
    P = lead[0] if lead else 1
    L = Lp1 - 1
    T, KR, _ = rb.shape
    if B < 1 or B & (B - 1):
        raise ValueError(f"bucket count must be a power of two, got {B}")
    dev = _device(pivots, grid, count, bmax, floor, *bounds, rb, re, t_snap)
    _check(pivots, "pivots", _I32, (*lead, B, L))
    _check(grid, "grid", _I32)
    for name, t in (("count", count), ("bmax", bmax), ("floor", floor)):
        _check(t, name, _I32, (*lead, B))
    for name, t in zip(("plo", "phi"), bounds):
        _check(t, name, _I32, (P, L))
    _check(rb, "rb", _I32, (T, KR, L))
    _check(re, "re", _I32, (T, KR, L))
    _check(t_snap, "t_snap", _I32, (T,))
    B1, B2 = split_factors(B)
    sup = torch.empty(P * B1, dtype=_I32, device=dev)
    hit = torch.empty(T, dtype=torch.bool, device=dev)
    _launch(
        fn_name, dev,
        _ptr(pivots), _ptr(grid), _ptr(count), _ptr(bmax), _ptr(floor),
        *(_ptr(t) for t in bounds), _ptr(rb), _ptr(re), _ptr(t_snap), _ptr(sup),
        _ptr(hit), *lead, B, S, L, T, KR, B1, B2,
    )
    return hit


@_counted
def history(pivots, grid, count, bmax, floor, rb, re, t_snap) -> torch.Tensor:
    """K1: bool[T] history-conflict flags of one batch."""
    hit = _history("fdb_history", pivots, grid, count, bmax, floor, (), rb, re, t_snap)
    history.launches += 1
    return hit


@_counted
def history_parts(pivots, grid, count, bmax, floor, plo, phi, rb, re, t_snap) -> torch.Tensor:
    """K6 history: bool[T] history-conflict flags of one batch against P
    stacked partitions, each read range clipped to its partition's
    [plo, phi), OR-ed over the partitions."""
    hit = _history("fdb_history_parts", pivots, grid, count, bmax, floor, (plo, phi), rb, re, t_snap)
    history_parts.launches += 1
    return hit


MAX_TXNS = 65536  # intra_batch: a 32·ceil(T/32)²-word bitset (512 MiB at the limit)
SMEM_OPTIN = 232448  # bytes of shared memory one block may opt into (H100)


def overlap_words(WT: int, CR: int, CW: int, L: int) -> int:
    """Shared-memory words of one K2 overlap tile: 32 readers' CR slots at
    an odd stride and 32·WT writers' CW slots, both ends of L lanes."""
    return 32 * ((CR * 2 * L) | 1) + 32 * WT * CW * 2 * L


def intra_batch_plan(KR: int, KW: int, L: int, smem: int = SMEM_OPTIN,
                     widths=(8, 4, 2, 1)) -> tuple[int, int, int]:
    """K2's overlap tiling for KR read and KW write slots of L lanes in
    ``smem`` bytes of shared memory: (WT, CR, CW) — WT writer words per
    tile (32·WT threads compute it), and the read and write slots staged
    in shared memory at a time. Where 32 readers' KR slots and 32·WT
    writers' KW slots fit one block, that is the plan (the largest WT of
    ``widths`` that fits, CR = KR, CW = KW). Otherwise WT = widths[0] and
    the larger of the two staged parts is halved until they fit, then WT;
    CR = CW = 0 where not even one slot of each fits: the kernel then
    reads the endpoints from global memory."""
    cap = smem // 4
    for wt in widths:
        if overlap_words(wt, KR, KW, L) <= cap:
            return wt, KR, KW
    wt, cr, cw = widths[0], KR, KW
    while overlap_words(wt, cr, cw, L) > cap:
        if cr > 1 and cr >= wt * cw:
            cr = -(-cr // 2)
        elif cw > 1:
            cw = -(-cw // 2)
        elif wt > 1:
            wt //= 2
        else:
            return 1, 0, 0
    return wt, cr, cw


@_counted
def intra_batch(rb, re, wb, we, H) -> torch.Tensor:
    """K2: bool[T] in-order greedy commit from the batch's int32 code
    lanes (``rb``/``re`` [T, KR, L], ``wb``/``we`` [T, KW, L]); any KR, KW
    and L (``intra_batch_plan``), T <= MAX_TXNS."""
    T, KR, L = rb.shape
    KW = wb.shape[1]
    if T > MAX_TXNS:
        raise ValueError(f"batch of {T} transactions exceeds the kernel's {MAX_TXNS}")
    dev = _device(rb, re, wb, we, H)
    _check(rb, "rb", _I32, (T, KR, L))
    _check(re, "re", _I32, (T, KR, L))
    _check(wb, "wb", _I32, (T, KW, L))
    _check(we, "we", _I32, (T, KW, L))
    _check(H, "H", torch.bool, (T,))
    WT, CR, CW = intra_batch_plan(KR, KW, L)
    W = (T + 31) // 32
    pt = torch.empty(W * 32 * W, dtype=_I32, device=dev)  # the transposed bitset
    commit = torch.empty(T, dtype=torch.bool, device=dev)
    _launch(
        "fdb_intra_batch", dev,
        _ptr(rb), _ptr(re), _ptr(wb), _ptr(we), _ptr(H), _ptr(pt),
        _ptr(commit), T, KR, KW, L, WT, CR, CW,
    )
    intra_batch.launches += 1
    return commit


STAGE_TILE_BYTES = SMEM_OPTIN - 2048  # shared memory of one sort tile (the scans take the rest)
STAGE_TILE_ROWS = 8192  # rows one CTA sorts (16-bit indices); more go through merge passes
MAX_STAGE_ROWS = 1 << 30  # endpoint rows of one partition, padded (int row indices)


def _stage(wb, we, commit, pivots, S2):
    P, T, KW, L = wb.shape
    B = pivots.shape[1]
    dev = _device(wb, we, commit, pivots)
    _check(wb, "wb", _I32)
    _check(we, "we", _I32, (P, T, KW, L))
    _check(commit, "commit", torch.bool, (T,))
    _check(pivots, "pivots", _I32, (P, B, L))
    n2 = 2 * T * KW
    n2pad = 1 << (n2 - 1).bit_length()
    if n2pad > MAX_STAGE_ROWS:
        raise ValueError(f"{n2pad} endpoint rows a partition exceed the kernel's {MAX_STAGE_ROWS}")
    rw = L + 2
    fit = STAGE_TILE_BYTES // (rw * 4 + 6)  # records a sort tile holds
    if fit < 1:
        raise ValueError(f"{L} lanes: one staging record exceeds a block's shared memory")
    # a tile's records of rw words and its sort keys (4-byte bucket, 2-byte index)
    tile = min(n2pad, STAGE_TILE_ROWS, 1 << (fit.bit_length() - 1))
    U = P * min(n2, B)
    st_code = torch.empty((U, S2, L), dtype=_I32, device=dev)
    st_ev = torch.empty((U, S2), dtype=_I32, device=dev)
    tid = torch.empty(U, dtype=_I32, device=dev)
    carry = torch.empty(U, dtype=_I32, device=dev)
    counters = torch.zeros(2 * P, dtype=_I32, device=dev)  # max_staged, then valid rows, per partition
    max_staged, n_valid = counters[:P], counters[P:]
    # the records; the sorted tiles and merge passes need a second buffer
    # unless one CTA sorts and aggregates everything in shared memory
    n_rec = P * n2pad * rw
    rec_a = torch.empty(n_rec, dtype=_I32, device=dev)
    rec_b = torch.empty(0 if P == 1 and tile == n2pad else n_rec, dtype=_I32, device=dev)
    _launch(
        "fdb_stage", dev,
        _ptr(wb), _ptr(we), _ptr(commit), _ptr(pivots), _ptr(st_code), _ptr(st_ev), _ptr(tid),
        _ptr(carry), _ptr(max_staged), _ptr(n_valid), _ptr(rec_a), _ptr(rec_b),
        P, T, KW, L, B, U, S2, n2pad, tile,
    )
    return st_code, st_ev, tid, carry, max_staged


@_counted
def stage(wb, we, commit, pivots, S2: int):
    """K3 staging on one grid: the committed write endpoints of ``wb``/
    ``we`` [1, T, KW, L] ranked against ``pivots`` [1, B, L], sorted by
    (bucket, code), aggregated per distinct code and staged per touched
    bucket in planes of ``S2`` slots. Returns (st_code [U, S2, L], st_ev [U, S2], tid [U], carry
    [U] — the event prefix at each touched bucket —, max_staged [1]).

    Limits (both raise before the launch): at most MAX_STAGE_ROWS = 2^30
    endpoint rows 2·T·KW a partition, padded to a power of two (the
    kernel's row indices are int), and at most 57,596 lanes (a key width
    of 230 KB: one record of L + 2 words and its sort key must fit a sort
    tile's shared memory). Memory bounds it first: the two record buffers
    take 2·P·n2pad·(L + 2)·4 bytes, 2 × 335 MB at P = 4, T = 4096,
    KW = 256, L = 8."""
    out = _stage(wb, we, commit, pivots, S2)
    stage.launches += 1
    return out


@_counted
def stage_parts(wb, we, commit, pivots, S2: int):
    """K6 staging: ``stage`` over P partitions at once (``wb``/``we``
    [P, T, KW, L] clipped to each partition, ``pivots`` [P, B, L]); bucket
    ids are flat over the [P·B] view, max_staged is per partition."""
    out = _stage(wb, we, commit, pivots, S2)
    stage_parts.launches += 1
    return out


MERGE_WARPS = 8  # touched buckets per CTA of csrc/merge.cu (kWarps)


def _merge(grid, count, bmax, floor, st_code, st_ev, tid, carry_in, now, oldest, n_parts):
    B, S, Lp1 = grid.shape
    L = Lp1 - 1
    U, S2, _ = st_code.shape
    if S > 32 or S2 > 32:
        raise ValueError(f"S = {S}, S2 = {S2}: one warp holds at most 32 rows of each")
    if B % n_parts:
        raise ValueError(f"{B} buckets do not split into {n_parts} partitions")
    dev = _device(grid, count, bmax, floor, st_code, st_ev, tid, carry_in)
    _check(grid, "grid", _I32)
    for name, t in (("count", count), ("bmax", bmax), ("floor", floor)):
        _check(t, name, _I32, (B,))
    _check(st_code, "st_code", _I32, (U, S2, L))
    _check(st_ev, "st_ev", _I32, (U, S2))
    _check(tid, "tid", _I32, (U,))
    _check(carry_in, "carry_in", _I32, (U,))
    max_kept = torch.zeros(n_parts, dtype=_I32, device=dev)
    # a warp's 64 rows of L + 1 words in shared memory, or (L > 112) in
    # global scratch, one plane per staging slot
    rows = None
    if MERGE_WARPS * 64 * Lp1 * 4 > SMEM_OPTIN:
        rows = torch.empty((U, 64, Lp1), dtype=_I32, device=dev)
    _launch(
        "fdb_merge", dev,
        _ptr(grid), _ptr(count), _ptr(bmax), _ptr(floor), _ptr(st_code),
        _ptr(st_ev), _ptr(tid), _ptr(carry_in), int(now), int(oldest),
        _ptr(max_kept), None if rows is None else _ptr(rows), B, B // n_parts, S, S2, L, U,
    )
    return max_kept


@_counted
def merge(grid, count, bmax, floor, st_code, st_ev, tid, carry_in, now: int, oldest: int):
    """K3: merge the staged rows into their buckets IN PLACE (grid, count,
    bmax, floor), and raise the floor of the untouched buckets a committed
    write spans (``carry_in`` > 0 at the next touched bucket). Returns
    int32[1]: the most rows any bucket kept."""
    out = _merge(grid, count, bmax, floor, st_code, st_ev, tid, carry_in, now, oldest, 1)
    merge.launches += 1
    return out


@_counted
def merge_parts(grid, count, bmax, floor, st_code, st_ev, tid, carry_in, now: int, oldest: int,
                n_parts: int):
    """K6 merge: K3 over the flat [P·B] view of P stacked partitions (tid
    holds flat bucket ids). Returns int32[P]: the most rows any bucket of
    each partition kept."""
    out = _merge(grid, count, bmax, floor, st_code, st_ev, tid, carry_in, now, oldest, n_parts)
    merge_parts.launches += 1
    return out


def _scan_words(B: int) -> int:
    """Words of the reshard's scan per partition (``scan_levels`` of
    csrc/maint.cu): the B prefix sums, then every 32nd, 1024th, ... of them
    while more than 32 chunk totals lie above, rounded up to 16 bytes."""
    words = n = B
    while n > 1024:
        n = -(-n // 32)
        words += n
    return -(-words // 4) * 4


def _reshard(grid, count, floor, n_buckets, n_slots):
    P, B, S, Lp1 = grid.shape
    L = Lp1 - 1
    dev = _device(grid, count, floor)
    _check(grid, "grid", _I32)
    _check(count, "count", _I32, (P, B))
    _check(floor, "floor", _I32, (P, B))
    if n_buckets < 1 or n_slots < 1:
        raise ValueError(f"n_buckets = {n_buckets}, n_slots = {n_slots}: both must be >= 1")
    scan = torch.empty((P, _scan_words(B)), dtype=_I32, device=dev)  # scratch: the counts' prefix sums
    totals = torch.empty((P, 32), dtype=_I32, device=dev)  # scratch: the scan's chunk totals
    pivots = torch.empty((P, n_buckets, L), dtype=_I32, device=dev)
    out = torch.empty((P, n_buckets, n_slots, Lp1), dtype=_I32, device=dev)
    count_out = torch.empty((P, n_buckets), dtype=_I32, device=dev)
    bmax = torch.empty((P, n_buckets), dtype=_I32, device=dev)
    floor_out = torch.empty((P, n_buckets), dtype=_I32, device=dev)
    pressure = torch.empty(P, dtype=_I32, device=dev)
    _launch(
        "fdb_reshard", dev,
        _ptr(grid), _ptr(count), _ptr(floor), _ptr(scan), _ptr(totals), _ptr(pivots),
        _ptr(out), _ptr(count_out), _ptr(bmax), _ptr(floor_out), _ptr(pressure),
        P, B, S, L, int(n_buckets), int(n_slots), scan.shape[1],
    )
    return pivots, out, count_out, bmax, floor_out, pressure


@_counted
def maint_reshard(grid, count, floor, n_buckets: int, n_slots: int):
    """K4a: rebalance the live rows (slots s < count[b]) into ``n_buckets``
    × ``n_slots``. Returns (pivots, grid, count, bmax, floor, pressure int32
    scalar)."""
    out = _reshard(grid[None], count[None], floor[None], n_buckets, n_slots)
    maint_reshard.launches += 1
    return tuple(x[0] for x in out)


@_counted
def maint_reshard_parts(grid, count, floor, n_buckets: int, n_slots: int):
    """K7a: K4a on each of P stacked partitions in one launch. Returns the
    stacked (pivots, grid, count, bmax, floor) and int32[P] pressures."""
    out = _reshard(grid, count, floor, n_buckets, n_slots)
    maint_reshard_parts.launches += 1
    return out


def _rebase(grid, count, floor, delta):
    B, S, Lp1 = grid.shape
    dev = _device(grid, count, floor)
    _check(grid, "grid", _I32)
    _check(count, "count", _I32, (B,))
    _check(floor, "floor", _I32, (B,))
    out = torch.empty_like(grid)
    bmax = torch.empty(B, dtype=_I32, device=dev)
    floor_out = torch.empty(B, dtype=_I32, device=dev)
    _launch(
        "fdb_rebase", dev,
        _ptr(grid), _ptr(count), _ptr(floor), _ptr(out), _ptr(bmax),
        _ptr(floor_out), int(delta), B, S, Lp1 - 1,
    )
    return out, bmax, floor_out


@_counted
def maint_rebase(grid, count, floor, delta: int):
    """K4b: shift the version origin by ``delta``. Returns (grid, bmax,
    floor) as new tensors; the inputs are left intact."""
    out = _rebase(grid, count, floor, delta)
    maint_rebase.launches += 1
    return out


@_counted
def maint_rebase_parts(grid, count, floor, delta: int):
    """K7b: K4b over P stacked partitions as one flat grid of P·B buckets
    (rebase is independent per bucket). Returns stacked (grid, bmax,
    floor)."""
    P, B, S, Lp1 = grid.shape
    _check(grid, "grid", _I32)
    _check(count, "count", _I32, (P, B))
    _check(floor, "floor", _I32, (P, B))
    out, bmax, floor_out = _rebase(
        grid.view(P * B, S, Lp1), count.view(P * B), floor.view(P * B), delta
    )
    maint_rebase_parts.launches += 1
    return out.view(P, B, S, Lp1), bmax.view(P, B), floor_out.view(P, B)


@_counted
def search(codes, q):
    """K5: int32[2, Q] — for each query row, the count of sorted code rows
    < q (row 0, side "left") and <= q (row 1, side "right"), each plus one
    where it equals P >= 2, as the reference's fixed-step search ends."""
    P, L = codes.shape
    Q = q.shape[0]
    if P < 1:
        raise ValueError("the code array is empty")
    dev = _device(codes, q)
    _check(codes, "codes", _I32)
    _check(q, "q", _I32, (Q, L))
    out = torch.empty((2, Q), dtype=_I32, device=dev)
    if Q:
        _launch("fdb_search", dev, _ptr(codes), _ptr(q), _ptr(out), P, Q, L)
        search.launches += 1
    return out


def search_steps(n: int) -> int:
    """The reference's step count: max(1, ceil(log2 n) + 1)."""
    return max(1, (n - 1).bit_length() + 1)


SCAN_THREADS = 1024  # threads of a scan CTA: the chain's and the tile sort's (csrc/scan.cu)
SCAN_SMEM = STAGE_TILE_BYTES  # dynamic shared memory a scan CTA may take; its aggregation keeps 1,056 static bytes
SCAN_OVERLAP_WIDTHS = (32, 16, 8, 4, 2, 1)  # writer words of a scan CTA's overlap tile: its 32 warps at most
CHAIN_WORDS = 2048  # the chain's commit words in shared memory (csrc/intra_batch.cuh kMaxWords)


class ScanPlan(NamedTuple):
    """How one group goes through the scan: the cooperative grid, a CTA's
    dynamic shared memory (the largest phase's), each phase's tiling and
    the scratch, one int32 buffer cut into 16-byte aligned pieces."""

    blocks: int  # CTAs of the cooperative grid, all co-resident
    smem: int  # dynamic shared memory of a CTA, bytes
    overlap: tuple  # K2's tiling (WT, CR, CW), intra_batch_plan's in SCAN_SMEM, WT < 2·⌈T/32⌉
    S2: int  # staging slots a touched bucket
    U: int  # staging planes: touched buckets a batch may have
    n2pad: int  # a partition's staging rows, 2·T·KW padded to a power of two
    tile: int  # rows one sort tile holds (csrc/stage.cu)
    rows_in_smem: bool  # the merge's 64 rows a warp in shared memory, else in scratch
    offsets: dict  # scratch piece -> (offset, words)
    words: int  # the scratch in int32 words


# the scan's scratch pieces in order (their int32 words: ``scan_plan``)
SCAN_PIECES = ("bmax_sup", "H", "commit", "pt", "st_code", "st_ev", "tid", "carry", "rec_a", "rec_b",
               "rows", "counters")


def scan_plan(G: int, T: int, KR: int, KW: int, L: int, P: int, B: int, S: int, S2: int,
              n_sms: int, blocks_per_sm: int = 1) -> ScanPlan:
    """The launch of one group of G batches (T transactions of KR reads
    and KW writes, L lanes) over P stacked partitions of B buckets × S
    slots on ``n_sms`` SMs with ``blocks_per_sm`` scan CTAs co-resident on
    each (the occupancy query's answer). Raises ValueError for a shape the
    kernels refuse, as their standalone wrappers do."""
    if T > MAX_TXNS:
        raise ValueError(f"batch of {T} transactions exceeds the kernel's {MAX_TXNS}")
    if B < 1 or B & (B - 1):
        raise ValueError(f"bucket count must be a power of two, got {B}")
    if S > 32 or S2 > 32:
        raise ValueError(f"S = {S}, S2 = {S2}: one warp holds at most 32 rows of each")
    n2 = 2 * T * KW
    n2pad = 1 << (n2 - 1).bit_length()
    if n2pad > MAX_STAGE_ROWS:
        raise ValueError(f"{n2pad} endpoint rows a partition exceed the kernel's {MAX_STAGE_ROWS}")
    rw = L + 2
    fit = STAGE_TILE_BYTES // (rw * 4 + 6)
    if fit < 1:
        raise ValueError(f"{L} lanes: one staging record exceeds a block's shared memory")
    tile = min(n2pad, STAGE_TILE_ROWS, 1 << (fit.bit_length() - 1))
    W = -(-T // 32)
    # a tile no wider than the batch's writer words, padded to a power of
    # two: wider ones stage padding (and, chunked, take more passes)
    overlap = intra_batch_plan(KR, KW, L, SCAN_SMEM,
                               tuple(w for w in SCAN_OVERLAP_WIDTHS if w < 2 * W) or (1,))
    rows_smem = SCAN_THREADS // 32 * 64 * (L + 1) * 4
    rows_in_smem = rows_smem <= SCAN_SMEM
    smem = max(overlap_words(*overlap, L) * 4 if overlap[1] else 0, CHAIN_WORDS * 4,
               tile * (rw * 4 + 6), rows_smem if rows_in_smem else 0)
    smem = -(-smem // 16) * 16
    blocks = n_sms * blocks_per_sm
    U = P * min(n2, B)
    B1, _B2 = split_factors(B)
    rec = P * n2pad * rw
    sizes = {
        "bmax_sup": P * B1, "H": -(-T // 4), "commit": -(-T // 4), "pt": 32 * W * W,
        "st_code": U * S2 * L, "st_ev": U * S2, "tid": U, "carry": U,
        "rec_a": rec, "rec_b": 0 if P == 1 and tile == n2pad else rec,
        "rows": 0 if rows_in_smem else min(U, blocks * SCAN_THREADS // 32) * 64 * (L + 1),
        "counters": 3 * G * P,
    }
    offsets, at = {}, 0
    for name in SCAN_PIECES:
        offsets[name] = (at, sizes[name])
        at += -(-sizes[name] // 4) * 4
    return ScanPlan(blocks, smem, overlap, S2, U, n2pad, tile, rows_in_smem, offsets, at)


_scan_occupancy: dict = {}  # (device, L, smem) -> (CTAs an SM, SMs): the card's answer, asked once


def _plan_on(dev: torch.device, G, T, KR, KW, L, P, B, S, S2) -> ScanPlan:
    """``scan_plan`` on card ``dev``, its grid sized by the occupancy query
    there."""
    smem = scan_plan(G, T, KR, KW, L, P, B, S, S2, n_sms=0).smem
    occ = _scan_occupancy.get((dev, L, smem))
    if occ is None:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(dev):
            _run("fdb_scan_occupancy", L, smem, ctypes.c_void_p(ctypes.addressof(out)))
        occ = _scan_occupancy[(dev, L, smem)] = (out[0], out[1])
    return scan_plan(G, T, KR, KW, L, P, B, S, S2, n_sms=occ[1], blocks_per_sm=occ[0])


@_counted
def resolve_many(pivots, grid, count, bmax, floor, bounds, rb, re, wb, we, t_snap, t_has_reads, vers,
                 S2: int):
    """The group scan: G batches (``rb``/``re`` [G, T, KR, L], ``wb``/``we``
    [G, T, KW, L], ``t_snap`` int32 and ``t_has_reads`` bool [G, T]; ``vers``
    int32 [3, G]: each batch's now, oldest version before it and after it)
    through K1 → K2 → K3 staging → K3 merge in ONE cooperative launch,
    updating the state IN PLACE: one grid ([B, ...], ``bounds`` None) or P
    stacked partitions ([P, B, ...]) with ``bounds`` = (plo, phi) [P, L],
    each read and write clipped to its partitions in the kernel. Returns
    (verdicts int8 [G, T], the per-batch pressures int32 [G, P, 2] — most
    staged and most kept rows in a bucket of each partition —, their
    maxima over the group int32 [P, 2]). A grid that cannot be co-resident
    and a refused launch raise; nothing falls back to the per-batch
    kernels."""
    *lead, B, S, Lp1 = grid.shape
    P = lead[0] if lead else 1
    L = Lp1 - 1
    G, T, KR, _ = rb.shape
    KW = wb.shape[2]
    if bool(lead) != (bounds is not None):
        raise ValueError("the scan takes partition bounds with a stacked state, and none with one grid")
    bounds = tuple(bounds or ())
    dev = _device(pivots, grid, count, bmax, floor, *bounds, rb, re, wb, we, t_snap, t_has_reads, vers)
    _check(pivots, "pivots", _I32, (*lead, B, L))
    _check(grid, "grid", _I32)
    for name, t in (("count", count), ("bmax", bmax), ("floor", floor)):
        _check(t, name, _I32, (*lead, B))
    for name, t in zip(("plo", "phi"), bounds):
        _check(t, name, _I32, (P, L))
    for name, t in (("rb", rb), ("re", re)):
        _check(t, name, _I32, (G, T, KR, L))
    for name, t in (("wb", wb), ("we", we)):
        _check(t, name, _I32, (G, T, KW, L))
    _check(t_snap, "t_snap", _I32, (G, T))
    _check(t_has_reads, "t_has_reads", torch.bool, (G, T))
    _check(vers, "vers", _I32, (3, G))
    plan = _plan_on(dev, G, T, KR, KW, L, P, B, S, S2)
    scratch = torch.empty(plan.words, dtype=_I32, device=dev)
    base = scratch.data_ptr()
    pieces = [ctypes.c_void_p(base + 4 * off) if n else None for off, n in
              (plan.offsets[name] for name in SCAN_PIECES)]
    verdicts = torch.empty((G, T), dtype=torch.int8, device=dev)
    pressures = torch.empty((G, P, 2), dtype=_I32, device=dev)
    gmax = torch.empty((P, 2), dtype=_I32, device=dev)
    B1, B2 = split_factors(B)
    _launch(
        "fdb_resolve_many", dev,
        _ptr(pivots), _ptr(grid), _ptr(count), _ptr(bmax), _ptr(floor),
        *([_ptr(t) for t in bounds] or [None, None]),
        _ptr(rb), _ptr(re), _ptr(wb), _ptr(we), _ptr(t_snap), _ptr(t_has_reads), _ptr(vers),
        _ptr(verdicts), _ptr(pressures), _ptr(gmax), *pieces,
        G, P, B, S, L, T, KR, KW, B1, B2, *plan.overlap, S2, plan.U, plan.n2pad, plan.tile,
        plan.smem, plan.blocks,
    )
    resolve_many.launches += 1
    return verdicts, pressures, gmax


WRAPPERS = {
    "history": history,
    "intra_batch": intra_batch,
    "stage": stage,
    "merge": merge,
    "maint_reshard": maint_reshard,
    "maint_rebase": maint_rebase,
    "search": search,
    "history_parts": history_parts,
    "stage_parts": stage_parts,
    "merge_parts": merge_parts,
    "maint_reshard_parts": maint_reshard_parts,
    "maint_rebase_parts": maint_rebase_parts,
    "resolve_many": resolve_many,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
