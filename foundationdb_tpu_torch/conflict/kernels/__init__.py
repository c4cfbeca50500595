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
launch (``csrc/scan.cu``), planned by ``scan_plan``; ``resolve_many_spread``
is the same scan over every entry of a spread on a card, one launch a card
(``spread_plan``), every card's launch prepared before any is issued, the
cards' history verdicts exchanged inside the launches through a
``SpreadExchange`` (each card's inbox in its own memory over NVLink, or in
mapped host memory where the cards lack peer access). The spreads of one
process reach every card they share in one order: their launches are
issued under one lock (``_spread_issue``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ..errors import KernelTimeoutError, cuda_fault_class
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


def intra_batch_plan(T: int, KR: int, KW: int, n_sms: int) -> tuple[int, int]:
    """K2's overlap items (R, NS) for a batch of T transactions with KR read
    and KW write slots on a card of ``n_sms`` SMs: the scan's
    (``overlap_items`` over one scan CTA's warps an SM), so the standalone
    K2 and the scan's phase split the work alike. Any KR, KW and L: a
    warp stages at most 2·32·16 lanes of readers (``overlap_smem``)."""
    return overlap_items(T, KR, KW, n_sms * SCAN_THREADS // 32)


def overlap_smem(n_warps: int, L: int) -> int:
    """Bytes of shared memory ``n_warps`` warps of K2's overlap items
    stage their readers in: both ends of 32 readers in the kernel's
    register width (4, 8 or 16 lanes; none past 16, compared in memory)."""
    lanes = next((m for m in (4, 8, 16) if L <= m), 0)
    return n_warps * 64 * lanes * 4


_sm_counts: dict = {}  # device -> its SMs


def _sms(dev: torch.device) -> int:
    n = _sm_counts.get(dev)
    if n is None:
        n = _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


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
    R, NS = intra_batch_plan(T, KR, KW, _sms(dev))
    W = (T + 31) // 32
    pt = torch.empty(W * 32 * W, dtype=_I32, device=dev)  # the transposed bitset
    commit = torch.empty(T, dtype=torch.bool, device=dev)
    _launch(
        "fdb_intra_batch", dev,
        _ptr(rb), _ptr(re), _ptr(wb), _ptr(we), _ptr(H), _ptr(pt),
        _ptr(commit), T, KR, KW, L, R, NS,
    )
    intra_batch.launches += 1
    return commit


STAGE_TILE_BYTES = SMEM_OPTIN - 2048  # shared memory of one sort tile (the scans take the rest)
STAGE_TILE_ROWS = 8192  # rows one CTA sorts (16-bit indices); more go through merge passes
STAGE_THREADS = 1024  # threads of a sort tile's and an aggregation chunk's CTA (csrc/stage.cu)
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
    # the aggregation's chunk totals, four (head, value) pairs a chunk of
    # STAGE_THREADS records (csrc/stage.cu)
    agg = torch.empty(P * -(-n2pad // STAGE_THREADS) * 8, dtype=_I32, device=dev)
    _launch(
        "fdb_stage", dev,
        _ptr(wb), _ptr(we), _ptr(commit), _ptr(pivots), _ptr(st_code), _ptr(st_ev), _ptr(tid),
        _ptr(carry), _ptr(max_staged), _ptr(n_valid), _ptr(rec_a), _ptr(rec_b), _ptr(agg),
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
    # a warp's 64 rows of L words, their payloads and their order in
    # shared memory, or (L > 111) in global scratch, one plane per staging slot
    rows = None
    if MERGE_WARPS * 64 * (L + 2) * 4 > SMEM_OPTIN:
        rows = torch.empty((U, 64, L + 2), dtype=_I32, device=dev)
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


SCAN_THREADS = 512  # threads of a scan CTA: 128 registers a thread at one CTA an SM (csrc/scan.cu)
SCAN_SMEM = STAGE_TILE_BYTES  # dynamic shared memory a scan CTA may take (1,056 static bytes beside it)
SCAN_TILE_ROWS = 1024  # rows of a scan sort tile: CTAs sort tiles side by side, then merge passes
CHAIN_WORDS = 2048  # the chain's commit words in shared memory (csrc/intra_batch.cuh kMaxWords)
SCAN_SLICE_WORK = 8  # read x write slot pairs a lane of an overlap item tests before the write slots are sliced


class ScanPlan(NamedTuple):
    """How one group goes through the scan on one card: the cooperative
    grid, a CTA's dynamic shared memory (the largest phase's), each phase's
    tiling and the scratch, one int32 buffer cut into 16-byte aligned
    pieces: the card's own (SCAN_SHARED), then one block of SCAN_ENTRY
    pieces for each of its ``entries`` (entry e's at + e · entry_words)."""

    blocks: int  # CTAs of the cooperative grid, all co-resident
    smem: int  # dynamic shared memory of a CTA, bytes
    overlap: tuple  # K2's overlap items (R, NS): readers an item, slices of the write slots
    S2: int  # staging slots a touched bucket
    U: int  # staging planes of an entry: touched buckets a batch may have
    n2pad: int  # a partition's staging rows, 2·T·KW padded to a power of two
    tile: int  # rows one sort tile holds
    rows_in_smem: bool  # the merge's 64 rows a warp in shared memory, else in scratch
    offsets: dict  # scratch piece -> (offset, words); an entry's piece: entry 0's
    words: int  # the scratch in int32 words
    entries: int = 1  # entries of a spread on the card
    entry_words: int = 0  # int32 words of one entry's block of pieces


# the scan's scratch pieces in the order the C entry points take them
# (their int32 words: ``scan_plan``): the card's own, and each entry's
SCAN_PIECES = ("bmax_sup", "H", "commit", "pt", "st_code", "st_ev", "tid", "carry", "rec_a", "rec_b",
               "rows", "agg", "counters")
SCAN_SHARED = ("H", "commit", "pt", "rows")
SCAN_ENTRY = tuple(p for p in SCAN_PIECES if p not in SCAN_SHARED)


def overlap_items(T: int, KR: int, KW: int, n_warps: int) -> tuple[int, int]:
    """K2's overlap items in the scan, (R, NS): a warp an item of R
    readers (a power of two up to 32) × one writer word × one of NS slices
    of the KW write slots. R grows while the (reader, word) pairs at or
    below the diagonal still give every warp of the grid an item; where
    they give fewer than one a warp (a batch of a few transactions) and a
    lane would test more than SCAN_SLICE_WORK slot pairs, the write slots
    are sliced, NS a power of two up to KW."""
    W = -(-T // 32)
    pairs = sum((k + 1) * min(32, T - 32 * k) for k in range(W))  # (reader j, word w <= j / 32)
    n_warps = max(n_warps, 1)
    R = 1
    while R < 32 and pairs >= 2 * R * n_warps:
        R *= 2
    NS = 1
    if R == 1 and KR * KW > SCAN_SLICE_WORK:
        cap = min(KW, max(n_warps // pairs, 1))
        NS = 1 << (cap.bit_length() - 1)
    return R, NS


def scan_plan(G: int, T: int, KR: int, KW: int, L: int, P: int, B: int, S: int, S2: int,
              n_sms: int, blocks_per_sm: int = 1, entries: int = 1) -> ScanPlan:
    """The launch of one group of G batches (T transactions of KR reads
    and KW writes, L lanes) over P stacked partitions of B buckets × S
    slots, for each of ``entries`` entries of a spread on the card, on
    ``n_sms`` SMs with ``blocks_per_sm`` scan CTAs co-resident on each (the
    occupancy query's answer). Raises ValueError for a shape the kernels
    refuse, as their standalone wrappers do."""
    if not 1 <= entries <= MAX_CARD_ENTRIES:
        raise ValueError(f"{entries} entries on one card: the scan takes 1 to {MAX_CARD_ENTRIES}")
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
    tile = min(n2pad, SCAN_TILE_ROWS, 1 << (fit.bit_length() - 1))
    blocks = n_sms * blocks_per_sm
    overlap = overlap_items(T, KR, KW, blocks * SCAN_THREADS // 32)
    rows_smem = SCAN_THREADS // 32 * 64 * (L + 2) * 4  # a warp's merge rows, their payloads and order
    rows_in_smem = rows_smem <= SCAN_SMEM
    readers_smem = overlap_smem(SCAN_THREADS // 32, L)  # a warp's 32 staged readers of K2's overlap items
    smem = max(CHAIN_WORDS * 4, tile * (rw * 4 + 6), rows_smem if rows_in_smem else 0, readers_smem)
    smem = -(-smem // 16) * 16
    U = P * min(n2, B)
    B1, _B2 = split_factors(B)
    W = -(-T // 32)
    rec = P * n2pad * rw
    sizes = {
        "bmax_sup": P * B1, "H": -(-T // 4), "commit": -(-T // 4), "pt": 32 * W * W,
        "st_code": U * S2 * L, "st_ev": U * S2, "tid": U, "carry": U,
        "rec_a": rec, "rec_b": 0 if P == 1 and tile == n2pad else rec,
        "rows": 0 if rows_in_smem else min(entries * U, blocks * SCAN_THREADS // 32) * 64 * (L + 2),
        "agg": P * -(-n2pad // SCAN_THREADS) * 8,  # a chunk's scan total: four (head, value) pairs
        "counters": 3 * G * P,
    }
    offsets, at = {}, 0
    for names in (SCAN_SHARED, SCAN_ENTRY):
        first = at
        for name in names:
            offsets[name] = (at, sizes[name])
            at += -(-sizes[name] // 4) * 4
    entry_words = at - first
    at += (entries - 1) * entry_words
    return ScanPlan(blocks, smem, overlap, S2, U, n2pad, tile, rows_in_smem, offsets, at, entries, entry_words)


_scan_occupancy: dict = {}  # (device, L, smem) -> (CTAs an SM, SMs): the card's answer, asked once


def _plan_on(dev: torch.device, G, T, KR, KW, L, P, B, S, S2, entries: int = 1) -> ScanPlan:
    """``scan_plan`` on card ``dev``, its grid sized by the occupancy query
    there."""
    smem = scan_plan(G, T, KR, KW, L, P, B, S, S2, n_sms=0, entries=entries).smem
    occ = _scan_occupancy.get((dev, L, smem))
    if occ is None:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(dev):
            _run("fdb_scan_occupancy", L, smem, ctypes.c_void_p(ctypes.addressof(out)))
        occ = _scan_occupancy[(dev, L, smem)] = (out[0], out[1])
    return scan_plan(G, T, KR, KW, L, P, B, S, S2, n_sms=occ[1], blocks_per_sm=occ[0], entries=entries)


def _scratch_pieces(scratch: torch.Tensor, plan: ScanPlan) -> list:
    """The pointers of the plan's pieces in ``scratch`` (entry 0's of an
    entry's piece), in SCAN_PIECES order; None for an empty piece."""
    base = scratch.data_ptr()
    return [ctypes.c_void_p(base + 4 * off) if n else None
            for off, n in (plan.offsets[name] for name in SCAN_PIECES)]


SCAN_PHASES = ("superblock maxima", "history + K2 overlap", "K2 chain", "verdicts + staging records",
               "sort tiles", "merge passes", "aggregation", "K3 merge + floor raise")  # csrc/scan.cu kScanPhases
# a spread's launch stamps the exchange of H across cards apart (zero time on one card)
SPREAD_PHASES = SCAN_PHASES[:2] + ("exchange",) + SCAN_PHASES[2:]
# and three points inside the exchange, after the phase boundaries (csrc/scan.cu kExchangePoints)
EXCHANGE_POINTS = ("published", "peers seen", "H ORed")
SPREAD_STAMPS = len(SPREAD_PHASES) + 1 + len(EXCHANGE_POINTS)  # a spread's stamps a batch
# the exchange's segments: its start, the points, the grid barrier that ends it
EXCHANGE_SEGMENTS = ("publish", "wait", "OR", "barrier")


def _stamp_runs(stamps: torch.Tensor) -> torch.Tensor:
    """The stamps as [runs, G, columns] int64 on the host."""
    s = stamps.detach().cpu()
    return s[None] if s.dim() == 2 else s


def scan_phase_ms(stamps: torch.Tensor) -> dict:
    """The per-phase timer's stamps (int64 [G, len(SCAN_PHASES) + 1] of
    ``resolve_many(..., phase_ns=)``, or [G, SPREAD_STAMPS] of a card's
    launch of ``resolve_many_spread``: the card's nanosecond clock at each
    phase boundary of each batch, then a spread's points inside the
    exchange, or several such runs stacked [R, G, ...]) as ms a group: each
    phase's time summed over the group's batches (the mean over the runs),
    and their total."""
    s = _stamp_runs(stamps)
    names = {len(SCAN_PHASES) + 1: SCAN_PHASES, SPREAD_STAMPS: SPREAD_PHASES}.get(s.shape[-1])
    if s.dim() != 3 or names is None:
        raise ValueError(f"stamps must be [G, {len(SCAN_PHASES) + 1}] or [G, {SPREAD_STAMPS}], or "
                         f"runs of them stacked, got {tuple(stamps.shape)}")
    s = s[..., : len(names) + 1]
    # differences in int64 first: a stamp (ns since the epoch) needs 61 bits
    ms = (s[..., 1:] - s[..., :-1]).sum(dim=1).to(torch.float64).mean(dim=0) / 1e6
    phases = dict(zip(names, ms.tolist()))
    return {"phases": phases, "total_ms": float(ms.sum()), "batches": int(s.shape[1])}


def exchange_split(stamps: torch.Tensor) -> dict:
    """A card's exchange of H from its spread stamps ([G, SPREAD_STAMPS] or
    runs of them stacked), in µs a batch: the whole phase and its segments
    (``EXCHANGE_SEGMENTS``: the words published, the wait for the last
    card's, the OR into H, the grid barrier after it), for batch 0 alone
    (the mean over the runs; its wait holds the cards' start-up skew), and
    the median and the largest over the other batches of every run (the
    transport's own cost a batch). Only differences of one card's clock."""
    s = _stamp_runs(stamps)
    if s.dim() != 3 or s.shape[-1] != SPREAD_STAMPS:
        raise ValueError(f"stamps must be [G, {SPREAD_STAMPS}] or runs of them stacked, got {tuple(stamps.shape)}")
    n = len(SPREAD_PHASES) + 1
    cols = [2, n, n + 1, n + 2, 3]  # the exchange's start, its three points, its end
    at = s[..., cols]
    seg = (at[..., 1:] - at[..., :-1]).to(torch.float64) / 1e3  # [R, G, 4] µs
    seg = torch.cat([seg, seg.sum(dim=-1, keepdim=True)], dim=-1)
    names = EXCHANGE_SEGMENTS + ("total",)
    out = {"batch0": dict(zip(names, seg[:, 0].mean(dim=0).tolist()))}
    rest = seg[:, 1:].reshape(-1, len(names))
    if rest.shape[0]:
        out["median_rest"] = dict(zip(names, rest.median(dim=0).values.tolist()))
        out["max_rest"] = dict(zip(names, rest.max(dim=0).values.tolist()))
    return out


@_counted
def resolve_many(pivots, grid, count, bmax, floor, bounds, rb, re, wb, we, t_snap, t_has_reads, vers,
                 S2: int, phase_ns: torch.Tensor | None = None):
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
    kernels. ``phase_ns`` (int64 [G, len(SCAN_PHASES) + 1] on the card,
    None on every path of the system) receives the per-phase timer's
    stamps (``scan_phase_ms``)."""
    *lead, B, S, Lp1 = grid.shape
    P = lead[0] if lead else 1
    L = Lp1 - 1
    G, T, KR, _ = rb.shape
    KW = wb.shape[2]
    if bool(lead) != (bounds is not None):
        raise ValueError("the scan takes partition bounds with a stacked state, and none with one grid")
    bounds = tuple(bounds or ())
    timer = () if phase_ns is None else (phase_ns,)
    dev = _device(pivots, grid, count, bmax, floor, *bounds, rb, re, wb, we, t_snap, t_has_reads, vers, *timer)
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
    if phase_ns is not None:
        _check(phase_ns, "phase_ns", torch.int64, (G, len(SCAN_PHASES) + 1))
    plan = _plan_on(dev, G, T, KR, KW, L, P, B, S, S2)
    scratch = torch.empty(plan.words, dtype=_I32, device=dev)
    pieces = _scratch_pieces(scratch, plan)
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
        None if phase_ns is None else _ptr(phase_ns),
        G, P, B, S, L, T, KR, KW, B1, B2, *plan.overlap, S2, plan.U, plan.n2pad, plan.tile, plan.smem, plan.blocks,
    )
    resolve_many.launches += 1
    return verdicts, pressures, gmax


MAX_CARD_ENTRIES = 32  # entries of a spread on one card (csrc/scan.cu kMaxEntries)
MAX_CARDS = 32  # cards of a spread's exchange (csrc/scan.cu kMaxCards)


class ExchangeLayout(NamedTuple):
    """Each card's inbox in the exchange of a spread over ``cards`` cards:
    for each launch parity, batch and sending card a slot of ``words``
    64-bit words, each (the sending launch's epoch << 32 | 32 bits of its
    H), transaction 32 w + b at bit b of word w (``exchange_words``)."""

    cards: int
    slots: int  # batches a parity (a group's G at most)
    words: int  # 64-bit words of one slot: ceil(T / 32), padded to 16 bytes
    inbox: int  # 64-bit words of one card's inbox: [2, slots, cards, words]

    def slot(self, parity: int, g: int, sender: int) -> int:
        """The offset (64-bit words) in an inbox of the slot in which card
        ``sender`` puts batch ``g``'s bits in a launch of ``parity``."""
        return ((parity * self.slots + g) * self.cards + sender) * self.words


def exchange_layout(n_cards: int, G: int, T: int) -> ExchangeLayout:
    """The inboxes for groups of up to G batches of T transactions over
    ``n_cards`` cards."""
    words = -(-(-(-T // 32)) // 2) * 2
    return ExchangeLayout(n_cards, G, words, 2 * G * n_cards * words)


def exchange_words(epoch: int, H: torch.Tensor) -> torch.Tensor:
    """A card's slot as its launch publishes it (the plain version of the
    kernel's pack): H's bits (bool [T]) 32 to a word, each word (epoch << 32
    | bits) as int64 [ceil(T / 32)]."""
    T = H.shape[0]
    W = -(-T // 32)
    bits = torch.zeros(32 * W, dtype=torch.int64)
    bits[:T] = H.to(torch.int64)
    word = (bits.view(W, 32) << torch.arange(32, dtype=torch.int64)).sum(dim=1)
    return word | (int(epoch) << 32)


def exchange_bits(words: torch.Tensor, epoch: int, T: int) -> torch.Tensor | None:
    """A slot read back (the plain version of the kernel's poll and unpack):
    the T bits (bool [T]) of its first ceil(T / 32) words, or None where a
    word does not carry ``epoch`` (not published yet in that launch)."""
    w = words[: -(-T // 32)].to(torch.int64)
    if not bool(((w >> 32) == int(epoch)).all()):
        return None
    bits = ((w & 0xFFFFFFFF)[:, None] >> torch.arange(32, dtype=torch.int64)) & 1
    return bits.reshape(-1)[:T].bool()


class SpreadPlan(NamedTuple):
    """How a spread's entries go through one group (``spread_plan``)."""

    cards: tuple  # the distinct cards (or card ids) in entry order; card 0 holds entry 0
    tables: tuple  # for each card, the spread's entries on it in order: its launch's entry table
    rows: tuple  # for each card, (position in its table, row) of each replica-0 entry: the rows whose pressures it gives
    exchange: ExchangeLayout | None  # None on one card


def spread_plan(cards: list, n_data: int, G: int, T: int) -> SpreadPlan:
    """The launches of a group over a spread whose entries lie on ``cards``
    (one item an entry: a device, or any id of the card the entry's launch
    runs on), ``n_data`` replicas a row (entry i is replica i % n_data of
    row i // n_data): one launch a distinct card, its entry table, the rows
    of the pressures [G, P, 2] its replica-0 entries give, and the inboxes
    of the exchange where there is more than one card. Runs without a
    card."""
    if not cards or len(cards) % n_data:
        raise ValueError(f"{len(cards)} entries do not make rows of {n_data} replicas")
    order = list(dict.fromkeys(cards))
    tables = [[i for i, c in enumerate(cards) if c == card] for card in order]
    if max(map(len, tables)) > MAX_CARD_ENTRIES:
        raise ValueError(f"{max(map(len, tables))} entries on one card: the scan takes {MAX_CARD_ENTRIES}")
    if len(order) > MAX_CARDS:
        raise ValueError(f"{len(order)} cards: the exchange takes {MAX_CARDS}")
    rows = tuple(tuple((pos, i // n_data) for pos, i in enumerate(table) if i % n_data == 0) for table in tables)
    layout = exchange_layout(len(order), G, T) if len(order) > 1 else None
    return SpreadPlan(tuple(order), tuple(map(tuple, tables)), rows, layout)


TRANSPORTS = ("peer", "host")


def exchange_transport(peer) -> str | None:
    """The exchange's route for a spread whose cards reach each other as
    ``peer`` says (``peer[i][j]``: card i can store into card j's memory;
    the diagonal is not read): each card's inbox in its own memory, stored
    into over NVLink, where every ordered pair of distinct cards can
    ("peer"), else one buffer of mapped host memory ("host"); None for one
    card, which exchanges nothing."""
    n = len(peer)
    if n < 2:
        return None
    return "peer" if all(peer[i][j] for i in range(n) for j in range(n) if i != j) else "host"


def peer_matrix(devices: list) -> list:
    """``exchange_transport``'s matrix for the cards ``devices`` (a list
    that may name a card twice, as the one-card plans of the tests do: a
    card reaches its own memory), from cudaDeviceCanAccessPeer."""
    out = []
    for a in devices:
        row = []
        for b in devices:
            can = ctypes.c_int(1)
            if a != b:
                with torch.cuda.device(a):
                    _run("fdb_peer_access", b.index, 0, ctypes.byref(can))
            row.append(bool(can.value))
        out.append(row)
    return out


def _card(d) -> torch.device:
    """``d`` as a card with its index (``cuda`` alone: the current one)."""
    d = torch.device(d)
    return torch.device("cuda", torch.cuda.current_device()) if d.index is None else d


class SpreadExchange:
    """The inboxes through which the cards of one spread exchange H inside
    their launches, and the spread's launch counter (the epoch a launch
    marks its words with, so an earlier launch's word is never read as this
    one's). ``devices`` is each card of the spread's plan, in its order (a
    card may appear twice: two launches on one card). The transport is
    chosen once, here, from the cards' peer matrix (``exchange_transport``)
    unless ``transport`` names one: "peer" enables peer access between
    every pair of distinct cards (already enabled counts) and puts each
    inbox in its own card's memory; "host" puts them in one buffer of
    mapped, pinned host memory. Asking for "peer" where a pair refuses it
    raises. Inboxes too small for a group are replaced, and kept until
    ``close``, since launches in flight may still use them."""

    def __init__(self, devices: list, transport: str | None = None):
        self.devices = [_card(d) for d in devices]
        chosen = exchange_transport(peer_matrix(self.devices))
        if transport is None:
            transport = chosen
        if transport not in TRANSPORTS or (transport == "peer" and chosen != "peer"):
            raise ValueError(f"transport {transport!r} over {[str(d) for d in self.devices]} "
                             f"(their peer access gives {chosen!r})")
        if transport == "peer":
            can = ctypes.c_int()
            for a in dict.fromkeys(self.devices):
                for b in dict.fromkeys(self.devices):
                    if a != b:
                        with torch.cuda.device(a):
                            _run("fdb_peer_access", b.index, 1, ctypes.byref(can))
        self.transport = transport
        self.epoch = 0
        self.layout: ExchangeLayout | None = None
        self.inboxes: list | None = None  # each card's inbox address
        self._buffers: list = []  # (device or None for host memory, address), the current ones last

    def reserve(self, layout: ExchangeLayout) -> list:
        """Each card's inbox address, large enough for ``layout`` (zeroed
        when new)."""
        if layout.cards != len(self.devices):
            raise ValueError(f"the exchange holds {len(self.devices)} cards, the plan {layout.cards}")
        cur = self.layout
        if cur is None or cur.slots < layout.slots or cur.words < layout.words:
            if cur is not None:  # grown, never shrunk
                layout = exchange_layout(layout.cards, max(layout.slots, cur.slots), 32 * max(layout.words, cur.words))
            nbytes = 8 * layout.inbox
            out = ctypes.c_void_p()
            if self.transport == "host":
                _run("fdb_host_alloc", ctypes.c_longlong(nbytes * layout.cards), ctypes.byref(out))
                self._buffers.append((None, out.value))
                self.inboxes = [out.value + c * nbytes for c in range(layout.cards)]
            else:
                self.inboxes = []
                for dev in self.devices:
                    with torch.cuda.device(dev):
                        _run("fdb_dev_alloc", ctypes.c_longlong(nbytes), ctypes.byref(out))
                    self._buffers.append((dev, out.value))
                    self.inboxes.append(out.value)
            self.layout = layout
        return self.inboxes

    def next_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def inbox(self, c: int) -> torch.Tensor:
        """A copy of card ``c``'s inbox (int64 [2, slots, cards, words] on the
        CPU), once the launches that write it are done."""
        lay = self.layout
        out = torch.empty((2, lay.slots, lay.cards, lay.words), dtype=torch.int64)
        with torch.cuda.device(self.devices[c]):
            _run("fdb_copy", ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(self.inboxes[c]),
                 ctypes.c_longlong(8 * lay.inbox))
        return out

    def close(self) -> None:
        """Wait for every launch of the spread's cards, then free the
        inboxes."""
        if not self._buffers:
            return
        for dev in dict.fromkeys(self.devices):
            torch.cuda.synchronize(dev)
        for dev, ptr in self._buffers:
            if dev is None:
                _run("fdb_host_free", ctypes.c_void_p(ptr))
            else:
                with torch.cuda.device(dev):
                    _run("fdb_dev_free", ctypes.c_void_p(ptr))
        self._buffers, self.inboxes, self.layout = [], None, None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the process's memory goes with it
            pass


class SpreadLaunch(NamedTuple):
    """One card's launch of ``resolve_many_spread``: its outputs, on the card."""

    verdicts: torch.Tensor  # int8 [G, T]
    pressures: torch.Tensor  # int32 [E, G, P, 2]: every entry of the card's table
    status: torch.Tensor  # int32 [1]: 1 where another card's H did not come in time


class _Checked(NamedTuple):
    """One card's launch after its checks: its device, entries and dims."""

    dev: torch.device
    ents: list
    rds: list
    dims: tuple  # G, T, KR, KW, L, P, B, S, KRe


def _spread_check(plan: SpreadPlan, c: int, entries: list, reads: list, batch, vers,
                  exchange: SpreadExchange | None, epoch: int, timeout_s, phase_ns) -> _Checked:
    """Every check of card ``c``'s launch (devices, dtypes, shapes, the
    exchange's arguments), before anything of any card is allocated."""
    table = plan.tables[c]
    ents = [entries[i] for i in table]
    rds = [reads[i] for i in table]
    rb, re, wb, we, t_snap, t_has_reads = batch
    G, T, KR, L = rb.shape
    KW = wb.shape[2]
    P, B, S, Lp1 = ents[0][1].shape
    KRe = rds[0][0].shape[2]
    timer = () if phase_ns is None else (phase_ns,)
    dev = _device(*(x for e in ents for x in e), *(x for r in rds for x in r), *batch, vers, *timer)
    if Lp1 - 1 != L:
        raise ValueError(f"the state has {Lp1 - 1} lanes, the batch {L}")
    for e, (rbe, ree) in zip(ents, rds):
        pivots, grid, count, bmax, floor, plo, phi = e
        _check(pivots, "pivots", _I32, (P, B, L))
        _check(grid, "grid", _I32, (P, B, S, Lp1))
        for name, t in (("count", count), ("bmax", bmax), ("floor", floor)):
            _check(t, name, _I32, (P, B))
        for name, t in (("plo", plo), ("phi", phi)):
            _check(t, name, _I32, (P, L))
        for name, t in (("read slice rb", rbe), ("read slice re", ree)):
            _check(t, name, _I32, (G, T, KRe, L))
    for name, t in (("rb", rb), ("re", re)):
        _check(t, name, _I32, (G, T, KR, L))
    for name, t in (("wb", wb), ("we", we)):
        _check(t, name, _I32, (G, T, KW, L))
    _check(t_snap, "t_snap", _I32, (G, T))
    _check(t_has_reads, "t_has_reads", torch.bool, (G, T))
    _check(vers, "vers", _I32, (3, G))
    if phase_ns is not None:
        _check(phase_ns, "phase_ns", torch.int64, (G, SPREAD_STAMPS))
    if plan.exchange is not None:
        if exchange is None or epoch < 1 or timeout_s is None:
            raise ValueError("a spread over several cards exchanges H through a SpreadExchange, epoch >= 1, "
                             "with the bound of its wait, timeout_s")
        if len(exchange.devices) != len(plan.cards) or exchange.devices[c] != dev:
            raise ValueError(f"card {c} of the plan runs on {dev}; the exchange was built for "
                             f"{[str(d) for d in exchange.devices]}")
    return _Checked(dev, ents, rds, (G, T, KR, KW, L, P, B, S, KRe))


class _Prepared(NamedTuple):
    """One card's launch, ready to issue: its outputs and its arguments."""

    out: SpreadLaunch
    args: object  # the launch's kernel arguments (fdb_spread_prepare's output)
    device: int
    smem: int
    blocks: int
    stream: int
    scratch: torch.Tensor  # held until the launch is issued


_args_bytes: list = []  # sizeof the kernel's arguments, asked once


def _spread_prepare(plan: SpreadPlan, c: int, checked: _Checked, batch, vers, S2: int, inboxes,
                    epoch: int, timeout_s, phase_ns) -> _Prepared:
    """Card ``c``'s plan, scratch, outputs and kernel arguments (checked by
    the C side too), on the card's current stream."""
    dev, ents, rds = checked.dev, checked.ents, checked.rds
    G, T, KR, KW, L, P, B, S, KRe = checked.dims
    rb, re, wb, we, t_snap, t_has_reads = batch
    plan_c = _plan_on(dev, G, T, KR, KW, L, P, B, S, S2, entries=len(ents))
    table_ptrs = (ctypes.c_void_p * (9 * len(ents)))(*(t.data_ptr() for e, r in zip(ents, rds) for t in (*e, *r)))
    B1, B2 = split_factors(B)
    R, NS = plan_c.overlap
    layout = plan.exchange
    if not _args_bytes:
        _args_bytes.append(build.load()["fdb_spread_args_bytes"]())
    args = (ctypes.c_uint64 * -(-_args_bytes[0] // 8))()
    st = torch.cuda.current_stream(dev)
    # scratch and outputs allocated on the launch's stream, so the caching
    # allocator hands the scratch to no other stream's work before the
    # launch is done with it
    with torch.cuda.device(dev), torch.cuda.stream(st):
        scratch = torch.empty(plan_c.words, dtype=_I32, device=dev)
        pieces = (ctypes.c_void_p * len(SCAN_PIECES))(*(p.value if p is not None else None
                                                         for p in _scratch_pieces(scratch, plan_c)))
        out = SpreadLaunch(torch.empty((G, T), dtype=torch.int8, device=dev),
                           torch.empty((len(ents), G, P, 2), dtype=_I32, device=dev),
                           torch.empty(1, dtype=_I32, device=dev))
        _run("fdb_spread_prepare",
             table_ptrs, len(ents), _ptr(rb), _ptr(re), _ptr(wb), _ptr(we), _ptr(t_snap), _ptr(t_has_reads),
             _ptr(vers), _ptr(out.verdicts), _ptr(out.pressures), None, pieces,
             ctypes.c_longlong(plan_c.entry_words), None if phase_ns is None else _ptr(phase_ns),
             None if layout is None else (ctypes.c_void_p * len(inboxes))(*inboxes), _ptr(out.status),
             ctypes.c_longlong(int((timeout_s or 0.0) * 1e9)), c, len(plan.cards), int(epoch),
             0 if layout is None else layout.slots, 0 if layout is None else layout.words,
             G, P, B, S, L, T, KR, KRe, KW, B1, B2, R, NS, S2, plan_c.U, plan_c.n2pad, plan_c.tile,
             plan_c.smem, plan_c.blocks, ctypes.byref(args))
    return _Prepared(out, args, dev.index, plan_c.smem, plan_c.blocks, st.cuda_stream, scratch)


# Held while one spread's launches are issued: a launch waits inside the
# card for the other cards' launches of its spread, so two spreads queued on
# two shared cards in opposite orders (A, B on one; B, A on the other) would
# each wait for a launch queued behind the other's until the bound. Under
# the lock every spread's launches reach all its cards before the next
# spread's. Each card takes them on one stream, the issuing thread's
# current one (every thread's is the card's default stream unless it sets
# another), so a card's queue order is the issue order.
_SPREAD_LAUNCH_LOCK = threading.Lock()


def _spread_issue(prepared: list) -> None:
    """The prepared launches issued back to back, in one C call, under the
    process's spread lock (held for the issue only: the launches run and
    are collected without it)."""
    n = len(prepared)
    args = ((ctypes.c_void_p * n)(*(ctypes.addressof(p.args) for p in prepared)),
            (ctypes.c_int * n)(*(p.device for p in prepared)), (ctypes.c_int * n)(*(p.smem for p in prepared)),
            (ctypes.c_int * n)(*(p.blocks for p in prepared)), (ctypes.c_void_p * n)(*(p.stream for p in prepared)))
    with _SPREAD_LAUNCH_LOCK:
        _run("fdb_spread_launch", n, *args)
        resolve_many_spread.launches += n


def _spread_launches(plan: SpreadPlan, cards: list, entries: list, reads: list, batches: list, vers: list,
                     S2: int, exchange: SpreadExchange | None, epoch: int, timeout_s, timers: list) -> list:
    """The launches of the plan's ``cards`` (card ``cards[i]`` takes
    ``batches[i]``, ``vers[i]`` and ``timers[i]``): every card's checks,
    then every card's preparation, then every launch issued together."""
    checked = [_spread_check(plan, c, entries, reads, b, v, exchange, epoch, timeout_s, t)
               for c, b, v, t in zip(cards, batches, vers, timers)]
    inboxes = exchange.reserve(plan.exchange) if plan.exchange is not None else None
    prepared = [_spread_prepare(plan, c, k, b, v, S2, inboxes, epoch, timeout_s, t)
                for c, k, b, v, t in zip(cards, checked, batches, vers, timers)]
    _spread_issue(prepared)
    return [p.out for p in prepared]


def spread_launch(plan: SpreadPlan, c: int, entries: list, reads: list, batch, vers, S2: int,
                  exchange: SpreadExchange | None = None, epoch: int = 0,
                  timeout_s: float | None = None, phase_ns: torch.Tensor | None = None) -> SpreadLaunch:
    """Launch card ``c`` of ``plan`` alone (its entries' states and bounds
    ``entries[i]`` = (pivots, grid, count, bmax, floor, plo, phi), each a
    stack [P, B, ...], and read slots ``reads[i]`` = (rb, re) [G, T, KRe, L]
    for each entry i of its table; ``batch`` = (rb, re, wb, we, t_snap,
    t_has_reads) the whole group; ``vers`` int32 [3, G]) on its card's
    current stream, on the card's co-resident grid. Where the plan has
    more than one card, its H goes through ``exchange`` under ``epoch``
    with the bounded wait ``timeout_s`` (seconds; the caller's dispatch
    deadline); the launch's ``status`` says whether it ran out."""
    return _spread_launches(plan, [c], entries, reads, [batch], [vers], S2, exchange, epoch, timeout_s,
                            [phase_ns])[0]


@_counted
def resolve_many_spread(plan: SpreadPlan, entries: list, reads: list, batches: list, vers: list, S2: int,
                        exchange: SpreadExchange | None = None, timeout_s: float | None = None,
                        phase_ns: list | None = None) -> list:
    """The group scan over every entry of a spread: ONE cooperative launch
    on each card of ``plan`` (``spread_plan``; ``batches[c]`` and
    ``vers[c]`` that card's copy of the group and its versions, as
    ``spread_launch`` takes them), each on its card's current stream: every
    card's launch checked and prepared before any is issued, then all
    issued back to back in one C call, the cards' H exchanged inside the
    launches (each waiting at most ``timeout_s`` for another card's).
    Updates every entry's state IN PLACE. Returns each card's
    ``SpreadLaunch``; a launch whose ``status`` is set gave no verdicts
    (``check_spread_status`` raises). ``phase_ns`` (one int64 [G,
    SPREAD_STAMPS] tensor a card, on that card, or None) times each card's
    launch (``scan_phase_ms``, ``exchange_split``). Nothing falls back to
    the per-batch kernels."""
    epoch = exchange.next_epoch() if plan.exchange is not None and exchange is not None else 0
    cards = range(len(plan.cards))
    return _spread_launches(plan, list(cards), entries, reads, batches, vers, S2, exchange, epoch, timeout_s,
                            phase_ns or [None] * len(cards))


class ExchangeTimeoutError(KernelTimeoutError):
    """A card of a spread waited past its bound for another card's H
    inside ``resolve_many_spread``: a card is missing or stalled. A kernel
    fault (the guard fails over), never a hang."""


def check_spread_status(status) -> None:
    """Raise ``ExchangeTimeoutError`` where a launch's status (``SpreadLaunch
    .status`` of each card, read back once the launches are done) is set."""
    late = [i for i, v in enumerate(torch.as_tensor(status).reshape(-1).tolist()) if v]
    if late:
        raise ExchangeTimeoutError(f"resolve_many_spread: cards {late} of the spread waited past "
                                   f"their bound for another card's H")


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
    "resolve_many_spread": resolve_many_spread,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
