#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Drives the resolver's conflict check through the port's entry point,
``new_conflict_set("torch", key_width=12, capacity=1<<19)``, at the size of
``bench.py`` (200 batches × 2500 transactions, one read and one write range
each over a 1M-key keyspace, a 50-batch MVCC window, groups of 40 batches
with 3 groups in flight; a 32768 × 32 × 4 uint32 grid = 16 MiB on the
card). Phases, each of which raises on failure:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the CUDA kernels from ``foundationdb_tpu_torch/conflict/kernels/csrc``;
3. run the first group on a warm-up instance (its state after that group is
   the kernel checks' input), and the whole workload through the plain
   PyTorch path on the CPU and through the port's oracle;
4. run the main path on the card with every kernel launch count set to 0
   just before it; versions start just below 2^30, so the run crosses the
   int32 rebase threshold as a long-running cluster does (K4b), and one
   device reshard is forced between groups (K4a). Every verdict must equal
   the CPU path's and the oracle's, and every kernel must have launched.
   Then 10 more batches under ``torch.profiler``: one line of CUDA kernels
   launched per batch and the encode / glue dispatch / kernel time split;
5. hold each kernel against its plain version on the card at the main
   path's shapes (exact equality: outputs are integers and bools), time
   both with CUDA events (the table's ``ms`` and ``plain_ms``) and the
   kernel's device time too (``device_ms``: the calls queued behind a
   sleeping kernel, so the host's launch gaps drop out): K1, then K1 once
   more with every read of the batch keyspace-wide (the stress case), K2
   from the codes, the K3 staging launch, the K3 merge launch with the
   floor raise, K4a, K4b; then the merge launch once more when a single
   committed clear spans the whole keyspace;
6. after phases 7 to 9: print the kernel table (every kernel of the three
   paths), the card line and the result line;
7. the partitioned resolver, ``new_conflict_set("torch_mesh", key_width=12,
   capacity=1<<19, n_parts=4)`` (4 partitions × 8192 × 32 × 4 uint32 =
   16 MiB), over the same workload with every key re-encoded
   order-preservingly so its first lane is uniform over 2^32 (the ASCII
   keys would all land in partition 0): every verdict must equal the
   oracle's from phase 3; versions cross the int32 rebase; one partition
   reshard is forced between groups; every partition must hold live rows;
   then its kernels (K6 history, also on keyspace-wide reads, staging and
   merge over partitions, K7 reshard and rebase over partitions) are held
   against their plain versions, and its profile line is printed;
8. the storage range index at ``bench.py``'s shape: 1M random 12-byte
   keys at width 32 (2^20 × 8 lanes = 32 MiB of codes on the card), 50
   rounds of 4096 lookups (70 % hits) and 4096 range queries, every answer
   equal to host ``bisect``, and a delta of 1K adds and 1K removes equal to
   a rebuild; then K5 is held against its plain version;
9. the "limits" phase: the shapes the card path takes past the bench's.
   At key widths 32 and 128, batches whose transactions have up to 100
   reads and 40 writes, and one of 130 writes, through one grid and through
   four partitions, every verdict equal to the oracle and to the same
   backend's plain path on the CPU; K1, K6 history and K2 on those states;
   K2 at the read and write slot counts it stages in chunks; the staging of
   2^23 endpoint rows; the range index at width 128 against ``bisect``.
   Every kernel is held against its plain version; one JSON line each;
10. the resolver role, ``server/resolver.py`` over the guarded conflict
   set, on a RealLoop with all 200 requests of the main workload spawned
   at once (the proxies' pipelining): ``Resolver(backend="torch")`` and
   ``"torch_mesh"`` (4 partitions, the spread keys), each with
   CONFLICT_ENCODE_THREADS 1 and 0, every verdict equal to the oracle's
   from phase 3; versions step by 100,000 a batch, so the resolver's
   5,000,000-version MVCC window is the main phase's 50 batches, and they
   cross the int32 rebase. The guard must stay HEALTHY with no fault,
   failover or deadline hit, and at most one retry a rebase (the backends
   carry payloads across it). Then the port's ``native`` skip list
   through the same resolver on the card's host. One JSON line a run:
   txn/s, wall, the encode overlap, resolveLatency p50 / p99, the per-batch
   encode / dispatch / collect split and the guard's health;
11. the failover phase, through ``Resolver(backend="torch")`` with an
   explicit ``KernelFaultInjector``: 20 batches × 256 transactions one at
   a time with the device lost partway, then 31 batches spawned 0.1 s
   apart with a hang, a stall and a device loss among the dispatches. In
   both the guard must fail over to the port's ``NativeConflictSet`` (not
   the oracle), give the oracle's verdicts over the stream, commit nothing
   an oracle referee of the committed writes refuses, and promote back to
   the card once the loss heals; the pipelined case must also recover a
   deadline while later batches are in flight and re-resolve them in order.
   One JSON line a case.

Each path runs with every kernel launch count set to 0 just before it and
read just after, and every kernel of the path must have launched.

Exits non-zero, without a result line, when no CUDA card is visible.
Usage: ``python3 chip_smoke.py``; ``python3 chip_smoke.py --profile-only``
prints only the two resolver paths' profile lines (each path warmed by one
group first) and no result line, and runs from any checkout of the port;
``--history-only`` adds the history kernels of both paths on the bench batch
and on keyspace-wide reads (one JSON line), ``--reshard-only`` the reshard
entry point of both paths with its glue and ``--rebase-only`` the rebase
entry point of both paths with its glue beside a copy of the same grid (one
JSON line each), for comparisons of two checkouts in one call.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import random
import re
import subprocess
import sys
import time

import torch

N_BATCHES = 200
N_TXNS = 2500
KEYSPACE = 1_000_000
WINDOW = 50
GROUP = 40
DEPTH = 3
KEY_WIDTH = 12
CAPACITY = 1 << 19
INDEX_KEYS = 1_000_000  # bench.py bench_range_index
INDEX_BATCH = 4096
INDEX_ROUNDS = 50
PROFILE_BATCHES = 10  # the steady window of the per-batch launch and time split
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SCALAR_OPS_PER_S = 67e12  # H100 SXM, non-tensor-core rate (used for int ops)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ascii_key(n: int) -> bytes:
    return b"%08d" % n


def spread_key(n: int) -> bytes:
    """Key n re-encoded order-preservingly over the whole 64-bit range, so
    its first uint32 lane is uniform over 2^32 (n < KEYSPACE + 16)."""
    return (n * (2**64 // (KEYSPACE + 16))).to_bytes(8, "big")


def make_batches(n_batches: int, n_txns: int, offset: int, seed: int = 0, key=ascii_key):
    """The bench workload (bench.py make_batches): per transaction one read
    and one write range of 1-10 keys over a uniform 1M-key keyspace; batch
    i reads at snapshot offset + i. ``key`` maps a key number to bytes; any
    order-preserving map gives the same verdicts."""
    from foundationdb_tpu_torch.conflict.api import CommitTransaction

    rnd = random.Random(seed)
    batches = []
    for i in range(n_batches):
        txs = []
        for _ in range(n_txns):
            a = rnd.randrange(KEYSPACE)
            b = a + 1 + rnd.randrange(10)
            c = rnd.randrange(KEYSPACE)
            d = c + 1 + rnd.randrange(10)
            txs.append(
                CommitTransaction(
                    read_snapshot=offset + i,
                    read_conflict_ranges=[(key(a), key(b))],
                    write_conflict_ranges=[(key(c), key(d))],
                )
            )
        batches.append(txs)
    return batches


def drive(cs, batches, offset: int, force_at: int | None = None, force=None):
    """The resolver's pipeline over ``batches``: per group, prepare (which
    rebases the int32 version origin when due), encode, dispatch without
    waiting, keep DEPTH groups in flight; before group ``force_at`` drain
    the pipeline and call ``force(cs)``. Returns the verdict lists and the
    host seconds spent encoding."""
    handles, verdicts, encode_s = [], [], 0.0
    for gi, g in enumerate(range(0, len(batches), GROUP)):
        idx = range(g, min(g + GROUP, len(batches)))
        cs.prepare(max(offset + i + WINDOW for i in idx))
        if gi == force_at:
            cs._flush()
            force(cs)
        if len(handles) >= DEPTH:
            verdicts.extend(handles.pop(0)())
        t0 = time.perf_counter()
        work = [(cs.encode(batches[i]), offset + i + WINDOW, offset + i) for i in idx]
        encode_s += time.perf_counter() - t0
        handles.append(cs.detect_many_encoded_async(work))
    for h in handles:
        verdicts.extend(h())
    return verdicts, encode_s


# the port's kernels by their names in csrc/*.cu (greedy_commit, compact_live,
# build_buckets and search_both: K2, K4a/K7a and K5 before their redesigns,
# for profiles of older checkouts); every other kernel on the card is a
# torch op of the glue
PORT_KERNELS = re.compile(
    r"\b(superblock_max|history_kernel|build_overlap|greedy_chain|greedy_commit|stage_records"
    r"|stage_sort|stage_merge|stage_aggregate|merge_buckets|compact_live|build_buckets"
    r"|reshard_scan|reshard_build|rebase_kernel|search_both|search_warp)\b"
)


def profile_path(cs, batches, first: int, label: str, card: str) -> dict:
    """Launches and time per batch over a steady window: ``batches`` (read
    snapshots first, first + 1, ...) as one group through the warm
    resolver's encoded async path, under ``torch.profiler``. Host encode and
    the group's dispatch (torch glue and launches, enqueued without waiting)
    are timed on the host clock; kernel launches and kernel time are the
    profiler's CUDA kernel events, split into the port's kernels and
    torch's. The profiler's own overhead is inside the dispatch time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(batches)
    cs.prepare(first + n - 1 + WINDOW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    work = [(cs.encode(b), first + i + WINDOW, first + i) for i, b in enumerate(batches)]
    encode_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handle = cs.detect_many_encoded_async(work)
        dispatch_s = time.perf_counter() - t0
        handle()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError(f"{label}: the profiler recorded no device time")
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    kern = [e for e in dev if e not in copies]
    ours = [e for e in kern if PORT_KERNELS.search(e.name)]

    def busy_s(es):
        return sum(e.time_range.elapsed_us() for e in es) * 1e-6

    out = {
        "path": label, "batches": n,
        "kernels_per_batch": len(kern) / n,
        "port_kernels_per_batch": len(ours) / n,
        "torch_kernels_per_batch": (len(kern) - len(ours)) / n,
        "copies_per_batch": len(copies) / n,
        "encode_ms": encode_s / n * 1e3,
        "dispatch_ms": dispatch_s / n * 1e3,
        "kernel_ms": busy_s(kern) / n * 1e3,
        "port_kernel_ms": busy_s(ours) / n * 1e3,
        "window_ms": window_s / n * 1e3,
        "device_idle": 1.0 - busy_s(kern + copies) / window_s,
    }
    log(f"{label}, per batch over a steady window of {n} [{card}]: "
        f"{out['kernels_per_batch']:.1f} CUDA kernels launched ({out['port_kernels_per_batch']:.1f} "
        f"of the port's kernels, {out['torch_kernels_per_batch']:.1f} of torch's glue) and "
        f"{out['copies_per_batch']:.1f} copies; encode {out['encode_ms']:.3f} ms, glue dispatch "
        f"{out['dispatch_ms']:.3f} ms, kernel time {out['kernel_ms']:.4f} ms (the port's kernels "
        f"{out['port_kernel_ms']:.4f} ms); device idle {out['device_idle']:.4f} of the "
        f"{out['window_ms']:.3f} ms dispatch-to-verdicts window")
    log(f"{label} profile: " + json.dumps(out))
    return out


def kernel_ms(fn, reps: int) -> tuple[float | None, float, dict]:
    """A kernel wrapper's time per call, twice: between CUDA events around
    ``reps`` calls (the timer of every row; it also counts the stream's
    idle gaps while the host runs the wrapper, as the plain versions'
    times do), and its device time (``queued_ms``); and, for the log only,
    the ``torch.profiler`` device time of each kernel it launches by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    events_ms = cuda_ms(fn, reps)
    device_ms = queued_ms(fn, reps, events_ms)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy"):
            key = PORT_KERNELS.search(e.name)
            key = key.group(1) if key else e.name.split("(")[0][:40]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return device_ms, events_ms, by_name


def queued_ms(fn, reps: int, host_ms: float) -> float | None:
    """Device time per call: CUDA events around ``reps`` calls that the
    host enqueues while a sleeping kernel holds the stream, so the calls
    run back to back and the host's time between launches drops out. None
    if the sleep ended before the host had enqueued every call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_ms = 2 * host_ms * reps + 1
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(sleep_ms * 2e6))  # cycles, at <= 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        sleep_ms *= 4
    return None


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_abs_err(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long().cpu() - b.long().cpu()).abs().max()) if a.numel() else 0


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


CELL = 4  # bytes of one int32 lane or word


def binary_search_rows(piv, pts, strict: bool):
    """The pivot rows a binary search for #pivots <= point (< if
    ``strict``) probes: ⌈log2 B⌉ steps over the counts [1, B], as pivot 0
    (the all-zero code) lies below every active range's ends."""
    from foundationdb_tpu_torch.conflict import grid as G

    B = piv.shape[0]
    lo = torch.ones(pts.shape[0], dtype=torch.long, device=pts.device)
    hi = torch.full_like(lo, B)
    cmp = G.lex_lt if strict else G.lex_le
    probed = []
    for _ in range(max(1, (B - 1).bit_length())):
        mid = (lo + hi + 1) // 2
        probed.append(mid - 1)
        below = cmp(piv[mid - 1], pts)
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid - 1)
    return torch.cat(probed)


def history_work(state, rb, re) -> tuple[int, int]:
    """(bytes, int ops) the history check of ranges [rb, re) needs on one
    grid beyond the batch itself, whatever the kernel's form: the distinct
    pivot rows a binary search of each end probes, each bucket window it
    touches once (with its count and floor), and the bmax words of the
    buckets strictly between a range's ends, each once. Ops: ⌈log2 B⌉
    L-lane compares per end, two per window row, a max per between word."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.device import ordered

    B, S, Lp1 = state.grid.shape
    L = Lp1 - 1
    a = ordered(rb.reshape(-1, L))
    e = ordered(re.reshape(-1, L))
    act = G.lex_lt(a, e)
    piv = ordered(state.pivots)
    a, e = a[act], e[act]
    ba = G._rank(a, piv, strict=False)
    be = G._rank(e, piv, strict=True)
    n_act = int(act.sum())
    windows = torch.unique(torch.cat([ba.clamp(min=0), be[be > ba]])).numel()
    probed = torch.cat([binary_search_rows(piv, a, False), binary_search_rows(piv, e, True)])
    rows = torch.unique(probed).numel()
    # distinct buckets strictly between the ends: a difference array over B
    inner = be - ba > 1
    marks = torch.zeros(B + 1, dtype=torch.int32, device=piv.device)
    marks.index_add_(0, (ba[inner] + 1), torch.ones_like(ba[inner], dtype=torch.int32))
    marks.index_add_(0, be[inner], -torch.ones_like(be[inner], dtype=torch.int32))
    between = int((marks.cumsum(0) > 0).sum())
    nbytes = (rows * L + windows * (S * Lp1 + 2) + between) * CELL
    ops = probed.numel() * L + n_act * 2 * S * L * 2 + between
    return nbytes, ops


def merge_work(state, after, st, n_parts: int) -> tuple[int, int]:
    """(bytes, int ops) of the per-bucket merge and the floor raise: per
    touched bucket its live rows read, max(old, new count) rows written,
    S2 staged rows, tid/carry/count/floor read, count/bmax/floor written;
    floor and bmax read and written in each spanned bucket; one pressure
    word per partition; a comparison sort of S + S2 rows (M log2 M
    compares of L lanes) and a few scans per bucket. ``state``/``after``
    are the grid before and after (the flat view of a stacked grid), ``st``
    the staging."""
    from foundationdb_tpu_torch.conflict import grid as G

    B, S, Lp1 = state.grid.shape
    L = Lp1 - 1
    live = st.tid < B
    U = int(live.sum())
    S2 = st.st_ev.shape[1]
    M = S + S2
    touched = st.tid[live].long()
    old_n, new_n = state.count[touched], after.count[touched]
    row_io = int(old_n.sum()) + int(torch.maximum(old_n, new_n).sum())
    spanned = int(G.spanned_buckets(st, B, n_parts).sum())
    nbytes = (row_io * Lp1 + U * (S2 * (L + 1) + 7) + 4 * spanned + n_parts) * CELL
    return nbytes, U * (M * math.ceil(math.log2(M)) * L + M * 8) + 2 * spanned


def intra_batch_work(T: int, KR: int, KW: int, L: int) -> tuple[int, int]:
    """(bytes, int ops) of K2 from codes: the four code planes and H in,
    the commit flags out; one lane compare per lane of the two lex
    compares of every (read, earlier write) pair."""
    nbytes = 2 * T * (KR + KW) * L * CELL + 2 * T
    return nbytes, T * (T - 1) // 2 * KR * KW * 2 * L


def stage_work(sk, T: int, KW: int, L: int, B: int, P: int) -> tuple[int, int]:
    """(bytes, int ops) of the staging: the write codes and commit flags
    in, the pivot rows the binary searches probe (at most all), the staging
    planes, touched ids, carries and pressure out; a comparison sort of
    the rows (n log2 n compares of L + 1 words) and the searches."""
    U, S2, _ = sk.st_code.shape
    n = P * 2 * T * KW
    n_valid = int((sk.tid < P * B).sum())  # touched buckets: a floor on valid rows
    probes = n * max(1, math.ceil(math.log2(B)))
    nbytes = (n * L + T // 4 + min(P * B * L, probes * L) + U * S2 * (L + 1) + 2 * U + P) * CELL
    ops = n * max(1, math.ceil(math.log2(max(n, 2)))) * (L + 1) + probes * L + n_valid
    return nbytes, ops


def merge_case(state, st, vers, n_parts: int, reps: int = 20):
    """The merge launch (with its floor raise) against its plain version,
    each on fresh clones of ``state`` since both update it in place:
    (max abs err, kernel_ms's timing, plain ms, the kernel's state after)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels

    now, _, old_post = vers

    def launch(s):
        args = (s.grid, s.count, s.bmax, s.floor, *st[:4], now, old_post)
        return kernels.merge(*args) if n_parts == 1 else kernels.merge_parts(*args, n_parts)

    ks, ps = G.clone_state(state), G.clone_state(state)
    mk = launch(ks)
    mp = G.merge_staged_plain(ps, st, now, old_post, n_parts)
    err = max_abs_err((*ks[1:], mk), (*ps[1:], mp))
    it = iter([G.clone_state(state) for _ in range(5 * reps + 2)])  # as many as kernel_ms may call
    timed = kernel_ms(lambda: launch(next(it)), reps)
    pit = iter([G.clone_state(state) for _ in range(5)])
    plain_ms = cuda_ms(lambda: G.merge_staged_plain(next(pit), st, now, old_post, n_parts), 3)
    return err, timed, plain_ms, ks


def row_maker(rows: list, launches: dict):
    """A function that checks one kernel's result, appends its row of the
    kernel table and logs it."""

    def row(name, source, replaces, err, timed, plain_ms, nbytes, ops):
        device_ms, ms, by_name = timed
        b_ms, b_by = bound(nbytes, ops)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max abs err {err})")
        rows.append({
            "name": name, "route": "cuda",
            "source": "foundationdb_tpu_torch/conflict/kernels/csrc/" + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        parts = ", ".join(f"{k} {v:.4f}" for k, v in by_name.items())
        log(f"  {name:19s} kernel {ms:.4f} ms (CUDA events; on the device {fmt_ms(device_ms)}; "
            f"profiler {parts})  plain {plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
            f"max_abs_err {err}")

    return row


def reshard_entry(states, label: str) -> dict:
    """The reshard entry point a resolver calls, its glue included:
    ``grid.reshard_device`` on one grid, ``sharded.reshard_parts`` on a
    stacked state, into the same bucket and slot counts; CUDA events around
    20 calls, and their device time. It calls only those entry points, so
    it measures any checkout of the port."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import sharded as SH

    if states.grid.dim() == 3:
        name, (B, S) = "grid.reshard_device", states.grid.shape[:2]

        def fn():
            return G.reshard_device(states, B, S)
    else:
        name, (B, S) = "sharded.reshard_parts", states.grid.shape[1:3]

        def fn():
            return SH.reshard_parts(states, B, S)
    ms = cuda_ms(fn, 20)
    out = {"path": label, "entry": name, "ms": ms, "device_ms": queued_ms(fn, 20, ms)}
    log(f"  {name}, glue included: {ms:.4f} ms (CUDA events; on the device "
        f"{fmt_ms(out['device_ms'])})")
    return out


def rebase_bytes(grid) -> int:
    """Bytes of the rebase: the whole grid read and written, count and
    floor read, bmax and floor written (B words each)."""
    n_buckets = grid.numel() // (grid.shape[-2] * grid.shape[-1])
    return (2 * grid.numel() + 4 * n_buckets) * CELL


def copy_yardstick(grid) -> dict:
    """The floor of any copy-shaped kernel on this card: one torch copy of
    the grid's bytes into a fresh tensor (not the rebase's function, so
    the table's library column stays null), on CUDA events and on the
    device."""

    def fn():
        return torch.empty_like(grid).copy_(grid)

    ms = cuda_ms(fn, 20)
    return {"copy_ms": ms, "copy_device_ms": queued_ms(fn, 20, ms)}


def rebase_entry(states, label: str) -> dict:
    """The rebase entry point a resolver calls, its glue included:
    ``grid.rebase`` on one grid, ``sharded.rebase_parts`` on a stacked
    state, by the same delta; CUDA events around 20 calls and their device
    time, beside the copy yardstick of the same grid. It calls only those
    entry points, so it measures any checkout of the port."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import sharded as SH

    delta = 1 << 20
    if states.grid.dim() == 3:
        name = "grid.rebase"

        def fn():
            return G.rebase(states, delta)
    else:
        name = "sharded.rebase_parts"

        def fn():
            return SH.rebase_parts(states, delta)
    ms = cuda_ms(fn, 20)
    out = {"path": label, "entry": name, "ms": ms, "device_ms": queued_ms(fn, 20, ms),
           **copy_yardstick(states.grid)}
    log(f"  {name}, glue included: {ms:.4f} ms (CUDA events; on the device "
        f"{fmt_ms(out['device_ms'])}); a copy of the grid {out['copy_ms']:.4f} ms (on the device "
        f"{fmt_ms(out['copy_device_ms'])})")
    return out


def wide_reads(batch):
    """``batch`` with every read range keyspace-wide: [the all-zero code,
    the all-0xFF code), so each spans every bucket of the grid."""
    return batch._replace(rb=torch.zeros_like(batch.rb), re=torch.full_like(batch.re, -1))


def check_history(state, batch, launches: dict, bounds=None) -> tuple[list[dict], list[dict]]:
    """K1 (``bounds`` None) or K6 history over the stacked ``state`` and its
    partition ``bounds`` (plo, phi) against the plain version, on ``batch``
    and on the same batch with every read keyspace-wide (the stress case):
    exact equality, timed both ways. Returns (the kernel-table row of the
    bench batch, both cases' numbers)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH

    T, KR, L = batch.rb.shape
    io = (2 * T * KR * L + T) * CELL + T  # the reads and snapshots in, the flags out
    if bounds is None:
        name, replaces = "history", "foundationdb_tpu/conflict/grid.py:210"

        def launch(b):
            return kernels.history(*state, b.rb, b.re, b.t_snap)

        def plain(b):
            return G.history_conflicts_plain(state, b)

        def work(b):
            return history_work(state, b.rb, b.re)
    else:
        name, replaces = "history_parts", "foundationdb_tpu/conflict/sharded.py:149"
        P = state.grid.shape[0]

        def launch(b):
            return kernels.history_parts(*state, *bounds, b.rb, b.re, b.t_snap)

        def plain(b):
            return SH.history_conflicts_sharded_plain(state, b, *bounds)

        def work(b):
            nbytes, ops = 2 * P * L * CELL, 0
            for p in range(P):
                rb, re = SH.clip(b.rb, b.re, bounds[0][p], bounds[1][p])
                nb, no = history_work(SH.partition(state, p), rb, re)
                nbytes, ops = nbytes + nb, ops + no
            return nbytes, ops

    rows, cases = [], []
    for case, b in (("bench", batch), ("keyspace-wide", wide_reads(batch))):
        err = max_abs_err(launch(b), plain(b))
        device_ms, ms, by_name = kernel_ms(lambda: launch(b), 50)
        plain_ms = cuda_ms(lambda: plain(b), 3)
        nbytes, ops = work(b)
        b_ms, b_by = bound(nbytes + io, ops)
        cases.append({"name": name, "case": case, "ms": ms, "device_ms": device_ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err})
        if case == "bench":
            row_maker(rows, launches)(name, "history.cu", replaces, err, (device_ms, ms, by_name),
                                      plain_ms, nbytes + io, ops)
        elif err != 0:
            raise AssertionError(f"{name} on keyspace-wide reads differs from its plain version ({err})")
        else:
            log(f"  {name}, {T} keyspace-wide reads: kernel {ms:.4f} ms (CUDA events; on the device "
                f"{fmt_ms(device_ms)})  plain {plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
                f"max_abs_err {err}")
    return rows, cases


def check_kernels(state, hbatch, vers, launches: dict) -> list[dict]:
    """Each kernel against its plain version on the card, on the state
    after the first group and the next bench batch. Exact equality; times
    from CUDA events (the 16 MiB grid stays resident in the 50 MB L2, as it
    does between the main path's batches)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import torch_backend as TB

    dev = state.grid.device
    now, old_pre, old_post = vers
    batch = TB.upload(hbatch, dev)
    B, S, Lp1 = state.grid.shape
    L = Lp1 - 1
    T, KR, _ = batch.rb.shape
    KW = batch.wb.shape[1]
    cell = CELL
    rows = []
    row = row_maker(rows, launches)

    # K1 history, on the bench batch and on keyspace-wide reads
    rows += check_history(state, batch, launches)[0]
    hk = kernels.history(*state, batch.rb, batch.re, batch.t_snap)

    # K2 intra-batch greedy commit: the kernel from the codes, the plain
    # version from dense endpoint ranks (which it computes)
    H = hk | (batch.t_has_reads & (batch.t_snap < old_pre))
    kargs = (batch.rb, batch.re, batch.wb, batch.we, H)
    ck = kernels.intra_batch(*kargs)
    cp = G.intra_batch_commits_plain(*G._endpoint_ranks(batch), H)
    nbytes, ops = intra_batch_work(T, KR, KW, L)
    row("intra_batch", "intra_batch.cu", "foundationdb_tpu/conflict/grid.py:297,337", max_abs_err(ck, cp),
        kernel_ms(lambda: kernels.intra_batch(*kargs), 20),
        cuda_ms(lambda: G.intra_batch_commits_plain(*G._endpoint_ranks(batch), H), 3),
        nbytes, ops)

    # K3 staging: the kernel against _stage_writes
    S2 = G.staging_slots(S)
    sargs = (batch.wb[None], batch.we[None], ck, state.pivots[None], S2)
    sk = G.Staged(*kernels.stage(*sargs))
    st = G._stage_writes(state, batch, ck)
    row("stage", "stage.cu", "foundationdb_tpu/conflict/grid.py:430", max_abs_err(tuple(sk), tuple(st)),
        kernel_ms(lambda: kernels.stage(*sargs), 20),
        cuda_ms(lambda: G._stage_writes(state, batch, ck), 3),
        *stage_work(sk, T, KW, L, B, 1))

    # K3 merge with the floor raise
    err, timed, plain_ms, ks = merge_case(state, st, vers, 1)
    row("merge", "merge.cu", "foundationdb_tpu/conflict/grid.py:526", err, timed, plain_ms,
        *merge_work(state, ks, st, 1))

    # the same launch when one committed clear spans the whole keyspace and
    # nothing else commits: two touched buckets, all others floor-raised
    wb, we = batch.wb.clone(), batch.we.clone()
    wb[0], we[0] = 0, -1  # [the all-zero code, the all-0xFF code)
    wide = torch.zeros_like(ck)
    wide[0] = True
    sw = G._stage_writes(state, batch._replace(wb=wb, we=we), wide)
    err, timed, plain_ms, _ = merge_case(state, sw, vers, 1)
    if err != 0:
        raise AssertionError(f"merge of a keyspace-wide clear differs from its plain version ({err})")
    log(f"  merge, one keyspace-wide clear ({int(G.spanned_buckets(sw, B).sum())} spanned buckets): "
        f"kernel {timed[1]:.4f} ms (CUDA events; on the device {fmt_ms(timed[0])})  plain {plain_ms:.4f} ms  "
        f"max_abs_err {err}")

    # K4a device reshard at the same grid shape
    N = B * S
    used = (torch.arange(S, device=dev)[None, :] < state.count[:, None]).reshape(N)
    rk = kernels.maint_reshard(state.grid, state.count, state.floor, B, S)
    rp_state, rp_press = G.reshard_device_plain(state, used, B, S)
    n_live = int(used.sum())
    # the live rows, count and floor read; the whole new grid, pivots,
    # count, bmax, floor and pressure written (a kernel's scratch is not
    # the function's)
    nbytes = (n_live * Lp1 + 2 * B + B * S * Lp1 + B * (L + 3) + 1) * cell
    row("maint_reshard", "maint.cu", "foundationdb_tpu/conflict/grid.py:718",
        max_abs_err(tuple(rk), tuple(rp_state) + (rp_press,)),
        kernel_ms(lambda: kernels.maint_reshard(state.grid, state.count, state.floor, B, S), 20),
        cuda_ms(lambda: G.reshard_device_plain(state, used, B, S), 3),
        nbytes, n_live * Lp1 + B * S)
    reshard_entry(state, "one grid")

    # K4b rebase: the whole grid read and written (every key lane is
    # copied), count and floor read, bmax and floor written
    delta = max(now // 2, 1)
    bk = kernels.maint_rebase(state.grid, state.count, state.floor, delta)
    bp = G.rebase_plain(state, delta)
    row("maint_rebase", "maint.cu", "foundationdb_tpu/conflict/grid.py:704",
        max_abs_err(bk, (bp.grid, bp.bmax, bp.floor)),
        kernel_ms(lambda: kernels.maint_rebase(state.grid, state.count, state.floor, delta), 20),
        cuda_ms(lambda: G.rebase_plain(state, delta), 5),
        rebase_bytes(state.grid), B * S * 3)
    rows[-1].update(copy_yardstick(state.grid))
    torch.cuda.synchronize()
    return rows


def check_partition_kernels(states, hbatch, vers, launches: dict) -> list[dict]:
    """K6 and K7 against their plain versions on the card, on the
    partitioned resolver's stacked state and a bench batch; exact
    equality, CUDA-event times."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.conflict import torch_backend as TB

    dev = states.grid.device
    now, old_pre, old_post = vers
    batch = TB.upload(hbatch, dev)
    P, B, S, Lp1 = states.grid.shape
    L = Lp1 - 1
    T = batch.rb.shape[0]
    plo, phi = SH.partition_bounds(L, P, dev)
    rows = []
    row = row_maker(rows, launches)

    # K6 history over the partitions, reads clipped in the kernel
    rows += check_history(states, batch, launches, (plo, phi))[0]
    hk = kernels.history_parts(*states, plo, phi, batch.rb, batch.re, batch.t_snap)

    # K6 staging of every partition's clipped writes in one launch
    commit = G.intra_batch_commits(batch, hk | (batch.t_has_reads & (batch.t_snap < old_pre)))
    wb, we = SH.clip(batch.wb, batch.we, plo[:, None, None, :], phi[:, None, None, :])
    sargs = (wb, we, commit, states.pivots, G.staging_slots(S))
    sk = G.Staged(*kernels.stage_parts(*sargs))
    st = SH._stage_clipped_plain(states, wb, we, commit)
    row("stage_parts", "stage.cu", "foundationdb_tpu/conflict/sharded.py:160", max_abs_err(tuple(sk), tuple(st)),
        kernel_ms(lambda: kernels.stage_parts(*sargs), 20),
        cuda_ms(lambda: SH._stage_clipped_plain(states, wb, we, commit), 3),
        *stage_work(sk, T, wb.shape[2], L, B, P))

    # K6 merge over the flat [P·B] view
    flat = SH.flat_view(states)
    err, timed, plain_ms, ks = merge_case(flat, st, vers, P)
    row("merge_parts", "merge.cu", "foundationdb_tpu/conflict/sharded.py:160", err, timed, plain_ms,
        *merge_work(flat, ks, st, P))

    # K7a reshard of every partition at its grid shape
    used = (torch.arange(S, device=dev) < states.count[..., None]).reshape(P, B * S)
    rk = kernels.maint_reshard_parts(states.grid, states.count, states.floor, B, S)
    rp_state, rp_press = SH.reshard_parts_plain(states, used, B, S)
    n_live = int(used.sum())
    nbytes = (n_live * Lp1 + 2 * P * B + P * B * S * Lp1 + P * B * (L + 3) + P) * CELL
    row("maint_reshard_parts", "maint.cu", "foundationdb_tpu/conflict/mesh_backend.py:477",
        max_abs_err(tuple(rk), tuple(rp_state) + (rp_press,)),
        kernel_ms(lambda: kernels.maint_reshard_parts(states.grid, states.count, states.floor, B, S), 20),
        cuda_ms(lambda: SH.reshard_parts_plain(states, used, B, S), 3),
        nbytes, n_live * Lp1 + P * B * S)
    reshard_entry(states, "four partitions")

    # K7b rebase of every partition as one flat grid
    delta = max(now // 2, 1)
    bk = kernels.maint_rebase_parts(states.grid, states.count, states.floor, delta)
    bp = SH.rebase_parts_plain(states, delta)
    row("maint_rebase_parts", "maint.cu", "foundationdb_tpu/conflict/mesh_backend.py:499",
        max_abs_err(bk, (bp.grid, bp.bmax, bp.floor)),
        kernel_ms(lambda: kernels.maint_rebase_parts(states.grid, states.count, states.floor, delta), 20),
        cuda_ms(lambda: SH.rebase_parts_plain(states, delta), 5),
        rebase_bytes(states.grid), P * B * S * 3)
    rows[-1].update(copy_yardstick(states.grid))
    torch.cuda.synchronize()
    return rows


def check_search(codes, q, launches: dict) -> list[dict]:
    """K5 against its plain version on the card, on the index's codes and
    one round of lookups; exact equality, CUDA-event times. The bound
    counts each code row the two searches probe once."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.device import ordered

    P, L = codes.shape
    Q = q.shape[0]
    steps = kernels.search_steps(P)
    rows = []
    row = row_maker(rows, launches)

    def plain():
        return torch.stack([G.searchsorted_lex(codes, q, "left"), G.searchsorted_lex(codes, q, "right")])

    # the distinct rows the reference's fixed-step searches probe
    arr, qo = ordered(codes), ordered(q)
    probed = []
    for cmp in (G.lex_lt, G.lex_le):
        lo = torch.zeros(Q, dtype=torch.int32, device=q.device)
        hi = torch.full((Q,), P, dtype=torch.int32, device=q.device)
        for _ in range(steps):
            mid = (lo + hi) >> 1
            probed.append(mid.clamp(max=P - 1))
            right = cmp(arr[probed[-1].long()], qo)
            lo, hi = torch.where(right, mid + 1, lo), torch.where(right, hi, mid)
    n_rows = torch.unique(torch.cat(probed)).numel()
    nbytes = (Q * L + 2 * Q + n_rows * L) * CELL
    row("search", "search.cu", "foundationdb_tpu/conflict/grid.py:125",
        max_abs_err(kernels.search(codes, q), plain()),
        kernel_ms(lambda: kernels.search(codes, q), 50),
        cuda_ms(plain, 5),
        nbytes, Q * 2 * steps * L)
    torch.cuda.synchronize()
    return rows


def run_mesh(want_oracle, offset: int, card: str):
    """Phase 7: the partitioned resolver's main path, then its kernels.
    Returns the kernel rows and the workload with its spread keys."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.conflict.api import new_conflict_set

    batches = make_batches(N_BATCHES, N_TXNS, offset, key=spread_key)
    cs = new_conflict_set("torch_mesh", key_width=KEY_WIDTH, capacity=CAPACITY, n_parts=4)
    cs.warm_compile()
    log(f"partitioned grid: {tuple(cs._states.grid.shape)} int32 = "
        f"{cs._states.grid.numel() * 4 / 2**20:.1f} MiB")

    def reshard_partition(c):  # a device rebalance of one partition between groups
        c._states, pressure = SH.reshard_partition(c._states, 1, c._B, c._S)
        if pressure > c._S:
            raise AssertionError(f"partition reshard overflowed: {pressure}")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got, encode_s = drive(cs, batches, offset, force_at=2, force=reshard_partition)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    snap = cs.metrics.snapshot()

    if len(got) != N_BATCHES or any(len(v) != N_TXNS for v in got):
        raise AssertionError("partitioned path returned verdicts of the wrong shape")
    bad = sum(a != b for vg, vo in zip(got, want_oracle) for a, b in zip(vg, vo))
    if bad:
        raise AssertionError(f"{bad} partitioned verdicts differ from the oracle")
    if snap["rebases"] < 1:
        raise AssertionError(f"rebase not exercised on the partitioned path: {snap}")
    per_part = snap["occupancy"]["liveRowsPerPartition"]
    if not all(n > 0 for n in per_part):
        raise AssertionError(f"a partition holds no live rows: {per_part}")
    path = ("history_parts", "intra_batch", "stage_parts", "merge_parts", "maint_reshard_parts",
            "maint_rebase_parts")
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the partitioned path: {missing}")
    txns = N_BATCHES * N_TXNS
    log(f"partitioned path: {wall:.3f} s, {txns / wall:.1f} txn/s end to end "
        f"({txns / max(wall - encode_s, 1e-9):.1f} txn/s without {encode_s:.3f} s "
        f"of host encode), live rows per partition {per_part} [{card}]")
    log("partitioned verdicts: all equal to the oracle")
    log("launches on the partitioned path: " + json.dumps(launches))
    log("partitioned kernel metrics: " + json.dumps(snap, default=str))

    # its kernels, on the final stacked state and the last batch again
    hbatch, _n, _epoch = cs.encode(batches[-1])
    now = offset + N_BATCHES + WINDOW - cs._base
    old = max(cs.oldest_version - cs._base, 0)
    log(f"partitioned kernel checks on the final state [{card}]:")
    rows = check_partition_kernels(cs._states, hbatch, (now, old, old), launches)
    profile_path(cs, make_batches(PROFILE_BATCHES, N_TXNS, offset + N_BATCHES, seed=1, key=spread_key),
                 offset + N_BATCHES, "four partitions", card)
    return rows, batches


def run_range_index(card: str) -> list[dict]:
    """Phase 8: the storage range index at bench.py's shape, then K5."""
    import bisect

    import numpy as np

    from foundationdb_tpu_torch.conflict import keys as K
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.device import lanes_to_torch
    from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex

    rnd = random.Random(0)
    t0 = time.perf_counter()
    keys = sorted({b"%012d" % rnd.randrange(10**12) for _ in range(INDEX_KEYS)})
    idx = TorchRangeIndex(keys)
    log(f"range index over {len(keys)} keys: codes {tuple(idx._codes.shape)} int32 = "
        f"{idx._codes.numel() * 4 / 2**20:.1f} MiB, built in {time.perf_counter() - t0:.1f} s")
    queries = [
        [rnd.choice(keys) if rnd.random() < 0.7 else b"%012d" % rnd.randrange(10**12)
         for _ in range(INDEX_BATCH)]
        for _ in range(INDEX_ROUNDS)
    ]
    intervals = [sorted((b"%012d" % rnd.randrange(10**12), b"%012d" % rnd.randrange(10**12)))
                 for _ in range(INDEX_BATCH)]
    idx.batch_lookup(queries[0])  # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    answers = [idx.batch_lookup(q) for q in queries]
    wall = time.perf_counter() - t0
    los, his = idx.batch_range([a for a, _b in intervals], [b for _a, b in intervals])
    launches = kernels.launch_counts()

    t0 = time.perf_counter()
    host = [[bisect.bisect_left(keys, k) for k in q] for q in queries]
    host_s = time.perf_counter() - t0
    for q, (rows, found), pos in zip(queries, answers, host):
        want_found = np.array([i < len(keys) and keys[i] == k for k, i in zip(q, pos)])
        if not (found == want_found).all():
            raise AssertionError("range index found flags differ from bisect")
        if not (rows == np.where(want_found, pos, -1)).all():
            raise AssertionError("range index rows differ from bisect")
    want_lo = [bisect.bisect_left(keys, a) for a, _b in intervals]
    want_hi = [bisect.bisect_left(keys, b) for _a, b in intervals]
    if list(los) != want_lo or list(his) != want_hi:
        raise AssertionError("range index intervals differ from bisect")
    if launches["search"] != INDEX_ROUNDS + 1:
        raise AssertionError(f"search launches {launches['search']} != {INDEX_ROUNDS + 1}")
    n_q = INDEX_ROUNDS * INDEX_BATCH
    hits = sum(int(f.sum()) for _r, f in answers)
    log(f"range index: {n_q / wall:.1f} lookups/s on the card (encode and copies included), "
        f"{n_q / host_s:.1f} lookups/s by host bisect, {hits} hits of {n_q} [{card}]")

    live = set(keys)
    added = sorted({b"%012d" % rnd.randrange(10**12) for _ in range(1000)} - live)
    removed = sorted(rnd.sample(keys, 1000))
    t0 = time.perf_counter()
    idx2 = idx.apply_delta(added, removed)
    delta_s = time.perf_counter() - t0
    ref = TorchRangeIndex(sorted((live - set(removed)) | set(added)))
    if idx2.n != ref.n or not torch.equal(idx2._codes, ref._codes):
        raise AssertionError("apply_delta differs from a rebuild")
    log(f"apply_delta (+{len(added)} / -{len(removed)}) in {delta_s * 1e3:.1f} ms equals a rebuild")
    log("launches on the range-index path: " + json.dumps(launches))

    log(f"range index kernel check [{card}]:")
    q = lanes_to_torch(K.encode_keys(queries[1], width=idx.width), "cuda")
    return check_search(idx._codes, q, launches)


LIMIT_WIDTHS = (32, 128)  # the default key width (L = 8) and one past 64 bytes (L = 32)
LIMIT_BATCHES = 3
LIMIT_TXNS = 64
LIMIT_KEYS = 20_000
# (KR, KW, L) K2 is held at: the shapes whose staged endpoints outgrow one
# block before the chunked plan (all but (256, 1, 3), the widest one-chunk
# plan at the bench's L), T = 512
K2_LIMIT_SHAPES = ((128, 1, 8), (64, 64, 8), (64, 32, 16), (256, 1, 3), (512, 2, 3), (16, 16, 32))


def limit_key(n: int, width: int) -> bytes:
    """Key n at ``width - 8`` bytes, so it encodes whole: a first byte
    spread over the partitions, a common run of ``width - 20`` bytes (at
    width 128 codes first differ past lane 16), then the number."""
    return bytes([n * 256 // LIMIT_KEYS]) + b"/" * (width - 20) + b"key/%07d" % n


def limit_batches(width: int, seed: int):
    """(transactions, now, oldest) batches that the card refused before the
    chunked K2 and the wide staging: in every 32 transactions one of 65-100
    reads and one of 33-40 reads and writes (KR = 128, KW = 64); in the
    second batch one of 130 writes (KW = 256); the rest one or two of each.
    Ranges are points or 1-10 keys; snapshots inside a 30-version window."""
    from foundationdb_tpu_torch.conflict.api import CommitTransaction

    rnd = random.Random(seed)

    def ranges(n):
        out = []
        for _ in range(n):
            a = rnd.randrange(LIMIT_KEYS - 16)
            end = limit_key(a, width) + b"\x00" if rnd.random() < 0.5 else limit_key(a + 1 + rnd.randrange(10), width)
            out.append((limit_key(a, width), end))
        return out

    out, v = [], 100
    for i in range(LIMIT_BATCHES):
        txs = []
        for t in range(LIMIT_TXNS):
            nr, nw = rnd.randint(0, 2), rnd.randint(0, 2)
            if t % 32 == 0:
                nr = rnd.randint(65, 100)
            elif t % 32 == 1:
                nr, nw = rnd.randint(33, 40), rnd.randint(33, 40)
            elif i == 1 and t == 2:
                nw = 130
            txs.append(CommitTransaction(read_snapshot=rnd.randrange(v - 30, v + 1),
                                         read_conflict_ranges=ranges(nr), write_conflict_ranges=ranges(nw)))
        rnd.shuffle(txs)
        out.append((txs, v + 10, v - 40))
        v += 10
    return out


def k2_codes(T: int, KR: int, KW: int, L: int, seed: int):
    """Random K2 inputs on the card: (begin, end) lanes over a small
    keyspace in the first lane, 20 % padding slots, 10 % of H set."""
    import numpy as np

    rnd = np.random.default_rng(seed)

    def ranges(k):
        b = np.zeros((T, k, L), np.int64)
        b[..., 0] = rnd.integers(0, 4 * T, (T, k))
        e = b.copy()
        e[..., 0] += rnd.integers(1, 8, (T, k))
        pad = rnd.random((T, k)) < 0.2
        b[pad] = e[pad] = 0xFFFFFFFF
        return [torch.from_numpy(x.astype(np.uint32).view(np.int32)).cuda() for x in (b, e)]

    rb, re = ranges(KR)
    wb, we = ranges(KW)
    H = torch.from_numpy(rnd.random(T) < 0.1).cuda()
    return rb, re, wb, we, H


def run_limits(card: str) -> None:
    """The "limits" phase: the shapes the card took only from this slice on.
    For key widths 32 and 128, ``limit_batches`` through one grid
    (``TorchConflictSet``) and through four partitions
    (``TorchMeshConflictSet``) on the card, every verdict equal to the same
    backend's plain path on the CPU and to the oracle, every kernel of the
    path launched (counts set to 0 just before each run); K1, K6 history and
    K2 then held against their plain versions on the final state and the
    last batch. Then K2 at ``K2_LIMIT_SHAPES`` (its chunk plan and device
    time), the staging of 2^23 endpoint rows (P = 4, T = 4096, KW = 256,
    L = 8), and the range index at width 128 against ``bisect`` with K5
    held against its plain version. One JSON line each."""
    import bisect

    import numpy as np

    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import keys as K
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.conflict import torch_backend as TB
    from foundationdb_tpu_torch.conflict.api import new_conflict_set
    from foundationdb_tpu_torch.device import lanes_to_torch
    from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex

    t_phase = time.perf_counter()
    paths = (("one grid", "torch", {}, ("history", "intra_batch", "stage", "merge")),
             ("four partitions", "torch_mesh", {"n_parts": 4},
              ("history_parts", "intra_batch", "stage_parts", "merge_parts")))
    for width in LIMIT_WIDTHS:
        work = limit_batches(width, width)
        oracle = new_conflict_set("oracle")
        want = [oracle.detect_batch(txs, now, old) for txs, now, old in work]
        for label, backend, kwargs, path in paths:
            cpu = new_conflict_set(backend, key_width=width, capacity=1 << 14, device="cpu", **kwargs)
            t0 = time.perf_counter()
            want_cpu = [cpu.detect_batch(txs, now, old) for txs, now, old in work]
            cpu_s = time.perf_counter() - t0
            cs = new_conflict_set(backend, key_width=width, capacity=1 << 14, **kwargs)
            cs.warm_compile()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            got = [cs.detect_batch(txs, now, old) for txs, now, old in work]
            card_s = time.perf_counter() - t0
            launches = kernels.launch_counts()
            if got != want:
                raise AssertionError(f"limits, {label}, width {width}: verdicts differ from the oracle")
            if got != want_cpu:
                raise AssertionError(f"limits, {label}, width {width}: verdicts differ from the CPU path")
            missing = [k for k in path if launches[k] <= 0]
            if missing:
                raise AssertionError(f"limits, {label}, width {width}: kernels never launched: {missing}")
            # the kernels on the final state and the last batch, against their plain versions
            txs, now, old = work[-1]
            batch = TB.upload(cs.encode(txs)[0], torch.device("cuda"))
            state = cs._states if kwargs else cs._state
            if kwargs:
                bounds = SH.partition_bounds(width // 4, 4, "cuda")
                hk = kernels.history_parts(*state, *bounds, batch.rb, batch.re, batch.t_snap)
                hp = SH.history_conflicts_sharded_plain(state, batch, *bounds)
            else:
                hk = kernels.history(*state, batch.rb, batch.re, batch.t_snap)
                hp = G.history_conflicts_plain(state, batch)
            ck = kernels.intra_batch(batch.rb, batch.re, batch.wb, batch.we, hk)
            cp = G.intra_batch_commits_plain(*G._endpoint_ranks(batch), hk)
            errs = {"history": max_abs_err(hk, hp), "intra_batch": max_abs_err(ck, cp)}
            if any(errs.values()):
                raise AssertionError(f"limits, {label}, width {width}: a kernel differs from its plain version {errs}")
            T, KR, L = batch.rb.shape
            log("limits: " + json.dumps({
                "path": label, "key_width": width, "batches": len(work), "txns": sum(len(w[0]) for w in work),
                "max_reads": max(len(t.read_conflict_ranges) for w in work for t in w[0]),
                "max_writes": max(len(t.write_conflict_ranges) for w in work for t in w[0]),
                "last_batch_shape": [T, KR, batch.wb.shape[1], L], "verdicts_equal_oracle_and_cpu": True,
                "card_s": card_s, "cpu_s": cpu_s, "launches": {k: launches[k] for k in path},
                "max_abs_err": errs, "card": card}))

    # K2 at its chunked shapes: the plan, kernel against plain, device
    # time; beside it the same launch with every endpoint read from global
    # memory (the plan's last resort, CR = CW = 0), the alternative to chunks
    def k2_global(rb, re, wb, we, H):
        T, KR, L = rb.shape
        W = (T + 31) // 32
        pt = torch.empty(W * 32 * W, dtype=torch.int32, device="cuda")
        commit = torch.empty(T, dtype=torch.bool, device="cuda")
        kernels._run("fdb_intra_batch", *(kernels._ptr(x) for x in (rb, re, wb, we, H, pt, commit)),
                     T, KR, wb.shape[1], L, 8, 0, 0, kernels._stream())
        return commit

    cases = []
    for KR, KW, L in K2_LIMIT_SHAPES:
        args = k2_codes(512, KR, KW, L, seed=KR * 1000 + KW + L)
        batch = G.Batch(*args[:4], torch.zeros(512, dtype=torch.int32, device="cuda"), args[4])
        got = kernels.intra_batch(*args)
        err = max(max_abs_err(got, G.intra_batch_commits_plain(*G._endpoint_ranks(batch), args[4])),
                  max_abs_err(got, k2_global(*args)))
        if err:
            raise AssertionError(f"intra_batch at KR = {KR}, KW = {KW}, L = {L} differs from its plain version")
        ms = cuda_ms(lambda: kernels.intra_batch(*args), 5)
        gms = cuda_ms(lambda: k2_global(*args), 5)
        cases.append({"kernel": "intra_batch", "T": 512, "KR": KR, "KW": KW, "L": L,
                      "plan": list(kernels.intra_batch_plan(KR, KW, L)), "ms": ms,
                      "device_ms": queued_ms(lambda: kernels.intra_batch(*args), 5, ms),
                      "global_device_ms": queued_ms(lambda: k2_global(*args), 5, gms), "max_abs_err": err})

    # the staging of 2^23 endpoint rows over four partitions
    P, T, KW, L, B = 4, 4096, 256, 8, 8192
    gen = torch.Generator(device="cuda").manual_seed(6)
    wb = torch.randint(0, 1 << 20, (P, T, KW, L), generator=gen, device="cuda", dtype=torch.int32)
    wb[..., 1:] = 0
    we = wb.clone()
    we[..., 0] += torch.randint(1, 64, (P, T, KW), generator=gen, device="cuda", dtype=torch.int32)
    we[..., -1] = 1
    piv = torch.zeros((P, B, L), dtype=torch.int32, device="cuda")
    piv[:, :, 0] = torch.arange(B, device="cuda", dtype=torch.int32) * ((1 << 20) // B)
    commit = torch.rand(T, generator=gen, device="cuda") < 0.8
    S2 = G.staging_slots(32)
    sk = kernels.stage_parts(wb, we, commit, piv, S2)
    shape_only = torch.empty((), dtype=torch.int32, device="cuda").expand(P, B, 32, L + 1)
    st = SH._stage_clipped_plain(G.GridState(piv, shape_only, None, None, None), wb, we, commit)
    err = max_abs_err(tuple(sk), tuple(st))
    if err:
        raise AssertionError("the staging of 2^23 rows differs from its plain version")
    ms = cuda_ms(lambda: kernels.stage_parts(wb, we, commit, piv, S2), 2, warmup=1)
    cases.append({"kernel": "stage_parts", "P": P, "T": T, "KW": KW, "L": L, "rows": P * 2 * T * KW,
                  "ms": ms, "max_abs_err": err})
    log("limits kernels: " + json.dumps({"cases": cases, "card": card}))

    # the range index at width 128: 50K keys of 113 bytes
    rnd = random.Random(128)
    prefix = b"tenant/" + b"/" * 94
    keys = sorted({prefix + b"%012d" % rnd.randrange(10**12) for _ in range(50_000)})
    idx = TorchRangeIndex(keys, width=128)
    queries = [[rnd.choice(keys) if rnd.random() < 0.7 else prefix + b"%012d" % rnd.randrange(10**12)
                for _ in range(INDEX_BATCH)] for _ in range(4)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [idx.batch_lookup(q) for q in queries]
    launches = kernels.launch_counts()["search"]
    for q, (rows, found) in zip(queries, answers):
        pos = [bisect.bisect_left(keys, k) for k in q]
        want_found = np.array([i < len(keys) and keys[i] == k for k, i in zip(q, pos)])
        if not (found == want_found).all() or not (rows == np.where(want_found, pos, -1)).all():
            raise AssertionError("range index at width 128 differs from bisect")
    if launches != len(queries):
        raise AssertionError(f"search launches at width 128: {launches}")
    q = lanes_to_torch(K.encode_keys(queries[0], width=128), "cuda")
    plain = torch.stack([G.searchsorted_lex(idx._codes, q, "left"), G.searchsorted_lex(idx._codes, q, "right")])
    err = max_abs_err(kernels.search(idx._codes, q), plain)
    if err:
        raise AssertionError("search at width 128 differs from its plain version")
    ms = cuda_ms(lambda: kernels.search(idx._codes, q), 20)
    log("limits range index: " + json.dumps({
        "key_width": 128, "keys": len(keys), "lookups": len(queries) * INDEX_BATCH, "equal_to_bisect": True,
        "launches": launches, "search_ms": ms, "search_device_ms": queued_ms(lambda: kernels.search(idx._codes, q), 20, ms),
        "max_abs_err": err, "card": card}))
    log(f"limits phase: {time.perf_counter() - t_phase:.1f} s")


# the resolver phase: versions step by RES_STEP a batch, so the resolver's
# MVCC window (MAX_READ_TRANSACTION_LIFE_VERSIONS, 5,000,000 by default) is
# the main phase's WINDOW of batches
RES_STEP = 100_000
RES_BASE = (1 << 30) - 1 - RES_STEP * (2 * GROUP + WINDOW)  # batch 2·GROUP rebases
FAILOVER_BATCHES = 20
FAILOVER_TXNS = 256
PIPE_BATCHES = 30  # the pipelined failover case


def resolver_requests(batches, offset: int):
    """The main workload as the proxies' ResolveBatchRequests. Batch i of
    the main phase resolves at now = offset + i + WINDOW over the horizon
    offset + i; here every version v becomes RES_BASE + RES_STEP·(v - offset),
    so batch i's version is RES_BASE + RES_STEP·(i + WINDOW) and the
    horizon the resolver derives from it is RES_BASE + RES_STEP·i. The map
    keeps every order, so every verdict must equal the main phase's."""
    from foundationdb_tpu_torch.server.interfaces import ResolveBatchRequest, TransactionData

    def v(x):
        return RES_BASE + RES_STEP * (x - offset)

    reqs = []
    for i, txs in enumerate(batches):
        reqs.append(ResolveBatchRequest(
            prev_version=v(offset + i - 1 + WINDOW) if i else 0,
            version=v(offset + i + WINDOW),
            last_receive_version=0,
            requesting_proxy="px",
            transactions=[
                TransactionData(read_snapshot=v(t.read_snapshot),
                                read_conflict_ranges=t.read_conflict_ranges,
                                write_conflict_ranges=t.write_conflict_ranges)
                for t in txs
            ],
        ))
    return reqs


def run_resolver(backend: str, reqs, want, card: str, threads: int = 1, **backend_kw) -> dict:
    """Phase 10, one run: every request spawned at once through
    ``Resolver(backend=...)`` on a RealLoop (device backends on the card),
    after the resolver's warm-up has finished. Every verdict must equal
    ``want``; the guard must end HEALTHY with no fault, failover or
    deadline hit. Returns the run's JSON record."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.runtime.futures import spawn
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.runtime.loop import RealLoop, set_loop
    from foundationdb_tpu_torch.runtime.trace import trace_log
    from foundationdb_tpu_torch.server.resolver import Resolver

    knobs = Knobs(CONFLICT_ENCODE_THREADS=threads)
    if knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS != RES_STEP * WINDOW:
        raise AssertionError("the resolver's MVCC window is not the main phase's")
    loop = RealLoop(seed=0)
    set_loop(loop)
    device = backend != "native"
    r = Resolver(knobs=knobs, backend=backend, uid=f"{backend}-{threads}", **backend_kw)
    try:
        if r._warm is not None:  # the kernels' build and the warm-up batch, untimed
            loop.run(stop_when=r._warm.is_ready)
            r._warm.get()
        if device:
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [spawn(r.resolve(q)) for q in reqs]
        loop.run(stop_when=lambda: all(f.is_ready() for f in futs))
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        got = [f.get().committed for f in futs]
        stats = r.stats.snapshot()
        health = r.cs.health_snapshot()
        faults = [e for e in trace_log().events if e["Type"] in ("KernelFault", "KernelRebuilt")
                  and e.get("Resolver") == r.uid]
    finally:
        r.close()
        set_loop(None)
        loop.close()

    label = f"resolver {backend}, encode threads {threads}" if device else "resolver native"
    kernel = stats["kernel"]
    rebases = kernel.get("rebases", 0)
    txns = sum(len(q.transactions) for q in reqs)

    def sample(name):
        return kernel.get(name) if device else None

    out = {
        "run": label, "backend": backend, "encode_threads": threads if device else None,
        "batches": len(reqs), "txns": txns, "wall_s": wall, "txn_s": txns / wall,
        "resolveLatency": stats["resolveLatency"], "resolveLatencyBands": stats["resolveLatencyBands"],
        "encodeOverlapSeconds": sample("encodeOverlapSeconds"), "encodeSeconds": sample("encodeSeconds"),
        "dispatchSeconds": sample("dispatchSeconds"), "collectSeconds": sample("collectSeconds"),
        "rebases": rebases, "health": health, "fault_events": faults[:6],
        "launches": {k: v for k, v in launches.items() if v} if device else None,
        "card": card,
    }
    log(json.dumps({"resolver": out}, default=str))
    if len(got) != len(reqs) or any(len(g) != len(q.transactions) for g, q in zip(got, reqs)):
        raise AssertionError(f"{label}: verdicts of the wrong shape")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if [int(v) for v in g] != [int(v) for v in w]]
    if bad:
        n = sum(int(a) != int(b) for i in bad for a, b in zip(got[i], want[i]))
        raise AssertionError(f"{label}: {n} verdicts differ from the oracle, in batches {bad[:10]} "
                             f"(of {len(bad)})")
    want_backend = {"torch": "TorchConflictSet", "torch_mesh": "TorchMeshConflictSet",
                    "native": "NativeConflictSet"}[backend]
    if (health["state"] != "HEALTHY" or health["faults"] or health["failovers"]
            or health["deadlineHits"] or health["backend"] != want_backend):
        raise AssertionError(f"{label}: the guard left its healthy path: {health}")
    if device:
        if rebases < 1 or health["retries"] > rebases:
            raise AssertionError(f"{label}: {health['retries']} retries over {rebases} rebases")
        path = (("history", "intra_batch", "stage", "merge", "maint_rebase") if backend == "torch"
                else ("history_parts", "intra_batch", "stage_parts", "merge_parts", "maint_rebase_parts"))
        missing = [k for k in path if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
    log(f"{label}: {wall:.3f} s, {txns / wall:.1f} txn/s, resolveLatency p50 "
        f"{stats['resolveLatency']['p50']} s p99 {stats['resolveLatency']['p99']} s, "
        f"{health['retries']} retries over {rebases} rebases, every verdict equal to the oracle [{card}]")
    return out


class FalseCommitReferee:
    """Zero-false-commit referee (tests/test_kernel_faults.py): applies
    exactly the writes the resolver committed to an oracle, and probes each
    claimed commit's reads against that history. Returns the count of
    commits it refuses; conservative aborts pass."""

    def __init__(self):
        from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet

        self.cs = OracleConflictSet()
        self.false_commits = 0

    def check_batch(self, txns, verdicts, version):
        from foundationdb_tpu_torch.conflict.api import CommitTransaction, Verdict

        for t, v in zip(txns, verdicts):
            if int(v) != int(Verdict.COMMITTED):
                continue
            if t.read_conflict_ranges:
                probe = self.cs.detect_batch(
                    [CommitTransaction(t.read_snapshot, list(t.read_conflict_ranges), [])],
                    now=version, new_oldest_version=0)
                self.false_commits += probe[0] != Verdict.COMMITTED
            if t.write_conflict_ranges:
                self.cs.detect_batch([CommitTransaction(0, [], list(t.write_conflict_ranges))],
                                     now=version, new_oldest_version=0)


def failover_requests(n: int, seed: int):
    """``n`` batches of FAILOVER_TXNS transactions over a hot 2000-key
    keyspace (conflicts matter), versions 10, 20, ..."""
    from foundationdb_tpu_torch.server.interfaces import ResolveBatchRequest, TransactionData

    rnd = random.Random(seed)
    reqs = []
    for i in range(n):
        version = 10 * (i + 1)

        def rng():
            a = rnd.randrange(2000)
            return [(ascii_key(a), ascii_key(a + 1 + rnd.randrange(10)))]

        reqs.append(ResolveBatchRequest(
            prev_version=version - 10, version=version, last_receive_version=0,
            requesting_proxy="px",
            transactions=[TransactionData(read_snapshot=max(0, version - 10 * rnd.randrange(1, 4)),
                                          read_conflict_ranges=rng(), write_conflict_ranges=rng())
                          for _ in range(FAILOVER_TXNS)]))
    return reqs


def run_failover(card: str, pipelined: bool) -> dict:
    """Phase 11, one case. Sequential: a device loss partway through
    FAILOVER_BATCHES batches, one batch at a time; a pause after the loss
    lets it heal and the re-probe interval pass. Pipelined: PIPE_BATCHES
    batches, batch i spawned 0.1·i s in, with a hang at the 5th dispatch
    (the deadline recovers it while later batches are in flight on the old
    backend), a 0.5 s stall at the 12th (an old-backend batch still in
    collect when the recovery swaps) and a device loss at the 16th, then
    one batch after the loss heals. Every verdict must equal the oracle's
    over the same stream, with no false commit; the fallback must be the
    port's native; the guard must promote back to the card."""
    from foundationdb_tpu_torch.conflict.faults import KernelFaultInjector
    from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
    from foundationdb_tpu_torch.runtime.futures import delay, spawn
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.runtime.loop import RealLoop, set_loop
    from foundationdb_tpu_torch.runtime.rng import DeterministicRandom
    from foundationdb_tpu_torch.runtime.trace import trace_log
    from foundationdb_tpu_torch.server.resolver import Resolver

    lose_at, pause_after, loss_s = 6, 10, 1.0
    reqs = failover_requests(PIPE_BATCHES + 1 if pipelined else FAILOVER_BATCHES, 8 if pipelined else 7)
    inj = KernelFaultInjector(DeterministicRandom(7), p_dispatch_error=0, p_device_loss=0, p_hang=0,
                              p_compile_stall=0, p_encode_error=0, p_encode_hang=0)
    knobs = Knobs(CONFLICT_FAILOVER_STRIKES=2, CONFLICT_REPROBE_INTERVAL=0.5,
                  **({"CONFLICT_DISPATCH_DEADLINE": 1.0} if pipelined else {}))
    if pipelined:
        dispatches = {"n": 0}
        on_dispatch = inj.on_dispatch

        def scheduled():
            dispatches["n"] += 1
            if dispatches["n"] == 5:
                inj._pending_stall = float("inf")
            if dispatches["n"] == 12:
                inj._pending_stall = 0.5
            if dispatches["n"] == 16:
                inj.lose_device(loss_s)
            on_dispatch()

        inj.on_dispatch = scheduled
    loop = RealLoop(seed=0)
    set_loop(loop)
    uid = "failover-pipelined" if pipelined else "failover"
    r = Resolver(knobs=knobs, backend="torch", uid=uid, key_width=KEY_WIDTH, fault_injector=inj)
    log_rows = []
    replies = {}

    def note(q, rep):
        replies[q.version] = rep.committed
        log_rows.append((q.version, r.cs.health, r.cs.backend_name,
                         sum(int(v) != 0 for v in rep.committed)))

    async def one(i, q):
        await delay(0.1 * i)
        note(q, await r.resolve(q))

    async def go():
        await r._warm
        if pipelined:
            futs = [spawn(one(i, q)) for i, q in enumerate(reqs[:-1])]
            for f in futs:
                await f
            await delay(loss_s + knobs.CONFLICT_REPROBE_INTERVAL)
            note(reqs[-1], await r.resolve(reqs[-1]))
            return True
        for i, q in enumerate(reqs):
            if i == lose_at:
                inj.lose_device(loss_s)
            note(q, await r.resolve(q))
            if i == pause_after:
                await delay(loss_s + knobs.CONFLICT_REPROBE_INTERVAL)
        return True

    try:
        fut = spawn(go())
        t0 = time.perf_counter()
        loop.run(stop_when=fut.is_ready)
        wall = time.perf_counter() - t0
        fut.get()
        health = r.cs.health_snapshot()
        in_order = sum(e["Type"] == "ResolveInOrder" and e.get("Resolver") == uid
                       for e in trace_log().events)
    finally:
        r.close()
        set_loop(None)
        loop.close()
    referee, oracle, wrong = FalseCommitReferee(), OracleConflictSet(), 0
    for q in reqs:
        got = replies[q.version]
        referee.check_batch(q.transactions, got, q.version)
        want = oracle.detect_batch(q.transactions, now=q.version, new_oldest_version=0)
        wrong += sum(int(a) != int(b) for a, b in zip(got, want))
    fell_back = {b for _v, h, b, _a in log_rows if h == "FAILED_OVER"}
    mode = "pipelined" if pipelined else "sequential"
    out = {"failover": {"mode": mode, "batches": len(reqs), "txns": FAILOVER_TXNS,
                        "fallback": sorted(fell_back), "false_commits": referee.false_commits,
                        "verdicts_off_oracle": wrong, "in_order_resolves": in_order,
                        "per_batch": sorted(log_rows), "health": health, "wall_s": wall, "card": card}}
    log(json.dumps(out, default=str))
    if fell_back != {"NativeConflictSet"}:
        raise AssertionError(f"{mode} failover did not go to the port's native skip list: {fell_back}")
    if referee.false_commits or wrong:
        raise AssertionError(f"{mode} failover: {referee.false_commits} false commits, "
                             f"{wrong} verdicts off the oracle's")
    if not (health["failovers"] >= 1 and health["promotions"] >= 1 and health["state"] == "HEALTHY"
            and health["backend"] == "TorchConflictSet"):
        raise AssertionError(f"{mode}: the guard did not fail over and promote back: {health}")
    if pipelined and not (health["deadlineHits"] >= 1 and in_order >= 1):
        raise AssertionError(f"pipelined failover: no deadline recovery under pipelining: {health}")
    log(f"{mode} failover phase: resolved on NativeConflictSet, promoted back to TorchConflictSet, "
        f"0 false commits, every verdict equal to the oracle's, {in_order} in-order resolves [{card}]")
    return out


def profile_only(card: str, history: bool = False, reshard: bool = False, rebase: bool = False) -> None:
    """Only the per-batch profile of both resolver paths: each warmed by
    one group of the bench workload, then profiled over the next
    PROFILE_BATCHES batches. With ``history``, then K1 and K6 history on
    the path's state and its last batch, as read and with every read
    keyspace-wide, against their plain versions; with ``reshard``, the
    reshard entry point on the path's state (``reshard_entry``), with
    ``rebase`` the rebase entry point (``rebase_entry``): one JSON line
    each. Uses the resolvers' entry points, the kernel wrappers and, for
    ``history``, ``reshard`` and ``rebase``, the resolvers' device state (``_state`` of
    the one-grid backend, ``_states`` of the partitioned one), so it
    measures any checkout of the port that keeps those names."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.conflict import torch_backend as TB
    from foundationdb_tpu_torch.conflict.api import new_conflict_set

    offset = 1
    cases, reshards, rebases = [], [], []
    for label, key, kwargs in (("one grid", ascii_key, {}), ("four partitions", spread_key, {"n_parts": 4})):
        backend = "torch_mesh" if kwargs else "torch"
        cs = new_conflict_set(backend, key_width=KEY_WIDTH, capacity=CAPACITY, **kwargs)
        cs.warm_compile()
        batches = make_batches(GROUP + PROFILE_BATCHES, N_TXNS, offset, key=key)
        drive(cs, batches[:GROUP], offset)
        profile_path(cs, batches[GROUP:], offset + GROUP, label, card)
        if reshard:
            reshards.append(reshard_entry(cs._states if kwargs else cs._state, label))
        if rebase:
            rebases.append(rebase_entry(cs._states if kwargs else cs._state, label))
        if history:
            batch = TB.upload(cs.encode(batches[-1])[0], torch.device("cuda"))
            if kwargs:
                bounds = SH.partition_bounds(KEY_WIDTH // 4, kwargs["n_parts"], "cuda")
                cases += check_history(cs._states, batch, kernels.launch_counts(), bounds)[1]
            else:
                cases += check_history(cs._state, batch, kernels.launch_counts())[1]
    if history:
        log(json.dumps({"history": cases, "card": card}))
    if reshard:
        log(json.dumps({"reshard": reshards, "card": card}))
    if rebase:
        log(json.dumps({"rebase": rebases, "card": card}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-only", action="store_true",
                    help="print only the per-batch profile lines of both resolver paths")
    ap.add_argument("--reshard-only", action="store_true",
                    help="the profile lines, then the reshard entry point of both paths, glue "
                         "included, on CUDA events")
    ap.add_argument("--history-only", action="store_true",
                    help="the profile lines, then the history kernels of both paths on the bench "
                         "batch and on keyspace-wide reads, timed and held to their plain versions")
    ap.add_argument("--rebase-only", action="store_true",
                    help="the profile lines, then the rebase entry point of both paths, glue "
                         "included, beside a copy of the same grid, on CUDA events")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if args.profile_only or args.history_only or args.reshard_only or args.rebase_only:
        card = card_line()
        log(f"card: {card}")
        profile_only(card, history=args.history_only, reshard=args.reshard_only,
                     rebase=args.rebase_only)
        return 0

    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict.api import new_conflict_set
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 2. build every kernel from the checkout's sources
    kernels.build.load()
    log(f"kernels built in {kernels.build.build_seconds:.1f} s")
    for src, text in sorted(kernels.build.build_log.items()):
        for line in text.splitlines():
            if "Used" in line:
                log(f"  ptxas {src}: {line.split('info    :')[-1].strip()}")

    # 3. workload, warm-up group, CPU plain path, oracle
    # versions start so that group 2 crosses now - base >= 2^30: the int32
    # origin is rebased mid-run (K4b) as in a cluster up for ~20 minutes
    offset = (1 << 30) - 1 - (2 * GROUP + WINDOW)
    t0 = time.perf_counter()
    batches = make_batches(N_BATCHES, N_TXNS, offset)
    log(f"workload {N_BATCHES}x{N_TXNS} made in {time.perf_counter() - t0:.1f} s")

    warm = TorchConflictSet(key_width=KEY_WIDTH, capacity=CAPACITY)
    warm.warm_compile()
    drive(warm, batches[:GROUP], offset)
    state_g1 = warm._state  # the state after the first group
    nxt = GROUP
    hbatch, _n, _epoch = warm.encode(batches[nxt])
    vers = (offset + nxt + WINDOW - warm._base,
            max(warm.oldest_version - warm._base, 0),
            max(max(warm.oldest_version, offset + nxt) - warm._base, 0))

    t0 = time.perf_counter()
    cpu = TorchConflictSet(key_width=KEY_WIDTH, capacity=CAPACITY, device="cpu")
    want, _ = drive(cpu, batches, offset)
    log(f"CPU plain path: {time.perf_counter() - t0:.1f} s")
    # the independent reference, over every batch: those after the rebase
    # and the device reshard too
    t0 = time.perf_counter()
    oracle = new_conflict_set("oracle")
    want_oracle = [
        oracle.detect_batch(txs, offset + i + WINDOW, offset + i)
        for i, txs in enumerate(batches)
    ]
    log(f"oracle: {time.perf_counter() - t0:.1f} s")

    # 4. the main path on the card; counts set to 0 just before it
    cs = new_conflict_set("torch", key_width=KEY_WIDTH, capacity=CAPACITY)
    cs.warm_compile()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got, encode_s = drive(cs, batches, offset, force_at=2, force=lambda c: c._reshard(c._state))
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    snap = cs.metrics.snapshot()

    if len(got) != N_BATCHES or any(len(v) != N_TXNS for v in got):
        raise AssertionError("main path returned verdicts of the wrong shape")
    bad = sum(a != b for vg, vc in zip(got, want) for a, b in zip(vg, vc))
    if bad:
        raise AssertionError(f"{bad} verdicts differ from the CPU plain path")
    bad = sum(a != b for vg, vo in zip(got, want_oracle) for a, b in zip(vg, vo))
    if bad:
        raise AssertionError(f"{bad} verdicts differ from the oracle")
    if snap["rebases"] < 1 or snap["reshardsDevice"] < 1:
        raise AssertionError(f"rebase/device reshard not exercised: {snap}")
    path = ("history", "intra_batch", "stage", "merge", "maint_reshard", "maint_rebase")
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    txns = N_BATCHES * N_TXNS
    aborts = sum(v != 0 for vg in got for v in vg)
    log(f"main path: {wall:.3f} s, {txns / wall:.1f} txn/s end to end "
        f"({txns / max(wall - encode_s, 1e-9):.1f} txn/s without {encode_s:.3f} s "
        f"of host encode), abort rate {aborts / txns:.4f} [{card}]")
    log("verdicts: all equal to the CPU plain path and to the oracle")
    log("launches on the main path: " + json.dumps(launches))
    log("kernel metrics: " + json.dumps(snap, default=str))
    profile_path(cs, make_batches(PROFILE_BATCHES, N_TXNS, offset + N_BATCHES, seed=1),
                 offset + N_BATCHES, "one grid", card)

    # 5. each kernel against its plain version, at the main path's shapes
    log(f"kernel checks on the state after the first group [{card}]:")
    rows = check_kernels(state_g1, hbatch, vers, launches)

    # 7. the partitioned resolver
    mesh_rows, spread_batches = run_mesh(want_oracle, offset, card)
    # 8. the range index
    index_rows = run_range_index(card)
    # 9. the shapes past the bench's: many ranges a transaction, wide keys
    run_limits(card)
    # 10. the resolver role over both device paths, then the port's native
    t_phase = time.perf_counter()
    reqs = resolver_requests(batches, offset)
    # the smoke keeps millions of its own objects alive (the workloads, the
    # oracle's verdicts, the requests): move them out of the collector's
    # scans, or a full collection stalls every thread of a run for a second
    # and more, inside the resolver's dispatch deadline
    gc.collect()
    gc.freeze()
    device_kw = {"key_width": KEY_WIDTH, "capacity": CAPACITY}
    for threads in (1, 0):
        run_resolver("torch", reqs, want_oracle, card, threads, **device_kw)
    run_resolver("native", reqs, want_oracle, card)
    reqs = resolver_requests(spread_batches, offset)
    for threads in (1, 0):
        run_resolver("torch_mesh", reqs, want_oracle, card, threads, n_parts=4, **device_kw)
    del reqs
    log(f"resolver phase: {time.perf_counter() - t_phase:.1f} s")
    # 11. a device loss: failover to the port's native and back, one batch
    # at a time and with every batch in flight
    run_failover(card, pipelined=False)
    run_failover(card, pipelined=True)

    # 6. results
    log(json.dumps({"kernels": rows + index_rows + mesh_rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
