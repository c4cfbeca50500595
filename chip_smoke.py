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
   the CPU path's and the oracle's, and every kernel must have launched;
5. hold each kernel against its plain version on the card at the main
   path's shapes (exact equality: outputs are integers and bools) and time
   both with CUDA events;
6. after phases 7 and 8: print the kernel table (every kernel of the three
   paths), the card line and the result line;
7. the partitioned resolver, ``new_conflict_set("torch_mesh", key_width=12,
   capacity=1<<19, n_parts=4)`` (4 partitions × 8192 × 32 × 4 uint32 =
   16 MiB), over the same workload with every key re-encoded
   order-preservingly so its first lane is uniform over 2^32 (the ASCII
   keys would all land in partition 0): every verdict must equal the
   oracle's from phase 3; versions cross the int32 rebase; one partition
   reshard is forced between groups; every partition must hold live rows;
   then its kernels (K6 history and merge over partitions, K7 reshard and
   rebase over partitions) are held against their plain versions;
8. the storage range index at ``bench.py``'s shape: 1M random 12-byte
   keys at width 32 (2^20 × 8 lanes = 32 MiB of codes on the card), 50
   rounds of 4096 lookups (70 % hits) and 4096 range queries, every answer
   equal to host ``bisect``, and a delta of 1K adds and 1K removes equal to
   a rebuild; then K5 is held against its plain version.

Each path runs with every kernel launch count set to 0 just before it and
read just after, and every kernel of the path must have launched.

Exits non-zero, without a result line, when no CUDA card is visible.
Usage: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import random
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


def history_work(state, rb, re) -> tuple[int, int]:
    """(bytes, int ops) the history check of ranges [rb, re) needs on one
    grid beyond the batch itself: each bucket window it touches once, the
    pivot rows its binary searches probe (at most all), the bmax words of
    the buckets strictly between a range's ends (at most all)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.device import ordered

    B, S, Lp1 = state.grid.shape
    L = Lp1 - 1
    a = ordered(rb.reshape(-1, L))
    e = ordered(re.reshape(-1, L))
    act = G.lex_lt(a, e)
    piv = ordered(state.pivots)
    ba = G._rank(a, piv, strict=False)[act]
    be = G._rank(e, piv, strict=True)[act]
    n_act = int(act.sum())
    windows = torch.unique(torch.cat([ba, be[be > ba]])).numel()
    between = int((be - ba - 1).clamp(min=0).sum())
    probes = 2 * n_act * math.ceil(math.log2(B))
    nbytes = windows * (S * Lp1 + 2) * CELL + min(B * L, probes * L) * CELL \
        + min(B, between) * CELL
    ops = probes * L + n_act * 2 * S * L * 2 + between
    return nbytes, ops


def merge_work(state, after, st, n_parts: int) -> tuple[int, int]:
    """(bytes, int ops) of the per-bucket merge: per touched bucket its live
    rows read, max(old, new count) rows written, S2 staged rows,
    tid/carry/count/floor read, count/bmax/floor written; one pressure
    word per partition. ``state``/``after`` are the grid before and after
    (the flat view of a stacked grid)."""
    B, S, Lp1 = state.grid.shape
    L = Lp1 - 1
    live = st.tid < B
    U = int(live.sum())
    S2 = st.st_ev.shape[1]
    M = S + S2
    touched = st.tid[live].long()
    old_n, new_n = state.count[touched], after.count[touched]
    row_io = int(old_n.sum()) + int(torch.maximum(old_n, new_n).sum())
    nbytes = (row_io * Lp1 + U * (S2 * (L + 1) + 7) + n_parts) * CELL
    return nbytes, U * (M * M * L + M * 8)


def row_maker(rows: list, launches: dict):
    """A function that checks one kernel's result, appends its row of the
    kernel table and logs it."""

    def row(name, source, replaces, err, ms, plain_ms, nbytes, ops):
        b_ms, b_by = bound(nbytes, ops)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max abs err {err})")
        rows.append({
            "name": name, "route": "cuda",
            "source": "foundationdb_tpu_torch/conflict/kernels/csrc/" + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        log(f"  {name:19s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {b_ms:.5f} ms ({b_by})  max_abs_err {err}")

    return row


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

    # K1 history
    hargs = (state.pivots, state.grid, state.count, state.bmax, state.floor,
             batch.rb, batch.re, batch.t_snap)
    hk = kernels.history(*hargs)
    hp = G.history_conflicts_plain(state, batch)
    nbytes, ops = history_work(state, batch.rb, batch.re)
    nbytes += (2 * T * KR * L + T) * cell + T
    row("history", "history.cu", "foundationdb_tpu/conflict/grid.py:210", max_abs_err(hk, hp),
        cuda_ms(lambda: kernels.history(*hargs), 50),
        cuda_ms(lambda: G.history_conflicts_plain(state, batch), 5),
        nbytes, ops)

    # K2 intra-batch greedy commit (ranks are torch glue on both sides)
    H = hk | (batch.t_has_reads & (batch.t_snap < old_pre))
    ranks = G._endpoint_ranks(batch)
    ck = kernels.intra_batch(*ranks, H)
    cp = G.intra_batch_commits_plain(*ranks, H)
    nbytes = 2 * T * (KR + KW) * cell + 2 * T
    ops = T * (T - 1) // 2 * KR * KW * 2 + T * ((T + 31) // 32)
    row("intra_batch", "intra_batch.cu", "foundationdb_tpu/conflict/grid.py:337", max_abs_err(ck, cp),
        cuda_ms(lambda: kernels.intra_batch(*ranks, H), 20),
        cuda_ms(lambda: G.intra_batch_commits_plain(*ranks, H), 3),
        nbytes, ops)

    # K3 per-bucket merge, on fresh clones (it updates the state in place)
    st = G._stage_writes(state, batch, ck)
    live = st.tid < B
    carry_in = torch.where(live, st.carry[st.tid.clamp(max=B - 1).long()], torch.zeros_like(st.tid))
    ks, ps = G.clone_state(state), G.clone_state(state)
    mk = kernels.merge(ks.grid, ks.count, ks.bmax, ks.floor, st.st_code, st.st_ev, st.tid, carry_in, now, old_post)
    mp = G._merge_buckets_plain(ps, st, carry_in, now, old_post)
    err = max_abs_err((ks.grid, ks.count, ks.bmax, ks.floor, mk.reshape(())),
                      (ps.grid, ps.count, ps.bmax, ps.floor, mp.reshape(())))
    reps = 20
    pool = [G.clone_state(state) for _ in range(reps + 2)]
    it = iter(pool)

    def merge_once():
        s = next(it)
        kernels.merge(s.grid, s.count, s.bmax, s.floor, st.st_code, st.st_ev, st.tid, carry_in, now, old_post)

    ms = cuda_ms(merge_once, reps)
    ppool = iter([G.clone_state(state) for _ in range(5)])
    plain_ms = cuda_ms(lambda: G._merge_buckets_plain(next(ppool), st, carry_in, now, old_post), 3)
    nbytes, ops = merge_work(state, ks, st, 1)
    row("merge", "merge.cu", "foundationdb_tpu/conflict/grid.py:402", err, ms, plain_ms, nbytes, ops)

    # K4a device reshard at the same grid shape
    N = B * S
    used = (torch.arange(S, device=dev)[None, :] < state.count[:, None]).reshape(N)
    dest = torch.cumsum(used, 0, dtype=torch.int32) - 1
    rk = kernels.maint_reshard(state.grid, state.floor, used, dest, B, S)
    rp_state, rp_press = G.reshard_device_plain(state, used, B, S)
    n_live = int(used.sum())
    # the live rows, count and floor read; the whole new grid, pivots,
    # count, bmax, floor and pressure written (used/dest are the wrapper's
    # intermediates, not the function's)
    nbytes = (n_live * Lp1 + 2 * B + B * S * Lp1 + B * (L + 3) + 1) * cell
    row("maint_reshard", "maint.cu", "foundationdb_tpu/conflict/grid.py:718",
        max_abs_err(tuple(rk), tuple(rp_state) + (rp_press,)),
        cuda_ms(lambda: kernels.maint_reshard(state.grid, state.floor, used, dest, B, S), 20),
        cuda_ms(lambda: G.reshard_device_plain(state, used, B, S), 3),
        nbytes, n_live * Lp1 + B * S)

    # K4b rebase
    delta = max(now // 2, 1)
    bk = kernels.maint_rebase(state.grid, state.count, state.floor, delta)
    bp = G.rebase_plain(state, delta)
    nbytes = n_live * cell + 2 * B * cell + B * S * Lp1 * cell + 2 * B * cell
    row("maint_rebase", "maint.cu", "foundationdb_tpu/conflict/grid.py:704",
        max_abs_err(bk, (bp.grid, bp.bmax, bp.floor)),
        cuda_ms(lambda: kernels.maint_rebase(state.grid, state.count, state.floor, delta), 20),
        cuda_ms(lambda: G.rebase_plain(state, delta), 5),
        nbytes, B * S * 3)
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
    T, KR, _ = batch.rb.shape
    plo, phi = SH.partition_bounds(L, P, dev)
    rows = []
    row = row_maker(rows, launches)

    # K6 history over the partitions, reads clipped in the kernel
    hargs = (*states, plo, phi, batch.rb, batch.re, batch.t_snap)
    hk = kernels.history_parts(*hargs)
    hp = SH.history_conflicts_sharded_plain(states, batch, plo, phi)
    nbytes = (2 * T * KR * L + T + 2 * P * L) * CELL + T
    ops = 0
    for p in range(P):
        rb, re = SH.clip(batch.rb, batch.re, plo[p], phi[p])
        nb, no = history_work(SH.partition(states, p), rb, re)
        nbytes, ops = nbytes + nb, ops + no
    row("history_parts", "history.cu", "foundationdb_tpu/conflict/sharded.py:149",
        max_abs_err(hk, hp),
        cuda_ms(lambda: kernels.history_parts(*hargs), 50),
        cuda_ms(lambda: SH.history_conflicts_sharded_plain(states, batch, plo, phi), 3),
        nbytes, ops)

    # K6 merge over the flat [P·B] view, on fresh clones
    commit = G.intra_batch_commits(batch, hk | (batch.t_has_reads & (batch.t_snap < old_pre)))
    st = SH.stage_writes_sharded(states, batch, commit, plo, phi)
    flat = SH.flat_view(states)
    live = st.tid < P * B
    carry_in = torch.where(live, st.carry[st.tid.clamp(max=P * B - 1).long()], torch.zeros_like(st.tid))

    def margs(s):
        return (s.grid, s.count, s.bmax, s.floor, st.st_code, st.st_ev, st.tid, carry_in, now, old_post)

    ks, ps = G.clone_state(flat), G.clone_state(flat)
    mk = kernels.merge_parts(*margs(ks), P)
    mp = G._merge_buckets_plain(ps, st, carry_in, now, old_post, P)
    err = max_abs_err((ks.grid, ks.count, ks.bmax, ks.floor, mk), (ps.grid, ps.count, ps.bmax, ps.floor, mp))
    it = iter([G.clone_state(flat) for _ in range(22)])
    ms = cuda_ms(lambda: kernels.merge_parts(*margs(next(it)), P), 20)
    pit = iter([G.clone_state(flat) for _ in range(5)])
    plain_ms = cuda_ms(lambda: G._merge_buckets_plain(next(pit), st, carry_in, now, old_post, P), 3)
    nbytes, ops = merge_work(flat, ks, st, P)
    row("merge_parts", "merge.cu", "foundationdb_tpu/conflict/sharded.py:160", err, ms, plain_ms, nbytes, ops)

    # K7a reshard of every partition at its grid shape
    used = (torch.arange(S, device=dev) < states.count[..., None]).reshape(P, B * S)
    dest = torch.cumsum(used, 1, dtype=torch.int32) - 1
    rk = kernels.maint_reshard_parts(states.grid, states.floor, used, dest, B, S)
    rp_state, rp_press = SH.reshard_parts_plain(states, used, B, S)
    n_live = int(used.sum())
    nbytes = (n_live * Lp1 + 2 * P * B + P * B * S * Lp1 + P * B * (L + 3) + P) * CELL
    row("maint_reshard_parts", "maint.cu", "foundationdb_tpu/conflict/mesh_backend.py:477",
        max_abs_err(tuple(rk), tuple(rp_state) + (rp_press,)),
        cuda_ms(lambda: kernels.maint_reshard_parts(states.grid, states.floor, used, dest, B, S), 20),
        cuda_ms(lambda: SH.reshard_parts_plain(states, used, B, S), 3),
        nbytes, n_live * Lp1 + P * B * S)

    # K7b rebase of every partition as one flat grid
    delta = max(now // 2, 1)
    bk = kernels.maint_rebase_parts(states.grid, states.count, states.floor, delta)
    bp = SH.rebase_parts_plain(states, delta)
    nbytes = (n_live + 4 * P * B + P * B * S * Lp1) * CELL
    row("maint_rebase_parts", "maint.cu", "foundationdb_tpu/conflict/mesh_backend.py:499",
        max_abs_err(bk, (bp.grid, bp.bmax, bp.floor)),
        cuda_ms(lambda: kernels.maint_rebase_parts(states.grid, states.count, states.floor, delta), 20),
        cuda_ms(lambda: SH.rebase_parts_plain(states, delta), 5),
        nbytes, P * B * S * 3)
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
        return G.searchsorted_lex(codes, q, "left"), G.searchsorted_lex(codes, q, "right")

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
        cuda_ms(lambda: kernels.search(codes, q), 50),
        cuda_ms(plain, 5),
        nbytes, Q * 2 * steps * L)
    torch.cuda.synchronize()
    return rows


def run_mesh(want_oracle, offset: int, card: str) -> list[dict]:
    """Phase 7: the partitioned resolver's main path, then its kernels."""
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
    path = ("history_parts", "intra_batch", "merge_parts", "maint_reshard_parts", "maint_rebase_parts")
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
    return check_partition_kernels(cs._states, hbatch, (now, old, old), launches)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2

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
    path = ("history", "intra_batch", "merge", "maint_reshard", "maint_rebase")
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

    # 5. each kernel against its plain version, at the main path's shapes
    log(f"kernel checks on the state after the first group [{card}]:")
    rows = check_kernels(state_g1, hbatch, vers, launches)

    # 7. the partitioned resolver
    mesh_rows = run_mesh(want_oracle, offset, card)
    # 8. the range index
    index_rows = run_range_index(card)

    # 6. results
    log(json.dumps({"kernels": rows + index_rows + mesh_rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
