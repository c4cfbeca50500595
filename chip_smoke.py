#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Drives the resolver's conflict check through the port's entry point,
``new_conflict_set("torch1", key_width=12, capacity=1<<19)`` (the one grid
that ``"torch"`` is on a host of one card), at the size of
``bench.py`` (200 batches × 2500 transactions, one read and one write range
each over a 1M-key keyspace, a 50-batch MVCC window, groups of 40 batches
with 3 groups in flight; a 32768 × 32 × 4 uint32 grid = 16 MiB on the
card). Phases, each of which raises on failure:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the CUDA kernels from ``foundationdb_tpu_torch/conflict/kernels/csrc``;
3. run the first group on a warm-up instance (its state after that group is
   the kernel checks' input), and the whole workload through the plain
   PyTorch path on the CPU and through the port's oracle (each in a child
   process started before the build, both done before phase 4);
4. run the main path on the card with every kernel launch count set to 0
   just before it; versions start just below 2^30, so the run crosses the
   int32 rebase threshold as a long-running cluster does (K4b), and one
   device reshard is forced between groups (K4a). Every verdict must equal
   the CPU path's and the oracle's, and every kernel must have launched:
   the group scan (``csrc/scan.cu``) once a dispatched group and no
   per-batch resolve kernel. Then 10 more batches under
   ``torch.profiler``: one line of CUDA kernels launched per batch and the
   encode / glue dispatch / kernel time split;
5. hold each kernel against its plain version on the card at the main
   path's shapes (exact equality: outputs are integers and bools), time
   both with CUDA events (the table's ``ms`` and ``plain_ms``) and the
   kernel's device time too (``device_ms``: the calls queued behind a
   sleeping kernel, so the host's launch gaps drop out): K1, then K1 once
   more with every read of the batch keyspace-wide (the stress case), K2
   from the codes, the K3 staging launch, the K3 merge launch with the
   floor raise, K4a, K4b; then the merge launch once more when a single
   committed clear spans the whole keyspace. Then the group scan, exactly
   against the loop of those standalone kernels and against the plain
   loop, both timed beside it: (a) the bench group (40 batches after the
   first), (b) the commit path's widest batch shape (T = 64, KR = 8,
   KW = 1, L = 8), (c) four stacked partitions, (d) a group whose middle
   batch overflows staging, (e) three batches of phase 13's bulk load
   (KW = 2048); each case, and each group of one of phases 13-15, also
   prints one ``{"scan_phases": ...}`` line: the per-phase timer inside
   the launch (``kernels.resolve_many(..., phase_ns=)``), ms a group a
   phase;
6. after phases 7 to 19: print the kernel table (every kernel of the
   paths that its path launched, the spread's and the data replicas' resolve kernels, K5 also at the storage shapes, K1-K3 and K5 also on the commit
   path, in the dynamic cluster, in the soak and in the in-process TCP
   cluster, K5 also on the B-tree's index), the card line and the result
   line;
7. the partitioned resolver, ``new_conflict_set("torch_mesh", key_width=12,
   capacity=1<<19, n_parts=4)`` (4 partitions × 8192 × 32 × 4 uint32 =
   16 MiB), over the same workload with every key re-encoded
   order-preservingly so its first lane is uniform over 2^32 (the ASCII
   keys would all land in partition 0): every verdict must equal the
   oracle's from phase 3; versions cross the int32 rebase; one partition
   reshard is forced between groups; every partition must hold live rows;
   the scan launched once a group over the 4 stacked partitions; then the
   standalone kernels (K6 history, also on keyspace-wide reads, staging and
   merge over partitions, K7 reshard and rebase over partitions) are held
   against their plain versions, and its profile line is printed;
18. right after phase 7, the same partitions spread over the host's cards
   (``TorchMeshConflictSet(devices=...)``, ``conflict/sharded.py``
   ``Spread``): (a) ``new_conflict_set("torch")`` must be the one grid on
   a host of one card and the spread over every card on a host of more;
   (b) phase 7's workload, reshard and rebase through 4 partitions on
   ``[cuda:0] * 4`` (and, where there are more cards, one partition a
   card over all of them): every verdict the oracle's, the gathered final
   state equal to phase 7's array by array, live rows in every partition,
   the spread's group scan (``kernels.resolve_many_spread``, csrc/scan.cu
   over every entry of a card) launched once a card a dispatched group and
   K6 history, K2, K6 staging and K6 merge never, K7 reshard and rebase
   launched, every group the path resolved equal (verdicts, per-batch
   pressures, every entry's state) to the loop of standalone kernels from
   the state it started from, card memory back after ``close()``, and
   over cards that reach each other's memory the exchange on its "peer"
   transport (each card's inbox in its own memory); the last full group's
   launch equal to the plain loop on the card (``plain_spread_group``) and
   timed beside it and the loop, its bound the busiest card's share of the
   work (its kernel row), one ``{"spread_phases": ...}`` line a card from
   its per-phase timer (the exchange of H its own phase, split at three
   points inside it: batch 0, the median and the largest of the rest) with
   the transport and the group's host wall time; the path's last batch
   through ``check_built_resolve``, the check phases 13-16 make of what
   the resolver built (on a spread of several entries its launch, the
   batch a group of one, against the plain loop on the card, its own
   row); and the profile line; (c) where more than one card is visible, K6 history and K5 launched on
   the last card, not the current one, against their plain versions; (d)
   the exchange's bounded wait on the peer transport: a two-card plan with
   only card 0's launch queued puts its words into card 1's inbox, gives
   up at its bound, and the timeout is a kernel fault; the card serves
   the next launch. One ``{"spread": ...}`` line;
19. right after phase 18, the mesh's ``data`` axis (``Spread`` rows of
   replicas that split the read slots): (a) ``tools.multichip``'s
   ``dryrun_multichip(8)`` over 8 cards or ``[cuda:0] * 8`` (4 partitions
   x 2 replicas), its figures equal to its CPU twin's (run in a child
   process meanwhile), and
   ``dryrun_sweep(8, 6, 192)`` with every verdict the native's; (b)
   phase 7's workload, reshard and rebase through 4 partitions x 2
   replicas on ``[cuda:0] * 8`` (and in rows of two cards where there is
   an even number of them): every verdict the oracle's, every replica's
   final state phase 7's, phase 18 (b)'s launch gates and loop
   yardstick, KR = 1 padded to 2, its launch's device time and timer
   line; (c) 40
   batches of 8 reads a transaction through 4 x 2 and 4 x 1, both on the
   spread's group scan: verdicts equal to each other and to the oracle
   (computed in a child process meanwhile), states equal, every group
   equal to the loop, and the 4 x 2 run's launch timed (its device time
   and timer line); card memory back after ``close()``. One
   ``{"data_mesh": ...}`` line;
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
   at once (the proxies' pipelining): ``Resolver(backend="torch1")`` (the
   one grid, pinned) with CONFLICT_ENCODE_THREADS 1, ``"torch"`` (what the
   host builds: the one grid on one card, the spread over every card on
   more; the gates follow it, as they do in phases 11 and 13-16) with 0,
   and ``"torch_mesh"`` (4 partitions, the spread keys) with 1 and 0,
   every verdict equal to the oracle's
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
   One JSON line a case;
12. the storage role: one tlog and one ``StorageServer`` (index on, on the
   card by default) on the port's ``Sim``, each on its own SimDisk, fed
   through the tlog's commit endpoint with phase 8's shape of keys (1M
   random 12-byte keys, 16-byte values) in commits of 10,000, then empty
   commits until the durable engine and the index hold every key. 50
   rounds of one multiGet of 4096 keys (70 % present) and one
   multiGetRange of 4096 forward ranges at the last version, with a few
   getKeyValues and getValue requests; then a delta of 1000 new keys and
   1000 single-key clears, after which the index must equal a fresh one
   over the engine's keys, and 5 more rounds. Every reply must equal a
   host model of the writes (a dict and a sorted list), every engine miss
   must be served by the index (``multiGetFallbackKeys`` 0) and K5 must
   launch for every request; K5 is then held against its plain version
   at the two storage shapes (Q = 4096 and 8192 over 2^20 rows). One
   ``{"storage": ...}`` JSON line: ingest and durable seconds, p50/p95
   request ms, lookups/s through the role beside phase 8's and host
   ``bisect``'s, the index search's share, ``apply_delta`` ms and bytes,
   the device's idle share over a round.
13. the commit path: the port's static ``Cluster`` (2 proxies, 2
   resolvers on ``torch``, 1 tlog, 1 storage server with its durable
   engine, bench_e2e's datacenter latency) on the port's ``Sim(seed=0)``,
   the resolution balancer on, and one ``Database``. 1M keys
   ``b"rw/%08d"`` with 16-byte values are loaded in transactions of 2000
   sets, until the engine and its index hold them; then mix A "90_10" (100
   actors × 50 transactions of 9 parallel gets and 1 set) and mix B
   "write" (100 × 20 of 10 sets), retried through ``on_error``. Gates: a
   serializability referee over every committed transaction (reads, read
   and commit versions, batch order), every written key read back through
   a multiGet, the scan and K5 launched in the mixes
   with no multiGet fallback, both resolvers' guards HEALTHY with no fault,
   both resolvers given transactions in mix A (the balancer moved the
   boundary) (its CPU twin at 100,000 keys, identical transcripts on the
   CPU and on the card, is cut for phase 16's budget). K1, K2,
   K3 and the scan are then held against their plain versions on mix A's
   widest batch and K5 at its widest multiGet search. One ``{"commit_path": ...}``
   JSON line: load and durable seconds, per mix committed txn/s and ops/s,
   NotCommitted, commit and GRV latency (sim and wall), per resolver
   batches, transactions, resolveLatency and the encode / dispatch /
   collect split, the proxies' phase latencies, multiGets and their keys,
   the grid's growths and device reshards, the device's idle share.
14. the dynamic cluster: the port's ``DynamicCluster`` (3 coordinators, 2
   proxies, 2 resolvers on ``torch``, 2 tlogs and 4 storage servers, both
   at 2 replicas; default knobs and phase 13's latency) on ``Sim(seed=0)``,
   one ``Database.from_coordinators``. It forms, loads 500,000 keys (half
   of phase 13's, for the script's budget)
   until all four storage servers' engines and indexes hold their shards,
   runs a mix-A round (100 actors x 10 transactions), kills the master's
   worker during a round (recovery: fresh resolvers at the recovery
   version), kills a storage worker and reboots it 1 s later (its index
   rebuilt from the engine it recovers), kills another storage worker for
   good until data distribution has every team at 2 replicas again, runs
   a last round and reads every key back from a fresh client. Gates: the
   read-back equals the referee's model, the serializability referee
   (unknown results count where their proxy logged them within their
   generation), every generation's guards HEALTHY on ``torch`` on the
   card with the scan launched, K5 launched on the rebooted and the filled
   servers, no multiGet fallback, and a CPU twin at 50,000 keys (run in a
   child process beside the card's runs) with an identical transcript. Then K1-K3 and the scan against their plain versions on the
   newest generation's widest batch and K5 on the rebooted and the filled
   indexes. One ``{"dynamic_cluster": ...}`` JSON line: per step the
   times and mix figures, time to recover and to the new generation's
   first commit (sim and wall), time to serve after the reboot, time to
   full replication and keys moved, recoveries, per generation resolver
   batches and grid growths, card memory after each step, the device's
   idle share over a profiled round. After the master kill, the resolvers
   the surviving workers destroyed must have taken their grids off the
   card (the killed worker's stay: the Sim keeps its roles); the step
   reports the bytes.
15. the chaos soak: the port's ``tools.soak.run_one`` on the card for
   ``tests/test_soak.py``'s seeds 0, 1, 4 and 7, seed 0 with kernel faults
   and the overload burst forced, then seeds from 8 while the phase has
   run under 30 s (none past 18). Each seed draws its own cluster
   shape, knobs, buggify sites and fault workloads from its seed. Gates a
   seed: the run's own checks (the workloads' oracles, the exact ledger
   under kernel faults, the ConsistencyCheck, the prefilter oracle), a
   CPU twin with the identical summary, K5 launched, the scan on a ``torch``
   seed with every live guard on the card (or failed over by an injected
   fault), the forced seed's failover to ``native`` and promotion back,
   and ``torch.cuda.memory_allocated()`` back at its value before the
   phase. K1-K3 and the scan on the forced seed's widest batch and K5 on its widest
   search against their plain versions. One ``{"soak": ...}`` line a seed
   and one ``{"soak_summary": ...}`` line.
16. the real-process cluster. (a) The port's ``TcpCluster``
   (``tools/tcp_soak.py``), each server a real ``fdbserver --device cuda``
   process: 1 coordinator and workers of class storage x3, transaction x2
   and stateless x2; 2 proxies, 2 resolvers on ``torch``, 2 tlogs and 2
   storage servers at 2 replicas, the storage index on. Its 500,000 keys
   ``b"rw/%08d"`` (16-byte values) come from 4 load client processes
   (this script with ``--tcp-loader``); once both storage servers are
   durable at the load's last version, ``perf``'s 90_10 preset runs for
   20 s from 2 ``tcp-client`` processes (this script with ``--tcp-mix``,
   which times them). Then ``status json`` through the port's cli: both
   resolvers HEALTHY on the card with 0 failovers, batches dispatched and
   the scan launched in their processes, both indexes on the card,
   current with their engines, with K5 launched and no multiGet key
   answered from the engine since a status read that showed every index
   current (taken once the load was durable). The process
   hosting the master is SIGKILLed and restarted, a probe write is timed
   until it commits, the new resolvers are checked the same way; once
   every index has caught up again (the restarted server rebuilds its
   index at its first durability advance), a fresh client reads every
   key back and makes 1,000 point reads, and the storage gate holds over
   those reads. A server that dies (but the killed
   one) fails the phase, its output printed. One ``{"tcp_cluster": ...}``
   line: processes and roles, load and mix figures, the proxies' commit
   phases, recovery seconds, the read-back, each process's card memory as
   its status pull reports it. (b) ``perf --mode tcp-inproc`` through ``perf.main``: the same
   layout as RealWorlds on one RealLoop in this process at 100,000 keys
   and a 10 s mix, over loopback and then over sockets; every resolver's
   guard HEALTHY on the card, K1-K3 and the scan on the widest batch and K5 on the
   widest search held to their plain versions and timed (one ``{"tcp_inproc":
   ...}`` line). (c) The 55 bindingtester streams of
   ``tests/test_bindingtester.py`` (seeds 0-49, the long stream, the four
   chaos seeds) through the port's ``Cluster`` on the card, each
   identical to the port's model database (one ``{"bindings": ...}`` line).
17. the port's lint and its B-tree engine. (a) ``cli lint --json`` (the
   ``main`` of ``python -m foundationdb_tpu_torch.tools.cli``) over this
   checkout must be clean (one ``{"lint": ...}`` line: files, per-rule counts, seconds).
   (b) ``kv/native_engine.py`` ``KeyValueStoreBTree``, built with g++ at
   first use: cell 3's draw of random ``b"%012d"`` keys with phase 12's
   16-byte values, cut to 50,000 sets (the engine writes about 64 KiB of
   pages a set), committed every 10,000 into a file under ``build/``,
   closed and reopened; the full scan must equal the host model in count
   and order, and 4096 point reads too. K5's ``TorchRangeIndex`` is then
   built on the card from the reopened rows; 10 rounds of 4096 lookups
   (70 % present) and 4096 of phase 12's ranges must equal ``bisect``,
   each found point must hold the B-tree's value, and the first 64
   intervals of a round must count the B-tree's range read; K5 is held
   against its plain version. One ``{"btree": ...}`` line: writes/s, set,
   commit, reopen and scan seconds, pages, live and file bytes.

Each path runs with every kernel launch count set to 0 just before it and
read just after, and every kernel of the path must have launched.

Exits non-zero, without a result line, when no CUDA card is visible.
Usage: ``python3 chip_smoke.py``; ``--phases 11,13,16b`` runs phases 1 and
2, then only the phases named (16a, 16b and 16c: phase 16's parts) with
what they need (phase 3's workload and oracle, phase 7 for 10, 18 and 19,
phase 4 for 5, phase 8 for 12) in a whole run's order, and prints their
kernel rows but no result line; ``--tcp-only``, ``--btree-only``,
``--spread-only`` and ``--data-only`` are ``--phases`` 16, 17, 18 and 19;
``python3 chip_smoke.py --profile-only``
prints only the two resolver paths' profile lines (each path warmed by one
group first) and no result line, and runs from any checkout of the port;
``--history-only`` adds the history kernels of both paths on the bench batch
and on keyspace-wide reads (one JSON line), ``--reshard-only`` the reshard
entry point of both paths with its glue and ``--rebase-only`` the rebase
entry point of both paths with its glue beside a copy of the same grid (one
JSON line each), for comparisons of two checkouts in one call;
``--scan-only`` runs phases 1, 2, phase 5's standalone kernels and scan
cases, then synthetic groups of one at phases 13-15's widest shapes, each
scan case with its timer line (no result line).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import time
import weakref
import zlib

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
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink, each way (900 GB/s all to all)
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
    r"|reshard_scan|reshard_build|rebase_kernel|search_both|search_warp|resolve_many_kernel)\b"
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


def path_rows(rows: list[dict]) -> list[dict]:
    """The rows of the kernels line: the kernels held to their plain
    versions that their phase's path launched. One checked but launched
    nowhere on its path (the standalone K1-K3 beside the scan, which does
    their work in one launch a group) stays in the log only."""
    off = [r["name"] for r in rows if not r["launches"]]
    if off:
        log("held to their plain versions but not launched on their phase's path: " + json.dumps(off))
    return [r for r in rows if r["launches"]]


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


def merge_case(state, st, vers, n_parts: int | None, reps: int = 20):
    """The merge launch (with its floor raise; K3 on one grid for
    ``n_parts`` None, else K6 over the flat view of ``n_parts`` partitions)
    against its plain version, each on fresh clones of ``state`` since both
    update it in place: (max abs err, kernel_ms's timing, plain ms, the
    kernel's state after)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels

    now, _, old_post = vers

    def launch(s):
        args = (s.grid, s.count, s.bmax, s.floor, *st[:4], now, old_post)
        return kernels.merge(*args) if n_parts is None else kernels.merge_parts(*args, n_parts)

    ks, ps = G.clone_state(state), G.clone_state(state)
    mk = launch(ks)
    mp = G.merge_staged_plain(ps, st, now, old_post, n_parts or 1)
    err = max_abs_err((*ks[1:], mk), (*ps[1:], mp))
    it = iter([G.clone_state(state) for _ in range(5 * reps + 2)])  # as many as kernel_ms may call
    timed = kernel_ms(lambda: launch(next(it)), reps)
    pit = iter([G.clone_state(state) for _ in range(5)])
    plain_ms = cuda_ms(lambda: G.merge_staged_plain(next(pit), st, now, old_post, n_parts or 1), 3)
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
            "replaces": replaces, "launches": launches.get(name, 0),
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


def check_resolve_kernels(state, hbatch, vers, launches: dict):
    """The kernels of one batch's resolve against their plain versions on
    the card: K1 history (on ``hbatch`` and on keyspace-wide reads), K2,
    the K3 staging and the K3 merge with its floor raise. Exact equality;
    times from CUDA events. Returns (the rows, the uploaded batch, K2's
    commit flags, the staged writes)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import torch_backend as TB

    old_pre = vers[1]
    batch = TB.upload(hbatch, state.grid.device)
    B, S, Lp1 = state.grid.shape
    L = Lp1 - 1
    T, KW = batch.rb.shape[0], batch.wb.shape[1]
    rows = []
    row = row_maker(rows, launches)

    # K1 history, on the bench batch and on keyspace-wide reads
    rows += check_history(state, batch, launches)[0]
    hk = kernels.history(*state, batch.rb, batch.re, batch.t_snap)

    # K2 intra-batch greedy commit
    ck = check_intra_batch(batch, hk | (batch.t_has_reads & (batch.t_snap < old_pre)), row)

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
    err, timed, plain_ms, ks = merge_case(state, st, vers, None)
    row("merge", "merge.cu", "foundationdb_tpu/conflict/grid.py:526", err, timed, plain_ms,
        *merge_work(state, ks, st, 1))
    return rows, batch, ck, st


def check_intra_batch(batch, H, row) -> torch.Tensor:
    """K2 against its plain version: the kernel from the codes, the plain
    version from dense endpoint ranks (which it computes); one row through
    ``row``. Returns the kernel's commit flags."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels

    T, KR, L = batch.rb.shape
    kargs = (batch.rb, batch.re, batch.wb, batch.we, H)
    ck = kernels.intra_batch(*kargs)
    cp = G.intra_batch_commits_plain(*G._endpoint_ranks(batch), H)
    nbytes, ops = intra_batch_work(T, KR, batch.wb.shape[1], L)
    row("intra_batch", "intra_batch.cu", "foundationdb_tpu/conflict/grid.py:297,337", max_abs_err(ck, cp),
        kernel_ms(lambda: kernels.intra_batch(*kargs), 20),
        cuda_ms(lambda: G.intra_batch_commits_plain(*G._endpoint_ranks(batch), H), 3),
        nbytes, ops)
    return ck


def check_reshard(state, n_buckets: int, n_slots: int, row) -> int:
    """K4a (``maint_reshard``) against ``grid.reshard_device_plain`` on
    ``state`` into ``n_buckets`` × ``n_slots``; one row through ``row``.
    Returns the live rows it moved."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels

    B, S, Lp1 = state.grid.shape
    used = (torch.arange(S, device=state.grid.device)[None, :] < state.count[:, None]).reshape(B * S)
    rk = kernels.maint_reshard(state.grid, state.count, state.floor, n_buckets, n_slots)
    rp_state, rp_press = G.reshard_device_plain(state, used, n_buckets, n_slots)
    n_live = int(used.sum())
    # the live rows, count and floor read; the whole new grid, pivots,
    # count, bmax, floor and pressure written (a kernel's scratch is not
    # the function's)
    nbytes = (n_live * Lp1 + 2 * B + n_buckets * n_slots * Lp1 + n_buckets * (Lp1 + 2) + 1) * CELL
    row("maint_reshard", "maint.cu", "foundationdb_tpu/conflict/grid.py:718",
        max_abs_err(tuple(rk), tuple(rp_state) + (rp_press,)),
        kernel_ms(lambda: kernels.maint_reshard(state.grid, state.count, state.floor, n_buckets, n_slots), 20),
        cuda_ms(lambda: G.reshard_device_plain(state, used, n_buckets, n_slots), 3),
        nbytes, n_live * Lp1 + B * S)
    return n_live


def check_kernels(state, hbatch, vers, launches: dict) -> list[dict]:
    """Each kernel against its plain version on the card, on the state
    after the first group and the next bench batch. Exact equality; times
    from CUDA events (the 16 MiB grid stays resident in the 50 MB L2, as it
    does between the main path's batches)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels

    rows, batch, ck, st = check_resolve_kernels(state, hbatch, vers, launches)
    row = row_maker(rows, launches)
    now = vers[0]
    B, S, _Lp1 = state.grid.shape

    # the same launch when one committed clear spans the whole keyspace and
    # nothing else commits: two touched buckets, all others floor-raised
    wb, we = batch.wb.clone(), batch.we.clone()
    wb[0], we[0] = 0, -1  # [the all-zero code, the all-0xFF code)
    wide = torch.zeros_like(ck)
    wide[0] = True
    sw = G._stage_writes(state, batch._replace(wb=wb, we=we), wide)
    err, timed, plain_ms, _ = merge_case(state, sw, vers, None)
    if err != 0:
        raise AssertionError(f"merge of a keyspace-wide clear differs from its plain version ({err})")
    log(f"  merge, one keyspace-wide clear ({int(G.spanned_buckets(sw, B).sum())} spanned buckets): "
        f"kernel {timed[1]:.4f} ms (CUDA events; on the device {fmt_ms(timed[0])})  plain {plain_ms:.4f} ms  "
        f"max_abs_err {err}")

    # K4a device reshard at the same grid shape
    check_reshard(state, B, S, row)
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


def scan_group(cs, batches, first: int):
    """``batches`` (read snapshots first, first + 1, ...) encoded by the warm
    resolver ``cs`` as one group at its version base, as its dispatch
    would: (the stacked group on its card, the version columns now /
    oldest before / oldest after)."""
    from foundationdb_tpu_torch.conflict import torch_backend as TB

    base, horizon = cs._base, cs.oldest_version
    hbs, cols = [], [[], [], []]
    for i, txs in enumerate(batches):
        now, old = first + i + WINDOW, first + i
        post = max(horizon, old)
        for c, v in zip(cols, (now - base, max(horizon - base, 0), max(post - base, 0))):
            c.append(v)
        horizon = post
        hbs.append(cs.encode(txs)[0])
    return TB.upload(TB.stack_batches(hbs, cs._lanes), cs._device), cols


def scan_bound(state, batches, cols, bounds=None) -> tuple[float, str]:
    """The least time of a group's work on this card: each batch's phases
    (K1 or K6 history, K2, K3 staging, K3 merge) bounded as the standalone
    kernels' rows bound them (``history_work``, ``intra_batch_work``,
    ``stage_work``, ``merge_work`` on this group's data, from the plain
    steps on a clone), summed over phases and batches. ``bound_by`` names
    the limit of the larger share of the sum."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import sharded as SH

    state = G.clone_state(state)
    stacked = state.grid.dim() == 4
    P = state.grid.shape[0] if stacked else 1
    B = state.grid.shape[-3]
    flat = SH.flat_view(state) if stacked else state
    share = {"bytes": 0.0, "operations": 0.0}

    def add(nbytes, ops):
        ms, by = bound(nbytes, ops)
        share[by] += ms

    for g in range(batches.rb.shape[0]):
        batch = G.Batch(*(x[g] for x in batches))
        T, KR, L = batch.rb.shape
        KW = batch.wb.shape[1]
        now, old_pre, old_post = (int(c[g]) for c in cols)
        nbytes, ops = (2 * T * KR * L + T) * CELL + T, 0  # the reads and snapshots in, H out
        if stacked:
            for p in range(P):
                rb, re = SH.clip(batch.rb, batch.re, bounds[0][p], bounds[1][p])
                nb, no = history_work(SH.partition(state, p), rb, re)
                nbytes, ops = nbytes + nb, ops + no
            H = SH.history_conflicts_sharded_plain(state, batch, *bounds)
        else:
            nb, no = history_work(state, batch.rb, batch.re)
            nbytes, ops = nbytes + nb, ops + no
            H = G.history_conflicts_plain(state, batch)
        add(nbytes, ops)
        add(*intra_batch_work(T, KR, KW, L))
        commit = G.intra_batch_commits_plain(*G._endpoint_ranks(batch), H | (batch.t_has_reads & (batch.t_snap < old_pre)))
        if stacked:
            wb, we = SH.clip(batch.wb, batch.we, bounds[0][:, None, None, :], bounds[1][:, None, None, :])
            st = SH._stage_clipped_plain(state, wb, we, commit)
        else:
            st = G._stage_writes(state, batch, commit)
        add(*stage_work(st, T, KW, L, B, P))
        before = G.clone_state(flat)
        G.merge_staged_plain(flat, st, now, old_post, P)
        add(*merge_work(before, flat, st, P))
    total = share["bytes"] + share["operations"]
    return total, max(share, key=share.get)


def plain_spread_group(spread, batches, cols, reads=None, work: dict | None = None):
    """The plain version of the spread's group scan on the tensors' own
    devices (the card too): ``sharded.resolve_many_spread_loop``'s loop of
    ``resolve_one_spread`` with each step's plain version (K6 history on
    each entry's read slice, H OR-ed over the entries by plain copies
    (``sharded.exchange``), K2, the clipped staging and the merge of every
    entry). Updates ``spread`` IN PLACE; returns (verdicts int8[G, T],
    pressures int32[G, P, 2]) on entry 0's device. With ``work`` (a dict),
    adds each card's least time for its share of the group there
    (``spread_bound``)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import sharded as SH

    entries = spread.entries
    reads = [(b.rb, b.re) for b in batches] if reads is None else reads
    dev0 = entries[0].device
    share = {}

    def add(card, nbytes, ops):
        ms, by = bound(nbytes, ops)
        share.setdefault(card, {"bytes": 0.0, "operations": 0.0})[by] += ms

    verdicts, pressures = [], []
    for g in range(batches[0].rb.shape[0]):
        views = [G.Batch(*(x[g] for x in b)) for b in batches]
        slices = [(rb[g], re[g]) for rb, re in reads]
        now, old_pre, old_post = (int(c[g]) for c in cols)
        T, KR, L = views[0].rb.shape
        KW, KRe = views[0].wb.shape[1], slices[0][0].shape[1]
        if work is not None:  # history: the card's read slices and snapshots in, H out; K2 once a card
            hist = {}  # card: [its read slices, bytes, ops]
            for e, (rb, re) in zip(entries, slices):
                h = hist.setdefault(e.device, [set(), 0, 0])
                h[0].add(e.replica)
                for p in range(e.states.grid.shape[0]):
                    nb, no = history_work(SH.partition(e.states, p), *SH.clip(rb, re, e.plo[p], e.phi[p]))
                    h[1], h[2] = h[1] + nb, h[2] + no
            for card, (replicas, nb, no) in hist.items():
                add(card, (2 * T * KRe * len(replicas) * L + T) * CELL + T + nb, no)
                add(card, *intra_batch_work(T, KR, KW, L))
        Hs = SH.exchange([SH.history_conflicts_sharded_plain(e.states, b._replace(rb=rb, re=re), e.plo, e.phi)
                          for e, b, (rb, re) in zip(entries, views, slices)])
        v, ps = None, []
        for e, b, H in zip(entries, views, Hs):
            too_old = b.t_has_reads & (b.t_snap < old_pre)
            commit = G.intra_batch_commits_plain(*G._endpoint_ranks(b), H | too_old)
            k, B = e.states.grid.shape[:2]
            wb, we = SH.clip(b.wb, b.we, e.plo[:, None, None, :], e.phi[:, None, None, :])
            st = SH._stage_clipped_plain(e.states, wb, we, commit)
            flat = SH.flat_view(e.states)
            before = G.clone_state(flat) if work is not None else None
            max_kept = G.merge_staged_plain(flat, st, now, old_post, k)
            if work is not None:
                add(e.device, *stage_work(st, T, KW, L, B, k))
                add(e.device, *merge_work(before, flat, st, k))
            if e.replica == 0:
                ps.append(torch.stack([st.max_staged, max_kept], dim=-1).to(dev0, non_blocking=True))
            if v is None:
                v = (~commit).to(torch.int8).masked_fill(too_old, G.TOO_OLD)
        verdicts.append(v)
        pressures.append(torch.cat(ps))
    if work is not None:
        work.update(share)
    return torch.stack(verdicts), torch.stack(pressures)


def spread_bound(spread, batches, cols, reads=None) -> tuple[float, str, dict]:
    """The least time of a spread's group on its cards, from the plain
    steps on a clone (``plain_spread_group``): each card's share bounded as
    ``scan_bound`` bounds a stack's (each phase's bytes over the memory rate
    or its operations over the peak rate, whichever is longer, summed over
    the phases and batches), with the history of that card's entries on
    their read slices (each slice read once a card), K2 once a card, and
    the staging and merge of each of its entries; the cards run side by
    side, so the group's bound is the busiest card's. Returns (ms, the
    limit of the larger share of that card's sum, ms a card)."""
    share = {}
    plain_spread_group(spread.clone(), batches, cols, reads, work=share)
    per_card = {str(c): v["bytes"] + v["operations"] for c, v in share.items()}
    busiest = max(share, key=lambda c: per_card[str(c)])
    return per_card[str(busiest)], max(share[busiest], key=share[busiest].get), per_card


def check_scan(label: str, state, batches, cols, launches: dict, bounds=None, reps: int = 5,
               plain_time: bool = True) -> dict:
    """The group scan (``kernels.resolve_many``, one launch) on a clone of
    ``state`` against the loop of the standalone kernels
    (``grid.resolve_many_loop``) and the plain loop
    (``grid.resolve_many_plain``, on the card), each on its own clone:
    verdicts, per-batch pressures, group maxima and every state array
    exactly. Then the scan timed on fresh clones (CUDA events around the
    calls, and their device time queued behind a sleeping kernel; it is
    one kernel, so no profiler pass names its parts: its own per-phase
    timer does, one ``scan_phases`` line), the loop beside it the same way
    (the yardstick), the plain loop once, and the bound (``scan_bound``).
    Returns (the kernel-table row, the per-batch pressures)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels

    n_batches = batches.rb.shape[0]
    S2 = G.staging_slots(state.grid.shape[-2])
    vers = G.version_rows(*cols, state.grid.device)

    def scan(s):
        return kernels.resolve_many(*s, bounds, *batches, vers, S2)

    def loop(s):
        return G.resolve_many_loop(s, batches, *cols, bounds)

    def plain(s):
        return G.resolve_many_plain(s, batches, *cols, bounds)

    got = G.clone_state(state)
    verdicts, pressures, gmax = scan(got)
    errs = {}
    for name, fn in (("loop", loop), ("plain", plain)):
        want = G.clone_state(state)
        wv, wp = fn(want)
        errs[name] = max_abs_err((verdicts, pressures, gmax, *got[1:]), (wv, wp, wp.amax(dim=0), *want[1:]))
    if any(errs.values()):
        raise AssertionError(f"the scan ({label}) differs from the loop of kernels or the plain loop: {errs}")

    def clones(n):
        return iter([G.clone_state(state) for _ in range(n)])

    it = clones(4 * reps + 2)  # as many as cuda_ms and queued_ms may call
    ms = cuda_ms(lambda: scan(next(it)), reps)
    device_ms = queued_ms(lambda: scan(next(it)), reps, ms)
    lit = clones(reps + 5)
    loop_ms = cuda_ms(lambda: loop(next(lit)), reps)
    # one call queued: a bench group's 8 launches a batch fill the launch
    # queue behind the sleeping kernel when more calls are
    loop_device_ms = queued_ms(lambda: loop(next(lit)), 1, loop_ms)
    plain_ms = None
    if plain_time:
        pit = clones(1)
        plain_ms = cuda_ms(lambda: plain(next(pit)), 1, warmup=0)
    b_ms, b_by = scan_bound(state, batches, cols, bounds)
    T, KR, L = batches.rb.shape[1:]
    P = state.grid.shape[0] if state.grid.dim() == 4 else 1
    scan_phases(label, state, batches, vers, S2, bounds, reps, device_ms,
                [n_batches, T, KR, batches.wb.shape[2], L, P])
    row = {
        "name": "resolve_many", "route": "cuda",
        "source": "foundationdb_tpu_torch/conflict/kernels/csrc/scan.cu",
        "replaces": "foundationdb_tpu/conflict/grid.py:681; foundationdb_tpu/conflict/sharded.py:220",
        "launches": launches.get("resolve_many", 0), "max_abs_err": max(errs.values()),
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "loop_ms": loop_ms, "loop_device_ms": loop_device_ms,
        "group": [n_batches, T, KR, batches.wb.shape[2], L, P],
        "max_pressure": [int(x) for x in gmax.amax(dim=0)],
    }
    log(f"  resolve_many, {label} (G={n_batches} T={T} KR={KR} KW={batches.wb.shape[2]} L={L} P={P}): "
        f"one launch {ms:.4f} ms (CUDA events; on the device {fmt_ms(device_ms)}), "
        f"{ms / n_batches:.4f} ms a batch; the loop of standalone kernels {loop_ms:.4f} ms (on the "
        f"device {fmt_ms(loop_device_ms)}); plain loop {fmt_ms(plain_ms)}; bound {b_ms:.5f} ms ({b_by}); "
        f"max pressure {row['max_pressure']}; max_abs_err {row['max_abs_err']}")
    return row, pressures


def scan_phases(label: str, state, batches, vers, S2: int, bounds, reps: int, device_ms, group: list) -> None:
    """The per-phase timer inside the scan's launch: ``reps`` launches on
    fresh clones of ``state``, each writing the card's clock at every phase
    boundary of every batch (``resolve_many(..., phase_ns=)``), printed as
    one ``{"scan_phases": ...}`` line of ms a group a phase, beside the
    launch's device time without the timer."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels

    stamps = torch.zeros((reps, group[0], len(kernels.SCAN_PHASES) + 1), dtype=torch.int64,
                         device=state.grid.device)
    for r in range(reps):
        kernels.resolve_many(*G.clone_state(state), bounds, *batches, vers, S2, phase_ns=stamps[r])
    out = {"case": label, "group": group, **kernels.scan_phase_ms(stamps), "device_ms": device_ms,
           "card": card_line()}
    log(json.dumps({"scan_phases": out}))


def scan_groups_of_one(launches: dict) -> None:
    """The scan on synthetic groups of one at the widest batch shapes of
    phases 13-15 (the commit path's T = 64, KR = 8, KW = 1; the dynamic
    cluster's T = 64, KR = 16; the soak's T = 8, KW = 16), each on a
    resolver's grid (key width 32, capacity 2^14, the resolver's knobs)
    after one group of its shape: the same check as ``check_scan``, for an
    A/B of two checkouts without phases 13-15."""
    from foundationdb_tpu_torch.conflict.api import CommitTransaction
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet

    for label, T, KR, KW in (("commit path", 64, 8, 1), ("dynamic cluster", 64, 16, 1), ("chaos soak", 8, 1, 16)):
        rnd = random.Random(T * KR * KW)

        def rng():
            k = rnd.randrange(KEYSPACE)
            return b"rw/%08d" % k, b"rw/%08d\x00" % k

        def batch(i):
            return [CommitTransaction(read_snapshot=i, read_conflict_ranges=[rng() for _ in range(KR)],
                                      write_conflict_ranges=[rng() for _ in range(KW)]) for _ in range(T)]

        cs = TorchConflictSet(key_width=32, capacity=1 << 14)
        drive(cs, [batch(1 + i) for i in range(GROUP)], 1)
        group, cols = scan_group(cs, [batch(1 + GROUP)], 1 + GROUP)
        check_scan(f"a group of one at the {label}'s widest shape", cs._state, group, cols, launches,
                   reps=20, plain_time=False)
        cs.close()


def scan_only(card: str) -> None:
    """Phase 5's standalone kernels (``check_kernels``, whose device code
    the scan shares) and its scan cases (``check_scans``) on the bench's
    warm-up state, then ``scan_groups_of_one``: every case held to its
    plain version (the scan to the loop of standalone kernels and the
    plain loop), timed, with the scan's per-phase timer lines."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet

    offset = (1 << 30) - 1 - (2 * GROUP + WINDOW)
    batches = make_batches(2 * GROUP, N_TXNS, offset)
    warm = TorchConflictSet(key_width=KEY_WIDTH, capacity=CAPACITY)
    warm.warm_compile()
    drive(warm, batches[:GROUP], offset)
    launches = kernels.launch_counts()
    hbatch = warm.encode(batches[GROUP])[0]
    vers = (offset + GROUP + WINDOW - warm._base, max(warm.oldest_version - warm._base, 0),
            max(max(warm.oldest_version, offset + GROUP) - warm._base, 0))
    log(f"the standalone kernels against their plain versions [{card}]:")
    check_kernels(warm._state, hbatch, vers, launches)
    log(f"the group scan against the loop of standalone kernels and the plain loop [{card}]:")
    check_scans(warm._state, batches, offset, warm, launches, card)
    scan_groups_of_one(launches)
    warm.close()


def check_scans(state_g1, batches, offset: int, warm, launches: dict, card: str) -> list[dict]:
    """Phase 5's scan cases, each against the loop of standalone kernels
    and the plain loop (``check_scan``): (a) the bench group, the 40
    batches after the first, on the state after it (the row of the main
    path); (b) the commit path's widest batch shape (T = 64, KR = 8,
    KW = 1, L = 8) on a grid of width 32 after one such group; (c) four
    stacked partitions after one group of the bench's spread keys (its row
    takes phase 7's launches); (d) a group whose middle batch overflows
    staging (40 ranges of consecutive keys, into one or two buckets); (e)
    three batches of phase 13's bulk load (8 transactions of 2000 writes,
    KW = 2048) on (b)'s grid. Returns the rows of (a) and (c)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict.api import CommitTransaction
    from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet

    rows = []
    # (a) the bench group
    group, cols = scan_group(warm, batches[GROUP : 2 * GROUP], offset + GROUP)
    rows.append(check_scan("the bench group", state_g1, group, cols, launches)[0])

    # (b) the commit path's widest batch shape, a group of GROUP
    rnd = random.Random(3)

    def wide(i0, n):
        out = []
        for i in range(n):
            txs = []
            for _ in range(64):
                reads = [(b"rw/%08d" % k, b"rw/%08d\x00" % k) for k in rnd.sample(range(KEYSPACE), 8)]
                c = rnd.randrange(KEYSPACE)
                txs.append(CommitTransaction(read_snapshot=i0 + i, read_conflict_ranges=reads,
                                             write_conflict_ranges=[(b"rw/%08d" % c, b"rw/%08d\x00" % c)]))
            out.append(txs)
        return out

    cs = TorchConflictSet(key_width=32, capacity=1 << 14)
    drive(cs, wide(1, GROUP), 1)
    group, cols = scan_group(cs, wide(1 + GROUP, GROUP), 1 + GROUP)
    check_scan("the commit path's widest batch shape", cs._state, group, cols, launches, plain_time=False)

    # (e) the commit path's bulk load (phase 13): 8 transactions of
    # COMMIT_LOAD_SETS consecutive keys a batch (KW = 2048), on the same grid
    k0 = KEYSPACE // 2

    def load(b):
        return [CommitTransaction(1 + 2 * GROUP, [], [(b"rw/%08d" % k, b"rw/%08d\x00" % k) for k in
                                                      range(k0 + (8 * b + j) * COMMIT_LOAD_SETS,
                                                            k0 + (8 * b + j + 1) * COMMIT_LOAD_SETS)])
                for j in range(8)]

    group, cols = scan_group(cs, [load(b) for b in range(3)], 1 + 2 * GROUP)
    check_scan("three batches of the bulk load", cs._state, group, cols, launches, reps=3, plain_time=False)
    cs.close()

    # (c) four stacked partitions after one group of the spread keys
    spread = make_batches(2 * GROUP, N_TXNS, offset, key=spread_key)
    cs = TorchMeshConflictSet(key_width=KEY_WIDTH, capacity=CAPACITY, n_parts=4)
    drive(cs, spread[:GROUP], offset)
    e = cs._spread.entries[0]
    group, cols = scan_group(cs, spread[GROUP:], offset + GROUP)
    row = check_scan("four stacked partitions", e.states, group, cols, launches, bounds=(e.plo, e.phi))[0]
    row["name"] = "resolve_many (four stacked partitions)"
    rows.append(row)
    cs.close()

    # (d) the middle batch of three overflows staging: 40 ranges of
    # consecutive keys, no reads (they commit)
    c = KEYSPACE // 3
    run = [CommitTransaction(offset + GROUP + 1, [], [(ascii_key(c + i), ascii_key(c + i + 1))]) for i in range(40)]
    three = [batches[GROUP], run, batches[GROUP + 2]]
    group, cols = scan_group(warm, three, offset + GROUP)
    _row, per_batch = check_scan("a group whose middle batch overflows staging", state_g1, group, cols,
                                 launches, reps=3)
    staged = [int(x) for x in per_batch[:, 0, 0]]
    if not staged[1] > G.staging_slots(state_g1.grid.shape[1]) >= max(staged[0], staged[2]):
        raise AssertionError(f"the overflow group staged {staged} rows in a bucket")
    log(f"  the overflow group's most staged rows in a bucket, batch by batch: {staged}")
    torch.cuda.synchronize()
    return rows


def check_parts_resolve(states, batch, bounds, vers, launches: dict, k2: bool = False,
                        reads=None) -> list[dict]:
    """K6 history (also on keyspace-wide reads), with ``k2`` K2, then the
    K6 staging and merge against their plain versions on the card, on a
    stacked state of P partitions with their ``bounds`` (plo, phi) and an
    uploaded batch; exact equality, CUDA-event times. ``reads`` (rb, re):
    a data replica's slice of the read slots, which its K6 history checks
    (K2 still runs on the whole batch)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH

    old_pre = vers[1]
    P, B, S, Lp1 = states.grid.shape
    L = Lp1 - 1
    T = batch.rb.shape[0]
    plo, phi = bounds
    rows = []
    row = row_maker(rows, launches)

    # K6 history over the partitions, reads clipped in the kernel
    hbatch = batch if reads is None else batch._replace(rb=reads[0], re=reads[1])
    rows += check_history(states, hbatch, launches, (plo, phi))[0]
    hk = kernels.history_parts(*states, plo, phi, hbatch.rb, hbatch.re, batch.t_snap)
    H = hk | (batch.t_has_reads & (batch.t_snap < old_pre))
    commit = check_intra_batch(batch, H, row) if k2 else G.intra_batch_commits(batch, H)

    # K6 staging of every partition's clipped writes in one launch
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
    return rows


def check_partition_kernels(states, hbatch, vers, launches: dict) -> list[dict]:
    """K6 and K7 against their plain versions on the card, on the
    partitioned resolver's stacked state and a bench batch; exact
    equality, CUDA-event times."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.conflict import torch_backend as TB

    dev = states.grid.device
    now = vers[0]
    P, B, S, Lp1 = states.grid.shape
    L = Lp1 - 1
    rows = check_parts_resolve(states, TB.upload(hbatch, dev), SH.partition_bounds(L, P, dev), vers, launches)
    row = row_maker(rows, launches)

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


def oracle_verdicts(batches, offset: int) -> list:
    """The independent reference's verdicts over every batch of the
    workload (those after the rebase and the device reshard too)."""
    from foundationdb_tpu_torch.conflict.api import new_conflict_set

    t0 = time.perf_counter()
    oracle = new_conflict_set("oracle")
    out = [oracle.detect_batch(txs, offset + i + WINDOW, offset + i) for i, txs in enumerate(batches)]
    log(f"oracle: {time.perf_counter() - t0:.1f} s")
    return out


def cpu_plain_verdicts(offset: int) -> list:
    """Phase 3's CPU plain path (``TorchConflictSet(device="cpu")``) over
    the main workload, as ints: run in a child process beside the oracle."""
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet

    t0 = time.perf_counter()
    cpu = TorchConflictSet(key_width=KEY_WIDTH, capacity=CAPACITY, device="cpu")
    got, _encode_s = drive(cpu, make_batches(N_BATCHES, N_TXNS, offset), offset)
    log(f"CPU plain path: {time.perf_counter() - t0:.1f} s")
    return [[int(v) for v in vg] for vg in got]


def oracle_ints(offset: int) -> list:
    """``oracle_verdicts`` over the main workload, as ints (a child process)."""
    return [[int(v) for v in vg] for vg in oracle_verdicts(make_batches(N_BATCHES, N_TXNS, offset), offset)]


def start_references(offset: int) -> tuple:
    """Phase 3's references (the CPU plain path's verdicts and the
    oracle's) started in two spawned child processes, each over the main
    workload made anew from its seed: (the pool, the two futures)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(cpu_plain_verdicts, offset), pool.submit(oracle_ints, offset)


def finish_references(references: tuple) -> tuple:
    """``start_references``' verdict lists (CPU plain path, oracle), the
    pool shut down."""
    pool, plain_run, oracle_run = references
    try:
        return plain_run.result(), oracle_run.result()
    finally:
        pool.shutdown()


def reshard_partition_1(cs) -> None:
    """A device rebalance of partition 1 between groups (phases 7 and 18)."""
    from foundationdb_tpu_torch.conflict import sharded as SH

    cs._spread, pressure = SH.reshard_spread_partition(cs._spread, 1, cs._B, cs._S)
    if pressure > cs._S:
        raise AssertionError(f"partition reshard overflowed: {pressure}")


def run_mesh(want_oracle, offset: int, card: str):
    """Phase 7: the partitioned resolver's main path, then its kernels.
    Returns the kernel rows, the workload with its spread keys and the
    path's figures with its final state (numpy) for phase 18."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.conflict.api import new_conflict_set

    batches = make_batches(N_BATCHES, N_TXNS, offset, key=spread_key)
    cs = new_conflict_set("torch_mesh", key_width=KEY_WIDTH, capacity=CAPACITY, n_parts=4)
    cs.warm_compile()
    log(f"partitioned grid: {tuple(cs._states.grid.shape)} int32 = "
        f"{cs._states.grid.numel() * 4 / 2**20:.1f} MiB")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got, encode_s = drive(cs, batches, offset, force_at=2, force=reshard_partition_1)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    snap = cs.metrics.snapshot()
    phase7 = {"wall_s": wall, "encode_s": encode_s, "state": SH.gather_to_numpy(cs._spread),
              "launches": launches}

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
    path = RESOLVE_PATH + ("maint_reshard_parts", "maint_rebase_parts")
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the partitioned path: {missing}")
    one_launch_a_group(launches, snap, N_BATCHES // GROUP, "the partitioned path")
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
    cs.close()
    return rows, batches, phase7


def capture_groups(cs) -> list:
    """Record every group the spread mesh ``cs`` resolves from now on (its
    ``_resolve``, which ``del cs._resolve`` restores): (a clone of the
    spread the launch starts from, the group's batches an entry, the read
    slices, the version columns, the result (verdicts, pressures, status),
    the spread it leaves), for the loop of standalone kernels to redo."""
    groups, real = [], cs._resolve

    def capturing(spread, uploaded, nows, olds_pre, olds_post):
        before = spread.clone()
        out = real(spread, uploaded, nows, olds_pre, olds_post)
        groups.append((before, [uploaded["batch"][e.device] for e in spread.entries], uploaded["reads"],
                       [list(nows), list(olds_pre), list(olds_post)], out, spread))
        return out

    cs._resolve = capturing
    return groups


def spread_states(spread) -> list:
    return [x for e in spread.entries for x in e.states]


def check_groups_against_loop(groups, label: str) -> int:
    """The yardstick of phases 18-19: every group the spread's path
    resolved (one launch a card), redone from the state it started from by
    the loop of standalone kernels (``sharded.resolve_many_spread_loop``):
    verdicts, per-batch pressures and every replica's state equal, array
    by array, and no card's exchange ran out. Returns the groups checked."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH

    for i, (before, batches, reads, cols, (v, p, status), after) in enumerate(groups):
        if status is not None:
            kernels.check_spread_status(status.cpu())
        loop = before.clone()
        lv, lp = SH.resolve_many_spread_loop(loop, batches, *cols, reads)
        err = max_abs_err((v, p, *spread_states(after)), (lv, lp, *spread_states(loop)))
        if err:
            raise AssertionError(f"spread ({label}): group {i} differs from the loop of standalone kernels "
                                 f"(max abs err {err})")
    return len(groups)


def sync_cards(cards) -> None:
    for dev in cards:
        torch.cuda.synchronize(dev)


def check_spread_scan(label: str, group, launches: dict, reps: int = 3, row: bool = True,
                      transport: str | None = None) -> dict | None:
    """The spread's group scan (``sharded.resolve_many_spread``: one launch
    a card) on ``group`` (``capture_groups``' record of one the path
    resolved): against the plain loop on the card (``plain_spread_group``:
    verdicts, per-batch pressures, every replica's state, exactly), timed
    on fresh clones (CUDA events around the calls, and their device time
    queued behind a sleeping kernel) beside the loop of standalone kernels
    (the yardstick) and the plain loop, with the bound of its work
    (``spread_bound``: the busiest card's share); then every card's
    per-phase timer (``phase_ns``, a stamp buffer a card), one
    ``{"spread_phases": ...}`` line a card: its phases, the exchange's µs a
    batch split into its segments for batch 0, the median and the largest
    of the other batches (``kernels.exchange_split``), the transport (the
    exchange's own choice, or ``transport``), and the group's host wall
    time (every card synchronised before the call and after it). Returns
    the kernel-table row; without ``row`` only the launch's device time
    and its timer lines (None)."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.runtime.knobs import Knobs

    before, batches, reads, cols, (v, p, _status), after = group
    n_batches, T, KR, L = batches[0].rb.shape
    KW = batches[0].wb.shape[2]
    cards = before.devices()
    exchange = kernels.SpreadExchange(cards, transport) if len(cards) > 1 else None

    def launch(s, **kw):
        return SH.resolve_many_spread(s, batches, *cols, reads, exchange=exchange,
                                      timeout_s=Knobs.CONFLICT_DISPATCH_DEADLINE, **kw)

    try:
        it = iter([before.clone() for _ in range(4 * reps + 2)])  # as many as cuda_ms and queued_ms may call
        ms = cuda_ms(lambda: launch(next(it)), reps)
        device_ms = queued_ms(lambda: launch(next(it)), reps, ms)
        if row:  # the loop's CUDA events once: queued behind a sleep it outlasts the sleep
            loop = before.clone()
            loop_ms = cuda_ms(lambda: SH.resolve_many_spread_loop(loop, batches, *cols, reads), 1, warmup=0)
        stamps = [torch.zeros((reps, n_batches, kernels.SPREAD_STAMPS), dtype=torch.int64, device=d)
                  for d in cards]
        walls = []
        for r in range(reps):
            s = before.clone()
            sync_cards(cards)
            t0 = time.perf_counter()
            launch(s, phase_ns=[x[r] for x in stamps])
            sync_cards(cards)
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        if exchange is not None:
            exchange.close()
    transport = None if exchange is None else exchange.transport
    shape = [n_batches, T, KR, KW, L, len(before.entries), len(cards)]
    line_card = card_line()
    timer = kernels.scan_phase_ms(stamps[0])
    for c, (dev, st) in enumerate(zip(cards, stamps)):
        t = timer if c == 0 else kernels.scan_phase_ms(st)
        log(json.dumps({"spread_phases": {
            "layout": label, "launch": c, "device": str(dev), "transport": transport, "group": shape, **t,
            "exchange_us_a_batch": t["phases"]["exchange"] * 1e3 / n_batches,
            "exchange_split_us": kernels.exchange_split(st) if len(cards) > 1 else None,
            "host_wall_ms": walls, "device_ms": device_ms if c == 0 else None, "card": line_card}}))
    if not row:
        return None
    # the plain loop, on the card, once
    plain, res = before.clone(), {}
    plain_ms = cuda_ms(lambda: res.update(out=plain_spread_group(plain, batches, cols, reads)), 1, warmup=0)
    err = max_abs_err((v, p, *spread_states(after)), (*res["out"], *spread_states(plain)))
    if err:
        raise AssertionError(f"the spread's group scan ({label}) differs from the plain loop (max abs err {err})")
    b_ms, b_by, b_cards = spread_bound(before, batches, cols, reads)
    out = {
        "name": f"resolve_many_spread ({label})", "kernel": "resolve_many_spread", "route": "cuda",
        "source": "foundationdb_tpu_torch/conflict/kernels/csrc/scan.cu",
        "replaces": "foundationdb_tpu/conflict/sharded.py:220 (build_sharded_resolver_many; pmax :131-132)",
        "launches": launches.get("resolve_many_spread", 0), "max_abs_err": err, "ms": ms, "device_ms": device_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "loop_ms": loop_ms,
        "bound_ms_a_card": b_cards, "group": shape, "transport": transport, "host_wall_ms": min(walls),
    }
    log(f"  resolve_many_spread, {label} (G={n_batches} T={T} KR={KR} KW={KW} L={L}, {len(before.entries)} entries "
        f"on {len(cards)} card(s), transport {transport}): {ms:.4f} ms a group (CUDA events; on the device "
        f"{fmt_ms(device_ms)}; host wall {min(walls):.4f} ms), {ms / n_batches:.4f} ms a batch; the loop of "
        f"standalone kernels {loop_ms:.4f} ms; plain loop {plain_ms:.1f} ms; bound {b_ms:.5f} ms ({b_by}; the "
        f"busiest of {', '.join(f'{c} {c_ms:.5f}' for c, c_ms in b_cards.items())}); the exchange "
        f"{timer['phases']['exchange'] * 1e3 / n_batches:.3f} µs a batch on card 0; max_abs_err {err}")
    return out


def check_exchange_timeout(card: str) -> dict:
    """Phase 18 (d), on one card: the spread's group scan planned over two
    cards (entries 0-1 and 2-3 of a 4 x 1 spread, both "cards" this one,
    on the "peer" transport: each inbox on this card) with only card 0's
    launch queued. Its wait for card 1's H must give up at the bound given,
    set the launch's status and leave, after putting batch 0's words, with
    the launch's epoch, into card 1's inbox (and none of card 1's in its
    own); ``check_spread_status`` must raise the exchange timeout, which
    ``as_kernel_fault`` classifies as a kernel fault; and the card must
    then serve the next launch, its result the loop's."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import keys as K
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.conflict import torch_backend as TB
    from foundationdb_tpu_torch.conflict.errors import as_kernel_fault

    cuda0 = torch.device("cuda", 0)
    bound_s = 0.25
    lanes = K.lanes_for_width(KEY_WIDTH)
    hbs = [TB.encode_transactions(txs, KEY_WIDTH, 0) for txs in make_batches(3, 256, 0, seed=3, key=spread_key)]
    group = TB.upload(TB.stack_batches(hbs, lanes), cuda0)
    cols = [[WINDOW + i for i in range(3)], [0] * 3, [0] * 3]
    spread = SH.make_spread(4, 256, 32, lanes, [cuda0] * 4)
    plan = kernels.spread_plan([0, 0, 1, 1], 1, 3, group.rb.shape[1])
    entries = [(*e.states, e.plo, e.phi) for e in spread.entries]
    exchange = kernels.SpreadExchange([cuda0, cuda0])
    try:
        torch.cuda.synchronize()
        epoch = exchange.next_epoch()
        t0 = time.perf_counter()
        out = kernels.spread_launch(plan, 0, entries, [(group.rb, group.re)] * 4, tuple(group),
                                    G.version_rows(*cols, cuda0), G.staging_slots(32), exchange,
                                    epoch, timeout_s=bound_s)
        torch.cuda.synchronize()
        waited = time.perf_counter() - t0
        lay, T = exchange.layout, group.rb.shape[1]
        sent = exchange.inbox(1).view(-1)[lay.slot(epoch & 1, 0, 0):][: lay.words]
        got = exchange.inbox(0).view(-1)[lay.slot(epoch & 1, 0, 1):][: lay.words]
        if exchange.transport != "peer" or kernels.exchange_bits(sent, epoch, T) is None or got.any():
            raise AssertionError(f"the exchange ({exchange.transport}): card 0's words in card 1's inbox "
                                 f"{sent.tolist()}, card 1's in card 0's {got.tolist()} (epoch {epoch})")
    finally:
        exchange.close()
    try:
        kernels.check_spread_status(out.status)
        raised = None
    except kernels.ExchangeTimeoutError as e:
        raised = e
    if raised is None or as_kernel_fault(raised) is not raised or not bound_s <= waited < bound_s + 5.0:
        raise AssertionError(f"the exchange's bounded wait: status {out.status.tolist()}, raised {raised!r}, "
                             f"{waited:.3f} s for a bound of {bound_s} s")
    # the card serves the next launch: a fresh spread's group, one card
    fresh, loop = (SH.make_spread(4, 256, 32, lanes, [cuda0] * 4) for _ in range(2))
    v, p, _status = SH.resolve_many_spread(fresh, [group] * 4, *cols)
    lv, lp = SH.resolve_many_spread_loop(loop, [group] * 4, *cols)
    err = max_abs_err((v, p, *spread_states(fresh)), (lv, lp, *spread_states(loop)))
    if err:
        raise AssertionError(f"after the timeout the spread's group scan differs from the loop ({err})")
    out = {"bound_s": bound_s, "waited_s": waited, "raised": type(raised).__name__, "kernel_fault": True,
           "transport": "peer", "published": True, "next_launch_equal_to_loop": True}
    log(f"spread exchange timeout: card 0 of a two-card plan alone (peer transport) published batch 0 into "
        f"card 1's inbox and gave up after {waited:.3f} s (bound {bound_s} s), {type(raised).__name__} is a "
        f"kernel fault, the next launch equals the loop [{card}]")
    return out


TWO_SPREAD_GROUPS = 20  # groups each of the two spreads resolves
TWO_SPREAD_G = 4  # batches a group
# transactions a batch of each spread (the bench's transactions, spread
# keys): shapes whose launches take different shared memory (24,576 and
# 30,720 bytes by ``kernels.scan_plan``), which each card's kernel
# attribute must hold both of
TWO_SPREAD_T = (256, 1024)
TWO_SPREAD_CAPACITY = 1 << 16


def time_spread(cs, stamps: list) -> None:
    """Time every group the spread mesh ``cs`` (several entries) resolves
    from now on: its ``_resolve`` (which ``del cs._resolve`` restores) runs
    the same launch with each card's per-phase timer, and appends the
    group's stamp buffers (one a card, in the spread's card order) to
    ``stamps``."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH

    def timed(spread, uploaded, nows, olds_pre, olds_post):
        st = [torch.zeros((len(nows), kernels.SPREAD_STAMPS), dtype=torch.int64, device=d)
              for d in spread.devices()]
        out = SH.resolve_many_spread(spread, [uploaded["batch"][e.device] for e in spread.entries], nows,
                                     olds_pre, olds_post, uploaded["reads"], exchange=cs._exchange,
                                     timeout_s=cs._exchange_timeout, phase_ns=st)
        stamps.append(st)
        return out

    cs._resolve = timed


def spread_worker(devices, n_parts: int, seed: int, T: int, go=None, capture: bool = True) -> dict:
    """One spread mesh over ``devices`` (``n_parts`` partitions) through
    TWO_SPREAD_GROUPS groups of its own workload (``T`` of the bench's
    transactions a batch over spread keys, from ``seed``), a group encoded, dispatched and
    collected at a time, every group's launch timed card by card. ``go``
    (a callable) runs once the mesh is warm, just before the first group.
    Returns each group's host wall (ms, dispatch to verdicts), the verdicts,
    the exchange's split a card (``kernels.exchange_split`` over the
    groups; several cards only), the current stream of each card on the
    calling thread and, with ``capture``, every group the path resolved
    (``capture_groups``) for ``check_spread_groups``."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet

    offset = 1000
    batches = make_batches(TWO_SPREAD_GROUPS * TWO_SPREAD_G, T, offset, seed=seed, key=spread_key)
    cs = TorchMeshConflictSet(key_width=KEY_WIDTH, capacity=TWO_SPREAD_CAPACITY, n_parts=n_parts,
                              devices=devices)
    try:
        cs.warm_compile()
        cards = cs._targets
        on_card = [d for d in cards if d.type == "cuda"]
        streams = [torch.cuda.current_stream(d).cuda_stream for d in on_card]
        stamps: list = []
        time_spread(cs, stamps)
        groups = capture_groups(cs) if capture else []
        sync_cards(on_card)
        if go is not None:
            go()
        walls, verdicts = [], []
        for g in range(0, len(batches), TWO_SPREAD_G):
            idx = range(g, g + TWO_SPREAD_G)
            cs.prepare(offset + idx[-1] + WINDOW)
            work = [(cs.encode(batches[i]), offset + i + WINDOW, offset + i) for i in idx]
            t0 = time.perf_counter()
            verdicts += [[int(v) for v in vs] for vs in cs.detect_many_encoded_async(work)()]
            walls.append((time.perf_counter() - t0) * 1e3)
        sync_cards(on_card)
        del cs._resolve
        split = None
        if len(on_card) > 1:
            split = {str(d): kernels.exchange_split(torch.stack([st[c] for st in stamps]))
                     for c, d in enumerate(cards)}
    finally:
        cs.close()
    return {"walls_ms": walls, "verdicts": verdicts, "exchange_us": split, "streams": streams, "groups": groups}


def check_spread_groups(groups, label: str) -> int:
    """Every group a spread resolved (``capture_groups``) held to
    ``plain_spread_group`` from the state it started from: verdicts,
    per-batch pressures and every entry's state, exactly, with no card's
    exchange out of time. On the calling thread (K2's plain version is a
    matmul, and cuBLAS keeps a workspace a thread). Returns the groups
    checked."""
    from foundationdb_tpu_torch.conflict import kernels

    for i, (before, gb, reads, cols, (v, p, status), after) in enumerate(groups):
        if status is not None:
            kernels.check_spread_status(status.cpu())
        plain = before.clone()
        pv, pp = plain_spread_group(plain, gb, cols, reads)
        err = max_abs_err((v, p, *spread_states(after)), (pv, pp, *spread_states(plain)))
        if err:
            raise AssertionError(f"two spreads ({label}): group {i} differs from plain_spread_group "
                                 f"(max abs err {err})")
    return len(groups)


def _spread_child(devices, n_parts: int, seed: int, T: int, ready, go, out) -> None:
    """``spread_worker`` in a spawned child process (``two_spreads``'s
    second process): ready once warm, then waits for ``go``; its record,
    or its error, on the queue ``out``."""
    from foundationdb_tpu_torch.conflict import kernels

    try:
        kernels.build.load()
        out.put(spread_worker(devices, n_parts, seed, T, go=lambda: (ready.set(), go.wait(300.0)), capture=False))
    except BaseException as e:  # the parent raises it
        ready.set()
        out.put({"error": repr(e)})


def two_spreads(devices, n_parts: int, mode: str) -> dict:
    """Two spread meshes over the same ``devices``, each through its own
    TWO_SPREAD_GROUPS groups (``spread_worker``, seeds 11 and 12, batches
    of TWO_SPREAD_T[0] and TWO_SPREAD_T[1] transactions): "one
    thread" resolves them one after the other; "two threads" side by side,
    from two threads of this process that start together (both with each
    card's same current stream; then, on this thread, every group equal
    to ``plain_spread_group``); "two processes" side by side from this
    process and a spawned child (their launches in no order between them:
    each process orders only its own). Returns the wall of the case (the
    groups resolved, not the checks), and each spread's record."""
    import threading

    seeds = (11, 12)
    t0 = time.perf_counter()
    if mode == "one thread":
        recs = [spread_worker(devices, n_parts, s, T, capture=False) for s, T in zip(seeds, TWO_SPREAD_T)]
    elif mode == "two threads":
        start = threading.Barrier(2, timeout=300.0)
        recs, errors = [None, None], []

        def one(i):
            try:
                recs[i] = spread_worker(devices, n_parts, seeds[i], TWO_SPREAD_T[i], go=start.wait)
            except BaseException as e:  # raised below, on this thread
                errors.append(e)
                start.abort()

        threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        if recs[0]["streams"] != recs[1]["streams"]:
            raise AssertionError(f"two threads launch on different streams of the cards: {recs[0]['streams']}, "
                                 f"{recs[1]['streams']}")
        wall = time.perf_counter() - t0
        for r in recs:
            r["groups_checked"] = check_spread_groups(r.pop("groups"), layout_label(devices))
    elif mode == "two processes":
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        ready, go, out = ctx.Event(), ctx.Event(), ctx.Queue()
        child = ctx.Process(target=_spread_child, args=(devices, n_parts, seeds[1], TWO_SPREAD_T[1], ready, go, out))
        child.start()
        try:
            mine = spread_worker(devices, n_parts, seeds[0], TWO_SPREAD_T[0],
                                 go=lambda: (ready.wait(300.0), go.set()), capture=False)
            theirs = out.get(timeout=600.0)
        finally:
            child.join(60.0)
            if child.is_alive():
                child.kill()
        if "error" in theirs:
            raise AssertionError(f"two spreads, the child process: {theirs['error']}")
        recs = [mine, theirs]
    else:
        raise ValueError(mode)
    if mode != "two threads":
        wall = time.perf_counter() - t0
    return {"mode": mode, "wall_s": wall, "spreads": recs}


def check_two_spreads(devices, n_parts: int, card: str) -> dict:
    """Phase 18 (e), one layout: two spreads over the same cards resolved
    from one thread, then from two threads side by side (``two_spreads``):
    every group of the two threads equal to its ``plain_spread_group``,
    with no card's exchange out of time and every group done within a
    quarter of the exchange's bound (CONFLICT_DISPATCH_DEADLINE), and their
    verdicts the one thread's; over several cards also from two processes,
    recorded beside them. The collector is off during each case. One
    ``{"two_spreads": ...}`` line; returns its object."""
    from foundationdb_tpu_torch.runtime.knobs import Knobs

    label = layout_label(devices)
    modes = ["one thread", "two threads"] + (["two processes"] if len(set(devices)) > 1 else [])
    runs = {}
    for mode in modes:
        gc.collect()
        gc.disable()
        try:
            runs[mode] = two_spreads(devices, n_parts, mode)
        finally:
            gc.enable()
    one, two = runs["one thread"]["spreads"], runs["two threads"]["spreads"]
    if [r["verdicts"] for r in two] != [r["verdicts"] for r in one]:
        raise AssertionError(f"two spreads ({label}): the two threads' verdicts differ from the one thread's")
    limit_ms = Knobs.CONFLICT_DISPATCH_DEADLINE * 1e3 / 4
    slowest = max(w for r in two for w in r["walls_ms"])
    if slowest > limit_ms:
        raise AssertionError(f"two spreads ({label}): a group of the two threads took {slowest:.1f} ms "
                             f"(more than {limit_ms:.0f} ms, a quarter of the exchange's bound)")
    out = {"layout": label, "groups": TWO_SPREAD_GROUPS, "group": [TWO_SPREAD_G, list(TWO_SPREAD_T)],
           "groups_equal_to_plain": sum(r["groups_checked"] for r in two), "card": card}
    for mode, run in runs.items():
        walls = [w for r in run["spreads"] for w in r["walls_ms"]]
        out[mode] = {"wall_s": run["wall_s"], "group_ms_median": statistics.median(walls),
                     "group_ms_max": max(walls),
                     "exchange_us": [r["exchange_us"] for r in run["spreads"]]}
    log(f"two spreads ({label}): {TWO_SPREAD_GROUPS} groups each, one thread {runs['one thread']['wall_s']:.3f} s, "
        f"two threads {runs['two threads']['wall_s']:.3f} s (a group at most {slowest:.1f} ms), "
        f"every group of the two threads equal to plain_spread_group [{card}]")
    log(json.dumps({"two_spreads": out}))
    return out


def warm_cublas(n: int) -> None:
    """K2's plain version is a matmul: a card's first one allocates the
    cuBLAS workspace (32 MiB on the H100), held for the process's life, so
    a phase with a memory gate makes it on each of the ``n`` cards before
    its baseline, where phase 5 did not run before it."""
    for i in range(n):
        torch.ones(8, 8, device=torch.device("cuda", i)) @ torch.ones(8, 8, device=torch.device("cuda", i))


def cards_allocated() -> int:
    """Bytes the allocator holds for live tensors, over every card."""
    return sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count()))


def check_upgrade(n_cards: int) -> str:
    """Phase 18 (a): ``new_conflict_set("torch")`` is one grid on a host
    of one card and the spread mesh over every card on a host of more."""
    from foundationdb_tpu_torch.conflict.api import new_conflict_set
    from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet

    cs = new_conflict_set("torch", key_width=KEY_WIDTH, capacity=CAPACITY)
    try:
        if n_cards == 1:
            ok = type(cs) is TorchConflictSet
        else:
            ok = (type(cs) is TorchMeshConflictSet and cs._n_parts == n_cards
                  and [e.device for e in cs._spread.entries] == [torch.device("cuda", i) for i in range(n_cards)])
        if not ok:
            raise AssertionError(f"new_conflict_set('torch') on {n_cards} card(s) built {type(cs).__name__}")
        return type(cs).__name__
    finally:
        cs.close()


def layout_label(devices) -> str:
    """A spread layout's name: its rows x replicas where rows have several,
    its entries and its distinct cards."""
    from foundationdb_tpu_torch.conflict import sharded as SH

    rows_of = SH.device_grid(devices)
    flat = [d for row in rows_of for d in row]
    shape = f"{len(rows_of)} x {len(rows_of[0])} " if len(rows_of[0]) > 1 else ""
    return f"{shape}{len(flat)} entries on {', '.join(str(d) for d in dict.fromkeys(flat))}"


def exchange_only(card: str, reps: int = 5) -> None:
    """The spread's launch alone, for an A/B of two checkouts of its
    exchange (``--exchange-only``): the first two groups of phase 7's
    workload (spread keys, 40 x 2500) through the spread mesh on
    ``[cuda:0] * 4``, on 4 x 2 over ``[cuda:0] * 8`` and, where there are
    more cards, one partition a card over all of them; every group equal to
    the loop of standalone kernels, then the last group's launch timed
    (``check_spread_scan`` without its row: its device time, every card's
    timer line with the exchange's split, the host wall), over several
    cards on the exchange's own transport and then on "host"."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet

    offset = (1 << 30) - 1 - (2 * GROUP + WINDOW)
    batches = make_batches(2 * GROUP, N_TXNS, offset, key=spread_key)
    n = torch.cuda.device_count()
    cuda0 = torch.device("cuda", 0)
    layouts = [([cuda0] * 4, 4), ([[cuda0] * 2 for _ in range(4)], 4)]
    if n > 1:
        layouts.append(([torch.device("cuda", i) for i in range(n)], n))
    for devices, n_parts in layouts:
        label = layout_label(devices)
        cs = TorchMeshConflictSet(key_width=KEY_WIDTH, capacity=CAPACITY, n_parts=n_parts, devices=devices)
        cs.warm_compile()
        groups = capture_groups(cs)
        kernels.reset_launch_counts()
        drive(cs, batches, offset)
        sync_cards(cs._targets)
        del cs._resolve
        checked = check_groups_against_loop(groups, label)
        log(f"spread ({label}): its {checked} groups equal to the loop of standalone kernels [{card}]")
        for transport in (None, "host") if len(cs._targets) > 1 else (None,):
            check_spread_scan(label, groups[-1], kernels.launch_counts(), reps=reps, row=False, transport=transport)
        groups.clear()
        cs.close()


def spread_path(devices, n_parts: int, batches, want_oracle, offset: int, card: str,
                maintenance: bool = True, profile: bool = True, checks: bool = True) -> dict:
    """Phase 18 (b), one layout, and phase 19 (b) and (c): the spread mesh
    over ``devices`` (a list, or rows of ``data`` replicas) on ``batches``,
    its gates, its figures and, with ``checks``, the spread's group scan
    timed beside its yardsticks on the path's last full group. Gates: every
    verdict the oracle's, live rows in every partition, one launch of the
    spread's group scan a card a group and no per-batch resolve kernel,
    every group equal to the loop of standalone kernels from the state it
    started from, the replicas equal, and over cards that reach each
    other's memory the exchange on the "peer" transport. With ``checks``
    True, the path's last batch also goes through ``check_built_resolve``
    on the spread as the path left it. With ``maintenance`` (phase 7's 200
    batches), a partition reshard is forced before group 2 and the versions
    cross the rebase, and both must have launched."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.conflict import torch_backend as TB
    from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet

    label = layout_label(devices)
    cs = TorchMeshConflictSet(key_width=KEY_WIDTH, capacity=CAPACITY, n_parts=n_parts, devices=devices)
    cs.warm_compile()
    for dev in cs._targets:
        torch.cuda.synchronize(dev)
    groups = capture_groups(cs)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got, encode_s = drive(cs, batches, offset, force_at=2 if maintenance else None, force=reshard_partition_1)
    for dev in cs._targets:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    snap = cs.metrics.snapshot()
    del cs._resolve  # the capture ends with the path

    n = len(batches)
    if len(got) != n or any(len(v) != len(b) for v, b in zip(got, batches)):
        raise AssertionError(f"spread ({label}) returned verdicts of the wrong shape")
    bad = sum(a != b for vg, vo in zip(got, want_oracle) for a, b in zip(vg, vo))
    if bad:
        raise AssertionError(f"{bad} spread verdicts ({label}) differ from the oracle")
    per_part = snap["occupancy"]["liveRowsPerPartition"]
    if not all(k > 0 for k in per_part):
        raise AssertionError(f"a partition of the spread ({label}) holds no live rows: {per_part}")
    entries, n_cards = len(cs._spread.entries), len(cs._targets)
    want = {**{k: 0 for k in SPREAD_LOOP}, "resolve_many_spread": n_cards * snap["deviceDispatches"]}
    if {k: launches[k] for k in want} != want or len(groups) != snap["deviceDispatches"]:
        raise AssertionError(f"spread ({label}) launches {launches}, want {want} ({len(groups)} groups)")
    missing = [k for k in ("maint_reshard_parts", "maint_rebase_parts") if launches[k] <= 0]
    if maintenance and (missing or snap["rebases"] < 1):
        raise AssertionError(f"spread ({label}): maintenance never launched: {missing}, {snap['rebases']} rebases")
    if not cs._spread.replicas_equal():
        raise AssertionError(f"spread ({label}): the data replicas of a row differ")
    transport = snap.get("exchangeTransport")  # only where the spread exchanges across cards
    if n_cards > 1 and kernels.exchange_transport(kernels.peer_matrix(cs._targets)) == "peer" != transport:
        raise AssertionError(f"spread ({label}): its cards have peer access, its exchange went through {transport}")
    t1 = time.perf_counter()
    checked = check_groups_against_loop(groups, label)
    txns = sum(len(b) for b in batches)
    out = {"layout": label, "entries": entries, "cards": n_cards, "part_rows": cs._spread.n_rows,
           "data": cs._spread.n_data, "n_parts": n_parts, "transport": transport, "batches": n, "wall_s": wall,
           "encode_s": encode_s,
           "txn_s": txns / wall, "txn_s_without_encode": txns / max(wall - encode_s, 1e-9),
           "live_rows": per_part, "launches": launches, "replicas_equal": True,
           "groups_equal_to_loop": checked, "loop_check_s": time.perf_counter() - t1,
           "state": SH.gather_to_numpy(cs._spread), "verdicts": got}
    if cs._spread.n_data > 1:  # every replica's own state, for the phase's gates
        out["replica_states"] = [(cs._spread.per_entry * (i // cs._spread.n_data), SH.states_to_numpy(e.states))
                                 for i, e in enumerate(cs._spread.entries)]
    log(f"spread ({label}): every one of its {checked} groups equal to the loop of standalone kernels "
        f"({out['loop_check_s']:.1f} s) [{card}]")

    # the spread's group scan on the path's last full group, timed beside
    # its yardsticks (``checks`` "timer": its device time and timer alone)
    full = [g for g in groups if len(g[3][0]) == GROUP] or groups
    out["rows"] = []
    if checks:
        got_row = check_spread_scan(label, full[-1], launches, row=checks != "timer")
        out["rows"] = [got_row] if got_row else []
    if checks is True and entries > 1:  # what the resolver paths' kernel checks hold on this spread
        base = cs._origin[1]
        old = max(cs.oldest_version - base, 0)
        hbatch = TB.encode_transactions(batches[-1], KEY_WIDTH, base)
        out["rows"] += check_built_resolve(resolver_state(cs), hbatch, (old + WINDOW, old, old), launches,
                                           f" ({label}, its last batch)")
    _before, last, last_reads = full[-1][:3]
    out["shape"] = [*last[0].rb.shape[1:], last[0].wb.shape[2],  # T, KR, L, KW, the slice's KR
                    (last_reads[0][0] if last_reads else last[0].rb).shape[2]]
    groups.clear()
    if profile:
        out["profile"] = profile_path(
            cs, make_batches(PROFILE_BATCHES, N_TXNS, offset + n, seed=1, key=spread_key),
            offset + n, f"spread over {label}", card)
    cs.close()
    return out


def run_spread(batches, want_oracle, offset: int, phase7: dict, card: str) -> list[dict]:
    """Phase 18: the partitioned resolver spread over the cards of the
    host. (a) the upgrade of ``torch``; (b) the spread at phase 7's width
    over ``[cuda:0] * 4`` and, where there are more cards, over all of
    them, one partition a card, with every gate of ``spread_path``, the
    gathered final state of the 4-partition layouts equal to phase 7's,
    and card memory back after ``close()``; (c) where more than one card
    is visible, K6 history and K5 on the last card against their plain
    versions; (d) the exchange's bounded wait; (e) on each layout of (b),
    two spreads over its cards resolved from two threads side by side
    (``check_two_spreads``). Returns the kernel rows."""
    import numpy as np

    from foundationdb_tpu_torch.conflict import grid as G

    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    warm_cublas(n)
    gc.collect()
    torch.cuda.synchronize()
    m0 = cards_allocated()
    built = check_upgrade(n)
    log(f"spread phase: new_conflict_set('torch') on {n} card(s) is a {built}; card memory "
        f"{m0} B before the phase, {cards_allocated()} B after the check")
    layouts = [([torch.device("cuda", 0)] * 4, 4)]
    if n > 1:
        layouts.append(([torch.device("cuda", i) for i in range(n)], n))
    rows, lines = [], []
    for devices, n_parts in layouts:
        run = spread_path(devices, n_parts, batches, want_oracle, offset, card)
        run["two_spreads"] = check_two_spreads(devices, n_parts, card)  # (e)
        state = run.pop("state")
        del run["verdicts"]
        if n_parts == 4:
            for field, a, b in zip(G.GridState._fields, phase7["state"], state):
                if not np.array_equal(a, b):
                    raise AssertionError(f"spread ({run['layout']}): final {field} differs from phase 7's")
        rows += run.pop("rows")
        run["memory_after"] = cards_allocated()
        lines.append(run)
        log(f"spread path ({run['layout']}): {run['wall_s']:.3f} s, {run['txn_s']:.1f} txn/s end to end "
            f"({run['txn_s_without_encode']:.1f} txn/s without {run['encode_s']:.3f} s of host encode); "
            f"phase 7's one stack {N_BATCHES * N_TXNS / phase7['wall_s']:.1f} "
            f"({N_BATCHES * N_TXNS / max(phase7['wall_s'] - phase7['encode_s'], 1e-9):.1f} without encode); "
            f"cards: {run['cards']} [{card}]")
    timeout = check_exchange_timeout(card)  # (d) a missing card is a kernel fault, not a hang
    if n > 1:  # (c) the repair of the wrappers, seen: launches on the last card
        last = torch.device("cuda", n - 1)
        log(f"kernel checks on the last card ({last}) [{card}]:")
        rows += check_card_kernels(last, batches, offset, lines[-1]["launches"])
    gc.collect()
    for i in range(n):
        torch.cuda.synchronize(i)
    m1 = cards_allocated()
    if m1 != m0:
        raise AssertionError(f"card memory {m1} B after the spread phase, {m0} B before it")
    out = {"upgrade": built, "runs": lines, "exchange_timeout": timeout, "memory": {"before": m0, "after": m1},
           "phase_s": time.perf_counter() - t_phase, "card": card}
    log(json.dumps({"spread": out}))
    return rows


def check_card_kernels(dev, batches, offset: int, launches: dict) -> list[dict]:
    """Phase 18 (c): K6 history on a 4-partition state resolved on the CPU
    from the first 8 batches, and K5 on its live codes, launched on card
    ``dev`` (not the current one) and held to their plain versions; the
    rows carry ``launches``, the multi-card run's (K5 is not on its path)."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.conflict import torch_backend as TB
    from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet

    cpu = TorchMeshConflictSet(key_width=KEY_WIDTH, capacity=CAPACITY, n_parts=4, device="cpu")
    drive(cpu, batches[:8], offset)
    hbatch, _n, _epoch = cpu.encode(batches[8])
    states = G.GridState(*(x.to(dev) for x in cpu._states))
    P, _B, _S, Lp1 = states.grid.shape
    with torch.cuda.device(dev):
        batch = TB.upload(hbatch, dev)
        rows = check_history(states, batch, launches, SH.partition_bounds(Lp1 - 1, P, dev))[0]
        codes, _vers = G.live_codes(SH.partition(states, 1))
        rows += check_search(codes.contiguous(), batch.rb[:, 0].contiguous(), launches)
    for r in rows:
        r["name"] = f"{r['name']} (on {dev}, not the current card)"
    return rows


# phase 19: the mesh's data axis. (a) the multi-card dry runs; (b) phase 7's
# workload through part x data; (c) a group of wide reads, the commit
# path's KR = 8 (PERF.md kernel table, "K1, commit path"), split over data
DATA_ROWS, DATA_REPLICAS = 4, 2  # part x data of (b) and (c): dryrun_multichip(8)'s mesh
DRY_DEVICES = 8
SWEEP = (8, 6, 192)  # dryrun_sweep's defaults (__graft_entry__.py:188): parts, batches, txns
DRY_FIGURES = ("n_part", "n_data", "committed", "txns", "pressure", "parity", "moves", "gained")
WIDE_BATCHES = 40
WIDE_READS = 8
WIDE_SEED = 2


def make_wide_batches(n_batches: int, n_txns: int, offset: int, seed: int = WIDE_SEED) -> list:
    """Phase 19 (c)'s batches: WIDE_READS read ranges and one write range a
    transaction, phase 7's spread keys, read at snapshot offset + i."""
    from foundationdb_tpu_torch.conflict.api import CommitTransaction

    rnd = random.Random(seed)
    batches = []
    for i in range(n_batches):
        txs = []
        for _ in range(n_txns):
            reads = []
            for _r in range(WIDE_READS):
                a = rnd.randrange(KEYSPACE)
                reads.append((spread_key(a), spread_key(a + 1 + rnd.randrange(10))))
            c = rnd.randrange(KEYSPACE)
            txs.append(CommitTransaction(offset + i, reads, [(spread_key(c), spread_key(c + 1 + rnd.randrange(10)))]))
        batches.append(txs)
    return batches


def wide_oracle(n_batches: int, n_txns: int, offset: int, window: int) -> list:
    """The oracle's verdicts (ints) over phase 19 (c)'s batches, resolved
    as ``drive`` does with ``window``; phase 19 runs it in a child process
    while (a) and (b) hold the card."""
    from foundationdb_tpu_torch.conflict.api import new_conflict_set

    oracle = new_conflict_set("oracle")
    return [[int(v) for v in oracle.detect_batch(txs, offset + i + window, offset + i)]
            for i, txs in enumerate(make_wide_batches(n_batches, n_txns, offset))]


def dryrun_twin() -> dict:
    """Phase 19 (a)'s CPU twin (a spawned child process):
    ``dryrun_multichip(DRY_DEVICES)`` on the CPU; its figures and seconds."""
    from foundationdb_tpu_torch.tools import multichip as MC

    t0 = time.perf_counter()
    twin = MC.dryrun_multichip(DRY_DEVICES, device="cpu", log=log)
    return {**{k: twin[k] for k in DRY_FIGURES}, "s": time.perf_counter() - t0}


def run_dry_runs(card: str, cpu_twin) -> dict:
    """Phase 19 (a): ``tools.multichip.dryrun_multichip(8)`` over the host's
    8 cards or ``[cuda:0] * 8``, its figures equal to its CPU twin's (the
    future ``cpu_twin`` of ``dryrun_twin``) and K6 history, K2, K6 staging
    and K6 merge launched; then ``dryrun_sweep(8, 6, 192)`` on the card,
    every verdict the native's."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.runtime.loop import set_loop
    from foundationdb_tpu_torch.tools import multichip as MC

    devs = MC.card_devices(DRY_DEVICES)
    for dev in set(devs):
        torch.cuda.synchronize(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    on_card = MC.dryrun_multichip(DRY_DEVICES, devices=devs, log=log)
    for dev in set(devs):
        torch.cuda.synchronize(dev)
    card_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    set_loop(None)  # the drills' simulated clusters
    twin = cpu_twin.result()
    cpu_s = twin["s"]
    differ = {k: (on_card[k], twin[k]) for k in DRY_FIGURES if on_card[k] != twin[k]}
    if differ:
        raise AssertionError(f"dryrun_multichip on the card differs from its CPU twin: {differ}")
    missing = [k for k in SPREAD_LOOP + SPREAD_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"dryrun_multichip: kernels never launched: {missing} ({launches})")
    t0 = time.perf_counter()
    sweep = MC.dryrun_sweep(*SWEEP, log=log)
    out = {"dryrun": {**{k: on_card[k] for k in DRY_FIGURES}, "devices": on_card["devices"], "card_s": card_s,
                      "cpu_twin_s": cpu_s, "equal_to_cpu_twin": True,
                      "launches": {k: v for k, v in launches.items() if v}},
           "sweep": {**sweep, "s": time.perf_counter() - t0}}
    log(f"dry runs: dryrun_multichip(8) on {', '.join(dict.fromkeys(on_card['devices']))} in {card_s:.1f} s, "
        f"equal to its CPU twin ({cpu_s:.1f} s); dryrun_sweep{SWEEP} " + ", ".join(
            f"{r['parts']}p {r['txn_s']:.1f} txn/s ({r['ratio']:.2f}x)" for r in sweep["rows"]) + f" [{card}]")
    return out


def same_state(label: str, want: tuple, got: tuple, lo: int = 0) -> None:
    """``got`` (numpy arrays of k partitions) equals partitions lo … lo + k - 1
    of ``want``, array by array."""
    import numpy as np

    from foundationdb_tpu_torch.conflict import grid as G

    for field, a, b in zip(G.GridState._fields, want, got):
        if not np.array_equal(a[lo : lo + b.shape[0]], b):
            raise AssertionError(f"{label}: {field} of partitions {lo}.. differs")


def run_data(batches, want_oracle, offset: int, phase7: dict, card: str) -> list[dict]:
    """Phase 19: the mesh's data axis. (a) ``run_dry_runs``; (b) phase 7's
    workload, reshard and rebase through 4 partitions x 2 replicas on
    ``[cuda:0] * 8`` (and in rows of two cards where there is an even
    number of them), with ``spread_path``'s gates (one launch of the
    spread's group scan a card a group, every group equal to the loop of
    standalone kernels): every verdict the oracle's, the final state in
    every replica equal to phase 7's, the replicas equal, KR = 1 padded to
    2; (c) WIDE_BATCHES groups of WIDE_READS reads through 4 x 2 and phase
    18's 4 x 1, both through the spread's launch: verdicts equal to each
    other and to the oracle, states equal. (b) and (c) print the launch's
    timer line; its kernel-table row is phase 18's. Card memory back after
    ``close()``. Returns no kernel rows."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    cuda0 = torch.device("cuda", 0)
    grid_of = [[cuda0] * DATA_REPLICAS for _ in range(DATA_ROWS)]
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_twin = pool.submit(dryrun_twin)
        oracle_wide = pool.submit(wide_oracle, WIDE_BATCHES, N_TXNS, offset, WINDOW)
        out = run_dry_runs(card, cpu_twin)

        warm_cublas(n)
        gc.collect()
        torch.cuda.synchronize()
        m0 = cards_allocated()

        # (b) phase 7's workload through part x data
        layouts = [grid_of]
        if n > 1 and n % 2 == 0:
            layouts.append([[torch.device("cuda", 2 * r), torch.device("cuda", 2 * r + 1)] for r in range(n // 2)])
        out["runs"] = []
        for devices in layouts:
            n_parts = 4 if 4 % len(devices) == 0 else len(devices)
            run = spread_path(devices, n_parts, batches, want_oracle, offset, card, checks="timer")
            del run["verdicts"], run["rows"]
            state = run.pop("state")
            replicas = run.pop("replica_states")
            if n_parts == 4:
                same_state(f"data ({run['layout']}) gathered", phase7["state"], state)
                for i, (lo, st) in enumerate(replicas):
                    same_state(f"data ({run['layout']}) entry {i}", phase7["state"], st, lo)
            out["runs"].append(run)
            log(f"data path ({run['layout']}): {run['wall_s']:.3f} s, {run['txn_s']:.1f} txn/s end to end "
                f"({run['txn_s_without_encode']:.1f} txn/s without {run['encode_s']:.3f} s of host encode); "
                f"phase 7's one stack {N_BATCHES * N_TXNS / phase7['wall_s']:.1f}; every replica's state phase 7's; "
                f"cards: {run['cards']} [{card}]")

        # (c) a group of wide reads, split over data, beside phase 18's 4 x 1
        wide = make_wide_batches(WIDE_BATCHES, N_TXNS, offset)
        t0 = time.perf_counter()
        want_wide = oracle_wide.result()
        oracle_wait_s = time.perf_counter() - t0
    wide_runs = {}
    for name, devices in (("4 x 2", grid_of), ("4 x 1", [cuda0] * DATA_ROWS)):
        wide_runs[name] = spread_path(devices, 4, wide, want_wide, offset, card, maintenance=False, profile=False,
                                      checks="timer" if name == "4 x 2" else False)
    a, b = wide_runs["4 x 2"], wide_runs["4 x 1"]
    if a["verdicts"] != b["verdicts"]:
        raise AssertionError("wide group: the 4 x 2 and 4 x 1 verdicts differ")
    same_state("wide group, 4 x 2 against 4 x 1", b["state"], a["state"])
    for i, (lo, st) in enumerate(a["replica_states"]):
        same_state(f"wide group, 4 x 2 entry {i}", b["state"], st, lo)
    KR = a["shape"][1]
    out["wide"] = {name: {k: r[k] for k in ("layout", "entries", "batches", "wall_s", "encode_s", "txn_s",
                                           "txn_s_without_encode", "groups_equal_to_loop", "live_rows", "shape")}
                   for name, r in wide_runs.items()}
    out["wide"]["oracle_wait_s"] = oracle_wait_s
    for name, r in wide_runs.items():
        log(f"wide group ({r['layout']}, {WIDE_BATCHES} x {N_TXNS}, KR={KR}): {r['wall_s']:.3f} s, "
            f"{r['txn_s']:.1f} txn/s end to end ({r['txn_s_without_encode']:.1f} txn/s without "
            f"{r['encode_s']:.3f} s of host encode) [{card}]")
    del wide_runs, a, b
    gc.collect()
    for i in range(n):
        torch.cuda.synchronize(i)
    m1 = cards_allocated()
    if m1 != m0:
        raise AssertionError(f"card memory {m1} B after the data phase, {m0} B before it")
    out.update(memory={"before": m0, "after": m1}, phase_s=time.perf_counter() - t_phase, card=card)
    log(json.dumps({"data_mesh": out}))
    log(f"data phase: {out['phase_s']:.1f} s [{card}]")
    return []


def run_range_index(card: str) -> tuple[list[dict], float]:
    """Phase 8: the storage range index at bench.py's shape, then K5.
    Returns the K5 row and the lookups/s on the card."""
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
    return check_search(idx._codes, q, launches), n_q / wall


STORAGE_KEYS = INDEX_KEYS  # bench.py bench_range_index: 1M random b"%012d" keys over 10^12
STORAGE_COMMIT = 10_000  # SET_VALUEs a tlog commit
STORAGE_STEP = 100_000  # versions a commit
STORAGE_ROUNDS = INDEX_ROUNDS  # timed rounds: one multiGet and one multiGetRange each
STORAGE_DELTA = 1000  # the epoch delta: new keys and single-key clears of present keys
STORAGE_DELTA_ROUNDS = 5
STORAGE_RANGE_LIMIT = 10


def storage_value(n: int) -> bytes:
    return b"v%015d" % n  # 16 bytes


class StorageModel:
    """The host model of the storage phase's writes: a dict and a sorted
    key list, searched with ``bisect``."""

    def __init__(self, items: dict):
        self.map = items
        self.keys = sorted(items)

    def update(self, sets: dict, cleared: list) -> None:
        import bisect

        for k in cleared:
            del self.map[k]
            del self.keys[bisect.bisect_left(self.keys, k)]
        for k, v in sets.items():
            if k not in self.map:
                bisect.insort(self.keys, k)
            self.map[k] = v

    def rows(self, begin: bytes, end: bytes, limit: int, reverse: bool = False):
        """(rows, more) as a storage range read returns them."""
        import bisect

        lo, hi = bisect.bisect_left(self.keys, begin), bisect.bisect_left(self.keys, end)
        ks = self.keys[lo:hi][::-1] if reverse else self.keys[lo:hi]
        return [(k, self.map[k]) for k in ks[:limit]], hi - lo > limit


def storage_queries(rnd, model: StorageModel):
    """One round: 4096 point keys (70 % present, as bench.py) and 4096
    forward ranges of 0-20 keys on average."""
    keys = [rnd.choice(model.keys) if rnd.random() < 0.7 else b"%012d" % rnd.randrange(10**12)
            for _ in range(INDEX_BATCH)]
    ranges = []
    for _ in range(INDEX_BATCH):
        a = rnd.randrange(10**12)
        ranges.append((b"%012d" % a, b"%012d" % (a + rnd.randrange(2 * 10**12 // STORAGE_KEYS * 10)),
                       STORAGE_RANGE_LIMIT, False))
    return keys, ranges


def check_multi_get(rep, keys, model: StorageModel) -> None:
    if rep.errors or rep.selectors or rep.selector_errors or len(rep.values) != len(keys):
        raise AssertionError(f"multiGet replied errors {rep.errors[:4]} or {len(rep.values)} values")
    bad = [k for k, v in zip(keys, rep.values) if v != model.map.get(k)]
    if bad:
        raise AssertionError(f"multiGet: {len(bad)} values differ from the host model, e.g. {bad[0]!r}")


def check_multi_get_range(rep, ranges, model: StorageModel) -> None:
    if rep.errors or len(rep.results) != len(ranges):
        raise AssertionError(f"multiGetRange replied errors {rep.errors[:4]}")
    for (b, e, limit, reverse), res in zip(ranges, rep.results):
        rows, more = model.rows(b, e, limit, reverse)
        if res.data != rows or res.more != more:
            raise AssertionError(f"multiGetRange [{b!r}, {e!r}) differs from the host model")


def percentile(xs: list, q: float) -> float:
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def run_storage(card: str, index_lookups_s: float) -> tuple[dict, list[dict]]:
    """Phase 12: the storage role's read path on the card. One tlog and one
    storage server on the port's Sim, each on its own SimDisk, with a
    client process standing in for the proxy. Every write goes in through
    the tlog's commit endpoint, every read through a storage endpoint at
    the last committed version; every reply must equal the host model.
    Returns the phase's JSON object and K5's rows at the storage shapes."""
    import bisect

    from foundationdb_tpu_torch.conflict import keys as K
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.device import lanes_to_torch
    from foundationdb_tpu_torch.kv.mutations import Mutation, MutationType
    from foundationdb_tpu_torch.net.sim import Endpoint, Sim
    from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex
    from foundationdb_tpu_torch.runtime.futures import AsyncVar, delay
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.server import interfaces as I
    from foundationdb_tpu_torch.server.log_system import LogSystemConfig, TLogInterface, TLogSet
    from foundationdb_tpu_torch.server.storage import StorageServer
    from foundationdb_tpu_torch.server.tlog import TLog

    t_phase = time.perf_counter()
    rnd = random.Random(12)
    keys: dict = {}
    while len(keys) < STORAGE_KEYS:
        keys.setdefault(b"%012d" % rnd.randrange(10**12), None)
    keys = list(keys)  # distinct, in draw order
    model = StorageModel({k: storage_value(i) for i, k in enumerate(keys)})

    knobs = Knobs(STORAGE_TPU_INDEX=True)
    sim = Sim(12, knobs=knobs)
    sim.activate()
    tlog = TLog(knobs, tags=frozenset({0}), epoch=0, log_id="tlog0", disk=sim.disk("tlog0"))
    tlog.register_instance(sim.new_process("tlog0"))
    logs = (TLogInterface(address="tlog0", log_id="tlog0", tags=(0,)),)
    config = AsyncVar(LogSystemConfig(epoch=0, current=TLogSet(epoch=0, logs=logs)))
    ss = StorageServer(tag=0, log_config=config, knobs=knobs, disk=sim.disk("ss0"), uid="ss0")
    ss.register(sim.new_process("ss0"))
    client = sim.new_process("client")

    # apply_delta's wall time and the bytes it copies to the card, a call
    # each (the copy is from pageable host memory, so it returns once the
    # codes have been staged; nothing is added to the role's own work);
    # and the wall time of each index search (query encode, the copy up,
    # K5, the copy back), to split a request's time. With ``spans`` set,
    # CUDA events also bracket the device part of each search (the copy
    # up, K5, the copy back). Each wrapper's calls are checked against
    # what the role must have made, so a rename that bypassed one fails
    # the phase
    deltas, searches, spans = [], [], {"on": False, "pairs": []}
    apply_delta, search = TorchRangeIndex.apply_delta, TorchRangeIndex._search
    search_codes = TorchRangeIndex._search_codes

    def timed_apply_delta(idx, added, removed):
        t0 = time.perf_counter()
        new = apply_delta(idx, added, removed)
        deltas.append({"ms": (time.perf_counter() - t0) * 1e3, "added": len(added),
                       "removed": len(removed), "bytes_to_card": new._codes.numel() * 4,
                       "rows": new.n, "at_s": time.perf_counter() - t_phase})
        return new

    def timed_search(idx, qkeys):
        t0 = time.perf_counter()
        lo_hi = search(idx, qkeys)
        searches.append((time.perf_counter() - t0) * 1e3)
        return lo_hi

    def spanned_search_codes(idx, codes):
        if not spans["on"]:
            return search_codes(idx, codes)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        lo_hi = search_codes(idx, codes)  # ends in a copy back, so e1 waits for nothing
        e1.record()
        spans["pairs"].append((e0, e1))
        return lo_hi

    st = {"v": 0}
    out: dict = {"keys": STORAGE_KEYS, "card": card}

    async def commit(muts):
        prev, v = st["v"], st["v"] + STORAGE_STEP
        await client.request(Endpoint("tlog0", "tlog.commit#tlog0"), I.TLogCommitRequest(
            prev_version=prev, version=v, messages={0: muts} if muts else {}, known_committed=prev))
        st["v"] = v

    async def until_durable():
        """Empty commits until the durable engine and the index hold every
        write (the MVCC window is 50 commits; a stalled durability loop, one
        whose index launch raised, fails here)."""
        target = st["v"]
        for _ in range(500):
            if ss.durable_version >= target and ss._range_index is not None and (
                    ss._range_index.n == len(ss.engine._keys)):
                return
            await commit([])
            await delay(0.1)
        raise AssertionError(f"durability stalled at {ss.durable_version} below {target}")

    async def ask(token, req):
        return await client.request(Endpoint("ss0", token), req)

    def search_launches() -> int:
        return kernels.launch_counts()["search"]

    async def read_rounds(n: int, timed: dict) -> tuple:
        """``n`` rounds of one multiGet and one multiGetRange, then a few
        single reads; every reply against the model."""
        v = st["v"]
        before = ss.stats.snapshot()
        last = None
        for _ in range(n):
            qkeys, ranges = storage_queries(rnd, model)
            c0, s0 = search_launches(), len(searches)
            t0 = time.perf_counter()
            rep = await ask(I.Tokens.MULTI_GET, I.MultiGetRequest(keys=qkeys, version=v))
            t1 = time.perf_counter()
            c1, s1 = search_launches(), len(searches)
            rrep = await ask(I.Tokens.MULTI_GET_RANGE, I.MultiGetRangeRequest(ranges=ranges, version=v))
            t2 = time.perf_counter()
            c2 = search_launches()
            timed["index_ms"][0].append(sum(searches[s0:s1]))
            timed["index_ms"][1].append(sum(searches[s1:]))
            if c1 - c0 < 1 or c2 - c1 < 1:
                raise AssertionError(f"K5 did not launch for a request: {c1 - c0}, {c2 - c1}")
            if (s1 - s0, len(searches) - s1) != (c1 - c0, c2 - c1):
                raise AssertionError("the timed index search was bypassed: searches "
                                     f"{s1 - s0}, {len(searches) - s1} against launches {c1 - c0}, {c2 - c1}")
            check_multi_get(rep, qkeys, model)
            check_multi_get_range(rrep, ranges, model)
            timed["multi_get_ms"].append((t1 - t0) * 1e3)
            timed["multi_get_range_ms"].append((t2 - t1) * 1e3)
            timed["launches_multi_get"] += c1 - c0
            timed["launches_multi_get_range"] += c2 - c1
            timed["queries"].append(qkeys)
            last = (qkeys, ranges)
        for b, e, limit, _r in last[1][:4] + [(b"", b"\xff", 25, False), (b"5", b"6", 7, True)]:
            for reverse in (False, True):
                rep = await ask(I.Tokens.GET_KEY_VALUES, I.GetKeyValuesRequest(
                    begin=b, end=e, version=v, limit=limit, reverse=reverse))
                if (rep.data, rep.more) != model.rows(b, e, limit, reverse):
                    raise AssertionError(f"getKeyValues [{b!r}, {e!r}) differs from the host model")
        for k in last[0][:8]:
            rep = await ask(I.Tokens.GET_VALUE, I.GetValueRequest(key=k, version=v))
            if rep.value != model.map.get(k):
                raise AssertionError(f"getValue {k!r} differs from the host model")
        after = ss.stats.snapshot()
        return (after["multiGetIndexKeys"] - before["multiGetIndexKeys"],
                after["multiGetFallbackKeys"] - before["multiGetFallbackKeys"], last)

    def new_timed():
        return {"multi_get_ms": [], "multi_get_range_ms": [], "index_ms": ([], []),
                "launches_multi_get": 0, "launches_multi_get_range": 0, "queries": []}

    async def main():
        t0 = time.perf_counter()
        muts = [Mutation(MutationType.SET_VALUE, k, model.map[k]) for k in keys]
        for i in range(0, len(muts), STORAGE_COMMIT):
            await commit(muts[i:i + STORAGE_COMMIT])
        del muts[:]  # the tlog drops its copies once storage pops them
        out["ingest_s"] = time.perf_counter() - t0
        out["commits"] = STORAGE_KEYS // STORAGE_COMMIT
        t0 = time.perf_counter()
        await until_durable()
        out["durable_s"] = time.perf_counter() - t0
        out["index_rows"] = ss._range_index.n
        out["index_bytes"] = ss._range_index._codes.numel() * 4
        log(f"storage: {STORAGE_KEYS} keys in {out['commits']} tlog commits in {out['ingest_s']:.2f} s, "
            f"durable and indexed ({out['index_rows']} rows, codes {tuple(ss._range_index._codes.shape)}) "
            f"{out['durable_s']:.2f} s later [{card}]")

        await read_rounds(1, new_timed())  # warm
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        timed = new_timed()
        index_keys, fallback, last = await read_rounds(STORAGE_ROUNDS, timed)
        launches = kernels.launch_counts()
        want_index = STORAGE_ROUNDS * 2 * INDEX_BATCH  # every point key and every forward range
        if index_keys != want_index or fallback != 0:
            raise AssertionError(f"multiGetIndexKeys {index_keys} (want {want_index}), "
                                 f"multiGetFallbackKeys {fallback} (want 0)")
        out["launches"] = launches
        out["timed"] = timed
        out["last"] = last

        # one round under the profiler: the device's idle share. The
        # profiler gives the device's kernels and copies, but on the H100
        # host it has dropped device events at random (none, some or all
        # of a session's), so its share is used only where it saw every K5
        # launch. CUDA events bracketing the device part of each search
        # (the copy up, K5, the copy back) give a span that holds all of
        # the round's device work and the host's launch and copy time
        # between those steps, so 1 - spans / window is a floor on the idle
        # share; it stands in where the profiler missed a launch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        qkeys, ranges = storage_queries(rnd, model)
        torch.cuda.synchronize()
        c0 = search_launches()
        spans["on"], spans["pairs"] = True, []
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                rep = await ask(I.Tokens.MULTI_GET, I.MultiGetRequest(keys=qkeys, version=st["v"]))
                rrep = await ask(I.Tokens.MULTI_GET_RANGE,
                                 I.MultiGetRangeRequest(ranges=ranges, version=st["v"]))
                torch.cuda.synchronize()
                window = time.perf_counter() - t0
        finally:
            spans["on"] = False
        k5_launches = search_launches() - c0
        check_multi_get(rep, qkeys, model)
        check_multi_get_range(rrep, ranges, model)
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        k5_dev = [e for e in dev if "search_warp" in e.name]
        busy = sum(e.time_range.elapsed_us() for e in dev) * 1e-6
        span = sum(e0.elapsed_time(e1) for e0, e1 in spans["pairs"]) * 1e-3
        if k5_launches < 2 or len(spans["pairs"]) != k5_launches:
            raise AssertionError(f"the profiled round launched K5 {k5_launches} times "
                                 f"over {len(spans['pairs'])} device spans (want 2 and 2)")
        whole = len(k5_dev) == k5_launches  # the profiler saw every K5 launch
        out["round_profile"] = {
            "window_ms": window * 1e3, "k5_launches": k5_launches,
            "profiler_device_events": len(dev), "profiler_k5_kernels": len(k5_dev),
            "profiler_device_busy_ms": busy * 1e3, "search_device_span_ms": span * 1e3,
            "device_idle_at_least": 1.0 - span / window,
            "device_idle": 1.0 - (busy if whole else span) / window,
            "device_busy_from": "profiler" if whole else "cuda_events_around_device_part"}
        # where a request's host time goes, by function (the log only)
        import cProfile
        import pstats

        for token, req in ((I.Tokens.MULTI_GET, I.MultiGetRequest(keys=qkeys, version=st["v"])),
                           (I.Tokens.MULTI_GET_RANGE, I.MultiGetRangeRequest(ranges=ranges, version=st["v"]))):
            cprof = cProfile.Profile()
            cprof.enable()
            await ask(token, req)
            cprof.disable()
            stats = pstats.Stats(cprof)
            top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]

            def where(fn):
                return f"{fn[2]} ({fn[0].rsplit('/', 1)[-1]}:{fn[1]})"

            callers = sorted(top[0][1][4].items(), key=lambda kv: -kv[1][2])[:3]
            log(f"storage {token} under cProfile, top functions by own time: " + "; ".join(
                f"{where(fn)} {tt * 1e3:.1f} ms in {nc} calls"
                for fn, (_cc, nc, tt, _ct, _callers) in top)
                + f"; the first one's callers: " + "; ".join(
                f"{where(fn)} {c[2] * 1e3:.1f} ms in {c[1]} calls" for fn, c in callers))

        # the epoch delta: new keys and single-key clears of present keys
        live = set(model.map)
        added = {}
        while len(added) < STORAGE_DELTA:
            k = b"%012d" % rnd.randrange(10**12)
            if k not in live:
                added[k] = storage_value(STORAGE_KEYS + len(added))
        cleared = rnd.sample(model.keys, STORAGE_DELTA)
        await commit([Mutation(MutationType.SET_VALUE, k, v) for k, v in added.items()]
                     + [Mutation(MutationType.CLEAR_RANGE, k, k + b"\x00") for k in cleared])
        model.update(added, cleared)
        n_deltas = len(deltas)
        await until_durable()
        if [(d["added"], d["removed"]) for d in deltas[n_deltas:]] != [(STORAGE_DELTA, STORAGE_DELTA)]:
            raise AssertionError("the epoch delta did not reach the index as one apply_delta: "
                                 f"{[(d['added'], d['removed']) for d in deltas[n_deltas:]]}")
        fresh = TorchRangeIndex(list(ss.engine._keys))
        if ss._range_index.n != fresh.n or not torch.equal(ss._range_index._codes, fresh._codes):
            raise AssertionError("the index after the delta differs from a fresh index of the engine's keys")

        dtimed = new_timed()
        index_keys, fallback, _ = await read_rounds(STORAGE_DELTA_ROUNDS, dtimed)
        if index_keys != STORAGE_DELTA_ROUNDS * 2 * INDEX_BATCH or fallback != 0:
            raise AssertionError(f"after the delta: multiGetIndexKeys {index_keys}, fallback {fallback}")
        return True

    TorchRangeIndex.apply_delta, TorchRangeIndex._search = timed_apply_delta, timed_search
    TorchRangeIndex._search_codes = spanned_search_codes
    try:
        sim.run_until_done(client.spawn(main()), limit=1e6)
    finally:
        TorchRangeIndex.apply_delta, TorchRangeIndex._search = apply_delta, search
        TorchRangeIndex._search_codes = search_codes
    out["apply_delta"] = deltas
    timed = out.pop("timed")
    qkeys, ranges = out.pop("last")

    # lookups through the role against host bisect over the same keys
    n_q = STORAGE_ROUNDS * INDEX_BATCH
    t0 = time.perf_counter()
    for q in timed["queries"]:
        for k in q:
            bisect.bisect_left(model.keys, k)
    host_s = time.perf_counter() - t0
    mg, mgr = timed["multi_get_ms"], timed["multi_get_range_ms"]
    out.update({
        "multi_get_ms": {"p50": percentile(mg, 0.5), "p95": percentile(mg, 0.95)},
        "multi_get_range_ms": {"p50": percentile(mgr, 0.5), "p95": percentile(mgr, 0.95)},
        # the index search's wall ms inside each request (encode, copies, K5)
        "index_ms": {"multi_get_p50": percentile(timed["index_ms"][0], 0.5),
                     "multi_get_range_p50": percentile(timed["index_ms"][1], 0.5)},
        "lookups_s_storage": n_q / (sum(mg) / 1e3),
        "lookups_s_range_index": index_lookups_s,
        "lookups_s_bisect": n_q / host_s,
        "launches_multi_get": timed["launches_multi_get"],
        "launches_multi_get_range": timed["launches_multi_get_range"],
        "counters": {k: v for k, v in ss.stats.snapshot().items()
                     if k.startswith("multiGet") or k == "batchRangeSeconds"},
    })

    # K5 at the storage shapes against its plain version
    codes = ss._range_index._codes
    width = ss._range_index.width
    q_get = lanes_to_torch(K.encode_keys(qkeys, width=width), "cuda")
    q_range = lanes_to_torch(K.encode_keys([r[0] for r in ranges] + [r[1] for r in ranges], width=width),
                             "cuda")
    log(f"K5 at the storage shapes [{card}]:")
    rows = []
    for label, q, n in (("multiGet", q_get, out["launches_multi_get"]),
                        ("multiGetRange", q_range, out["launches_multi_get_range"])):
        row = check_search(codes, q, {"search": n})[0]
        row["name"] = f"search (storage {label}, Q={q.shape[0]})"
        rows.append(row)
    out["k5"] = [{k: r[k] for k in ("name", "launches", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "max_abs_err")} for r in rows]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"storage: multiGet p50 {out['multi_get_ms']['p50']:.2f} ms p95 {out['multi_get_ms']['p95']:.2f} ms, "
        f"multiGetRange p50 {out['multi_get_range_ms']['p50']:.2f} ms p95 "
        f"{out['multi_get_range_ms']['p95']:.2f} ms; {out['lookups_s_storage']:.1f} lookups/s through the "
        f"role, {index_lookups_s:.1f} direct (phase 8), {out['lookups_s_bisect']:.1f} by host bisect; "
        f"device idle {out['round_profile']['device_idle']:.4f} over a round "
        f"({out['round_profile']['device_busy_from']}) [{card}]")
    log(json.dumps({"storage": out}))
    del sim, ss, tlog, client, model, keys
    gc.collect()
    return out, rows


LIMIT_WIDTHS = (32, 128)  # the default key width (L = 8) and one past 64 bytes (L = 32)
LIMIT_BATCHES = 3
LIMIT_TXNS = 64
LIMIT_KEYS = 20_000
# (KR, KW, L) K2 is held at, T = 512: many read and write slots, and key
# widths whose codes K2 holds in registers (L <= 16) or compares in memory
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
    last batch. Then K2 at ``K2_LIMIT_SHAPES`` (its plan and device
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
    paths = (("one grid", "torch1", {}, RESOLVE_PATH), ("four partitions", "torch_mesh", {"n_parts": 4}, RESOLVE_PATH))
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

    # K2 at its widest shapes: the plan, kernel against plain, device time
    cases = []
    for KR, KW, L in K2_LIMIT_SHAPES:
        args = k2_codes(512, KR, KW, L, seed=KR * 1000 + KW + L)
        batch = G.Batch(*args[:4], torch.zeros(512, dtype=torch.int32, device="cuda"), args[4])
        got = kernels.intra_batch(*args)
        err = max_abs_err(got, G.intra_batch_commits_plain(*G._endpoint_ranks(batch), args[4]))
        if err:
            raise AssertionError(f"intra_batch at KR = {KR}, KW = {KW}, L = {L} differs from its plain version")
        ms = cuda_ms(lambda: kernels.intra_batch(*args), 5)
        plan = kernels.intra_batch_plan(512, KR, KW, torch.cuda.get_device_properties(0).multi_processor_count)
        cases.append({"kernel": "intra_batch", "T": 512, "KR": KR, "KW": KW, "L": L, "plan": list(plan),
                      "ms": ms, "device_ms": queued_ms(lambda: kernels.intra_batch(*args), 5, ms),
                      "max_abs_err": err})

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
    want_backend = "NativeConflictSet" if backend == "native" else torch_built(backend)["name"]
    if (health["state"] != "HEALTHY" or health["faults"] or health["failovers"]
            or health["deadlineHits"] or health["backend"] != want_backend):
        raise AssertionError(f"{label}: the guard left its healthy path: {health}")
    if device:
        if rebases < 1 or health["retries"] > rebases:
            raise AssertionError(f"{label}: {health['retries']} retries over {rebases} rebases")
        built = torch_built(backend)
        path = built["path"] + (built["rebase"],)
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
            and health["backend"] == torch_built()["name"]):
        raise AssertionError(f"{mode}: the guard did not fail over and promote back: {health}")
    if pipelined and not (health["deadlineHits"] >= 1 and in_order >= 1):
        raise AssertionError(f"pipelined failover: no deadline recovery under pipelining: {health}")
    log(f"{mode} failover phase: resolved on NativeConflictSet, promoted back to {torch_built()['name']}, "
        f"0 false commits, every verdict equal to the oracle's, {in_order} in-order resolves [{card}]")
    return out


COMMIT_KEYS = 1_000_000  # ReadWrite's key shape at BASELINE.json's YCSB "uniform 1M keys" scale
COMMIT_LOAD_SETS = 2000  # workloads/readwrite.py:134 setup: sets a load transaction
COMMIT_ACTORS = 100
MIX_A = ("90_10", 50, 9, 1)  # tools/perf.py:39: (name, txns an actor, parallel gets, sets)
MIX_B = ("write", 20, 0, 10)  # perf.py's "write" preset
COMMIT_ATTEMPTS = 20  # ReadWriteWorkload._one_txn's retry budget
COMMIT_LOAD_PROGRESS = 100_000  # keys between two lines of the load's progress


def commit_key(n: int) -> bytes:
    return b"rw/%08d" % n


class CommitReferee:
    """Serializability referee of the commit path. Each committed
    transaction comes with its read version, its commit version, its batch
    index (the versionstamp's last two bytes), what it read and what it
    wrote; (commit version, batch index) is the order the proxies gave
    them. Checks that every read saw the last write at or below the read
    version (or the loaded value), that no committed write came between a
    reader's read version and its own commit point over a key it read, and
    that among the transactions of one commit version "the reader precedes
    the writer" has no cycle. ``model()`` is every key's last value."""

    def __init__(self):
        self.txns = []  # (cv, idx, rv, reads {k: v}, writes {k: v})

    def add(self, cv: int, stamp: bytes, rv: int, reads: dict, writes: dict) -> None:
        self.txns.append((cv, int.from_bytes(stamp[8:10], "big"), rv, reads, writes))

    def check(self) -> dict:
        import bisect

        self.txns.sort(key=lambda t: (t[0], t[1]))
        order = [(t[0], t[1]) for t in self.txns]
        if len(set(order)) != len(order):
            raise AssertionError("two committed transactions share a commit version and batch index")
        hist: dict = {}  # key -> [(cv, idx, value)] in commit order
        for cv, idx, _rv, _r, writes in self.txns:
            for k, v in writes.items():
                hist.setdefault(k, []).append((cv, idx, v))
        n_reads = 0
        for cv, idx, rv, reads, _w in self.txns:
            if reads and rv >= cv:
                raise AssertionError(f"read version {rv} not below commit version {cv}")
            for k, v in reads.items():
                h = hist.get(k, [])
                i = bisect.bisect_right(h, (rv, 1 << 62))
                want = h[i - 1][2] if i else None
                if v != want:
                    raise AssertionError(f"read of {k!r} at {rv} saw {v!r}, the last write is {want!r}")
                if i < len(h) and (h[i][0], h[i][1]) < (cv, idx):
                    raise AssertionError(f"{k!r} read at {rv} was written at {h[i][:2]} before the "
                                         f"reader committed at {(cv, idx)}")
                n_reads += 1
        # one commit version: edges reader -> writer of a key it read
        by_cv: dict = {}
        for t in self.txns:
            by_cv.setdefault(t[0], []).append(t)
        for cv, group in by_cv.items():
            if len(group) < 2:
                continue
            edges = {t[1]: [u[1] for u in group if u is not t and set(t[3]) & set(u[4])] for t in group}
            state = {}

            def visit(n):
                state[n] = 1
                for m in edges[n]:
                    if state.get(m) == 1 or (m not in state and visit(m)):
                        return True
                state[n] = 2
                return False

            if any(n not in state and visit(n) for n in edges):
                raise AssertionError(f"the reads-before-writes graph of commit version {cv} has a cycle")
        return {"committed": len(self.txns), "reads_checked": n_reads, "commit_versions": len(by_cv)}

    def model(self) -> dict:
        final = {}
        for _cv, _idx, _rv, _r, writes in sorted(self.txns, key=lambda t: (t[0], t[1])):
            final.update(writes)
        return final


def commit_path_run(card: str, device, n_keys: int, measure: bool) -> dict:
    """Phase 13, one run: the port's static ``Cluster`` on the port's
    ``Sim(seed=0)`` with bench_e2e's datacenter latency profile and layout
    (2 proxies, 2 resolvers on ``torch``, 1 tlog, 1 storage server; every
    other knob at its default), the resolution balancer on, one
    ``Database``. Loads ``n_keys`` keys in transactions of 2000 sets, waits
    until the storage engine and its index hold them, then runs mix A
    (100 actors × 50 transactions of 9 parallel gets and 1 set) and mix B
    (100 × 20 of 10 sets), retrying through ``on_error``. Every committed
    transaction goes to the referee; every key the mixes wrote is read back
    through a multiGet. ``device`` is the cluster's (``"cpu"``: the plain
    versions). With ``measure``, also the kernel launches, the device's
    idle share, a cProfile of one mix-A round and the kernel rows. Returns
    the transcript (every attempt's read version, reads, writes and
    outcome) and the measurements."""
    from foundationdb_tpu_torch.client import Database
    from foundationdb_tpu_torch.client.read_coalescer import ReadCoalescer
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.net.sim import Sim
    from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex
    from foundationdb_tpu_torch.runtime.futures import delay, spawn, wait_for_all
    from foundationdb_tpu_torch.runtime.loop import now as sim_now
    from foundationdb_tpu_torch.server import Cluster, ClusterConfig
    from foundationdb_tpu_torch.server.interfaces import Tokens

    on_card = device is None
    t_run = time.perf_counter()
    sim = Sim(seed=0)
    sim.activate()
    sim.knobs.SIM_FAST_LATENCY = 0.00025  # bench.py:928-929, the datacenter profile
    sim.knobs.SIM_MAX_LATENCY = 0.001
    cluster = Cluster(sim, ClusterConfig(n_proxies=2, n_resolvers=2, n_tlogs=1, n_storage=1,
                                         conflict_backend="torch"), device=device)
    balancer = cluster.start_resolution_balancer()
    db = Database(sim, cluster.proxy_addrs)
    ss = cluster.storages[0]
    referee = CommitReferee()
    transcript: list = []
    out: dict = {"keys": n_keys, "device": "card" if on_card else "cpu"}

    # instruments: the multiGet sizes the clients send; with ``spans`` on,
    # CUDA events around the device part of each resolver group (dispatch
    # to collected verdicts) and of each index search; and the widest batch
    # a resolver encodes while ``capture`` is on
    mg_sizes, spans, capture = [], {"on": False, "pairs": []}, {"on": False, "best": None}
    # the class the cluster's resolvers build (a spread on a multi-card host)
    Built = torch_built("torch", device)["cls"]
    send, detect_async = ReadCoalescer._send, Built.detect_many_encoded_async
    encode, search_codes = Built.encode, TorchRangeIndex._search_codes

    async def sized_send(self, team, token, req, batch, size_tags):
        if token == Tokens.MULTI_GET:
            mg_sizes.append(len(req.keys))
        return await send(self, team, token, req, batch, size_tags)

    def spanned_detect(self, work):
        if not spans["on"]:
            return detect_async(self, work)
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        collect = detect_async(self, work)

        def collected():
            verdicts = collect()  # ends in a copy of the verdicts to the host
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            spans["pairs"].append((e0, e1))
            return verdicts

        return collected

    def spanned_search(self, codes):
        if not spans["on"]:
            return search_codes(self, codes)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        lo_hi = search_codes(self, codes)
        e1.record()
        spans["pairs"].append((e0, e1))
        if capture["on"] and codes.shape[0] > capture.get("q", (0,))[0]:
            capture["q"] = (codes.shape[0], self, codes)
        return lo_hi

    def captured_encode(self, transactions):
        enc = encode(self, transactions)
        if capture["on"]:
            b = enc[0]
            size = (len(transactions), b.rb.shape[1] * b.wb.shape[1])
            if capture["best"] is None or size > capture["best"][0]:
                capture["best"] = (size, self, enc)
        return enc

    def resolver_snaps():
        return [r.stats.snapshot() for r in cluster.resolvers]

    async def load():
        t0, s0 = time.perf_counter(), sim_now()
        for lo in range(0, n_keys, COMMIT_LOAD_SETS):
            writes = {commit_key(i): b"%016d" % i for i in range(lo, min(lo + COMMIT_LOAD_SETS, n_keys))}
            for _attempt in range(COMMIT_ATTEMPTS):
                tr = db.transaction()
                try:
                    for k, v in writes.items():
                        tr.set(k, v)
                    rv = await tr.get_read_version()
                    cv = await tr.commit()
                    referee.add(cv, tr.get_versionstamp(), rv, {}, writes)
                    transcript.append(("load", lo, rv, cv))
                    break
                except Exception as e:
                    transcript.append(("load", lo, type(e).__name__))
                    await tr.on_error(e)
            else:
                raise AssertionError(f"load transaction at {lo} failed {COMMIT_ATTEMPTS} times")
            done = min(lo + COMMIT_LOAD_SETS, n_keys)
            if done % COMMIT_LOAD_PROGRESS == 0 and done < n_keys:  # how far a load cut short got
                log(f"commit path ({out['device']}): {done} keys loaded in {time.perf_counter() - t0:.1f} s")
        out["load_s"] = time.perf_counter() - t0
        out["load_sim_s"] = sim_now() - s0
        out["load_txns"] = math.ceil(n_keys / COMMIT_LOAD_SETS)
        target = max(r[3] for r in transcript if len(r) == 4)  # the last load commit
        t0 = time.perf_counter()
        for _ in range(2000):  # the engine also holds its own metadata key
            idx = ss._range_index
            if (ss.durable_version >= target and len(ss.engine._keys) > n_keys and idx is not None
                    and idx.n == len(ss.engine._keys)):
                break
            await delay(0.05)
        else:
            raise AssertionError(f"storage durable at {ss.durable_version} below {target}, "
                                 f"{len(ss.engine._keys)} engine keys of {n_keys}")
        out["durable_s"] = time.perf_counter() - t0
        log(f"commit path ({out['device']}): {n_keys} keys in {out['load_txns']} transactions of "
            f"{COMMIT_LOAD_SETS} sets in {out['load_s']:.2f} s, durable and indexed "
            f"{out['durable_s']:.2f} s later" + (f" [{card}]" if on_card else ""))

    async def run_mix(spec, seed: int, n_actors: int = COMMIT_ACTORS, txns: int | None = None):
        name, n_txns, n_reads, n_sets = spec
        n_txns = n_txns if txns is None else txns
        lat = {"commit_sim": [], "commit_wall": [], "grv_sim": [], "grv_wall": []}
        stats = {"committed": 0, "not_committed": 0, "other_errors": 0}

        async def actor(a):
            rnd = random.Random(seed * 1000 + a)
            for t in range(n_txns):
                for attempt in range(COMMIT_ATTEMPTS):
                    tr = db.transaction()
                    try:
                        s0, w0 = sim_now(), time.perf_counter()
                        rv = await tr.get_read_version()
                        lat["grv_sim"].append(sim_now() - s0)
                        lat["grv_wall"].append(time.perf_counter() - w0)
                        keys = [commit_key(rnd.randrange(n_keys)) for _ in range(n_reads)]
                        vals = await wait_for_all([spawn(tr.get(k)) for k in keys]) if keys else []
                        writes = {commit_key(rnd.randrange(n_keys)): b"%s%03d-%011d" % (name[:1].encode(), a, t)
                                  for _ in range(n_sets)}
                        for k, v in writes.items():
                            tr.set(k, v)
                        s0, w0 = sim_now(), time.perf_counter()
                        cv = await tr.commit()
                        lat["commit_sim"].append(sim_now() - s0)
                        lat["commit_wall"].append(time.perf_counter() - w0)
                        reads = dict(zip(keys, vals))
                        referee.add(cv, tr.get_versionstamp(), rv, reads, writes)
                        transcript.append((name, a, t, attempt, rv, keys, vals, sorted(writes.items()), cv))
                        stats["committed"] += 1
                        break
                    except Exception as e:
                        kind = type(e).__name__
                        transcript.append((name, a, t, attempt, kind))
                        stats["not_committed" if kind == "NotCommitted" else "other_errors"] += 1
                        await tr.on_error(e)
                else:
                    raise AssertionError(f"{name}: actor {a} transaction {t} failed {COMMIT_ATTEMPTS} times")
            return True

        before = resolver_snaps()
        w0, s0 = time.perf_counter(), sim_now()
        await wait_for_all([spawn(actor(a)) for a in range(n_actors)])
        wall, sim_s = time.perf_counter() - w0, sim_now() - s0
        after = resolver_snaps()
        ops = stats["committed"] * (n_reads + n_sets)
        res = {
            "actors": n_actors, "txns_per_actor": n_txns, "wall_s": wall, "sim_s": sim_s,
            "txn_s_wall": stats["committed"] / wall, "ops_s_wall": ops / wall, **stats,
            "commit_ms_sim": {"p50": percentile(lat["commit_sim"], 0.5) * 1e3,
                              "p95": percentile(lat["commit_sim"], 0.95) * 1e3},
            "commit_ms_wall": {"p50": percentile(lat["commit_wall"], 0.5) * 1e3,
                               "p95": percentile(lat["commit_wall"], 0.95) * 1e3},
            "grv_ms_sim_p50": percentile(lat["grv_sim"], 0.5) * 1e3,
            "grv_ms_wall_p50": percentile(lat["grv_wall"], 0.5) * 1e3,
            "resolvers": [{k: a_[k] - b_[k] for k in ("resolveBatchIn", "transactions", "conflicts")}
                          for a_, b_ in zip(after, before)],
        }
        return res

    async def main():
        await load()
        # phase 12's rule: the run's millions of objects leave the
        # collector's scans before the timed mixes
        gc.collect()
        gc.freeze()
        st0 = ss.stats.snapshot()
        if on_card:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
        mixes = {}
        capture["on"], spans["on"], spans["pairs"] = True, on_card, []
        mixes["A"] = await run_mix(MIX_A, seed=1)
        capture["on"], spans["on"] = False, False
        if on_card:
            torch.cuda.synchronize()
            busy = sum(e0.elapsed_time(e1) for e0, e1 in spans["pairs"]) * 1e-3
            mixes["A"]["device_spans"] = len(spans["pairs"])
            mixes["A"]["device_idle_at_least"] = 1.0 - busy / mixes["A"]["wall_s"]
            mixes["A"]["launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
        if measure:
            out["round_profile"] = await profiled_round()
            out["cprofile"] = await cprofiled_round()
        mixes["B"] = await run_mix(MIX_B, seed=2)
        out["mixes"] = mixes
        if on_card:
            out["launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
        st1 = ss.stats.snapshot()
        out["storage"] = {k: st1[k] - st0[k] for k in ("multiGetBatches", "multiGetKeys",
                                                          "multiGetIndexKeys", "multiGetFallbackKeys")}
        # read-back: every key the mixes wrote, through one multiGet tick
        written = sorted({k for row in transcript if len(row) == 9 for k, _v in row[7]})
        tr = db.transaction()
        rv = await tr.get_read_version()
        n_mg = len(mg_sizes)
        vals = await wait_for_all([spawn(tr.get(k)) for k in written])
        out["read_back"] = {"keys": len(written), "read_version": rv, "multi_gets": len(mg_sizes) - n_mg}
        return dict(zip(written, vals))

    async def profiled_round():
        """One mix-A round (one transaction an actor) under torch.profiler
        and the device spans: the profiler's idle share where it saw every
        launch of the port's kernels, else the spans' floor."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        c0 = sum(kernels.launch_counts().values())
        spans["on"], spans["pairs"] = True, []
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                await run_mix(MIX_A, seed=3, txns=1)
                torch.cuda.synchronize()
                window = time.perf_counter() - w0
        finally:
            spans["on"] = False
        n_launch = sum(kernels.launch_counts().values()) - c0
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ours = [e for e in dev if PORT_KERNELS.search(e.name)]
        busy = sum(e.time_range.elapsed_us() for e in dev) * 1e-6
        span = sum(e0.elapsed_time(e1) for e0, e1 in spans["pairs"]) * 1e-3
        whole = len(ours) >= n_launch > 0
        return {"window_ms": window * 1e3, "launches": n_launch, "profiler_device_events": len(dev),
                "profiler_port_kernels": len(ours), "profiler_device_busy_ms": busy * 1e3,
                "device_span_ms": span * 1e3, "device_idle_at_least": 1.0 - span / window,
                "device_idle": 1.0 - (busy if whole else span) / window,
                "device_busy_from": "profiler" if whole else "cuda_events_around_device_part"}

    async def cprofiled_round():
        """One mix-A round under cProfile: the top functions by own time."""
        import cProfile
        import pstats

        cprof = cProfile.Profile()
        w0 = time.perf_counter()
        cprof.enable()
        await run_mix(MIX_A, seed=4, txns=1)
        cprof.disable()
        wall = time.perf_counter() - w0
        stats = pstats.Stats(cprof)
        top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:15]
        cum = sorted(stats.stats.items(), key=lambda kv: -kv[1][3])[:25]

        def where(fn):
            return f"{fn[2]} ({fn[0].rsplit('/', 2)[-2:][-1]}:{fn[1]})"

        return {"wall_s": wall,
                "own": [(where(fn), tt, nc) for fn, (_cc, nc, tt, _ct, _c) in top],
                "cumulative": [(where(fn), ct, nc) for fn, (_cc, nc, _tt, ct, _c) in cum]}

    ReadCoalescer._send, Built.detect_many_encoded_async = sized_send, spanned_detect
    Built.encode, TorchRangeIndex._search_codes = captured_encode, spanned_search
    try:
        read_back = sim.run_until_done(spawn(main()), limit=1e6)
    finally:
        ReadCoalescer._send, Built.detect_many_encoded_async = send, detect_async
        Built.encode, TorchRangeIndex._search_codes = encode, search_codes
    out["referee"] = referee.check()

    # gate: every acknowledged write read back
    model = referee.model()
    bad = [k for k, v in read_back.items() if v != model[k]]
    if bad:
        raise AssertionError(f"{len(bad)} written keys read back other than the referee's model, "
                             f"e.g. {bad[0]!r}: {read_back[bad[0]]!r} != {model[bad[0]]!r}")
    if out["storage"]["multiGetFallbackKeys"] != 0:
        raise AssertionError(f"multiGetFallbackKeys {out['storage']['multiGetFallbackKeys']} in the mixes")
    # gate: both guards healthy
    health = [r.cs.health_snapshot() for r in cluster.resolvers]
    for i, h in enumerate(health):
        if h["state"] != "HEALTHY" or h["faults"] or h["failovers"] or h["deadlineHits"]:
            raise AssertionError(f"resolver {i}: the guard left its healthy path: {h}")
    # gate: the balancer gave resolver 1 work in mix A
    if any(r["transactions"] <= 0 for r in out["mixes"]["A"]["resolvers"]):
        raise AssertionError(f"a resolver resolved no transaction in mix A: {out['mixes']['A']['resolvers']} "
                             f"(balancer moves {balancer.moves})")
    snaps = resolver_snaps()
    out["resolvers"] = [{
        "batches": s["resolveBatchIn"], "transactions": s["transactions"], "conflicts": s["conflicts"],
        "resolveLatency_s": {k: s["resolveLatency"].get(k) for k in ("p50", "p99")},
        "encode_s": s["kernel"].get("encodeSeconds"), "dispatch_s": s["kernel"].get("dispatchSeconds"),
        "collect_s": s["kernel"].get("collectSeconds"),
        "capacityGrowths": s["kernel"]["capacityGrowths"], "reshardsDevice": s["kernel"]["reshardsDevice"],
        "overflowReplays": s["kernel"]["overflowReplays"], "reshard_s": s["kernel"].get("reshardSeconds"),
        "grid": list(r.cs._cs._states.grid.shape[:3] if hasattr(r.cs._cs, "_spread")
                     else r.cs._cs._state.grid.shape[:2]), "health": h["state"],
    } for s, r, h in zip(snaps, cluster.resolvers, health)]
    out["balancer_moves"] = balancer.moves
    out["resolver_map"] = [(b.decode("latin-1"), None if e is None else e.decode("latin-1"), r.address)
                           for b, e, r in balancer.map.ranges()]
    out["proxies"] = [{k: p.stats.snapshot()[k] for k in ("phase1Version", "phase2Resolve", "phase4LogPush",
                                                           "commitBatchesOut", "txnCommitOut", "txnConflicts")}
                      for p in cluster.proxies]
    out["multi_get_keys_p50"] = percentile(mg_sizes, 0.5) if mg_sizes else 0
    out["multi_gets"] = len(mg_sizes)
    out["run_s"] = time.perf_counter() - t_run
    out["capture"] = capture
    out["transcript"] = transcript
    out["cluster"] = cluster
    return out


def run_commit_path(card: str) -> tuple[dict, list[dict]]:
    """Phase 13: the commit path on the card: the 1M-key run with its
    gates, its measurements and the kernel rows of its widest mix-A batch
    and its widest K5 search (its CPU twin at bench_e2e's 100,000 keys is
    cut for phase 16's budget). Returns the phase's JSON object and the
    rows."""
    from foundationdb_tpu_torch.device import lanes_to_torch
    from foundationdb_tpu_torch.runtime.loop import set_loop

    t_phase = time.perf_counter()
    run = commit_path_run(card, None, COMMIT_KEYS, measure=True)
    cluster, capture = run.pop("cluster"), run.pop("capture")
    transcript = run.pop("transcript")
    launches = run["launches"]
    path = torch_built()["path"] + ("search",)
    missing = [k for k in path if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the mixes: {missing} ({launches})")

    # the kernel rows: K1, K2, K3 on the widest mix-A batch, K5 at mix A's
    # widest multiGet, each against its plain version
    (_size, cs, (hbatch, n_real, _epoch)) = capture["best"]
    base = cs._origin[1]
    window = cluster.knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS
    old = max(cs.oldest_version - base, 0)
    vers = (old + window, old, old)
    T, KR, KW = hbatch.rb.shape[0], hbatch.rb.shape[1], hbatch.wb.shape[1]
    log(f"kernel checks on the widest mix-A batch ({n_real} transactions, T={T} KR={KR} KW={KW}) "
        f"and the resolver's state after the mixes ({type(cs).__name__}) [{card}]:")
    rows = check_built_resolve(resolver_state(cs), hbatch, vers, launches, " (commit path)")
    for r in rows:
        r["name"] = f"{r['name']} (commit path, mix A batch T={T} KR={KR} KW={KW})"
    q_rows, idx, codes = capture["q"]
    log(f"K5 at mix A's widest multiGet search (Q={q_rows}) [{card}]:")
    k5 = check_search(idx._codes, lanes_to_torch(codes, "cuda"), {"search": launches["search"]})[0]
    k5["name"] = f"search (commit path, mix A multiGet, Q={q_rows})"
    rows.append(k5)
    run["kernel_rows"] = [{k: r[k] for k in ("name", "launches", "ms", "device_ms", "plain_ms",
                                             "bound_ms", "bound_by", "max_abs_err")} for r in rows]
    run["phase_s"] = time.perf_counter() - t_phase
    run["card"] = card
    cp = run.pop("cprofile")
    A = run["mixes"]["A"]
    log(f"commit path: mix A {A['txn_s_wall']:.1f} committed txn/s ({A['ops_s_wall']:.1f} ops/s) of wall "
        f"time, commit p50 {A['commit_ms_sim']['p50']:.3f} ms sim / {A['commit_ms_wall']['p50']:.3f} ms wall, "
        f"{A['not_committed']} NotCommitted; device idle {run['round_profile']['device_idle']:.4f} "
        f"({run['round_profile']['device_busy_from']}), at least {A.get('device_idle_at_least', 0):.4f} "
        f"over mix A [{card}]")
    log("commit path, one mix-A round under cProfile (%.3f s wall), top own time: " % cp["wall_s"]
        + "; ".join(f"{w} {t * 1e3:.1f} ms in {n} calls" for w, t, n in cp["own"]))
    log("commit path, one mix-A round under cProfile, top cumulative: "
        + "; ".join(f"{w} {t * 1e3:.1f} ms" for w, t, _n in cp["cumulative"]))
    log(json.dumps({"commit_path": run}, default=str))
    log(card)
    del cluster, transcript, capture, cs
    set_loop(None)
    gc.unfreeze()
    gc.collect()
    return run, rows


# half of phase 13's keys (BASELINE.json's YCSB "uniform 1M keys"), and its
# CPU twin at half of phase 13's: the script's budget with phases 15 and 16
# after it
DYN_KEYS = 500_000
DYN_TWIN_KEYS = 50_000
DYN_TXNS = 10  # mix A transactions an actor in each round of phase 14
DYN_SHAPE = dict(n_proxies=2, n_resolvers=2, n_tlogs=2, tlog_replication=2, n_storage=4, replication=2,
                 conflict_backend="torch")  # FoundationDB's "double" mode (configuration.rst)
DYN_COORDINATORS = 3
DYN_ATTEMPTS = 100  # a transaction's retry budget (db.run retries without one)
DYN_READ_CHUNK = 10_000  # rows a range read of the final read-back
DYN_REBOOT_S = 1.0  # the storage worker's reboot delay
# a group's kernels: one launch of the scan on one grid and on one stack of
# partitions; a batch at a time on each entry of a spread of several
RESOLVE_PATH = ("resolve_many",)
SPREAD_PATH = ("resolve_many_spread",)
# the spread's per-batch loop of standalone kernels: the yardstick of its
# group scan, and what tools.multichip's dry run steps through
SPREAD_LOOP = ("history_parts", "intra_batch", "stage_parts", "merge_parts")


LOOP_KERNELS = ("history", "history_parts", "intra_batch", "stage", "stage_parts", "merge", "merge_parts")


def one_launch_a_group(launches: dict, snap: dict, groups: int, label: str) -> None:
    """The gate of a path that runs the scan: one launch a dispatched group
    (replays included), at least ``groups``, and no per-batch resolve
    kernel."""
    loop = {k: launches[k] for k in LOOP_KERNELS if launches[k]}
    if launches["resolve_many"] != snap["deviceDispatches"] or launches["resolve_many"] < groups or loop:
        raise AssertionError(f"{label}: {launches['resolve_many']} launches of the scan for "
                             f"{snap['deviceDispatches']} dispatched groups, per-batch kernels {loop}")


def torch_built(backend: str = "torch", device=None) -> dict:
    """What ``new_conflict_set(backend, device=device)`` builds on this
    host: ``torch1`` is always the one grid; ``torch`` with no device is
    the one grid on a host of one card and the spread over every card on a
    host of more (``api.mesh_upgrade``; inside ``twin_layout`` ``torch`` on
    the CPU is that spread's layout too); ``torch_mesh`` is one stack. Its
    class, the class's name, the kernels of its resolve and its rebase
    kernel."""
    from foundationdb_tpu_torch.conflict.api import mesh_upgrade
    from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet

    if backend == "torch" and mesh_upgrade(device) is not None:
        return {"cls": TorchMeshConflictSet, "name": "TorchMeshConflictSet", "path": SPREAD_PATH,
                "rebase": "maint_rebase_parts"}
    if backend == "torch_mesh":
        return {"cls": TorchMeshConflictSet, "name": "TorchMeshConflictSet", "path": RESOLVE_PATH,
                "rebase": "maint_rebase_parts"}
    return {"cls": TorchConflictSet, "name": "TorchConflictSet", "path": RESOLVE_PATH, "rebase": "maint_rebase"}


@contextlib.contextmanager
def twin_layout():
    """Inside, a conflict set built for the CPU takes the layout ``torch``
    has on this host's cards: on a host of n cards (``api.mesh_upgrade``)
    ``torch`` with ``device="cpu"`` is the spread over n CPU entries, one
    partition each, as the card run's is over the n cards. A CPU twin so
    built grows, replays and reshards its grids as the card run does, and
    its guards name the same backend; on one card nothing changes."""
    from foundationdb_tpu_torch.conflict import api

    real = api.mesh_upgrade
    cards = real()

    def upgrade(device=None):
        if cards is not None and device is not None and torch.device(device).type == "cpu":
            return {"devices": [torch.device("cpu")] * len(cards["devices"]), "n_parts": cards["n_parts"]}
        return real(device)

    api.mesh_upgrade = upgrade
    try:
        yield
    finally:
        api.mesh_upgrade = real


def resolver_state(cs):
    """A snapshot of a device conflict set's state for the kernel rows: the
    one grid's state, the one stack's partitions with their bounds, or the
    whole spread where it has several entries (cloned, so later batches
    leave it as it was)."""
    from foundationdb_tpu_torch.conflict import grid as G

    spread = getattr(cs, "_spread", None)
    if spread is None:
        return {"state": G.clone_state(cs._state)}
    if len(spread.entries) > 1:
        return {"spread": spread.clone()}
    e = spread.entries[0]
    return {"state": G.clone_state(e.states), "bounds": (e.plo, e.phi)}


def check_built_spread(spread, hbatch, vers, launches: dict, label: str) -> dict:
    """What a spread of several entries launches for a batch: the batch as
    a group of one through ``sharded.resolve_many_spread`` on the whole
    spread (one launch a card, H exchanged across its cards), held exactly
    to ``plain_spread_group`` and timed by ``check_spread_scan``."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict import sharded as SH
    from foundationdb_tpu_torch.conflict import torch_backend as TB
    from foundationdb_tpu_torch.runtime.knobs import Knobs

    uploaded = {}
    for dev in spread.devices():
        b = TB.upload(hbatch, dev)
        uploaded[dev] = type(b)(*(x[None].contiguous() for x in b))
    batches = [uploaded[e.device] for e in spread.entries]
    reads = None
    if spread.n_data > 1:
        reads = [SH.split_reads(b.rb, b.re, spread.n_data)[e.replica] for e, b in zip(spread.entries, batches)]
    cols = [[v] for v in vers]
    cards = spread.devices()
    before, after = spread.clone(), spread.clone()
    exchange = kernels.SpreadExchange(cards) if len(cards) > 1 else None
    try:
        out = SH.resolve_many_spread(after, batches, *cols, reads, exchange=exchange,
                                     timeout_s=Knobs.CONFLICT_DISPATCH_DEADLINE)
        sync_cards(cards)
    finally:
        if exchange is not None:
            exchange.close()
    if out[2] is not None:
        kernels.check_spread_status(out[2].cpu())
    return check_spread_scan(f"the batch as a group of one{label}", (before, batches, reads, cols, out, after),
                             launches)


def check_built_resolve(snap: dict, hbatch, vers, launches: dict, label: str = "") -> list[dict]:
    """The resolve kernels of one batch held to their plain versions on
    ``resolver_state``'s snapshot: on the one grid K1-K3 and the scan
    (the batch as a group of one, against the loop of those kernels and
    the plain loop); on one stack K6 history, K2, the K6 staging and
    merge; on a spread of several entries its launch, the path's
    (``check_built_spread``)."""
    from foundationdb_tpu_torch.conflict import torch_backend as TB

    if "spread" in snap:
        return [check_built_spread(snap["spread"], hbatch, vers, launches, label)]
    if "bounds" not in snap:
        rows, batch, _ck, _st = check_resolve_kernels(snap["state"], hbatch, vers, launches)
        group = type(batch)(*(x[None] for x in batch))
        row, _p = check_scan(f"the batch as a group of one{label}", snap["state"], group, [[v] for v in vers],
                             launches)
        return rows + [row]
    dev = snap["state"].grid.device
    with torch.cuda.device(dev):
        return check_parts_resolve(snap["state"], TB.upload(hbatch, dev), snap["bounds"], vers, launches, k2=True)


# trace events of the transcript: the recovery's, the roles' and data
# distribution's (none carries a host value)
DYN_EVENTS = ("MasterRecoveryState", "MasterFullyRecovered", "RoleRecruited", "RoleDestroyed",
              "FetchKeysDone", "KillProcess", "ResurrectingRole", "BecameClusterController",
              "StorageServerUp", "RecruitedMaster", "DDShardSplit", "DDShardMerge", "DDRelocating",
              "DDStorageFailed")


class StackSampler:
    """Samples the calling thread's stack every ``interval`` seconds from a
    second thread (``sys._current_frames``): the functions a slow stretch
    of host work spends its time in, at a cost of a few frame walks a
    second. ``top()`` is the innermost frames and the port's innermost
    frames by share of samples."""

    def __init__(self, interval: float = 0.005):
        import threading

        self.interval, self.samples = interval, []
        self._target, self._stop = threading.get_ident(), threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(self._target)
            stack = []
            while frame is not None and len(stack) < 40:
                code = frame.f_code
                stack.append((code.co_name, code.co_filename.rsplit("/", 1)[-1], frame.f_lineno))
                frame = frame.f_back
            self.samples.append(stack)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def top(self, n: int = 25) -> dict:
        """The ``n`` frames most often innermost, and most often anywhere
        in the stack (cumulative), each with its share of the samples."""
        def share(frames):
            counts: dict = {}
            for f in frames:
                counts[f] = counts.get(f, 0) + 1
            total = max(len(self.samples), 1)
            return sorted(((f, c / total) for f, c in counts.items()), key=lambda fc: -fc[1])[:n]

        return {"samples": len(self.samples), "interval_s": self.interval,
                "innermost": share("%s (%s:%d)" % st[0] for st in self.samples if st),
                "cumulative": share(f for st in self.samples for f in {"%s (%s)" % fr[:2] for fr in st})}


def dynamic_cluster_run(card: str, device, n_keys: int, measure: bool) -> dict:
    """Phase 14, one run: the port's ``DynamicCluster`` (3 coordinators,
    2 proxies, 2 resolvers on ``torch``, 2 tlogs with 2 replicas, 4
    storage servers in teams of 2) on the port's ``Sim(seed=0)`` with
    bench_e2e's datacenter latency profile and default knobs, one
    ``Database.from_coordinators``. The steps: form the cluster; load
    ``n_keys`` keys in transactions of 2000 sets until every storage
    server's engine and index hold its shards; a mix-A round; the master's
    worker killed during a mix-A round; a storage worker killed and
    rebooted 1 s later, then a round; another storage worker killed for
    good until data distribution has every team at 2 replicas again; a
    last round and a read-back of every key from a fresh client. Every
    committed transaction goes to the serializability referee, those with
    an unknown result too where the proxy logged them at or below their
    generation's end. ``device`` is the cluster's (``"cpu"``: the plain
    versions). With ``measure``, also the device's idle share over a
    profiled round. Returns the transcript and the measurements."""
    import bisect

    from foundationdb_tpu_torch.client import Database
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.net.sim import Endpoint, Sim
    from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex
    from foundationdb_tpu_torch.runtime import trace as T
    from foundationdb_tpu_torch.runtime.futures import delay, spawn, wait_for_all
    from foundationdb_tpu_torch.runtime.loop import now as sim_now
    from foundationdb_tpu_torch.server import proxy as proxy_mod
    from foundationdb_tpu_torch.server.cluster import ClusterConfig, DynamicCluster
    from foundationdb_tpu_torch.server.interfaces import GetKeyValuesRequest, Tokens
    from foundationdb_tpu_torch.server.movekeys import walk_shards
    from foundationdb_tpu_torch.server.storage import StorageServer
    from foundationdb_tpu_torch.server.worker import Worker

    on_card = device is None
    t_run = time.perf_counter()
    marks: list = []  # (type, sim time, wall time, process, fields) of the transcript's events

    class MarkedLog(T.TraceLog):
        def log(self, severity, event_type, time_, process, **fields):
            super().log(severity, event_type, time_, process, **fields)
            if event_type in DYN_EVENTS:
                marks.append((event_type, time_, time.perf_counter(), process, fields))

    saved_log = T.trace_log()
    T.set_trace_log(MarkedLog())
    sim = Sim(seed=0)
    sim.activate()
    sim.knobs.SIM_FAST_LATENCY = 0.00025  # bench.py:928-929, the datacenter profile
    sim.knobs.SIM_MAX_LATENCY = 0.001
    cluster = DynamicCluster(sim, ClusterConfig(**DYN_SHAPE), n_coordinators=DYN_COORDINATORS, device=device)
    db = Database.from_coordinators(sim, cluster.coordinators)
    referee = CommitReferee()
    transcript: list = []
    unknowns: list = []  # attempts whose commit outcome the client did not learn
    acks: list = []  # (sim time, wall time, commit version) of every acknowledged commit
    out: dict = {"keys": n_keys, "device": "card" if on_card else "cpu", "steps": {}}

    # instruments: the roles every worker recruits; kernel launches by
    # resolver (K1-K3, around each dispatch) and by storage server (K5,
    # around each index read); the widest batch the newest generation
    # encodes and each server's widest search while ``capture`` is on;
    # device spans for the idle share; every committed transaction's
    # (version, batch index, mutations) as its proxy tags it
    # the phase holds no role itself (a reference would keep a destroyed
    # generation's grids, or a replaced index, on the card): weak references,
    # and each resolver's figures taken as its worker destroys it
    resolvers: dict = {}  # uid -> (epoch, weak reference to the Resolver)
    resolved_by: dict = {}  # uid -> (epoch, health, stats, device type, launches)
    storages: list = []  # weak references to every StorageServer, in recruitment order
    fallbacks: dict = {}  # id(storage server) -> (tag, multiGetFallbackKeys) of the killed ones
    by_cs: dict = {}  # id(conflict set) -> launches
    by_ss: dict = {}  # id(storage server) -> K5 launches
    spans, capture = {"on": False, "pairs": []}, {"on": False, "best": None, "q": {}}
    current = {"ss": None}
    tagged: dict = {}  # (key, value) -> (epoch, cv, batch index)
    make_resolver, make_storage, destroy = Worker._make_resolver, Worker._make_storage, Worker._destroy
    # the class the resolvers build (a spread on a multi-card host) and its
    # resolve kernels
    built = torch_built("torch", device)
    Built, path = built["cls"], built["path"]
    detect_async, encode = Built.detect_many_encoded_async, Built.encode
    search_codes = TorchRangeIndex._search_codes
    ss_reads = {n: getattr(StorageServer, n) for n in ("_multi_get_at", "_multi_engine_bounds", "_engine_range")}
    substitute = proxy_mod.substitute_versionstamps

    def counts():
        return kernels.launch_counts() if on_card else {}

    def recorded_resolver(self, h, **kw):
        make_resolver(self, h, **kw)
        resolvers[h.uid] = (h.epoch, weakref.ref(h.obj))

    def recorded_storage(self, h, **kw):
        make_storage(self, h, **kw)
        storages.append(weakref.ref(h.obj))

    def summarize(uid, epoch, r):
        cs = r.cs._cs
        resolved_by[uid] = (epoch, r.cs.health_snapshot(), r.stats.snapshot(), cs._device.type,
                            dict(by_cs.get(id(cs), {})))

    def summarized_destroy(self, uid):
        h = self.roles.get(uid)
        if h is not None and h.kind == "resolver":
            summarize(uid, h.epoch, h.obj)
        destroy(self, uid)

    def counted_detect(self, work):
        c0 = counts()
        e0 = None
        if spans["on"]:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        collect = detect_async(self, work)
        c1 = counts()
        mine = by_cs.setdefault(id(self), {})
        for k in path:
            mine[k] = mine.get(k, 0) + c1.get(k, 0) - c0.get(k, 0)
        if e0 is None:
            return collect

        def collected():
            verdicts = collect()
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            spans["pairs"].append((e0, e1))
            return verdicts

        return collected

    def captured_encode(self, transactions):
        enc = encode(self, transactions)
        if capture["on"] and capture.get("cs") is self:
            b = enc[0]
            size = (len(transactions), b.rb.shape[1] * b.wb.shape[1])
            if capture["best"] is None or size > capture["best"][0]:
                capture["best"] = (size, self, enc)
        return enc

    def spanned_search(self, codes):
        if spans["on"]:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        lo_hi = search_codes(self, codes)
        if spans["on"]:
            e1.record()
            spans["pairs"].append((e0, e1))
        ss = current["ss"]
        if capture["on"] and ss is not None and codes.shape[0] > capture["q"].get(id(ss), (0,))[0]:
            capture["q"][id(ss)] = (codes.shape[0], codes)
        return lo_hi

    def counted_read(name):
        fn = ss_reads[name]

        def read(self, *a, **kw):
            c0, current["ss"] = counts().get("search", 0), self
            try:
                return fn(self, *a, **kw)
            finally:
                current["ss"] = None
                by_ss[id(self)] = by_ss.get(id(self), 0) + counts().get("search", 0) - c0

        return read

    def tagging(mutations, stamp):
        caller = sys._getframe(1).f_locals.get("self")
        cv, idx = int.from_bytes(stamp[:8], "big"), int.from_bytes(stamp[8:10], "big")
        for m in mutations:
            if m.param2 and m.param2[:2] == b"A:":
                tagged[(m.param1, m.param2)] = (caller.epoch, cv, idx)
        return substitute(mutations, stamp)

    def hosting(kind):
        return [a for a, p in sorted(sim.processes.items()) if getattr(p, "worker", None) is not None
                and p.alive and any(h.kind == kind for h in p.worker.roles.values())]

    def live_storages():
        return [(a, h.obj) for a, p in sorted(sim.processes.items()) if getattr(p, "worker", None) is not None
                and p.alive for h in p.worker.roles.values() if h.kind == "storage"]

    def recovered():
        return [(f["RecoveryCount"], f["RecoveryVersion"], s, w) for e, s, w, _p, f in marks
                if e == "MasterFullyRecovered"]

    def memory():
        return torch.cuda.memory_allocated() if on_card else None

    async def attempt_loop(label, body):
        for attempt in range(DYN_ATTEMPTS):
            tr = db.transaction()
            try:
                return await body(tr, attempt)
            except Exception as e:
                transcript.append((label, attempt, type(e).__name__))
                await tr.on_error(e)
        raise AssertionError(f"{label}: no commit in {DYN_ATTEMPTS} attempts")

    async def form():
        w0 = time.perf_counter()

        async def body(tr, _attempt):
            tr.set(b"dyn/formed", b"%016d" % 0)
            rv = await tr.get_read_version()
            cv = await tr.commit()
            referee.add(cv, tr.get_versionstamp(), rv, {}, {b"dyn/formed": b"%016d" % 0})
            transcript.append(("form", rv, cv))

        await attempt_loop("form", body)
        out["steps"]["form"] = {"sim_s": sim_now(), "wall_s": time.perf_counter() - w0,
                                "recoveries": [r[:2] for r in recovered()]}
        log(f"dynamic cluster ({out['device']}): formed, first commit at {sim_now():.3f} sim s, "
            f"{out['steps']['form']['wall_s']:.2f} s wall")

    def data_keys(ss) -> int:
        keys = ss.engine._keys
        return bisect.bisect_left(keys, b"rw0") - bisect.bisect_left(keys, b"rw/")

    async def load():
        t0, s0 = time.perf_counter(), sim_now()
        for lo in range(0, n_keys, COMMIT_LOAD_SETS):
            writes = {commit_key(i): b"%016d" % i for i in range(lo, min(lo + COMMIT_LOAD_SETS, n_keys))}

            async def body(tr, _attempt, writes=writes, lo=lo):
                for k, v in writes.items():
                    tr.set(k, v)
                rv = await tr.get_read_version()
                cv = await tr.commit()
                referee.add(cv, tr.get_versionstamp(), rv, {}, writes)
                transcript.append(("load", lo, rv, cv))
                return cv

            target = await attempt_loop(f"load {lo}", body)
            done = min(lo + COMMIT_LOAD_SETS, n_keys)
            if done % COMMIT_LOAD_PROGRESS == 0 and done < n_keys:  # how far a load cut short got
                log(f"dynamic cluster ({out['device']}): {done} keys loaded in {time.perf_counter() - t0:.1f} s")
        load_s, load_sim = time.perf_counter() - t0, sim_now() - s0
        # durable: every live server durable past the last load commit, its
        # index over its whole engine, no fetch in flight, and the data at
        # exactly two replicas
        t0 = time.perf_counter()
        for _ in range(20_000):
            live = [ss for _a, ss in live_storages()]
            if (len(live) == DYN_SHAPE["n_storage"]
                    and all(ss.durable_version >= target and ss._range_index is not None
                            and ss._range_index.n == len(ss.engine._keys) and not ss._fetch_buffers
                            for ss in live)
                    and sum(data_keys(ss) for ss in live) == DYN_SHAPE["replication"] * n_keys):
                break
            await delay(0.05)
        else:
            raise AssertionError("the load never became durable at two replicas: " + str(
                [(ss.tag, ss.durable_version, data_keys(ss)) for _a, ss in live_storages()]))
        out["steps"]["load"] = {"load_s": load_s, "load_sim_s": load_sim, "txns": math.ceil(n_keys / COMMIT_LOAD_SETS),
                                "durable_s": time.perf_counter() - t0, "durable_sim_s": sim_now() - s0 - load_sim,
                                "keys_by_tag": {ss.tag: data_keys(ss) for _a, ss in live_storages()},
                                "device_bytes": memory()}
        log(f"dynamic cluster ({out['device']}): {n_keys} keys in {out['steps']['load']['txns']} transactions "
            f"of {COMMIT_LOAD_SETS} sets in {load_s:.2f} s ({load_sim:.3f} sim s), durable at two replicas "
            f"{out['steps']['load']['durable_s']:.2f} s later; keys by tag {out['steps']['load']['keys_by_tag']}")

    async def mix_round(label: str, seed: int, txns: int = DYN_TXNS, during=None):
        _name, _n, n_reads, n_sets = MIX_A
        lat = {"commit_sim": [], "commit_wall": [], "grv_sim": [], "grv_wall": []}
        stats = {"committed": 0, "not_committed": 0, "unknown": 0, "other_errors": 0}
        errors: dict = {}  # error class -> attempts it ended

        async def actor(a):
            rnd = random.Random(seed * 1000 + a)
            for t in range(txns):
                for attempt in range(DYN_ATTEMPTS):
                    tr = db.transaction()
                    rv, reads, writes = None, {}, {}
                    try:
                        s0, w0 = sim_now(), time.perf_counter()
                        rv = await tr.get_read_version()
                        lat["grv_sim"].append(sim_now() - s0)
                        lat["grv_wall"].append(time.perf_counter() - w0)
                        keys = [commit_key(rnd.randrange(n_keys)) for _ in range(n_reads)]
                        vals = await wait_for_all([spawn(tr.get(k)) for k in keys])
                        reads = dict(zip(keys, vals))
                        # a value no other attempt writes: an unknown result
                        # is told apart by it
                        writes = {commit_key(rnd.randrange(n_keys)): b"A:%02d-%03d-%03d-%03d" % (seed, a, t, attempt)
                                  for _ in range(n_sets)}
                        for k, v in writes.items():
                            tr.set(k, v)
                        s0, w0 = sim_now(), time.perf_counter()
                        cv = await tr.commit()
                        lat["commit_sim"].append(sim_now() - s0)
                        lat["commit_wall"].append(time.perf_counter() - w0)
                        acks.append((sim_now(), time.perf_counter(), cv))
                        referee.add(cv, tr.get_versionstamp(), rv, reads, writes)
                        transcript.append((label, a, t, attempt, rv, keys, vals, sorted(writes.items()), cv))
                        stats["committed"] += 1
                        break
                    except Exception as e:
                        kind = type(e).__name__
                        transcript.append((label, a, t, attempt, kind))
                        errors[kind] = errors.get(kind, 0) + 1
                        if kind == "CommitUnknownResult":
                            unknowns.append((label, rv, reads, writes))
                            stats["unknown"] += 1
                        else:
                            stats["not_committed" if kind == "NotCommitted" else "other_errors"] += 1
                        await tr.on_error(e)
                else:
                    raise AssertionError(f"{label}: actor {a} transaction {t} failed {DYN_ATTEMPTS} times")
            return True

        w0, s0 = time.perf_counter(), sim_now()
        tasks = [spawn(actor(a)) for a in range(COMMIT_ACTORS)]
        if during is not None:
            await during()
        await wait_for_all(tasks)
        wall, sim_s = time.perf_counter() - w0, sim_now() - s0

        def pct(xs, q):
            return percentile(xs, q) * 1e3 if xs else None

        return {"actors": COMMIT_ACTORS, "txns_per_actor": txns, "wall_s": wall, "sim_s": sim_s,
                "txn_s_wall": stats["committed"] / wall, **stats, "errors": errors,
                "commit_ms_sim": {"p50": pct(lat["commit_sim"], 0.5), "p95": pct(lat["commit_sim"], 0.95)},
                "commit_ms_wall": {"p50": pct(lat["commit_wall"], 0.5), "p95": pct(lat["commit_wall"], 0.95)},
                "grv_ms_sim": {"p50": pct(lat["grv_sim"], 0.5), "p95": pct(lat["grv_sim"], 0.95)},
                "grv_ms_wall": {"p50": pct(lat["grv_wall"], 0.5), "p95": pct(lat["grv_wall"], 0.95)}}

    async def step(name, coro):
        res = await coro
        res["device_bytes"] = memory()
        out["steps"][name] = res
        r = res.get("mix", res)
        log(f"dynamic cluster ({out['device']}) {name}: {r['txn_s_wall']:.1f} committed txn/s of wall time "
            f"({r['sim_s']:.3f} sim s), {r['not_committed']} NotCommitted, {r['unknown']} unknown results, "
            f"commit p50 {r['commit_ms_sim']['p50']:.3f} ms sim / {r['commit_ms_wall']['p50']:.3f} ms wall, "
            f"GRV p50 {r['grv_ms_sim']['p50']:.3f} ms sim / {r['grv_ms_wall']['p50']:.3f} ms wall")

    def resolver_grids():
        """uid -> (worker, grid bytes, weak references to the grid's
        tensors: every entry's where torch is the spread) of every live
        resolver."""
        out = {}
        for addr, p in sim.processes.items():
            w = getattr(p, "worker", None)
            for uid, h in (w.roles.items() if w is not None and p.alive else ()):
                if h.kind == "resolver":
                    primary = h.obj.cs.primary
                    state = spread_states(primary._spread) if hasattr(primary, "_spread") else primary._state
                    out[uid] = (addr, sum(x.numel() * x.element_size() for x in state),
                                [weakref.ref(x) for x in state])
        return out

    async def kill_master():
        n0 = len(recovered())
        info, grids = {}, {}

        async def during():
            a0 = len(acks)
            while len(acks) < a0 + COMMIT_ACTORS // 2:  # the round is under way
                await delay(0.001)
            victim = hosting("master")[0]
            grids.update(resolver_grids())
            info.update(victim=victim, sim=sim_now(), wall=time.perf_counter(), memory=memory())
            transcript.append(("kill master", victim, sim_now()))
            sim.kill_process(victim)

        mix = await mix_round("master kill", seed=2, during=during)
        # gate: the surviving workers destroyed the old generation's
        # resolvers, and their grids left the card with them (those on the
        # killed worker stay: the Sim keeps its roles)
        gc.collect()
        destroyed = {u: g for u, g in grids.items() if g[0] != info["victim"]}
        kept = {u: g for u, g in grids.items() if g[0] == info["victim"]}
        held = sorted(u for u, (_a, _n, refs) in destroyed.items() if any(r() is not None for r in refs))
        if held or not destroyed:
            raise AssertionError(f"destroyed resolvers' grids still held: {held} of {sorted(destroyed)}")
        freed = {"destroyed_resolvers": len(destroyed), "destroyed_grid_bytes": sum(g[1] for g in destroyed.values()),
                 "kept_on_killed_worker": len(kept), "kept_grid_bytes": sum(g[1] for g in kept.values()),
                 "device_bytes_at_kill": info["memory"], "device_bytes_after_recovery": memory()}
        del grids, destroyed, kept
        rc, rv, s_rec, w_rec = recovered()[n0]
        first = next((s, w, cv) for s, w, cv in acks if cv > rv and s >= info["sim"])
        transcript.append(("recovered", rc, rv))
        return {"mix": mix, "victim": info["victim"], "recovery_count": rc, "recovery_version": rv, "grids": freed,
                "to_recovered_sim_s": s_rec - info["sim"], "to_recovered_wall_s": w_rec - info["wall"],
                "to_first_commit_sim_s": first[0] - info["sim"], "to_first_commit_wall_s": first[1] - info["wall"],
                "first_commit_version": first[2]}

    async def reboot_storage():
        victim, old = next((a, ss) for a, ss in live_storages() if ss.tag == 0)
        rv = await attempt_loop("reboot rv", lambda tr, _a: tr.get_read_version())
        s0, w0 = sim_now(), time.perf_counter()
        fallbacks[id(old)] = (old.tag, old.stats.snapshot()["multiGetFallbackKeys"])
        transcript.append(("kill storage", victim, old.tag, sim_now(), DYN_REBOOT_S))
        sim.kill_process(victim, reboot_in=DYN_REBOOT_S)
        for _ in range(100_000):
            new = next((ss for a, ss in live_storages() if a == victim and ss is not old), None)
            if new is not None and new._range_index is not None and new.version.get() >= rv:
                break
            await delay(0.01)
        else:
            raise AssertionError("the rebooted storage server never served again")
        serve = {"victim": victim, "tag": new.tag, "serves_sim_s": sim_now() - s0,
                 "serves_wall_s": time.perf_counter() - w0, "index_rows": new._range_index.n}
        transcript.append(("storage serves", new.tag, sim_now()))
        capture["rebooted"] = new
        return {"mix": await mix_round("storage reboot", seed=3), **serve}

    async def kill_storage():
        victim, dead = next((a, ss) for a, ss in live_storages() if ss.tag == 1)
        n_marks = len(marks)
        s0, w0 = sim_now(), time.perf_counter()
        fallbacks[id(dead)] = (dead.tag, dead.stats.snapshot()["multiGetFallbackKeys"])
        transcript.append(("kill storage for good", victim, dead.tag, sim_now()))
        sim.kill_process(victim)
        while True:
            await delay(1.0)
            shards = await walk_shards(db)
            if all(dead.tag not in tags and len(tags) == DYN_SHAPE["replication"] for _b, _e, _t, tags in shards):
                break
            if sim_now() - s0 > 600.0:
                raise AssertionError(f"data distribution left teams below two replicas: {shards}")
        fetched = [(p, f) for e, _s, _w, p, f in marks[n_marks:] if e == "FetchKeysDone"]
        transcript.append(("replicated", sim_now(), [(b, e, tags) for b, e, _t, tags in shards]))
        res = {"victim": victim, "tag": dead.tag, "replicated_sim_s": sim_now() - s0,
               "replicated_wall_s": time.perf_counter() - w0, "keys_moved": sum(f["Rows"] for _p, f in fetched),
               "fetches": len(fetched), "destinations": sorted({f["Tag"] for _p, f in fetched}),
               "shards": len(shards)}
        # the fetched rows leave the destinations' MVCC windows for their
        # engines: from then on their reads go through the filled indexes
        ready: dict = {}
        for _p, f in fetched:
            ready[f["Tag"]] = max(ready.get(f["Tag"], 0), f["ReadyVersion"])
        filled = [ss for _a, ss in live_storages() if ss.tag in ready]
        while any(ss.durable_version < ready[ss.tag] or ss._range_index is None
                  or ss._range_index.n != len(ss.engine._keys) for ss in filled):
            await delay(0.1)
        res["filled_durable_sim_s"] = sim_now() - s0
        res["filled_durable_wall_s"] = time.perf_counter() - w0
        res["filled_index_rows"] = {ss.tag: ss._range_index.n for ss in filled}
        transcript.append(("filled durable", sim_now()))
        capture["filled"] = filled
        capture["filled_base"] = {id(ss): by_ss.get(id(ss), 0) for ss in filled}
        return res

    async def read_back():
        """Every key through a fresh client's range reads, then every
        shard from every replica of its team through that server's own
        getKeyValues at one read version (each server's engine and index
        answer for their whole shards)."""
        db2 = Database.from_coordinators(sim, cluster.coordinators, client_addr="reader")
        got, lo = {}, b"rw/"
        w0 = time.perf_counter()
        while True:
            async def body(tr, _attempt, lo=lo):
                return await tr.get_range(lo, b"rw0", limit=DYN_READ_CHUNK)

            rows = await attempt_loop("read back", body)
            got.update(rows)
            if len(rows) < DYN_READ_CHUNK:
                break
            lo = rows[-1][0] + b"\x00"
        client_s = time.perf_counter() - w0
        rv = await attempt_loop("replica read version", lambda tr, _a: tr.get_read_version())
        replicas: dict = {}
        for begin, end, team, _tags in await walk_shards(db2):
            lo, hi = max(begin, b"rw/"), b"rw0" if end is None else min(end, b"rw0")
            for addr in team if lo < hi else ():
                rows, at = replicas.setdefault(addr, {}), lo
                while True:
                    reply = await db2.client.request(
                        Endpoint(addr, Tokens.GET_KEY_VALUES),
                        GetKeyValuesRequest(begin=at, end=hi, version=rv, limit=DYN_READ_CHUNK))
                    rows.update(reply.data)
                    if not reply.more:
                        break
                    at = reply.data[-1][0] + b"\x00"
        return got, replicas, {"client_s": client_s, "replicas_s": time.perf_counter() - w0 - client_s,
                               "replica_read_version": rv}

    async def profiled_round():
        """One mix-A round (one transaction an actor) under torch.profiler
        and the device spans, as phase 13's."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        c0 = sum(kernels.launch_counts().values())
        spans["on"], spans["pairs"] = True, []
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                await mix_round("profiled", seed=9, txns=1)
                torch.cuda.synchronize()
                window = time.perf_counter() - w0
        finally:
            spans["on"] = False
        n_launch = sum(kernels.launch_counts().values()) - c0
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ours = [e for e in dev if PORT_KERNELS.search(e.name)]
        busy = sum(e.time_range.elapsed_us() for e in dev) * 1e-6
        span = sum(e0.elapsed_time(e1) for e0, e1 in spans["pairs"]) * 1e-3
        whole = len(ours) >= n_launch > 0
        return {"window_ms": window * 1e3, "launches": n_launch, "profiler_port_kernels": len(ours),
                "profiler_device_busy_ms": busy * 1e3, "device_span_ms": span * 1e3,
                "device_idle_at_least": 1.0 - span / window,
                "device_idle": 1.0 - (busy if whole else span) / window,
                "device_busy_from": "profiler" if whole else "cuda_events_around_device_part"}

    async def main():
        await form()
        await load()
        gc.collect()
        gc.freeze()  # phase 12's rule: the load's objects leave the collector's scans
        if on_card:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
        w0 = time.perf_counter()
        if measure:  # the first round after the load is the slow one: where its host time goes
            with StackSampler() as sampler:
                await step("mix_a", mix_round("mix A", seed=1))
            out["steps"]["mix_a"]["stacks"] = sampler.top()
        else:
            await step("mix_a", mix_round("mix A", seed=1))
        await step("master_kill", kill_master())
        await step("storage_reboot", reboot_storage())
        res = await kill_storage()
        res["device_bytes"] = memory()
        out["steps"]["storage_death"] = res
        log(f"dynamic cluster ({out['device']}): storage tag {res['tag']} dead, every team at two replicas "
            f"{res['replicated_sim_s']:.3f} sim s / {res['replicated_wall_s']:.2f} s wall later, "
            f"{res['keys_moved']} keys moved in {res['fetches']} fetches to tags {res['destinations']}")
        if measure:
            out["round_profile"] = await profiled_round()
        newest = max(e for e, _r in resolvers.values())
        capture["on"] = True
        capture["cs"] = next(r() for e, r in resolvers.values() if e == newest).cs._cs
        await step("last", mix_round("last", seed=4))
        got, replicas, read_s = await read_back()
        capture["on"] = False
        out["main_wall_s"] = time.perf_counter() - w0
        out["read_back"] = {"keys": len(got), "replica_keys": {a: len(r) for a, r in sorted(replicas.items())},
                            **read_s}
        if on_card:
            out["launches"] = {k: v for k, v in kernels.launch_counts().items() if v}
        return got, replicas

    Worker._make_resolver, Worker._make_storage, Worker._destroy = recorded_resolver, recorded_storage, summarized_destroy
    Built.detect_many_encoded_async, Built.encode = counted_detect, captured_encode
    TorchRangeIndex._search_codes = spanned_search
    for n in ss_reads:
        setattr(StorageServer, n, counted_read(n))
    proxy_mod.substitute_versionstamps = tagging
    try:
        got, replicas = sim.run_until_done(spawn(main()), limit=1e6)
    finally:
        Worker._make_resolver, Worker._make_storage, Worker._destroy = make_resolver, make_storage, destroy
        Built.detect_many_encoded_async, Built.encode = detect_async, encode
        TorchRangeIndex._search_codes = search_codes
        for n, fn in ss_reads.items():
            setattr(StorageServer, n, fn)
        proxy_mod.substitute_versionstamps = substitute
        T.set_trace_log(saved_log)

    # unknown results: committed where the proxy tagged the attempt's write
    # at or below its generation's end (the next recovery's version)
    ends = {rc - 1: rv for rc, rv, _s, _w in recovered()}
    resolved = []
    for label, rv, reads, writes in unknowns:
        (key, value), = writes.items()
        epoch, cv, idx = tagged.get((key, value), (None, None, None))
        committed = cv is not None and cv <= ends.get(epoch, 1 << 62)
        if committed:
            referee.add(cv, cv.to_bytes(8, "big") + idx.to_bytes(2, "big"), rv, reads, writes)
        resolved.append((label, rv, sorted(writes.items()), committed, cv, idx))
    transcript.append(("unknown results", resolved))
    out["unknown_results"] = {"attempts": len(resolved), "committed": sum(r[3] for r in resolved)}
    out["referee"] = referee.check()

    # gate: every acknowledged write read back, as the referee's model says
    model = {commit_key(i): b"%016d" % i for i in range(n_keys)}
    model.update({k: v for k, v in referee.model().items() if k.startswith(b"rw/")})
    if got != model:
        bad = sorted(set(got) ^ set(model)) or [k for k in model if got[k] != model[k]]
        raise AssertionError(f"read-back differs from the model at {len(bad)} keys, e.g. {bad[0]!r}: "
                             f"{got.get(bad[0])!r} != {model.get(bad[0])!r}")
    transcript.append(("read back", len(got), zlib.crc32(b"".join(k + v for k, v in sorted(got.items())))))
    # gate: every replica holds exactly its shards' keys with the model's
    # values, and every key has two replicas
    held: dict = {}
    for addr, rows in sorted(replicas.items()):
        bad = [k for k, v in rows.items() if model.get(k) != v]
        if bad:
            raise AssertionError(f"replica {addr} holds {len(bad)} keys other than the model's, e.g. "
                                 f"{bad[0]!r}: {rows[bad[0]]!r} != {model.get(bad[0])!r}")
        for k in rows:
            held[k] = held.get(k, 0) + 1
    if len(held) != len(model) or set(held.values()) != {DYN_SHAPE["replication"]}:
        raise AssertionError(f"{len(held)} keys on the replicas of {len(model)}, copies "
                             f"{sorted(set(held.values()))}")
    transcript.append(("replicas", sorted((a, len(r)) for a, r in replicas.items())))
    # gate: no multiGet key fell back to the engine bisect, on any server
    for ref in storages:
        ss = ref()
        if ss is not None and id(ss) not in fallbacks:
            fallbacks[id(ss)] = (ss.tag, ss.stats.snapshot()["multiGetFallbackKeys"])
    if any(n for _tag, n in fallbacks.values()):
        raise AssertionError(f"multiGetFallbackKeys (tag, keys): {sorted(fallbacks.values())}")
    # gate: every generation's resolvers healthy on torch, on the card named
    for uid, (epoch, ref) in resolvers.items():
        if uid not in resolved_by:  # still serving
            summarize(uid, epoch, ref())
    gens: dict = {}
    for uid, (epoch, h, snap, device_type, launched) in sorted(resolved_by.items()):
        if (h["state"], h["faults"], h["failovers"], h["backend"]) != ("HEALTHY", 0, 0, built["name"]):
            raise AssertionError(f"resolver {uid}: the guard left its healthy path: {h}")
        if device_type != ("cuda" if on_card else "cpu"):
            raise AssertionError(f"resolver {uid} runs on {device_type}")
        g = gens.setdefault(epoch, {"resolvers": 0, "batches": 0, "transactions": 0, "grid_growths": 0,
                                    "launches": {}})
        g["resolvers"] += 1
        g["batches"] += snap["resolveBatchIn"]
        g["transactions"] += snap["transactions"]
        g["grid_growths"] += snap["kernel"]["capacityGrowths"]
        for k, v in launched.items():
            g["launches"][k] = g["launches"].get(k, 0) + v
    for epoch, g in gens.items():
        if g["resolvers"] != DYN_SHAPE["n_resolvers"]:
            raise AssertionError(f"generation {epoch} recruited {g['resolvers']} resolvers")
        if on_card and any(g["launches"].get(k, 0) <= 0 for k in path):
            raise AssertionError(f"generation {epoch}: the resolve kernels did not all launch: {g['launches']}")
    out["generations"] = {str(e): g for e, g in sorted(gens.items())}
    transcript.append(("generations", sorted((e, g["batches"], g["transactions"], g["grid_growths"])
                                             for e, g in gens.items())))
    if len(gens) < 2:
        raise AssertionError(f"no recovery recruited a second generation: {sorted(gens)}")
    # gate: K5 on the rebooted server and on the data distribution's
    # destinations
    rebooted, filled = capture["rebooted"], capture["filled"]
    after_fill = {ss.tag: by_ss.get(id(ss), 0) - capture["filled_base"][id(ss)] for ss in filled}
    out["search_launches"] = {"rebooted": by_ss.get(id(rebooted), 0), "filled_after_the_fill": after_fill}
    if on_card and (out["search_launches"]["rebooted"] <= 0 or not filled
                    or any(n <= 0 for n in after_fill.values())):
        raise AssertionError(f"K5 did not launch on the rebooted and the filled servers: {out['search_launches']}")
    events = [(e, s, p, sorted((k, v) for k, v in f.items() if isinstance(v, (int, str, bytes))))
              for e, s, _w, p, f in marks]
    transcript.append(("events", events))
    out["recoveries"] = [r[:2] for r in recovered()]
    out["data_distribution"] = [(e, s, w - t_run) for e, s, w, _p, _f in marks if e.startswith("DD")]
    out["run_s"] = time.perf_counter() - t_run
    out["transcript"] = transcript
    out["capture"] = capture
    out["cluster"] = cluster
    return out


def dynamic_twin_cpu(card: str, n_keys: int) -> dict:
    """Phase 14's CPU twin (a spawned child process): ``dynamic_cluster_run``
    at ``n_keys`` keys with ``device="cpu"`` in this host's layout
    (``twin_layout``); its transcript and seconds."""
    with twin_layout():
        run = dynamic_cluster_run(card, "cpu", n_keys, measure=False)
    return {"transcript": run["transcript"], "run_s": run["run_s"]}


def run_dynamic_cluster(card: str) -> tuple[dict, list[dict]]:
    """Phase 14: the dynamic cluster on the card. The twin (the same run at
    DYN_TWIN_KEYS keys with ``device="cpu"`` in a child process, and on the
    card: identical transcripts) and the DYN_KEYS run on the card with its
    gates and measurements; after it, K1-K3 against their plain versions on
    the newest generation's widest batch, and K5 on the rebooted server's
    and a filled server's index. Returns the phase's JSON object and the
    rows."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from foundationdb_tpu_torch.device import lanes_to_torch
    from foundationdb_tpu_torch.runtime.loop import set_loop

    t_phase = time.perf_counter()
    # the CPU twin in a spawned child process, beside the card's two runs
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_twin = pool.submit(dynamic_twin_cpu, card, DYN_TWIN_KEYS)
        card_twin = dynamic_cluster_run(card, None, DYN_TWIN_KEYS, measure=False)
        twin = {"card": {k: card_twin[k] for k in ("transcript", "run_s", "recoveries", "unknown_results")}}
        del card_twin
        set_loop(None)
        gc.unfreeze()  # the run froze its objects before its mixes
        gc.collect()
        run = dynamic_cluster_run(card, None, DYN_KEYS, measure=True)
        t0 = time.perf_counter()
        twin["cpu"] = cpu_twin.result()
        twin_wait_s = time.perf_counter() - t0
    a, b = twin["cpu"]["transcript"], twin["card"]["transcript"]
    if a != b:
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        raise AssertionError(f"the CPU twin's transcript differs from the card's at record {i} of "
                             f"{len(a)} / {len(b)}: {str(a[i] if i < len(a) else None)[:400]} != "
                             f"{str(b[i] if i < len(b) else None)[:400]}")
    twin_out = {"keys": DYN_TWIN_KEYS, "records": len(a), "cpu_run_s": twin["cpu"]["run_s"],
                "card_run_s": twin["card"]["run_s"], "cpu_wait_s": twin_wait_s,
                "recoveries": twin["card"]["recoveries"], "unknown_results": twin["card"]["unknown_results"]}
    log(f"dynamic cluster twin: {len(a)} records identical on the CPU (a child process) and on the card "
        f"({twin_out['cpu_run_s']:.1f} s and {twin_out['card_run_s']:.1f} s; waited {twin_wait_s:.1f} s for "
        f"the CPU's after the card's runs) [{card}]")
    del twin, a, b
    gc.collect()

    cluster, capture = run.pop("cluster"), run.pop("capture")
    run.pop("transcript")
    launches = run["launches"]
    missing = [k for k in torch_built()["path"] + ("search",) if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the dynamic cluster: {missing} ({launches})")

    # K1-K3 on the newest generation's widest batch of the last round
    (_size, cs, (hbatch, n_real, _epoch)) = capture["best"]
    newest = max(int(e) for e in run["generations"])
    gen_launches = run["generations"][str(newest)]["launches"]
    base = cs._origin[1]
    window = cluster.knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS
    old = max(cs.oldest_version - base, 0)
    vers = (old + window, old, old)
    T_, KR, KW = hbatch.rb.shape[0], hbatch.rb.shape[1], hbatch.wb.shape[1]
    log(f"kernel checks on generation {newest}'s widest batch of the last round ({n_real} transactions, "
        f"T={T_} KR={KR} KW={KW}; version origin {base}) [{card}]:")
    rows = check_built_resolve(resolver_state(cs), hbatch, vers, gen_launches, " (dynamic cluster)")
    for r in rows:
        r["name"] = f"{r['name']} (dynamic cluster, generation {newest} batch T={T_} KR={KR} KW={KW})"
    # K5 on the rebooted server's index and on the filled server that
    # searched most after the fill, each with its widest search of the
    # last round and the read-back
    after_fill = run["search_launches"]["filled_after_the_fill"]
    filled = max(capture["filled"], key=lambda ss: after_fill[ss.tag])
    for label, ss, n in (("rebooted", capture["rebooted"], run["search_launches"]["rebooted"]),
                         ("filled by data distribution", filled, after_fill[filled.tag])):
        q_rows, codes = capture["q"][id(ss)]
        idx = ss._range_index
        log(f"K5 on the {label} storage server's index (tag {ss.tag}, {idx.n} rows), its widest search "
            f"(Q={q_rows}) [{card}]:")
        k5 = check_search(idx._codes, lanes_to_torch(codes, "cuda"), {"search": n})[0]
        k5["name"] = f"search (dynamic cluster, {label} index, Q={q_rows})"
        rows.append(k5)
    run["kernel_rows"] = [{k: r[k] for k in ("name", "launches", "ms", "device_ms", "plain_ms",
                                             "bound_ms", "bound_by", "max_abs_err")} for r in rows]
    run["twin"] = twin_out
    run["phase_s"] = time.perf_counter() - t_phase
    run["card"] = card
    mk = run["steps"]["master_kill"]
    log(f"dynamic cluster: master killed, recovered (count {mk['recovery_count']}, version "
        f"{mk['recovery_version']}) {mk['to_recovered_sim_s']:.3f} sim s / {mk['to_recovered_wall_s']:.3f} s wall "
        f"later, first commit of the new generation {mk['to_first_commit_sim_s']:.3f} sim s / "
        f"{mk['to_first_commit_wall_s']:.3f} s wall; device idle {run['round_profile']['device_idle']:.4f} "
        f"({run['round_profile']['device_busy_from']}) [{card}]")
    log(json.dumps({"dynamic_cluster": run}, default=str))
    log(card)
    del cluster, capture, cs
    set_loop(None)
    gc.unfreeze()
    gc.collect()
    return run, rows


SOAK_SEEDS = (0, 1, 4, 7)  # tests/test_soak.py's seeds
SOAK_FORCED = {"force_kernel_faults": True, "force_overload": True}  # its composition case, on seed 0
SOAK_MORE_FROM = 8  # then consecutive seeds from here ...
SOAK_BUDGET_S = 30.0  # ... while the phase has run less than this (90 s, then 40 s for phase 17, 30 s for phase 5's scan checks),
SOAK_MORE_LAST = 18  # and none past 18: seed 19 never finishes, in either package (ROADMAP C6)
SOAK_EVENTS = ("KernelFailover", "KernelPromoted", "MasterFullyRecovered")


def collect_all() -> None:
    """Collect until nothing is left: a freed Sim's coroutines run their
    ``finally`` blocks as the collector finalizes them, and what those
    schedule on the dead loop holds the Sim through one more pass."""
    for _ in range(20):
        if not gc.collect():
            return


def counting_log(counted: dict, events, by_error: bool = False):
    """A trace log that also counts, into ``counted``, the events of the
    types ``events`` (with ``by_error``, a ``KernelFault`` under its
    error's class, "KernelFault ExchangeTimeoutError")."""
    from foundationdb_tpu_torch.runtime import trace as T

    class CountingLog(T.TraceLog):
        def log(self, severity, event_type, time_, process, **fields):
            super().log(severity, event_type, time_, process, **fields)
            if event_type in events:
                if by_error and event_type == "KernelFault":
                    event_type += " " + str(fields.get("Err", "")).split("(")[0]
                counted[event_type] = counted.get(event_type, 0) + 1

    return CountingLog()


def live_guards(sim) -> list:
    """(health, backend, device, last error) of every live resolver's
    guard."""
    out = []
    for _addr, proc in sorted(sim.processes.items()):
        w = getattr(proc, "worker", None)
        for h in (w.roles.values() if w is not None and proc.alive else ()):
            if h.kind == "resolver":
                primary = h.obj.cs.primary
                out.append((h.obj.cs.health, type(primary).__name__,
                            getattr(getattr(primary, "_device", None), "type", "host"), h.obj.cs.last_error))
    return out


def soak_once(seed: int, device, kw: dict, capture: dict | None = None,
              reshards: dict | None = None) -> dict:
    """One ``tools.soak.run_one(seed, device=device, **kw)`` of the port:
    its summary, its sim and wall seconds, the guards' failovers and
    promotions and the recoveries (from its trace), the kernel launches of
    the run (on the card), the transport arm, and each live resolver's
    guard at the end (health, backend, device, last error). With
    ``capture``, the run's widest resolver batch (a copy of the grid it
    met, the encoded batch and its versions) and its widest K5 search (the
    index's codes and the query codes) go into it. With ``reshards``, the
    widest device reshard (K4a) it has seen so far, over this and earlier
    runs: a host copy of the grid (so the card's memory gate does not see
    it), the bucket and slot counts and the seed."""
    from foundationdb_tpu_torch.conflict import grid as G
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex
    from foundationdb_tpu_torch.runtime import trace as T
    from foundationdb_tpu_torch.runtime.loop import set_loop
    from foundationdb_tpu_torch.tools import soak

    on_card = device is None
    counted = {e: 0 for e in SOAK_EVENTS}
    sims: list = []
    # torch is a spread on a multi-card host; the forced seed pins torch1
    encodes = {cls: cls.encode for cls in (TorchConflictSet, TorchMeshConflictSet)}
    make_sim, search_codes = soak.Sim, TorchRangeIndex._search_codes
    reshard = G.reshard_device

    def recorded_sim(*a, **k):
        sims.append(make_sim(*a, **k))
        return sims[-1]

    def captured_encode(self, transactions):
        enc = encodes[type(self)](self, transactions)
        size = (len(transactions), enc[0].rb.shape[1] * enc[0].wb.shape[1])
        if size > capture.get("size", (0, 0)):
            base = self._origin[1]
            old = max(self.oldest_version - base, 0)
            window = sims[-1].knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS
            capture.update(size=size, snap=resolver_state(self), enc=enc, vers=(old + window, old, old))
        return enc

    def captured_search(self, codes):
        if codes.shape[0] > capture.get("q_rows", 0):
            capture.update(q_rows=codes.shape[0], q=codes, index=self._codes)
        return search_codes(self, codes)

    def captured_reshard(state, n_buckets, n_slots):
        size = (int(state.count.sum()), n_buckets * n_slots)
        if size > reshards.get("size", (-1, 0)):
            reshards.update(size=size, seed=seed, buckets=n_buckets, slots=n_slots,
                            state=type(state)(*(t.cpu() for t in state)))
        return reshard(state, n_buckets, n_slots)

    def run() -> dict:
        """The run, and what it leaves as plain data: no frame that
        outlives this call holds its Sim."""
        if on_card:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
        w0 = time.perf_counter()
        summary = soak.run_one(seed, device=device, **kw)
        wall = time.perf_counter() - w0
        if on_card:
            torch.cuda.synchronize()
        sim = sims[0]
        return {"summary": summary, "wall_s": wall, "sim_s": sim.loop.now(),
                "failovers": counted["KernelFailover"], "promotions": counted["KernelPromoted"],
                "recoveries": counted["MasterFullyRecovered"],
                "launches": {k: v for k, v in kernels.launch_counts().items() if v} if on_card else {},
                "transport_armed": bool(sim.knobs.TRANSPORT_FAULT_INJECTION), "guards": live_guards(sim)}

    saved_log = T.trace_log()
    T.set_trace_log(counting_log(counted, SOAK_EVENTS))
    soak.Sim = recorded_sim
    if capture is not None:
        TorchConflictSet.encode = TorchMeshConflictSet.encode = captured_encode
        TorchRangeIndex._search_codes = captured_search
    if reshards is not None:
        G.reshard_device = captured_reshard
    try:
        return run()
    finally:
        # the run is freed before the next one starts: an abandoned Sim's
        # actors run their ``finally`` blocks when the collector frees
        # them, into whatever run is current (its RNG draws, its trace)
        soak.Sim = make_sim
        for cls, fn in encodes.items():
            cls.encode = fn
        TorchRangeIndex._search_codes = search_codes
        G.reshard_device = reshard
        T.set_trace_log(saved_log)
        sims.clear()
        set_loop(None)
        collect_all()


def soak_kernel_rows(capture: dict, card: str) -> list[dict]:
    """K1-K3 and the scan on the forced seed's widest batch and K5 on its
    widest search, against their plain versions (launch counts filled in
    by the caller)."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.device import lanes_to_torch

    if "size" not in capture or "q" not in capture:
        raise AssertionError(f"the forced seed captured no batch or search: {sorted(capture)}")
    hbatch, n_real, _epoch = capture["enc"]
    T_, KR, KW = hbatch.rb.shape[0], hbatch.rb.shape[1], hbatch.wb.shape[1]
    counts = dict.fromkeys(kernels.WRAPPERS, 0)
    log(f"kernel checks on the forced soak seed's widest batch ({n_real} transactions, T={T_} KR={KR} "
        f"KW={KW}) [{card}]:")
    rows = check_built_resolve(capture["snap"], hbatch, capture["vers"], counts, " (chaos soak)")
    for r in rows:
        r["kernel"], r["name"] = r["name"], f"{r['name']} (chaos soak, forced seed's widest batch T={T_} KR={KR} KW={KW})"
    log(f"K5 on the forced soak seed's widest search (Q={capture['q_rows']} over "
        f"{capture['index'].shape[0]} rows) [{card}]:")
    k5 = check_search(capture["index"], lanes_to_torch(capture["q"], "cuda"), counts)[0]
    k5["kernel"], k5["name"] = "search", f"search (chaos soak, forced seed's widest search, Q={capture['q_rows']})"
    return rows + [k5]


def soak_reshard_rows(reshards: dict, card: str) -> list[dict]:
    """K4a on the widest device reshard of the phase's card runs, against
    its plain version (launch count filled in by the caller)."""
    if "state" not in reshards:
        raise AssertionError("K4a launched in the soak, but no reshard was captured")
    host = reshards["state"]
    state = type(host)(*(t.to("cuda") for t in host))
    B, S = reshards["buckets"], reshards["slots"]
    rows: list = []
    log(f"K4a on the widest reshard of the soak's card runs (seed {reshards['seed']}, "
        f"{reshards['size'][0]} live rows of a {tuple(state.grid.shape)} grid into B={B} S={S}) [{card}]:")
    check_reshard(state, B, S, row_maker(rows, {"maint_reshard": 0}))
    (r,) = rows
    r["kernel"], r["name"] = "maint_reshard", (
        f"maint_reshard (chaos soak, the card runs' widest reshard: seed {reshards['seed']}, "
        f"{reshards['size'][0]} live rows into B={B} S={S})")
    return rows


def same_guards(card_guards: list, twin_guards: list) -> bool:
    """The card run's live guards equal its CPU twin's: health, backend
    and last error, with the device left out."""
    def strip(guards):
        return [(health, backend, err) for health, backend, _device, err in guards]

    return strip(card_guards) == strip(twin_guards)


def injected(last_error: str) -> bool:
    """A failed-over guard's last error is a fault the injector raised,
    or the dispatch deadline on an injected stall: in a Sim the device
    thread runs inline, so a real card that stops answering blocks the
    run instead of reaching the deadline, and a lost card's CUDA error
    names no injection."""
    return "injected" in last_error or last_error.startswith(
        "KernelTimeoutError('conflict dispatch deadline")


def run_soak(card: str) -> tuple[dict, list[dict]]:
    """Phase 15: the port's chaos soak (``tools.soak.run_one``) on the card,
    through its own entry point. Seeds 0, 1, 4 and 7, then seed 0 with
    kernel faults and the overload burst forced, then consecutive seeds
    from 8 while the phase is under its budget (none past 18: seed 19 never
    finishes in either package, ROADMAP C6). Each
    seed's gates: the run passes every check of its own; a CPU twin (the
    same call with ``device="cpu"``) gives the identical summary; K5
    launched; on a seed that drew ``torch``, the scan launched and every live
    guard on the card at the end (or failed over, where kernel faults are
    armed); on the forced seed, a ``kernel-*`` site fired and the guard
    failed over and promoted back (the run's ``KernelChaosWorkload`` holds
    its exact ledger), then K1-K3 on its widest batch and K5 on its widest
    search against their plain versions; after the seed,
    ``torch.cuda.memory_allocated()`` is back at its value before the
    phase. The twin also gives the same failovers, promotions, recoveries
    and live guards (health, backend, last error), and a guard failed
    over at the end names an injected fault. After the seeds, K4a on the
    widest reshard of the card runs against its plain version. One
    ``{"soak": ...}`` line a seed, then one summary line; a failing seed
    fails the phase after every seed has run. Returns the phase's JSON
    object and the rows."""
    t_phase = time.perf_counter()
    # the first matmul on the card allocates cuBLAS's workspace (32 MiB on
    # Hopper) through the caching allocator, and it stays: K2's plain
    # version makes one in the forced seed's checks, so the baseline holds
    # it already, as it does after phase 5
    torch.ones(1, 1, device="cuda") @ torch.ones(1, 1, device="cuda")
    collect_all()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    plan = [(s, {}) for s in SOAK_SEEDS] + [(0, SOAK_FORCED)]
    lines, failures, totals, rows, reshards = [], [], {}, [], {}
    more = SOAK_MORE_FROM
    while plan or (more <= SOAK_MORE_LAST and time.perf_counter() - t_phase < SOAK_BUDGET_S):
        if plan:
            seed, kw = plan.pop(0)
        else:
            seed, kw = more, {}
            more += 1
        forced = bool(kw)
        line = {"seed": seed, "forced": forced}
        capture: dict = {}
        collect_all()  # a failed seed's traceback held its Sim until here
        try:
            card_run = soak_once(seed, None, kw, capture if forced else None, reshards)
            with twin_layout():  # the CPU twin of this host's layout
                twin = soak_once(seed, "cpu", kw)
            s = card_run["summary"]
            backend = s["config"]["conflict_backend"]
            launches = card_run["launches"]
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            kernel_sites = [x for x in s["buggify_sites"] if x.startswith("kernel-")]
            line.update({
                "config": s["config"], "backend": backend, "workloads": s["workloads"],
                "kernel_faults_armed": s["kernel_faults_armed"], "overload_armed": s["overload_armed"],
                "transport_armed": card_run["transport_armed"], "buggify_fired": s["buggify_fired"],
                "kernel_sites": kernel_sites, "failovers": card_run["failovers"],
                "promotions": card_run["promotions"], "recoveries": card_run["recoveries"],
                "launches": {**{k: 0 for k in RESOLVE_PATH + ("search",)}, **launches},
                "card": {"wall_s": card_run["wall_s"], "sim_s": card_run["sim_s"]},
                "twin": {"wall_s": twin["wall_s"], "sim_s": twin["sim_s"]},
                "guards": card_run["guards"],
            })
            if twin["summary"] != s:
                diff = sorted(k for k in s if twin["summary"].get(k) != s[k])
                raise AssertionError(f"the CPU twin's summary differs in {diff}")
            # the injector's draws are seeded: the card's faults are the twin's
            for k in ("failovers", "promotions", "recoveries"):
                if card_run[k] != twin[k]:
                    raise AssertionError(f"{k}: card {card_run[k]}, CPU twin {twin[k]}")
            if not same_guards(card_run["guards"], twin["guards"]):
                raise AssertionError(f"live guards: card {card_run['guards']}, CPU twin {twin['guards']}")
            stray = [g for g in card_run["guards"] if g[0] == "FAILED_OVER" and not injected(g[3])]
            if stray:
                raise AssertionError(f"a guard failed over on a fault nothing injected: {stray}")
            if launches.get("search", 0) <= 0:
                raise AssertionError(f"K5 never launched: {launches}")
            if backend in ("torch", "torch1"):  # torch1: the forced seed's pinned grid
                built = torch_built(backend)
                missing = [k for k in built["path"] if launches.get(k, 0) <= 0]
                if missing:
                    raise AssertionError(f"kernels never launched on a torch seed: {missing}")
                # a guard fails over only on a kernel fault: with the
                # injection armed, the run may end before it promotes back
                off = [g for g in card_run["guards"] if g[1:3] != (built["name"], "cuda")
                       and not (s["kernel_faults_armed"] and g[0] == "FAILED_OVER")]
                if off or not card_run["guards"]:
                    raise AssertionError(f"a live guard is off the card at the end: {card_run['guards']}")
            if forced:
                if not (kernel_sites and card_run["failovers"] > 0 and card_run["promotions"] > 0):
                    raise AssertionError(f"the forced seed: kernel sites {kernel_sites}, failovers "
                                         f"{card_run['failovers']}, promotions {card_run['promotions']}")
                rows = soak_kernel_rows(capture, card)
        except Exception as e:  # the seed fails; the phase fails after every seed has run
            failures.append((seed, forced, repr(e)))
            line["error"] = repr(e)[:600]
        capture.clear()
        collect_all()
        torch.cuda.synchronize()
        line["memory"] = {"before_phase": m0, "after": torch.cuda.memory_allocated()}
        if line["memory"]["after"] != m0:
            failures.append((seed, forced, f"card memory {line['memory']['after']} B after the seed, "
                                           f"{m0} B before the phase"))
        lines.append(line)
        log(json.dumps({"soak": line}, default=str))
    if totals.get("maint_reshard", 0):
        rows += soak_reshard_rows(reshards, card)
    reshards.clear()
    for r in rows:  # the launches of the phase's runs, not of the checks
        r["launches"] = totals.get(r.pop("kernel"), 0)
    torch_seeds = [x["seed"] for x in lines if x.get("backend") == "torch" and not x["forced"]]
    out = {"seeds": len(lines), "green": len(lines) - len({(s, f) for s, f, _e in failures}),
           "torch_seeds": torch_seeds, "failures": failures, "wall_s": time.perf_counter() - t_phase,
           "launches": totals, "memory_before_phase": m0, "card": card}
    log(json.dumps({"soak_summary": out}, default=str))
    log(card)
    if failures:
        raise AssertionError(f"phase 15: {len(failures)} failure(s): {failures}")
    return out, rows


# 16. the real-process cluster: the port's fdbserver processes over TCP,
# the same layout as RealWorlds in this process, and the bindingtester
# phase 13's b"rw/%08d" keys, cut to half of BASELINE.json's YCSB "uniform
# 1M keys": the script's time limit
TCP_KEYS = 500_000
TCP_VALUE = b"v" * 16  # workloads/readwrite.py's value, which the mix writes too
TCP_CLASSES = ("storage",) * 3 + ("transaction",) * 2 + ("stateless",) * 2
# FoundationDB's "double" redundancy, cell 9's shape on two storage servers
TCP_CONFIG = ("n_proxies=2,n_resolvers=2,n_tlogs=2,tlog_replication=2,n_storage=2,replication=2,"
              "conflict_backend=torch")
TCP_KNOBS = ("STORAGE_TPU_INDEX=true",)  # on a RealLoop the index is off unless asked for (knobs.py)
TCP_LOADERS = 4  # load client processes
TCP_LOAD_ACTORS = 4  # transactions of COMMIT_LOAD_SETS sets in flight in each
TCP_MIX_PROCS = 2  # perf tcp-client processes of the 90_10 mix
TCP_MIX_ACTORS = 20  # perf.py's default actors
TCP_MIX_S = 20.0  # the mix's steady-state seconds (perf --duration)
TCP_READ_CHUNK = 10_000  # rows a range read of the read-back
TCP_FORM_S = 240.0
TCP_SPOT_TXNS = 20  # transactions of point reads after the read-back (the storage gate's multiGet reads)
TCP_SPOT_GETS = 50
TCP_RECOVER_S = 180.0
INPROC_KEYS = 100_000  # bench_e2e's keyspace, phase 13's twin
INPROC_ACTORS = 20
INPROC_MIX_S = 10.0
BINDING_SEEDS = range(50)  # tests/test_bindingtester.py's streams
BINDING_CHAOS = (3, 17, 29, 41)
BINDING_OPS, BINDING_CHAOS_OPS = 1000, 250
BINDING_PREFIXES = (b"bt/i", b"bt/d/", b"bt/r/")  # instructions, data, results


def tcp_loader(coord: str, lo: int, hi: int, actors: int) -> dict:
    """One load client process (``--tcp-loader``): keys ``[lo, hi)`` in
    transactions of COMMIT_LOAD_SETS sets, ``actors`` of them in flight,
    each retried through ``Database.run``; every key of the range is
    acknowledged when this returns."""
    from foundationdb_tpu_torch.client.database import Database
    from foundationdb_tpu_torch.net.tcp import RealWorld
    from foundationdb_tpu_torch.runtime.futures import spawn, wait_for_all

    world = RealWorld("127.0.0.1:0")
    world.activate()
    db = Database.from_coordinators(world, [coord])
    starts = list(range(lo, hi, COMMIT_LOAD_SETS))
    lat: list = []

    async def actor(i):
        for b in starts[i::actors]:
            async def fill(tr, b=b):
                for n in range(b, min(b + COMMIT_LOAD_SETS, hi)):
                    tr.set(commit_key(n), TCP_VALUE)

            t0 = time.perf_counter()
            await db.run(fill)
            lat.append(time.perf_counter() - t0)
        return True

    async def load():
        await wait_for_all([spawn(actor(i)) for i in range(actors)])
        return True

    t0 = time.perf_counter()
    try:
        world.run_until_done(spawn(load()), 3600.0)
    finally:
        world.close()
    return {"keys": hi - lo, "txns": len(lat), "wall_s": time.perf_counter() - t0,
            "commit_ms": {"p50": percentile(lat, 0.5) * 1e3, "p95": percentile(lat, 0.95) * 1e3}}


def tcp_mix(argv: list) -> dict:
    """One mix client process (``--tcp-mix``): ``perf.main(argv)`` (its
    report is the line it prints), with the seconds from this process's
    start to the workload's start, the workload's run and its exit
    returned beside it. The load processes hold the keyspace already:
    perf's tcp-client gives its ReadWrite workload no client id, so each
    such process would load the whole keyspace again in the workload's
    setup, which is skipped here."""
    from foundationdb_tpu_torch.tools import perf
    from foundationdb_tpu_torch.workloads import readwrite

    t0 = time.perf_counter()
    marks: dict = {}
    start = readwrite.ThroughputWorkload.start

    async def loaded(self):
        return None

    readwrite.ReadWriteWorkload.setup = loaded

    async def timed_start(self):
        marks["to_start_s"] = time.perf_counter() - t0
        await start(self)
        marks["start_s"] = time.perf_counter() - t0 - marks["to_start_s"]

    readwrite.ThroughputWorkload.start = timed_start
    if perf.main(argv) != 0:
        raise AssertionError(f"perf {' '.join(argv)} failed")
    marks["process_s"] = time.perf_counter() - t0
    return marks


def child_lines(proc, what: str) -> list:
    """The JSON lines a child process printed, once it has exited 0."""
    out, _ = proc.communicate(timeout=3600)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n{out[-3000:]}")
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def child_json(proc, what: str) -> dict:
    return child_lines(proc, what)[-1]


def cli_status(coord: str) -> dict:
    """``status json`` through the port's cli, as an operator runs it."""
    from foundationdb_tpu_torch.tools.tcp_soak import fdbcli

    rc, out = fdbcli(coord, "status json", timeout=90)
    if rc != 0:
        raise AssertionError(f"cli status json exited {rc}: {out[-2000:]}")
    return json.loads(out[out.index("{"):])


def roles_by_process(doc: dict, names: dict) -> dict:
    """process name -> the roles status lists for its address."""
    workers = (doc.get("cluster") or {}).get("workers") or {}
    return {names.get(a, a): sorted(w.get("roles") or []) for a, w in sorted(workers.items())}


def storage_snapshots(doc: dict, names: dict) -> dict:
    """Each storage server's index figures in a status document, by uid."""
    out = {}
    for addr, w in sorted(((doc.get("cluster") or {}).get("workers") or {}).items()):
        for uid, snap in sorted((w.get("metrics") or {}).items()):
            if snap.get("kind") == "storage":
                out[uid] = {"process": names.get(addr, addr), "indexDevice": snap.get("indexDevice"),
                            "indexCurrent": snap.get("indexCurrent"), "indexLaunches": snap.get("indexLaunches"),
                            "multiGetIndexKeys": snap.get("multiGetIndexKeys"),
                            "multiGetFallbackKeys": snap.get("multiGetFallbackKeys"),
                            "durableVersion": snap.get("durableVersion")}
    return out


def storage_addresses(doc: dict) -> dict:
    """Each storage server's process address in a status document, by uid."""
    return {uid: addr for addr, w in sorted(((doc.get("cluster") or {}).get("workers") or {}).items())
            for uid, snap in sorted((w.get("metrics") or {}).items()) if snap.get("kind") == "storage"}


def indexes_current(doc: dict, device: str, names: dict) -> bool:
    """Has the index of each of the two storage servers (TCP_CONFIG's)
    caught up with its engine, on ``device``, as ``doc`` shows it? A
    restarted server answers multiGet from its engine until its first
    durability advance rebuilds its index (``server/storage.py``
    ``_multi_get_at``, as the reference does)."""
    storages = storage_snapshots(doc, names)
    return len(storages) == 2 and all(s["indexDevice"] == device and s["indexCurrent"] is True
                                      for s in storages.values())


def check_storage_indexes(base: dict, doc: dict, device: str, names: dict) -> dict:
    """The storage half of phase 16's gate, on two status documents:
    ``base``, read once every index had caught up with its engine
    (``indexes_current``), and ``doc``, read after the reads that the gate
    covers. Both storage servers (TCP_CONFIG's two) of ``doc`` are in
    ``base`` in the same process, their counters not behind it (a restart
    between them resets them, so it fails), each index on ``device`` and
    current, on the card with K5 launched in
    its process, and it answered no multiGet key from its engine in
    between: its ``multiGetFallbackKeys`` grew by 0, and its index answered
    reads in between (``multiGetIndexKeys`` grew), so neither half of the
    gate passes over a server no read reached. A fallback while the index
    is current fails; one during a restarted server's rebuild, before
    ``base``, does not count. Returns the per-server figures with the
    deltas; raises AssertionError otherwise."""
    if not indexes_current(base, device, names):
        raise AssertionError(f"the base status shows an index behind its engine: {storage_snapshots(base, names)}")
    before, after = storage_snapshots(base, names), storage_snapshots(doc, names)
    bad = {}
    for uid, s in after.items():
        b = before.get(uid)
        if b is not None:
            s["fallbackDelta"] = (s["multiGetFallbackKeys"] or 0) - (b["multiGetFallbackKeys"] or 0)
            s["indexKeysDelta"] = (s["multiGetIndexKeys"] or 0) - (b["multiGetIndexKeys"] or 0)
        if (b is None or b["process"] != s["process"] or s["indexDevice"] != device or s["indexCurrent"] is not True
                or s["fallbackDelta"] != 0 or s["indexKeysDelta"] <= 0
                or (device == "cuda" and (s["indexLaunches"] or 0) <= 0)):
            bad[uid] = s
    if len(after) != 2 or bad:
        raise AssertionError(f"storage indexes: {after} (at the base: {before})")
    return after


def wait_indexes_current(coord: str, device: str, names: dict, seconds: float = 60.0) -> dict:
    """``status json`` until every storage server's index is current
    (``indexes_current``); that document. Raises after ``seconds``."""
    deadline = time.perf_counter() + seconds
    while True:
        doc = cli_status(coord)
        if indexes_current(doc, device, names):
            return doc
        if time.perf_counter() > deadline:
            raise AssertionError(f"the storage indexes did not catch up in {seconds} s: "
                                 f"{storage_snapshots(doc, names)}")
        time.sleep(1.0)


def check_cluster_kernels(doc: dict, device: str, names: dict, want_batches: bool, after: int = 0) -> dict:
    """Every resolver of the status document on ``device``, HEALTHY, with 0
    failovers, its backend what ``torch`` builds there (``torch_built``);
    at least two of the newest generation (its recovery count, above
    ``after``), and with ``want_batches`` at least two of them with batches
    dispatched, and on the card each busy one's process with the scan (the
    spread's on a host of several cards) launched. A master attempt that a newer one fenced leaves its resolvers
    recruited, idle. (The storage half is ``check_storage_indexes``.)
    Returns the per-resolver figures and the generation."""
    resolvers = {}
    for uid, snap in sorted((doc.get("resolvers") or {}).items()):
        k = snap.get("kernel") or {}
        h = k.get("health") or {}
        resolvers[uid] = {"process": names.get(snap.get("address"), snap.get("address")),
                          "generation": int(uid.split("-")[1]),
                          "device": k.get("device"), "batches": k.get("batches"),
                          "deviceDispatches": k.get("deviceDispatches"), "txns": k.get("txns"),
                          "state": h.get("state"), "failovers": h.get("failovers"),
                          "deadlineHits": h.get("deadlineHits"), "backend": h.get("backend"),
                          "launches": {n: c for n, c in (k.get("launches") or {}).items() if c}}
    newest = max((r["generation"] for r in resolvers.values()), default=0)
    current = [r for r in resolvers.values() if r["generation"] == newest]
    # a worker with --device cuda builds torch as this host does: the spread
    # over every card where there are several
    built = torch_built("torch", None if device == "cuda" else device)
    bad = [(u, r) for u, r in resolvers.items()
           if r["device"] != device or r["state"] != "HEALTHY" or r["failovers"] != 0
           or r["backend"] != built["name"]]
    busy = [r for r in current if (r["batches"] or 0) > 0]
    # on the card, a busy resolver's process launched the scan (the counts are
    # the process's; off it nothing launches)
    unlaunched = [r for r in busy if device == "cuda" and any(r["launches"].get(k, 0) <= 0 for k in built["path"])]
    if bad or unlaunched or newest <= after or len(current) < 2 or (want_batches and len(busy) < 2):
        raise AssertionError(f"resolvers (generation {newest}, after {after}): {resolvers}")
    return {"resolvers": resolvers, "generation": newest}


def commit_phases(doc: dict, names: dict) -> dict:
    """Where a commit's time goes, as the status document has it: each
    proxy's version, resolve and log-push phases and its commit latency,
    and each resolver's resolveLatency (p50 / p95 ms)."""
    out = {}
    for addr, w in sorted(((doc.get("cluster") or {}).get("workers") or {}).items()):
        for uid, snap in sorted((w.get("metrics") or {}).items()):
            keys = {"proxy": ("phase1Version", "phase2Resolve", "phase4LogPush", "commitLatency", "grvLatency"),
                    "resolver": ("resolveLatency",)}.get(snap.get("kind"), ())
            for k in keys:
                lat = snap.get(k) or {}
                out[f"{uid}@{names.get(addr, addr)} {k}"] = (lat.get("count"), (lat.get("p50") or 0) * 1e3,
                                                             (lat.get("p95") or 0) * 1e3)
    return out


def card_memory(doc: dict, names: dict) -> dict:
    """Each server process's card memory in MiB, as its status pull reports
    it from inside the process (``cardMemory`` of its resolvers' kernel
    sections and its storage servers: the allocator's allocated and
    reserved bytes, without the CUDA context)."""
    out = {}
    for addr, w in sorted(((doc.get("cluster") or {}).get("workers") or {}).items()):
        for snap in (w.get("metrics") or {}).values():
            mem = snap.get("cardMemory") or (snap.get("kernel") or {}).get("cardMemory")
            if mem:
                out[names.get(addr, addr)] = {k: v / 2**20 for k, v in mem.items()}
    return out


async def wait_durable(db, coord: str) -> dict:
    """Until every storage server's durable version reaches a read version
    taken now (so every commit acknowledged before it): that version, and
    the status reads it took."""
    from foundationdb_tpu_torch.client import management
    from foundationdb_tpu_torch.runtime.futures import delay

    v = await db.transaction().get_read_version()
    polls = 0
    while True:
        polls += 1
        doc = await management.get_status([coord], db.client)
        durable = [snap.get("durableVersion") or 0
                   for w in ((doc.get("cluster") or {}).get("workers") or {}).values()
                   for snap in (w.get("metrics") or {}).values() if snap.get("kind") == "storage"]
        if durable and min(durable) >= v:
            return {"version": v, "status_reads": polls}
        await delay(0.5)


# the servers' trace events that tell why a generation ended (C10): what
# the master saw fail, the cluster controller's master pings, each
# recovery's start, the resolvers' deadline misses (the window's split) and
# failovers, and the proxies' failed batches
TCP_TRACE_EVENTS = ("MasterSawRoleFailure", "MasterFailed", "RecruitedMaster", "MasterFullyRecovered",
                    "KernelDeadlineMissed", "KernelFailover", "ProxyMasterGone", "ProxyEpochEnded")


def tcp_trace_summary(cluster) -> dict:
    """Phase 16's servers' trace files (``TcpCluster(trace=True)``, rolled
    files first), read back: the events of TCP_TRACE_EVENTS in time order
    with the process that traced them, each recovery's start
    (``MasterRecoveryState`` at ``reading_cstate_done``), the proxies'
    failed batches counted by error, and every SevError event."""
    import glob

    events, failed, errors = [], {}, []
    for name in cluster.procs:
        path = cluster.trace_path(name)
        rolled = sorted(glob.glob(path + ".*"), key=lambda f: -int(f.rsplit(".", 1)[1]))
        for f in [*rolled, path] if os.path.exists(path) else rolled:
            with open(f, errors="replace") as fh:
                for line in fh:
                    try:
                        e = json.loads(line)
                    except ValueError:
                        continue
                    kind = e.get("Type")
                    if kind == "CommitBatchFailed":
                        err = str(e.get("Err", "")).split("(", 1)[0]
                        failed[err] = failed.get(err, 0) + 1
                        continue
                    if e.get("Severity") == "Error":
                        errors.append({"process": name, **e})
                    if kind in TCP_TRACE_EVENTS or (kind == "MasterRecoveryState"
                                                    and e.get("State") == "reading_cstate_done"):
                        events.append({"process": name, **{k: v for k, v in e.items() if k != "Machine"}})
    events.sort(key=lambda e: (e.get("Time", 0.0), e["process"]))
    return {"events": events, "commit_batches_failed": failed, "errors": errors[:20]}


def run_tcp_cluster(card: str, device: str = "cuda", n_keys: int = TCP_KEYS, mix_s: float = TCP_MIX_S) -> dict:
    """Phase 16 (a): the port's ``TcpCluster`` (``tools/tcp_soak.py``), each
    server a real ``fdbserver --device <device>`` process: one coordinator
    and workers of class storage x3, transaction x2 and stateless x2, with
    ``TCP_CONFIG`` and the storage index on. ``n_keys`` keys ``rw/%08d``
    are loaded by TCP_LOADERS client processes (this script with
    ``--tcp-loader``), then ``perf --mode tcp-client`` processes run the
    90_10 mix for ``mix_s`` seconds; ``status json`` through the port's cli
    must show both resolvers on ``device``, HEALTHY, with no failover and
    batches dispatched, and both storage indexes on ``device`` with no
    fallback since they were current (``check_storage_indexes``). Then the
    process hosting the master is SIGKILLed and restarted, and the wait
    until a probe write commits is timed; once every index is current
    again, a fresh client reads every key back and makes point reads, and
    the storage gate holds over them. Before each gate every storage server
    answers point reads sent to it directly (``read_each_storage``), so
    each index must have answered reads. Any server that dies but the killed
    one fails the phase (its output is printed first). Returns the
    phase's JSON object."""
    import shutil
    import tempfile

    from foundationdb_tpu_torch.client.database import Database
    from foundationdb_tpu_torch.net.sim import Endpoint
    from foundationdb_tpu_torch.net.tcp import RealWorld
    from foundationdb_tpu_torch.runtime.futures import spawn
    from foundationdb_tpu_torch.runtime.loop import set_loop
    from foundationdb_tpu_torch.server import interfaces as I
    from foundationdb_tpu_torch.tools import perf, tcp_soak

    t_phase = time.perf_counter()
    datadir = tempfile.mkdtemp(prefix="fdbtpu-smoke-tcp-")
    clients: list = []

    def check_alive(cluster):
        """Any dead server fails the phase, its output printed first."""
        try:
            cluster.check_alive()
        except AssertionError as e:
            log(str(e))
            raise

    def client_world():
        world = RealWorld("127.0.0.1:0")
        world.activate()
        return world, Database.from_coordinators(world, [cluster.coord])

    def read_each_storage(doc: dict, seed: int) -> dict:
        """TCP_SPOT_GETS point reads sent to every storage server of
        ``doc`` itself (one multiGet RPC each, at one read version), not
        through the client's load balancer, which may send every read to
        one replica: each index answers reads the storage gate counts.
        Raises on a wrong value; returns the keys each server answered."""
        world, db = client_world()
        rnd = random.Random(seed)
        keys = [commit_key(rnd.randrange(n_keys)) for _ in range(TCP_SPOT_GETS)]
        addrs = storage_addresses(doc)

        async def reads():
            version = await db.transaction().get_read_version()
            return {uid: await db.client.request(Endpoint(addr, I.Tokens.MULTI_GET),
                                                 I.MultiGetRequest(keys=keys, version=version))
                    for uid, addr in addrs.items()}

        try:
            replies = world.run_until_done(spawn(reads()), 120.0)
        finally:
            world.close()
            set_loop(None)
        for uid, rep in replies.items():
            if rep.errors or rep.values != [TCP_VALUE] * len(keys):
                raise AssertionError(f"storage server {uid} at {addrs[uid]}: errors {rep.errors[:5]}, "
                                     f"{sum(v != TCP_VALUE for v in rep.values)} wrong values")
        return {uid: len(keys) for uid in replies}

    out: dict = {"keys": n_keys, "device": device, "config": TCP_CONFIG, "knobs": list(TCP_KNOBS)}
    cluster = None
    try:
        cluster = tcp_soak.TcpCluster(datadir, config=TCP_CONFIG, classes=TCP_CLASSES, knobs=TCP_KNOBS,
                                      device=device, trace=True)
        names = {f"127.0.0.1:{n.rsplit('-', 1)[1]}": n for n in cluster.procs if n != "coord"}
        names[cluster.coord] = "coord"
        # formation: the first commit through the port's cli
        w0 = time.perf_counter()
        deadline = w0 + TCP_FORM_S
        while tcp_soak.fdbcli(cluster.coord, "set tcp/formed ok", timeout=60)[0] != 0:
            check_alive(cluster)
            if time.perf_counter() > deadline:
                raise AssertionError(f"the cluster did not form in {TCP_FORM_S} s")
            time.sleep(1.0)
        out["form_s"] = time.perf_counter() - w0
        log(f"real-process cluster formed in {out['form_s']:.1f} s: {len(cluster.procs)} processes [{card}]")

        # the load: TCP_LOADERS client processes, disjoint ranges
        w0 = time.perf_counter()
        bounds = [n_keys * i // TCP_LOADERS for i in range(TCP_LOADERS + 1)]
        clients[:] = [subprocess.Popen(
            [sys.executable, __file__, "--tcp-loader", cluster.coord, str(lo), str(hi), str(TCP_LOAD_ACTORS)],
            env=tcp_soak._env(), cwd=tcp_soak.REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for lo, hi in zip(bounds, bounds[1:])]
        loads = [child_json(p, "a load client") for p in clients]
        check_alive(cluster)
        load_s = time.perf_counter() - w0
        out["load"] = {"wall_s": load_s, "writes_s": n_keys / load_s, "clients": loads}
        log(f"real-process cluster: {n_keys} keys loaded in {load_s:.1f} s ({n_keys / load_s:.1f} writes/s) "
            f"by {TCP_LOADERS} client processes [{card}]")

        # every load write durable on both replicas: a read version taken
        # now covers every acknowledged commit
        world, db = client_world()
        w0 = time.perf_counter()
        try:
            durable = world.run_until_done(spawn(wait_durable(db, cluster.coord)), 1800.0)
        finally:
            world.close()
            set_loop(None)
        out["durable"] = {"wall_s": time.perf_counter() - w0, **durable}
        log(f"real-process cluster: both storage servers durable at the load's last version "
            f"{out['durable']['wall_s']:.1f} s after it [{card}]")
        # the storage gate's base: every index caught up with its engine
        base = wait_indexes_current(cluster.coord, device, names)

        # the mix: perf's tcp-client processes on the loaded keyspace
        w0 = time.perf_counter()
        clients[:] = [subprocess.Popen(
            [sys.executable, __file__, "--tcp-mix", "--workload", "90_10",
             "--mode", "tcp-client", "--coordinators", cluster.coord, "--actors", str(TCP_MIX_ACTORS),
             "--keyspace", str(n_keys), "--duration", str(mix_s), "--client-procs", str(TCP_MIX_PROCS),
             "--seed", str(i), "--client-id", str(i)],
            env=tcp_soak._env(), cwd=tcp_soak.REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(TCP_MIX_PROCS)]
        lines = [child_lines(p, "a perf tcp-client") for p in clients]
        mix = perf.aggregate([ls[-2] for ls in lines])
        check_alive(cluster)
        out["mix"] = {k: mix.get(k) for k in ("txn_per_s", "ops_per_s", "commits", "conflicts", "reads",
                                               "writes", "commit_p50_ms", "commit_p95_ms", "read_p50_ms",
                                               "read_p95_ms", "wall_s", "client_procs")}
        out["mix"]["process_wall_s"] = time.perf_counter() - w0
        out["mix"]["processes"] = [ls[-1] for ls in lines]
        log(f"real-process cluster: mix 90_10 {mix['txn_per_s']:.1f} txn/s, commit p50 {mix['commit_p50_ms']:.3f} "
            f"ms / p95 {mix['commit_p95_ms']:.3f} ms ({TCP_MIX_PROCS} x {TCP_MIX_ACTORS} actors) [{card}]")

        # status through the port's cli: the resolvers and indexes on the
        # card, after point reads that reach every storage server
        out["direct_reads"] = read_each_storage(base, 1)
        doc = cli_status(cluster.coord)
        out["roles"] = roles_by_process(doc, names)
        out["status"] = check_cluster_kernels(doc, device, names, want_batches=True)
        out["status"]["storage"] = check_storage_indexes(base, doc, device, names)
        out["commit_phases_ms"] = commit_phases(doc, names)
        master = names.get((doc.get("cluster") or {}).get("master"))
        if master not in cluster.procs:
            raise AssertionError(f"no process hosts the master: {out['roles']}")
        out["card_memory"] = card_memory(doc, names)

        # SIGKILL the master's process, restart it, time a probe commit
        world, db = client_world()

        async def probe(tr):
            tr.set(b"tcp/probe", b"after-kill")

        w0 = time.perf_counter()
        cluster.kill(master)
        cluster.restart(master)
        try:
            world.run_until_done(spawn(db.run(probe)), TCP_RECOVER_S)
        finally:
            world.close()
            set_loop(None)
        recover_s = time.perf_counter() - w0
        check_alive(cluster)
        # read status until the new generation's resolvers show
        deadline = time.perf_counter() + 60.0
        while True:
            after = cli_status(cluster.coord)
            try:
                checked = check_cluster_kernels(after, device, names, want_batches=False,
                                                after=out["status"]["generation"])
                break
            except AssertionError:
                if time.perf_counter() > deadline:
                    raise
                time.sleep(2.0)
        # the restarted process's storage server answers multiGet from its
        # engine until its first durability advance rebuilds its index: the
        # gate counts the reads after every index caught up
        w1 = time.perf_counter()
        base = wait_indexes_current(cluster.coord, device, names)
        out["recovery"] = {"killed": master, "roles_killed": out["roles"].get(master), "wall_s": recover_s,
                           "recovery_count": (after.get("cluster") or {}).get("recovery_count"),
                           "status": checked, "roles": roles_by_process(after, names),
                           "indexes_current_s": time.perf_counter() - w1,
                           "fallback_before_current": {u: s["multiGetFallbackKeys"] for u, s in
                                                       storage_snapshots(base, names).items()}}
        log(f"real-process cluster: killed {master} ({out['recovery']['roles_killed']}), restarted it; a probe "
            f"write committed {recover_s:.3f} s after the kill; every index current "
            f"{out['recovery']['indexes_current_s']:.1f} s after that [{card}]")

        # every acknowledged key, from a fresh client
        world, db = client_world()
        w0 = time.perf_counter()

        async def read_back():
            seen, bad, begin = 0, [], commit_key(0)
            while True:
                async def chunk(tr, begin=begin):
                    return await tr.get_range(begin, b"rw0", limit=TCP_READ_CHUNK)

                rows = await db.run(chunk)
                for k, v in rows:
                    if k != commit_key(seen) or v != TCP_VALUE:
                        bad.append((k, v))
                    seen += 1
                if len(rows) < TCP_READ_CHUNK:
                    break
                begin = rows[-1][0] + b"\x00"

            async def extras(tr):
                return [await tr.get(k) for k in (b"tcp/formed", b"tcp/probe")]

            # point reads through multiGet, for the storage gate below
            rnd = random.Random(16)
            for _ in range(TCP_SPOT_TXNS):
                keys = [rnd.randrange(n_keys) for _ in range(TCP_SPOT_GETS)]

                async def spot(tr, keys=keys):
                    return [await tr.get(commit_key(k)) for k in keys]

                bad += [(commit_key(k), v) for k, v in zip(keys, await db.run(spot)) if v != TCP_VALUE]
            return seen, bad[:10], await db.run(extras)

        try:
            seen, bad, extras = world.run_until_done(spawn(read_back()), 1800.0)
        finally:
            world.close()
            set_loop(None)
        check_alive(cluster)
        out["read_back"] = {"keys": seen, "point_reads": TCP_SPOT_TXNS * TCP_SPOT_GETS,
                            "wall_s": time.perf_counter() - w0, "extras": extras}
        if seen != n_keys or bad or extras != [b"ok", b"after-kill"]:
            raise AssertionError(f"read back {seen} of {n_keys} keys, wrong {bad}, extras {extras}")
        out["read_back"]["direct_reads"] = read_each_storage(base, 2)
        out["recovery"]["storage"] = check_storage_indexes(base, cli_status(cluster.coord), device, names)
        log(f"real-process cluster: read back all {seen} acknowledged keys in {out['read_back']['wall_s']:.1f} s "
            f"from a fresh client [{card}]")
    finally:
        for p in clients:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        if cluster is not None:
            cluster.stop()
            # why each generation ended, printed on a failed run too
            out["trace"] = tcp_trace_summary(cluster)
            log(json.dumps({"tcp_trace": out["trace"]}, default=str))
        shutil.rmtree(datadir, ignore_errors=True)
    out["processes"] = len(cluster.procs)
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = card
    log(json.dumps({"tcp_cluster": out}, default=str))
    log(card)
    return out


# the guards' trace events phase 16 (b) counts in each leg
GUARD_EVENTS = ("KernelFault", "KernelDeadlineMissed", "KernelFailover", "KernelPromoted")


def run_tcp_inproc(card: str, device: str = "cuda", n_keys: int = INPROC_KEYS,
                   mix_s: float = INPROC_MIX_S, check=True) -> tuple[dict, list[dict]]:
    """Phase 16 (b): ``perf --mode tcp-inproc`` through ``perf.main``: the
    same layout as RealWorlds on one RealLoop in this process, ``n_keys``
    keys and the 90_10 mix for ``mix_s`` seconds, over loopback and then
    over sockets (``--no-loopback``). Launch counts are set to 0 before the
    two runs and read after; the scan (the spread's on a host of several
    cards) and K5 must have launched, and every resolver's guard must be
    HEALTHY on ``device`` with no failover (each guard's record, printed
    before the gate: health, failovers, device, faults, deadline hits, last
    error; and each leg's count of the guards' ``GUARD_EVENTS``, a fault by
    its error's class, an exchange's timeout among them). With ``check``, the widest resolver batch (on its resolver's
    state after the runs: ``check_built_resolve`` on what the resolver
    built) and the widest storage search are held to their plain versions
    and timed. Returns the JSON object and the kernel rows."""
    import contextlib
    import io

    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet
    from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
    from foundationdb_tpu_torch.device import lanes_to_torch
    from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex
    from foundationdb_tpu_torch.runtime import trace as T
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.server.worker import Worker
    from foundationdb_tpu_torch.tools import perf

    t_phase = time.perf_counter()
    capture: dict = {"best": None, "q": None}
    resolvers: list = []
    counted: dict = {}  # the guards' trace events of a leg, a fault by its error's class

    # torch is the spread on a host of several cards
    encodes = {cls: cls.encode for cls in (TorchConflictSet, TorchMeshConflictSet)}
    search_codes, make_resolver = TorchRangeIndex._search_codes, Worker._make_resolver

    def captured_encode(self, transactions):
        enc = encodes[type(self)](self, transactions)
        size = (len(transactions), enc[0].rb.shape[1] * enc[0].wb.shape[1])
        if capture["best"] is None or size > capture["best"][0]:
            capture["best"] = (size, self, enc)
        return enc

    def captured_search(self, codes):
        if capture["q"] is None or codes.shape[0] > capture["q"][0]:
            capture["q"] = (codes.shape[0], self, codes)
        return search_codes(self, codes)

    def recorded_resolver(self, h, **kw):
        make_resolver(self, h, **kw)
        resolvers.append(h.obj)

    legs = {}
    TorchConflictSet.encode = TorchMeshConflictSet.encode = captured_encode
    TorchRangeIndex._search_codes = captured_search
    Worker._make_resolver = recorded_resolver
    saved_log = T.trace_log()
    T.set_trace_log(counting_log(counted, GUARD_EVENTS, by_error=True))
    Knobs.STORAGE_TPU_INDEX = True  # perf builds its own knobs; on a RealLoop the index is off unless asked for
    gc.collect()
    gc.freeze()  # this process's earlier objects out of the collector's scans (ROADMAP C3)
    try:
        if device == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for leg, extra in (("loopback", []), ("sockets", ["--no-loopback"])):
            argv = ["--mode", "tcp-inproc", "--workload", "90_10", "--keyspace", str(n_keys), "--actors",
                    str(INPROC_ACTORS), "--duration", str(mix_s), "--tcp-config", TCP_CONFIG,
                    "--tcp-classes", ",".join(TCP_CLASSES), "--device", device, *extra]
            w0 = time.perf_counter()
            counted.clear()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                if perf.main(argv) != 0:
                    raise AssertionError(f"perf {' '.join(argv)} failed")
            rep = json.loads(text.getvalue().strip().splitlines()[-1])
            moved = {k: sum(s.get(k, 0) for s in rep["transport"].values())
                     for k in ("loopbackMessages", "tcpMessages", "messagesSent", "framesSent")}
            legs[leg] = {k: rep.get(k) for k in ("txn_per_s", "ops_per_s", "commits", "conflicts",
                                                   "commit_p50_ms", "commit_p95_ms", "read_p50_ms", "wall_s")}
            legs[leg].update(process_wall_s=time.perf_counter() - w0, transport=moved,
                             transport_knobs=rep["transport_knobs"], guard_events=dict(counted))
            if (moved["loopbackMessages"] <= 0 if leg == "loopback"
                    else moved["loopbackMessages"] != 0 or moved["tcpMessages"] <= 0):
                raise AssertionError(f"{leg}: transport {moved}")
            # every resolver the leg recruited; a destroyed generation's
            # guard stays readable, its backend is gone
            legs[leg]["resolvers"] = list(resolvers)
            resolvers.clear()
            log(f"tcp-inproc over {leg}: {n_keys} keys, mix 90_10 {rep['txn_per_s']:.1f} txn/s, commit p50 "
                f"{rep['commit_p50_ms']:.3f} ms / p95 {rep['commit_p95_ms']:.3f} ms, run {legs[leg]['process_wall_s']:.1f} s, "
                f"the guards' events {json.dumps(counted)} [{card}]")
        if device == "cuda":
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        for cls, fn in encodes.items():
            cls.encode = fn
        TorchRangeIndex._search_codes = search_codes
        Worker._make_resolver = make_resolver
        T.set_trace_log(saved_log)
        Knobs.STORAGE_TPU_INDEX = None
        gc.unfreeze()
    bad, recruited = {}, []
    for name, leg in legs.items():
        mine = leg.pop("resolvers")
        recruited += mine
        # (health, failovers, device or None once destroyed, faults,
        # deadline hits, last error) of each guard
        snaps = [r.cs.health_snapshot() for r in mine]
        leg["guards"] = [(r.cs.health, h["failovers"],
                          None if getattr(r.cs, "_closed", False)
                          else getattr(getattr(r.cs.primary, "_device", None), "type", None),
                          h["faults"], h["deadlineHits"], h["lastError"]) for r, h in zip(mine, snaps)]
        live = [g for g in leg["guards"] if g[2] is not None]
        if len(live) < 2 or any(g[0] != "HEALTHY" or g[1] != 0 for g in leg["guards"]) \
                or any(g[2] != device for g in live):
            bad[name] = leg["guards"]
    out = {"keys": n_keys, "device": device, "legs": legs, "launches": {k: v for k, v in launches.items() if v}}
    if bad:  # the figures first, pass or fail
        log(json.dumps({"tcp_inproc": dict(out, phase_s=time.perf_counter() - t_phase, card=card)}, default=str))
    rows: list = []
    try:
        if bad:
            raise AssertionError(f"tcp-inproc resolver guards: {bad}")
        if check:
            built = torch_built("torch", None if device == "cuda" else device)
            missing = [k for k in built["path"] + ("search",) if launches.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"kernels never launched in tcp-inproc: {missing} ({launches})")
            (_size, cs, (hbatch, n_real, _epoch)) = capture["best"]
            base = cs._origin[1]
            old = max(cs.oldest_version - base, 0)
            vers = (old + Knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS, old, old)
            T_, KR, KW = hbatch.rb.shape[0], hbatch.rb.shape[1], hbatch.wb.shape[1]
            log(f"kernel checks on tcp-inproc's widest batch ({n_real} transactions, T={T_} KR={KR} KW={KW}) "
                f"and its resolver's state after the runs [{card}]:")
            rows = check_built_resolve(resolver_state(cs), hbatch, vers, launches, " (tcp_inproc)")
            for r in rows:
                r["name"] = f"{r['name']} (tcp_inproc, widest batch T={T_} KR={KR} KW={KW})"
            q_rows, idx, codes = capture["q"]
            log(f"K5 at tcp-inproc's widest storage search (Q={q_rows} over {idx.n} keys) [{card}]:")
            k5 = check_search(idx._codes, lanes_to_torch(codes, "cuda"), launches)[0]
            k5["name"] = f"search (tcp_inproc, widest storage search, Q={q_rows})"
            rows.append(k5)
            out["kernel_rows"] = [{k: r[k] for k in ("name", "launches", "ms", "device_ms", "plain_ms",
                                                     "bound_ms", "bound_by", "max_abs_err")} for r in rows]
    finally:
        # the legs' worlds are closed: stop their resolvers' threads and
        # free their grids (a thread left running at exit aborts the process)
        for r in recruited:
            if not getattr(r.cs, "_closed", False):
                r.close()
        del recruited, capture
        collect_all()
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = card
    log(json.dumps({"tcp_inproc": out}, default=str))
    log(card)
    return out, rows


def binding_run(seed: int, n_ops: int, chaos: bool, device, **cfg) -> tuple:
    """One bindingtester stream of ``tests/test_bindingtester.py`` through
    the port's static ``Cluster`` on ``device`` (None: the card): the
    stream, the final data rows and the logged stack rows."""
    from foundationdb_tpu_torch.bindings import StackMachine
    from foundationdb_tpu_torch.bindings.generator import StreamGenerator, store_instructions
    from foundationdb_tpu_torch.client import Database
    from foundationdb_tpu_torch.net.sim import Sim
    from foundationdb_tpu_torch.runtime.buggify import Buggify, set_buggify
    from foundationdb_tpu_torch.runtime.futures import spawn
    from foundationdb_tpu_torch.server import Cluster, ClusterConfig

    ins, data, result = BINDING_PREFIXES
    sim = Sim(seed=seed, chaos=chaos)
    sim.activate()
    cluster = Cluster(sim, ClusterConfig(**cfg), device=device)
    db = Database(sim, cluster.proxy_addrs)
    stream = StreamGenerator(seed, data_prefix=data).generate(n_ops, result_prefix=result, machine_prefix=ins)

    async def go():
        await store_instructions(db, ins, stream)
        await StackMachine(db, ins).run_from_db()

        async def read_all(tr):
            return (await tr.get_range(data, data + b"\xff"), await tr.get_range(result, result + b"\xff"))

        return await db.run(read_all)

    try:
        rows, log_rows = sim.run_until_done(spawn(go()), 3600.0)
    finally:
        set_buggify(Buggify(None))  # a chaos Sim arms the process's buggify: disarm it for what follows
    return stream, list(rows), list(log_rows)


def binding_model(stream) -> tuple:
    """The same stream through the port's ``ModelDatabase``."""
    from foundationdb_tpu_torch.bindings import ModelDatabase, StackMachine
    from foundationdb_tpu_torch.bindings.generator import store_instructions
    from foundationdb_tpu_torch.net.sim import Sim
    from foundationdb_tpu_torch.runtime.futures import spawn

    ins, data, result = BINDING_PREFIXES
    sim = Sim(seed=0)
    sim.activate()
    db = ModelDatabase()

    async def go():
        await store_instructions(db, ins, stream)
        await StackMachine(db, ins).run_stream(stream)
        return (sorted((k, v) for k, v in db.data.items() if k.startswith(data)),
                sorted((k, v) for k, v in db.data.items() if k.startswith(result)))

    return sim.run_until_done(spawn(go()), 3600.0)


def run_bindings(card: str, device=None, seeds=BINDING_SEEDS, chaos=BINDING_CHAOS) -> dict:
    """Phase 16 (c): the bindingtester streams of
    ``tests/test_bindingtester.py`` (seeds 0-49, the long stream on 2
    proxies and 2 resolvers, the four chaos seeds) through the port's
    ``Cluster`` on the card, each byte-identical, data and stack log, to
    the port's ``ModelDatabase`` run of the same stream. K1-K3 must launch
    (counts set to 0 before the streams, read after)."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.runtime.loop import set_loop

    t_phase = time.perf_counter()
    plan = [(s, BINDING_OPS, False, {}) for s in seeds] + [(99, BINDING_OPS, False, {"n_proxies": 2, "n_resolvers": 2})]
    plan += [(s, BINDING_CHAOS_OPS, True, {}) for s in chaos]
    if device is None:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    failed, instructions, rows = [], 0, 0
    for seed, n_ops, is_chaos, cfg in plan:
        stream, data, log_rows = binding_run(seed, n_ops, is_chaos, device, **cfg)
        instructions += len(stream)
        rows += len(log_rows)
        if (data, log_rows) != tuple(map(list, binding_model(stream))):
            failed.append((seed, is_chaos, cfg))
    set_loop(None)
    if device is None:
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    collect_all()
    out = {"streams": len(plan), "identical": len(plan) - len(failed), "failed": failed,
           "instructions": instructions, "logged_rows": rows, "wall_s": time.perf_counter() - t_phase,
           "launches": {k: v for k, v in launches.items() if v}, "card": card}
    log(json.dumps({"bindings": out}, default=str))
    log(card)
    if failed:
        raise AssertionError(f"bindingtester streams differ from the model: {failed}")
    missing = [k for k in torch_built()["path"] if launches.get(k, 0) <= 0] if device is None else []
    if missing:
        raise AssertionError(f"kernels never launched by the bindingtester streams: {missing}")
    return out


def run_real_process(card: str, parts: str = "abc") -> list[dict]:
    """Phase 16, the real-process cluster: (a) ``run_tcp_cluster``, (b)
    ``run_tcp_inproc``, (c) ``run_bindings``, those of ``parts``. Returns
    (b)'s kernel rows."""
    t0 = time.perf_counter()
    rows: list = []
    if "a" in parts:
        run_tcp_cluster(card)
    if "b" in parts:
        _inproc, rows = run_tcp_inproc(card)
    if "c" in parts:
        run_bindings(card)
    log(f"real-process phase ({parts}): {time.perf_counter() - t0:.1f} s [{card}]")
    return rows


BTREE_KEYS = 50_000  # cell 3's draw (bench.py:61-120), cut: the engine writes ~64 KiB a set (PERF.md §4)
BTREE_COMMIT = 10_000  # sets a commit, phase 12's tlog commit
BTREE_SPOT = 4096  # read_value spot checks after the reopen
BTREE_ROUNDS = 10  # rounds of INDEX_BATCH lookups and INDEX_BATCH intervals on the card
BTREE_RANGE_CHECKS = 64  # intervals of each round whose count is read from the B-tree too


def run_lint(card: str) -> dict:
    """Phase 17 (a): the port's ``cli lint --json`` over this checkout,
    through the function ``python -m foundationdb_tpu_torch.tools.cli``
    runs (its output captured); it must be clean. One ``{"lint": ...}``
    line."""
    import contextlib
    import io

    from foundationdb_tpu_torch.tools import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["lint", "--json"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli lint exited {rc}:\n{out.getvalue()[-4000:]}")
    doc = json.loads(out.getvalue())
    if not doc["clean"] or doc["failing"] or doc["parse_errors"] or doc["stale_baseline"]:
        raise AssertionError(f"cli lint is not clean: {doc['failing'][:5]} {doc['parse_errors'][:5]} "
                             f"{doc['stale_baseline'][:5]}")
    out = {"clean": True, "files": doc["files"], "seconds": doc["seconds"], "wall_s": wall,
           "disabled": len(doc["disabled"]), "baselined": len(doc["baselined"]),
           "per_rule": doc["per_rule"], "card": card}
    log(json.dumps({"lint": out}))
    return out


def run_btree(card: str) -> tuple[dict, list[dict]]:
    """Phase 17 (b): the port's ``KeyValueStoreBTree`` at cell 3's shape,
    cut to BTREE_KEYS keys, committed every BTREE_COMMIT sets into a file
    under the checkout's git-ignored ``build/``, closed and reopened; a
    full scan and BTREE_SPOT point reads against the host model. Then K5's
    index is built on the card from the reopened engine's rows, as a
    rebooted storage server rebuilds it from its recovered engine, and
    BTREE_ROUNDS rounds of lookups (70 % present) and intervals (phase 12's
    ranges) are held to ``bisect`` and to the engine. Returns the phase's
    JSON object and K5's row."""
    import bisect
    import os
    import pathlib

    from foundationdb_tpu_torch.conflict import keys as K
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.device import lanes_to_torch
    from foundationdb_tpu_torch.kv.native_engine import KeyValueStoreBTree, lib_path
    from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex

    def commit(bt):
        coro = bt.commit()  # the native commit never suspends
        try:
            coro.send(None)
        except StopIteration:
            return
        raise AssertionError("the B-tree's commit suspended")

    t_phase = time.perf_counter()
    rnd = random.Random(0)
    draw = [b"%012d" % rnd.randrange(10**12) for _ in range(BTREE_KEYS)]
    model = {k: storage_value(i) for i, k in enumerate(draw)}
    path = pathlib.Path(__file__).resolve().parent / "build" / "btree" / "phase17.btree"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    bt = KeyValueStoreBTree(str(path))
    open_s = time.perf_counter() - t0  # the g++ build of the engine at first use included
    try:
        set_s = commit_s = 0.0
        for lo in range(0, BTREE_KEYS, BTREE_COMMIT):
            t0 = time.perf_counter()
            for i in range(lo, min(lo + BTREE_COMMIT, BTREE_KEYS)):
                bt.set(draw[i], storage_value(i))
            t1 = time.perf_counter()
            commit(bt)
            set_s, commit_s = set_s + t1 - t0, commit_s + time.perf_counter() - t1
        stats = bt.stats()
        bt.close()
        file_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        bt = KeyValueStoreBTree(str(path))
        reopen_s = time.perf_counter() - t0
        if bt.stats() != stats:
            raise AssertionError(f"reopened stats {bt.stats()} != committed {stats}")
        t0 = time.perf_counter()
        rows = bt.read_range(b"", b"\xff")
        scan_s = time.perf_counter() - t0
        want = sorted(model.items())
        if len(rows) != len(want) or rows != want:
            raise AssertionError(f"reopened scan: {len(rows)} rows, the host model {len(want)}, "
                                 f"{sum(a != b for a, b in zip(rows, want))} differ")
        spot = [rnd.choice(draw) if rnd.random() < 0.7 else b"%012d" % rnd.randrange(10**12)
                for _ in range(BTREE_SPOT)]
        t0 = time.perf_counter()
        got = [bt.read_value(k) for k in spot]
        spot_s = time.perf_counter() - t0
        bad = [k for k, v in zip(spot, got) if v != model.get(k)]
        if bad:
            raise AssertionError(f"{len(bad)} of {BTREE_SPOT} read_value differ from the host model")
        log(f"B-tree: {BTREE_KEYS} sets ({len(want)} keys) in {BTREE_KEYS // BTREE_COMMIT} commits, "
            f"sets {set_s:.2f} s, commits {commit_s:.2f} s, file {file_bytes} B for {stats['live_bytes']} "
            f"live bytes; reopened in {reopen_s * 1e3:.2f} ms, scanned in {scan_s:.2f} s, "
            f"{BTREE_SPOT} point reads in {spot_s * 1e3:.1f} ms [{card}]")

        # K5's index on the card, rebuilt from the reopened engine's rows
        keys = [k for k, _v in rows]
        t0 = time.perf_counter()
        idx = TorchRangeIndex(keys)
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
        span = 2 * 10**12 // len(keys) * 10  # phase 12's ranges: 10 keys on average
        work = []
        for _ in range(BTREE_ROUNDS):
            q = [rnd.choice(keys) if rnd.random() < 0.7 else b"%012d" % rnd.randrange(10**12)
                 for _ in range(INDEX_BATCH)]
            begins = [b"%012d" % rnd.randrange(10**12) for _ in range(INDEX_BATCH)]
            ends = [b"%012d" % min(int(b) + rnd.randrange(span), 10**12 - 1) for b in begins]
            work.append((q, begins, ends))
        idx.batch_lookup(work[0][0])  # warm
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        answers = [(idx.batch_lookup(q), idx.batch_range(b, e)) for q, b, e in work]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        if launches["search"] != 2 * BTREE_ROUNDS:
            raise AssertionError(f"search launches {launches['search']} != {2 * BTREE_ROUNDS}")
        found_points = range_rows = 0
        for (q, begins, ends), ((pos, found), (los, his)) in zip(work, answers):
            want_pos = [bisect.bisect_left(keys, k) for k in q]
            want_found = [i < len(keys) and keys[i] == k for k, i in zip(q, want_pos)]
            if list(found) != want_found or list(pos) != [i if f else -1 for i, f in zip(want_pos, want_found)]:
                raise AssertionError("the B-tree index's lookups differ from bisect")
            for k, i, f in zip(q, pos, found):
                if f and bt.read_value(k) != rows[i][1]:
                    raise AssertionError(f"index row {i} of {k!r} does not hold the B-tree's value")
            found_points += int(sum(found))
            if list(los) != [bisect.bisect_left(keys, b) for b in begins] or \
                    list(his) != [bisect.bisect_left(keys, e) for e in ends]:
                raise AssertionError("the B-tree index's intervals differ from bisect")
            for b, e, lo, hi in list(zip(begins, ends, los, his))[:BTREE_RANGE_CHECKS]:
                n = len(bt.read_range(b, e))
                if n != hi - lo:
                    raise AssertionError(f"[{b!r}, {e!r}): {hi - lo} index rows, {n} B-tree rows")
                range_rows += n
        n_q = BTREE_ROUNDS * INDEX_BATCH
        log(f"B-tree index on the card: {len(keys)} rows built in {index_s:.2f} s; {n_q} lookups and "
            f"{n_q} intervals in {wall:.3f} s, equal to bisect; {found_points} found points with the "
            f"B-tree's value; {BTREE_ROUNDS * BTREE_RANGE_CHECKS} intervals' counts ({range_rows} rows) "
            f"equal to the B-tree's range reads [{card}]")
        log("launches on the B-tree index path: " + json.dumps(launches))
        log(f"B-tree index kernel check [{card}]:")
        q = lanes_to_torch(K.encode_keys(work[1][0], width=idx.width), "cuda")
        k5 = check_search(idx._codes, q, launches)
        k5[0]["name"] = f"search (B-tree index, Q={q.shape[0]})"
    finally:
        bt.close()
        path.unlink(missing_ok=True)
    out = {"keys": BTREE_KEYS, "distinct_keys": len(want), "commits": BTREE_KEYS // BTREE_COMMIT,
           "writes_per_s": BTREE_KEYS / (set_s + commit_s), "set_s": set_s, "commit_s": commit_s,
           "open_s": open_s, "reopen_s": reopen_s, "scan_s": scan_s, "scan_rows_per_s": len(rows) / scan_s,
           "spot_reads": BTREE_SPOT, "spot_s": spot_s, "pages": stats["pages"],
           "live_bytes": stats["live_bytes"], "file_bytes": file_bytes, "file_bytes_per_set": file_bytes / BTREE_KEYS,
           "epoch": stats["epoch"], "library": lib_path().name, "index_rows": len(keys), "index_build_s": index_s,
           "lookups_per_s": 2 * n_q / wall, "found_points": found_points, "range_checks": BTREE_ROUNDS * BTREE_RANGE_CHECKS,
           "range_check_rows": range_rows, "launches": {k: v for k, v in launches.items() if v},
           "wall_s": time.perf_counter() - t_phase, "card": card}
    log(json.dumps({"btree": out}))
    return out, k5


def run_phase17(card: str) -> list[dict]:
    """Phase 17: (a) ``run_lint``, (b) ``run_btree``. Returns K5's row."""
    t0 = time.perf_counter()
    run_lint(card)
    _btree, rows = run_btree(card)
    log(f"lint and B-tree phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return rows


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


# the phases after 1 (the card) and 2 (the build) in a whole run's order (6
# is the results), and what each needs run before it
PHASE_ORDER = (3, 4, 5, 7, 18, 19, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17)
PHASE_NEEDS = {4: (3,), 5: (4,), 10: (3, 7), 12: (8,), 18: (7,), 19: (7,)}
TCP_PARTS = "abc"


def phase_plan(spec: str | None) -> tuple[set, str]:
    """The phases a run takes after 1 and 2, for ``--phases`` ``spec`` (a
    comma list of phase numbers; 16a, 16b and 16c name phase 16's parts):
    each named phase with what it needs (``PHASE_NEEDS``), and the parts of
    phase 16. None: every phase, every part."""
    if spec is None:
        return set(PHASE_ORDER), TCP_PARTS
    todo, parts = [], ""
    for tok in filter(None, (t.strip() for t in spec.split(","))):
        m = re.fullmatch(r"(\d+)([abc]*)", tok)
        if not m or int(m[1]) not in PHASE_ORDER or (m[2] and m[1] != "16"):
            raise ValueError(f"--phases: no phase {tok!r} (phases {', '.join(map(str, PHASE_ORDER))}; "
                             f"16a, 16b, 16c)")
        todo.append(int(m[1]))
        if m[1] == "16":
            parts += m[2] or TCP_PARTS
    if not todo:
        raise ValueError("--phases: no phase named")
    run = set()
    while todo:
        p = todo.pop()
        if p not in run:
            run.add(p)
            todo += PHASE_NEEDS.get(p, ())
    return run, "".join(x for x in TCP_PARTS if x in parts)


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
    ap.add_argument("--scan-only", action="store_true",
                    help="phases 1, 2 and phase 5's group scan cases alone, then groups of one at the "
                         "commit path's, the dynamic cluster's and the soak's widest shapes, each with "
                         "its per-phase timer line")
    ap.add_argument("--exchange-only", action="store_true",
                    help="phases 1, 2 and the spread's launch alone on two groups of phase 7's workload, "
                         "each layout's last group timed card by card (an A/B of the cross-card exchange)")
    ap.add_argument("--phases", metavar="LIST",
                    help="phases 1 and 2, then only the phases named (a comma list such as "
                         "11,13,16b,19; 16a, 16b and 16c are phase 16's parts) with what they need "
                         "(phase 3's workload and oracle, phase 7 for 10, 18 and 19, 4 for 5, 8 for 12), "
                         "in a whole run's order; their kernel rows and no result line")
    ap.add_argument("--tcp-only", action="store_true", help="--phases 16: the real-process cluster")
    ap.add_argument("--spread-only", action="store_true",
                    help="--phases 18: the partitioned resolver on one stack and spread")
    ap.add_argument("--data-only", action="store_true",
                    help="--phases 19: the partitioned resolver on one stack and over part x data, and "
                         "the multi-card dry runs")
    ap.add_argument("--btree-only", action="store_true",
                    help="--phases 17: the port's lint and its B-tree engine with K5's index rebuilt "
                         "from it")
    ap.add_argument("--tcp-loader", nargs=4, metavar=("COORDINATOR", "LO", "HI", "ACTORS"),
                    help="(phase 16's load client processes) load keys [LO, HI) and print one JSON line")
    ap.add_argument("--tcp-mix", nargs=argparse.REMAINDER,
                    help="(phase 16's mix client processes) run perf with the arguments that follow, "
                         "then print its timing as one JSON line")
    if sys.argv[1:2] == ["--tcp-mix"]:  # phase 16's mix client processes: perf's own arguments follow
        log(json.dumps(tcp_mix(sys.argv[2:])))
        return 0
    args = ap.parse_args()
    try:
        phase_plan(args.phases)
    except ValueError as e:
        ap.error(str(e))
    if args.tcp_loader:
        coord, lo, hi, actors = args.tcp_loader
        log(json.dumps(tcp_loader(coord, int(lo), int(hi), int(actors))))
        return 0
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
    t_script = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    # versions start so that group 2 crosses now - base >= 2^30: the int32
    # origin is rebased mid-run (K4b) as in a cluster up for ~20 minutes
    offset = (1 << 30) - 1 - (2 * GROUP + WINDOW)
    aliases = {"16": args.tcp_only, "17": args.btree_only, "18": args.spread_only, "19": args.data_only}
    spec = args.phases or next((k for k, on in aliases.items() if on), None)
    run, tcp_parts = phase_plan(spec)
    alone = args.scan_only or args.exchange_only
    # phase 3's references, in two spawned child processes from here on, so
    # that they run beside the build (where phase 4 runs)
    references = start_references(offset) if 4 in run and not alone else None

    # 2. build every kernel from the checkout's sources
    kernels.build.load()
    log(f"kernels built in {kernels.build.build_seconds:.1f} s")
    for src, text in sorted(kernels.build.build_log.items()):
        for line in text.splitlines():
            if "Used" in line:
                log(f"  ptxas {src}: {line.split('info    :')[-1].strip()}")
    if args.exchange_only:
        exchange_only(card)
        log(f"script: {time.perf_counter() - t_script:.1f} s [{card}]")
        return 0
    if args.scan_only:
        scan_only(card)
        log(f"script: {time.perf_counter() - t_script:.1f} s [{card}]")
        return 0
    if spec is not None:
        log(f"phases 1, 2 and {', '.join(str(p) for p in PHASE_ORDER if p in run)} (16: {tcp_parts}) [{card}]")

    rows, index_rows, mesh_rows, spread_rows, data_rows, storage_rows = [], [], [], [], [], []
    commit_rows, dynamic_rows, soak_rows, tcp_rows, btree_rows = [], [], [], [], []
    batches = spread_batches = want = want_oracle = phase7 = cs = warm = state_g1 = hbatch = None
    # 3. workload, warm-up group; the CPU plain path and the oracle from
    # their child processes, both done before the timed path starts
    if 3 in run:
        t0 = time.perf_counter()
        batches = make_batches(N_BATCHES, N_TXNS, offset)
        log(f"workload {N_BATCHES}x{N_TXNS} made in {time.perf_counter() - t0:.1f} s")
    if 4 in run:
        warm = TorchConflictSet(key_width=KEY_WIDTH, capacity=CAPACITY)
        warm.warm_compile()
        drive(warm, batches[:GROUP], offset)
        state_g1 = warm._state  # the state after the first group
        nxt = GROUP
        hbatch, _n, _epoch = warm.encode(batches[nxt])
        vers = (offset + nxt + WINDOW - warm._base,
                max(warm.oldest_version - warm._base, 0),
                max(max(warm.oldest_version, offset + nxt) - warm._base, 0))
        want, want_oracle = finish_references(references)
        log(f"the CPU plain path and the oracle (child processes) ready {time.perf_counter() - t_script:.1f} s "
            f"after the script started")
    elif 7 in run:  # the oracle alone, in this process
        want_oracle = oracle_verdicts(batches or make_batches(N_BATCHES, N_TXNS, offset), offset)

    # 4. the main path on the card; counts set to 0 just before it
    if 4 in run:
        cs = new_conflict_set("torch1", key_width=KEY_WIDTH, capacity=CAPACITY)
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
        path = RESOLVE_PATH + ("maint_reshard", "maint_rebase")
        missing = [k for k in path if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: {missing}")
        one_launch_a_group(launches, snap, N_BATCHES // GROUP, "the main path")
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
    if 5 in run:
        log(f"kernel checks on the state after the first group [{card}]:")
        rows = check_kernels(state_g1, hbatch, vers, launches)
        log(f"the group scan against the loop of standalone kernels and the plain loop [{card}]:")
        scan_rows = check_scans(state_g1, batches, offset, warm, launches, card)
        rows += scan_rows[:1]

    # 7. the partitioned resolver
    if 7 in run:
        mesh_rows, spread_batches, phase7 = run_mesh(want_oracle, offset, card)
        if 5 in run:
            scan_rows[1]["launches"] = phase7["launches"]["resolve_many"]
            mesh_rows += scan_rows[1:]
    # 18. the partitioned resolver spread over the cards of the host, while
    # phase 7's workload, final state and the oracle's verdicts are alive
    if 18 in run:
        spread_rows = run_spread(spread_batches, want_oracle, offset, phase7, card)
    # 19. the mesh's data axis: the multi-card dry runs, phase 7's workload
    # through part x data, and a group of wide reads split over data
    if 19 in run:
        data_rows = run_data(spread_batches, want_oracle, offset, phase7, card)
    phase7 = None
    # 8. the range index
    if 8 in run:
        index_rows, index_lookups_s = run_range_index(card)
    # 9. the shapes past the bench's: many ranges a transaction, wide keys
    if 9 in run:
        run_limits(card)
    # 10. the resolver role over both device paths, then the port's native
    if 10 in run:
        t_phase = time.perf_counter()
        reqs = resolver_requests(batches, offset)
        # the smoke keeps millions of its own objects alive (the workloads, the
        # oracle's verdicts, the requests): move them out of the collector's
        # scans, or a full collection stalls every thread of a run for a second
        # and more, inside the resolver's dispatch deadline
        gc.collect()
        gc.freeze()
        device_kw = {"key_width": KEY_WIDTH, "capacity": CAPACITY}
        # the one grid pinned (torch1), then what torch builds on this host
        # (the spread over every card where there are more than one)
        for backend, threads in (("torch1", 1), ("torch", 0)):
            run_resolver(backend, reqs, want_oracle, card, threads, **device_kw)
        run_resolver("native", reqs, want_oracle, card)
        reqs = resolver_requests(spread_batches, offset)
        for threads in (1, 0):
            run_resolver("torch_mesh", reqs, want_oracle, card, threads, n_parts=4, **device_kw)
        del reqs
        log(f"resolver phase: {time.perf_counter() - t_phase:.1f} s")
    # 11. a device loss: failover to the port's native and back, one batch
    # at a time and with every batch in flight
    if 11 in run:
        run_failover(card, pipelined=False)
        run_failover(card, pipelined=True)

    # 12. the storage role: tlog -> storage server on the port's Sim, its
    # reads through K5; the earlier phases' objects go first
    batches = spread_batches = want = want_oracle = cs = warm = state_g1 = hbatch = None
    gc.collect()
    if 12 in run:
        _storage, storage_rows = run_storage(card, index_lookups_s)
    # 13. the commit path: client -> proxy -> master -> resolver -> tlog ->
    # storage in the port's static Cluster, its CPU twin first
    if 13 in run:
        _commit, commit_rows = run_commit_path(card)
    # 14. the dynamic cluster: coordinators -> cluster controller -> master
    # recovery -> recruited resolvers and storage, through a master kill, a
    # storage reboot and a storage death; its CPU twin first
    if 14 in run:
        _dynamic, dynamic_rows = run_dynamic_cluster(card)
    # 15. the chaos soak: tools.soak.run_one on the card, seed by seed, each
    # held to its CPU twin
    if 15 in run:
        _soak, soak_rows = run_soak(card)
    # 16. the real-process cluster: fdbserver processes over TCP with their
    # resolvers and storage on the card, the same layout in this process,
    # and the bindingtester streams
    if 16 in run:
        tcp_rows = run_real_process(card, tcp_parts)
    # 17. the port's lint over the checkout, and its B-tree engine: load,
    # commit, reopen, and K5's index rebuilt on the card from its rows
    if 17 in run:
        btree_rows = run_phase17(card)

    # 6. results
    log(f"script: {time.perf_counter() - t_script:.1f} s to the results [{card}]")
    log(json.dumps({"kernels": path_rows(rows + index_rows + mesh_rows + spread_rows + data_rows + storage_rows
                                         + commit_rows + dynamic_rows + soak_rows + tcp_rows + btree_rows)}))
    log(card)
    if spec is None:
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
