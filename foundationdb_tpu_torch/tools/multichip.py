"""The multi-card entry points: a one-step check of the resolver kernel, the
multi-card dry run and the scaling sweep — the port's counterpart of the
JAX package's ``__graft_entry__.py``.

entry()               → (fn, example_args): one resolver step of the bucket
                        grid (``conflict/grid.py`` ``resolve_one``: history
                        check → intra-batch greedy commit → merge) on a
                        256 × 32 grid and a batch of 256 transactions.
dryrun_multichip(n)   → a ``part = n // 2`` × ``data = n // part`` spread of
                        the partitioned grid (``conflict/sharded.py``), three
                        resolver steps with a partition reshard between
                        them, ``TorchMeshConflictSet(n_parts=n)`` against
                        the one grid, and the resolution balancer's
                        hot-prefix drill in a simulated ``Cluster``.
dryrun_sweep(...)     → the same batches through 1, 2, 4, … partitions,
                        every verdict against the port's ``native``, txn/s
                        a part count.

Run: ``python -m foundationdb_tpu_torch.tools.multichip [-n N] [--sweep]
[--batches B] [--txns T] [--device cpu]``. Everything runs on the CUDA
card (raising ``DeviceUnavailableError`` without one) unless
``device="cpu"`` asks for the kernels' plain versions. Partitions go one
to a card where the host has that many cards, else all on ``cuda:0``.
"""

# flowlint: disable-file=det-wall-clock — the sweep's txn/s is HOST wall
# time of device work on purpose; it is printed evidence, never an input to
# sim scheduling (no control flow reads it).

from __future__ import annotations

import argparse
import random
import sys
import time

import numpy as np
import torch

from ..conflict import grid as G
from ..conflict import keys as K
from ..conflict import sharded as SH
from ..conflict.api import CommitTransaction
from ..device import resolve_device
from ..conflict.torch_backend import upload


def _example_batch(T, KR, KW, L, seed=0):
    """``__graft_entry__.py:18``'s batch: narrow [k, k + span) ranges over
    keys whose first byte spreads over the keyspace, as host numpy."""
    rnd = np.random.default_rng(seed)
    width = 4 * L

    def key(k):
        # spread over the full first byte so every partition of the
        # uniform first-lane split owns traffic
        return bytes([(k * 37) % 251]) + b"%07d" % k

    def ranges(n):
        ks = rnd.integers(0, 1_000_000, size=n)
        spans = rnd.integers(1, 10, size=n)
        b = K.encode_keys([key(k) for k in ks], width=width)
        e = K.encode_keys([key(k) + bytes([s]) for k, s in zip(ks, spans)], width=width)
        return b, e

    rb, re = ranges(T * KR)
    wb, we = ranges(T * KW)
    return G.Batch(
        rb=rb.reshape(T, KR, L), re=re.reshape(T, KR, L),
        wb=wb.reshape(T, KW, L), we=we.reshape(T, KW, L),
        t_snap=np.full(T, 5, np.int32), t_has_reads=np.ones(T, bool),
    )


def entry(device=None):
    """(fn, example_args): ``fn(*example_args)`` is one resolver step,
    (state, verdicts int8[T], pressure int32[2]), on ``device`` (the card by
    default). ``fn`` updates the state it is given in place."""
    dev = resolve_device(device)
    T, KR, KW, L = 256, 2, 2, 8
    state = G.make_state(n_buckets=256, n_slots=32, lanes=L, device=dev)
    batch = upload(_example_batch(T, KR, KW, L), dev)
    return G.resolve_one, (state, batch, 100, 1, 1)


def card_devices(n: int, device=None) -> list:
    """``n`` devices for ``n`` partitions: ``device`` repeated where it is
    given (``"cpu"``, or one card), else the host's first ``n`` cards where
    there are that many, else ``cuda:0`` repeated."""
    if device is not None:
        return [resolve_device(device)] * n
    resolve_device(None)
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def _sync(devices) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def dryrun_multichip(n_devices: int, devices=None, device=None, log=print) -> dict:
    """``__graft_entry__.py:68``: a ``part`` × ``data`` spread over
    ``devices`` (``card_devices`` by default), three steps with a reshard of
    partition 0 after step 1, the pressure checks, ``TorchMeshConflictSet(
    n_parts=n)`` against ``TorchConflictSet`` on 3 × 48 transactions, and
    the hot-prefix drill of the resolution balancer in the port's
    ``Cluster(ClusterConfig(n_resolvers=2, n_proxies=2))`` on ``Sim(seed=11)``.
    Prints the reference's line and returns its figures."""
    from ..client.database import Database
    from ..conflict.mesh_backend import TorchMeshConflictSet
    from ..conflict.torch_backend import TorchConflictSet
    from ..net.sim import Sim
    from ..runtime.futures import spawn
    from ..server import Cluster, ClusterConfig
    from ..workloads.rebalance_drill import hot_prefix_rebalance

    devs = list(devices) if devices is not None else card_devices(n_devices, device)
    devs = [resolve_device(d) for d in devs]
    if len(devs) != n_devices:
        raise ValueError(f"{len(devs)} devices for a dry run of {n_devices}")
    n_part = max(n_devices // 2, 1)
    n_data = n_devices // n_part
    rows = [devs[r * n_data : (r + 1) * n_data] for r in range(n_part)]

    T, KR, KW, L, B, S = 64, n_data, 2, 8, 64, 32
    spread = SH.make_spread(n_part, B, S, L, rows)
    for i in range(3):  # the state stays on the cards across steps
        hbatch = _example_batch(T, KR, KW, L, seed=i)
        batches = {dev: upload(hbatch, dev) for dev in spread.devices()}
        slices = {dev: SH.split_reads(b.rb, b.re, n_data) for dev, b in batches.items()}
        verdicts, pressure = SH.resolve_one_spread(
            spread, [batches[e.device] for e in spread.entries], 100 + i, 1 + i, 1 + i,
            [slices[e.device][e.replica] for e in spread.entries],
        )
        pr = pressure.cpu().numpy()
        assert (pr[:, 0] <= G.staging_slots(S)).all(), pr
        assert (pr[:, 1] <= S).all(), pr
        if i == 1:
            # host-driven partition rebalance between batches (the dynamic
            # resolver-split analog, masterserver.actor.cpp:896)
            spread, p0 = SH.reshard_spread_partition(spread, 0, B, S)
            assert p0 <= S, p0
    _sync(devs)
    out_v = verdicts.cpu().numpy()
    assert out_v.shape == (T,) and set(np.unique(out_v)) <= {0, 1, 2}
    committed = int((out_v == 0).sum())
    replicas_equal = spread.replicas_equal()
    assert replicas_equal, "the data replicas of a row differ"
    del spread, batches, slices

    # the backend a resolver builds, one partition a device, against the
    # one grid on the first device
    rnd = np.random.default_rng(7)
    mesh_cs = TorchMeshConflictSet(key_width=12, capacity=1 << 12, n_parts=n_devices, devices=devs)
    single_cs = TorchConflictSet(key_width=12, capacity=1 << 12, device=devs[0])
    parity = 0
    for i in range(3):
        txs = []
        for _t in range(48):
            a = int(rnd.integers(0, 5000))
            c = int(rnd.integers(0, 5000))
            txs.append(CommitTransaction(
                read_snapshot=i,
                read_conflict_ranges=[(b"%06d" % a, b"%06d" % (a + 3))],
                write_conflict_ranges=[(b"%06d" % c, b"%06d" % (c + 3))],
            ))
        vm = mesh_cs.detect_batch(txs, now=i + 20, new_oldest_version=i)
        vs = single_cs.detect_batch(txs, now=i + 20, new_oldest_version=i)
        assert [int(v) for v in vm] == [int(v) for v in vs], f"batch {i}"
        parity += len(vm)
    mesh_cs.close()
    single_cs.close()

    # in-cluster load-driven resolver rebalancing (resolutionBalancing,
    # masterserver.actor.cpp:896): a hot-prefix run must end with a moved
    # role boundary and both resolvers carrying traffic
    sim = Sim(seed=11)
    sim.activate()
    cluster = Cluster(sim, ClusterConfig(n_resolvers=2, n_proxies=2), device=device)
    db = Database(sim, cluster.proxy_addrs)
    balancer = cluster.start_resolution_balancer()
    moves, gained = sim.run_until_done(
        spawn(hot_prefix_rebalance(cluster, db, balancer, bursts=(150, 100))), 600.0,
    )
    assert moves >= 1, "no resolver boundary moved"
    assert min(gained) > 0, f"post-move traffic unbalanced: {gained}"
    for r in cluster.resolvers:
        r.close()

    out = {
        "n_part": n_part, "n_data": n_data, "committed": committed, "txns": T,
        "pressure": pr.tolist(), "parity": parity, "moves": int(balancer.moves),
        "gained": [int(g) for g in gained], "replicas_equal": replicas_equal,
        "devices": [str(d) for d in devs],
    }
    log(
        f"dryrun_multichip OK: mesh part={n_part} data={n_data}, "
        f"{committed}/{T} committed, pressure per part "
        f"{out['pressure']}; TorchMeshConflictSet({n_devices} parts) "
        f"verdict parity on {parity} txns; resolutionBalancing moved "
        f"{balancer.moves} boundaries, post-move resolver txns {out['gained']}"
    )
    return out


def sweep_batches(n_batches: int, n_txns: int) -> list:
    """``__graft_entry__.py:216``'s batches: one 3-key read and one 3-key
    write a transaction over 100,000 keys, read at snapshot i."""
    rnd = random.Random(17)
    batches = []
    for i in range(n_batches):
        txs = []
        for _ in range(n_txns):
            a = rnd.randrange(100000)
            c = rnd.randrange(100000)
            txs.append(CommitTransaction(
                read_snapshot=i,
                read_conflict_ranges=[(b"%06d" % a, b"%06d" % (a + 3))],
                write_conflict_ranges=[(b"%06d" % c, b"%06d" % (c + 3))],
            ))
        batches.append(txs)
    return batches


def dryrun_sweep(max_parts: int = 8, n_batches: int = 6, n_txns: int = 192, devices=None,
                 device=None, log=print) -> dict:
    """``__graft_entry__.py:188``: the same batches at 1, 2, 4, …,
    ``max_parts`` partitions, ``TorchConflictSet`` at 1 and
    ``TorchMeshConflictSet`` above, the parts on ``devices[:p]`` (by default
    ``card_devices(p, device)``). Each count runs twice on fresh instances,
    a warm pass and a timed one, every group dispatched through
    ``detect_many_encoded_async`` before the first is collected; every
    verdict must equal the port's ``native``. Prints txn/s a part count and
    its ratio to 1 part; returns them."""
    from ..conflict.mesh_backend import TorchMeshConflictSet
    from ..conflict.native import NativeConflictSet
    from ..conflict.torch_backend import TorchConflictSet

    batches = sweep_batches(n_batches, n_txns)
    ref_cs = NativeConflictSet()
    ref = [ref_cs.detect_batch(list(txs), now=i + 20, new_oldest_version=i) for i, txs in enumerate(batches)]

    def place(p):
        return [resolve_device(d) for d in devices[:p]] if devices is not None else card_devices(p, device)

    def run(cs, devs) -> float:
        t0 = time.perf_counter()
        handles = []
        for i, txs in enumerate(batches):
            cs.prepare(i + 20)
            handles.append(cs.detect_many_encoded_async([(cs.encode(txs), i + 20, i)]))
        got = []
        for h in handles:
            got.extend(h())
        _sync(devs)
        dt = time.perf_counter() - t0
        for i, want in enumerate(ref):
            assert [int(v) for v in got[i]] == [int(v) for v in want], f"verdict divergence vs native at batch {i}"
        return dt

    parts, p = [], 1
    while p <= max_parts:
        parts.append(p)
        p *= 2
    total = n_batches * n_txns
    rows = []
    for p in parts:
        devs = place(p)

        def make(devs=devs, p=p):
            if p == 1:
                return TorchConflictSet(key_width=12, capacity=1 << 12, device=devs[0])
            return TorchMeshConflictSet(key_width=12, capacity=1 << 12, n_parts=p, devices=devs)

        warm = make()
        warm.warm_compile()
        run(warm, devs)
        warm.close()
        timed = make()
        timed.warm_compile()
        _sync(devs)
        dt = run(timed, devs)
        k = timed.metrics.snapshot()
        timed.close()
        rows.append({"parts": p, "devices": sorted({str(d) for d in devs}), "txn_s": total / dt,
                     "ms": dt * 1e3, "replays": k["overflowReplays"]})
        log(f"  part={p}: {total / dt:,.0f} txn/s ({dt * 1e3:.1f} ms, replays={k['overflowReplays']}, "
            f"on {', '.join(rows[-1]['devices'])}) — verdicts == native")
    base = rows[0]["txn_s"]
    for r in rows:
        r["ratio"] = r["txn_s"] / base
    log(f"dryrun_sweep OK: {total} txns x {len(parts)} configs, parity vs native on all; txn/s vs 1-part: "
        + ", ".join(f"{r['parts']}p={r['ratio']:.2f}x" for r in rows))
    return {"txns": total, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multichip", description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", "--devices", type=int, default=8, help="devices of the dry run, or the sweep's most parts")
    ap.add_argument("--sweep", action="store_true", help="resolver scaling sweep 1..N parts at fixed total work")
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--txns", type=int, default=192)
    ap.add_argument("--device", default=None, help="cpu: the kernels' plain versions (default: the card)")
    args = ap.parse_args(argv)
    if args.sweep:
        dryrun_sweep(args.devices, args.batches, args.txns, device=args.device)
    else:
        dryrun_multichip(args.devices, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
