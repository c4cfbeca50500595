"""Throughput workloads: ReadWrite (YCSB-style), BulkLoad, Throughput.

The analogs of fdbserver/workloads/ReadWrite.actor.cpp:1 (randomized
read/write mixes with latency sampling), BulkLoad.actor.cpp:1 (max-rate
sequential ingest) and Throughput.actor.cpp:1 (sustained mixed load with
steady-state measurement). These are the workloads behind the reference's
published numbers (documentation/sphinx/source/benchmarking.rst:53-97:
46K writes/s, 305K reads/s @ 0.6 ms, 107K 90/10 ops/s, one core) — the
repo's previous batteries checked correctness only; these measure.

Each workload runs unchanged against the simulated cluster (wall-clock =
cost of the Python+PyTorch pipeline; latencies in *sim* time = protocol cost)
and against a real TCP cluster (both wall) via tools/perf.py.
"""

from __future__ import annotations

import time

from ..runtime.futures import spawn, wait_for_all
from . import Workload
from ..runtime.loop import Cancelled


def _pct(sorted_vals, p):
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * p))]


class _Recorder:
    """Shared op/latency accounting across a workload's client actors."""

    def __init__(self, now_fn):
        self.now = now_fn  # model-time clock for latency samples
        self.reads = 0
        self.writes = 0
        self.commits = 0
        self.conflicts = 0
        self.read_lat: list[float] = []
        self.commit_lat: list[float] = []
        self.t0_wall = None
        self.t1_wall = None

    def start_clock(self):
        if self.t0_wall is None:
            self.t0_wall = time.perf_counter()

    def stop_clock(self):
        self.t1_wall = time.perf_counter()

    @property
    def wall(self) -> float:
        return (self.t1_wall or time.perf_counter()) - self.t0_wall

    def report(self) -> dict:
        ops = self.reads + self.writes
        rl = sorted(self.read_lat)
        cl = sorted(self.commit_lat)
        wall = max(self.wall, 1e-9)
        return {
            "ops": ops,
            "reads": self.reads,
            "writes": self.writes,
            "commits": self.commits,
            "conflicts": self.conflicts,
            "wall_s": round(wall, 3),
            "ops_per_s": round(ops / wall, 1),
            "reads_per_s": round(self.reads / wall, 1),
            "writes_per_s": round(self.writes / wall, 1),
            "txn_per_s": round(self.commits / wall, 1),
            "read_p50_ms": round(_pct(rl, 0.50) * 1000, 3),
            "read_p95_ms": round(_pct(rl, 0.95) * 1000, 3),
            "commit_p50_ms": round(_pct(cl, 0.50) * 1000, 3),
            "commit_p95_ms": round(_pct(cl, 0.95) * 1000, 3),
        }


class ReadWriteWorkload(Workload):
    """N concurrent client actors, each running transactions composed of
    ``reads_per_txn`` random gets + ``writes_per_txn`` random sets over a
    pre-populated uniform keyspace (ReadWrite.actor.cpp's
    actorCount/readsPerTransactionA shape). 90/10 = (9, 1); 50/50 = (5, 5);
    write-only = (0, 10) reproduces benchmarking.rst:53's concurrent
    writes; read-only = (10, 0) reproduces :67's concurrent reads."""

    def __init__(
        self,
        db,
        rng,
        actors=20,
        txns_per_actor=50,
        reads_per_txn=9,
        writes_per_txn=1,
        keyspace=10_000,
        value_len=16,
        prefix=b"rw/",
        now_fn=None,
        parallel_reads=False,
        priority=None,
        tenant=None,
        **kw,
    ):
        super().__init__(db, rng, **kw)
        self.actors = actors
        self.txns_per_actor = txns_per_actor
        self.reads_per_txn = reads_per_txn
        self.writes_per_txn = writes_per_txn
        self.keyspace = keyspace
        self.value_len = value_len
        self.prefix = prefix
        # issue each transaction's reads concurrently (the reference's
        # clients pipeline their gets; with the read coalescer this is
        # what collapses a txn's N gets into one multiGet hop)
        self.parallel_reads = parallel_reads
        # admission options: the overload workloads run this
        # shape per priority class / tenant; None = database defaults
        self.priority = priority
        self.tenant = tenant
        if now_fn is None:
            from ..runtime.loop import now as now_fn
        self.rec = _Recorder(now_fn)

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%08d" % i

    def _value(self) -> bytes:
        return b"v" * self.value_len

    async def setup(self):
        if self.client_id != 0:
            return
        # populate in chunks (one giant txn would blow batch limits)
        for lo in range(0, self.keyspace, 2000):
            hi = min(lo + 2000, self.keyspace)

            async def fill(tr, lo=lo, hi=hi):
                for i in range(lo, hi):
                    tr.set(self._key(i), self._value())

            await self.db.run(fill)

    async def _one_txn(self, rnd):
        rec = self.rec
        for attempt in range(20):
            tr = self.db.transaction(
                priority=self.priority, tenant=self.tenant
            )
            try:
                if self.parallel_reads and self.reads_per_txn > 1:
                    keys = [
                        self._key(rnd.random_int(0, self.keyspace))
                        for _ in range(self.reads_per_txn)
                    ]
                    t0 = rec.now()
                    futs = [spawn(tr.get(k)) for k in keys]
                    try:
                        await wait_for_all(futs)
                    except Cancelled:
                        raise  # actor-cancelled-swallow
                    except BaseException:
                        for f in futs:
                            f.cancel()
                        raise
                    dt = rec.now() - t0
                    rec.read_lat.extend([dt] * len(keys))
                else:
                    for _ in range(self.reads_per_txn):
                        k = self._key(rnd.random_int(0, self.keyspace))
                        t0 = rec.now()
                        await tr.get(k)
                        rec.read_lat.append(rec.now() - t0)
                for _ in range(self.writes_per_txn):
                    k = self._key(rnd.random_int(0, self.keyspace))
                    tr.set(k, self._value())
                if self.writes_per_txn or self.reads_per_txn:
                    t0 = rec.now()
                    await tr.commit()
                    if self.writes_per_txn:
                        rec.commit_lat.append(rec.now() - t0)
                rec.reads += self.reads_per_txn
                rec.writes += self.writes_per_txn
                rec.commits += 1
                return
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception as e:
                rec.conflicts += 1
                await tr.on_error(e)

    async def start(self):
        self.rec.start_clock()

        async def client(cid):
            rnd = self.rng.fork()
            for _ in range(self.txns_per_actor):
                await self._one_txn(rnd)
            return True

        await wait_for_all(
            [spawn(client(c)) for c in range(self.actors)]
        )
        self.rec.stop_clock()

    async def check(self) -> bool:
        return self.rec.commits > 0


class BulkLoadWorkload(Workload):
    """Max-rate sequential ingest (BulkLoad.actor.cpp:1): W writer actors
    each append batches of ``keys_per_txn`` contiguous keys in disjoint
    ranges; metric = keys ingested per second."""

    def __init__(
        self,
        db,
        rng,
        actors=8,
        txns_per_actor=40,
        keys_per_txn=50,
        value_len=16,
        prefix=b"bulk/",
        now_fn=None,
        **kw,
    ):
        super().__init__(db, rng, **kw)
        self.actors = actors
        self.txns_per_actor = txns_per_actor
        self.keys_per_txn = keys_per_txn
        self.value_len = value_len
        self.prefix = prefix
        if now_fn is None:
            from ..runtime.loop import now as now_fn
        self.rec = _Recorder(now_fn)

    async def start(self):
        self.rec.start_clock()
        val = b"b" * self.value_len

        async def writer(w):
            rec = self.rec
            # globally unique writer index: concurrent client PROCESSES
            # (tools/perf.py --client-procs) must ingest disjoint ranges,
            # or the aggregate keys/s double-counts rewrites of the same
            # keys
            gw = self.client_id * self.actors + w
            for t in range(self.txns_per_actor):
                base = (gw * self.txns_per_actor + t) * self.keys_per_txn

                async def body(tr, base=base):
                    for i in range(self.keys_per_txn):
                        tr.set(self.prefix + b"%012d" % (base + i), val)

                t0 = rec.now()
                await self.db.run(body)
                rec.commit_lat.append(rec.now() - t0)
                rec.writes += self.keys_per_txn
                rec.commits += 1
            return True

        await wait_for_all([spawn(writer(w)) for w in range(self.actors)])
        self.rec.stop_clock()

    async def check(self) -> bool:
        # spot-verify the tail of THIS client's last writer range arrived
        tr = self.db.transaction()
        last = (
            ((self.client_id + 1) * self.actors * self.txns_per_actor)
            * self.keys_per_txn
            - 1
        )
        return (await tr.get(self.prefix + b"%012d" % last)) is not None


class ThroughputWorkload(ReadWriteWorkload):
    """Duration-based steady state (Throughput.actor.cpp:1): run the mixed
    transaction shape for ``duration`` seconds of model time (sim) or wall
    time (TCP) after a ramp-up, and report only the steady-state window —
    start-up transients don't pollute the measured rate."""

    def __init__(self, db, rng, duration=5.0, ramp=0.5, **kw):
        kw.setdefault("txns_per_actor", 10**9)  # bounded by time, not count
        super().__init__(db, rng, **kw)
        self.duration = duration
        self.ramp = ramp

    async def start(self):
        rec = self.rec
        t_end = rec.now() + self.ramp + self.duration
        ramp_until = rec.now() + self.ramp
        started = [False]

        async def client(cid):
            rnd = self.rng.fork()
            while rec.now() < t_end:
                if not started[0] and rec.now() >= ramp_until:
                    started[0] = True
                    # reset counters at steady state; wall clock restarts
                    rec.reads = rec.writes = rec.commits = rec.conflicts = 0
                    rec.read_lat.clear()
                    rec.commit_lat.clear()
                    rec.t0_wall = time.perf_counter()
                await self._one_txn(rnd)
            return True

        rec.start_clock()
        await wait_for_all(
            [spawn(client(c)) for c in range(self.actors)]
        )
        rec.stop_clock()
