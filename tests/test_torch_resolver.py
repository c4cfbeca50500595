"""The port's resolver role (foundationdb_tpu_torch/server/resolver.py over
the guarded conflict set, backends on the CPU) held against the JAX
package's Resolver request for request: ``torch`` against ``tpu1`` and
``torch_mesh`` against ``mesh`` (4 partitions), on a sim EventLoop and on
a RealLoop, with CONFLICT_ENCODE_THREADS 0 and 1, over versions that cross
the int32 rebase. Replies are compared exactly: ``committed``,
``state_mutations``, ``committed_ranges``, ``version_floor``; and the
``kernel`` metrics snapshot has the same keys."""

import numpy as np
import pytest
import torch

from foundationdb_tpu.kv.mutations import Mutation as JMutation
from foundationdb_tpu.kv.mutations import MutationType as JMutationType
from foundationdb_tpu.runtime import futures as j_futures
from foundationdb_tpu.runtime import loop as j_loop
from foundationdb_tpu.runtime.knobs import Knobs as JKnobs
from foundationdb_tpu.server import interfaces as j_if
from foundationdb_tpu.server.resolver import Resolver as JResolver
from foundationdb_tpu_torch.conflict.errors import DeviceUnavailableError
from foundationdb_tpu_torch.conflict.failover import HEALTHY
from foundationdb_tpu_torch.kv.mutations import Mutation, MutationType
from foundationdb_tpu_torch.runtime import futures as t_futures
from foundationdb_tpu_torch.runtime import loop as t_loop
from foundationdb_tpu_torch.runtime.knobs import Knobs
from foundationdb_tpu_torch.server import interfaces as t_if
from foundationdb_tpu_torch.server.resolver import Resolver

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

STEP = 1000  # versions a batch
WINDOW = 3 * STEP  # MAX_READ_TRANSACTION_LIFE_VERSIONS: a 3-batch MVCC window
N_BATCHES = 8
N_TXNS = 32
# the first batches sit just below the int32 rebase threshold (2^30 from
# the device's version origin), so the run rebases as a long-lived one does
V0 = (1 << 30) - 4 * STEP

PORT = (t_loop, t_futures, t_if, Knobs, Resolver, Mutation, MutationType)
JAX = (j_loop, j_futures, j_if, JKnobs, JResolver, JMutation, JMutationType)
PAIRS = {"torch": "tpu1", "torch_mesh": "mesh"}
# the class each JAX backend reports in the guard's health snapshot
_JAX_BACKEND = {"torch": "TpuConflictSet", "torch_mesh": "MeshConflictSet"}


@pytest.fixture(autouse=True)
def _no_loop_left():
    yield
    t_loop.set_loop(None)
    j_loop.set_loop(None)


def _workload(seed, n_batches=N_BATCHES, n_txns=N_TXNS):
    """Seeded requests: per batch N_TXNS transactions with 0-2 read and 0-2
    write ranges over 150 keys, snapshots 1-5 batches old (the oldest are
    TOO_OLD), one state transaction with a mutation per batch, each request
    acknowledging the version two batches back."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n_batches):
        version = V0 + STEP * (i + 1)

        def ranges(k):
            a = rs.randint(0, 150, size=k)
            return [(b"r%04d" % x, b"r%04d" % (x + 1 + rs.randint(0, 6))) for x in a]

        txns = [
            (int(version - STEP * rs.randint(1, 6)), ranges(rs.randint(0, 3)), ranges(rs.randint(0, 3)))
            for _ in range(n_txns)
        ]
        out.append((version - STEP, version, max(0, version - 2 * STEP), txns))
    return out


def _requests(mods, workload):
    _loop, _fut, ifs, _k, _r, mutation, mtype = mods
    reqs = []
    for prev, version, lrv, txns in workload:
        tds = [
            ifs.TransactionData(
                read_snapshot=s,
                read_conflict_ranges=list(r),
                write_conflict_ranges=list(w),
                mutations=[mutation(mtype.SET_VALUE, b"\xff/conf/%d" % j, b"v%d" % version)]
                if j == 0 else [],
            )
            for j, (s, r, w) in enumerate(txns)
        ]
        reqs.append(ifs.ResolveBatchRequest(
            prev_version=prev if prev > V0 else 0,
            version=version,
            last_receive_version=lrv,
            requesting_proxy="px",
            transactions=tds,
            state_txn_indices=[0],
        ))
    return reqs


def _reply_tuple(rep):
    state = [
        (v, [(ok, [(int(m.type), m.param1, m.param2) for m in muts]) for ok, muts in entries])
        for v, entries in rep.state_mutations
    ]
    return (list(rep.committed), state, rep.committed_ranges, rep.version_floor)


def _drive(mods, backend, loop_kind, threads, seed, **backend_kw):
    """All requests spawned at once (the proxies' pipelining); returns the
    replies in request order, the resolver's kernel snapshot and health."""
    loop_mod, fut_mod, _ifs, knobs_cls, res_cls, _m, _t = mods
    loop = loop_mod.EventLoop(seed) if loop_kind == "sim" else loop_mod.RealLoop(seed)
    loop_mod.set_loop(loop)
    knobs = knobs_cls(
        MAX_READ_TRANSACTION_LIFE_VERSIONS=WINDOW,
        CONFLICT_ENCODE_THREADS=threads,
        CONFLICT_SET_CAPACITY=256,
        # a RealLoop measures the deadline in wall seconds; a CPU worker
        # under load must not turn a slow batch into a recovery
        CONFLICT_DISPATCH_DEADLINE=60.0,
    )
    kw = {"n_parts": 4} if backend in ("torch_mesh", "mesh") else {}
    if mods is PORT:
        kw["device"] = "cpu"
    kw.update(backend_kw)
    r = res_cls(knobs=knobs, backend=backend, uid="r0", **kw)
    try:
        futs = [fut_mod.spawn(r.resolve(q)) for q in _requests(mods, _workload(seed))]
        loop.run(until=600.0, stop_when=lambda: all(f.is_ready() for f in futs))
        replies = [_reply_tuple(f.get()) for f in futs]
        kernel = r.stats.snapshot()["kernel"]
        return replies, kernel, r.cs.health_snapshot()
    finally:
        r.close()
        if loop_kind == "real":
            loop.close()


@pytest.mark.parametrize("threads", [0, 1])
@pytest.mark.parametrize("loop_kind", ["sim", "real"])
@pytest.mark.parametrize("backend", ["torch", "torch_mesh"])
def test_resolver_replies_equal_jax_request_for_request(backend, loop_kind, threads):
    seed = {"torch": 3, "torch_mesh": 4}[backend]
    got, kernel, health = _drive(PORT, backend, loop_kind, threads, seed)
    want, j_kernel, j_health = _drive(JAX, PAIRS[backend], loop_kind, threads, seed)
    assert got == want
    assert set(kernel) == set(j_kernel)
    verdicts = {v for rep in got for v in rep[0]}
    assert verdicts == {0, 1, 2}  # commits, conflicts and TOO_OLD all occur
    assert any(rep[1] for rep in got) and any(rep[2] for rep in got)
    assert kernel["rebases"] >= 1 and kernel["batches"] == N_BATCHES
    assert kernel["rebases"] == j_kernel["rebases"]
    assert health["state"] == j_health["state"] == HEALTHY
    assert health["failovers"] == health["faults"] == health["deadlineHits"] == 0
    assert health["backend"] == {"torch": "TorchConflictSet",
                                 "torch_mesh": "TorchMeshConflictSet"}[backend]
    assert j_health["backend"] == _JAX_BACKEND[backend]


@pytest.mark.parametrize("backend, devices", [("torch_mesh", ["cpu"] * 4), ("torch1", None)])
def test_spread_and_pinned_resolvers_equal_jax(backend, devices):
    """``torch_mesh`` with its 4 partitions spread over 4 CPU entries
    against the JAX ``mesh``, and the pinned ``torch1`` against ``tpu1``:
    the guard threads the knobs into both and keeps them HEALTHY."""
    kw = {"devices": devices} if devices else {}
    got, kernel, health = _drive(PORT, backend, "sim", 0, 4, **kw)
    want, j_kernel, j_health = _drive(JAX, {"torch_mesh": "mesh", "torch1": "tpu1"}[backend], "sim", 0, 4)
    assert got == want
    assert kernel["rebases"] == j_kernel["rebases"] >= 1
    assert kernel["occupancy"] == j_kernel["occupancy"]
    assert health["state"] == j_health["state"] == HEALTHY
    assert health["backend"] == {"torch_mesh": "TorchMeshConflictSet", "torch1": "TorchConflictSet"}[backend]


def test_retransmit_replays_the_cached_reply():
    t_loop.set_loop(loop := t_loop.EventLoop(9))
    r = Resolver(knobs=Knobs(MAX_READ_TRANSACTION_LIFE_VERSIONS=WINDOW), backend="torch",
                 uid="r0", device="cpu")
    reqs = _requests(PORT, _workload(9))[:3]

    async def go():
        first = [await r.resolve(q) for q in reqs]
        again = await r.resolve(reqs[1])
        return first, again

    fut = t_futures.spawn(go())
    loop.run(until=60.0, stop_when=fut.is_ready)
    first, again = fut.get()
    assert again is first[1]
    snap = r.stats.snapshot()
    assert snap["resolveBatchIn"] == 3 and snap["transactions"] == 3 * N_TXNS
    assert snap["resolveLatencyBands"]["count"] == 3
    assert snap["version"] == reqs[-1].version


def test_register_instance_and_split_point():
    class Process:
        address = "1.2.3.4:1"

        def __init__(self):
            self.endpoints = {}

        def register(self, token, fn):
            self.endpoints[token] = fn

    t_loop.set_loop(loop := t_loop.EventLoop(1))
    r = Resolver(backend="oracle", uid="r7")
    p = Process()
    r.register_instance(p)
    assert set(p.endpoints) == {
        "resolver.resolve#r7", "resolver.ping#r7", "resolver.metrics#r7",
        "resolver.resolutionMetrics#r7", "resolver.splitPoint#r7",
    }
    reqs = _requests(PORT, _workload(2))[:2]

    async def go():
        for q in reqs:
            await p.endpoints["resolver.resolve#r7"](q)
        return await r._split_point({"begin": b"", "end": None, "target_ops": 20})

    fut = t_futures.spawn(go())
    loop.run(until=60.0, stop_when=fut.is_ready)
    assert fut.get()["ops"] >= 20
    r.close()


def test_resolver_with_no_device_raises_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    t_loop.set_loop(t_loop.EventLoop(1))
    for backend in ("torch", "torch_mesh"):
        with pytest.raises(DeviceUnavailableError, match="CUDA"):
            Resolver(backend=backend)
        with pytest.raises(DeviceUnavailableError, match="CUDA"):
            Resolver(backend=backend, device="cuda")
    assert Resolver(backend="native").cs.backend_name == "NativeConflictSet"


def test_threads_under_fast_switching_keep_every_verdict():
    """Stress: the loop thread, the device thread and two encode threads
    share the backend (its key sample, its version base) with the
    interpreter switching threads every 10 µs, across the rebase; every
    verdict must equal the oracle's and the guard must see no fault."""
    import sys

    from foundationdb_tpu_torch.conflict.api import CommitTransaction, new_conflict_set

    workload = _workload(11, n_batches=24, n_txns=160)
    oracle = new_conflict_set("oracle")
    want = [
        oracle.detect_batch(
            [CommitTransaction(s, list(r), list(w)) for s, r, w in txns], version,
            max(0, version - WINDOW),
        )
        for _prev, version, _lrv, txns in workload
    ]
    loop = t_loop.RealLoop(11)
    t_loop.set_loop(loop)
    knobs = Knobs(MAX_READ_TRANSACTION_LIFE_VERSIONS=WINDOW, CONFLICT_ENCODE_THREADS=2,
                  CONFLICT_DISPATCH_DEADLINE=60.0)
    r = Resolver(knobs=knobs, backend="torch", uid="r0", device="cpu", capacity=256)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        futs = [t_futures.spawn(r.resolve(q)) for q in _requests(PORT, workload)]
        loop.run(until=120.0, stop_when=lambda: all(f.is_ready() for f in futs))
        assert all(f.is_ready() for f in futs)
        got = [[int(v) for v in f.get().committed] for f in futs]
    finally:
        sys.setswitchinterval(interval)
        r.close()
        loop.close()
    assert got == [[int(v) for v in w] for w in want]
    h = r.cs.health_snapshot()
    assert h["faults"] == 0 and h["state"] == HEALTHY
    assert r.stats.snapshot()["kernel"]["rebases"] >= 1


@pytest.mark.parametrize("loop_kind", ["sim", "real"])
def test_one_batch_encodes_ahead(loop_kind):
    """Double buffering keeps one batch's encode ahead of the version chain:
    with every request spawned at once, batch k encodes only once batch k-1
    is at the head (the dispatch gate has passed batch k-2)."""
    loop = t_loop.EventLoop(5) if loop_kind == "sim" else t_loop.RealLoop(5)
    t_loop.set_loop(loop)
    r = Resolver(knobs=Knobs(MAX_READ_TRANSACTION_LIFE_VERSIONS=WINDOW), backend="torch",
                 uid="r0", device="cpu", capacity=256)
    reqs = _requests(PORT, _workload(5))
    first = {id(q.transactions): i for i, q in enumerate(reqs)}
    gate_at_encode = {}
    encode = r.cs.encode

    def watched(txns):
        gate_at_encode.setdefault(first[id(txns)], r.gate.version)
        return encode(txns)

    r.cs.encode = watched
    try:
        futs = [t_futures.spawn(r.resolve(q)) for q in reversed(reqs)]
        loop.run(until=120.0, stop_when=lambda: all(f.is_ready() for f in futs))
        assert all(f.is_ready() for f in futs)
    finally:
        r.close()
        if loop_kind == "real":
            loop.close()
    assert sorted(gate_at_encode) == list(range(N_BATCHES))
    for k in range(2, N_BATCHES):
        assert gate_at_encode[k] >= reqs[k - 2].version, (k, gate_at_encode)
