"""The port's kernel fault tolerance (conflict/faults.py, conflict/failover.py
and the resolver's deadline and retry) on the port's own EventLoop, with the
backend on the CPU (``device="cpu"``): the cluster-free battery of
tests/test_kernel_faults.py, a same-seed chaos scenario run through both
packages with equal verdicts, health snapshots and fault counts (exact
equality), and the fence that keeps a missing card or an unbuildable kernel
from passing for a failed-over resolver."""

import numpy as np
import pytest
import torch

from foundationdb_tpu.conflict.faults import KernelFaultInjector as JInjector
from foundationdb_tpu.runtime import futures as j_futures
from foundationdb_tpu.runtime import loop as j_loop
from foundationdb_tpu.runtime.knobs import Knobs as JKnobs
from foundationdb_tpu.runtime.rng import DeterministicRandom as JRandom
from foundationdb_tpu.server import interfaces as j_if
from foundationdb_tpu.server.resolver import Resolver as JResolver
from foundationdb_tpu_torch.conflict import errors, faults
from foundationdb_tpu_torch.conflict.api import CommitTransaction, Verdict
from foundationdb_tpu_torch.conflict.failover import (
    FAILED_OVER,
    HEALTHY,
    GuardedConflictSet,
    WriteRangeJournal,
)
from foundationdb_tpu_torch.conflict.faults import (
    KERNEL_FAULT_SITES,
    KernelFaultInjector,
    KernelTransientError,
)
from foundationdb_tpu_torch.conflict.oracle import OracleConflictSet
from foundationdb_tpu_torch.conflict.torch_backend import TorchConflictSet
from foundationdb_tpu_torch.runtime import loop as t_loop
from foundationdb_tpu_torch.runtime.futures import delay, spawn
from foundationdb_tpu_torch.runtime.knobs import Knobs
from foundationdb_tpu_torch.runtime.rng import DeterministicRandom
from foundationdb_tpu_torch.server import interfaces as t_if
from foundationdb_tpu_torch.server.resolver import Resolver

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


@pytest.fixture(autouse=True)
def _no_loop_left():
    yield
    t_loop.set_loop(None)
    j_loop.set_loop(None)


@pytest.fixture(autouse=True)
def _no_buggify_armed():
    """The injectors also fire where the process's buggify is armed, and a
    chaos Sim that ran earlier in this process (any test file's) leaves it
    armed: each test starts with both packages' disarmed."""
    from foundationdb_tpu.runtime import buggify as j_buggify
    from foundationdb_tpu_torch.runtime import buggify as t_buggify

    for b in (j_buggify, t_buggify):
        b.set_buggify(b.Buggify(None))
    yield


def _sim(seed, loop_mod=t_loop):
    loop = loop_mod.EventLoop(seed)
    loop_mod.set_loop(loop)
    return loop


def _run(loop, coro, limit, spawn_fn=spawn):
    fut = spawn_fn(coro)
    loop.run(until=limit, stop_when=fut.is_ready)
    assert fut.is_ready(), "scenario did not finish in virtual time"
    return fut.get()


def _req(prev, version, txns, ifs=t_if):
    return ifs.ResolveBatchRequest(
        version=version,
        prev_version=prev,
        transactions=[
            ifs.TransactionData(
                read_snapshot=s,
                read_conflict_ranges=list(r),
                write_conflict_ranges=list(w),
                mutations=[],
            )
            for (s, r, w) in txns
        ],
        last_receive_version=0,
        requesting_proxy="px",
    )


class _FalseCommitOracle:
    """Zero-false-commit referee (tests/test_kernel_faults.py): applies
    exactly the writes the resolver COMMITTED, and probes each claimed
    commit's reads against that history. Conservative aborts pass."""

    def __init__(self):
        self.cs = OracleConflictSet()

    def check_batch(self, txns, verdicts, version):
        for t, v in zip(txns, verdicts):
            committed = int(v) == int(Verdict.COMMITTED)
            if committed and t.read_conflict_ranges:
                probe = self.cs.detect_batch(
                    [CommitTransaction(read_snapshot=t.read_snapshot,
                                       read_conflict_ranges=list(t.read_conflict_ranges))],
                    now=version, new_oldest_version=0,
                )
                assert probe[0] == Verdict.COMMITTED, (
                    f"FALSE COMMIT: snap={t.read_snapshot} reads={t.read_conflict_ranges} "
                    f"admitted at v{version} over a newer committed write"
                )
            if committed and t.write_conflict_ranges:
                self.cs.detect_batch(
                    [CommitTransaction(write_conflict_ranges=list(t.write_conflict_ranges))],
                    now=version, new_oldest_version=0,
                )


def _quiet_injector(loop, inj_cls=KernelFaultInjector, **kw):
    return inj_cls(
        loop.random.fork(),
        p_dispatch_error=0, p_device_loss=0, p_hang=0, p_compile_stall=0,
        p_encode_error=0, p_encode_hang=0, **kw,
    )


def _resolver(loop, knobs=None, **inj_kw):
    inj = _quiet_injector(loop, **inj_kw)
    r = Resolver(knobs=knobs or Knobs(), backend="torch", uid="r0", device="cpu",
                 fault_injector=inj)
    return r, inj


# ---------------------------------------------------------------------------
# Journal + injector units


def test_journal_replay_reconstructs_history():
    j = WriteRangeJournal(capacity=100)
    j.record(10, [(b"a", b"b")])
    j.record(20, [(b"c", b"d")])
    for cs in (OracleConflictSet(), TorchConflictSet(capacity=64, device="cpu")):
        j.replay_into(cs)
        old = cs.detect_batch(
            [CommitTransaction(read_snapshot=5, read_conflict_ranges=[(b"a", b"b")])],
            now=30, new_oldest_version=0,
        )
        new = cs.detect_batch(
            [CommitTransaction(read_snapshot=15, read_conflict_ranges=[(b"a", b"b")])],
            now=31, new_oldest_version=0,
        )
        assert old == [Verdict.CONFLICT] and new == [Verdict.COMMITTED]


def test_journal_capacity_floor_is_conservative_only():
    j = WriteRangeJournal(capacity=2)
    j.record(10, [(b"a", b"b")])
    j.record(20, [(b"c", b"d")])
    j.record(30, [(b"e", b"f")])  # evicts v10 → floor 11
    assert j.floor == 11 and len(j) == 2
    cs = OracleConflictSet()
    j.replay_into(cs)
    probe = cs.detect_batch(
        [CommitTransaction(read_snapshot=5, read_conflict_ranges=[(b"a", b"b")])],
        now=40, new_oldest_version=0,
    )
    assert probe == [Verdict.TOO_OLD]
    j.trim_below(25)
    assert j.floor == 25 and len(j) == 1


def _roll(inj_cls, rng_cls, transient, seed):
    inj = inj_cls(rng_cls(seed), p_dispatch_error=0.3, p_device_loss=0.0,
                  p_hang=0.2, p_compile_stall=0.2)
    out = []
    for _ in range(40):
        try:
            inj.on_dispatch()
            out.append(inj.take_stall())
        except transient:
            out.append("err")
    return out, dict(inj.counts)


def test_injector_same_seed_same_fault_sequence_as_jax():
    _sim(5)
    _sim(5, j_loop)
    from foundationdb_tpu.conflict.faults import KernelTransientError as JTransient

    a = _roll(KernelFaultInjector, DeterministicRandom, KernelTransientError, 123)
    assert a == _roll(KernelFaultInjector, DeterministicRandom, KernelTransientError, 123)
    assert a != _roll(KernelFaultInjector, DeterministicRandom, KernelTransientError, 321)
    assert a == _roll(JInjector, JRandom, JTransient, 123)
    assert set(t for (_f, t) in KERNEL_FAULT_SITES) >= set(a[1])


def test_fault_classes_have_one_identity():
    """The backend raises, the injector raises and the resolver catches the
    same classes (conflict/errors.py, re-exported by conflict/faults.py)."""
    from foundationdb_tpu_torch.conflict import failover, torch_backend
    from foundationdb_tpu_torch.server import resolver

    assert faults.StaleEncodingError is errors.StaleEncodingError is torch_backend.StaleEncodingError
    assert faults.KernelTimeoutError is errors.KernelTimeoutError is failover.KernelTimeoutError
    assert resolver.KernelFaultError is errors.KernelFaultError
    assert resolver.KernelTimeoutError is errors.KernelTimeoutError
    assert faults.KernelDeviceLostError is errors.KernelDeviceLostError
    assert issubclass(errors.StaleEncodingError, errors.KernelTransientError)
    assert errors.StaleEncodingError.transient and not errors.KernelDeviceLostError.transient
    assert not issubclass(errors.DeviceUnavailableError, errors.KernelFaultError)
    assert issubclass(errors.KernelBuildError, errors.DeviceUnavailableError)


# ---------------------------------------------------------------------------
# Resolver-level fault handling


def test_transient_dispatch_error_retried_in_place():
    loop = _sim(11)
    r, inj = _resolver(loop)
    fire = {"n": 1}
    orig = inj.on_dispatch

    def once():
        if fire["n"]:
            fire["n"] -= 1
            raise KernelTransientError("injected transient dispatch error")
        orig()

    inj.on_dispatch = once

    async def go():
        rep = await r.resolve(_req(0, 10, [(0, [], [(b"a", b"b")])]))
        assert rep.committed == [0]
        h = r.cs.health_snapshot()
        assert h["state"] == HEALTHY and h["retries"] == 1
        assert h["failovers"] == 0 and h["deviceRebuilds"] == 0
        return True

    assert _run(loop, go(), 60.0)


def test_hang_hits_deadline_and_recovers():
    loop = _sim(12)
    r, inj = _resolver(loop, knobs=Knobs(CONFLICT_DISPATCH_DEADLINE=1.5))

    async def go():
        inj._pending_stall = 0.3  # finite stall: latency only
        t0 = loop.now()
        rep = await r.resolve(_req(0, 10, [(0, [], [(b"a", b"b")])]))
        assert rep.committed == [0]
        assert 0.3 <= loop.now() - t0 < 1.5
        assert r.cs.health_snapshot()["deadlineHits"] == 0
        inj._pending_stall = float("inf")  # hang: the deadline recovers it
        t0 = loop.now()
        rep = await r.resolve(_req(10, 20, [(5, [(b"a", b"b")], [(b"a", b"b")])]))
        assert rep.committed == [1]  # conflict with the v10 write — not lost
        assert loop.now() - t0 >= 1.5
        h = r.cs.health_snapshot()
        assert h["deadlineHits"] == 1 and h["faults"] >= 1
        return True

    assert _run(loop, go(), 120.0)


def _loss_scenario(seed):
    """Device loss mid-stream: kill → failover → heal → re-promotion,
    refereed for false commits. Returns (verdict log, health snapshot)."""
    loop = _sim(seed)
    knobs = Knobs(CONFLICT_FAILOVER_STRIKES=2, CONFLICT_REPROBE_INTERVAL=0.5)
    r, inj = _resolver(loop, knobs=knobs, loss_duration=3.0)
    referee = _FalseCommitOracle()
    log = []

    async def go():
        async def batch(prev, ver, txns):
            req = _req(prev, ver, txns)
            rep = await r.resolve(req)
            referee.check_batch(req.transactions, rep.committed, ver)
            log.append((ver, list(rep.committed), r.cs.health, r.cs.backend_name))

        await batch(0, 10, [(0, [], [(b"a", b"b")])])
        assert r.cs.health == HEALTHY
        inj.lose_device(3.0)
        await batch(10, 20, [(5, [(b"a", b"b")], [(b"a", b"b")])])
        await batch(20, 30, [(15, [(b"a", b"b")], [(b"a", b"b")])])
        await batch(30, 40, [(25, [(b"c", b"d")], [(b"c", b"d")])])
        assert r.cs.health == FAILED_OVER
        await delay(4.0)  # loss heals; reprobe window passes
        await batch(40, 50, [(45, [(b"a", b"b")], [(b"e", b"f")])])
        assert r.cs.health == HEALTHY
        return True

    assert _run(loop, go(), 300.0)
    return log, r.cs.health_snapshot()


def test_device_loss_fails_over_to_the_ports_native_and_promotes_back():
    log, health = _loss_scenario(seed=42)
    assert [v for v, *_ in log] == [10, 20, 30, 40, 50]
    assert health["state"] == HEALTHY and health["backend"] == "TorchConflictSet"
    assert health["failovers"] == 1 and health["promotions"] == 1
    assert health["reprobes"] >= 1 and health["journalReplays"] >= 2
    # the fallback is the port's native skip list, not the oracle
    assert {b for _v, _c, h, b in log if h == FAILED_OVER} == {"NativeConflictSet"}
    assert [c for _v, c, *_ in log[1:]] == [[1], [0], [0], [0]]


def test_loss_scenario_is_same_seed_reproducible():
    assert _loss_scenario(seed=43) == _loss_scenario(seed=43)


def test_encode_executor_fault_retried_in_place():
    loop = _sim(31)
    r, inj = _resolver(loop)
    fire = {"n": 1}

    def once():
        if fire["n"]:
            fire["n"] -= 1
            raise KernelTransientError("injected encode-executor error")

    inj.on_encode = once

    async def go():
        rep = await r.resolve(_req(0, 10, [(0, [], [(b"a", b"b")])]))
        assert rep.committed == [0]
        h = r.cs.health_snapshot()
        assert h["state"] == HEALTHY and h["retries"] == 1
        assert h["failovers"] == 0 and h["deviceRebuilds"] == 0
        k = r.stats.snapshot()["kernel"]
        assert k["encodeOverlapSeconds"]["count"] >= 1
        assert k["encodeQueueDepth"] == 0
        return True

    assert _run(loop, go(), 60.0)


def test_encode_hang_hits_deadline_and_recovers():
    loop = _sim(32)
    r, inj = _resolver(loop, knobs=Knobs(CONFLICT_DISPATCH_DEADLINE=1.5))
    referee = _FalseCommitOracle()

    async def go():
        req1 = _req(0, 10, [(0, [], [(b"a", b"b")])])
        rep = await r.resolve(req1)
        referee.check_batch(req1.transactions, rep.committed, 10)
        assert rep.committed == [0]
        fire = {"n": 1}

        def once():
            if fire["n"]:
                fire["n"] -= 1
                inj._pending_stall = float("inf")

        inj.on_encode = once
        t0 = loop.now()
        req2 = _req(10, 20, [(5, [(b"a", b"b")], [(b"a", b"b")])])
        rep = await r.resolve(req2)
        referee.check_batch(req2.transactions, rep.committed, 20)
        assert rep.committed == [1]
        assert loop.now() - t0 >= 1.5
        h = r.cs.health_snapshot()
        assert h["deadlineHits"] == 1 and h["faults"] >= 1
        return True

    assert _run(loop, go(), 120.0)


def test_device_loss_mid_overlap_zero_false_commits():
    loop = _sim(33)
    r, inj = _resolver(loop, knobs=Knobs(CONFLICT_FAILOVER_STRIKES=2), loss_duration=30.0)
    referee = _FalseCommitOracle()
    dispatches = {"n": 0}
    orig = inj.on_dispatch

    def lose_on_second(*a):
        dispatches["n"] += 1
        if dispatches["n"] == 2:
            inj.lose_device()
        orig()

    inj.on_dispatch = lose_on_second

    async def go():
        req1 = _req(0, 10, [(0, [], [(b"a", b"b")])])
        req2 = _req(10, 20, [(5, [(b"a", b"b")], [(b"c", b"d")])])
        f1 = spawn(r.resolve(req1))
        f2 = spawn(r.resolve(req2))
        rep1, rep2 = await f1, await f2
        referee.check_batch(req1.transactions, rep1.committed, 10)
        referee.check_batch(req2.transactions, rep2.committed, 20)
        assert rep1.committed == [0] and rep2.committed == [1]
        assert r.cs.health_snapshot()["faults"] >= 1
        assert r.cs.health == FAILED_OVER and r.cs.backend_name == "NativeConflictSet"
        req3 = _req(20, 30, [(15, [(b"c", b"d")], [(b"e", b"f")])])
        rep3 = await r.resolve(req3)
        referee.check_batch(req3.transactions, rep3.committed, 30)
        assert rep3.committed == [0]
        return True

    assert _run(loop, go(), 300.0)


# ---------------------------------------------------------------------------
# Faults while batches are pipelined: every batch spawned at once


def _pipelined(loop, gap, hang_at=(), lose_at=(), ecc_at=(), stall_at=(), pairs=False,
               n=30, deadline=1.0):
    """30 batches of 16 contending transactions, batch i spawned ``gap * i``
    seconds in (``gap * (i // 2)`` in pairs), with a hang, a device loss
    (0.3 s), a torch error of a lost card or a 0.5 s stall injected at the
    given dispatches. Returns the verdicts that differ from the oracle's
    over the same stream, the batches the false-commit referee rejects, and
    the guard's health snapshot."""
    knobs = Knobs(CONFLICT_FAILOVER_STRIKES=2, CONFLICT_REPROBE_INTERVAL=0.5,
                  CONFLICT_DISPATCH_DEADLINE=deadline)
    r, inj = _resolver(loop, knobs=knobs, loss_duration=0.3)
    count = {"n": 0}
    orig = inj.on_dispatch

    def on_dispatch():
        count["n"] += 1
        if count["n"] in hang_at:
            inj._pending_stall = float("inf")
        if count["n"] in stall_at:
            inj._pending_stall = 0.5
        if count["n"] in lose_at:
            inj.lose_device(0.3)
        if count["n"] in ecc_at:
            raise RuntimeError("CUDA error: uncorrectable ECC error encountered")
        orig()

    inj.on_dispatch = on_dispatch
    rs = np.random.RandomState(3)
    reqs = [_req(10 * i, 10 * (i + 1), _chaos_txns(rs, 10 * (i + 1), 16)) for i in range(n)]

    async def one(i, req):
        await delay(gap * (i // 2 if pairs else i))
        return await r.resolve(req)

    futs = [spawn(one(i, q)) for i, q in enumerate(reqs)]
    loop.run(until=600.0, stop_when=lambda: all(f.is_ready() for f in futs))
    r.close()
    oracle, referee = OracleConflictSet(), _FalseCommitOracle()
    wrong = rejected = 0
    for req, f in zip(reqs, futs):
        got = f.get().committed
        want = oracle.detect_batch(req.transactions, now=req.version, new_oldest_version=0)
        wrong += sum(int(a) != int(b) for a, b in zip(got, want))
        try:
            referee.check_batch(req.transactions, got, req.version)
        except AssertionError:
            rejected += 1
    return wrong, rejected, r.cs.health_snapshot()


@pytest.mark.parametrize(
    "gap,hang_at,lose_at",
    [(0.0, (5,), (13,)), (0.05, (5,), (13,)), (0.2, (5,), ()), (0.5, (5,), (13,)), (0.05, (), (8,))],
)
def test_pipelined_faults_give_the_oracles_verdicts(gap, hang_at, lose_at):
    """A hang or a device loss while later batches are in flight: the
    batches dispatched on the replaced backend are re-resolved in order, so
    every verdict equals the oracle's (exact) and none is a false commit.
    The JAX package's resolver gives wrong verdicts on the hang cases with
    a gap (its batches keep verdicts that miss the faulted batch's writes)."""
    wrong, rejected, health = _pipelined(_sim(21), gap, hang_at, lose_at)
    assert (wrong, rejected) == (0, 0)
    assert health["faults"] >= 1 and health["state"] in (HEALTHY, FAILED_OVER)
    assert health["backend"] in ("TorchConflictSet", "NativeConflictSet")


@pytest.mark.parametrize(
    "case",
    [dict(gap=0.01, hang_at=(4,), ecc_at=(12,), lose_at=(20,)),
     dict(gap=0.02, lose_at=(3,), pairs=True, n=60)],
    ids=["hang-ecc-loss", "loss-in-pairs"],
)
def test_pipelined_faults_on_a_real_loop(case):
    """The same on a RealLoop's threads, every batch spawned at once: a hang
    past the deadline, a lost card that torch reports as an ECC error and a
    device loss; or a loss in a stream that arrives in pairs, where the
    re-probe falls between two dispatches (the promoted backend must hold
    both). Exact oracle verdicts, no false commit."""
    loop = t_loop.RealLoop(22)
    t_loop.set_loop(loop)
    wrong, rejected, health = _pipelined(loop, deadline=0.5, **case)
    assert (wrong, rejected) == (0, 0)
    assert health["faults"] >= 2


# ---------------------------------------------------------------------------
# The same chaos scenario through both packages


def _chaos_txns(rs, version, n):
    out = []
    for _ in range(n):
        def ranges(k):
            a = rs.randint(0, 40, size=k)
            return [(b"c%03d" % x, b"c%03d" % (x + 1 + rs.randint(0, 4))) for x in a]

        snap = int(version - 10 * rs.randint(1, 4))
        out.append((snap, ranges(rs.randint(0, 3)), ranges(rs.randint(0, 3))))
    return out


_BACKENDS = {"TpuConflictSet": "TorchConflictSet"}


def _chaos(seed, jax):
    """Seeded device faults (errors, stalls, hangs, a device loss, encode
    faults) over 16 batches on a sim loop; returns each batch's verdicts and
    health, the final health snapshot and the injector's fault counts, with
    the JAX backend's class name mapped to the port's."""
    loop_mod, fut_mod, ifs = (j_loop, j_futures, j_if) if jax else (t_loop, None, t_if)
    loop = _sim(seed, loop_mod)
    knobs_cls, inj_cls, res_cls = (JKnobs, JInjector, JResolver) if jax else (Knobs, KernelFaultInjector, Resolver)
    knobs = knobs_cls(CONFLICT_FAILOVER_STRIKES=2, CONFLICT_REPROBE_INTERVAL=0.5,
                      CONFLICT_DISPATCH_DEADLINE=1.0)
    inj = inj_cls(loop.random.fork(), p_dispatch_error=0.15, p_device_loss=0.04, p_hang=0.04,
                  p_compile_stall=0.15, p_encode_error=0.1, p_encode_hang=0.03,
                  loss_duration=1.5, stall_seconds=0.2)
    kw = {"backend": "tpu1"} if jax else {"backend": "torch", "device": "cpu"}
    r = res_cls(knobs=knobs, uid="r0", fault_injector=inj, capacity=256, **kw)
    rs = np.random.RandomState(seed)
    referee = _FalseCommitOracle()
    log = []

    async def go():
        prev = 0
        for i in range(16):
            ver = 10 * (i + 1)
            req = _req(prev, ver, _chaos_txns(rs, ver, 12), ifs)
            rep = await r.resolve(req)
            referee.check_batch(req.transactions, rep.committed, ver)
            log.append((ver, list(rep.committed), r.cs.health))
            prev = ver
        return True

    assert _run(loop, go(), 600.0, spawn_fn=(fut_mod.spawn if jax else spawn))
    h = dict(r.cs.health_snapshot())
    h["backend"] = _BACKENDS.get(h["backend"], h["backend"])
    return log, h, dict(inj.counts)


@pytest.mark.parametrize("seed", [7, 8])
def test_chaos_scenario_equals_jax_with_the_same_seed(seed):
    got = _chaos(seed, jax=False)
    want = _chaos(seed, jax=True)
    assert got == want
    log, health, counts = got
    assert sum(counts.values()) > 0 and health["faults"] > 0  # faults did fire


# ---------------------------------------------------------------------------
# The fence: a missing card and unbuildable kernels are not kernel faults


def test_resolver_without_a_card_raises_instead_of_failing_over():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    _sim(1)
    for backend in ("torch", "torch_mesh"):
        with pytest.raises(errors.DeviceUnavailableError, match="CUDA"):
            Resolver(backend=backend, uid="r0")
        with pytest.raises(errors.DeviceUnavailableError):
            GuardedConflictSet(backend, device="cuda")


def test_kernel_build_failure_at_construction_raises(monkeypatch):
    def no_build(*a, **k):
        raise errors.KernelBuildError("nvcc failed for history.cu")

    monkeypatch.setattr(TorchConflictSet, "__init__", no_build)
    _sim(2)
    with pytest.raises(errors.KernelBuildError):
        Resolver(backend="torch", uid="r0", device="cpu")


def test_kernel_build_failure_at_dispatch_raises_out_of_resolve():
    """A kernel library that fails to build on the first dispatch leaves
    ``resolve`` as raised: no recovery, no failover, the version chain
    still advances."""
    loop = _sim(3)
    r, inj = _resolver(loop)
    orig = inj.on_dispatch

    def unbuildable():
        orig()
        raise errors.KernelBuildError("a kernel library did not load")

    inj.on_dispatch = unbuildable

    async def go():
        try:
            await r.resolve(_req(0, 10, [(0, [], [(b"a", b"b")])]))
        except errors.KernelBuildError:
            return "raised"
        return "resolved"

    assert _run(loop, go(), 60.0) == "raised"
    h = r.cs.health_snapshot()
    assert h["failovers"] == 0 and h["deviceRebuilds"] == 0 and h["faults"] == 0
    assert r.cs.backend_name == "TorchConflictSet"
    assert r.gate.version == 10 and r.reply_gate.version == 10


def test_warm_compile_build_failure_is_not_swallowed(monkeypatch):
    g = GuardedConflictSet("torch", device="cpu")

    def no_build():
        raise errors.KernelBuildError("nvcc not found")

    monkeypatch.setattr(g._cs, "warm_compile", no_build)
    with pytest.raises(errors.KernelBuildError):
        g.warm_compile()
    assert g.health == HEALTHY


def _defective_collect(r, err):
    """The backend's collect raises ``err`` once (after the dispatch ran)."""
    inner = r.cs._cs.inner
    dispatch = inner.detect_many_encoded_async
    fire = {"n": 1}

    def wrapped(work):
        handle = dispatch(work)
        if not fire["n"]:
            return handle
        fire["n"] -= 1

        def collect():
            handle()
            raise err

        return collect

    inner.detect_many_encoded_async = wrapped


@pytest.mark.parametrize("where", ["dispatch", "collect"])
def test_defect_at_launch_leaves_resolve_without_failover(where):
    """A CUDA error that is not a lost card (an illegal address, code 700)
    is a defect, not a kernel fault: ``resolve`` raises it, nothing recovers
    or fails over, and the version chain goes on."""
    loop = _sim(6)
    r, inj = _resolver(loop, knobs=Knobs(CONFLICT_FAILOVER_STRIKES=1))
    err = RuntimeError("fdb_history: CUDA error 700 at launch")
    if where == "dispatch":
        orig = inj.on_dispatch
        fire = {"n": 1}

        def once():
            orig()
            if fire["n"]:
                fire["n"] -= 1
                raise err

        inj.on_dispatch = once
    else:
        _defective_collect(r, err)

    async def go():
        try:
            await r.resolve(_req(0, 10, [(0, [], [(b"a", b"b")])]))
        except RuntimeError as e:
            assert e is err
        else:
            return "resolved"
        rep = await r.resolve(_req(10, 20, [(15, [(b"x", b"y")], [(b"x", b"y")])]))
        return rep.committed

    assert _run(loop, go(), 60.0) == [0]
    h = r.cs.health_snapshot()
    assert h["failovers"] == 0 and h["faults"] == 0 and h["deviceRebuilds"] == 0
    assert h["state"] == HEALTHY and r.cs.backend_name == "TorchConflictSet"
    assert r.gate.version == 20 and r.reply_gate.version == 20


def test_lost_card_error_from_torch_is_a_kernel_fault():
    """A torch error that says the card is gone (ECC) is a device loss: the
    batch recovers on a rebuilt backend with its verdict intact."""
    loop = _sim(7)
    r, _inj = _resolver(loop)
    _defective_collect(r, RuntimeError("CUDA error: uncorrectable ECC error encountered"))

    async def go():
        await r.resolve(_req(0, 10, [(0, [], [(b"a", b"b")])]))
        rep = await r.resolve(_req(10, 20, [(5, [(b"a", b"b")], [(b"a", b"b")])]))
        return rep.committed

    # the first batch faulted at collect and recovered: its write conflicts
    assert _run(loop, go(), 60.0) == [1]
    h = r.cs.health_snapshot()
    assert h["faults"] == 1 and h["deviceRebuilds"] == 1 and h["failovers"] == 0
    assert h["state"] == HEALTHY


@pytest.mark.parametrize(
    "code,fault",
    [(46, errors.KernelDeviceLostError), (214, errors.KernelDeviceLostError),
     (702, errors.KernelTimeoutError), (700, None), (719, None), (1, None)],
)
def test_launch_error_codes_map_to_faults(monkeypatch, code, fault):
    """The wrappers raise a kernel fault for a lost or silent card and a
    plain RuntimeError for anything else; ``as_kernel_fault`` reads the same
    errors out of torch's messages and never takes a missing card."""
    from foundationdb_tpu_torch.conflict import kernels
    from foundationdb_tpu_torch.conflict.kernels import build

    monkeypatch.setattr(build, "load", lambda: {"fdb_x": lambda: code})
    with pytest.raises(fault or RuntimeError) as e:
        kernels._run("fdb_x")
    assert (errors.as_kernel_fault(e.value) is None) == (fault is None)
    assert errors.as_kernel_fault(errors.KernelBuildError("no CUDA-capable device is detected")) is None
    assert errors.as_kernel_fault(ValueError("x")) is None


def test_warm_failure_raises_out_of_the_first_resolve(monkeypatch):
    """A warm-up that raises anything but a kernel fault fails the first
    batch (not a SevWarn trace and a resolver that carries on)."""

    def broken(self):
        raise RuntimeError("fdb_merge: CUDA error 700 at launch")

    monkeypatch.setattr(TorchConflictSet, "warm_compile", broken)
    loop = _sim(8)
    r, _inj = _resolver(loop)

    async def go():
        try:
            await r.resolve(_req(0, 10, [(0, [], [(b"a", b"b")])]))
        except RuntimeError:
            return "raised"
        return "resolved"

    assert _run(loop, go(), 60.0) == "raised"
    assert r.cs.health_snapshot()["failovers"] == 0 and r.reply_gate.version == 10


def test_running_kernel_fault_keeps_failover(monkeypatch):
    """A fault of a running backend is still the system's fault tolerance:
    strikes escalate to the port's native skip list."""
    loop = _sim(4)
    r, inj = _resolver(loop, knobs=Knobs(CONFLICT_FAILOVER_STRIKES=1))
    inj.lose_device(100.0)

    async def go():
        rep = await r.resolve(_req(0, 10, [(0, [], [(b"a", b"b")])]))
        return rep.committed

    assert _run(loop, go(), 60.0) == [0]
    assert r.cs.health == FAILED_OVER and r.cs.backend_name == "NativeConflictSet"
