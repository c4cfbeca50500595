"""The port's runtime (foundationdb_tpu_torch/runtime) held against the JAX
package's: one seed gives the same DeterministicRandom stream, the same
randomized Knobs (the conflict-set backend name aside), the same buggify
decisions, the same loop ordering, futures behaviour and trace events.
Every comparison is exact equality."""

import pytest
import torch

from foundationdb_tpu.runtime import buggify as j_buggify
from foundationdb_tpu.runtime import futures as j_futures
from foundationdb_tpu.runtime import knobs as j_knobs
from foundationdb_tpu.runtime import loop as j_loop
from foundationdb_tpu.runtime import rng as j_rng
from foundationdb_tpu.runtime import stats as j_stats
from foundationdb_tpu.runtime import trace as j_trace
from foundationdb_tpu_torch.runtime import buggify as t_buggify
from foundationdb_tpu_torch.runtime import futures as t_futures
from foundationdb_tpu_torch.runtime import knobs as t_knobs
from foundationdb_tpu_torch.runtime import loop as t_loop
from foundationdb_tpu_torch.runtime import rng as t_rng
from foundationdb_tpu_torch.runtime import stats as t_stats
from foundationdb_tpu_torch.runtime import trace as t_trace
from foundationdb_tpu_torch.runtime.timeseries import MetricsHistory

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

# (rng, knobs, loop, futures, trace, buggify, stats) of each package
JAX = (j_rng, j_knobs, j_loop, j_futures, j_trace, j_buggify, j_stats)
PORT = (t_rng, t_knobs, t_loop, t_futures, t_trace, t_buggify, t_stats)


def _stream(rng_mod, seed):
    r = rng_mod.DeterministicRandom(seed)
    out = [r.random01(), r.random_int(3, 1000), r.random_choice("abcdefg"),
           r.random_unique_id(), r.coinflip(0.3)]
    lst = list(range(20))
    r.shuffle(lst)
    out.append(lst)
    f = r.fork()
    out += [f.random01(), f.random_int(0, 1 << 40), r.random01()]
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**40 + 3])
def test_deterministic_random_stream_equals_jax(seed):
    got = _stream(t_rng, seed)
    assert got == _stream(j_rng, seed)
    assert got != _stream(t_rng, seed + 1)


def _randomized(mods, seed):
    rng_mod, knobs_mod = mods[0], mods[1]
    r = rng_mod.DeterministicRandom(seed)
    k = knobs_mod.Knobs()
    for step in ("randomize", "randomize_admission", "randomize_transport",
                 "randomize_storage_engine", "randomize_watches", "randomize_prefilter",
                 "randomize_read_pipeline", "randomize_commit_path",
                 "randomize_storage_metrics"):
        getattr(k, step)(r)
    d = k.as_dict()
    backend = d.pop("CONFLICT_SET_BACKEND")
    return d, backend, r.random01()


@pytest.mark.parametrize("seed", [0, 3, 99, 2024])
def test_randomized_knobs_equal_jax_but_for_the_backend_name(seed):
    got, backend, tail = _randomized(PORT, seed)
    want, j_backend, j_tail = _randomized(JAX, seed)
    assert got == want
    assert tail == j_tail  # the same number of draws
    assert (backend, j_backend) == ("torch", "tpu")


def test_knob_defaults_and_overrides():
    assert t_knobs.Knobs().as_dict().keys() == j_knobs.Knobs().as_dict().keys()
    k = t_knobs.Knobs(CONFLICT_ENCODE_THREADS=0, CONFLICT_SET_BACKEND="torch_mesh")
    assert (k.CONFLICT_ENCODE_THREADS, k.CONFLICT_SET_BACKEND) == (0, "torch_mesh")
    with pytest.raises(KeyError):
        t_knobs.Knobs(NOT_A_KNOB=1)


def _buggify_trace(mods, seed):
    b = mods[5].Buggify(mods[0].DeterministicRandom(seed), p_enabled=0.5, p_fire=0.5)
    return [b(("site", i % 13)) for i in range(200)], sorted(b.fired)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_buggify_decisions_equal_jax(seed):
    assert _buggify_trace(PORT, seed) == _buggify_trace(JAX, seed)
    assert not t_buggify.Buggify(None)(("site", 0))  # off outside simulation


def _loop_run(mods, seed):
    """Callbacks at several times and priorities, actors that await delays,
    futures, a timeout and a version gate, and trace events with spans:
    returns the order things ran in and the trace log."""
    _rng, _knobs, loop_mod, fut_mod, trace_mod, _b, stats_mod = mods
    log = trace_mod.TraceLog()
    trace_mod.set_trace_log(log)
    loop = loop_mod.EventLoop(seed)
    loop_mod.set_loop(loop)
    order = []
    P = loop_mod.TaskPriority
    for i, (t, pri) in enumerate([(0.5, P.DEFAULT), (0.1, P.LOW), (0.1, P.RESOLVER),
                                  (0.0, P.MAX), (0.1, P.RESOLVER), (0.3, P.ZERO)]):
        loop.call_at(t, lambda i=i: order.append(("cb", i, loop.now())), pri)
    gate = fut_mod.VersionGate(0)
    stats = stats_mod.CounterCollection("Test", "t0")

    async def actor(name, n):
        for k in range(n):
            await fut_mod.delay(loop.random.random01() * 0.2)
            order.append((name, k, round(loop.now(), 9)))
            stats.counter("steps").add()
            stats.latency("lat").add(loop.random.random01())
            stats.bands("band").add(loop.random.random01() * 0.01)
            trace_mod.trace(trace_mod.SevInfo, "Step", "p0", Actor=name, K=k)
        return name

    async def gated(v, prev):
        await gate.wait_until(prev)
        order.append(("gate", v, round(loop.now(), 9)))
        gate.advance_to(v)

    async def timed():
        never = fut_mod.Future()
        r = await fut_mod.timeout(never, 0.25, default="timed-out")
        order.append(("timeout", r, round(loop.now(), 9)))
        with trace_mod.span("child", "p0", parent=trace_mod.root_context("tr1")) as sp:
            sp.tag(k=1)
            await fut_mod.delay(0.05)
        trace_mod.emit_span("emitted", "p0", trace_mod.root_context("tr2"), 0.0, 0.5, x=2)

    futs = [fut_mod.spawn(actor(n, 4)) for n in ("a", "b", "c")]
    futs += [fut_mod.spawn(gated(v, v - 1)) for v in (3, 1, 2)]
    futs.append(fut_mod.spawn(timed()))
    c = fut_mod.spawn(fut_mod.forever())
    c.cancel()
    loop.run(until=10.0)
    assert all(f.is_ready() for f in futs)
    assert isinstance(c._error, loop_mod.Cancelled)
    snap = stats.snapshot()
    return order, log.events, snap, futs[0].get()


@pytest.mark.parametrize("seed", [0, 5, 77])
def test_loop_ordering_futures_and_trace_events_equal_jax(seed):
    logs = (t_trace.trace_log(), j_trace.trace_log())
    try:
        got = _loop_run(PORT, seed)
        want = _loop_run(JAX, seed)
    finally:
        t_loop.set_loop(None)
        j_loop.set_loop(None)
        t_trace.set_trace_log(logs[0])
        j_trace.set_trace_log(logs[1])
    assert got == want
    order, events = got[0], got[1]
    assert [o[1] for o in order if o[0] == "gate"] == [1, 2, 3]
    assert ("timeout", "timed-out", 0.25) in order
    assert {e["Type"] for e in events} == {"Step", "Span"}


def test_cancelled_keeps_one_identity_across_port_modules():
    assert t_futures.Cancelled is t_loop.Cancelled
    from foundationdb_tpu_torch.conflict import failover
    from foundationdb_tpu_torch.server import resolver

    with pytest.raises(t_loop.Cancelled):  # the guard lets a cancellation through
        failover.fault_of(t_futures.Cancelled())
    assert resolver.Cancelled is t_loop.Cancelled
    assert t_loop.Cancelled is not j_loop.Cancelled


def test_real_loop_post_and_external_work_from_another_thread():
    import threading

    loop = t_loop.RealLoop(seed=1)
    t_loop.set_loop(loop)
    try:
        got = []
        loop.external_begin()

        def worker():
            loop.post(lambda: (got.append("posted"), loop.external_end()))

        threading.Thread(target=worker).start()
        loop.run(until=5.0, stop_when=lambda: bool(got))
        assert got == ["posted"]
        assert loop._external_pending == 0
    finally:
        t_loop.set_loop(None)
        loop.close()


def test_stats_snapshot_and_history_equal_jax():
    from foundationdb_tpu.runtime.timeseries import MetricsHistory as JHistory

    def fill(stats_mod, hist_cls):
        c = stats_mod.CounterCollection("R", "r0")
        c.counter("n").add(3)
        for i in range(2000):
            c.latency("lat", cap=64).add(i * 1e-4)
            c.bands("b").add(i * 1e-4)
        c.gauge("g", lambda: 7)
        c.gauge("bad", lambda: 1 / 0)
        h = hist_cls(4)
        for t in range(6):
            h.record(float(t), c.snapshot())
        return c.snapshot(), h.to_dict(), stats_mod.LatencyBands.merge([c.snapshot()["b"]] * 2)

    assert fill(t_stats, MetricsHistory) == fill(j_stats, JHistory)
