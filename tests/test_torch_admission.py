"""The port's GRV admission (foundationdb_tpu_torch/server/admission.py) held
against the JAX package's: ``coerce_priority`` over every kind of input, a
seeded ``TokenBucket`` sequence, and ``GrvAdmission`` on each package's
sim loop under seeded GRV arrivals (priority classes, tenants, coalesced
counts), rate grants, queue overflow, deadline shedding, a cancelled
waiter and the proxy's death. The grants are the Ratekeeper's: the JAX
package's ``compute_rates`` (server/data_distribution.py, which the port
does not have yet) turns seeded health signals into per-class rates, and
both packages' admissions take the same grants. Every outcome (queue wait
or error class), every bucket's state and every counter must be equal:
the tolerance is exact."""

import numpy as np
import pytest
import torch

from foundationdb_tpu.runtime import futures as j_futures
from foundationdb_tpu.runtime import loop as j_loop
from foundationdb_tpu.runtime.knobs import Knobs as JKnobs
from foundationdb_tpu.runtime.stats import CounterCollection as JCounters
from foundationdb_tpu.server import admission as j_adm
from foundationdb_tpu.server.data_distribution import compute_rates
from foundationdb_tpu_torch.runtime import futures as t_futures
from foundationdb_tpu_torch.runtime import loop as t_loop
from foundationdb_tpu_torch.runtime.knobs import Knobs
from foundationdb_tpu_torch.runtime.stats import CounterCollection
from foundationdb_tpu_torch.server import admission as t_adm

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

PORT = (t_loop, t_futures, Knobs, CounterCollection, t_adm)
JAX = (j_loop, j_futures, JKnobs, JCounters, j_adm)


@pytest.fixture(autouse=True)
def _no_loop_left():
    yield
    t_loop.set_loop(None)
    j_loop.set_loop(None)


def test_priority_classes_and_coercion_equal_the_jax_package():
    inputs = [0, 1, 2, -5, 7, "batch", "default", "immediate", "bogus", None, 1.9, "2", [], object]
    assert [t_adm.coerce_priority(x) for x in inputs] == [j_adm.coerce_priority(x) for x in inputs]
    for name in ("PRIORITY_BATCH", "PRIORITY_DEFAULT", "PRIORITY_IMMEDIATE", "PRIORITY_NAMES",
                 "PRIORITY_BY_NAME", "ADMIT_ORDER"):
        assert getattr(t_adm, name) == getattr(j_adm, name), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_sequence_equals_the_jax_package(seed):
    rs = np.random.RandomState(seed)
    ops = []
    t = 0.0
    for _ in range(300):
        t += float(rs.exponential(0.05))
        k = rs.randint(4)
        ops.append((k, t, float(rs.choice([0.0, 0.5, 3.0, 80.0, 1e4])), float(rs.choice([0.1, 1.0, 4.0]))))
    got = []
    for adm in (t_adm, j_adm):
        b, trace = adm.TokenBucket(), []
        for k, t, x, y in ops:
            if k == 0:
                b.set_rate(x, t, y)
            elif k == 1:
                b.refill(t)
            elif k == 2:
                trace.append(b.peek(t))
            else:
                b.take(y)
            trace.append((b.rate, b.capacity, b.tokens, b.last))
        got.append(trace)
    assert got[0] == got[1]


SIGNALS = [
    dict(version_lag=0, durability_lag=0, tlog_queue_bytes=0, busy_fraction=0.1,
         band_overrun=0.0, kernel_state="HEALTHY"),
    dict(version_lag=3_500_000, durability_lag=0, tlog_queue_bytes=0, busy_fraction=0.2,
         band_overrun=0.0, kernel_state="HEALTHY"),
    dict(version_lag=0, durability_lag=0, tlog_queue_bytes=0, busy_fraction=0.1,
         band_overrun=0.3, kernel_state="DEGRADED"),
    dict(version_lag=6_000_000, durability_lag=9_000_000, tlog_queue_bytes=1 << 30,
         busy_fraction=0.99, band_overrun=0.9, kernel_state="FAILED_OVER"),
]


def _grants(knobs, n_proxies=2):
    """Per-proxy grants from the Ratekeeper's controller, one per signal
    set, healthy to overloaded."""
    out = []
    for sig in SIGNALS:
        rates, _limiting = compute_rates(knobs, dict(sig))
        out.append({c: r / n_proxies for c, r in rates.items()})
    return out


def _drive(mods, seed, grants, knob_kw):
    """Seeded GRV arrivals through one GrvAdmission and its pump on the
    package's sim loop: returns each request's outcome, the buckets, the
    counters and the clock."""
    loop_mod, fut_mod, knobs_cls, counters_cls, adm = mods
    loop = loop_mod.EventLoop(seed)
    loop_mod.set_loop(loop)
    knobs = knobs_cls(**knob_kw)
    stats = counters_cls("Proxy", "p0")
    a = adm.GrvAdmission(knobs, stats)
    rs = np.random.RandomState(seed)
    outcomes = {}

    async def one(i, prio, tenant, count):
        try:
            outcomes[i] = ("ok", await a.admit(prio, tenant, count))
        except Exception as e:
            outcomes[i] = ("error", type(e).__name__)

    async def main():
        pump = fut_mod.spawn(a.pump())
        a.set_rates(grants[0])
        reqs = []
        for step in range(6):
            if step in (1, 3, 4):
                a.set_rates(grants[step % len(grants)])
            for _ in range(40):
                i = len(reqs)
                prio = int(rs.choice([0, 1, 1, 2]))
                tenant = str(rs.choice(["", "", "t1", "t2", "t3"]))
                reqs.append(fut_mod.spawn(one(i, prio, tenant, int(rs.choice([1, 1, 3, 8])))))
                await fut_mod.delay(float(rs.exponential(0.004)))
            if step == 2:
                reqs[-1].cancel()  # a client actor that died while parked
                outcomes.setdefault(len(reqs) - 1, ("cancelled",))
        await fut_mod.delay(0.3)
        a.set_rates(None)  # ungated: every waiter admitted
        for _ in range(5):
            i = len(reqs)
            reqs.append(fut_mod.spawn(one(i, 0, "t1", 1)))
        a.set_rates(grants[-1])
        for _ in range(30):  # parked behind a starved grant, then the proxy dies
            i = len(reqs)
            reqs.append(fut_mod.spawn(one(i, 0, "t2", 4)))
        await fut_mod.delay(0.01)
        a.fail_all()
        await fut_mod.delay(0.1)
        pump.cancel()
        return len(reqs)

    main_fut = fut_mod.spawn(main())
    loop.run(until=60.0, stop_when=main_fut.is_ready)
    n = main_fut.get()
    buckets = {c: (b.rate, b.capacity, b.tokens, b.last) for c, b in a.buckets.items()}
    tenants = {t: (b.rate, b.capacity, b.tokens, b.last) for t, b in a.tenant_buckets.items()}
    snap = stats.snapshot()
    return [outcomes.get(i) for i in range(n)], buckets, tenants, snap, a.tenant_stats, loop.now()


@pytest.mark.parametrize("knob_kw", [
    {},
    {"RK_GRV_QUEUE_MAX": 6, "RK_GRV_QUEUE_TIMEOUT": 0.02},
    {"RK_TENANT_MAX_SHARE": 0.05, "RK_ADMISSION_TICK": 0.003},
], ids=["default", "tight-queue", "tenant-share"])
@pytest.mark.parametrize("seed", [0, 1])
def test_grv_admission_equals_the_jax_package(seed, knob_kw):
    grants = _grants(JKnobs(**knob_kw))
    port = _drive(PORT, seed, grants, knob_kw)
    ref = _drive(JAX, seed, grants, knob_kw)
    assert port[0] == ref[0]
    for i, part in enumerate(("buckets", "tenant buckets", "counters", "tenant stats", "clock"), 1):
        assert port[i] == ref[i], part
    kinds = {o[0] if o[0] != "error" else o[1] for o in port[0]}
    # the run reached every path: admitted, shed, and the proxy's death
    assert {"ok", "BrokenPromise"} <= kinds, kinds
    if "RK_GRV_QUEUE_MAX" in knob_kw:
        assert "GrvThrottled" in kinds, kinds
    assert any(o[0] == "ok" and o[1] > 0 for o in port[0])  # some waited in the queue
