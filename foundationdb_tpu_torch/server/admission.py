"""GRV admission control: priority classes, token buckets, bounded queues.

The proxy side of Ratekeeper-grade admission.
The analog of the reference's transactionStarter rate limiting
(fdbserver/MasterProxyServer.actor.cpp:925) grown to GrvProxy-era shape:

- three priority classes (batch / default / immediate — the reference's
  PRIORITY_BATCH / PRIORITY_DEFAULT / PRIORITY_SYSTEM_IMMEDIATE), each
  with its own token bucket replenished from the Ratekeeper's per-class
  per-proxy rate grant;
- per-tenant token buckets keyed off the tenant id in the GRV envelope,
  so one hot tenant cannot starve the rest of its class;
- a BOUNDED queue per class with deadline-based shedding: a waiter that
  cannot be admitted before its deadline (or that arrives to a full
  queue) fails with the typed retryable ``grv_throttled`` error instead
  of parking forever — load sheds, latency does not collapse. Shed order
  follows class deadlines: batch first, then default, then immediate
  (admission order is the reverse: immediate drains first).

The old shape — one scalar budget and an unbounded FIFO park on
``_grv_replenished`` — queued into collapse under overload: every waiter
eventually got a token, seconds late, and goodput went to zero-useful.
"""

from __future__ import annotations

from collections import deque

from ..errors import GrvThrottled
from ..net.sim import BrokenPromise
from ..runtime.futures import AsyncTrigger, Future, delay, wait_for_any
from ..runtime.loop import Cancelled, now

# transaction priority classes (fdbclient/FDBTypes.h TransactionPriority)
PRIORITY_BATCH = 0
PRIORITY_DEFAULT = 1
PRIORITY_IMMEDIATE = 2

PRIORITY_NAMES = {
    PRIORITY_BATCH: "batch",
    PRIORITY_DEFAULT: "default",
    PRIORITY_IMMEDIATE: "immediate",
}
PRIORITY_BY_NAME = {v: k for k, v in PRIORITY_NAMES.items()}

# admission drains immediate first; shedding therefore lands on batch
# first (its deadline is shortest and its bucket empties first)
ADMIT_ORDER = (PRIORITY_IMMEDIATE, PRIORITY_DEFAULT, PRIORITY_BATCH)


def coerce_priority(p) -> int:
    """Accept the int constants or their names ("batch"/"default"/
    "immediate"); anything unrecognized clamps to default."""
    if isinstance(p, str):
        return PRIORITY_BY_NAME.get(p, PRIORITY_DEFAULT)
    try:
        p = int(p)
    except (TypeError, ValueError):
        return PRIORITY_DEFAULT
    return min(max(p, PRIORITY_BATCH), PRIORITY_IMMEDIATE)


class TokenBucket:
    """Continuous-refill token bucket (the reference's Smoother-fed GRV
    budget). ``rate`` is tokens/second; capacity bounds the burst."""

    __slots__ = ("rate", "capacity", "tokens", "last")

    def __init__(self):
        self.rate = 0.0
        self.capacity = 1.0
        self.tokens = 0.0
        self.last = None

    def set_rate(self, rate: float, t: float, burst_s: float) -> None:
        self.refill(t)
        self.rate = max(float(rate), 0.0)
        # at least one token of burst so a trickle-rate class still
        # admits whole requests
        self.capacity = max(self.rate * burst_s, 1.0)
        self.tokens = min(self.tokens, self.capacity)

    def refill(self, t: float) -> None:
        if self.last is None:
            self.last = t
            return
        if t > self.last:
            self.tokens = min(
                self.tokens + self.rate * (t - self.last), self.capacity
            )
            self.last = t

    def peek(self, t: float) -> bool:
        self.refill(t)
        return self.tokens >= 1.0

    def take(self, n: float = 1.0) -> None:
        # may go negative: a coalesced GRV admits all-or-nothing for its
        # n transactions and the bucket repays the debt from future
        # refills (the reference's budget-debt shape) — long-run rate
        # stays exact without starving large batches behind the capacity
        self.tokens -= n


class GrvAdmission:
    """Per-proxy admission state: class buckets, tenant buckets, bounded
    queues, and the pump actor that drains them in priority order.

    ``rates is None`` means ungated (no Ratekeeper grant yet, or the
    master died: a throttled client must not hang across a recovery).
    """

    def __init__(self, knobs, stats):
        self.knobs = knobs
        self.rates = None  # {"batch"/"default"/"immediate": per-proxy tps}
        self.buckets = {c: TokenBucket() for c in PRIORITY_NAMES}
        self.tenant_buckets: dict[str, TokenBucket] = {}
        self._tenant_seen: dict[str, float] = {}  # tenant → last use
        self.queues: dict[int, deque] = {c: deque() for c in PRIORITY_NAMES}
        self.work = AsyncTrigger()
        self.failed = False
        # ProxyStats additions: admitted / throttled per class, queue
        # gauges, per-tenant roll-up (aggregated into status `qos`)
        self._c_admitted = {
            c: stats.counter("txnStart" + PRIORITY_NAMES[c].capitalize())
            for c in PRIORITY_NAMES
        }
        self._c_throttled = {
            c: stats.counter("grvThrottled" + PRIORITY_NAMES[c].capitalize())
            for c in PRIORITY_NAMES
        }
        self._c_throttled_total = stats.counter("grvThrottled")
        self._l_queue = stats.latency("grvQueueLatency")
        stats.gauge("grvQueued", lambda: {
            PRIORITY_NAMES[c]: len(q) for c, q in self.queues.items()
        })
        stats.gauge("grvRates", lambda: dict(self.rates) if self.rates else None)
        # tenant → [admitted, throttled]; surfaced top-N by traffic
        self.tenant_stats: dict[str, list] = {}
        stats.gauge("tenants", self._tenant_snapshot)

    # -- rate grants -----------------------------------------------------------

    def set_rates(self, per_proxy) -> None:
        """Install a Ratekeeper grant ({class: tps}, already split across
        proxies) or disable gating entirely (None)."""
        if per_proxy is None:
            self.rates = None
            self.work.trigger()  # pump admits every waiter ungated
            return
        t = now()
        burst = 2.0 * self.knobs.RK_POLL_INTERVAL
        self.rates = {
            name: max(float(per_proxy.get(name, 0.0)), 0.0)
            for name in PRIORITY_BY_NAME
        }
        for c, name in PRIORITY_NAMES.items():
            self.buckets[c].set_rate(self.rates[name], t, burst)
        tenant_rate = self._tenant_rate()
        for b in self.tenant_buckets.values():
            b.set_rate(tenant_rate, t, burst)
        # GC idle tenants so the bucket map stays bounded by live traffic
        cutoff = t - 10.0 * self.knobs.RK_POLL_INTERVAL
        for tenant, seen in list(self._tenant_seen.items()):
            if seen < cutoff:
                self._tenant_seen.pop(tenant, None)
                self.tenant_buckets.pop(tenant, None)
        self.work.trigger()

    def _tenant_rate(self) -> float:
        # each tenant's share of the DEFAULT class rate: a fair-share cap,
        # not a reservation — the class bucket still bounds the total
        if not self.rates:
            return 0.0
        return max(
            self.rates["default"] * self.knobs.RK_TENANT_MAX_SHARE, 0.1
        )

    def _tenant_bucket(self, tenant: str):
        b = self.tenant_buckets.get(tenant)
        if b is None:
            b = self.tenant_buckets[tenant] = TokenBucket()
            b.set_rate(
                self._tenant_rate(), now(), 2.0 * self.knobs.RK_POLL_INTERVAL
            )
            # a fresh tenant starts with a full burst (first requests are
            # not penalized for the bucket's birth)
            b.tokens = b.capacity
        return b

    # -- admission -------------------------------------------------------------

    def _try_take(self, cls: int, tenant: str, t: float, n: float) -> bool:
        # hierarchical limits (the reference's batch-rate ≤ normal-rate
        # shape): a BATCH admission draws from the batch bucket AND the
        # default bucket, so batch+default together never exceed the
        # default-class grant; immediate rides its own bucket only
        b = self.buckets[cls]
        if not b.peek(t):
            return False
        parent = (
            self.buckets[PRIORITY_DEFAULT] if cls == PRIORITY_BATCH else None
        )
        if parent is not None and not parent.peek(t):
            return False
        if tenant and cls != PRIORITY_IMMEDIATE:
            # immediate class is exempt from tenant fair-share (system
            # traffic: probes, DD) — it is already the scarcest grant
            tb = self._tenant_bucket(tenant)
            if not tb.peek(t):
                return False
            tb.take(n)
        b.take(n)
        if parent is not None:
            parent.take(n)
        return True

    def _deadline(self, cls: int, t: float) -> float:
        base = self.knobs.RK_GRV_QUEUE_TIMEOUT
        mult = {PRIORITY_BATCH: 0.5, PRIORITY_DEFAULT: 1.0,
                PRIORITY_IMMEDIATE: 2.0}[cls]
        return t + base * mult

    def _note_tenant(self, tenant: str, admitted: bool, n: int = 1) -> None:
        if not tenant:
            return
        s = self.tenant_stats.get(tenant)
        if s is None:
            # bound the stats map: evict the coldest tenant at capacity
            if len(self.tenant_stats) >= 4 * self.knobs.RK_STATUS_TENANTS:
                coldest = min(self.tenant_stats, key=lambda k: sum(self.tenant_stats[k]))
                self.tenant_stats.pop(coldest, None)
            s = self.tenant_stats[tenant] = [0, 0]
        s[0 if admitted else 1] += n

    def _tenant_snapshot(self) -> dict:
        top = sorted(
            self.tenant_stats.items(), key=lambda kv: -(kv[1][0] + kv[1][1])
        )[: self.knobs.RK_STATUS_TENANTS]
        return {
            tenant: {"admitted": s[0], "throttled": s[1]} for tenant, s in top
        }

    def _shed(self, cls: int, tenant: str, reason: str, n: int = 1):
        self._c_throttled[cls].add(n)
        self._c_throttled_total.add(n)
        self._note_tenant(tenant, admitted=False, n=n)
        return GrvThrottled(
            f"grv_throttled: {PRIORITY_NAMES[cls]} class {reason}"
        )

    async def admit(self, priority, tenant: str, count: int = 1) -> float:
        """Admit one (possibly client-coalesced) GRV carrying ``count``
        transactions — debiting that many tokens — or raise GrvThrottled
        / BrokenPromise. Returns the queue wait in seconds (0.0 =
        admitted on arrival). The caller re-checks proxy liveness."""
        cls = coerce_priority(priority)
        tenant = tenant or ""
        n = max(int(count), 1)
        if tenant:
            self._tenant_seen[tenant] = now()
        if self.rates is None or self.failed:
            # ungated (no ratekeeper / dead master) — the caller's
            # _check_alive covers the failed-proxy case
            self._c_admitted[cls].add(n)
            self._note_tenant(tenant, admitted=True, n=n)
            return 0.0
        t = now()
        q = self.queues[cls]
        if not q and self._try_take(cls, tenant, t, n):
            self._c_admitted[cls].add(n)
            self._note_tenant(tenant, admitted=True, n=n)
            return 0.0
        if len(q) >= self.knobs.RK_GRV_QUEUE_MAX:
            raise self._shed(cls, tenant, "queue full", n)
        fut: Future = Future()
        entry = (self._deadline(cls, t), tenant, fut, n)
        q.append(entry)
        self.work.trigger()
        try:
            await fut  # admitted (set) or shed/died (error)
        except Cancelled:
            # the caller's actor died while parked: drop the entry so the
            # pump never admits (and burns tokens for) a ghost. Re-fetch
            # the deque — _drain rebuilds it, so the local alias may be
            # stale. (The pump also skips already-ready futures, so a
            # missed removal is still harmless.)
            try:
                self.queues[cls].remove(entry)
            except ValueError:
                pass
            raise
        wait = now() - t
        self._l_queue.add(wait)
        self._c_admitted[cls].add(n)
        self._note_tenant(tenant, admitted=True, n=n)
        return wait

    # -- pump ------------------------------------------------------------------

    def _drain(self) -> None:
        """Admit in priority order (immediate → default → batch), shed
        expired waiters, skip cancelled ones. One pass per class: an
        entry whose TENANT bucket is dry is skipped over, not parked at
        the head — head-of-line FIFO across tenants would let one hot
        tenant's queue block every other tenant in its class, which is
        exactly the starvation the per-tenant buckets exist to prevent.
        Order is preserved within each tenant (entries keep queue order)."""
        t = now()
        for cls in ADMIT_ORDER:
            q = self.queues[cls]
            if not q:
                continue
            kept = deque()
            while q:
                entry = q.popleft()
                deadline, tenant, fut, n = entry
                if fut.is_ready():  # cancelled while parked
                    continue
                if self.failed:
                    fut._set_error(
                        BrokenPromise("proxy died with GRV parked at the rate gate")
                    )
                    continue
                if self.rates is None:
                    fut._set(None)
                    continue
                if self._try_take(cls, tenant, t, n):
                    fut._set(None)
                    continue
                if t >= deadline:
                    fut._set_error(self._shed(cls, tenant, "deadline", n))
                    continue
                kept.append(entry)
            self.queues[cls] = kept

    def has_waiters(self) -> bool:
        return any(self.queues[c] for c in PRIORITY_NAMES)

    async def pump(self):
        """Proxy actor: wakes on new work / new rates and on a fixed tick
        while waiters are parked (token accrual + deadline expiry are
        continuous; the tick discretizes them)."""
        while not self.failed:
            self._drain()
            if not self.has_waiters():
                await self.work.on_trigger()
                continue
            await wait_for_any(
                [delay(self.knobs.RK_ADMISSION_TICK), self.work.on_trigger()]
            )

    def fail_all(self) -> None:
        """Proxy death (epoch ended / role retired): every parked waiter
        must observe it promptly instead of outliving the role."""
        self.failed = True
        for q in self.queues.values():
            while q:
                _d, _tenant, fut, _n = q.popleft()
                if not fut.is_ready():
                    fut._set_error(
                        BrokenPromise("proxy died with GRV parked at the rate gate")
                    )
        self.work.trigger()
