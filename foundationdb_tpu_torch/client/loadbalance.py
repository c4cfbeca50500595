"""Client-side replica selection: latency model + hedged second request.

The analog of fdbrpc/LoadBalance.actor.h:158 loadBalance + QueueModel
(fdbrpc/QueueModel.cpp): per-replica state (latency EWMA, outstanding
requests, penalty/backoff window after failures) orders the team by
expected queueing cost, and a SECOND request is hedged to the next-best
replica when the first outlives its expected latency — tail reads ride
the healthy replica instead of a stalled one.
"""

from __future__ import annotations

from ..errors import FutureVersion, WrongShardServer
from ..net.sim import BrokenPromise, Endpoint
from ..runtime.futures import delay, settled, wait_for_any
from ..runtime.loop import Cancelled, now
from ..runtime.trace import annotate as _annotate, span

_ROTATE = (BrokenPromise, WrongShardServer)

MAX_READ_ATTEMPTS = 60
MAX_VERSION_RETRIES = 20
FUTURE_VERSION_RETRY_DELAY = 0.05


class QueueData:
    __slots__ = ("latency", "penalty", "outstanding", "failed_until")

    def __init__(self):
        self.latency = 0.001  # EWMA of reply latency (QueueData defaults)
        self.penalty = 1.0
        self.outstanding = 0
        self.failed_until = 0.0

    def metric(self) -> tuple:
        return (self.outstanding * self.penalty, self.latency)

    def begin(self) -> None:
        self.outstanding += 1

    def end(self, dt: float, ok: bool) -> None:
        self.outstanding = max(0, self.outstanding - 1)
        if ok:
            self.latency = 0.9 * self.latency + 0.1 * dt
            self.penalty = max(1.0, self.penalty * 0.9)
        else:
            # brief avoidance window after a failure (failedUntil)
            self.penalty = min(self.penalty * 2.0, 100.0)
            self.failed_until = now() + 1.0


class QueueModel:
    def __init__(self):
        self._data: dict[str, QueueData] = {}

    def get(self, addr: str) -> QueueData:
        d = self._data.get(addr)
        if d is None:
            d = self._data[addr] = QueueData()
        return d

    def order(self, team, rng) -> list:
        """Replicas by expected cost; failed ones last. Ties broken by a
        seeded shuffle so equal replicas share load."""
        team = list(team)
        rng.shuffle(team)
        t = now()
        return sorted(
            team,
            key=lambda a: (
                self.get(a).failed_until > t,
                self.get(a).metric(),
            ),
        )


async def load_balanced_request(db, team, token: str, req, hedge: bool = True):
    """One logical request against a replica team: best replica first,
    hedged second request when the first outlives ~2x its expected
    latency. Transport failures and moved shards (BrokenPromise /
    WrongShardServer) rotate to the next replica; anything else (e.g.
    FutureVersion) propagates to the caller's own retry policy. Raises
    the last rotate-error when every replica fails.

    Error-prone futures are raced via settled() (the codebase convention
    — futures.py) so a fast error reply rotates instead of escaping, and
    a hedge loser's cancellation is never recorded as replica failure."""
    model: QueueModel = db.queue_model
    order = model.order(team, db.rng)
    last_err = None

    async def one(addr):
        d = model.get(addr)
        d.begin()
        t0 = now()
        # per-attempt RPC span (runtime/trace.py): every replica try —
        # hedges and failures included — shows in the trace waterfall, so
        # wire time is the gap between this span and the server's
        with span("Client.rpc", "client", replica=addr, op=token) as sp:
            try:
                r = await db.client.request(Endpoint(addr, token), req)
                d.end(now() - t0, True)
                return r
            except Cancelled:
                # hedge loser: losing a race is not a replica failure
                sp.tag(outcome="hedge_lost")
                d.outstanding = max(0, d.outstanding - 1)
                raise
            except BaseException as e:
                sp.tag(outcome=type(e).__name__)
                d.end(now() - t0, False)
                raise

    i = 0
    while i < len(order):
        addr = order[i]
        if not hedge or i + 1 >= len(order):
            # single-attempt fast path: with no hedge candidate there is
            # nothing to race, so skip the task-spawn + settled/wait_for_any
            # scaffolding entirely — on a replication-1 team (the bench
            # shape) this removes one Task and three Futures per RPC, a
            # measurable slice of Client.rpc span self-time
            try:
                return await one(addr)
            except Cancelled:
                raise
            except _ROTATE as e:
                last_err = e
                i += 1
                continue
        first = db.client.spawn(one(addr))
        second = None
        if hedge and i + 1 < len(order):
            expected = max(model.get(addr).latency * 2.0, 0.002)
            which = await wait_for_any([settled(first), delay(expected)])
            if which != 0 and not first.is_ready():
                # first is slow: hedge to the next-best replica
                second = db.client.spawn(one(order[i + 1]))
        pending = [f for f in (first, second) if f is not None]
        advanced = 2 if second is not None else 1
        while pending:
            if len(pending) > 1:
                await wait_for_any([settled(f) for f in pending])
            else:
                await settled(pending[0])
            done = next(f for f in pending if f.is_ready())
            pending.remove(done)
            try:
                r = done.get()
                for p in pending:
                    p.cancel()
                return r
            except _ROTATE as e:
                last_err = e
            except BaseException:
                for p in pending:
                    p.cancel()
                raise
        i += advanced
    raise last_err or BrokenPromise("no replica answered")


async def load_balanced_read(db, key: bytes, token: str, req, before=False):
    """A whole storage read: locate the key's team (cached), load-balance
    the request across it, and retry through the standard failure modes —
    future_version backs off and re-asks (the storage will catch up),
    BrokenPromise / wrong_shard_server drop the location cache and
    re-locate (NativeAPI's getValue/getRange handling). The retry policy
    Transaction reads and the coalescer's per-key fallback share.

    ``before`` targets the shard holding the keys immediately BELOW
    ``key`` (backward selector walks / reverse scans)."""
    from ..runtime.buggify import buggify

    version_retries = 0
    last_err: Exception = None
    if buggify():
        db.invalidate_cache(key, before=before)  # stale-location path
    for attempt in range(MAX_READ_ATTEMPTS):
        if before:
            _b, _e, team = await db._locate_before(key)
        else:
            _b, _e, team = await db._locate(key)
        try:
            return await load_balanced_request(db, team, token, req)
        except FutureVersion as e:
            last_err = e
            version_retries += 1
            if version_retries > MAX_VERSION_RETRIES:
                raise
            _annotate("ClientReadRetry", "client", Err="FutureVersion")
            await delay(FUTURE_VERSION_RETRY_DELAY)
        except (BrokenPromise, WrongShardServer) as e:
            # whole team unreachable or moved: drop cache, back off,
            # re-locate
            last_err = e
            _annotate("ClientReadRetry", "client", Err=type(e).__name__)
            db.invalidate_cache(key, before=before)
            await delay(0.1)
    raise last_err or BrokenPromise("read retries exhausted")
