"""Same-tick client read coalescing + storage read pipelining.

Every ``get``/``getRange`` as its own RPC round trip makes reads cost a
full hop each while write batches amortize. This module is the client
half of the batched read path: concurrent reads
issued in the same loop tick against the same read version collect into
ONE ``storage.multiGet`` / ``storage.multiGetRange`` request per storage
team, dispatched through the ordinary load-balance path as a single
``Client.rpc`` hop. The storage half answers the whole batch through the
TorchRangeIndex primitives (the K5 search kernel on the card) with
waitVersion paid once (server/storage.py).

Mechanics (the same same-tick window as net/tcp.py's send coalescing):
the first read opening a batch schedules a flush callback at ZERO
priority, so every read issued during THIS loop tick — including all the
waiters a GRV batch just woke — joins before anything dispatches. No
select()/timer wait intervenes, so an isolated read pays no added
latency; a busy tick amortizes N reads into one hop.

Pipelining: dispatch is NOT stop-and-wait. Up to
``CLIENT_READ_PIPELINE_DEPTH`` batches per team ride the connection
concurrently; beyond that, batches queue and launch as replies free
slots — a storage connection keeps multiple batched reads in flight
instead of one wakeup per RPC.

Degradation: the batched reply carries per-entry error codes
(interfaces.READ_ERR_*). A definitive ``too_old`` fails only that
entry's future; ``wrong_shard``/``dropped``/missing entries fall back to
the ordinary per-key read path (loadbalance.load_balanced_read — its own
bounded retries and location-cache refresh), so fault injection on the
batched endpoint can never lose RYW correctness, only batching. All
retry loops here are attempt-bounded (flowlint actor-unbounded-retry).
"""

from __future__ import annotations

from ..errors import FutureVersion, TransactionTooOld, WrongShardServer
from ..net.sim import BrokenPromise
from ..runtime import trace as _trace
from ..runtime.futures import Future, delay
from ..runtime.loop import Cancelled, TaskPriority, current_loop
from ..runtime.trace import NULL_SPAN, span
from ..server.interfaces import (
    GetKeyRequest,
    GetValueRequest,
    READ_ERR_TOO_OLD,
    MultiGetRangeRequest,
    MultiGetRequest,
    Tokens,
)
from .loadbalance import (
    FUTURE_VERSION_RETRY_DELAY,
    MAX_VERSION_RETRIES,
    load_balanced_read,
    load_balanced_request,
)


class _PointBatch:
    """Point gets + selector resolutions forming one multiGet."""

    __slots__ = ("version", "keys", "key_futs", "key_index", "selectors",
                 "sel_futs", "span_ctx")

    def __init__(self, version: int):
        self.version = version
        self.keys: list[bytes] = []
        self.key_futs: list[list[Future]] = []  # parallel to keys (deduped)
        self.key_index: dict[bytes, int] = {}
        self.selectors: list[tuple] = []  # (key, offset, begin, end)
        self.sel_futs: list[Future] = []
        self.span_ctx = None  # first sampled member's context

    def size(self) -> int:
        return len(self.keys) + len(self.selectors)


class _RangeBatch:
    """Range windows forming one multiGetRange."""

    __slots__ = ("version", "ranges", "futs", "span_ctx")

    def __init__(self, version: int):
        self.version = version
        self.ranges: list[tuple] = []  # (begin, end, limit, reverse)
        self.futs: list[Future] = []
        self.span_ctx = None

    def size(self) -> int:
        return len(self.ranges)


class ReadCoalescer:
    """Per-database read batcher: one instance serves every transaction
    (cross-transaction coalescing is the point — a million-user read mix
    is many transactions at the same GRV-batched read version)."""

    def __init__(self, db):
        self.db = db
        # (team, version) → batch still accepting members this tick
        self._open_points: dict[tuple, _PointBatch] = {}
        self._open_ranges: dict[tuple, _RangeBatch] = {}
        self._flush_scheduled = False
        self._inflight: dict[tuple, int] = {}  # team → batches on the wire
        self._waiting: dict[tuple, list] = {}  # team → [(kind, batch)]

    def enabled(self) -> bool:
        return bool(getattr(self.db.knobs, "CLIENT_READ_COALESCING", True))

    # -- joining (one call per read, from Transaction) -------------------------

    def get(self, team, version: int, key: bytes) -> Future:
        """Future[value] for one point read at ``version``. Identical keys
        in a batch share one wire entry."""
        batch = self._point_batch(tuple(team), version)
        fut: Future = Future()
        i = batch.key_index.get(key)
        if i is None:
            batch.key_index[key] = len(batch.keys)
            batch.keys.append(key)
            batch.key_futs.append([fut])
        else:
            batch.key_futs[i].append(fut)
        return fut

    def get_key(self, team, version: int, req: GetKeyRequest) -> Future:
        """Future[GetKeyReply] for one selector resolution; the findKey
        shard-walk loop stays in Transaction — only the hop batches."""
        batch = self._point_batch(tuple(team), version)
        fut: Future = Future()
        batch.selectors.append((req.key, req.offset, req.begin, req.end))
        batch.sel_futs.append(fut)
        return fut

    def get_range(self, team, version: int, req) -> Future:
        """Future[GetKeyValuesReply] for one range window."""
        key = (tuple(team), version)
        batch = self._open_ranges.get(key)
        if batch is None:
            batch = self._open_ranges[key] = _RangeBatch(version)
            self._schedule_flush()
        if batch.span_ctx is None:
            batch.span_ctx = _trace.active_span()
        fut: Future = Future()
        batch.ranges.append((req.begin, req.end, req.limit, req.reverse))
        batch.futs.append(fut)
        return fut

    def _point_batch(self, team: tuple, version: int) -> _PointBatch:
        key = (team, version)
        batch = self._open_points.get(key)
        if batch is None:
            batch = self._open_points[key] = _PointBatch(version)
            self._schedule_flush()
        if batch.span_ctx is None:
            batch.span_ctx = _trace.active_span()
        return batch

    # -- same-tick flush -------------------------------------------------------

    def _schedule_flush(self) -> None:
        if not self._flush_scheduled:
            self._flush_scheduled = True
            current_loop().call_soon(self._flush_tick, TaskPriority.ZERO)

    def _flush_tick(self) -> None:
        self._flush_scheduled = False
        points, self._open_points = self._open_points, {}
        ranges, self._open_ranges = self._open_ranges, {}
        max_keys = max(2, int(getattr(
            self.db.knobs, "CLIENT_MULTIGET_MAX_KEYS", 1024
        )))
        for (team, _v), batch in points.items():
            for chunk in _chunk_points(batch, max_keys):
                self._launch(team, "point", chunk)
        for (team, _v), batch in ranges.items():
            for chunk in _chunk_ranges(batch, max_keys):
                self._launch(team, "range", chunk)

    def _launch(self, team: tuple, kind: str, batch) -> None:
        depth = max(1, int(getattr(
            self.db.knobs, "CLIENT_READ_PIPELINE_DEPTH", 4
        )))
        if self._inflight.get(team, 0) >= depth:
            self._waiting.setdefault(team, []).append((kind, batch))
            return
        self._inflight[team] = self._inflight.get(team, 0) + 1
        coro = (
            self._dispatch_point(team, batch)
            if kind == "point"
            else self._dispatch_range(team, batch)
        )
        self.db.client.spawn(coro)

    def _slot_freed(self, team: tuple) -> None:
        self._inflight[team] = max(0, self._inflight.get(team, 0) - 1)
        q = self._waiting.get(team)
        if q:
            kind, batch = q.pop(0)
            self._launch(team, kind, batch)

    # -- dispatch --------------------------------------------------------------

    async def _dispatch_point(self, team: tuple, batch: _PointBatch) -> None:
        try:
            req = MultiGetRequest(
                keys=batch.keys, selectors=batch.selectors, version=batch.version
            )
            reply = await self._send(
                team, Tokens.MULTI_GET, req, batch,
                size_tags={"keys": len(batch.keys),
                           "selectors": len(batch.selectors)},
            )
            if reply is not None:
                self._distribute_point(batch, reply)
        except Cancelled:
            self._fail_point(batch, Cancelled())
            raise
        except BaseException as e:
            self._fail_point(batch, e)
        finally:
            self._slot_freed(team)

    async def _dispatch_range(self, team: tuple, batch: _RangeBatch) -> None:
        try:
            req = MultiGetRangeRequest(ranges=batch.ranges, version=batch.version)
            reply = await self._send(
                team, Tokens.MULTI_GET_RANGE, req, batch,
                size_tags={"ranges": len(batch.ranges)},
            )
            if reply is not None:
                self._distribute_range(batch, reply)
        except Cancelled:
            self._fail_range(batch, Cancelled())
            raise
        except BaseException as e:
            self._fail_range(batch, e)
        finally:
            self._slot_freed(team)

    async def _send(self, team, token, req, batch, size_tags):
        """One batched hop with the per-key path's version-retry budget.
        Returns the reply, or None after degrading the whole batch to
        per-key reads (transport loss / shard moves — the per-key path
        owns relocation). Definitive errors propagate to the caller."""
        for attempt in range(MAX_VERSION_RETRIES + 1):
            sp = (
                span("Client.multiGet", "client",
                     parent=batch.span_ctx, op=token, **size_tags)
                if batch.span_ctx is not None
                else NULL_SPAN
            )
            try:
                with sp:
                    return await load_balanced_request(
                        self.db, list(team), token, req
                    )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except FutureVersion:
                if attempt >= MAX_VERSION_RETRIES:
                    raise
                await delay(FUTURE_VERSION_RETRY_DELAY)
            except (BrokenPromise, WrongShardServer):
                self._fallback_batch(batch)
                return None
        return None

    def _fail_point(self, batch: _PointBatch, err) -> None:
        """Definitive batch-wide error (too_old / version-retry budget
        spent / an unexpected failure): every member future sees it, the
        owning transactions' own retry policy takes over."""
        for futs in batch.key_futs:
            _settle_err(futs, err)
        _settle_err(batch.sel_futs, err)

    def _fail_range(self, batch: _RangeBatch, err) -> None:
        _settle_err(batch.futs, err)

    # -- reply distribution ----------------------------------------------------

    def _distribute_point(self, batch: _PointBatch, reply) -> None:
        errs = dict(reply.errors or ())
        vals = reply.values or []
        for i, key in enumerate(batch.keys):
            futs = batch.key_futs[i]
            code = errs.get(i)
            if code == READ_ERR_TOO_OLD:
                _settle_err(futs, TransactionTooOld())
            elif code is None and i < len(vals):
                _settle(futs, vals[i])
            else:
                # wrong_shard / dropped / partial reply: per-key fallback
                self._fallback_get(key, batch.version, futs)
        serrs = dict(reply.selector_errors or ())
        sreps = reply.selectors or []
        for i, sel in enumerate(batch.selectors):
            fut = batch.sel_futs[i]
            code = serrs.get(i)
            if code == READ_ERR_TOO_OLD:
                _settle_err([fut], TransactionTooOld())
            elif code is None and i < len(sreps) and sreps[i] is not None:
                _settle([fut], sreps[i])
            else:
                self._fallback_get_key(sel, batch.version, fut)

    def _distribute_range(self, batch: _RangeBatch, reply) -> None:
        errs = dict(reply.errors or ())
        results = reply.results or []
        for i, rng in enumerate(batch.ranges):
            fut = batch.futs[i]
            code = errs.get(i)
            if code == READ_ERR_TOO_OLD:
                _settle_err([fut], TransactionTooOld())
            elif code is None and i < len(results) and results[i] is not None:
                _settle([fut], results[i])
            else:
                self._fallback_get_range(rng, batch.version, fut)

    # -- per-key degradation ---------------------------------------------------

    def _fallback_batch(self, batch) -> None:
        if isinstance(batch, _PointBatch):
            for i, key in enumerate(batch.keys):
                self._fallback_get(key, batch.version, batch.key_futs[i])
            for i, sel in enumerate(batch.selectors):
                self._fallback_get_key(sel, batch.version, batch.sel_futs[i])
        else:
            for i, rng in enumerate(batch.ranges):
                self._fallback_get_range(rng, batch.version, batch.futs[i])

    def _fallback_get(self, key: bytes, version: int, futs) -> None:
        req = GetValueRequest(key=key, version=version)
        self._spawn_fallback(
            key, Tokens.GET_VALUE, req, futs, False,
            lambda reply: reply.value,
        )

    def _fallback_get_key(self, sel: tuple, version: int, fut) -> None:
        key, offset, begin, end = sel
        req = GetKeyRequest(
            key=key, offset=offset, version=version, begin=begin, end=end
        )
        self._spawn_fallback(
            key, Tokens.GET_KEY, req, [fut], offset < 1, lambda reply: reply
        )

    def _fallback_get_range(self, rng: tuple, version: int, fut) -> None:
        begin, end, limit, reverse = rng
        from ..server.interfaces import GetKeyValuesRequest

        req = GetKeyValuesRequest(
            begin=begin, end=end, version=version, limit=limit, reverse=reverse
        )
        anchor = end if reverse else begin
        self._spawn_fallback(
            anchor, Tokens.GET_KEY_VALUES, req, [fut], reverse,
            lambda reply: reply,
        )

    def _spawn_fallback(self, key, token, req, futs, before, extract) -> None:
        async def one():
            try:
                reply = await load_balanced_read(
                    self.db, key, token, req, before=before
                )
            except Cancelled:
                _settle_err(futs, Cancelled())
                raise  # actor-cancelled-swallow
            except BaseException as e:
                _settle_err(futs, e)
                return
            _settle(futs, extract(reply))

        self.db.client.spawn(one())


def _settle(futs, value) -> None:
    for f in futs:
        if not f.is_ready():
            f._set(value)


def _settle_err(futs, err) -> None:
    for f in futs:
        if not f.is_ready():
            f._set_error(err)


def _chunk_points(batch: _PointBatch, max_keys: int):
    if batch.size() <= max_keys:
        return [batch]
    out = []
    for lo in range(0, len(batch.keys), max_keys):
        c = _PointBatch(batch.version)
        c.span_ctx = batch.span_ctx
        c.keys = batch.keys[lo : lo + max_keys]
        c.key_futs = batch.key_futs[lo : lo + max_keys]
        out.append(c)
    for lo in range(0, len(batch.selectors), max_keys):
        c = _PointBatch(batch.version)
        c.span_ctx = batch.span_ctx
        c.selectors = batch.selectors[lo : lo + max_keys]
        c.sel_futs = batch.sel_futs[lo : lo + max_keys]
        out.append(c)
    return out


def _chunk_ranges(batch: _RangeBatch, max_keys: int):
    if batch.size() <= max_keys:
        return [batch]
    out = []
    for lo in range(0, len(batch.ranges), max_keys):
        c = _RangeBatch(batch.version)
        c.span_ctx = batch.span_ctx
        c.ranges = batch.ranges[lo : lo + max_keys]
        c.futs = batch.futs[lo : lo + max_keys]
        out.append(c)
    return out
