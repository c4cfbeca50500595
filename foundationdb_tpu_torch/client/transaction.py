"""Client Transaction with read-your-writes semantics.

The analog of fdbclient/NativeAPI.actor.cpp's Transaction (get:1863,
commit:2571) merged with the ReadYourWrites overlay
(fdbclient/ReadYourWrites.actor.cpp:46-142 + WriteMap, fdbclient/WriteMap.h:119):

- reads see this transaction's own uncommitted writes layered over a
  snapshot at the read version;
- the write overlay collapses eagerly: a set replaces prior ops on that key,
  a clear turns keys into determined-None, an atomic op chains onto a
  determined value immediately or waits for the storage base value
  (the reference's "unmodified/independent/dependent" op-stack states);
- every read records a read conflict range, every write a write conflict
  range (unless snapshot/disabled), exactly what the resolver checks;
- reads route via a key-location cache (getKeyLocation, NativeAPI:1059)
  and load-balance across the storage team (LoadBalance.actor.h:158).
"""

from __future__ import annotations

from typing import Optional

from ..errors import (
    AccessedUnreadable,
    CommitUnknownResult,
    FdbError,
    NotCommitted,
    TransactionTooOld,
)
from ..kv.atomic import apply_atomic
from ..kv.keyrange_map import KeyRangeMap
from ..kv.mutations import Mutation, MutationType
from ..kv.selector import SELECTOR_END, KeySelector, as_selector
from ..net.sim import BrokenPromise
from ..runtime.futures import delay
from ..runtime.trace import NULL_SPAN as _NO_SPAN
from .loadbalance import load_balanced_read
from ..runtime.buggify import buggify
from ..server.interfaces import (
    CommitRequest,
    GetKeyRequest,
    GetKeyValuesRequest,
    GetReadVersionRequest,
    GetValueRequest,
    Tokens,
    TransactionData,
)

MAX_FIND_KEY_HOPS = 10000  # findKey shard hops (a loop here is a bug)


def strinc(key: bytes) -> bytes:
    """Least key strictly greater than every key prefixed by `key`
    (the bindings' strinc; used for prefix ranges)."""
    key = key.rstrip(b"\xff")
    if not key:
        raise ValueError("no upper bound for all-0xff prefix")
    return key[:-1] + bytes([key[-1] + 1])


def key_after(key: bytes) -> bytes:
    return key + b"\x00"


class Transaction:
    def __init__(self, db):
        self.db = db
        self._read_version: Optional[int] = None
        # RYW overlay: key → ("value", v|None) | ("ops", [(type, param), ...])
        self._writes: dict[bytes, tuple] = {}
        self._cleared = KeyRangeMap(default=False)  # key covered by a clear?
        self._mutations: list[Mutation] = []
        self._rcr: list[tuple[bytes, bytes]] = []
        self._wcr: list[tuple[bytes, bytes]] = []
        self._unreadable: set[bytes] = set()  # versionstamped-key placeholders
        self._watches: list[tuple[bytes, object]] = []  # (key, Future)
        # watch actors this transaction started (commit's _start_watches):
        # reset()/on_error() cancels them — FDB's watch lifetime contract
        # (outstanding watches die with the transaction that owns them)
        self._watch_actors: list = []
        self.committed_version: Optional[int] = None
        self.versionstamp: Optional[bytes] = None
        # transaction-debug attach id (fdb_transaction_set_option
        # DEBUG_TRANSACTION_IDENTIFIER + the commit sampler): every
        # pipeline stage traces CommitDebug events with it. The same id
        # names the transaction's distributed trace (runtime/trace.py) —
        # a sampled transaction's spans and its debug chain share it.
        self.debug_id: str = ""
        self._span_root = None  # SpanContext once sampled
        self._trace_decided = False
        # admission options: priority class + tenant id ride
        # the GRV envelope (server/admission.py). Inherited from the
        # database's defaults; survive reset() (a retry keeps its class —
        # the reference's onError preserves option state the same way)
        self.priority = db.default_priority
        self.tenant: str = db.default_tenant

    def set_debug_id(self, debug_id: str) -> None:
        self.debug_id = debug_id

    # -- admission options (fdb_transaction_set_option PRIORITY_* / tenant) ----

    def set_priority(self, priority) -> None:
        """Transaction priority class: "batch" / "default" / "immediate"
        (or the admission module's int constants). Batch sheds first
        under overload; immediate is for system/probe traffic."""
        from ..server.admission import coerce_priority

        self.priority = coerce_priority(priority)

    def set_tenant(self, tenant: str) -> None:
        """Tenant id for per-tenant admission fair-share ("" = none)."""
        self.tenant = tenant or ""

    # -- distributed-trace sampling (TRACE_SAMPLE_RATE / debug ids) ------------

    def _trace_root(self):
        """This transaction's root span context, deciding sampling on
        first use: an explicit debug id forces sampling; otherwise one
        seeded-RNG draw against TRACE_SAMPLE_RATE (no draw at rate 0, so
        untraced runs consume an identical random stream)."""
        if not self._trace_decided:
            self._trace_decided = True
            if not self.debug_id:
                rate = getattr(self.db.knobs, "TRACE_SAMPLE_RATE", 0.0)
                if rate > 0.0 and self.db.rng.random01() < rate:
                    self.debug_id = f"txn-{self.db.rng.random_unique_id()}"
            if self.debug_id:
                from ..runtime.trace import root_context

                self._span_root = root_context(self.debug_id)
        elif self._span_root is None and self.debug_id:
            # debug id attached after the sampling decision (late
            # set_debug_id): still trace
            from ..runtime.trace import root_context

            self._span_root = root_context(self.debug_id)
        return self._span_root

    def _op_span(self, name: str, **tags):
        """A client-op span: child of the enclosing op when one is active
        (selector endpoints resolving inside getRange), else of the
        transaction root. None when this transaction is unsampled — the
        callers keep their untraced fast path."""
        root = self._trace_root()
        if root is None:
            return None
        from ..runtime.trace import active_span, span

        return span(name, "client", parent=active_span() or root, **tags)

    # -- read version ----------------------------------------------------------

    async def get_read_version(self) -> int:
        if self._read_version is None:
            sp = self._op_span("Client.getReadVersion")
            if sp is None:
                # batched through the database's readVersionBatcher
                self._read_version = await self.db.get_read_version(
                    self.priority, self.tenant
                )
            else:
                with sp:
                    sp.event("ClientGRVStart", kind="ReadDebug")
                    self._read_version = await self.db.get_read_version(
                        self.priority, self.tenant
                    )
                    sp.event("ClientGRVDone", kind="ReadDebug")
        return self._read_version

    def set_read_version(self, version: int) -> None:
        self._read_version = version

    # -- writes (RYW overlay + mutation log) -----------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        self._writes[key] = ("value", value)
        self._mutations.append(Mutation(MutationType.SET_VALUE, key, value))
        self._wcr.append((key, key_after(key)))

    def clear(self, key: bytes) -> None:
        self.clear_range(key, key_after(key))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        if begin >= end:
            return
        for k in list(self._writes):
            if begin <= k < end:
                self._writes[k] = ("value", None)
        self._cleared.insert(begin, end, True)
        self._mutations.append(Mutation(MutationType.CLEAR_RANGE, begin, end))
        self._wcr.append((begin, end))

    def atomic_op(self, op: MutationType, key: bytes, param: bytes) -> None:
        cur = self._writes.get(key)
        if cur is None and self._cleared[key]:
            cur = ("value", None)
        if cur is None:
            self._writes[key] = ("ops", [(op, param)])
        elif cur[0] in ("value", "value_db"):
            # chaining onto a determined value preserves its provenance
            # (database-dependent values stay conflict-protected on read)
            self._writes[key] = (cur[0], apply_atomic(op, cur[1], param))
        else:
            self._writes[key] = ("ops", cur[1] + [(op, param)])
        self._mutations.append(Mutation(op, key, param))
        self._wcr.append((key, key_after(key)))

    def set_versionstamped_key(self, key_with_offset: bytes, value: bytes) -> None:
        """key_with_offset: key bytes containing a 10-byte placeholder,
        followed by a 4-byte little-endian offset of the placeholder."""
        self._mutations.append(
            Mutation(MutationType.SET_VERSIONSTAMPED_KEY, key_with_offset, value)
        )
        body = key_with_offset[:-4]
        self._unreadable.add(body)
        self._wcr.append((body, key_after(body)))

    def set_versionstamped_value(self, key: bytes, value_with_offset: bytes) -> None:
        self._mutations.append(
            Mutation(MutationType.SET_VERSIONSTAMPED_VALUE, key, value_with_offset)
        )
        self._unreadable.add(key)
        self._wcr.append((key, key_after(key)))

    def watch(self, key: bytes):
        """A future that fires when the key's value changes after this
        transaction commits (fdb_transaction_watch; NativeAPI watches via
        storage watchValue). Await it only after a successful commit."""
        from ..runtime.futures import Future

        out = Future()
        self._watches.append((key, out))
        return out

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._rcr.append((begin, end))

    def add_write_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._wcr.append((begin, end))

    # -- reads -----------------------------------------------------------------

    async def get(self, key: bytes, snapshot: bool = False) -> Optional[bytes]:
        sp = self._op_span("Client.get")
        if sp is None:
            return await self._get_impl(key, snapshot)
        with sp:
            sp.event("ClientReadStart", kind="ReadDebug")
            try:
                return await self._get_impl(key, snapshot)
            finally:
                sp.event("ClientReadDone", kind="ReadDebug")

    async def _get_impl(self, key: bytes, snapshot: bool = False) -> Optional[bytes]:
        if key in self._unreadable:
            raise AccessedUnreadable()
        w = self._writes.get(key)
        if w is not None and w[0] == "value":
            # fully determined by this txn's own writes: no storage read and
            # no read conflict (ReadYourWrites 'read from write' — a plain
            # overwrite never observed the database)
            return w[1]
        if w is not None and w[0] == "value_db":
            # determined, but by collapsing an atomic chain over a value
            # observed from the database: repeat reads skip the storage
            # round-trip, yet a non-snapshot read still depends on the base
            # value and must conflict-protect it
            if not snapshot:
                self._rcr.append((key, key_after(key)))
            return w[1]
        if not snapshot:
            self._rcr.append((key, key_after(key)))
        if w is None and self._cleared[key]:
            return None
        base = await self._storage_get(key)
        if w is None:
            return base
        # pending atomic chain over the storage base; collapse to a
        # determined-but-database-dependent value
        v = base
        for op, param in w[1]:
            v = apply_atomic(op, v, param)
        self._writes[key] = ("value_db", v)
        return v

    async def get_key(self, selector, snapshot: bool = False) -> bytes:
        sp = self._op_span("Client.getKey")
        if sp is None:
            return await self._get_key_impl(selector, snapshot)
        with sp:
            return await self._get_key_impl(selector, snapshot)

    async def _get_key_impl(self, selector, snapshot: bool = False) -> bytes:
        """Resolve a key selector (kv/selector.py) to an existing key at
        the read version, seen through the RYW overlay — this txn's
        uncommitted sets add keys to the walk and its clears remove them
        (ReadYourWrites getKey over the WriteMap). A bare key coerces to
        firstGreaterOrEqual. Resolution clamps to b"" / b"\\xff" at the
        keyspace edges; a non-snapshot read conflict-protects the span the
        walk observed (anchor through resolved key), which is exactly what
        makes selector navigation serializable."""
        k, off = as_selector(selector).normalized()
        # resolution always observes the database (even when the walk ends
        # at a keyspace edge): pin the read version up front so pin timing
        # matches the model oracle instruction-for-instruction
        await self.get_read_version()
        if self._writes or any(v for _b, _e, v in self._cleared.ranges()):
            resolved = await self._selector_resolve_merged(k, off)
        else:
            # no overlay: the storage getKey walk (findKey) resolves it
            resolved = await self._find_key(k, off)
        if off >= 1:
            lo = k
            hi = key_after(resolved) if resolved < SELECTOR_END else SELECTOR_END
        else:
            lo, hi = resolved, min(k, SELECTOR_END)
        if lo < hi:
            for body in self._unreadable:
                if lo <= body < hi:
                    # a pending versionstamped key may land inside the
                    # observed span; the walk's outcome is unknowable
                    raise AccessedUnreadable()
            if not snapshot:
                self._rcr.append((lo, hi))
        return resolved

    async def _selector_resolve_merged(self, k: bytes, off: int) -> bytes:
        """Overlay-aware resolution: walk the MERGED view (storage rows at
        the read version + this txn's writes) — the RYWIterator path."""
        if off >= 1:
            if k >= SELECTOR_END:
                return SELECTOR_END
            rows = await self._get_range_merged(k, SELECTOR_END, off, False)
            return rows[off - 1][0] if len(rows) >= off else SELECTOR_END
        needed = 1 - off
        hi = min(k, SELECTOR_END)
        if hi <= b"":
            return b""
        rows = await self._get_range_merged(b"", hi, needed, True)
        return rows[-1][0] if len(rows) >= needed else b""

    async def _find_key(self, k: bytes, off: int) -> bytes:
        """The findKey loop (NativeAPI.actor.cpp:1220): ask the shard the
        anchor locates to; a partially-resolved reply repositions the
        selector at the shard boundary and the loop follows it to the
        adjacent shard."""
        version = await self.get_read_version()
        for _hop in range(MAX_FIND_KEY_HOPS):
            if off >= 1:
                if k >= SELECTOR_END:
                    return SELECTOR_END
                before = False
                s_begin, s_end, team = await self.db._locate(k)
            else:
                if k <= b"":
                    return b""
                before = True
                s_begin, s_end, team = await self.db._locate_before(k)
            req = GetKeyRequest(
                key=k, offset=off, version=version, begin=s_begin, end=s_end
            )
            if self.db.reads.enabled():
                # the resolution hop batches with the tick's other reads;
                # partial-resolution replies keep driving this walk
                reply = await self.db.reads.get_key(team, version, req)
            else:
                reply = await self._load_balanced(
                    k, Tokens.GET_KEY, req, before=before
                )
            if reply.resolved:
                return reply.key
            k, off = reply.key, reply.offset
        raise AssertionError("findKey did not converge (shard-walk loop)")

    async def get_range(
        self,
        begin,
        end,
        limit: int = 1 << 30,
        reverse: bool = False,
        snapshot: bool = False,
    ) -> list[tuple[bytes, bytes]]:
        sp = self._op_span("Client.getRange")
        if sp is None:
            return await self._get_range_impl(begin, end, limit, reverse, snapshot)
        with sp:
            sp.event("ClientReadStart", kind="ReadDebug")
            try:
                rows = await self._get_range_impl(begin, end, limit, reverse, snapshot)
                sp.tag(rows=len(rows))
                return rows
            finally:
                sp.event("ClientReadDone", kind="ReadDebug")

    async def _get_range_impl(
        self,
        begin,
        end,
        limit: int = 1 << 30,
        reverse: bool = False,
        snapshot: bool = False,
    ) -> list[tuple[bytes, bytes]]:
        if isinstance(begin, KeySelector) or isinstance(end, KeySelector):
            # selector endpoints resolve first (snapshot resolution — the
            # range read below conflict-protects the resolved range), then
            # the byte-range path runs unchanged; bare-byte endpoints stay
            # raw bounds, NOT selectors
            b = (
                begin
                if not isinstance(begin, KeySelector)
                else await self.get_key(begin, snapshot=True)
            )
            e = (
                end
                if not isinstance(end, KeySelector)
                else await self.get_key(end, snapshot=True)
            )
            if b >= e:
                return []
            return await self._get_range_impl(
                b, e, limit=limit, reverse=reverse, snapshot=snapshot
            )
        assert not reverse or limit < (1 << 30), "reverse needs a limit"
        for body in self._unreadable:
            if begin <= body < end:
                # a pending versionstamped write will land somewhere in this
                # range; its final key is unknowable before commit
                raise AccessedUnreadable()
        out = await self._get_range_merged(begin, end, limit, reverse)
        if not snapshot:
            # conflict on the portion actually observed (NativeAPI clamps
            # the range at the last returned key when the limit was hit)
            if len(out) >= limit and out:
                if reverse:
                    self._rcr.append((out[-1][0], end))
                else:
                    self._rcr.append((begin, key_after(out[-1][0])))
            else:
                self._rcr.append((begin, end))
        return out

    async def _get_range_merged(self, begin, end, limit, reverse):
        """Merge storage rows at the read version with the write overlay
        (the RYWIterator's job, fdbclient/RYWIterator.cpp), window by
        window: each storage reply defines an exactly-known key window
        (everything up to its last row, or the whole remainder when
        ``more`` is false), inside which overlay merging is exact — so
        truncated replies and overlay-dropped rows can't lose keys."""
        out: list[tuple[bytes, bytes]] = []
        lo, hi = begin, end
        while len(out) < limit and lo < hi:
            if not reverse:
                rows, next_lo = await self._storage_window(lo, hi, limit - len(out))
                w_hi = next_lo if next_lo is not None else hi
                out.extend(self._merge_window(rows, lo, w_hi, reverse=False))
                if next_lo is None:
                    break
                lo = next_lo
            else:
                rows, next_hi = await self._storage_window_rev(
                    lo, hi, limit - len(out)
                )
                w_lo = next_hi if next_hi is not None else lo
                out.extend(self._merge_window(rows, w_lo, hi, reverse=True))
                if next_hi is None:
                    break
                hi = next_hi
        return out[:limit]

    def _merge_window(self, rows, lo, hi, reverse):
        """Exact merge inside [lo, hi): storage absence is genuine here."""
        merged: dict[bytes, Optional[bytes]] = {}
        for k, v in rows:
            if lo <= k < hi and not (self._cleared[k] and k not in self._writes):
                merged[k] = v
        for k, w in self._writes.items():
            if lo <= k < hi:
                if w[0] in ("value", "value_db"):
                    v = w[1]
                else:
                    v = merged.get(k)  # absent in window = absent in storage
                    for op, param in w[1]:
                        v = apply_atomic(op, v, param)
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = v
        return sorted(merged.items(), reverse=reverse)

    # -- storage routing (getKeyLocation + loadBalance) ------------------------

    async def _storage_get(self, key: bytes) -> Optional[bytes]:
        version = await self.get_read_version()
        if self.db.reads.enabled():
            # same-tick coalescing: this get joins the tick's multiGet
            # batch for the key's team (client/read_coalescer.py); RYW
            # overlay and conflict accounting already happened per-key in
            # _get_impl, so only the storage fetch batches
            _b, _e, team = await self.db._locate(key)
            return await self.db.reads.get(team, version, key)
        req = GetValueRequest(key=key, version=version)
        reply = await self._load_balanced(key, Tokens.GET_VALUE, req)
        return reply.value

    async def _storage_window(self, lo, hi, limit):
        """One forward storage fetch. Returns (rows, next_lo): next_lo is
        where the next window starts, or None when [lo, hi) is fully
        covered by this reply (shard splits + `more` both advance it)."""
        version = await self.get_read_version()
        s_begin, s_end, team = await self.db._locate(lo)
        chunk_hi = hi if s_end is None else min(hi, s_end)
        if buggify():
            limit = 1  # one-row windows: worst-case RYW window merging
        req = GetKeyValuesRequest(begin=lo, end=chunk_hi, version=version, limit=limit)
        if self.db.reads.enabled():
            reply = await self.db.reads.get_range(team, version, req)
        else:
            reply = await self._load_balanced(lo, Tokens.GET_KEY_VALUES, req)
        if reply.more:
            return reply.data, key_after(reply.data[-1][0])
        if chunk_hi < hi:
            return reply.data, chunk_hi
        return reply.data, None

    async def _storage_window_rev(self, lo, hi, limit):
        """One reverse storage fetch, walking shards right-to-left from
        ``hi`` (NativeAPI's reverse getRange). next_hi bounds the next
        window, or None when [lo, hi) is fully covered by this reply."""
        version = await self.get_read_version()
        s_begin, _s_end, team = await self.db._locate_before(hi)
        chunk_lo = max(lo, s_begin)
        req = GetKeyValuesRequest(
            begin=chunk_lo, end=hi, version=version, limit=limit, reverse=True
        )
        if self.db.reads.enabled():
            reply = await self.db.reads.get_range(team, version, req)
        else:
            reply = await self._load_balanced(chunk_lo, Tokens.GET_KEY_VALUES, req)
        if reply.more:
            return reply.data, reply.data[-1][0]
        if chunk_lo > lo:
            return reply.data, chunk_lo
        return reply.data, None

    async def _load_balanced(self, key: bytes, token: str, req, before=False):
        """Replica selection with retry — LoadBalance.actor.h:158.
        Per-replica latency/penalty model + hedged second request,
        wrong_shard_server / dead-team location-cache refresh: the whole
        policy lives in client/loadbalance.py (load_balanced_read) so the
        read coalescer's per-key fallback shares it verbatim. ``before``
        targets the shard holding the keys immediately BELOW ``key``
        (backward selector walks / reverse scans — NativeAPI's isBackward
        location lookups)."""
        return await load_balanced_read(self.db, key, token, req, before=before)

    # -- commit ----------------------------------------------------------------

    async def commit(self) -> int:
        if not self._mutations and not self._wcr:
            # read-only: committing at the read version with no writes.
            # A watch-only transaction (watch() with no reads) must still
            # anchor its baseline at a version ordered BEFORE anything
            # the caller commits after us — without it the watch actor
            # reads the baseline at a fresh version and a change landing
            # in between is silently adopted as the baseline: a permanent
            # lost wakeup (seed-5 chaos soak, clogged registration racing
            # the release commit).
            if self._watches and self._read_version is None:
                await self.get_read_version()
            self.committed_version = self._read_version or 0
            self._start_watches()
            return self.committed_version
        if not self.debug_id and self.db.rng.random01() < getattr(
            self.db.knobs, "CLIENT_COMMIT_SAMPLE", 0.0
        ):
            self.debug_id = f"txn-{self.db.rng.random_unique_id()}"
        data = TransactionData(
            read_snapshot=await self.get_read_version() if self._rcr else 0,
            read_conflict_ranges=_dedup(self._rcr),
            write_conflict_ranges=_dedup(self._wcr),
            mutations=self._mutations,
            debug_id=self.debug_id,
        )
        sp = self._op_span("Client.commit", mutations=len(self._mutations))
        with sp if sp is not None else _NO_SPAN:
            if sp is not None:
                sp.event("ClientCommitStart")
            if buggify():
                await delay(0.002)  # commit racing a concurrent writer
            try:
                reply = await self.db._proxy_request(
                    Tokens.COMMIT, CommitRequest(transaction=data), retry=False
                )
            except (NotCommitted, TransactionTooOld):
                raise
            except BrokenPromise:
                raise CommitUnknownResult()
            self.committed_version = reply.version
            self.versionstamp = reply.versionstamp
            if sp is not None:
                sp.event("ClientCommitDone")
        self._start_watches()
        return reply.version

    def _start_watches(self) -> None:
        from .database import _NO_VALUE

        for key, fut in self._watches:
            # the baseline is what THIS transaction established: the value
            # it WROTE when it wrote the key (set-then-watch must not fire
            # on the transaction's own write), else what it could have SEEN
            # at its read version
            baseline_value = _NO_VALUE
            w = self._writes.get(key)
            if w is not None and w[0] == "value":
                baseline_value = w[1]
            elif w is None and key not in self._unreadable and self._cleared[key]:
                baseline_value = None
            elif w is not None or key in self._unreadable:
                # written, but the committed value is only known
                # server-side (an undetermined atomic chain, a chain
                # collapsed over a SNAPSHOT read whose base may have moved
                # without conflicting ("value_db"), or a versionstamped
                # value) — read the baseline back at the commit version
                self._watch_actors.append(
                    self.db.client.spawn(
                        self.db._watch_actor(
                            key, fut, baseline_version=self.committed_version
                        )
                    )
                )
                continue
            # a write-only transaction watching a key it didn't write has
            # no read version; its serialization point is the commit
            # version, so the baseline anchors there — never at a fresh
            # version, which would adopt a racing change (lost wakeup)
            bv = self._read_version
            if bv is None:
                bv = self.committed_version or None
            self._watch_actors.append(
                self.db.client.spawn(
                    self.db._watch_actor(
                        key,
                        fut,
                        baseline_version=bv,
                        baseline_value=baseline_value,
                    )
                )
            )
        self._watches = []

    def get_versionstamp(self) -> bytes:
        assert self.committed_version is not None, "commit first"
        return self.versionstamp

    # -- retry loop ------------------------------------------------------------

    def cancel_watches(self) -> None:
        """Cancel this transaction's outstanding watches (the reference's
        watch lifetime: reset/destroy cancels them). Futures not yet
        handed to an actor (watch() before commit) and futures whose
        actor is parked server-side both resolve promptly with the
        non-retryable TransactionCancelled."""
        from ..errors import TransactionCancelled

        for _key, fut in self._watches:
            if not fut.is_ready():
                fut._set_error(TransactionCancelled())
        self._watches = []
        for actor in self._watch_actors:
            actor.cancel()
        self._watch_actors = []

    def reset(self) -> None:
        backoff = getattr(self, "_backoff", 0.0)
        priority, tenant = self.priority, self.tenant
        self.cancel_watches()
        self.__init__(self.db)
        self._backoff = backoff
        # admission options survive reset: a throttled-then-retried txn
        # must not silently jump admission class
        self.priority, self.tenant = priority, tenant

    async def on_error(self, e: Exception) -> None:
        """Backoff + reset for retryable errors (Transaction::onError,
        NativeAPI.actor.cpp)."""
        if not isinstance(e, FdbError) or not e.retryable:
            raise e
        self._backoff = min(
            max(getattr(self, "_backoff", 0.0) * 2, 0.01),
            self.db.knobs.CLIENT_MAX_RETRY_DELAY,
        )
        wait = self._backoff * (0.5 + self.db.rng.random01() * 0.5)
        self.reset()
        await delay(wait)


def _dedup(ranges: list[tuple[bytes, bytes]]) -> list[tuple[bytes, bytes]]:
    return sorted(set(ranges))
