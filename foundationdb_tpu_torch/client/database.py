"""Database handle: connection to the cluster + the retry loop.

The analog of fdbclient/NativeAPI's Cluster/Database (and the run-loop idiom
every binding exposes, e.g. bindings/python/fdb/impl.py @transactional):
holds the key-location cache (getKeyLocation:1059) and proxy endpoints, and
``run()`` retries a transaction body on retryable errors.

The port's copy of ``foundationdb_tpu/client/database.py`` in its static
mode: an explicit proxy address list (``Database(sim,
cluster.proxy_addrs)``). The dynamic mode (``coordinators=``,
``Database.from_coordinators``: monitor the coordinators for the elected
cluster controller, then long-poll its openDatabase endpoint for the
proxy list) needs the coordination role and comes with the dynamic
cluster (ROADMAP queue A, item 9); until then ``coordinators=`` raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

from ..net.sim import BrokenPromise, Sim
from ..runtime.futures import (
    AsyncVar,
    RequestBatcher,
    delay,
    wait_for_any,
)
from ..runtime.knobs import Knobs
from ..runtime.buggify import buggify
from ..kv.keyrange_map import KeyRangeMap
from ..server.interfaces import (
    GetKeyServersRequest,
    GetReadVersionRequest,
    ProxyInterface,
    Tokens,
)
from .loadbalance import QueueModel
from .transaction import Transaction
from ..runtime.loop import Cancelled

# distinct from None: a cleared key's baseline value IS None
_NO_VALUE = object()

_METHOD_FOR_TOKEN = {
    Tokens.GRV: "grv",
    Tokens.COMMIT: "commit",
    Tokens.GET_KEY_SERVERS: "keyServers",
}


class Database:
    def __init__(
        self,
        sim: Sim,
        proxy_addrs: list[str] = None,
        client_addr: str = "client",
        coordinators: list[str] = None,
    ):
        if coordinators:
            raise NotImplementedError(
                "Database(coordinators=...) needs the coordination role, which "
                "the port does not have yet (ROADMAP queue A, item 9: "
                "coordination.py with DynamicCluster and "
                "Database.from_coordinators); pass proxy_addrs"
            )
        self.sim = sim
        self.knobs: Knobs = sim.knobs
        self.client = sim.processes.get(client_addr) or sim.new_process(client_addr)
        self.rng = sim.loop.random.fork()
        # per-replica latency/penalty model for read load balancing
        # (fdbrpc/QueueModel.cpp analog; client/loadbalance.py)
        self.queue_model = QueueModel()
        proxy_ifaces = None if proxy_addrs is None else [ProxyInterface(a) for a in proxy_addrs]
        self._proxies: AsyncVar = AsyncVar(proxy_ifaces)
        # location cache: key range → team addresses (None = unknown)
        self._locations = KeyRangeMap(default=None)
        # GRV batchers (readVersionBatcher, NativeAPI.actor.cpp:1290), one
        # per (priority class, tenant): the envelope now carries admission
        # fields, and batching across classes would let batch
        # traffic ride immediate-class grants
        self._grv_batchers: dict[tuple, RequestBatcher] = {}
        # database-level admission defaults (server/admission.py classes);
        # transactions inherit them and may override per-txn
        from ..server.admission import PRIORITY_DEFAULT

        self.default_priority = PRIORITY_DEFAULT
        self.default_tenant = ""
        # same-tick read coalescing into storage multiGet batches
        # (client/read_coalescer.py; CLIENT_READ_COALESCING gates use)
        from .read_coalescer import ReadCoalescer

        self.reads = ReadCoalescer(self)

    @property
    def proxy_addrs(self) -> list[str]:
        ps = self._proxies.get() or []
        return [p.address for p in ps]

    async def _get_proxies(self) -> list:
        while not self._proxies.get():
            await self._proxies.on_change()
        return self._proxies.get()

    # -- routing ---------------------------------------------------------------

    async def _proxy_request(self, token: str, req, retry: bool = True):
        """RPC to some proxy. Safe-to-retry requests (GRV, key location)
        fail over across proxies; non-idempotent ones (commit) surface
        BrokenPromise to the caller, which maps it to commit_unknown_result."""
        method = _METHOD_FOR_TOKEN[token]
        proxies = await self._get_proxies()
        if not retry:
            p = self.rng.random_choice(proxies)
            return await self.client.request(p.ep(method), req)
        last_err = None
        for attempt in range(60):
            proxies = await self._get_proxies()
            p = self.rng.random_choice(proxies)
            try:
                return await self.client.request(p.ep(method), req)
            except BrokenPromise as e:
                last_err = e
                # dead epoch? wait a moment for a fresh proxy list
                await wait_for_any(
                    [self._proxies.on_change(), delay(0.05 * min(attempt + 1, 10))]
                )
        raise last_err

    async def get_read_version(self, priority=None, tenant=None) -> int:
        """Batched GRV (the reference's readVersionBatcher,
        NativeAPI.actor.cpp:1290): concurrent callers coalesce into one
        proxy round trip — an idle client pays no added latency, a busy
        one amortizes the RPC. Callers batch per (priority, tenant) so a
        shared fetch never crosses admission classes; a throttled fetch
        (grv_throttled) errors every joined caller, and each one backs
        off through Transaction.on_error (bounded)."""
        from ..server.admission import coerce_priority

        priority = coerce_priority(
            self.default_priority if priority is None else priority
        )
        tenant = self.default_tenant if tenant is None else tenant
        key = (priority, tenant)
        b = self._grv_batchers.get(key)
        if b is None:
            b = self._grv_batchers[key] = RequestBatcher(
                lambda n, p=priority, t=tenant: self._fetch_grv(p, t, n),
                self.client.spawn,
                counted=True,  # admission debits per transaction
            )
        return await b.join()

    async def _fetch_grv(self, priority, tenant, count: int = 1) -> int:
        if buggify():
            await delay(0.001)  # GRV straggler (batcher forms bigger batches)
        reply = await self._proxy_request(
            Tokens.GRV,
            GetReadVersionRequest(
                priority=priority, tenant=tenant, count=count
            ),
        )
        return reply.version

    async def _locate(self, key: bytes):
        """(shard begin, end, team) for key, cached (NativeAPI:1059)."""
        cached = self._locations.range_for(key)
        if cached[2] is not None:
            return cached
        reply = await self._proxy_request(
            Tokens.GET_KEY_SERVERS, GetKeyServersRequest(key=key)
        )
        self._locations.insert(reply.begin, reply.end, reply.team)
        return reply.begin, reply.end, reply.team

    async def _locate_before(self, key: bytes):
        """(shard begin, end, team) for the keys immediately below ``key`` —
        reverse range reads walk shards right-to-left from the range end
        (NativeAPI getRange reverse handling)."""
        cached = self._locations.range_before(key)
        if cached[2] is not None:
            return cached
        reply = await self._proxy_request(
            Tokens.GET_KEY_SERVERS, GetKeyServersRequest(key=key, before=True)
        )
        self._locations.insert(reply.begin, reply.end, reply.team)
        return reply.begin, reply.end, reply.team

    def invalidate_cache(self, key: bytes, before: bool = False) -> None:
        b, e, _ = (
            self._locations.range_before(key)
            if before
            else self._locations.range_for(key)
        )
        self._locations.insert(b, e, None)

    # -- watches ---------------------------------------------------------------

    def watch(self, key: bytes):
        """Fire when the key's value changes from its current value."""
        from ..runtime.futures import Future

        out = Future()
        self.client.spawn(self._watch_actor(key, out))
        return out

    def change_feed(self, begin: bytes, end: bytes, from_version: int = 0):
        """A resumable cursor over the range's committed mutations in
        version order (client/feed.py). The range must live on one shard;
        ``from_version`` is exclusive (0 = from the retention floor)."""
        from .feed import ChangeFeed

        return ChangeFeed(self, begin, end, from_version)

    async def _watch_actor(
        self, key: bytes, out, baseline_version=None, baseline_value=_NO_VALUE
    ) -> None:
        """Register (and keep re-registering across failovers/moves) a
        storage watch; resolve `out` with the new value.

        ``baseline_version``: the WATCHING transaction's read version —
        the baseline value must be read there (fdb_transaction_watch
        semantics: a watch fires on change from the value the
        transaction saw). Reading it at a fresh version instead silently
        adopted any change that landed in between as the new baseline,
        and the watch then never fired for it (a permanent lost wakeup —
        found by the Watches workload in the chaos soak).

        ``baseline_value``: overrides the baseline read entirely — the
        set-then-watch pattern: when the watching transaction itself
        WROTE the key, the baseline is the value it wrote, not the
        pre-write value at its read version (which would fire the watch
        immediately and spuriously, turning watch loops into busy
        polls)."""
        from ..errors import FdbError, TransactionCancelled, TransactionTooOld
        from ..runtime.loop import now
        from ..runtime.trace import emit_span, swap_active_span
        from ..server.interfaces import Tokens as T
        from ..server.interfaces import WatchValueRequest

        baseline_known = baseline_value is not _NO_VALUE
        v0 = None if not baseline_known else baseline_value
        # Client.watch spans the whole register→fire lifetime (possibly
        # across failover re-registrations); the root comes from the first
        # internal transaction's sampling decision, and the registration
        # RPC carries it so Storage.watchFire joins the same trace.
        t0 = now()
        root = None
        try:
            while not out.is_ready():
                try:
                    tr = self.transaction()
                    if root is None:
                        root = tr._trace_root()
                    else:
                        tr.set_debug_id(root.trace_id)
                    if not baseline_known:
                        # the baseline is captured ONCE: a change landing
                        # during a failover retry must still fire the watch,
                        # not silently become the new baseline
                        if baseline_version is not None:
                            try:
                                tr.set_read_version(baseline_version)
                                v0 = await tr.get(key, snapshot=True)
                            except TransactionTooOld:
                                # the txn's version fell out of the MVCC
                                # window — the value may have changed since,
                                # unobservably: fire (watches may fire
                                # spuriously; they must never be lost)
                                tr = self.transaction()
                                v0 = await tr.get(key, snapshot=True)
                                if not out.is_ready():
                                    out._set(v0)
                                return
                        else:
                            v0 = await tr.get(key, snapshot=True)
                        baseline_known = True
                    else:
                        await tr.get_read_version()
                    req = WatchValueRequest(
                        key=key, value=v0, version=tr._read_version
                    )
                    # the RPC send snapshots the active span: install the
                    # watch root so the storage-side fire parents to it
                    prev = swap_active_span(root)
                    try:
                        reply = await tr._load_balanced(
                            key, T.WATCH_VALUE, req
                        )
                    finally:
                        swap_active_span(prev)
                    if not out.is_ready():
                        out._set(reply.value)
                    if root is not None:
                        emit_span("Client.watch", "client", root, t0, now())
                    return
                except (FdbError, BrokenPromise):
                    await delay(0.1)
                except Cancelled:
                    raise  # handled by the outer except (cancel contract)
                except Exception as e:
                    if not out.is_ready():
                        out._set_error(e)
                    return
        except Cancelled:
            # transaction reset/destroy cancels its watches: resolve the
            # caller-visible future with the non-retryable error (the
            # reference's watch lifetime contract), then let the runtime
            # see the cancellation
            if not out.is_ready():
                out._set_error(TransactionCancelled())
            raise  # actor-cancelled-swallow

    # -- transactions ----------------------------------------------------------

    def transaction(self, priority=None, tenant=None) -> Transaction:
        tr = Transaction(self)
        if priority is not None:
            tr.set_priority(priority)
        if tenant is not None:
            tr.set_tenant(tenant)
        return tr

    async def run(self, body, max_retries: Optional[int] = None):
        """Run ``await body(tr)`` then commit, retrying on retryable errors —
        the @transactional decorator semantics all bindings share."""
        tr = self.transaction()
        attempt = 0
        while True:
            try:
                result = await body(tr)
                await tr.commit()
                return result
            except Exception as e:
                attempt += 1
                if max_retries is not None and attempt > max_retries:
                    raise
                await tr.on_error(e)  # re-raises if not retryable
