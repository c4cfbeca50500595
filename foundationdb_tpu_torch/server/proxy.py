"""Proxy role: commit batching, the 5-phase commit pipeline, GRV service,
and key-location queries.

The analog of fdbserver/MasterProxyServer.actor.cpp:

- commit batching (batcher.actor.h): requests accumulate for
  COMMIT_BATCH_INTERVAL (or MAX_BATCH_TXNS), then run as one batch.
- commitBatch (:314-873), phases mirrored:
    1 (:352)  master assigns (prev_version, version) — the global chain
    2 (:408)  split conflict ranges across resolvers by key partition
              (ResolutionRequestBuilder:233), resolve, combine verdicts
    3 (:414)  substitute versionstamps, tag committed mutations per
              storage team (tagsForKey, :540-580)
    4 (:800)  push to the epoch's tlog set, wait for the durability quorum
    5 (:804)  advance committed version (master report, awaited — this is
              what makes GRV causally safe), reply per-txn
- GRV service (transactionStarter:925 / getLiveCommittedVersion:875):
  batched; returns the master's live committed version.
- key-location service (readRequestServer:1036) from the shard map.

Batches are pipelined: phase 1-2 of batch N+1 may run while batch N logs
(the latestLocalCommitBatchResolving/Logging gates, :353,415); version
chaining at resolver and tlog keeps application ordered.

A proxy belongs to one epoch. When its tlog set is locked by a recovering
master (TLogStopped from a push) the proxy is dead: it fails every pending
and future request, exactly like a reference proxy cut off at recovery —
clients see commit_unknown_result and move to the new epoch's proxies.
"""

from __future__ import annotations

import struct

from ..conflict.api import Verdict
from ..conflict.prefilter import ConflictPrefilter
from ..errors import GrvThrottled, NotCommitted, TransactionTooOld
from .admission import GrvAdmission
from ..kv.keyrange_map import KeyRangeMap
from ..kv.mutations import Mutation, MutationType
from ..net.sim import BrokenPromise, Endpoint
from ..runtime.futures import (
    Future,
    RequestBatcher,
    VersionGate,
    delay,
    settle_batch,
    timeout,
    wait_for_all,
    wait_for_any,
)
from ..runtime.knobs import Knobs
from ..runtime.loop import Cancelled, now
from ..runtime.serialize import BinaryWriter, write_mutation
from ..runtime.stats import CounterCollection
from ..runtime.trace import emit_span, span, swap_active_span
from .systemdata import (
    PRIVATE_PREFIX,
    TXS_TAG,
    apply_log_range_mutations,
    apply_metadata_mutations,
    is_metadata_mutation,
)


def _clip_for_capture(m, cap):
    """The portion of mutation `m` inside the capture range, or None.
    Mutations already in the system/backup keyspace are never captured."""
    if m.param1.startswith(b"\xff"):
        return None
    begin, end = cap["begin"], cap["end"]
    if m.type == MutationType.CLEAR_RANGE:
        b = max(m.param1, begin)
        e = m.param2 if end is None else min(m.param2, end)
        if b >= e:
            return None
        return Mutation(MutationType.CLEAR_RANGE, b, e)
    if m.param1 >= begin and (end is None or m.param1 < end):
        return m
    return None
from .interfaces import (
    CommitReply,
    CommitRequest,
    GetCommitVersionRequest,
    GetKeyServersReply,
    GetKeyServersRequest,
    GetReadVersionReply,
    GetReadVersionRequest,
    MasterInterface,
    ReportRawCommittedVersionRequest,
    ResolveBatchRequest,
    Tokens,
    TransactionData,
    Version,
)
from .log_system import LogSystem, spawn_retransmitting
from .tlog import TLogStopped
from ..runtime.buggify import buggify


class ShardMap:
    """Key → (team addresses, tags) map; the proxy's keyInfo, kept live by
    applying committed metadata mutations in version order
    (ApplyMetadataMutation). Each proxy owns its own copy."""

    def __init__(self):
        self.map = KeyRangeMap(default=None)  # → (tuple(addresses), tuple(tags))

    def set_shard(self, begin, end, addresses, tags) -> None:
        self.map.insert(begin, end, (tuple(addresses), tuple(tags)))

    def tags_for_key(self, key: bytes) -> tuple:
        return self.map[key][1]

    def tags_for_range(self, begin: bytes, end: bytes) -> set:
        out = set()
        for _, _, v in self.map.intersecting(begin, end):
            if v is not None:
                out.update(v[1])
        return out

    def team_for_key(self, key: bytes):
        """(begin, end, addresses, tags) of the shard containing key."""
        begin, end, v = self.map.range_for(key)
        return begin, end, v[0], v[1]

    def team_before_key(self, key: bytes):
        """(begin, end, addresses, tags) of the shard just below key."""
        begin, end, v = self.map.range_before(key)
        return begin, end, v[0], v[1]

    def to_list(self) -> list:
        return [
            (b, e, v[0], v[1]) for b, e, v in self.map.ranges() if v is not None
        ]

    @classmethod
    def from_list(cls, shards) -> "ShardMap":
        sm = cls()
        for begin, end, addrs, tags in shards:
            sm.set_shard(begin, end, addrs, tags)
        return sm


class ProxyDead(Exception):
    """This proxy's epoch ended (its tlogs are locked)."""


async def _swallow(fut):
    """Await a fire-and-forget request, discarding any error (the async
    master report: a dead master only matters to recovery, not to this
    commit, which is already durable)."""
    try:
        await fut
    except Cancelled:
        raise  # actor-cancelled-swallow
    except Exception:
        pass


class Proxy:
    def __init__(
        self,
        master: MasterInterface,
        resolver_map: KeyRangeMap,  # key range → ResolverInterface
        log_system: LogSystem,
        shards,  # ShardMap or [(begin, end, addrs, tags)] — copied either way
        knobs: Knobs = None,
        epoch: int = 0,
        recovery_version: Version = 0,
        uid: str = "",
        log_ranges: dict = None,  # uid → {begin, end, dest}: active captures
        peers: list = None,  # [(address, uid)] of ALL the epoch's proxies
    ):
        self.master = master
        # keyResolvers (MasterProxyServer.actor.cpp:183): key range →
        # VERSION HISTORY of owning resolvers, oldest..newest. Balancing
        # moves append (version, iface) entries delivered with version
        # grants; during the MVCC transition window reads fan out to every
        # owner back to their snapshot (each still holds its era's write
        # history — verdicts stay exact, no fence, no re-route race) and
        # writes go to the newest owner. Per-proxy (applied at each
        # proxy's own grant order), hence the copy.
        self.key_resolvers = KeyRangeMap()
        self._all_resolvers: list = []
        seen = set()
        for b, e, iface in resolver_map.ranges():
            self.key_resolvers.insert(b, e, ((0, iface),))
            if (iface.address, iface.uid) not in seen:
                seen.add((iface.address, iface.uid))
                self._all_resolvers.append(iface)
        self._resolver_index = {
            (i.address, i.uid): n for n, i in enumerate(self._all_resolvers)
        }
        self._last_kr_trim = 0.0
        self._applied_changes_version: Version = 0
        self.log_system = log_system
        if isinstance(shards, ShardMap):
            shards = shards.to_list()
        self.shards = ShardMap.from_list(shards)  # own copy: mutated by echoes
        self.log_ranges = dict(log_ranges or {})
        self.peers = [p for p in (peers or []) if p[1] != uid]
        self.knobs = knobs or Knobs()
        self.epoch = epoch
        self.uid = uid
        self.committed_version: Version = recovery_version
        self.last_resolver_versions: Version = recovery_version
        # highest version whose resolver state echoes this proxy has
        # APPLIED (phase 3) — the only receipt a hole-plug may claim
        self._state_applied: Version = recovery_version
        self.failed = False
        self.process = None
        self._batch: list[tuple[TransactionData, Future]] = []
        self._batch_trigger: Future = Future()
        self._work: Future = Future()
        # per-proxy batch sequencing: phase 1 (get version + send resolve)
        # and phase 3 (apply state mutations + tag) each run in batch order
        # (the latestLocalCommitBatchResolving/Logging gates, :353,415);
        # everything between pipelines freely
        self._local_batch = 0
        self._gcv_num = 0  # requestNum sequence for pipelined version asks
        self._resolving_gate = VersionGate(0)
        self._logging_gate = VersionGate(0)
        # GRV batching toward the master (transactionStarter batching);
        # created lazily — self.process is bound at register() time
        self._grv_batcher = None
        # consecutive master-unreachable batch failures: a proxy whose
        # master is gone dies with it (the reference proxy's lifetime is
        # tied to its master via waitFailure) instead of spamming empty
        # batches at a dead endpoint forever
        self._master_misses = 0
        # ProxyStats (MasterProxyServer.actor.cpp:60): commit/GRV traffic
        # counters + latency samples, traced periodically and served to the
        # status aggregator via the metrics endpoint
        self.stats = CounterCollection("Proxy", uid)
        self._c_txn_in = self.stats.counter("txnCommitIn")
        self._c_txn_committed = self.stats.counter("txnCommitOut")
        self._c_txn_conflict = self.stats.counter("txnConflicts")
        self._c_txn_too_old = self.stats.counter("txnTooOld")
        self._c_grv_in = self.stats.counter("txnStartIn")
        self._c_batches = self.stats.counter("commitBatchesOut")
        self._c_mutations = self.stats.counter("mutations")
        self._c_mutation_bytes = self.stats.counter("mutationBytes")
        self._l_commit = self.stats.latency("commitLatency")
        self._l_grv = self.stats.latency("grvLatency")
        # per-endpoint latency bands (the reference's GrvProxy/CommitProxy
        # LatencyBands): exact SLO histograms next to the sampled p50/p95
        self._b_commit = self.stats.bands("commitLatencyBands")
        self._b_grv = self.stats.bands("grvLatencyBands")
        # per-phase sim-time samples (batch-cut → reply), for latency work
        self._l_p1 = self.stats.latency("phase1Version")
        self._l_p2 = self.stats.latency("phase2Resolve")
        self._l_p4 = self.stats.latency("phase4LogPush")
        # GRV admission control (server/admission.py): per-class
        # + per-tenant token buckets fed by the Ratekeeper's getRate reply,
        # bounded queues with deadline shedding (grv_throttled). Ungated
        # until a getRate reply arrives (static clusters stay ungated).
        self.admission = GrvAdmission(self.knobs, self.stats)
        # conflict pre-filter (conflict/prefilter.py): decaying
        # summary of recently committed write ranges, fed from resolver
        # reply feedback, probed in commit() BEFORE the batch. Its own
        # CounterCollection (occupancy/decay gauges) nests under the
        # proxy's metrics as a "prefilter" section; the traffic counters
        # live on self.stats so status rates ride the proxy trace_loop.
        self.prefilter = (
            ConflictPrefilter(self.knobs, uid)
            if self.knobs.PROXY_CONFLICT_PREFILTER
            else None
        )
        self._c_prefiltered = self.stats.counter("prefiltered")
        self._c_prefilter_checks = self.stats.counter("prefilterChecks")
        self._c_prefilter_feedback = self.stats.counter("prefilterFeedbackRanges")
        self.stats.gauge("prefilter", self._prefilter_snapshot)

    # -- GRV -------------------------------------------------------------------

    async def get_read_version(self, req: GetReadVersionRequest) -> GetReadVersionReply:
        self._check_alive()
        self._c_grv_in.add()
        priority = getattr(req, "priority", 1)
        tenant = getattr(req, "tenant", "") or ""
        count = getattr(req, "count", 1)
        t0 = now()
        with span(
            "Proxy.grv", self.process.address, proxy=self.uid,
            priority=priority,
        ) as sp:
            # admission gate (server/admission.py): per-class + per-tenant
            # token buckets replenished from the Ratekeeper grant; a waiter
            # that can't be admitted by its class deadline (or arrives to a
            # full queue) sheds with the typed retryable grv_throttled
            # error — load sheds instead of latency collapsing
            t_gate = now()
            try:
                await self.admission.admit(priority, tenant, count)
            except GrvThrottled:
                if sp.sampled:
                    emit_span(
                        "Proxy.grvShed", self.process.address, sp, t_gate,
                        now(),
                    )
                raise
            self._check_alive()
            if sp.sampled and now() > t_gate:
                emit_span("Proxy.grvRateGate", self.process.address, sp, t_gate, now())
            # batched: requests that arrived before the master round trip began
            # share one getLiveCommitted fetch (transactionStarter batching,
            # MasterProxyServer.actor.cpp:925); arrivals during a flight form
            # the next batch (RequestBatcher's causality rule).
            if buggify():
                await delay(0.001)  # slow GRV (client sees stale-ish versions)
            if self._grv_batcher is None:
                self._grv_batcher = RequestBatcher(
                    self._fetch_live_version, self.process.spawn
                )
            t_confirm = now()
            version = await self._grv_batcher.join()
            if sp.sampled:
                emit_span(
                    "Proxy.grvConfirm", self.process.address, sp, t_confirm, now()
                )
        dt = now() - t0
        self._l_grv.add(dt)
        self._b_grv.add(dt)
        return GetReadVersionReply(version=version)

    async def _fetch_live_version(self):
        """getLiveCommittedVersion (MasterProxyServer.actor.cpp:875):
        max over every proxy's raw committed version — peer confirmation
        is what lets phase 5 reply WITHOUT awaiting a master round trip
        (causality: an acked commit at V raised its proxy's
        committed_version to ≥ V before the ack, and this GRV started
        after the ack, so that peer answers ≥ V). A dead peer never
        lowers the answer — we keep asking until it answers or this
        epoch dies (brokenPromiseToNever, :885)."""
        if not self.peers:
            # the master round trip alone is not enough: a deposed master
            # keeps answering getLiveCommitted below the new epoch's acked
            # commits — confirm tlog liveness concurrently, same as the
            # peer-vote path below
            confirm = self.process.spawn(
                self.log_system.confirm_live(self.process)
            )
            try:
                live = await self.process.request(
                    self.master.ep("getLiveCommitted"), None
                )
                await confirm
            except BaseException:
                confirm.cancel()  # don't orphan the confirm actor
                raise
            return max(live.version, self.committed_version)

        async def peer_version(address, uid):
            # bounded: a peer that stays unreachable for several failure
            # timeouts means this epoch is ending — error the GRV so the
            # client retries against the NEXT epoch's proxies (an unbounded
            # wait here outlived the role: destroy cancels the batcher
            # whose push failure would otherwise mark this proxy dead).
            # Each attempt is itself timed out: a PARTITIONED network drops
            # the request on the floor (net/sim.py) and the reply future
            # would otherwise never resolve at all.
            deadline = now() + self.knobs.FAILURE_TIMEOUT * 3
            while True:
                self._check_alive()
                try:
                    r = await timeout(
                        self.process.request(
                            Endpoint(address, f"proxy.rawCommitted#{uid}"),
                            None,
                        ),
                        1.0,
                    )
                    if r is not None:
                        return r
                except BrokenPromise:
                    pass
                # elapsed-time budget (not per-iteration increments): a peer
                # that answers instantly with BrokenPromise mid-restart must
                # not burn the whole budget in a few fast loop turns
                if now() >= deadline:
                    raise BrokenPromise(f"proxy peer {uid} unreachable")
                await delay(0.05)

        # epoch-liveness confirm (confirmEpochLive) rides CONCURRENTLY with
        # the peer round trip: after a recovering master locks this epoch's
        # tlogs, peer-confirmed GRVs among the old proxies could otherwise
        # hand out a read version below a commit the NEW epoch already
        # acked. One extra message round, zero extra latency.
        confirm = self.process.spawn(self.log_system.confirm_live(self.process))
        try:
            votes = await wait_for_all(
                [
                    self.process.spawn(peer_version(a, u))
                    for a, u in self.peers
                ]
            )
            await confirm
        except BaseException:
            confirm.cancel()  # don't orphan the confirm actor
            raise
        return max([self.committed_version, *votes])

    async def rate_poller(self):
        """Poll the master's ratekeeper (getRate:85); no ratekeeper (the
        static test cluster) means no gating. A run of failed polls (dead
        master) disables gating and wakes parked GRVs — a throttled client
        must not hang across a recovery."""
        interval = self.knobs.RK_POLL_INTERVAL
        misses = 0
        while True:
            await delay(interval)
            try:
                reply = await self.process.request(self.master.ep("getRate"), None)
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                reply = None
            if reply is None:
                misses += 1
                if misses >= 4 and self.admission.rates is not None:
                    self.admission.set_rates(None)
                continue
            misses = 0
            # per-class per-proxy rates; a legacy scalar reply
            # gates every class at the same rate
            if isinstance(reply, dict):
                self.admission.set_rates(reply.get("per_proxy") or {})
            else:
                r = float(reply)
                self.admission.set_rates(
                    {"batch": r, "default": r, "immediate": r}
                )

    # -- key location ----------------------------------------------------------

    async def get_key_servers(self, req: GetKeyServersRequest) -> GetKeyServersReply:
        self._check_alive()
        with span("Proxy.getKeyServers", self.process.address, proxy=self.uid):
            if buggify():
                await delay(0.001)  # slow key-location lookup
            if getattr(req, "before", False):
                begin, end, team, tags = self.shards.team_before_key(req.key)
            else:
                begin, end, team, tags = self.shards.team_for_key(req.key)
            return GetKeyServersReply(
                begin=begin, end=end, team=list(team), tags=list(tags)
            )

    # -- commit ----------------------------------------------------------------

    async def commit(self, req: CommitRequest) -> CommitReply:
        self._check_alive()
        if buggify():
            await delay(0.002)  # late-arriving commit (misses its batch)
        done: Future = Future()
        self._c_txn_in.add()
        t0 = now()
        # proxy-residency span (queue wait + batch pipeline); the batch's
        # stage spans nest under it via the context stored with the entry
        sp = span("Proxy.commit", self.process.address, proxy=self.uid)
        try:
            with sp:
                # pre-filter probe BEFORE the batch: a transaction the
                # summary proves doomed fails here with the same
                # retryable error the resolver would hand it, without
                # consuming a version grant or a batch slot
                if self.prefilter is not None and self._prefilter_reject(
                    req.transaction, sp
                ):
                    self._c_txn_conflict.add()
                    raise NotCommitted()
                self._batch.append((req.transaction, done, sp.context))
                if len(self._batch) == 1:
                    self._work._set(None)
                if len(self._batch) >= self.knobs.MAX_BATCH_TXNS:
                    self._batch_trigger._set(None)
                return await done
        finally:
            # failures (conflict/too-old) are client-observed commit
            # latency too — sample them all
            dt = now() - t0
            self._l_commit.add(dt)
            self._b_commit.add(dt)

    async def batcher_loop(self):
        while not self.failed:
            from_idle = False
            if not self._batch:
                self._work = Future()
                # an idle proxy still commits an EMPTY batch periodically:
                # that's how it receives the resolvers' forwarded state
                # mutations (its shard map would go stale otherwise) and
                # keeps the version chain moving (the reference's
                # commit-batch interval bounds / idle commits)
                which = await wait_for_any(
                    [self._work, delay(self.knobs.MAX_COMMIT_BATCH_INTERVAL)]
                )
                if which == 1 and not self._batch:
                    self.process.spawn(self.commit_batch([]))
                    continue
                from_idle = True
            # batch window: flush on interval or on the size trigger (which
            # may already have fired while we were parked on _work). A batch
            # opened from idle cuts sooner (the reference's
            # COMMIT_TRANSACTION_BATCH_INTERVAL_FROM_IDLE, Knobs.cpp:221) —
            # a lone transaction must not wait the full window
            if buggify():
                pass  # cut the batch immediately: tiny one-txn batches
            elif len(self._batch) < self.knobs.MAX_BATCH_TXNS:
                interval = (
                    self.knobs.COMMIT_BATCH_INTERVAL_FROM_IDLE
                    if from_idle
                    else self.knobs.COMMIT_BATCH_INTERVAL
                )
                trigger = self._batch_trigger = Future()
                await wait_for_any([trigger, delay(interval)])
            batch, self._batch = self._batch, []
            # commit batches run concurrently (pipelined); version chaining
            # at resolvers/tlogs orders application. The version request
            # fires at coroutine start — commit_batch coroutines begin in
            # spawn order, so requestNum order == local batch order
            self.process.spawn(self.commit_batch(batch))

    def _fire_gcv(self):
        """Fire one pipelined version request (requestNum keeps master-side
        assignment in submission order despite network reordering) — with
        one request at a time, a version RTT longer than the batch
        interval built an unbounded phase-1 queue."""
        num = self._gcv_num
        self._gcv_num += 1
        return self.process.request(
            self.master.ep("getCommitVersion"),
            GetCommitVersionRequest(
                requesting_proxy=self.uid,
                request_num=num,
                applied_changes_version=self._applied_changes_version,
            ),
        )

    async def commit_batch(self, batch):
        replies = [f for _, f, _ in batch]
        ctxs = [c for _, _, c in batch if c is not None]
        self._local_batch += 1
        local_n = self._local_batch
        vfut = self._fire_gcv()
        # the version-grant deadline anchors HERE (request submission), not
        # at phase-1 entry: phase 1 is serialized by the resolving gate, so
        # a deadline that started there would make a queue of doomed
        # batches (partition ate their requests) fail one full timeout at a
        # time instead of draining promptly
        vdeadline = now() + self.knobs.GETCOMMITVERSION_TIMEOUT
        try:
            await self._commit_batch(batch, local_n, vfut, vdeadline)
        except TLogStopped as e:
            # this epoch is over: a recovering master locked our tlogs.
            # EXPECTED end-of-life, not an actor crash — re-raising would
            # kill the hosting worker process on a real server
            # (die-on-actor-error), taking co-hosted roles with it
            self.failed = True
            # wake GRVs parked on the admission gate so they see failure
            self.admission.fail_all()
            for f in replies:
                if not f.is_ready():
                    f._set_error(BrokenPromise(str(e)))
            from ..runtime.trace import SevInfo, trace

            trace(
                SevInfo,
                "ProxyEpochEnded",
                getattr(self.process, "address", ""),
                Uid=self.uid,
                Epoch=self.epoch,
                Err=str(e),
            )
        except Exception as e:
            # a failed dependency (master/resolver/tlog unreachable) must
            # error every pending commit, not leave clients hanging; they
            # see it as commit_unknown_result. Swallow after reporting:
            # the clients have their answer and the batch actor's death
            # must not take the worker process down with it.
            # (Exception, NOT BaseException: KeyboardInterrupt/SystemExit
            # must still stop a real server.)
            for f in replies:
                if not f.is_ready():
                    f._set_error(e)
            # release the ordered-phase gates BEFORE the master-alive probe
            # below: a doomed-batch queue must drain at probe-free speed,
            # not serialize one probe timeout per batch (finally{} still
            # covers every other exit path)
            self._resolving_gate.advance_to(local_n)
            self._logging_gate.advance_to(local_n)
            from ..runtime.loop import Cancelled
            from ..runtime.trace import SevWarn, trace

            if isinstance(e, Cancelled):
                raise
            trace(
                SevWarn,
                "CommitBatchFailed",
                getattr(self.process, "address", ""),
                Uid=self.uid,
                Err=repr(e),
            )
            if isinstance(e, BrokenPromise) and "master" in str(e):
                # only count toward master-gone if the master is
                # unreachable NOW: a healed partition leaves a queue of
                # doomed batches whose version requests it ate, and their
                # drain must not kill a proxy whose master is back
                try:
                    alive = await timeout(
                        self.process.request(
                            self.master.ep("getLiveCommitted"), None
                        ),
                        1.0,
                    )
                except BrokenPromise:
                    alive = None
                if alive is not None:
                    self._master_misses = 0
                else:
                    self._master_misses += 1
                if self._master_misses >= self.knobs.PROXY_MASTER_MISS_LIMIT:
                    trace(
                        SevWarn,
                        "ProxyMasterGone",
                        getattr(self.process, "address", ""),
                        Uid=self.uid,
                    )
                    self.close()
        else:
            self._master_misses = 0
        finally:
            # a batch that died before its ordered phases must not wedge
            # its successors on the gates
            self._resolving_gate.advance_to(local_n)
            self._logging_gate.advance_to(local_n)

    async def _plug_version_hole(self, vfut):
        """A batch abandoned its version grant at the deadline, but the
        grant may arrive late (the request was delivered; only the reply
        was slow or lost). The master has chained later versions onto the
        granted one, so the chain hole MUST be filled — push an empty
        batch at exactly that (prev, version) through resolvers and tlogs,
        which order by prev_version chaining on their own. If the grant
        never arrives, no version was assigned and there is no hole."""
        try:
            vreq = await vfut
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception:
            return  # request truly lost: the master assigned nothing
        # a late grant can be the carrier of a balancing change set —
        # apply (idempotent) so the delivery isn't lost with the batch
        self._apply_resolver_changes(vreq)
        try:
            # built DIRECTLY, not via _send_resolve: the plug must neither
            # advance last_resolver_versions (the next real batch still
            # needs the echo window covering this version — the plug
            # discards its own echoes) nor claim receipt of state echoes
            # beyond what phase 3 actually applied (an overclaim lets the
            # resolver retire state txns another in-flight reply needs)
            lrv = min(self._state_applied, vreq.prev_version)
            # retransmitting (like every version-chained send): a plug
            # whose resolve is lost would leave the very hole it exists
            # to fill
            futs = [
                spawn_retransmitting(
                    self.process,
                    iface.ep("resolve"),
                    ResolveBatchRequest(
                        prev_version=vreq.prev_version,
                        version=vreq.version,
                        last_receive_version=lrv,
                        requesting_proxy=f"{self.process.address}#{self.uid}",
                        transactions=[],
                        state_txn_indices=[],
                    ),
                )
                for iface in self._all_resolvers
            ]
            await wait_for_all(futs)
            await self.log_system.push(
                self.process,
                vreq.prev_version,
                vreq.version,
                {},
                known_committed=self.committed_version,
            )
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception:
            pass  # epoch is ending; recovery fences and fills the chain

    async def _commit_batch(self, batch, local_n, vfut, vdeadline):
        txns = [t for t, _, _ in batch]
        replies = [f for _, f, _ in batch]
        ctxs = [c for _, _, c in batch if c is not None]
        debug_ids = [
            t.debug_id for t in txns if getattr(t, "debug_id", "")
        ]

        def _stage(name, t0, t1, skip_first=False):
            # per-stage spans for every sampled txn in the batch: each
            # sampled commit's waterfall carries the full phase breakdown.
            # skip_first: the first sampled txn already got a LIVE stage
            # span (the one parenting the downstream RPCs) — don't
            # double-attribute its wall time
            for c in ctxs[1 if skip_first else 0 :]:
                emit_span(name, self.process.address, c, t0, t1)

        def _live_stage(name):
            # a live stage span for the first sampled txn: activated
            # around the downstream RPC sends, so resolver/tlog server
            # spans nest UNDER the phase that paid for them (exact
            # critical-path accounting — no parallel-branch double count)
            return span(
                name,
                self.process.address,
                parent=ctxs[0] if ctxs else None,
                txns=len(txns),
            )

        def _debug(event):
            # transaction-debug chains (g_traceBatch,
            # MasterProxyServer.actor.cpp:345): one event per sampled txn
            # per pipeline phase
            if debug_ids:
                from ..runtime.trace import SevInfo, trace

                for did in debug_ids:
                    trace(
                        SevInfo, "CommitDebug", self.process.address,
                        Id=did, Event=event, Proxy=self.uid,
                    )

        _debug("ProxyReceived")

        # phase 1 (ordered): version assignment + send resolve requests.
        # Ordering phase 1 per proxy makes this proxy's commit versions
        # monotone in batch order, which phase 3 depends on. The version
        # request itself was fired at batch spawn (pipelined).
        t_p1 = now()
        await self._resolving_gate.wait_until(local_n - 1)
        try:
            # bounded: a getCommitVersion request dropped by a partition
            # never resolves (the sim net drops it on the floor), and the
            # master's gap-abandonment assumes the proxy's batch fails on
            # its own. Without this timeout the batch hangs at vfut forever
            # and every successor wedges on _resolving_gate. (A zero-or-
            # negative remaining budget still propagates a settled vfut's
            # real error instead of fabricating one.)
            vreq = await timeout(vfut, max(0.0, vdeadline - now()))
            if vreq is None:
                # the grant may still arrive LATE (request delivered, reply
                # slow or eaten): if it ever does, the master has chained
                # later versions onto it, and an unfilled hole in the
                # prev->version chain wedges every subsequent batch at the
                # resolvers/tlogs forever. Leave a continuation to plug it.
                self.process.spawn(self._plug_version_hole(vfut))
                raise BrokenPromise(
                    "master getCommitVersion lost (request or reply dropped)"
                )
            self._apply_resolver_changes(vreq)
            prev_version, version = vreq.prev_version, vreq.version
            _debug("GotCommitVersion")
            # the resolve stage opens HERE (requests fire now, verdicts
            # collect in phase 2): activating it around the synchronous
            # send puts its context on every resolve RPC envelope
            rsp = _live_stage("Proxy.resolve")
            prev_ctx = swap_active_span(rsp.context)
            try:
                resolve_futs, resolve_meta = self._send_resolve(
                    prev_version, version, txns
                )
            finally:
                swap_active_span(prev_ctx)
        finally:
            # always release the chain — a failed batch must not wedge the
            # proxy; successors fail or succeed on their own
            self._resolving_gate.advance_to(local_n)
        self._l_p1.add(now() - t_p1)
        _stage("Proxy.getVersion", t_p1, now())

        # phase 2: await resolver verdicts
        t_p2 = now()
        resolutions = await wait_for_all(resolve_futs)
        self._l_p2.add(now() - t_p2)
        rsp.finish()
        _stage("Proxy.resolve", t_p2, now(), skip_first=True)
        _debug("Resolved")
        # absorb prefilter feedback: each reply's window is
        # (last_receive_version, version], and those windows tile exactly
        # per proxy (last_resolver_versions advances at SEND time in
        # _send_resolve), so no dedup watermark is needed — and duplicate
        # feeds would only re-store known ranges anyway (conservative)
        if self.prefilter is not None:
            fed = 0
            for reply in resolutions:
                fed += self.prefilter.feed(
                    getattr(reply, "committed_ranges", ()),
                    getattr(reply, "version_floor", 0),
                )
            if fed:
                self._c_prefilter_feedback.add(fed)
        verdicts = [Verdict.COMMITTED] * len(txns)
        for idxs, reply in zip(resolve_meta, resolutions):
            for i, v in zip(idxs, reply.committed):
                verdicts[i] = max(verdicts[i], Verdict(v))  # CONFLICT/TOO_OLD win

        # phase 3 (ordered): apply forwarded state mutations to the shard
        # map in version order, then tag this batch's mutations with the
        # updated map (commitBatch :414-580)
        t_p3 = now()
        await self._logging_gate.wait_until(local_n - 1)
        try:
            plan = self._apply_state_mutations(resolutions, version)
            self._state_applied = max(self._state_applied, version)
            to_log: dict[int, list[Mutation]] = {}
            stamps: list[bytes] = []
            log_counter = 0  # per-batch ordinal for backup-log keys
            for idx, (txn, verdict) in enumerate(zip(txns, verdicts)):
                stamp = make_versionstamp(version, idx)
                stamps.append(stamp)
                if verdict != Verdict.COMMITTED:
                    continue
                for m in substitute_versionstamps(txn.mutations, stamp):
                    self._c_mutations.add()
                    self._c_mutation_bytes.add(
                        len(m.param1) + len(m.param2 or b"")
                    )
                    if m.type == MutationType.CLEAR_RANGE:
                        tags = self.shards.tags_for_range(m.param1, m.param2)
                    else:
                        tags = self.shards.tags_for_key(m.param1)
                    for tag in tags:
                        to_log.setdefault(tag, []).append(m)
                    if is_metadata_mutation(m):
                        # every metadata mutation also rides the txs tag
                        # (the recovering master's shard-map delta stream)
                        to_log.setdefault(TXS_TAG, []).append(m)
                    # active mutation-log captures (backup/DR): duplicate
                    # the mutation into the backup-log keyspace (the
                    # \xff\x02 machinery — MasterProxyServer's
                    # vecBackupKeys handling in commitBatch phase 3)
                    for cap in self.log_ranges.values():
                        dup = _clip_for_capture(m, cap)
                        if dup is None:
                            continue
                        log_key = cap["dest"] + struct.pack(
                            ">QI", version, log_counter
                        )
                        log_counter += 1
                        w = BinaryWriter()
                        write_mutation(w, dup)
                        copy = Mutation(
                            MutationType.SET_VALUE, log_key, w.data()
                        )
                        for tag in self.shards.tags_for_key(log_key):
                            to_log.setdefault(tag, []).append(copy)
            # privatized copies: shard-assignment changes delivered through
            # the affected storage servers' own streams
            for m, private_tags in plan:
                priv = Mutation(
                    MutationType.SET_VALUE, PRIVATE_PREFIX + m.param1, m.param2
                )
                for tag in private_tags:
                    to_log.setdefault(tag, []).append(priv)
        finally:
            self._logging_gate.advance_to(local_n)
        _stage("Proxy.tag", t_p3, now())

        # phase 4: push to the tlog set. Application order is enforced by
        # the tlogs' own prev_version chaining, so pushes of successive
        # batches may be in flight simultaneously (the reference's
        # pipelining).
        t_p4 = now()
        with _live_stage("Proxy.logPush"):
            await self.log_system.push(
                self.process,
                prev_version,
                version,
                to_log,
                known_committed=self.committed_version,
            )
        self._l_p4.add(now() - t_p4)
        _stage("Proxy.logPush", t_p4, now(), skip_first=True)
        _debug("Logged")

        # phase 5: make the commit visible locally, then reply — the
        # master report is ASYNC (the reference replies straight after
        # the log push, MasterProxyServer.actor.cpp:821-835; GRV
        # causality comes from peer confirmation in _fetch_live_version,
        # not from the master). With no peer set (static single-proxy
        # harness), the report stays awaited so the master's GRV answer
        # keeps causality.
        if version > self.committed_version:
            self.committed_version = version
        report = self.process.request(
            self.master.ep("reportCommitted"),
            ReportRawCommittedVersionRequest(version=version),
        )
        if self.peers:
            self.process.spawn(_swallow(report))
        else:
            await report
        self._c_batches.add()
        # sim-only durability oracle: record the acked version BEFORE any
        # reply leaves (debug_advanceMinCommittedVersion,
        # MasterProxyServer.actor.cpp:805)
        oracle = getattr(getattr(self.process, "sim", None), "validation", None)
        if oracle is not None and any(
            v == Verdict.COMMITTED for v in verdicts
        ):
            oracle.note_acked(version)
        _debug("Replied")
        # batch-settle the whole batch's replies in one loop step
        # (futures.settle_batch): a wide commit batch used to
        # pay one wakeup per waiting txn actor here
        settles = []
        for verdict, reply, stamp in zip(verdicts, replies, stamps):
            if verdict == Verdict.COMMITTED:
                self._c_txn_committed.add()
                settles.append(
                    (reply, CommitReply(version=version, versionstamp=stamp), None)
                )
            elif verdict == Verdict.TOO_OLD:
                self._c_txn_too_old.add()
                settles.append((reply, None, TransactionTooOld()))
            else:
                self._c_txn_conflict.add()
                settles.append((reply, None, NotCommitted()))
        settle_batch(settles)

    def _apply_resolver_changes(self, vreq) -> None:
        """Boundary moves piggybacked on the version grant
        (MasterProxyServer.actor.cpp:370): append the new owner to each
        touched range's version history. Grant order == batch order, so a
        batch's routing map reflects exactly the changes at versions
        before its own. Idempotent by changes version: the master
        re-attaches a set until acked, and several in-flight grants can
        carry the same one."""
        cv = vreq.resolver_changes_version
        if vreq.resolver_changes and cv > self._applied_changes_version:
            self._applied_changes_version = cv
            for begin, end, iface in vreq.resolver_changes:
                self.key_resolvers.modify(
                    begin, end, lambda owners, i=iface, v=cv: owners + ((v, i),)
                )
        # periodic expiry (:847): owners older than the MVCC window below
        # the newest can no longer be consulted by any live snapshot
        t = now()
        if t - self._last_kr_trim > 1.0:
            self._last_kr_trim = t
            oldest = (
                vreq.prev_version
                - self.knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS
            )
            trimmed = KeyRangeMap()
            for b, e, owners in self.key_resolvers.ranges():
                os = list(owners)
                while len(os) > 1 and os[1][0] < oldest:
                    os.pop(0)
                if os and os[0][0] < oldest:
                    os[0] = (0, os[0][1])
                trimmed.insert(b, e, tuple(os))
            trimmed.coalesce()
            self.key_resolvers = trimmed

    def _send_resolve(self, prev_version, version, txns):
        """ResolutionRequestBuilder (MasterProxyServer.actor.cpp:233):
        conflict ranges are clipped per keyResolvers range; a READ piece
        goes to every owner from newest back to the first one older than
        the txn's snapshot (each era's owner holds that era's write
        history — together they cover the read exactly), a WRITE piece to
        the newest owner. Verdicts combine conservatively (committed iff
        every involved resolver committed). A system-keyspace txn
        additionally appears in EVERY resolver's request
        (state_txn_indices) — its metadata mutations ride on resolver 0's
        copy — so each resolver can echo it to every proxy with its own
        verdict (:302-305)."""
        universe = self._all_resolvers
        index = self._resolver_index
        # [(iface, idxs, datas, state_idxs)] in fixed epoch order
        resolvers = [(iface, [], [], []) for iface in universe]

        single = len(universe) == 1
        for i, t in enumerate(txns):
            is_state = any(is_metadata_mutation(m) for m in t.mutations)
            if single:
                rcr_by = [list(t.read_conflict_ranges)]
                wcr_by = [list(t.write_conflict_ranges)]
            else:
                rcr_by = [[] for _ in universe]
                wcr_by = [[] for _ in universe]
                for rb, re_ in t.read_conflict_ranges:
                    for cb, ce, owners in self.key_resolvers.intersecting(
                        rb, re_
                    ):
                        for j in range(len(owners) - 1, -1, -1):
                            v, iface = owners[j]
                            rcr_by[index[_ikey(iface)]].append((cb, ce))
                            if v <= t.read_snapshot:
                                # this era already covers every write the
                                # snapshot could conflict with (> snap);
                                # older eras hold only writes < v
                                break
                for wb, we in t.write_conflict_ranges:
                    for cb, ce, owners in self.key_resolvers.intersecting(
                        wb, we
                    ):
                        wcr_by[index[_ikey(owners[-1][1])]].append((cb, ce))
            for rn, (iface, idxs, datas, state_idxs) in enumerate(resolvers):
                rcr, wcr = rcr_by[rn], wcr_by[rn]
                if rcr or wcr or is_state:
                    state_muts = (
                        [m for m in t.mutations if is_metadata_mutation(m)]
                        if is_state and rn == 0
                        else []
                    )
                    if is_state:
                        state_idxs.append(len(datas))
                    idxs.append(i)
                    datas.append(
                        TransactionData(
                            read_snapshot=t.read_snapshot,
                            read_conflict_ranges=rcr,
                            write_conflict_ranges=wcr,
                            mutations=state_muts,
                            debug_id=getattr(t, "debug_id", ""),
                        )
                    )

        reqs, meta = [], []
        for iface, idxs, datas, state_idxs in resolvers:
            # every resolver sees every version to keep its chain advancing,
            # even with no transactions for it (Resolver.actor.cpp:104-122)
            # retransmitting: a lost resolve tears a hole in the
            # resolver's prev→version chain (wedging every later batch);
            # the resolver caches replies by version precisely so a
            # retransmit of a delivered-but-unanswered batch is safe; the
            # batch reads each entrant's error (a closed resolver's answer
            # fails the batch, not the process)
            reqs.append(
                spawn_retransmitting(
                    self.process,
                    iface.ep("resolve"),
                    ResolveBatchRequest(
                        prev_version=prev_version,
                        version=version,
                        last_receive_version=self.last_resolver_versions,
                        requesting_proxy=f"{self.process.address}#{self.uid}",
                        transactions=datas,
                        state_txn_indices=state_idxs,
                    ),
                )
            )
            meta.append(idxs)
        # monotonic: a late hole-plug must not regress the frontier that
        # normal (gate-ordered) batches advanced past it
        self.last_resolver_versions = max(self.last_resolver_versions, version)
        return reqs, meta

    def _apply_state_mutations(self, resolutions, version):
        """Apply every forwarded state txn (from any proxy) committed at a
        version ≤ this batch's to our shard map (and the active capture
        set), in version order; a state txn counts committed iff EVERY
        resolver's echo says so (commitBatch :432-450). Returns the
        privatization plan for state txns of THIS batch (only the
        committing proxy pushes them)."""
        r0 = resolutions[0]
        plan = []
        for vi, (v, entries) in enumerate(r0.state_mutations):
            for ti, (committed, muts) in enumerate(entries):
                for other in resolutions[1:]:
                    committed = committed and other.state_mutations[vi][1][ti][0]
                if not committed:
                    continue
                applied = apply_metadata_mutations(self.shards, muts)
                self._apply_log_range_mutations(muts)
                if v == version:
                    plan.extend(applied)
        return plan

    def _apply_log_range_mutations(self, muts) -> None:
        apply_log_range_mutations(self.log_ranges, muts)

    # -- wiring ----------------------------------------------------------------

    def _check_alive(self):
        if self.failed:
            raise BrokenPromise(f"proxy {self.uid} epoch {self.epoch} is dead")

    def close(self) -> None:
        """Role retirement (worker._destroy): fail fast so parked GRVs
        (admission queue + peer-confirm loops) error out instead of
        outliving the role."""
        self.failed = True
        self.admission.fail_all()

    def _prefilter_snapshot(self) -> dict:
        """Nested "prefilter" section of proxy.metrics — occupancy/decay
        gauges from the summary's own CounterCollection (the resolver's
        ``kernel`` gauge nesting is the precedent)."""
        if self.prefilter is None:
            return {"enabled": False}
        snap = self.prefilter.stats.snapshot()
        snap["enabled"] = True
        return snap

    def _prefilter_reject(self, t, sp) -> bool:
        """Probe the summary with ``t``'s read conflict ranges. On a hit,
        prove the rejection conservative against the sim oracle (every
        rejection re-run through authoritative history — a false
        rejection fails the simulation), then emit the Proxy.prefilter
        stage span + CommitDebug event and tell commit() to fail the
        transaction locally."""
        self._c_prefilter_checks.add()
        t0 = now()
        if not self.prefilter.check(t.read_snapshot, t.read_conflict_ranges):
            return False
        oracle = getattr(
            getattr(self.process, "sim", None), "prefilter_oracle", None
        )
        if oracle is not None:
            oracle.check_rejection(
                t.read_snapshot, t.read_conflict_ranges, proxy=self.uid
            )
        self._c_prefiltered.add()
        emit_span(
            "Proxy.prefilter", self.process.address, sp.context,
            t0, now(), proxy=self.uid, prefiltered=True,
        )
        if getattr(t, "debug_id", ""):
            from ..runtime.trace import SevInfo, trace

            trace(
                SevInfo, "CommitDebug", "",
                Id=t.debug_id, Event="Prefiltered", Proxy=self.uid,
            )
        return True

    async def _metrics(self, _req) -> dict:  # flowlint: disable=reg-endpoint-span — metrics pull
        return self.stats.snapshot()

    async def _raw_committed(self, _req) -> Version:  # flowlint: disable=reg-endpoint-span — admin/recovery
        """getRawCommittedVersion (MasterProxyServer.actor.cpp:1214): the
        peer-confirmation half of getLiveCommittedVersion."""
        self._check_alive()
        return self.committed_version

    def register(self, process) -> None:
        """Well-known tokens (static cluster)."""
        self.process = process
        process.register(Tokens.GRV, self.get_read_version)
        process.register(Tokens.COMMIT, self.commit)
        process.register(Tokens.GET_KEY_SERVERS, self.get_key_servers)
        process.register(f"proxy.metrics#{self.uid}", self._metrics)
        process.register(f"proxy.rawCommitted#{self.uid}", self._raw_committed)
        process.spawn(self.batcher_loop())
        process.spawn(self.admission.pump())
        process.spawn(self.stats.trace_loop(5.0, process.address))

    def register_instance(self, process) -> None:
        """Endpoints only — the hosting worker owns the batcher actor."""
        self.process = process
        process.register(f"{Tokens.GRV}#{self.uid}", self.get_read_version)
        process.register(f"{Tokens.COMMIT}#{self.uid}", self.commit)
        process.register(f"{Tokens.GET_KEY_SERVERS}#{self.uid}", self.get_key_servers)
        process.register(f"proxy.ping#{self.uid}", self._ping)
        process.register(f"proxy.metrics#{self.uid}", self._metrics)
        process.register(f"proxy.rawCommitted#{self.uid}", self._raw_committed)

    async def _ping(self, _req):  # flowlint: disable=reg-endpoint-span — liveness
        self._check_alive()
        return "pong"


# -- helpers ------------------------------------------------------------------


def _ikey(iface):
    return (iface.address, iface.uid)


def make_versionstamp(version: Version, batch_index: int) -> bytes:
    """10 bytes: 8-byte big-endian commit version + 2-byte batch order —
    the reference's versionstamp format (fdbclient/CommitTransaction.h)."""
    return struct.pack(">QH", version, batch_index)


def substitute_versionstamps(mutations, stamp: bytes):
    """Rewrite SET_VERSIONSTAMPED_KEY/VALUE to plain sets, patching the
    stamp in at the 4-byte little-endian offset trailing the parameter
    (the bindings' versionstamp convention)."""
    out = []
    for m in mutations:
        if m.type == MutationType.SET_VERSIONSTAMPED_KEY:
            key = _patch(m.param1, stamp)
            out.append(Mutation(MutationType.SET_VALUE, key, m.param2))
        elif m.type == MutationType.SET_VERSIONSTAMPED_VALUE:
            val = _patch(m.param2, stamp)
            out.append(Mutation(MutationType.SET_VALUE, m.param1, val))
        else:
            out.append(m)
    return out


def _patch(param: bytes, stamp: bytes) -> bytes:
    pos = struct.unpack("<I", param[-4:])[0]
    body = param[:-4]
    assert pos + 10 <= len(body), "versionstamp offset out of range"
    return body[:pos] + stamp + body[pos + 10 :]
