"""TLog role: the durable, tag-indexed write-ahead log of one epoch.

The analog of fdbserver/TLogServer.actor.cpp: commits arrive in version order
(prev_version chaining — tLogCommit:1115 waits on the same kind of
sequencing), are indexed by tag in memory (LogData:304), and are served to
storage servers as per-tag streams (tLogPeekMessages:903) with long-polling;
acked data is trimmed by pop (tLogPop:861).

Epoch fencing (tLogLock:467): a recovering master locks the tlog with its
higher epoch; a locked tlog rejects further commits — acks already sent
stand (that data is durable and counted by recovery), but nothing new from
the fenced epoch's proxies can become committed. The lock reply carries the
durable version; min over locked replicas = the epoch's end version
(see log_system.py).

Durability here is modeled (a simulated fsync delay before the ack — the
DiskQueue push+sync of doQueueCommit:1045); the native DiskQueue-backed
persistence joins with the storage-engine stage (SURVEY.md §7 stage 7).
"""

from __future__ import annotations

import bisect
from ..kv.diskqueue import DiskQueue
from ..runtime.futures import AsyncVar, Future, VersionGate, delay
from ..runtime.knobs import Knobs
from ..runtime.buggify import buggify
from ..runtime.stats import CounterCollection
from ..runtime.loop import Cancelled, now
from ..runtime.trace import emit_span, span
from .systemdata import TXS_TAG
from .interfaces import (
    TLogCommitRequest,
    TLogLockReply,
    TLogLockRequest,
    TLogPeekReply,
    TLogPeekRequest,
    TLogPopRequest,
    Version,
)

FSYNC_TIME = 0.0002  # simulated DiskQueue sync (SSD-class fsync)

# named chaos site (runtime/buggify.py): stall INSIDE the pipelined-fsync
# window — the version chain has been released at push time but the
# covering fsync round has not returned, so a kill here is a crash with
# successor versions already accumulating behind an unfinished round
# (recovery must discard the whole unacked suffix; see test_tlog_trim)
SITE_FSYNC_PIPELINE_STALL = ("server/tlog.py", "tlog-fsync-pipeline-stall")


class Spilled:
    """In-memory placeholder for a spilled entry: the payload lives only
    in the DiskQueue (spill-by-reference — the 6.3-style successor of the
    reference's value spill, TLogServer.actor.cpp:518 updatePersistentData:
    past TLOG_SPILL_THRESHOLD the tlog stops holding message payloads in
    memory and serves peeks by reading the queue file). Keeps just the tag
    set, which _trim and peek filtering need."""

    __slots__ = ("tags",)

    def __init__(self, tags):
        self.tags = frozenset(tags)

    def __contains__(self, tag):
        return tag in self.tags

    def __iter__(self):
        return iter(self.tags)

    def keys(self):
        return self.tags


class TLogStopped(Exception):
    """Commit to a locked (fenced) tlog — the reference's tlog_stopped."""


class TLog:
    def __init__(
        self,
        knobs: Knobs = None,
        tags: frozenset = None,
        epoch: int = 0,
        log_id: str = "",
        first_version: Version = 0,
        disk=None,  # SimDisk/RealDisk → DiskQueue persistence; None = modeled
        consumers: tuple = ("ss",),  # expected pop consumers per tag
    ):
        self.knobs = knobs or Knobs()
        self.tags = tags  # tags this tlog stores; None = all
        self.epoch = epoch
        self.log_id = log_id
        self.stopped = False  # locked by a higher-epoch master
        self.locked_by_epoch = -1
        # ascending [(version, {tag: [mutations]})]
        self._log: list[tuple[Version, dict]] = []
        self._versions: list[Version] = []  # parallel index for bisect
        self.version = AsyncVar(first_version)  # highest *durable* version
        self.known_committed = first_version  # proxy-reported committed
        self._gate = VersionGate(first_version)  # commit sequencing
        # version → durability future while an append+fsync is in flight;
        # duplicates await it instead of acking early
        self._pending: dict[Version, Future] = {}
        # consumer → {tag → popped-through version}. The reference gives
        # remote log routers their own tag space so their pop frontier is
        # independent of local storage's; here each CONSUMER CLASS keeps
        # its own frontier per tag and trimming honors the minimum over
        # every EXPECTED consumer — primary storage popping ahead of a
        # lagging router can no longer truncate data the remote region
        # hasn't relayed (TagPartitionedLogSystem's router-tag retention).
        self.consumers = tuple(consumers)
        self._pops: dict[str, dict[int, Version]] = {
            c: {} for c in self.consumers
        }
        self.dq = DiskQueue(disk, f"tlog-{log_id}") if disk is not None else None
        # every pushed dq entry (incl. empty versions), ascending:
        # [(version, start_offset, end_offset)]
        self._dq_index: list[tuple[Version, int, int]] = []
        self._pops_since_compact = 0
        # Serializes the DiskQueue pop/compact section: compaction rewrites
        # file offsets across suspension points, so a concurrent pop using
        # pre-compaction _dq_index offsets would persist a bogus popped
        # frontier (data loss at replication=1 after reboot).
        self._pop_busy = False
        self._pop_waiters: list[Future] = []
        # spill accounting: in-memory payload bytes per version; past
        # TLOG_SPILL_THRESHOLD the oldest durable entries' payloads are
        # evicted (Spilled markers) and served back from the DiskQueue
        self._entry_bytes: dict[Version, int] = {}
        self._mem_bytes = 0
        # TLogMetrics (TLogServer.actor.cpp:348 TLogData counters)
        self.stats = CounterCollection("TLog", log_id)
        self._c_commits = self.stats.counter("commits")
        self._c_bytes_in = self.stats.counter("bytesInput")
        self._c_peeks = self.stats.counter("peeks")
        self.stats.gauge("version", lambda: self.version.get())
        self.stats.gauge("knownCommitted", lambda: self.known_committed)
        self.stats.gauge("memBytes", lambda: self._mem_bytes)
        self.stats.gauge(
            "queueBytes",
            lambda: self.dq.bytes_used if self.dq is not None else 0,
        )
        # durability observability: fsyncRounds vs groupJoins is
        # the write-coalescing ratio ((rounds+joins)/rounds commits per
        # physical fsync); fsyncSeconds is cumulative time inside
        # write+fsync rounds; pipelineDepth is the high-water number of
        # version commits overlapped behind an in-flight fsync round
        self._modeled_fsyncs = 0
        self._modeled_fsync_s = 0.0
        self._pipeline_peak = 0
        self.stats.gauge(
            "fsyncRounds",
            lambda: self.dq.commits
            if self.dq is not None
            else self._modeled_fsyncs,
        )
        self.stats.gauge(
            "groupJoins",
            lambda: self.dq.group_joins if self.dq is not None else 0,
        )
        self.stats.gauge(
            "fsyncSeconds",
            lambda: round(
                self.dq.fsync_seconds
                if self.dq is not None
                else self._modeled_fsync_s,
                6,
            ),
        )
        self.stats.gauge("pipelineDepth", lambda: self._pipeline_peak)

    async def recover(self) -> None:
        """Rebuild from the DiskQueue after a reboot
        (restorePersistentState:1547). A recovered tlog rejoins *stopped*:
        its generation missed pushes while it was down, so the version
        chain has a gap only a full recovery can close — it serves peeks
        and locks (its durable data still counts toward the epoch-end)
        but accepts no new commits."""
        assert self.dq is not None
        entries = await self.dq.recover()
        from ..runtime.serialize import read_tagged_messages

        last = self.version.get()
        for i, (offset, payload) in enumerate(entries):
            version, messages = read_tagged_messages(payload)
            end = (
                entries[i + 1][0] if i + 1 < len(entries) else self.dq._buffer_base
            )
            self._dq_index.append((version, offset, end))
            if messages:
                self._log.append((version, messages))
                self._versions.append(version)
                self._entry_bytes[version] = len(payload)
                self._mem_bytes += len(payload)
            last = max(last, version)
        self.version.set(last)
        self._maybe_spill()
        self._gate.advance_to(last)
        self.stopped = True
        self.locked_by_epoch = self.epoch

    async def commit(self, req: TLogCommitRequest):
        if self.stopped:
            raise TLogStopped(f"tlog {self.log_id} locked at {self.locked_by_epoch}")
        # push span under the proxy's batch span (RPC-envelope parent);
        # the queue child separates version-chain waiting from fsync time
        t0 = now()
        tsp = span("TLog.push", self._proc_addr(), log=self.log_id, version=req.version)
        try:
            # version-ordered application (same chain discipline as the resolver)
            await self._gate.wait_until(req.prev_version)
            if tsp.sampled and now() > t0:
                emit_span("TLog.queue", self._proc_addr(), tsp, t0, now())
            return await self._commit_inner(req)
        finally:
            tsp.finish()

    def _proc_addr(self) -> str:
        return getattr(getattr(self, "process", None), "address", "") or f"tlog:{self.log_id}"

    async def _commit_inner(self, req: TLogCommitRequest):
        if self.stopped:
            # fenced while waiting: must not make this durable/acked — the
            # recovery already chose an end version without it
            raise TLogStopped(f"tlog {self.log_id} locked at {self.locked_by_epoch}")
        dup = self._pending.get(req.version)
        if dup is not None:
            # appended and mid-fsync: a second append would double-apply at
            # storage, but acking now would claim durability that doesn't
            # exist yet — wait for the original's fsync
            await dup
            return None
        if req.version <= self._gate.version:
            # under pipelined fsync the gate is released at PUSH time, so a
            # past-gate version is provably durable only once the durable
            # high-water covers it; a retransmit landing in the gap left by
            # a cancelled push (appended, never fsynced) must not be acked
            if req.version <= self.version.get():
                return None  # duplicate (proxy retransmit): already durable
            raise Cancelled()
        pipeline = bool(getattr(self.knobs, "TLOG_FSYNC_PIPELINE", True))
        durable = self._pending[req.version] = Future()
        try:
            msgs = {
                t: ms
                for t, ms in req.messages.items()
                if ms and (self.tags is None or t in self.tags or t == TXS_TAG)
            }
            if msgs:
                self._log.append((req.version, msgs))
                self._versions.append(req.version)
            if self.dq is not None:
                # every version is logged (even empty): the durable high
                # water mark must survive reboot or the epoch-end rule
                # would discard acknowledged versions this tlog acked
                # while holding no payload for them
                from ..runtime.serialize import write_tagged_messages

                if buggify():
                    await delay(0.002)  # slow disk: fsync under pressure
                payload = write_tagged_messages(req.version, msgs)
                offset = self.dq.push(payload)
                self._dq_index.append((req.version, offset, self.dq._end))
                if msgs:
                    self._entry_bytes[req.version] = len(payload)
                    self._mem_bytes += len(payload)
                if pipeline:
                    # cross-commit group commit: release the
                    # version chain at push time — the in-memory append
                    # order already fixes this version's place, so the
                    # NEXT version's push can accumulate into the dq while
                    # this round's write+fsync is in flight (latecomers
                    # park on the active round and join the next one,
                    # which is how batches widen under load). The ack
                    # below still waits for the covering round's fsync.
                    self._gate.advance_to(req.version)
                    depth = len(self._pending)
                    if depth > self._pipeline_peak:
                        self._pipeline_peak = depth
                    if buggify(SITE_FSYNC_PIPELINE_STALL):
                        await delay(0.004)  # widen the unfsynced window
                await self.dq.commit()
            else:
                # modeled DiskQueue push + fsync
                if pipeline:
                    self._gate.advance_to(req.version)
                    depth = len(self._pending)
                    if depth > self._pipeline_peak:
                        self._pipeline_peak = depth
                fsync_s = getattr(self.knobs, "TLOG_FSYNC_TIME", FSYNC_TIME)
                await delay(fsync_s)
                self._modeled_fsyncs += 1
                self._modeled_fsync_s += fsync_s
            durable._set(None)
        finally:
            # on cancellation (process kill) the version must not stay
            # latched in _pending, or a retransmit after reboot would be
            # dropped as a duplicate without ever being made durable; any
            # duplicate parked on ``durable`` must not hang either
            self._pending.pop(req.version, None)
            if not durable.is_ready():
                durable._set_error(Cancelled())
        if self.stopped:
            # durable, but past the fence: never ack (the client sees
            # commit_unknown_result; peeks may serve it but the cursor
            # clamps at the epoch end version)
            raise TLogStopped(f"tlog {self.log_id} locked at {self.locked_by_epoch}")
        self._gate.advance_to(req.version)
        self._c_commits.add()
        self._c_bytes_in.add(self._entry_bytes.get(req.version, 0))
        if req.known_committed > self.known_committed:
            self.known_committed = req.known_committed
        if req.version > self.version.get():
            self.version.set(req.version)
        self._maybe_spill()
        return None

    async def confirmRunning(self, _req) -> bool:
        """GRV-path epoch-liveness probe (the reference's confirmEpochLive,
        TagPartitionedLogSystem.actor.cpp confirmEpochLive → tlog
        TLogConfirmRunningRequest): errors once a higher-epoch master has
        fenced this tlog, so old-epoch proxies stop answering GRVs from
        stale peer-confirmed state."""
        if self.stopped:
            raise TLogStopped(
                f"tlog {self.log_id} locked at {self.locked_by_epoch}"
            )
        return True

    async def lock(self, req: TLogLockRequest) -> TLogLockReply:
        """Fence this tlog for recovery by a higher epoch (tLogLock:467)."""
        if req.epoch > self.epoch and req.epoch > self.locked_by_epoch:
            self.stopped = True
            self.locked_by_epoch = req.epoch
            self.version.set(self.version.get())  # wake parked peeks
        return TLogLockReply(
            end_version=self.version.get(), known_committed=self.known_committed
        )

    def _maybe_spill(self) -> None:
        """Evict the oldest durable entries' payloads once memory exceeds
        TLOG_SPILL_THRESHOLD (updatePersistentData's trigger); peeks for
        them read the DiskQueue (spill-by-reference). A tag that never
        pops (a dead storage server) no longer grows tlog memory without
        bound — only the queue file grows."""
        if self.dq is None:
            return
        threshold = self.knobs.TLOG_SPILL_THRESHOLD
        if buggify():
            threshold = 64  # spill almost everything (exercise read-back)
        if self._mem_bytes <= threshold:
            return
        target = threshold // 2
        durable = self.version.get()
        for idx, (v, msgs) in enumerate(self._log):
            if self._mem_bytes <= target:
                break
            if isinstance(msgs, Spilled) or v > durable:
                continue
            self._log[idx] = (v, Spilled(msgs.keys()))
            self._mem_bytes -= self._entry_bytes.pop(v, 0)

    async def _read_spilled(self, version: Version):
        """Fetch a spilled entry's messages from the DiskQueue. Serialized
        with pop/compact (offsets are rewritten by compaction)."""
        while self._pop_busy:
            w = Future()
            self._pop_waiters.append(w)
            await w
        self._pop_busy = True
        try:
            vs = [v for v, _o, _e in self._dq_index]
            j = bisect.bisect_left(vs, version)
            if j >= len(self._dq_index) or self._dq_index[j][0] != version:
                raise IOError(f"tlog {self.log_id}: spilled {version} not in dq")
            _v, off, end = self._dq_index[j]
            payload = await self.dq.read_entry(off, end)
        finally:
            self._pop_busy = False
            if self._pop_waiters:
                self._pop_waiters.pop(0)._set(None)
        from ..runtime.serialize import read_tagged_messages

        _ver, messages = read_tagged_messages(payload)
        return messages

    async def peek(self, req: TLogPeekRequest) -> TLogPeekReply:
        self._c_peeks.add()
        # long-poll: wait until data through req.begin exists (a stopped
        # tlog's horizon is final — reply immediately with what it has)
        while self.version.get() < req.begin and not self.stopped:
            await self.version.on_change()
        durable = self.version.get()
        i = bisect.bisect_left(self._versions, req.begin)
        # clamp at the durable horizon: entries appended but not yet fsynced
        # must not be served (a peeker would double-apply them next poll)
        hi = bisect.bisect_right(self._versions, durable)
        out = []
        for v, msgs in list(self._log[i:hi]):
            if req.tag in msgs:
                if isinstance(msgs, Spilled):
                    full = await self._read_spilled(v)
                    if req.tag in full:
                        out.append((v, full[req.tag]))
                else:
                    out.append((v, msgs[req.tag]))
        return TLogPeekReply(
            messages=out,
            end_version=durable,
            known_committed=self.known_committed,
        )

    def _popped_for(self, tag: int) -> Version:
        """Effective popped frontier: min over expected consumers."""
        return min(self._pops[c].get(tag, 0) for c in self.consumers)

    async def pop(self, req: TLogPopRequest):
        consumer = getattr(req, "consumer", "ss") or "ss"
        frontier = self._pops.setdefault(consumer, {})
        prev = frontier.get(req.tag, 0)
        if req.upto > prev:
            frontier[req.tag] = req.upto
            # the dq pop/compact section below suspends (commit/compact
            # awaits); serialize concurrent pop handlers through it so no
            # one calls dq.pop with offsets from a stale _dq_index
            while self._pop_busy:
                w = Future()
                self._pop_waiters.append(w)
                await w
            self._pop_busy = True
            try:
                horizon = self._trim()
                if self.dq is not None and horizon is not None:
                    j = bisect.bisect_right(
                        [v for v, _o, _e in self._dq_index], horizon
                    )
                    if j:
                        # pop to the start of the first retained entry, or
                        # the END of the last one when everything is retired
                        # (a mid-entry frontier would make the compacted
                        # file start with a torn fragment and recovery
                        # would discard everything after it)
                        if j < len(self._dq_index):
                            self.dq.pop(self._dq_index[j][1])
                        else:
                            self.dq.pop(self._dq_index[-1][2])
                        del self._dq_index[:j]
                        self._pops_since_compact += 64 if buggify() else 1
                        # compact only with no commit in flight: compaction
                        # rewrites offsets and must not interleave with
                        # pushes
                        if (
                            self._pops_since_compact >= 64
                            and not self.stopped
                            and not self._pending
                        ):
                            self._pops_since_compact = 0
                            await self.dq.commit()
                            if not self._pending:
                                # entries appended while compact() is in
                                # flight already use new-file coordinates
                                # (a push during its copy phase aborts the
                                # compaction instead) — rebase only the
                                # entries that existed before the call
                                pre = len(self._dq_index)
                                shift = await self.dq.compact()
                                if shift:
                                    self._dq_index[:pre] = [
                                        (v, o - shift, e - shift)
                                        for v, o, e in self._dq_index[:pre]
                                    ]
            finally:
                self._pop_busy = False
                if self._pop_waiters:
                    self._pop_waiters.pop(0)._set(None)
        return None

    def _trim(self):
        """Drop log entries every tag has popped past (reference: DiskQueue
        pop location advancing once all tags acknowledge). Returns the
        DiskQueue-safe trim horizon (or None).

        TXS_TAG is excluded from the horizon min: the txs stream is popped
        only by a recovering master (after the shard-map snapshot lands in
        the coordinated state), so including it would pin EVERY tag's data
        for the whole epoch the moment one metadata mutation is logged.
        Entries at/below the horizon that still carry unpopped txs data are
        retained txs-only (other tags' payloads stripped) — the reference's
        separate txnStateStore retention via LogSystemDiskQueueAdapter."""
        if not self._log:
            return None
        # a (non-txs) tag with data but no pop record pins the log
        live_tags = set()
        for _, msgs in self._log:
            live_tags.update(msgs)
        live_tags.discard(TXS_TAG)
        if live_tags:
            horizon = min(self._popped_for(t) for t in live_tags)
        else:
            horizon = self.version.get()  # only txs data remains
        # txs is popped by a recovering master only (one consumer class):
        # take the max frontier, not the cross-consumer min
        txs_popped = max(
            (f.get(TXS_TAG, 0) for f in self._pops.values()), default=0
        )
        if self._versions[0] > horizon:
            return horizon  # nothing at/below the horizon: no-op pop
        new_log = []
        for v, msgs in self._log:
            if v > horizon:
                new_log.append((v, msgs))
            elif TXS_TAG in msgs and v > txs_popped:
                if isinstance(msgs, Spilled):
                    new_log.append((v, Spilled({TXS_TAG})))
                elif len(msgs) == 1:
                    # already stripped to the txs sliver on a prior trim:
                    # contents (and accounting) can't have changed
                    new_log.append((v, msgs))
                else:
                    sliver = {TXS_TAG: msgs[TXS_TAG]}
                    new_log.append((v, sliver))
                    # re-account the retained sliver at its estimated size
                    # — subtracting the whole entry would let repeated
                    # trims carry unbounded txs payloads past the spill
                    # threshold unnoticed
                    if v in self._entry_bytes:
                        # only re-account entries that were ever counted:
                        # a modeled (dq=None) tlog tracks no entry bytes,
                        # and inventing them here would drive _mem_bytes
                        # negative when the entry is finally dropped
                        kept = 16 + sum(
                            len(m)
                            if isinstance(m, (bytes, bytearray))
                            else len(getattr(m, "param1", b""))
                            + len(getattr(m, "param2", b"") or b"")
                            + 9
                            for m in msgs[TXS_TAG]
                        )
                        self._mem_bytes -= self._entry_bytes[v] - kept
                        self._entry_bytes[v] = kept
            else:
                self._mem_bytes -= self._entry_bytes.pop(v, 0)
        self._log = new_log
        self._versions = [v for v, _ in new_log]
        # the DiskQueue frontier must stop short of the first retained
        # entry (pops are prefix-contiguous)
        if self._versions and self._versions[0] <= horizon:
            return self._versions[0] - 1
        return horizon

    async def _metrics(self, _req) -> dict:
        return self.stats.snapshot()

    def register_instance(self, process) -> None:
        """Id-suffixed tokens: many generations can share a worker."""
        self.process = process
        process.register(f"tlog.commit#{self.log_id}", self.commit)
        process.register(f"tlog.peek#{self.log_id}", self.peek)
        process.register(f"tlog.pop#{self.log_id}", self.pop)
        process.register(f"tlog.lock#{self.log_id}", self.lock)
        process.register(f"tlog.confirmRunning#{self.log_id}", self.confirmRunning)
        process.register(f"tlog.ping#{self.log_id}", _pong)
        process.register(f"tlog.metrics#{self.log_id}", self._metrics)


async def _pong(_req):
    return "pong"
