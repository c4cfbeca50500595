"""Tag-partitioned log system: epochs, quorum push, cross-generation peek.

The analog of fdbserver/LogSystem.h + TagPartitionedLogSystem.actor.cpp:

- a **TLogSet** is the tlog generation of one epoch: each storage tag is
  replicated on `replication` tlogs of the set (the reference's policy-based
  tlog teams, TagPartitionedLogSystem.actor.cpp:339 push).
- **push** sends every commit version to every tlog of the current set
  (messages filtered per tlog's tags; empty pushes still advance the
  version chain) and waits for all acks — the all-replicas durability
  policy, so a committed version is durable on *every* tlog holding its
  tags. That invariant is what makes recovery's epoch-end rule safe.
- on recovery, the new master **locks** the old set
  (TLogLockResult; tLogLock:467): each locked tlog stops accepting
  commits (fencing the old proxies) and reports its durable version. The
  epoch-end version = min over locked tlogs' durable versions — ≥ every
  acked commit (durable everywhere ⇒ ≤ each tlog's durable), so nothing
  acknowledged is lost; a not-fully-durable tail above it is discarded
  and surfaces to its clients as commit_unknown_result.
- an **OldTLogSet** (a locked generation + its end version) is kept in the
  config until every storage server has pulled past end_version
  (trackTlogRecovery, masterserver.actor.cpp:1009); the storage-side
  **PeekCursor** spans generations: versions ≤ an old set's end come from
  that set (clamped there), later versions from the current set.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..net.sim import BrokenPromise, Endpoint
from ..runtime.buggify import buggify
from ..runtime.futures import (
    AsyncVar,
    Future,
    delay,
    settled,
    wait_for_all,
    wait_for_any,
)
from ..runtime.loop import Cancelled


@dataclass(frozen=True)
class TLogInterface:
    """Endpoints of one tlog role instance (TLogInterface.h)."""

    address: str
    log_id: str
    tags: tuple  # storage tags stored here

    def ep(self, method: str) -> Endpoint:
        return Endpoint(self.address, f"tlog.{method}#{self.log_id}")


@dataclass(frozen=True)
class TLogSet:
    epoch: int
    logs: tuple  # tuple[TLogInterface]
    replication: int = 1

    def logs_for_tag(self, tag: int) -> list:
        return [l for l in self.logs if tag in l.tags]


@dataclass(frozen=True)
class OldTLogSet:
    """A locked prior generation; its data is valid through end_version."""

    set: TLogSet
    end_version: int


@dataclass(frozen=True)
class LogSystemConfig:
    epoch: int
    current: TLogSet
    old: tuple = ()  # tuple[OldTLogSet], ascending epoch


def assign_tags(
    addresses: list[str],
    log_ids: list[str],
    n_tags: int,
    replication: int,
    zones: list[str] = None,
) -> list[TLogInterface]:
    """Spread each tag over `replication` distinct tlogs — across distinct
    ZONES when the topology allows (the reference's policy-driven tlog
    team choice, ReplicationPolicy.h PolicyAcross over zoneId); plain
    round-robin otherwise."""
    assert len(addresses) >= replication, "need >= replication tlogs"
    owned = [set() for _ in addresses]
    by_zone: dict = {}
    if zones is not None:
        for i, z in enumerate(zones):
            by_zone.setdefault(z or addresses[i], []).append(i)
    if len(by_zone) >= replication:
        zlist = sorted(by_zone, key=lambda z: (-len(by_zone[z]), z))
        for t in range(n_tags):
            for r in range(replication):
                z = zlist[(t + r) % len(zlist)]
                grp = by_zone[z]
                owned[grp[(t // len(zlist)) % len(grp)]].add(t)
    else:
        for t in range(n_tags):
            for r in range(replication):
                owned[(t + r) % len(addresses)].add(t)
    return [
        TLogInterface(address=a, log_id=i, tags=tuple(sorted(o)))
        for a, i, o in zip(addresses, log_ids, owned)
    ]


# -- proxy side: push ----------------------------------------------------------


async def settle_bounded(futs: list, seconds: float) -> list[bool]:
    """Await up to `seconds` (one shared deadline) for each future to
    settle; returns a per-future success flag (settled without error).
    Dropped requests never settle at all — this bounds them."""
    deadline = delay(seconds)
    ok = []
    for fut in futs:
        which = await wait_for_any([settled(fut), deadline])
        ok.append(which == 0 and not fut.is_error())
    return ok


async def retransmitting_request(
    process, ep, req, attempts: int = 5, backoff: float = 0.05
):
    """A commit-pipeline RPC with bounded retransmission on transport
    loss. Resolve and tlog-commit requests are version-chained: a LOST
    request tears a hole in the prev→version chain that wedges every
    successor at the receiver's VersionGate forever, and a lost REPLY
    just needs the duplicate answered — both receivers were built for
    retransmits (the resolver caches replies by version,
    Resolver.actor.cpp:159's outstandingBatches analog; the tlog acks
    duplicate versions as already-durable), but nothing ever actually
    retransmitted until the transport-truncate chaos site
    wedged the pipeline through exactly this gap. Typed epoch-end errors
    (TLogStopped) propagate immediately; only the BrokenPromise family
    (transport loss, incl. TransportTruncated) retransmits."""
    from ..net.sim import BrokenPromise
    from ..runtime.futures import delay
    from ..runtime.loop import Cancelled

    last = None
    for attempt in range(attempts):
        if attempt:
            await delay(backoff * (1 << (attempt - 1)))
        try:
            return await process.request(ep, req)
        except Cancelled:
            raise  # actor-cancelled-swallow
        except BrokenPromise as e:
            last = e
    raise last


def spawn_retransmitting(process, ep, req):
    """``retransmitting_request`` as an actor of ``process`` whose spawner
    awaits it and reads its error: the entrant is marked
    ``Task.observed``, so a typed answer (a locked tlog's TLogStopped, a
    closed resolver's error) ends the caller's batch or epoch and is no
    unhandled actor death that kills the hosting server process."""
    fut = process.spawn(retransmitting_request(process, ep, req))
    fut._task.observed = True
    return fut


class LogSystem:
    """The proxy's handle on the current tlog generation (ILogSystem::push)."""

    def __init__(self, tlog_set: TLogSet):
        self.tlog_set = tlog_set

    async def push(
        self, process, prev_version, version, to_log: dict, known_committed: int = 0
    ) -> None:
        """Push one commit batch; resolves when durable on every tlog
        (the push quorum — all replicas of every tag, see module doc).
        Individual pushes retransmit on transport loss: a push abandoned
        mid-epoch would leave a version hole that wedges the tlog's
        commit chain (duplicates are acked as already-durable)."""
        if buggify():
            from ..runtime.futures import delay

            await delay(0.001)  # slow log fan-out (stretches the pipeline)
        from .interfaces import TLogCommitRequest

        from .systemdata import TXS_TAG

        pushes = []
        for log in self.tlog_set.logs:
            # the txs (transaction-state) tag rides on EVERY tlog so any
            # locked replica can rebuild the shard map at recovery
            msgs = {
                t: ms for t, ms in to_log.items() if t in log.tags or t == TXS_TAG
            }
            # this push reads each entrant's error (TLogStopped ends the
            # proxy's epoch in its caller)
            pushes.append(
                spawn_retransmitting(
                    process,
                    log.ep("commit"),
                    TLogCommitRequest(
                        epoch=self.tlog_set.epoch,
                        prev_version=prev_version,
                        version=version,
                        messages=msgs,
                        known_committed=known_committed,
                    ),
                )
            )
        await wait_for_all(pushes)

    async def confirm_live(self, process) -> None:
        """Prove this epoch has not ended (confirmEpochLive,
        TagPartitionedLogSystem.actor.cpp:456): recovery must lock at least
        one replica of EVERY tag before it can determine the epoch end, so
        if every replica of ANY single tag confirms it is unlocked, no
        newer epoch can have acked a commit before those replies were sent.
        Raises BrokenPromise when no tag can fully confirm (epoch fenced or
        tlogs unreachable) — the caller errors its GRV batch and clients
        retry against the next epoch's proxies."""
        logs = self.tlog_set.logs
        futs = [process.request(l.ep("confirmRunning"), None) for l in logs]
        members = {}  # tag -> replica indices
        for i, log in enumerate(logs):
            for t in log.tags:
                members.setdefault(t, []).append(i)
        deadline = delay(1.0)
        ok: set = set()
        bad: set = set()
        while True:
            # return the moment ANY tag fully confirms — one slow or dead
            # tlog must not tax every GRV batch with the full deadline
            if any(all(i in ok for i in m) for m in members.values()):
                return
            # fail fast once no tag CAN fully confirm anymore
            if not any(
                all(i not in bad for i in m) for m in members.values()
            ):
                raise BrokenPromise(
                    "epoch not live: no tag fully confirmed running"
                )
            pending = [i for i in range(len(futs)) if i not in ok | bad]
            which = await wait_for_any(
                [settled(futs[i]) for i in pending] + [deadline]
            )
            if which == len(pending):
                raise BrokenPromise("epoch not live: confirm timed out")
            i = pending[which]
            (bad if futs[i].is_error() else ok).add(i)


# -- recovery side: lock -------------------------------------------------------


async def lock_tlog_set(
    process, tlog_set: TLogSet, epoch: int, timeout_per_try: float = 1.0
):
    """Lock every reachable tlog of a prior generation; returns
    {log_id: TLogLockReply}. Retries until, for every tag, at least one
    replica is locked (enough to both fence old proxies on that tag and
    serve the tag's data to storage)."""
    from .interfaces import TLogLockRequest

    locked: dict[str, object] = {}
    while True:
        pending = [l for l in tlog_set.logs if l.log_id not in locked]
        futs = [
            process.request(l.ep("lock"), TLogLockRequest(epoch=epoch))
            for l in pending
        ]
        flags = await settle_bounded(futs, timeout_per_try)
        for log, fut, good in zip(pending, futs, flags):
            if good:
                locked[log.log_id] = fut.get()
        all_tags = {t for log in tlog_set.logs for t in log.tags}
        covered = all(
            any(l.log_id in locked for l in tlog_set.logs_for_tag(t))
            for t in all_tags
        )
        if covered and locked:
            return locked
        await delay(0.5)


def epoch_end_version(lock_replies: dict) -> int:
    """min over locked tlogs' durable versions (see module doc for why this
    can't lose an acknowledged commit)."""
    return min(r.end_version for r in lock_replies.values())


# -- storage side: cross-generation peek cursor --------------------------------


class PeekCursor:
    """Storage server's view of its tag's mutation stream across epochs
    (ILogSystem::peek + LogSystemPeekCursor.actor.cpp merge cursors).

    next(begin) returns (messages, end_version) with version > begin...end,
    routed to the generation that owns `begin`, failing over across the
    tag's replicas inside that generation."""

    def __init__(self, process, tag: int, config_var: AsyncVar, consumer="ss"):
        self.process = process
        self.tag = tag
        self.config_var = config_var  # AsyncVar[LogSystemConfig]
        self.consumer = consumer  # pop-frontier class at the tlogs
        self._replica = 0  # failover rotation
        # highest proxy-acked commit any replica has piggybacked: the
        # consumer's committed frontier (watch firing / feed visibility
        # gate — a recovery boundary can never cut below it)
        self.known_committed = 0

    def _generation(self, cfg: LogSystemConfig, begin: int):
        """(TLogSet, clamp_version) owning versions from `begin`."""
        for old in cfg.old:
            if begin <= old.end_version:
                return old.set, old.end_version
        return cfg.current, None

    async def next(self, begin: int):
        """One peek: returns ([(version, mutations)], end_version) with
        entries > begin; blocks (long-poll at the tlog) until data exists."""
        from .interfaces import TLogPeekRequest

        while True:
            cfg = self.config_var.get()
            if cfg is None:
                await self.config_var.on_change()
                continue
            tlog_set, clamp = self._generation(cfg, begin + 1)
            replicas = tlog_set.logs_for_tag(self.tag)
            if not replicas:
                # tag not in this generation (shouldn't happen) — wait
                await wait_for_any([self.config_var.on_change(), delay(0.5)])
                continue
            log = replicas[self._replica % len(replicas)]
            if buggify():
                self._replica += 1  # rotate replica mid-stream (failover path)
                log = replicas[self._replica % len(replicas)]
            req = TLogPeekRequest(tag=self.tag, begin=begin + 1)
            fut = self.process.request(log.ep("peek"), req)
            # a peek may long-poll forever at a tlog of a generation that
            # just got superseded; wake on config change and re-route
            # (settled: a dead tlog's BrokenPromise must not kill the
            # caller — it's a failover signal)
            which = await wait_for_any([settled(fut), self.config_var.on_change()])
            if which == 1:
                fut.cancel()
                continue
            if fut.is_error():
                err = fut._error
                if isinstance(err, BrokenPromise):
                    self._replica += 1  # failover to the next replica
                    await delay(0.05)
                    continue
                raise err
            reply = fut.get()
            if reply.known_committed > self.known_committed:
                self.known_committed = reply.known_committed
            msgs, end = reply.messages, reply.end_version
            if clamp is not None:
                msgs = [(v, ms) for v, ms in msgs if v <= clamp]
                if end >= clamp:
                    # this replica is durable through the generation's end —
                    # the whole old generation is consumed; advance past it
                    end = clamp
            # No progress — a STOPPED (or behind) replica answers
            # immediately instead of long-polling, and versions above its
            # durable end may exist on another replica (lock only
            # guarantees >= 1 locked replica per tag). Back off and fail
            # over: without the delay this is a HOT LOOP that pins the
            # event loop of a real server whose storage is caught up to a
            # fenced tlog (found by the fdbmonitor restart soak — the
            # spinning worker starved the very lock/recovery traffic that
            # would have produced a new generation to follow).
            if end <= begin and not msgs:
                self._replica += 1
                await delay(0.05)
                continue
            return msgs, end

    async def pop(self, upto: int) -> None:
        """Ack data ≤ upto to every generation replica (tLogPop:861)."""
        from .interfaces import TLogPopRequest

        cfg = self.config_var.get()
        if cfg is None:
            return
        sets = [o.set for o in cfg.old] + [cfg.current]
        futs = []
        for s in sets:
            for log in s.logs_for_tag(self.tag):
                futs.append(
                    self.process.request(
                        log.ep("pop"),
                        TLogPopRequest(
                            tag=self.tag, upto=upto, consumer=self.consumer
                        ),
                    )
                )
        for f in futs:
            try:
                await f
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                pass  # popping a dead tlog is moot
