"""Master role: version assignment and committed-version tracking.

The analog of fdbserver/masterserver.actor.cpp's version authority
(getVersion:763 / provideVersions:830 and liveCommittedVersion
bookkeeping): ``Master`` hands out strictly increasing (prev_version,
version) pairs per commit batch; the prev→version chain is what lets
resolvers and tlogs apply batches in version order with no other
coordination (Resolver.actor.cpp:104-122). Versions advance with wall
(virtual) time at VERSIONS_PER_SECOND so they double as coarse timestamps,
like the reference.

The port's copy of the version authority of
``foundationdb_tpu/server/master.py`` (``Master``, ``MasterTerminated``,
``_split_points``), with every draw, buggify site and reply the same. The
recovery state machine is not here yet: ``master_core`` and its helpers
(``_RolePicker``, ``_seed_storage``, ``_wait_failure``,
``_track_tlog_recovery``), ``DBCoreState`` and ``_router_frontier`` need
the coordinators, the workers and the cluster controller, and come with
the dynamic cluster (ROADMAP queue A, item 9). The static ``Cluster``
(server/cluster.py) wires a ``Master`` by hand.
"""

from __future__ import annotations

from ..runtime.futures import delay
from ..runtime.loop import now
from ..runtime.buggify import buggify
from .interfaces import (
    GetCommitVersionReply,
    GetCommitVersionRequest,
    GetReadVersionReply,
    ReportRawCommittedVersionRequest,
    Tokens,
)

VERSIONS_PER_SECOND = 1_000_000
MAX_VERSION_JUMP = 10 * VERSIONS_PER_SECOND


class Master:
    def __init__(self, first_version: int = 0, uid: str = "", knobs=None):
        self.uid = uid
        self.knobs = knobs
        self.last_assigned = first_version
        self.last_assigned_at = 0.0
        self.live_committed = first_version
        # per-proxy requestNum sequencing (masterserver.actor.cpp:316
        # getVersion): a proxy pipelines several version requests; the
        # network may reorder them, but versions must be assigned in
        # submission order or the proxy's batch-order/version-order
        # invariant (phase 3) breaks
        self._req_seq: dict[str, int] = {}
        self._parked: dict[tuple, object] = {}  # (proxy, num) → Future
        # resolutionBalancing (masterserver.actor.cpp:216,806): pending
        # boundary moves, attached to every proxy's version grants until
        # the proxy ACKS the changes version in a later request — a lost
        # grant reply must not lose the delivery
        self._resolver_changes: tuple = ()
        self._resolver_changes_version: int = 0
        self._changes_proxy_ids: list = []
        self._changes_acked: dict[str, int] = {}

    def set_resolver_changes(self, moves, proxy_ids) -> bool:
        """Record boundary moves [(begin, end, iface)]; they reach every
        proxy piggybacked on version grants and apply from the next
        version. Refused (False) while a previous set is still being
        delivered — the balancer retries next interval."""
        if self._resolver_changes and any(
            self._changes_acked.get(p, 0) < self._resolver_changes_version
            for p in self._changes_proxy_ids
        ):
            return False
        self._changes_proxy_ids = list(proxy_ids)
        self._resolver_changes = tuple(moves)
        self._resolver_changes_version = self.last_assigned + 1
        return True

    # -- handlers --------------------------------------------------------------

    async def get_commit_version(
        self, req: GetCommitVersionRequest
    ) -> GetCommitVersionReply:
        if buggify():
            await delay(0.001)  # slow version assignment (phase-1 stall)
        if req.request_num >= 0:
            from ..runtime.futures import Future, timeout as _timeout

            expected = self._req_seq.get(req.requesting_proxy, 0)
            if req.request_num < expected:
                # a predecessor was skipped after its request was lost
                # (partition drops requests on the floor); assigning now
                # would violate the proxy's version-order invariant
                raise RuntimeError(
                    f"stale version request {req.request_num} < {expected}"
                )
            if req.request_num != expected:
                # arrived early: park until predecessors are assigned —
                # bounded, because a partition may have dropped a
                # predecessor outright; on expiry, abandon the gap (the
                # proxy's batch for the lost request fails on its own)
                gate: Future = Future()
                key = (req.requesting_proxy, req.request_num)
                self._parked[key] = gate
                fired = await _timeout(
                    gate,
                    getattr(
                        self.knobs, "MASTER_VERSION_GAP_TIMEOUT", 4.0
                    ),
                )
                self._parked.pop(key, None)
                if fired is None and self._req_seq.get(
                    req.requesting_proxy, 0
                ) > req.request_num:
                    raise RuntimeError("superseded while parked")
            self._req_seq[req.requesting_proxy] = req.request_num + 1
        prev = self.last_assigned
        t = now()
        advance = int((t - self.last_assigned_at) * VERSIONS_PER_SECOND)
        advance = max(1, min(advance, MAX_VERSION_JUMP))
        self.last_assigned = prev + advance
        self.last_assigned_at = t
        if req.request_num >= 0:
            nxt = self._parked.pop(
                (req.requesting_proxy, req.request_num + 1), None
            )
            if nxt is not None:
                nxt._set(True)  # truthy: distinguishes wake from timeout
        changes, changes_v = (), 0
        if req.requesting_proxy:
            acked = self._changes_acked.get(req.requesting_proxy, 0)
            if req.applied_changes_version > acked:
                acked = self._changes_acked[req.requesting_proxy] = (
                    req.applied_changes_version
                )
            if self._resolver_changes and acked < self._resolver_changes_version:
                changes = self._resolver_changes
                changes_v = self._resolver_changes_version
        return GetCommitVersionReply(
            prev_version=prev,
            version=self.last_assigned,
            resolver_changes=changes,
            resolver_changes_version=changes_v,
        )

    async def report_committed(self, req: ReportRawCommittedVersionRequest):
        if req.version > self.live_committed:
            self.live_committed = req.version
        return None

    async def get_live_committed(self, _req) -> GetReadVersionReply:
        return GetReadVersionReply(version=self.live_committed)

    async def _ping(self, _req):
        return "pong"

    # -- wiring ----------------------------------------------------------------

    def register(self, process) -> None:
        process.register(Tokens.GET_COMMIT_VERSION, self.get_commit_version)
        process.register(Tokens.REPORT_COMMITTED, self.report_committed)
        process.register(Tokens.GET_LIVE_COMMITTED, self.get_live_committed)

    def register_instance(self, process) -> None:
        process.register(
            f"{Tokens.GET_COMMIT_VERSION}#{self.uid}", self.get_commit_version
        )
        process.register(f"{Tokens.REPORT_COMMITTED}#{self.uid}", self.report_committed)
        process.register(
            f"{Tokens.GET_LIVE_COMMITTED}#{self.uid}", self.get_live_committed
        )
        process.register(f"master.ping#{self.uid}", self._ping)


class MasterTerminated(Exception):
    """This master's tenure is over (fenced, or a role it recruited died)."""


def _split_points(n: int) -> list[bytes]:
    return [bytes([(256 * i) // n]) for i in range(1, n)]
