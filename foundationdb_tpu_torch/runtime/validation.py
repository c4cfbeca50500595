"""Simulation-only invariant oracles — the analog of fdbrpc/sim_validation.h.

The reference threads debug hooks through production code that are active
only under simulation (debug_advanceMaxCommittedVersion /
debug_checkMinCommittedVersion, sim_validation.h:38): every version ACKED
to a client is recorded, and every recovery's chosen epoch-end version is
checked against it — a recovery that picks an end version below an acked
commit has silently lost durable data, which no workload read would
reliably catch (the key may never be read again).

Wired at the same points as the reference: the proxy's phase-5 ack
(MasterProxyServer.actor.cpp:834 debug_advanceMinCommittedVersion) and the
master's epoch-end determination (masterserver.actor.cpp recovery).
"""

from __future__ import annotations


class DurabilityOracle:
    def __init__(self):
        self.max_acked = 0  # highest commit version acked to ANY client
        self.violations: list[str] = []

    def note_acked(self, version: int) -> None:
        if version > self.max_acked:
            self.max_acked = version

    def forfeit_above(self, version: int) -> None:
        """A forced lossy operation (force_recovery_with_data_loss /
        region failover) explicitly gives up acked commits above
        ``version`` — lower the watermark so later recoveries aren't
        charged with the forfeited tail. The loss is the operation's
        documented contract, not a durability bug."""
        if self.max_acked > version:
            self.max_acked = version

    def check_recovery(self, end_version: int, epoch: int) -> None:
        """A new epoch's end version must cover every acked commit."""
        if end_version < self.max_acked:
            msg = (
                f"recovery epoch {epoch} chose end version {end_version} "
                f"below acked commit {self.max_acked}: acked data LOST"
            )
            self.violations.append(msg)
            raise AssertionError(msg)


class PrefilterOracle:
    """Differential oracle for the proxy conflict pre-filter.

    The pre-filter's contract is *strictly conservative*: it may miss
    conflicts, but must NEVER reject a transaction the resolver would
    have committed. This oracle proves it: resolvers report every
    committed write range here at the same instant they journal it (so
    this history is a superset of anything any proxy's summary can
    contain — the feedback the proxy learns from is built from the same
    journal entries AFTER this call, and this oracle never forgets), and
    every pre-rejection is re-run against it. A rejection is excused
    only if (1) some read range provably overlaps a committed write at a
    version newer than the read snapshot — the authoritative resolver
    verdict would be CONFLICT — or (2) the snapshot is below the
    resolver's forget horizon — the verdict would be TOO_OLD. Either
    way, never COMMITTED. Anything else is a real bug and fails the sim.
    """

    def __init__(self):
        # lazy import: runtime/ must not import conflict/ at module load
        from ..conflict.oracle import _StepFunction

        self._writes = _StepFunction()
        self.min_floor = 0  # lowest forget horizon any resolver reported
        self.committed_checked = 0
        self.rejections_checked = 0
        self.violations: list[str] = []

    def note_committed(self, version, ranges, oldest_version) -> None:
        for begin, end in ranges:
            self._writes.raise_to(bytes(begin), bytes(end), int(version))
        self.committed_checked += 1
        if oldest_version > self.min_floor:
            self.min_floor = int(oldest_version)

    def check_rejection(self, read_snapshot, read_ranges, proxy="") -> None:
        self.rejections_checked += 1
        for begin, end in read_ranges:
            if self._writes.max_over(bytes(begin), bytes(end)) > read_snapshot:
                return  # genuine conflict: resolver would convict too
        if read_snapshot < self.min_floor:
            return  # resolver would answer TOO_OLD, not COMMITTED
        msg = (
            f"prefilter FALSE REJECTION on proxy {proxy}: snapshot "
            f"{read_snapshot} conflicts with no committed write "
            f"(floor {self.min_floor}) — resolver would have committed"
        )
        self.violations.append(msg)
        raise AssertionError(msg)
