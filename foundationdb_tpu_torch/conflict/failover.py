"""Kernel fault tolerance around the ``newConflictSet()`` seam.

The resolver's MVCC conflict check lives on a device (the paper's bet) —
and a device is allowed to die. ``GuardedConflictSet`` wraps the backend
the resolver talks to with:

- a **bounded journal** of committed write conflict ranges inside the MVCC
  window (``WriteRangeJournal``) — the resolver already computes them, the
  journal just keeps them replayable;
- a **health state machine** HEALTHY → DEGRADED → FAILED_OVER →
  (re-probe) → HEALTHY, with FAILED as the terminal "even the fallback is
  gone" state (what used to be the resolver's permanent ``_broken``
  poison);
- **journal-replay recovery**: a faulted batch is re-resolved on a freshly
  built backend whose history is reconstructed from the journal. Replay is
  write-only blind transactions, so the rebuilt history is exactly the
  committed write set — verdict semantics are preserved with **zero false
  commits**; reads older than the journal floor turn TOO_OLD, i.e. at
  worst extra conservative aborts while replaying;
- **failover** to the ``native`` C++ skip list (or the ``oracle`` as a
  backstop) after repeated strikes, and **re-promotion** to the device
  backend once a periodic probe dispatch passes.

Deadline + bounded in-place retry live in the resolver
(server/resolver.py:_dispatch_collect), which owns the dispatch/collect
awaits; this module owns what happens when those fail.

The port's copy of ``foundationdb_tpu/conflict/failover.py``, with these
deliberate differences:

- Only a kernel fault reaches recovery and failover: a ``KernelFaultError``,
  or a torch error that says the card was lost or stopped answering
  (``errors.as_kernel_fault``). Anything else (no card, kernels that do not
  build or load, an illegal address, a failed assertion, a defect of the
  glue) leaves construction, recovery, re-probe, warm-up, clear and
  ``detect_batch`` as raised, so neither a missing card nor a broken
  kernel can pass for a failed-over resolver.
- Every recovery leaves a backend rebuilt from the journal (while failed
  over, a fresh fallback), and ``generation`` names it: the resolver
  re-resolves, in version order, each batch that was dispatched on a
  backend a recovery has since replaced.
- Re-promotion waits until the journal holds every batch dispatched on the
  fallback, so the promoted backend lacks none of them.
- One lock covers every call that reaches the backend. A device thread the
  resolver abandoned at a deadline may still be inside such a call, or run
  the jobs queued behind it; the lock keeps it from running beside the new
  device thread.
- ``close`` (the resolver's role is destroyed) frees the backend's device
  memory: at once when no call holds the lock, else when the call that
  holds it returns. A closed guard builds no backend again: every later
  call that would reach one, a recovery or a re-probe included, raises
  ``ConflictSetClosedError`` (a job queued on the device thread before
  the role was destroyed still runs).
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque

from ..runtime.knobs import Knobs
from ..runtime.loop import now as loop_now
from ..runtime.trace import SevError, SevInfo, SevWarn, trace
from .api import CommitTransaction, new_conflict_set
from .errors import ConflictSetClosedError, as_kernel_fault
from .faults import KernelTimeoutError, StaleEncodingError

# the device backends (the resolver's pipelined path)
DEVICE_BACKENDS = ("torch", "torch_mesh")

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
FAILED_OVER = "FAILED_OVER"
FAILED = "FAILED"

_STATE_ORDER = {HEALTHY: 0, DEGRADED: 1, FAILED_OVER: 2, FAILED: 3}


def health_rank(state: str) -> int:
    """Severity order for status roll-ups (worst state wins)."""
    return _STATE_ORDER.get(state, 0)


def fault_of(err: BaseException):
    """The kernel fault ``err`` stands for; anything else (a cancellation,
    a missing card, an unbuildable kernel, a defect) is raised again."""
    fault = as_kernel_fault(err)
    if fault is None:
        raise err
    return fault


def _locked(method):
    """Run ``method`` under the guard's lock (see the module docstring):
    on a closed guard it raises ``ConflictSetClosedError``, and a call
    that ``close`` overlapped frees the backend on its way out."""

    @functools.wraps(method)
    def run(self, *args, **kw):
        with self._lock:
            self._check_open()
            try:
                return method(self, *args, **kw)
            finally:
                if self._closed:
                    self._release_backend()

    return run


class KernelFailedError(RuntimeError):
    """Conflict kernel AND its fallback are broken — commits cannot be
    checked on this resolver. The structured (kernel.health=FAILED +
    SevError trace) replacement for the old opaque ``resolver backend
    failed`` RuntimeError."""


class WriteRangeJournal:
    """Bounded, version-ordered journal of committed write conflict ranges
    inside the MVCC window. ``floor`` is the first version whose committed
    history is fully journaled: replay onto a backend cleared at ``floor``
    reconstructs verdict-equivalent history for every snapshot >= floor,
    while older snapshots become TOO_OLD (a conservative abort, never a
    false commit)."""

    def __init__(self, capacity: int, floor: int = 0):
        self.capacity = max(int(capacity), 1)
        self.entries: deque = deque()  # (version, [(begin, end), ...]) ascending
        self.floor = floor
        self.dropped = 0

    def __len__(self) -> int:
        return len(self.entries)

    def record(self, version: int, ranges: list) -> None:
        if ranges:
            self.entries.append((version, list(ranges)))
        while len(self.entries) > self.capacity:
            v, _ = self.entries.popleft()
            self.floor = max(self.floor, v + 1)
            self.dropped += 1

    def trim_below(self, version: int) -> None:
        """MVCC GC: snapshots below ``version`` are TOO_OLD on any backend,
        so their history can never flip a verdict."""
        while self.entries and self.entries[0][0] < version:
            self.entries.popleft()
        self.floor = max(self.floor, version)

    def reset(self, floor: int) -> None:
        self.entries.clear()
        self.floor = floor

    def head_version(self) -> int:
        return self.entries[-1][0] if self.entries else self.floor

    def replay_into(self, cs) -> None:
        """Reconstruct history on a fresh backend: blind write-only txns
        always commit, so the backend ends with exactly the journaled
        committed writes at their original versions."""
        floor, entries = self.floor, list(self.entries)  # the loop thread records
        cs.clear(floor)
        work = [
            ([CommitTransaction(write_conflict_ranges=list(ranges))], v, 0)
            for v, ranges in entries
        ]
        if not work:
            return
        if hasattr(cs, "detect_many"):
            cs.detect_many(work)  # one device dispatch for the whole replay
        else:
            for txns, v, old in work:
                cs.detect_batch(txns, now=v, new_oldest_version=old)


class _GuardMetrics:
    """``resolver.metrics`` → ``kernel`` section: the inner device
    KernelMetrics snapshot (occupancy, replays, transfer bytes, …) merged
    with the guard's ``health`` subsection, so status/cli/bench consumers
    keep one well-known place to look."""

    def __init__(self, guard: "GuardedConflictSet"):
        self._guard = guard

    def snapshot(self) -> dict:
        inner = getattr(self._guard.primary, "metrics", None)
        out = inner.snapshot() if inner is not None else {}
        out["health"] = self._guard.health_snapshot()
        # encode-executor queue depth (the resolver owns the executor and
        # wires the callable; guard-level so it survives backend swaps)
        out["encodeQueueDepth"] = int(self._guard.encode_queue_fn())
        return out


class GuardedConflictSet:
    """The conflict set the resolver actually holds. Delegates to the
    current backend (device while healthy, native/oracle after failover)
    and owns journal + health + recovery. The async-dispatch protocol is
    emulated over sync fallbacks so the resolver's pipelined path keeps
    working across a failover."""

    def __init__(
        self,
        backend: str,
        knobs: Knobs = None,
        uid: str = "",
        fault_injector=None,
        **backend_kw,
    ):
        self.knobs = knobs or Knobs()
        self.kind = backend
        self.uid = uid
        self._kw = dict(backend_kw)
        self._injector = fault_injector
        self.journal = WriteRangeJournal(self.knobs.CONFLICT_JOURNAL_CAPACITY)
        self.health = HEALTHY
        self.last_error = ""
        self._strikes = 0
        self._gen = 0  # bumped on every backend swap (stale-encoding fence)
        self._last_probe = None
        # the newest version dispatched on the current backend, and the
        # newest the journal holds: re-promotion waits for the journal
        self._applied = 0
        self._journaled = 0
        # health counters (surfaced via health_snapshot → kernel.health)
        self.c_faults = 0
        self.c_retries = 0
        self.c_deadline_hits = 0
        self.c_rebuilds = 0
        self.c_failovers = 0
        self.c_reprobes = 0
        self.c_probe_failures = 0
        self.c_promotions = 0
        self.c_journal_replays = 0
        # wired by the resolver to its encode executor's queue depth
        self.encode_queue_fn = lambda: 0
        self.metrics = _GuardMetrics(self)
        self._lock = threading.RLock()
        self._closed = False
        self._cs = None  # set below; _note_fault may run before it exists
        self._fallback_kind = None
        try:
            self._cs = self._build_primary()
        except BaseException as e:
            # a backend that faults at boot: start failed over rather than
            # refuse the role — the journal is empty, so the fallback is
            # exactly equivalent
            self._note_fault(fault_of(e))
            self._failover()
        self.pipelined = hasattr(self._cs, "detect_many_encoded_async") or (
            self.health == FAILED_OVER and backend in DEVICE_BACKENDS
        )

    # -- backend construction / swap ------------------------------------------

    @property
    def primary(self):
        """The current backend, unwrapped of the fault injector (for
        isinstance checks and metrics access)."""
        return getattr(self._cs, "inner", self._cs)

    @property
    def backend_name(self) -> str:
        return type(self.primary).__name__ if self._cs is not None else "none"

    @property
    def failed(self) -> bool:
        return self.health == FAILED

    @property
    def generation(self) -> int:
        """Bumped by every backend swap: a batch dispatched on an older
        generation is not in the current backend's history."""
        return self._gen

    def _check_open(self) -> None:
        if self._closed:
            raise ConflictSetClosedError(f"conflict set of resolver {self.uid!r} is closed")

    def _build_primary(self):
        self._check_open()
        return new_conflict_set(
            self.kind, fault_injector=self._injector, **self._kw
        )

    def _swap(self, cs, health: str) -> None:
        self._cs = cs
        self._gen += 1
        self._applied = 0  # a swapped-in backend holds the journal alone
        self.health = health
        if health == HEALTHY:
            self.last_error = ""

    def _note_fault(self, err) -> None:
        self.c_faults += 1
        self._strikes += 1
        if isinstance(err, KernelTimeoutError) and "recovery" in str(err):
            # sync-path hang (no resolver deadline wait counted it)
            self.c_deadline_hits += 1
        self.last_error = repr(err)
        if self.health == HEALTHY:
            self.health = DEGRADED
        trace(
            SevWarn,
            "KernelFault",
            "",
            Resolver=self.uid,
            Backend=self.backend_name,
            Strikes=self._strikes,
            Health=self.health,
            Err=repr(err),
        )

    def note_retry(self) -> None:
        self.c_retries += 1
        if self.health == HEALTHY:
            self.health = DEGRADED

    def note_deadline(self) -> None:
        self.c_deadline_hits += 1

    def note_ok(self) -> None:
        """A batch completed through the normal device path: strikes reset
        and a DEGRADED kernel is healthy again."""
        self._strikes = 0
        if self.health == DEGRADED:
            self.health = HEALTHY
            self.last_error = ""

    def _hard_fail(self, err) -> None:
        self.health = FAILED
        self.last_error = repr(err)
        trace(
            SevError,
            "KernelFailed",
            "",
            Resolver=self.uid,
            Err=repr(err),
        )

    # -- journal ---------------------------------------------------------------

    def record_committed(self, version: int, ranges: list, oldest: int) -> None:
        """Called once per resolved batch, in version order (the resolver's
        gates guarantee it): journal this batch's committed write ranges
        and GC the journal to the MVCC window."""
        self.journal.record(version, ranges)
        self._journaled = version
        if oldest > 0:
            self.journal.trim_below(oldest)

    def _replayed(self, cs):
        self.journal.replay_into(cs)
        self.c_journal_replays += 1
        return cs

    def _check_stall(self, cs) -> None:
        """Sync paths can't await an injected stall: a finite stall is just
        latency (ignore), an infinite one is the hang fault."""
        take = getattr(cs, "take_stall", None)
        stall = take() if take is not None else None
        if stall == float("inf"):
            raise KernelTimeoutError("injected hang during recovery dispatch")

    # -- recovery / failover / re-promotion -------------------------------------

    @_locked
    def recover_resolve(self, transactions, version, new_oldest, err=None):
        """The device path faulted for this batch (deadline, device loss,
        exhausted retries): re-resolve it on a backend rebuilt from the
        journal. Strikes escalate to failover; if even the fallback fails,
        health=FAILED and KernelFailedError raises (typed, SevError-traced —
        never an opaque RuntimeError). Anything that is not a kernel fault
        is raised again as it is (``fault_of``)."""
        if err is not None:
            self._note_fault(fault_of(err))
        if self.health not in (FAILED_OVER, FAILED):
            attempts = self.knobs.CONFLICT_REBUILD_ATTEMPTS
            for _attempt in range(attempts):
                if self._strikes >= self.knobs.CONFLICT_FAILOVER_STRIKES:
                    break
                try:
                    cs = self._replayed(self._build_primary())
                    verdicts = cs.detect_batch(
                        transactions, now=version, new_oldest_version=new_oldest
                    )
                    self._check_stall(cs)
                except BaseException as e:
                    self._note_fault(fault_of(e))
                    continue
                self.c_rebuilds += 1
                self._swap(cs, DEGRADED)  # healthy again after a clean batch
                self._applied = version
                trace(
                    SevInfo,
                    "KernelRebuilt",
                    "",
                    Resolver=self.uid,
                    Version=version,
                    JournalDepth=len(self.journal),
                )
                return verdicts
        if self.health != FAILED_OVER:
            self._failover()
        else:
            # a fault while failed over: a fallback rebuilt from the journal,
            # as for the device above (batches dispatched on the old one
            # after the fault are re-resolved by the resolver, in order)
            self._swap(self._replayed(new_conflict_set(self._fallback_kind)), FAILED_OVER)
        try:
            verdicts = self._cs.detect_batch(
                transactions, now=version, new_oldest_version=new_oldest
            )
            self._applied = version
            return verdicts
        except BaseException as e:
            self._hard_fail(e)
            raise KernelFailedError(
                f"conflict kernel and fallback both failed: {e!r}"
            ) from e

    def _failover(self) -> None:
        """Construct the fallback (native skip list, oracle as backstop),
        replay the journal so verdict semantics carry over, and flip the
        state machine to FAILED_OVER."""
        for kind in ("native", "oracle"):
            try:
                cs = self._replayed(new_conflict_set(kind))
            except Exception:
                continue  # no native toolchain → oracle backstop
            self._fallback_kind = kind
            self._swap(cs, FAILED_OVER)
            self.c_failovers += 1
            self._last_probe = loop_now()
            trace(
                SevWarn,
                "KernelFailover",
                "",
                Resolver=self.uid,
                Fallback=type(cs).__name__,
                JournalDepth=len(self.journal),
                JournalFloor=self.journal.floor,
            )
            return
        err = RuntimeError("no fallback conflict backend could be built")
        self._hard_fail(err)
        raise KernelFailedError(str(err))

    def _maybe_promote(self) -> None:
        """While failed over: periodically rebuild the device backend from
        the journal and smoke-probe it; on success the device takes back
        over (HEALTHY). Not while a batch dispatched on the fallback is
        missing from the journal: the promoted backend is built from it."""
        if self.health != FAILED_OVER or self._applied > self._journaled:
            return
        t = loop_now()
        if (
            self._last_probe is not None
            and t - self._last_probe < self.knobs.CONFLICT_REPROBE_INTERVAL
        ):
            return
        self._last_probe = t
        self.c_reprobes += 1
        try:
            cs = self._replayed(self._build_primary())
            cs.detect_batch(
                [], now=self.journal.head_version(), new_oldest_version=0
            )
            self._check_stall(cs)
        except BaseException as e:
            fault_of(e)
            self.c_probe_failures += 1
            self.last_error = repr(e)
            return
        self._swap(cs, HEALTHY)
        self._strikes = 0
        self.c_promotions += 1
        trace(
            SevInfo,
            "KernelPromoted",
            "",
            Resolver=self.uid,
            Backend=self.backend_name,
            JournalDepth=len(self.journal),
        )

    # -- ConflictSet protocol (delegation + async emulation) ---------------------

    @property
    def oldest_version(self) -> int:
        return self._cs.oldest_version

    @_locked
    def warm_compile(self) -> None:
        fn = getattr(self._cs, "warm_compile", None)
        if fn is None:
            return
        try:
            fn()
        except BaseException as e:
            # a kernel fault while warming is not a boot failure: the first
            # batch meets it again under the guard. Anything else is raised
            fault_of(e)
            trace(SevWarn, "KernelWarmCompileFailed", "", Resolver=self.uid, Err=repr(e))

    def close(self) -> None:
        """Free the current backend's device memory (the resolver's role
        is destroyed); its metrics and the guard's health stay readable.
        It never waits for the lock: a dispatch wedged on the card must not
        wedge the worker's loop as well. When a call holds the lock, that
        call frees the backend as it returns (``_locked``)."""
        self._closed = True
        if self._lock.acquire(blocking=False):
            try:
                self._release_backend()
            finally:
                self._lock.release()

    def _release_backend(self) -> None:
        close = getattr(self._cs, "close", None)
        if close is not None:
            close()

    def take_stall(self):
        take = getattr(self._cs, "take_stall", None)
        return take() if take is not None else None

    @_locked
    def clear(self, version: int) -> None:
        self.journal.reset(version)
        try:
            self._cs.clear(version)
            self._applied = 0
        except BaseException as e:
            self._note_fault(fault_of(e))
            # the journal is empty at `version`: the fallback (or a later
            # promoted device) starts from exactly the cleared state
            self._failover()

    @_locked
    def prepare(self, now_version: int) -> None:
        fn = getattr(self._cs, "prepare", None)
        if fn is not None:
            fn(now_version)

    def encode(self, transactions):
        """Generation-stamped, TIMED encoding: returns ((gen, payload),
        encode_seconds). The resolver runs this on its encode executor —
        the double-buffered pipeline's off-loop thread — and uses the
        duration to compute how much encode time was hidden behind the
        previous batch's device scan (encodeOverlapSeconds). A backend
        swap between encode and dispatch surfaces as a transient
        StaleEncodingError (the resolver re-encodes)."""
        self._check_open()
        t0 = time.perf_counter()  # flowlint: disable=det-wall-clock — phase evidence
        fn = getattr(self._cs, "encode", None)
        payload = fn(transactions) if fn is not None else list(transactions)
        return (self._gen, payload), time.perf_counter() - t0  # flowlint: disable=det-wall-clock — phase evidence

    def note_encode_overlap(self, encode_s: float, stalled_s: float) -> None:
        """Per-batch encode-overlap evidence: of ``encode_s`` seconds of
        host encode, ``stalled_s`` actually delayed the dispatch — the
        rest was hidden behind the in-flight device scan."""
        m = getattr(self.primary, "metrics", None)
        if m is not None and hasattr(m, "encode_overlap_s"):
            m.encode_overlap_s.add(max(0.0, encode_s - stalled_s))

    @_locked
    def detect_many_encoded_async(self, work):
        self._maybe_promote()
        cs = self._cs
        for (gen, _payload), _v, _old in work:
            if gen != self._gen:
                raise StaleEncodingError(
                    "stale encoding: backend swapped after encode()"
                )
        if hasattr(cs, "detect_many_encoded_async"):
            handle = cs.detect_many_encoded_async(
                [(payload, v, old) for (_g, payload), v, old in work]
            )
        else:
            # sync emulation over the fallback: resolve now, hand back a
            # thunk (the resolver's pipelined path keeps one shape across
            # failover)
            outs = [
                cs.detect_batch(payload, now=v, new_oldest_version=old)
                for (_g, payload), v, old in work
            ]
            handle = lambda: outs  # noqa: E731
        self._applied = max([self._applied] + [v for _p, v, _o in work])
        return functools.partial(self._collect, handle)

    @_locked
    def _collect(self, handle):
        return handle()

    @_locked
    def detect_batch(self, transactions, now, new_oldest_version):
        """The resolver's non-pipelined path (and recovery re-resolves):
        guarded so a backend error degrades instead of poisoning."""
        if self.failed:
            raise KernelFailedError(f"conflict kernel failed: {self.last_error}")
        self._maybe_promote()
        try:
            verdicts = self._cs.detect_batch(
                transactions, now=now, new_oldest_version=new_oldest_version
            )
            self._check_stall(self._cs)
            self._applied = max(self._applied, now)
            return verdicts
        except KernelFailedError:
            raise
        except BaseException as e:
            return self.recover_resolve(
                transactions, now, new_oldest_version, err=fault_of(e)
            )

    # -- observability -----------------------------------------------------------

    def health_snapshot(self) -> dict:
        return {
            "state": self.health,
            "backend": self.backend_name,
            "strikes": self._strikes,
            "faults": self.c_faults,
            "retries": self.c_retries,
            "deadlineHits": self.c_deadline_hits,
            "deviceRebuilds": self.c_rebuilds,
            "failovers": self.c_failovers,
            "reprobes": self.c_reprobes,
            "probeFailures": self.c_probe_failures,
            "promotions": self.c_promotions,
            "journalDepth": len(self.journal),
            "journalFloor": self.journal.floor,
            "journalReplays": self.c_journal_replays,
            "lastError": self.last_error,
        }
