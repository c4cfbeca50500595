"""Seeded device-fault injection at the conflict-kernel seam (sim-only).

The deterministic-simulation answer to "what happens when the card behind
``newConflictSet()`` breaks". A ``KernelFaultInjector`` rolls named fault
kinds from a forked seeded RNG — optionally armed through this run's
BUGGIFY sites, so chaos soaks exercise them organically — and
``FaultInjectingConflictSet`` applies them in front of a real device
backend:

- **dispatch error**: a transient exception out of the dispatch path (the
  resolver's bounded in-place retry should absorb it);
- **device loss**: every dispatch/clear raises until the loss heals at a
  seeded virtual-time horizon (drives journal-replay failover, then
  re-promotion once probes pass);
- **hang**: the dispatch "completes" but its results never arrive — an
  infinite stall the resolver's per-batch deadline must convert into a
  recovery instead of a wedged commit pipeline;
- **compile stall**: a finite stall (a first kernel build, a slow device
  round trip) that should ride under the deadline without failover.

Stalls are modeled as *virtual-time* waits the resolver performs under its
deadline (``take_stall()``), so same-seed runs replay byte-identically and
the deadline machinery is genuinely exercised in simulation — exactly the
sim-mode-twin discipline of SURVEY.md §4.

Every fired fault is recorded under a NAMED buggify site
(``("conflict/faults.py", "kernel-…")``), so a soak's fired-site coverage
report shows which kernel faults a run hit. The sites, the rolls and their
order are those of ``foundationdb_tpu/conflict/faults.py``, so one seed
draws the same fault sequence in both packages. The fault classes live in
``conflict/errors.py`` (one identity for the backends, the guard and the
resolver) and are re-exported here.
"""

from __future__ import annotations

from ..runtime.buggify import buggify, mark_fired
from ..runtime.loop import now
from .errors import (  # noqa: F401  (re-exported: one class for every raiser and catcher)
    KernelDeviceLostError,
    KernelFaultError,
    KernelTimeoutError,
    KernelTransientError,
    StaleEncodingError,
)


# named buggify sites — stable keys for the soak's fired-site coverage
SITE_DISPATCH_ERROR = ("conflict/faults.py", "kernel-dispatch-error")
SITE_DEVICE_LOSS = ("conflict/faults.py", "kernel-device-loss")
SITE_HANG = ("conflict/faults.py", "kernel-dispatch-hang")
SITE_COMPILE_STALL = ("conflict/faults.py", "kernel-compile-stall")
SITE_ENCODE_ERROR = ("conflict/faults.py", "kernel-encode-error")
SITE_ENCODE_HANG = ("conflict/faults.py", "kernel-encode-hang")

KERNEL_FAULT_SITES = (
    SITE_DISPATCH_ERROR,
    SITE_DEVICE_LOSS,
    SITE_HANG,
    SITE_COMPILE_STALL,
    SITE_ENCODE_ERROR,
    SITE_ENCODE_HANG,
)


class KernelFaultInjector:
    """Shared fault state + seeded RNG. Lives OUTSIDE the backend instance
    it wraps, so an injected device loss survives the failover machinery's
    fresh backend constructions (a rebuilt index on a dead device must
    still fail until the loss heals)."""

    def __init__(
        self,
        rng,
        p_dispatch_error: float = 0.05,
        p_device_loss: float = 0.02,
        p_hang: float = 0.02,
        p_compile_stall: float = 0.05,
        p_encode_error: float = 0.03,
        p_encode_hang: float = 0.01,
        loss_duration: float = 1.0,
        stall_seconds: float = 0.25,
    ):
        self.rng = rng
        self.p_dispatch_error = p_dispatch_error
        self.p_device_loss = p_device_loss
        self.p_hang = p_hang
        self.p_compile_stall = p_compile_stall
        self.p_encode_error = p_encode_error
        self.p_encode_hang = p_encode_hang
        self.loss_duration = loss_duration
        self.stall_seconds = stall_seconds
        self._lost_until = 0.0
        self._pending_stall: float = None
        self.counts: dict[str, int] = {}  # site tag → times fired

    def _roll(self, p: float, site: tuple) -> bool:
        # two arming paths, both seeded: this injector's own RNG fork
        # (focused tests pin probabilities) OR the run's BUGGIFY machinery
        # (chaos soaks arm sites organically). Either way the named site
        # lands in the run's fired-site coverage.
        hit = buggify(site)
        if not hit and p > 0 and self.rng.coinflip(p):
            hit = True
            mark_fired(site)
        if hit:
            self.counts[site[1]] = self.counts.get(site[1], 0) + 1
        return hit

    @property
    def device_lost(self) -> bool:
        return now() < self._lost_until

    def lose_device(self, duration: float = None) -> None:
        """Force a loss episode (workloads/tests drive kill/heal cycles)."""
        self._lost_until = now() + (
            self.loss_duration if duration is None else duration
        )

    def on_dispatch(self) -> None:
        """Called in front of every device dispatch/clear; raises the
        injected fault or arms a stall for ``take_stall()``."""
        if self.device_lost:
            raise KernelDeviceLostError(
                "injected device loss (heals at %.3f)" % self._lost_until
            )
        if self._roll(self.p_device_loss, SITE_DEVICE_LOSS):
            self._lost_until = now() + self.loss_duration
            raise KernelDeviceLostError(
                "injected device loss (heals at %.3f)" % self._lost_until
            )
        if self._roll(self.p_dispatch_error, SITE_DISPATCH_ERROR):
            raise KernelTransientError("injected transient dispatch error")
        if self._roll(self.p_hang, SITE_HANG):
            self._pending_stall = float("inf")
        elif self._roll(self.p_compile_stall, SITE_COMPILE_STALL):
            self._pending_stall = self.stall_seconds

    def on_encode(self) -> None:
        """Called in front of every host encode on the encode executor —
        the double-buffered pipeline's off-loop thread. A raised error
        fails the encode future (the resolver's bounded retry re-encodes);
        an armed hang models an encode thread wedged on a poisoned batch,
        which the resolver's dispatch deadline must bound."""
        if self._roll(self.p_encode_error, SITE_ENCODE_ERROR):
            raise KernelTransientError("injected encode-executor error")
        if self._roll(self.p_encode_hang, SITE_ENCODE_HANG):
            self._pending_stall = float("inf")

    def take_stall(self):
        """Seconds the in-flight dispatch should stall (inf = never
        completes), or None. Consumed once per armed fault."""
        s, self._pending_stall = self._pending_stall, None
        return s


class FaultInjectingConflictSet:
    """Sim-only wrapper over a device ConflictSet: same interface, with the
    injector consulted in front of every dispatch. Selected through
    ``new_conflict_set(..., fault_injector=...)`` (conflict/api.py)."""

    def __init__(self, inner, injector: KernelFaultInjector):
        assert hasattr(inner, "detect_many_encoded_async"), (
            "fault injection targets the device (async-dispatch) backends"
        )
        self.inner = inner
        self.injector = injector

    # -- passthrough state ----------------------------------------------------

    @property
    def metrics(self):
        return self.inner.metrics

    @property
    def oldest_version(self) -> int:
        return self.inner.oldest_version

    def warm_compile(self) -> None:
        fn = getattr(self.inner, "warm_compile", None)
        if fn is not None:
            fn()  # scratch-state compile: not a dispatch, never injected

    def prepare(self, now_version: int) -> None:
        self.inner.prepare(now_version)

    def encode(self, transactions):
        self.injector.on_encode()
        return self.inner.encode(transactions)

    def take_stall(self):
        return self.injector.take_stall()

    # -- injected dispatch paths ----------------------------------------------

    def clear(self, version: int) -> None:
        self.injector.on_dispatch()
        self.inner.clear(version)

    def detect_batch(self, transactions, now, new_oldest_version):
        self.injector.on_dispatch()
        return self.inner.detect_batch(transactions, now, new_oldest_version)

    def detect_many(self, work):
        self.injector.on_dispatch()
        return self.inner.detect_many(work)

    def detect_many_encoded(self, work):
        self.injector.on_dispatch()
        return self.inner.detect_many_encoded(work)

    def detect_many_encoded_async(self, work):
        self.injector.on_dispatch()
        return self.inner.detect_many_encoded_async(work)
