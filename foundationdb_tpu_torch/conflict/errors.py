"""Exception classes the conflict backend raises.

``KernelFaultError`` is the base of conflict-kernel faults; ``transient``
marks errors a bounded in-place dispatch retry may absorb. Everything else
escalates to the resolver's journal-replay recovery (conflict/failover.py).
``conflict/faults.py`` re-exports the fault classes, so a fault raised by a
backend is the class the guard and the resolver catch.

``DeviceUnavailableError`` is not a kernel fault: the card is missing, or
the kernels could not be built or loaded. The guard never fails over on
it; it leaves ``Resolver(...)`` or ``resolve`` as raised, so a machine
without a working card cannot pass for a failed-over one.
"""

from __future__ import annotations


class KernelFaultError(Exception):
    """Base of conflict-kernel faults."""

    transient = False


class KernelTransientError(KernelFaultError):
    """Retryable dispatch failure (spurious device error)."""

    transient = True


class StaleEncodingError(KernelTransientError):
    """The encoded payload no longer matches the backend: the version base
    was rebased, or the guard swapped backends, between ``encode()`` and
    dispatch. The caller re-encodes and retries."""


class KernelDeviceLostError(KernelFaultError):
    """The device is gone; rebuild or failover — in-place retry is futile."""


class KernelTimeoutError(KernelFaultError):
    """The per-batch dispatch deadline (CONFLICT_DISPATCH_DEADLINE) passed
    with the device still silent — raised by the resolver, not injected."""


class BatchTooLargeError(KernelFaultError):
    """A commit batch holds more transactions than the card's kernels take
    (``kernels.MAX_TXNS``). The backend raises it before any state,
    snapshot or metric changes; the caller splits the batch."""


class ConflictSetClosedError(Exception):
    """The conflict set's role was destroyed and its backend freed; it
    resolves nothing more. Not a kernel fault: nothing rebuilds it."""


class DeviceUnavailableError(RuntimeError):
    """No usable CUDA card: none is visible, or the caller asked for one
    that is not there. Not a kernel fault."""


class KernelBuildError(DeviceUnavailableError):
    """``nvcc`` is missing or failed, or a built kernel library could not
    be loaded. Not a kernel fault."""


# CUDA runtime errors that say the card went away or stopped answering, not
# that a kernel is wrong: (code, the words cudaGetErrorString gives, the
# fault it stands for). Any other CUDA error (an illegal address, a launch
# failure, a failed assertion) is a defect of the port, not a kernel fault.
_CUDA_FAULTS = (
    (46, "busy or unavailable", KernelDeviceLostError),  # cudaErrorDevicesUnavailable
    (100, "no CUDA-capable device is detected", KernelDeviceLostError),  # cudaErrorNoDevice
    (214, "uncorrectable ECC error", KernelDeviceLostError),  # cudaErrorECCUncorrectable
    (220, "uncorrectable NVLink error", KernelDeviceLostError),  # cudaErrorNvlinkUncorrectable
    (702, "the launch timed out", KernelTimeoutError),  # cudaErrorLaunchTimeout
)


def cuda_fault_class(code: int):
    """The fault class a CUDA error code stands for, or None."""
    for c, _words, cls in _CUDA_FAULTS:
        if c == code:
            return cls
    return None


def as_kernel_fault(err: BaseException):
    """The ``KernelFaultError`` that ``err`` stands for, or None when it is
    not a kernel fault. A torch error raised on a lost card (its message
    carries one of the CUDA errors above) maps to the fault; every other
    exception is None: the guard and the resolver let it leave as raised,
    so a broken kernel cannot pass for a failed-over resolver."""
    if isinstance(err, KernelFaultError):
        return err
    if isinstance(err, RuntimeError) and not isinstance(err, DeviceUnavailableError):
        msg = str(err)
        for _code, words, cls in _CUDA_FAULTS:
            if words in msg:
                fault = cls(msg)
                fault.__cause__ = err
                return fault
    return None
