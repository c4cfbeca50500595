"""Exception classes the conflict backend raises.

``KernelFaultError`` is the base of conflict-kernel faults; ``transient``
marks errors a bounded in-place dispatch retry may absorb.
"""

from __future__ import annotations


class KernelFaultError(Exception):
    """Base of conflict-kernel faults."""

    transient = False


class KernelTransientError(KernelFaultError):
    """Retryable dispatch failure."""

    transient = True


class StaleEncodingError(KernelTransientError):
    """The encoded payload no longer matches the backend: the version base
    was rebased between ``encode()`` and dispatch. The caller re-encodes
    and retries."""


class BatchTooLargeError(KernelFaultError):
    """A commit batch holds more transactions than the card's kernels take
    (``kernels.MAX_TXNS``). The backend raises it before any state,
    snapshot or metric changes; the caller splits the batch."""
