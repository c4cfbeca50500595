"""Error taxonomy — the analog of flow/error_definitions.h.

Typed exceptions replace the reference's numbered error codes; the subset
here is the one that crosses the client API (retryable vs not mirrors
fdb_error_predicate in bindings/c/fdb_c.cpp).
"""

from __future__ import annotations


class FdbError(Exception):
    retryable = False


class NotCommitted(FdbError):
    """Transaction conflicted with another (error 1020)."""

    retryable = True


class TransactionTooOld(FdbError):
    """Read snapshot fell out of the MVCC window (error 1007)."""

    retryable = True


class FutureVersion(FdbError):
    """Storage server not yet caught up to read version (error 1009)."""

    retryable = True


class GrvThrottled(FdbError):
    """GRV shed by proxy admission control (the analog of error 1911
    proxy_memory_limit_exceeded / the GRV throttle): the cluster is over
    capacity for this transaction's priority class (or this tenant's
    share) and the request was rejected at admission rather than queued
    into collapse. Retryable — clients back off (bounded; see
    Transaction.on_error) and resubmit."""

    retryable = True


class CommitUnknownResult(FdbError):
    """Connection to proxy lost mid-commit; txn may or may not have
    committed (error 1021). Retryable, but retries must be idempotent."""

    retryable = True


class KeyOutsideLegalRange(FdbError):
    pass


class WrongShardServer(FdbError):
    """Read sent to a storage server that doesn't (yet) own the shard
    (error 1037 wrong_shard_server) — the client invalidates its location
    cache and retries."""

    retryable = True


class AccessedUnreadable(FdbError):
    """Read of a key written with a versionstamp op this transaction
    (error 1036)."""


class TooManyWatches(FdbError):
    """Storage server is at its STORAGE_WATCH_LIMIT (error 1032
    too_many_watches). Retryable: the client backs off and re-registers —
    parked watches fire and drain continuously, so capacity returns."""

    retryable = True


class TransactionCancelled(FdbError):
    """Operation belonged to a transaction that was cancelled or reset
    (error 1025 transaction_cancelled). NOT retryable: the watch/future
    was deliberately abandoned by its owner; retrying would resurrect
    work the application explicitly discarded."""


class DatabaseShutdown(FdbError):
    pass
