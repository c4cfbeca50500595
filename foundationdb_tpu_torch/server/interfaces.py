"""Role interfaces: the typed requests that cross process boundaries.

The analog of the reference's *Interface.h structs of RequestStreams
(MasterInterface.h, ResolverInterface.h, TLogInterface.h,
StorageServerInterface.h, MasterProxyInterface.h). An interface here is a
set of (endpoint token, request dataclass) pairs.

The port's copy of ``foundationdb_tpu/server/interfaces.py``, so far only
what the resolver takes and returns: ``Version``, ``TransactionData``,
``ResolveBatchRequest``, ``ResolveBatchReply`` and the endpoint ``Tokens``,
field for field. The other roles' messages come with those roles.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..kv.mutations import Mutation

Version = int
Tag = int  # per-storage-server tag (fdbclient/FDBTypes.h:39)

INVALID_VERSION = -1


# -- transactions over the wire ----------------------------------------------


@dataclass
class TransactionData:
    """Client → proxy commit payload: the analog of CommitTransactionRef
    (fdbclient/CommitTransaction.h): conflict ranges + mutations +
    read snapshot."""

    read_snapshot: Version = INVALID_VERSION
    read_conflict_ranges: list[tuple[bytes, bytes]] = field(default_factory=list)
    write_conflict_ranges: list[tuple[bytes, bytes]] = field(default_factory=list)
    mutations: list[Mutation] = field(default_factory=list)
    # sampled transaction-debug attach id (g_traceBatch,
    # MasterProxyServer.actor.cpp:345): every pipeline stage emits a
    # CommitDebug trace event carrying it, so one id reconstructs where a
    # commit's latency went across client→proxy→resolver→tlog
    debug_id: str = ""


# -- resolver (ResolverInterface.h / ResolveTransactionBatchRequest) ----------


@dataclass
class ResolveBatchRequest:
    prev_version: Version = INVALID_VERSION
    version: Version = INVALID_VERSION
    last_receive_version: Version = INVALID_VERSION
    requesting_proxy: str = ""
    transactions: list[TransactionData] = field(default_factory=list)
    # indices (into transactions) of system-keyspace txns; resolver 0's
    # copies carry the metadata mutations (ResolutionRequestBuilder's
    # txnStateTransactions, MasterProxyServer.actor.cpp:302-305)
    state_txn_indices: list[int] = field(default_factory=list)


@dataclass
class ResolveBatchReply:
    committed: list[int] = field(default_factory=list)  # Verdict per txn
    # state txns for every version in (last_receive_version, version]:
    # [(version, [(committed: bool, mutations)])] — this resolver's verdict;
    # the proxy ANDs the flags across resolvers and applies resolver 0's
    # mutation bytes (commitBatch phase 3, MasterProxyServer:432-450)
    state_mutations: list = field(default_factory=list)
    # prefilter feedback: write ranges this resolver committed
    # in (last_receive_version, version] as [(version, [(begin, end), ...])],
    # newest-first, capped at PREFILTER_FEEDBACK_MAX_RANGES ranges; empty
    # when PROXY_CONFLICT_PREFILTER is off
    committed_ranges: list = field(default_factory=list)
    # this resolver's forget horizon — the proxy's summary must drop
    # entries at/below it (jumps on failover / journal capacity pressure)
    version_floor: Version = 0


# -- endpoint token names (well-known, fdbrpc/fdbrpc.h:56) --------------------


class Tokens:
    # master
    GET_COMMIT_VERSION = "master.getCommitVersion"
    REPORT_COMMITTED = "master.reportCommitted"
    GET_LIVE_COMMITTED = "master.getLiveCommitted"
    # proxy
    GRV = "proxy.getConsistentReadVersion"
    COMMIT = "proxy.commit"
    GET_KEY_SERVERS = "proxy.getKeyServers"
    # resolver
    RESOLVE = "resolver.resolve"
    # tlog endpoints are always id-suffixed (TLogInterface.ep — many
    # generations share a worker), so they have no well-known tokens here
    # storage
    GET_VALUE = "storage.getValue"
    GET_KEY_VALUES = "storage.getKeyValues"
    GET_KEY = "storage.getKey"
    GET_SHARD_STATE = "storage.getShardState"
    GET_SHARD_METRICS = "storage.getShardMetrics"
    GET_SPLIT_KEY = "storage.getSplitKey"
    WAIT_METRICS = "storage.waitMetrics"
    WATCH_VALUE = "storage.watchValue"
    FEED_READ = "storage.feedRead"
    BATCH_GET = "storage.batchGet"
    MULTI_GET = "storage.multiGet"
    MULTI_GET_RANGE = "storage.multiGetRange"
    # worker
    WORKER_RECRUIT = "worker.recruit"
    WORKER_SET_DB_INFO = "worker.setDBInfo"
    WORKER_PING = "worker.ping"
    # cluster controller
    CC_REGISTER_WORKER = "cc.registerWorker"
    CC_GET_WORKERS = "cc.getWorkers"
    CC_OPEN_DATABASE = "cc.openDatabase"
    CC_SET_DB_INFO = "cc.setDBInfo"
    CC_GET_DB_INFO = "cc.getServerDBInfo"
    CC_GET_STATUS = "cc.getStatus"
    CC_FORCE_RECOVERY = "cc.forceRecovery"
    CC_FORCE_FAILOVER = "cc.forceFailover"
    WORKER_DESTROY_ROLE = "worker.destroyRole"
