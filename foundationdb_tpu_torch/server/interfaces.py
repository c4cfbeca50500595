"""Role interfaces: the typed requests that cross process boundaries.

The analog of the reference's *Interface.h structs of RequestStreams
(MasterInterface.h, ResolverInterface.h, TLogInterface.h,
StorageServerInterface.h, MasterProxyInterface.h). An interface here is a
set of (endpoint token, request dataclass) pairs.

The port's copy of ``foundationdb_tpu/server/interfaces.py``, every
message field for field: the master's
(``GetCommitVersion*``, ``ReportRawCommittedVersionRequest``), the
proxy's (``GetReadVersion*``, ``Commit*``, ``GetKeyServers*``), the
resolver's (``Version``, ``TransactionData``, ``ResolveBatchRequest``,
``ResolveBatchReply``), the tlog's (``TLogCommitRequest``, ``TLogPeek*``,
``TLogPop*``, ``TLogLock*``), the storage server's (``Get*``, ``Watch*``,
``WaitMetricsRequest``, ``FeedRead*``, ``MultiGet*``), the role
interfaces (``MasterInterface``, ``ProxyInterface``, ``ResolverInterface``,
``StorageInterface``), the client's bootstrap (``OpenDatabaseRequest``,
``ClientDBInfo``), the worker's and the cluster controller's
(``RegisterWorkerRequest``, ``GetWorkers*``, ``WorkerDetails``,
``RecruitRole*``, ``ServerDBInfo``, ``SetDBInfoRequest``) and the endpoint
``Tokens``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

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


# -- master (version assignment; masterserver.actor.cpp:763 getVersion) -------


@dataclass
class GetCommitVersionRequest:
    requesting_proxy: str = ""
    # per-proxy sequence (the reference's requestNum,
    # fdbserver/MasterInterface.h GetCommitVersionRequest): lets a proxy
    # keep several version requests in flight while the master assigns
    # versions in submission order despite network reordering. -1 =
    # unordered legacy caller (assign on arrival).
    request_num: int = -1
    # highest resolver_changes_version this proxy has applied — the ack
    # that lets the master stop re-attaching a balancing change set (a
    # lost grant reply must not lose the delivery)
    applied_changes_version: Version = 0


@dataclass
class GetCommitVersionReply:
    prev_version: Version = INVALID_VERSION
    version: Version = INVALID_VERSION
    # resolutionBalancing piggyback (masterserver.actor.cpp:806): boundary
    # moves [(begin, end, ResolverInterface)] delivered to each proxy with
    # its first version grant after the master recorded them; they apply
    # to commit versions >= resolver_changes_version
    resolver_changes: tuple = ()
    resolver_changes_version: Version = 0


@dataclass
class ReportRawCommittedVersionRequest:
    version: Version = INVALID_VERSION


# -- proxy (MasterProxyInterface.h) -------------------------------------------


@dataclass
class GetReadVersionRequest:
    """GRV envelope. ``priority`` is a transaction priority class
    (server/admission.py: 0=batch, 1=default, 2=immediate) and ``tenant``
    an opaque tenant id — both consumed by the proxy's admission queue
    (per-class and per-tenant token buckets; Ratekeeper-grade
    admission). Empty tenant = untenanted (class bucket only). ``count``
    is how many client transactions share this coalesced request (the
    reference's transactionCount): admission debits that many tokens."""

    priority: int = 1  # PRIORITY_DEFAULT
    tenant: str = ""
    count: int = 1


@dataclass
class GetReadVersionReply:
    version: Version = INVALID_VERSION


@dataclass
class CommitRequest:
    transaction: TransactionData = None


@dataclass
class CommitReply:
    version: Version = INVALID_VERSION  # commit version if committed
    versionstamp: bytes = b""


@dataclass
class GetKeyServersRequest:
    """Key-location query (NativeAPI getKeyLocation → proxy
    readRequestServer, MasterProxyServer.actor.cpp:1036)."""

    key: bytes = b""
    # resolve the shard containing the keys immediately BELOW `key` instead
    # (reverse range reads walk shards right-to-left from the range end)
    before: bool = False


@dataclass
class GetKeyServersReply:
    # (shard_begin, shard_end, [storage addresses], [storage tags])
    begin: bytes = b""
    end: Optional[bytes] = None
    team: list[str] = field(default_factory=list)
    tags: list = None


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


# -- tlog (TLogInterface.h) ---------------------------------------------------


@dataclass
class TLogCommitRequest:
    prev_version: Version = INVALID_VERSION
    version: Version = INVALID_VERSION
    # tag → mutations at this version (LogPushData's tagged messages)
    messages: dict[Tag, list[Mutation]] = field(default_factory=dict)
    epoch: int = 0
    known_committed: Version = 0  # piggybacked committed version


@dataclass
class TLogLockRequest:
    """Recovery fence from a higher-epoch master (tLogLock:467)."""

    epoch: int = 0


@dataclass
class TLogLockReply:
    end_version: Version = INVALID_VERSION  # this tlog's durable version
    known_committed: Version = 0


@dataclass
class TLogPeekRequest:
    tag: Tag = 0
    begin: Version = 0


@dataclass
class TLogPeekReply:
    # [(version, mutations)] with version >= begin, ascending
    messages: list[tuple[Version, list[Mutation]]] = field(default_factory=list)
    end_version: Version = INVALID_VERSION  # data complete through this version
    # piggybacked proxy-acked committed version (the consumer's committed
    # frontier: watch firing / change-feed visibility gate)
    known_committed: Version = 0


@dataclass
class TLogPopRequest:
    tag: Tag = 0
    upto: Version = INVALID_VERSION
    # consumer class: "ss" (storage / master) or "router" (remote-region
    # LogRouter) — each keeps an independent pop frontier at the tlog
    consumer: str = "ss"


# -- storage (StorageServerInterface.h) ---------------------------------------


@dataclass
class GetValueRequest:
    key: bytes = b""
    version: Version = INVALID_VERSION


@dataclass
class GetValueReply:
    value: Optional[bytes] = None


@dataclass
class WatchValueRequest:
    """Long-poll until the key's value differs from `value`
    (watchValue_impl, storageserver.actor.cpp:758)."""

    key: bytes = b""
    value: Optional[bytes] = None  # the value the watcher believes is current
    version: Version = INVALID_VERSION


@dataclass
class WatchValueReply:
    value: Optional[bytes] = None  # the changed value
    version: Version = INVALID_VERSION


@dataclass
class WaitMetricsRequest:
    """Threshold-band metrics subscription: the storage
    server replies immediately if its sampled byte estimate for
    [begin, end) is outside [min_bytes, max_bytes], else parks the reply
    until a sampled mutation pushes the estimate across the band
    (StorageMetrics.actor.h waitMetrics — DD's trackShardBytes
    subscribes instead of polling). A (-1, -1) band forces an immediate
    reply with the current estimate."""

    begin: bytes = b""
    end: Optional[bytes] = None  # None = end of keyspace
    min_bytes: int = -1
    max_bytes: int = -1


@dataclass
class FeedReadRequest:
    """One change-feed page: committed per-version diffs for
    [begin, end) above from_version. Long-polls while the range is
    quiet; `sub_id` identifies the subscriber's retention lease (the
    feed floor holds at its cursor while the lease is live, bounded)."""

    begin: bytes = b""
    end: bytes = b"\xff"
    from_version: Version = 0
    limit: int = 0  # 0 = server default (STORAGE_FEED_BATCH_ENTRIES)
    sub_id: str = ""


@dataclass
class FeedReadReply:
    """batches = [(version, [(clear_begin, clear_end)...],
    [(key, value)...])] — whole versions, clears clipped to the
    subscribed range, both lists canonically sorted. `more` = page was
    cut at the limit; resume immediately from next_version."""

    batches: list = field(default_factory=list)
    next_version: Version = 0
    more: bool = False


@dataclass
class GetKeyRequest:
    """Resolve a NORMALIZED key selector against this server's shard
    (getKeyQ, storageserver.actor.cpp:1288). ``key``/``offset`` are the
    or_equal-removed form (kv/selector.py): the result is the key
    ``offset`` positions after "the last key < key". ``begin``/``end``
    are the client's located shard bounds (end=None = infinity): servers
    that own everything tag-route their data client-side here, so the
    walk must clamp to the bounds the CLIENT located, intersected with
    the server's own shard map."""

    key: bytes = b""
    offset: int = 1
    version: Version = INVALID_VERSION
    begin: bytes = b""
    end: Optional[bytes] = None


@dataclass
class GetKeyReply:
    """resolved=True: ``key`` is the answer (clamped to [b"", b"\\xff"]).
    resolved=False: the walk ran off this shard's edge — continue with the
    normalized selector (``key``, ``offset``) at the adjacent shard (the
    client findKey loop, NativeAPI.actor.cpp:1220)."""

    key: bytes = b""
    offset: int = 0
    resolved: bool = True


@dataclass
class GetKeyValuesRequest:
    begin: bytes = b""
    end: bytes = b""
    version: Version = INVALID_VERSION
    limit: int = 1 << 30
    reverse: bool = False


@dataclass
class GetKeyValuesReply:
    data: list[tuple[bytes, bytes]] = field(default_factory=list)
    more: bool = False


# -- batched reads (the read pipeline's wire shapes) ---------------------------
#
# Per-entry error codes a batched reply may carry. A batched endpoint
# answers every entry it can and reports the rest individually, so one
# bad key cannot fail a whole batch:
#   too_old     — definitive: that entry's read is below the MVCC window
#                 (only reachable per-entry via fault injection; a version
#                 genuinely below the window fails the batch up front)
#   wrong_shard — this server can't serve that entry at the version; the
#                 client re-locates and retries it per-key
#   dropped     — the reply for that entry was lost (fault injection /
#                 partial reply); the client degrades it to a per-key read
READ_ERR_TOO_OLD = "too_old"
READ_ERR_WRONG_SHARD = "wrong_shard"
READ_ERR_DROPPED = "dropped"


@dataclass
class MultiGetRequest:
    """Many point reads — and selector resolutions — against ONE version
    in one RPC (the client's same-tick read coalescing; the storage
    answers engine misses through TorchRangeIndex.batch_lookup in one
    kernel and pays waitVersion once for the whole batch)."""

    keys: list[bytes] = field(default_factory=list)
    # normalized selector resolutions riding the same hop, each in the
    # GetKeyRequest shape: (key, offset, begin, end)
    selectors: list = field(default_factory=list)
    version: Version = INVALID_VERSION


@dataclass
class MultiGetReply:
    values: list = field(default_factory=list)  # per key: value | None
    errors: list = field(default_factory=list)  # [(key index, READ_ERR_*)]
    selectors: list = field(default_factory=list)  # per selector: GetKeyReply
    selector_errors: list = field(default_factory=list)  # [(index, READ_ERR_*)]


@dataclass
class MultiGetRangeRequest:
    """Several range reads against ONE version in one RPC — the
    multiGetRange sibling of getRange; the storage resolves every
    forward range's engine bounds with one TorchRangeIndex.batch_range
    interval query."""

    # (begin, end, limit, reverse) per range
    ranges: list = field(default_factory=list)
    version: Version = INVALID_VERSION


@dataclass
class MultiGetRangeReply:
    results: list = field(default_factory=list)  # per range: GetKeyValuesReply|None
    errors: list = field(default_factory=list)  # [(range index, READ_ERR_*)]


# -- role interfaces (the *Interface.h structs): address + instance uid -------
#
# A role instance registers its handlers under "{token}#{uid}" so many
# instances (e.g. tlog generations across epochs) can share one worker
# process; uid == "" means the well-known static tokens (fdbrpc.h:56).


def _suffixed(token: str, uid: str):
    return token if not uid else f"{token}#{uid}"


@dataclass(frozen=True)
class MasterInterface:
    address: str = ""
    uid: str = ""

    def ep(self, method: str):
        from ..net.sim import Endpoint

        token = {
            "getCommitVersion": Tokens.GET_COMMIT_VERSION,
            "reportCommitted": Tokens.REPORT_COMMITTED,
            "getLiveCommitted": Tokens.GET_LIVE_COMMITTED,
            "getRate": "master.getRate",
            "ping": "master.ping",
        }[method]
        return Endpoint(self.address, _suffixed(token, self.uid))


@dataclass(frozen=True)
class ProxyInterface:
    address: str = ""
    uid: str = ""

    def ep(self, method: str):
        from ..net.sim import Endpoint

        token = {
            "grv": Tokens.GRV,
            "commit": Tokens.COMMIT,
            "keyServers": Tokens.GET_KEY_SERVERS,
            "ping": "proxy.ping",
        }[method]
        return Endpoint(self.address, _suffixed(token, self.uid))


@dataclass(frozen=True)
class ResolverInterface:
    address: str = ""
    uid: str = ""

    def ep(self, method: str):
        from ..net.sim import Endpoint

        token = {"resolve": Tokens.RESOLVE, "ping": "resolver.ping"}[method]
        return Endpoint(self.address, _suffixed(token, self.uid))


@dataclass(frozen=True)
class StorageInterface:
    """Storage keeps well-known data tokens (one storage role per process;
    it outlives recoveries) plus a uid-suffixed ping."""

    address: str = ""
    uid: str = ""
    tag: Tag = 0

    def ep(self, method: str):
        from ..net.sim import Endpoint

        token = {
            "getValue": Tokens.GET_VALUE,
            "getKeyValues": Tokens.GET_KEY_VALUES,
            "getKey": Tokens.GET_KEY,
        }.get(method)
        if token is not None:
            return Endpoint(self.address, token)
        return Endpoint(self.address, _suffixed(f"storage.{method}", self.uid))


# -- worker / cluster controller (WorkerInterface.h, ClusterInterface.h) ------


@dataclass
class RegisterWorkerRequest:
    address: str = ""
    process_class: str = "unset"  # storage | transaction | stateless | unset
    roles: tuple = ()  # role kinds currently hosted (for fitness)
    # process locality (fdbrpc/Locality.h) for policy-driven placement
    machine: str = ""
    zone: str = ""
    dc: str = "dc0"


@dataclass
class GetWorkersRequest:
    pass


@dataclass
class WorkerDetails:
    address: str = ""
    process_class: str = "unset"
    roles: tuple = ()
    machine: str = ""
    zone: str = ""
    dc: str = "dc0"


@dataclass
class GetWorkersReply:
    workers: list = field(default_factory=list)  # [WorkerDetails]


@dataclass
class RecruitRoleRequest:
    """CC/master → worker: instantiate a role (worker.actor.cpp:693-794)."""

    role: str = ""  # master | proxy | resolver | tlog | storage
    uid: str = ""
    params: dict = field(default_factory=dict)


@dataclass
class RecruitRoleReply:
    address: str = ""
    uid: str = ""


@dataclass
class OpenDatabaseRequest:
    """Client → CC: long-polled ClientDBInfo (serves the proxy list)."""

    known_id: int = -1


@dataclass
class ClientDBInfo:
    id: int = 0
    proxies: list = field(default_factory=list)  # proxy addresses


@dataclass
class ServerDBInfo:
    """Broadcast cluster topology (the reference's ServerDBInfo pushed by
    the CC to every worker). None fields = not yet recovered."""

    id: int = 0
    recovery_count: int = 0
    master_address: str = ""
    master_uid: str = ""
    client_info: ClientDBInfo = None
    log_system: object = None  # log_system.LogSystemConfig
    recovery_version: Version = 0  # epoch-end of the previous generation
    # multi-region: the remote region's LogRouter set as a
    # LogSystemConfig (routers expose tlog-shaped peek/pop, so remote
    # storage follows them with the ordinary PeekCursor), plus the
    # remote storage mirror (tag → address for intra-region fetches)
    log_routers: object = None
    remote_storage: tuple = ()


@dataclass
class SetDBInfoRequest:
    info: ServerDBInfo = None


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
