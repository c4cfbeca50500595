"""Config knobs — the analog of flow/Knobs.cpp (Flow/Client/Server knobs).

Defaults live here; simulation randomizes a subset per run (the reference's
BUGGIFY-aware knob randomization, SURVEY.md §5.6); anything can be overridden
by name (the --knob_name flag path, fdbserver.actor.cpp:923).

The port's copy of ``foundationdb_tpu/runtime/knobs.py``: every knob, its
default and its randomization are the same, so one seed draws the same
values in both packages. Only the conflict-set backend names differ
(``torch`` / ``torch_mesh`` for the device backends).
"""

from __future__ import annotations


class Knobs:
    # commit pipeline (reference: COMMIT_TRANSACTION_BATCH_INTERVAL_MIN
    # 1 ms / _FROM_IDLE 0.5 ms, fdbserver/Knobs.cpp:221-223)
    COMMIT_BATCH_INTERVAL = 0.001  # proxy batch window (s)
    COMMIT_BATCH_INTERVAL_FROM_IDLE = 0.0005  # first batch after idle
    MAX_COMMIT_BATCH_INTERVAL = 0.25  # idle proxies commit empty batches
    MAX_BATCH_TXNS = 4096
    # bound on phase-1's wait for the master's version grant: past this the
    # request is presumed dropped (partition) and the batch errors as
    # commit_unknown_result instead of wedging the gate chain. Sized past
    # the master's 4s gap-abandonment window so a merely-slow grant that
    # the master still honors isn't double-assigned.
    GETCOMMITVERSION_TIMEOUT = 6.0
    # how long the master parks an out-of-order version request for its
    # missing predecessor before abandoning the gap (a partition ate it)
    MASTER_VERSION_GAP_TIMEOUT = 4.0
    # consecutive master-unreachable batch failures before a proxy
    # declares its master dead and retires
    PROXY_MASTER_MISS_LIMIT = 8
    VERSIONS_PER_SECOND = 1_000_000
    MAX_READ_TRANSACTION_LIFE_VERSIONS = 5_000_000  # the MVCC window (~5s)
    MAX_VERSIONS_IN_FLIGHT = 100_000_000
    # conflict set
    CONFLICT_SET_BACKEND = "torch"  # torch | torch_mesh | native | oracle (newConflictSet knob)
    CONFLICT_SET_CAPACITY = 1 << 14
    # conflict-kernel fault tolerance (conflict/failover.py + resolver):
    # per-batch deadline on the device dispatch/collect path, bounded
    # in-place retry for transient faults, then journal-replay recovery
    # escalating to failover onto the native/oracle backend
    CONFLICT_DISPATCH_DEADLINE = 2.0  # s per batch before the device is presumed wedged
    CONFLICT_DISPATCH_RETRIES = 3  # in-place dispatch retries (transient errors)
    CONFLICT_RETRY_BACKOFF = 0.02  # base retry backoff (s, doubles per attempt)
    CONFLICT_FAILOVER_STRIKES = 3  # recovery resolves before failing over
    CONFLICT_REBUILD_ATTEMPTS = 2  # device rebuild tries per recovery resolve
    CONFLICT_REPROBE_INTERVAL = 1.0  # probe cadence for device re-promotion (s)
    CONFLICT_JOURNAL_CAPACITY = 512  # journaled committed-write batches kept
    # double-buffered dispatch: size of the resolver's dedicated host
    # encode executor (batch N encodes while batch N-1 scans on device);
    # 0 = encode synchronously inside the dispatch job (pre-overlap shape)
    CONFLICT_ENCODE_THREADS = 1
    # occupancy-driven proactive resharding (between batches, never
    # stalling a live dispatch): rebalance when collected staging/kept
    # pressure crosses this fraction of the slot ceiling…
    CONFLICT_RESHARD_PRESSURE = 0.75
    # …and grow the bucket count when live rows fill this fraction of grid
    CONFLICT_GROW_FILL = 0.5
    # sim-only seeded device-fault injection at the conflict seam
    # (conflict/faults.py): dispatch errors, hangs, device loss, stalls
    CONFLICT_FAULT_INJECTION = False
    # proxy conflict pre-filter (conflict/prefilter.py): a
    # decaying summary of recently committed write ranges, fed from
    # feedback piggybacked on resolver replies and consulted BEFORE a
    # transaction joins a commit batch — a doomed transaction fails with
    # the normal retryable not_committed without paying the version
    # grant, resolver codec, or tlog round trip. Strictly conservative
    # (rejects only on a stored committed range that provably overlaps a
    # read at a newer version); off = the unfiltered path (one-build A/B)
    PROXY_CONFLICT_PREFILTER = True
    # bucket key = first N bytes of a range's begin key (coarse interval
    # bloom granularity): smaller prefixes alias more writes per bucket
    # (cheaper, blunter), longer ones spread them out
    PREFILTER_PREFIX_LEN = 6
    # exact (begin, end, version) entries kept per bucket; overflow
    # evicts oldest-first, which only FORGETS conflicts (conservative)
    PREFILTER_BUCKET_ENTRIES = 32
    # buckets kept per proxy; overflow evicts the stalest bucket
    PREFILTER_MAX_BUCKETS = 4096
    # entries on the wide-range side list (ranges spanning > 1 bucket)
    PREFILTER_WIDE_RANGES = 128
    # committed-write ranges a resolver echoes per reply (newest win;
    # truncation only delays learning — conservative)
    PREFILTER_FEEDBACK_MAX_RANGES = 512
    # storage
    STORAGE_DURABILITY_LAG = 0.5  # how far behind durable version may trail (s)
    STORAGE_WAIT_VERSION_TIMEOUT = 1.0  # then future_version (client retries)
    STORAGE_FETCH_KEYS_BATCH = 10_000
    # epoch-batched storage engine: the pull
    # loop applies each mutation batch as ONE epoch (sorted-index merge
    # once per batch, native range tombstones), reads pin O(1) immutable
    # snapshots, and the durability drain is clamped by active pins. Off
    # = the legacy per-mutation apply path (one-build A/B).
    STORAGE_EPOCH_BATCHING = True
    # scan lease: a chunked read that replied `more` pins its version for
    # this long (refreshed per chunk) so multi-chunk scans, fetchKeys and
    # backup pages stop racing durability advances into TOO_OLD restarts
    STORAGE_SNAPSHOT_LEASE = 2.0
    # bound on how far a pin may hold the durability horizon behind the
    # tip: past this the advance proceeds and the pin goes TOO_OLD (an
    # abandoned pin must not grow the MVCC window without limit)
    STORAGE_PIN_MAX_LAG_VERSIONS = 10_000_000
    # watches & change feeds: parked watch
    # registrations per storage server — past this, registration fails
    # with the typed retryable TooManyWatches and the client backs off
    # (reference: MAX_STORAGE_SERVER_WATCH_BYTES; sized so 100K-watch
    # storms fit with an order of magnitude to spare)
    STORAGE_WATCH_LIMIT = 1_000_000
    # change-feed retention: per-epoch committed diffs are kept for this
    # many versions behind the tip (~= seconds × VERSIONS_PER_SECOND).
    # Resuming below the retained floor raises TOO_OLD. Active subscriber
    # leases hold the floor (like scan-lease pins), bounded at 2x this.
    STORAGE_FEED_RETENTION_VERSIONS = 5_000_000
    # entries per change-feed read reply before `more` paging kicks in
    STORAGE_FEED_BATCH_ENTRIES = 1_000
    # device batched-read snapshot index on the storage read path
    # (ops/range_index.py): serves batch_get misses and getRange bounds,
    # delta-merged each durability epoch. None = AUTO: on under
    # simulation loops, off on a RealLoop (a real server must not
    # lazily bring up the card per durability epoch); True/False force
    # it either way. The knob keeps the reference's name.
    STORAGE_TPU_INDEX = None
    # tlog
    TLOG_SPILL_THRESHOLD = 1 << 20
    TLOG_FSYNC_TIME = 0.0002  # modeled DiskQueue sync (SSD-class fsync)
    # commit path at wire speed — all three are A/B'd together
    # by BENCH_COMPONENT=commit_path and drawn both ways by the soak's
    # randomize_commit_path(). Wire bytes are identical either way.
    # schema-compiled struct encode/decode in net/wire.py (process-wide:
    # the codec registry is module state)
    WIRE_COMPILED_CODEC = True
    # batch-settle reply/fan-out futures in one loop step
    # (futures.settle_batch; process-wide module state)
    FUTURE_SLAB_SETTLE = True
    # tlog releases the version chain at DiskQueue push time, overlapping
    # the next version's push with the in-flight write+fsync round; acks
    # still wait for the covering round's fsync (server/tlog.py)
    TLOG_FSYNC_PIPELINE = True
    # multi-region log routing
    ROUTER_BUFFER_BYTES = 1 << 20  # per-tag unacked relay buffer cap
    # data distribution (DataDistributionTracker.actor.cpp knobs
    # SHARD_MAX_BYTES_PER... scaled to sim data volumes)
    DD_SHARD_MAX_BYTES = 1 << 18  # split above this
    DD_SHARD_MIN_BYTES = 1 << 15  # merge adjacent same-team shards below
    DD_TRACKER_INTERVAL = 2.0
    DD_MOVE_THROTTLE = 0.5  # min delay between relocations (move queue)
    # failure detection / recovery
    HEARTBEAT_INTERVAL = 0.5
    FAILURE_TIMEOUT = 2.0
    # resolutionBalancing (masterserver.actor.cpp:896): load-driven moves
    # of key-range boundaries between resolver roles
    RESOLUTION_BALANCING_INTERVAL = 1.0  # master poll period (s)
    RESOLUTION_BALANCE_MIN_OPS = 200  # min per-interval imbalance to act
    RESOLUTION_BALANCE_RATIO = 1.5  # max/min load ratio that triggers a move
    RESOLUTION_SAMPLE_KEYS = 4096  # per-resolver load sample cap
    # ratekeeper (multi-signal admission control): per-class
    # rates from storage lag + tlog queue depth + run-loop busy fraction
    # + latency-band overrun + conflict-kernel health
    RK_POLL_INTERVAL = 0.5  # proxy -> master getRate cadence
    RK_MAX_TPS = 100_000.0
    RK_LAG_TARGET = 2_000_000  # start throttling here (versions)
    RK_LAG_MAX = 4_000_000  # floor rate here (MVCC window is 5M)
    # master does NOT gate admission entirely off: the floor keeps the
    # cluster draining (progress is what shrinks every signal)
    RK_RATE_FLOOR = 0.05  # default-class floor as a fraction of RK_MAX_TPS
    # worst storage durable-version lag (version - durableVersion): the
    # write-queue signal (limitReason storage_server_write_queue_size).
    # Calibrated ABOVE the sim's healthy steady state (~4.5-5.5M versions:
    # versions advance at 1M/s and durability batches seconds behind) so
    # only growth beyond baseline throttles
    RK_DURABILITY_LAG_TARGET = 6_000_000
    RK_DURABILITY_LAG_MAX = 12_000_000
    # worst tlog DiskQueue backlog (bytes not yet popped by consumers)
    RK_TLOG_QUEUE_TARGET = 2 << 20
    RK_TLOG_QUEUE_MAX = 8 << 20
    # run-loop busy fraction (the run-loop profiler gauge; REAL personality
    # only — a sim loop is busy by construction)
    RK_BUSY_FRACTION_TARGET = 0.90
    RK_BUSY_FRACTION_MAX = 0.98
    # latency-band overrun: fraction of proxy GRV/commit requests in the
    # poll interval that landed above RK_BAND_SLO seconds
    RK_BAND_SLO = 0.5
    RK_BAND_OVERRUN_TARGET = 0.05
    RK_BAND_OVERRUN_MAX = 0.25
    # conflict-kernel health (kernel.health): a DEGRADED kernel tightens
    # admission instead of queueing resolve batches into the dispatch
    # deadline; FAILED_OVER runs on the (slower) native backend
    RK_KERNEL_DEGRADED_FACTOR = 0.5
    RK_KERNEL_FAILED_OVER_FACTOR = 0.75
    # batch class throttles FIRST: its thresholds sit at this fraction of
    # the default class's targets (shed-order batch -> default -> immediate)
    RK_BATCH_SENSITIVITY = 0.5
    RK_RATE_SMOOTHING = 0.5  # exponential smoothing of per-class rates
    # proxy admission queue (server/admission.py): bounded depth per
    # class; waiters past their deadline shed with grv_throttled
    RK_GRV_QUEUE_MAX = 512  # per class per proxy
    RK_GRV_QUEUE_TIMEOUT = 0.5  # default-class queue deadline (s);
    #                             batch waits 0.5x, immediate 2x
    RK_ADMISSION_TICK = 0.02  # pump cadence while waiters are parked (s)
    RK_TENANT_MAX_SHARE = 0.5  # one tenant's cap as a fraction of the
    #                            default-class per-proxy rate
    RK_STATUS_TENANTS = 8  # per-tenant top-N surfaced through status
    # observability
    # run-loop profiler (runtime/profiler.py): per-actor busy attribution,
    # per-priority starvation, SlowTask events (the reference's run-loop
    # profiler + NetworkMetrics, flow/Net2.actor.cpp)
    RUN_LOOP_PROFILER = True
    RUN_LOOP_SLOW_TASK_MS = 50.0  # real-loop callbacks above this trace SlowTask
    PROFILER_SAMPLE_HZ = 100.0  # flame sampler rate (cli profile)
    TRACE_ROLL_BYTES = 10 << 20  # roll the JSONL trace file here (reference: 10 MB)
    TRACE_ROLL_KEEP = 10  # rolled files kept (path.1 .. path.N)
    # fraction of client transactions that open a sampled distributed
    # trace (runtime/trace.py spans; drawn from the client's seeded RNG so
    # same-seed sim runs sample identical trace_ids)
    TRACE_SAMPLE_RATE = 0.0
    LATENCY_PROBE_INTERVAL = 1.0  # CC's timed GRV/read/commit probe cadence
    METRICS_TRACE_INTERVAL = 5.0  # per-role CounterCollection trace cadence
    # keyspace telemetry (server/storage_metrics.py): sampled
    # byte/bandwidth estimation + read-hot-range detection on every
    # storage server (StorageMetrics.actor.h byteSample/getReadHotRanges)
    STORAGE_METRICS_SAMPLING = True
    STORAGE_BYTE_SAMPLE_FACTOR = 200  # P(sample a set) = size/FACTOR, capped at 1
    STORAGE_READ_SAMPLE_FACTOR = 400  # same for read-byte sampling
    STORAGE_READ_SAMPLE_MAX_KEYS = 4096  # read sample cap (smallest-weight eviction)
    STORAGE_METRICS_WINDOW = 5.0  # bandwidth/ops rolling-window width (s)
    STORAGE_HOT_RANGE_BUCKET_SAMPLES = 8  # byte-sample keys per hot-range bucket
    STORAGE_HOT_RANGE_MIN_DENSITY = 2.0  # status only surfaces density >= this
    STORAGE_HOT_RANGE_STATUS_N = 3  # per-storage top-N in the status gauge
    DD_WAIT_METRICS_SIZING = True  # DD sizes shards from waitMetrics pushes
    DD_WAIT_METRICS_TIMEOUT = 30.0  # re-arm cadence when no push arrives (s)
    # bounded metrics history (runtime/timeseries.py): every hosted
    # CounterCollection keeps a ring of numeric snapshots, read back via
    # worker.metricsHistory / cli metrics / trace_analyze --timeline
    METRICS_HISTORY_ENABLED = True
    METRICS_HISTORY_INTERVAL = 2.0  # snapshot cadence (s)
    METRICS_HISTORY_SAMPLES = 120  # ring capacity (points kept per role)
    # client
    # fraction of commits auto-tagged with a transaction-debug id
    # (g_traceBatch sampling; tr.set_debug_id forces one)
    CLIENT_COMMIT_SAMPLE = 0.0
    GRV_BATCH_INTERVAL = 0.0005
    CLIENT_MAX_RETRY_DELAY = 1.0
    # read pipeline: same-tick coalescing of
    # client reads into storage multiGet/multiGetRange batches
    # (client/read_coalescer.py). Off = every read is its own RPC (the
    # pre-pipeline shape; the differential battery runs both).
    CLIENT_READ_COALESCING = True
    CLIENT_MULTIGET_MAX_KEYS = 1024  # entries per batched request
    # batched reads a storage connection keeps in flight per team before
    # new reads queue into the next batch (read pipelining, not
    # stop-and-wait: batch N+1 dispatches while batch N's reply is on
    # the wire)
    CLIENT_READ_PIPELINE_DEPTH = 4
    # transport v2: frame-batched zero-copy
    # wire path. Batching selects what a sender EMITS (gen-7 super-frames
    # vs gen-6 per-message frames — receivers accept both, so the A/B
    # runs within one build); loopback short-circuits colocated worlds in
    # the same OS process onto an in-process byte path (net/loopback.py)
    TRANSPORT_FRAME_BATCHING = True
    TRANSPORT_LOOPBACK = True
    TRANSPORT_RECV_BYTES = 1 << 16  # preallocated recv buffer (grows on demand)
    TRANSPORT_COMPACT_WATERMARK = 1 << 16  # consumed bytes before compaction
    TRANSPORT_MAX_BATCH_MESSAGES = 512  # messages per super-frame before early flush
    # sim-only transport chaos: super-frame truncation / partial-flush
    # site — a faulted request's caller sees a typed retryable error
    # (TransportTruncated), never a wedged connection
    TRANSPORT_FAULT_INJECTION = False
    # simulation (Sim2's latency model: MIN + FAST·a almost always, rare
    # tail to MAX — flow/Knobs.cpp:106-108, sim2.actor.cpp:1618)
    SIM_MIN_LATENCY = 0.0001
    SIM_FAST_LATENCY = 0.0008
    SIM_MAX_LATENCY = 0.003
    SIM_CLOG_MAX = 2.0
    SIM_FILE_SYNC_TIME = 0.0005  # modeled fsync of a simulated file
    SIM_FILE_WRITE_TIME = 0.00005

    def __init__(self, **overrides):
        for k, v in overrides.items():
            if not hasattr(type(self), k):
                raise KeyError(f"unknown knob {k!r}")
            setattr(self, k, v)

    def as_dict(self) -> dict:
        """Every knob value (for the wire codec and --knob tooling)."""
        return {
            k: getattr(self, k)
            for k in dir(type(self))
            if k.isupper() and not k.startswith("_")
        }

    def randomize(self, rng) -> None:
        """Buggify-style knob randomization for simulation runs (the
        reference randomizes knob defaults per sim run — BUGGIFY-aware
        defaults in */Knobs.cpp). Every choice is a legal configuration;
        extreme values exist to force rare paths (tiny batches, tiny spill
        thresholds, aggressive timeouts)."""
        if rng.coinflip(0.25):
            self.COMMIT_BATCH_INTERVAL = rng.random_choice([0.0005, 0.002, 0.01])
        if rng.coinflip(0.25):
            self.GRV_BATCH_INTERVAL = rng.random_choice([0.0002, 0.001, 0.005])
        if rng.coinflip(0.25):
            self.MAX_BATCH_TXNS = rng.random_choice([8, 64, 1024])
        if rng.coinflip(0.25):
            self.CONFLICT_SET_CAPACITY = rng.random_choice([16, 256, 1 << 12])
        if rng.coinflip(0.25):
            self.MAX_COMMIT_BATCH_INTERVAL = rng.random_choice([0.02, 0.1, 0.25])
        if rng.coinflip(0.25):
            self.TLOG_SPILL_THRESHOLD = rng.random_choice([256, 4096, 1 << 20])
        if rng.coinflip(0.25):
            self.STORAGE_DURABILITY_LAG = rng.random_choice([0.05, 0.5, 1.5])
        if rng.coinflip(0.25):
            self.STORAGE_FETCH_KEYS_BATCH = rng.random_choice([2, 64, 10_000])
        if rng.coinflip(0.25):
            self.HEARTBEAT_INTERVAL = rng.random_choice([0.2, 0.5, 1.0])
        if rng.coinflip(0.25):
            self.FAILURE_TIMEOUT = rng.random_choice([1.0, 2.0, 4.0])
        if rng.coinflip(0.25):
            self.CLIENT_MAX_RETRY_DELAY = rng.random_choice([0.2, 1.0])
        # coupled constraint: the failure detector must tolerate several
        # heartbeat periods (including a buggify-doubled one), or workers
        # flap out of the registry and recruitment never settles
        self.FAILURE_TIMEOUT = max(
            self.FAILURE_TIMEOUT, self.HEARTBEAT_INTERVAL * 4
        )
        if rng.coinflip(0.25):
            self.SIM_MAX_LATENCY = rng.random_choice([0.001, 0.003, 0.02])
        if rng.coinflip(0.25):
            self.SIM_FAST_LATENCY = rng.random_choice([0.0002, 0.0008, 0.004])
        if rng.coinflip(0.25):
            self.COMMIT_BATCH_INTERVAL_FROM_IDLE = rng.random_choice(
                [0.0001, 0.0005, 0.005]
            )
        if rng.coinflip(0.25):
            self.ROUTER_BUFFER_BYTES = rng.random_choice([512, 1 << 14, 1 << 20])
        if rng.coinflip(0.25):
            self.DD_SHARD_MAX_BYTES = rng.random_choice([2048, 1 << 16, 1 << 18])
            self.DD_SHARD_MIN_BYTES = self.DD_SHARD_MAX_BYTES // 8
        if rng.coinflip(0.25):
            self.DD_TRACKER_INTERVAL = rng.random_choice([0.3, 2.0, 10.0])
        if rng.coinflip(0.25):
            self.DD_MOVE_THROTTLE = rng.random_choice([0.0, 0.5, 2.0])
        if rng.coinflip(0.25):
            self.RK_MAX_TPS = rng.random_choice([500.0, 10_000.0, 100_000.0])
        if rng.coinflip(0.25):
            self.GRV_BATCH_INTERVAL = rng.random_choice([0.0002, 0.0005, 0.002])
        if rng.coinflip(0.25):
            self.TLOG_FSYNC_TIME = rng.random_choice([0.00005, 0.0002, 0.002])
        if rng.coinflip(0.25):
            self.MASTER_VERSION_GAP_TIMEOUT = rng.random_choice([1.0, 4.0, 8.0])
        if rng.coinflip(0.25):
            self.PROXY_MASTER_MISS_LIMIT = rng.random_choice([3, 8, 20])
        if rng.coinflip(0.25):
            self.RK_POLL_INTERVAL = rng.random_choice([0.1, 0.5, 1.5])
        if rng.coinflip(0.25):
            self.STORAGE_WAIT_VERSION_TIMEOUT = rng.random_choice([0.3, 1.0, 3.0])
        if rng.coinflip(0.25):
            self.SIM_FILE_SYNC_TIME = rng.random_choice([0.0001, 0.0005, 0.005])
        if rng.coinflip(0.25):
            self.RESOLUTION_BALANCING_INTERVAL = rng.random_choice([0.3, 1.0, 5.0])
        if rng.coinflip(0.25):
            self.RESOLUTION_BALANCE_MIN_OPS = rng.random_choice([50, 200, 1000])
        if rng.coinflip(0.25):
            self.LATENCY_PROBE_INTERVAL = rng.random_choice([0.5, 1.0, 5.0])
        if rng.coinflip(0.25):
            self.METRICS_TRACE_INTERVAL = rng.random_choice([1.0, 5.0, 10.0])
        if rng.coinflip(0.25):
            self.CONFLICT_DISPATCH_DEADLINE = rng.random_choice([0.5, 2.0, 5.0])
        if rng.coinflip(0.25):
            self.CONFLICT_FAILOVER_STRIKES = rng.random_choice([2, 3, 5])
        if rng.coinflip(0.25):
            self.CONFLICT_REPROBE_INTERVAL = rng.random_choice([0.3, 1.0, 3.0])
        if rng.coinflip(0.25):
            self.CONFLICT_JOURNAL_CAPACITY = rng.random_choice([64, 512, 2048])
        if rng.coinflip(0.25):
            # 0 exercises the legacy encode-in-dispatch shape; >0 the
            # double-buffered path (inline in sim, but with the early
            # pre-gate encode ordering and its stale-encoding window)
            self.CONFLICT_ENCODE_THREADS = rng.random_choice([0, 1, 2])
        if rng.coinflip(0.25):
            self.CONFLICT_RESHARD_PRESSURE = rng.random_choice([0.5, 0.75, 0.9])
        if rng.coinflip(0.25):
            self.CONFLICT_GROW_FILL = rng.random_choice([0.25, 0.5, 0.8])
        # coupled constraint: a proxy must keep waiting for a version
        # grant at least as long as the master might legitimately park it
        # behind a gap, or slow-but-honored grants get double-assigned
        self.GETCOMMITVERSION_TIMEOUT = max(
            self.GETCOMMITVERSION_TIMEOUT,
            self.MASTER_VERSION_GAP_TIMEOUT + 2.0,
        )

    def randomize_admission(self, rng) -> None:
        """Admission-control knob randomization, kept OUT of
        randomize() for the same pinned-seed reason as the read-pipeline
        knobs: the soak draws these at the very END of its sequence so
        every pinned chaos seed's cluster shape and workload rotation
        reproduce exactly. Capacity (RK_MAX_TPS) already randomizes in
        randomize(); these shape the queue/shed/tenant behavior only."""
        if rng.coinflip(0.25):
            # tiny queues force the shed-on-arrival path
            self.RK_GRV_QUEUE_MAX = rng.random_choice([8, 64, 512])
        if rng.coinflip(0.25):
            self.RK_GRV_QUEUE_TIMEOUT = rng.random_choice([0.1, 0.5, 2.0])
        if rng.coinflip(0.25):
            self.RK_TENANT_MAX_SHARE = rng.random_choice([0.25, 0.5, 1.0])
        if rng.coinflip(0.25):
            self.RK_BATCH_SENSITIVITY = rng.random_choice([0.25, 0.5, 0.75])
        if rng.coinflip(0.25):
            self.RK_ADMISSION_TICK = rng.random_choice([0.005, 0.02, 0.05])

    def randomize_transport(self, rng) -> None:
        """Transport-knob randomization, drawn at the very END
        of the soak's sequence (after randomize_admission) for the same
        pinned-seed reason as the read-pipeline/admission draws: the
        earlier cluster-shape and workload-rotation draws must reproduce
        exactly. Arming TRANSPORT_FAULT_INJECTION makes the soak call
        ``sim.arm_transport_faults`` with a DEDICATED forked rng, so even
        the armed runs leave the main chaos stream untouched."""
        if rng.coinflip(0.25):
            # both framings stay exercised across the soak matrix
            self.TRANSPORT_FRAME_BATCHING = rng.random_choice([True, False])
        if rng.coinflip(0.25):
            # tiny caps force the early-flush path
            self.TRANSPORT_MAX_BATCH_MESSAGES = rng.random_choice([2, 64, 512])
        if rng.coinflip(0.25):
            # tiny watermarks force constant compaction
            self.TRANSPORT_COMPACT_WATERMARK = rng.random_choice(
                [1 << 12, 1 << 16]
            )
        if rng.coinflip(0.3):
            self.TRANSPORT_FAULT_INJECTION = True

    def randomize_storage_engine(self, rng) -> None:
        """Storage-engine knob randomization, drawn at the very
        END of the soak's sequence (after the transport draws) for the
        pinned-seed reason shared by every later draw: earlier
        cluster-shape and workload-rotation draws must reproduce exactly.
        The knob is consulted when a StorageServer constructs — in the
        soak that happens inside the sim run (worker recruitment), after
        these draws land."""
        if rng.coinflip(0.25):
            # both engine personalities stay exercised across the matrix
            self.STORAGE_EPOCH_BATCHING = rng.random_choice([True, False])
        if rng.coinflip(0.25):
            # tiny leases force the TOO_OLD-restart path; long ones hold
            # the durability horizon across whole scans
            self.STORAGE_SNAPSHOT_LEASE = rng.random_choice([0.05, 2.0, 10.0])
        if rng.coinflip(0.25):
            # a tight pin cap forces the forced-advance pin invalidation
            self.STORAGE_PIN_MAX_LAG_VERSIONS = rng.random_choice(
                [6_000_000, 10_000_000, 50_000_000]
            )

    def randomize_watches(self, rng) -> None:
        """Watch/change-feed knob randomization, drawn at the
        very END of the soak's sequence (after randomize_storage_engine)
        for the pinned-seed reason shared by every later draw:
        earlier cluster-shape and workload-rotation draws must reproduce
        exactly. Tiny limits force the TooManyWatches backoff path; tiny
        retention forces feed TOO_OLD resumes."""
        if rng.coinflip(0.25):
            # tiny limits force the over-limit error + client backoff
            self.STORAGE_WATCH_LIMIT = rng.random_choice([4, 64, 1_000_000])
        if rng.coinflip(0.25):
            # tiny retention forces feed resume-below-floor TOO_OLD
            self.STORAGE_FEED_RETENTION_VERSIONS = rng.random_choice(
                [200_000, 1_000_000, 5_000_000]
            )
        if rng.coinflip(0.25):
            # tiny pages force the `more` continuation path
            self.STORAGE_FEED_BATCH_ENTRIES = rng.random_choice([2, 64, 1_000])

    def randomize_prefilter(self, rng) -> None:
        """Prefilter knob randomization, drawn at the very END
        of the soak's sequence (after randomize_watches) for the
        pinned-seed reason shared by every later draw: earlier
        cluster-shape and workload-rotation draws must reproduce exactly.
        The knob is drawn both ways so the soak matrix covers on AND off;
        tiny caps force the eviction/decay paths that only forget
        conflicts (the conservative direction the oracle checks)."""
        if rng.coinflip(0.4):
            self.PROXY_CONFLICT_PREFILTER = rng.random_choice([True, False])
        if rng.coinflip(0.25):
            # short prefixes alias unrelated writes into one bucket —
            # blunter summary, still conservative (exact entry confirm)
            self.PREFILTER_PREFIX_LEN = rng.random_choice([1, 3, 6])
        if rng.coinflip(0.25):
            # tiny caps force bucket-entry eviction + wide-list overflow
            self.PREFILTER_BUCKET_ENTRIES = rng.random_choice([2, 8, 32])
            self.PREFILTER_WIDE_RANGES = rng.random_choice([2, 16, 128])
        if rng.coinflip(0.25):
            # tiny bucket cap forces whole-bucket eviction
            self.PREFILTER_MAX_BUCKETS = rng.random_choice([4, 64, 4096])
        if rng.coinflip(0.25):
            # tiny feedback cap forces resolver-side truncation (newest
            # kept; the proxy just learns less — conservative)
            self.PREFILTER_FEEDBACK_MAX_RANGES = rng.random_choice([4, 64, 512])

    def randomize_read_pipeline(self, rng) -> None:
        """Read-pipeline knob randomization, kept OUT of randomize():
        the chaos soak's cluster shapes and workload rotation draw from
        the same stream right after randomize(), so new draws there would
        silently reshuffle every pinned soak seed. The soak calls this at
        the END of its draw sequence instead (tools/soak.py)."""
        if rng.coinflip(0.25):
            # both read paths stay exercised across the soak matrix
            self.CLIENT_READ_COALESCING = rng.random_choice([True, False])
        if rng.coinflip(0.25):
            # tiny batches force the chunking path; tiny depth forces queuing
            self.CLIENT_MULTIGET_MAX_KEYS = rng.random_choice([2, 64, 1024])
        if rng.coinflip(0.25):
            self.CLIENT_READ_PIPELINE_DEPTH = rng.random_choice([1, 2, 8])

    def randomize_commit_path(self, rng) -> None:
        """Commit-path knob randomization, drawn at the very
        END of the soak's sequence (after randomize_prefilter) for the
        pinned-seed reason shared by every later draw: earlier
        cluster-shape and workload-rotation draws must reproduce exactly.
        Each mechanism is drawn both ways so the soak matrix covers the
        legacy paths too — the compiled codec is byte-identical by
        construction, slab settling only regroups wakeups, and the fsync
        pipeline must hold the no-early-ack contract under chaos."""
        if rng.coinflip(0.3):
            self.WIRE_COMPILED_CODEC = rng.random_choice([True, False])
        if rng.coinflip(0.3):
            self.FUTURE_SLAB_SETTLE = rng.random_choice([True, False])
        if rng.coinflip(0.3):
            self.TLOG_FSYNC_PIPELINE = rng.random_choice([True, False])

    def randomize_storage_metrics(self, rng) -> None:
        """Keyspace-telemetry knob randomization, drawn at the
        very END of the soak's sequence (after randomize_commit_path) so
        pinned chaos seeds keep their cluster-shape and workload draws
        byte-identical. Sampling is drawn both ways so the soak matrix
        keeps exercising DD's range-scan fallback; the sample factor
        sweeps dense→sparse; history cadence/capacity sweep tiny rings."""
        if rng.coinflip(0.3):
            self.STORAGE_METRICS_SAMPLING = rng.random_choice([True, False])
        if rng.coinflip(0.25):
            self.STORAGE_BYTE_SAMPLE_FACTOR = rng.random_choice([32, 200, 2000])
        if rng.coinflip(0.3):
            self.DD_WAIT_METRICS_SIZING = rng.random_choice([True, False])
        if rng.coinflip(0.25):
            self.METRICS_HISTORY_INTERVAL = rng.random_choice([0.5, 2.0, 10.0])
        if rng.coinflip(0.25):
            self.METRICS_HISTORY_SAMPLES = rng.random_choice([4, 32, 120])
