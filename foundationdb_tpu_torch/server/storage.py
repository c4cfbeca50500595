"""Storage server role: the MVCC read node.

The analog of fdbserver/storageserver.actor.cpp: pulls its tag's mutation
stream from the log system (update:2321) through a cross-generation
PeekCursor, applies it in version order to the VersionedMap MVCC window,
serves version-gated reads (getValueQ:680, getKeyValues:1180,
waitForVersion:627), and periodically advances durability — compacting the
window and popping the tlogs (updateStorage:2536).

Storage servers outlive master recoveries: when a new epoch's config
arrives, the server rolls back any versions beyond the old generation's end
version (rollback:2172 — data it pulled from a tlog whose tail didn't make
the recovery cut; clients never read those versions because GRVs only ever
return committed versions, which are ≤ every epoch-end) and then continues
pulling from the new generation's tlogs.

The port's copy of ``foundationdb_tpu/server/storage.py``. The durable
engine's snapshot index is a ``TorchRangeIndex``: multiGet engine misses,
multiGetRange's forward ranges and a single getRange's engine bounds are
answered by the K5 search kernel on the card named by ``device``
(``None`` = the CUDA card, which raises ``DeviceUnavailableError`` at the
first durability advance when there is none, and every later read of the
role raises that fault; the tests pass ``"cpu"``).
"""

from __future__ import annotations

from ..errors import FutureVersion, TransactionTooOld, WrongShardServer
from ..kv.atomic import apply_atomic
from ..kv.engine import KeyValueStoreMemory
from ..kv.keyrange_map import KeyRangeMap
from ..kv.mutations import Mutation, MutationType
from ..kv.versioned_map import EpochVersionedMap, VersionedMap
from ..runtime.futures import AsyncVar, delay, forever, wait_for_any
from ..runtime.knobs import Knobs
from ..runtime.buggify import buggify
from ..runtime.loop import Cancelled, now
from ..runtime.stats import CounterCollection
from ..runtime.trace import (
    SevInfo,
    SevWarn,
    active_span,
    emit_span,
    root_context,
    span,
    trace,
)
from ..kv.selector import SELECTOR_END
from ..ops.range_index import TorchRangeIndex
from .interfaces import (
    FeedReadReply,
    FeedReadRequest,
    GetKeyReply,
    GetKeyRequest,
    GetKeyValuesReply,
    GetKeyValuesRequest,
    GetValueReply,
    GetValueRequest,
    MultiGetRangeReply,
    MultiGetRangeRequest,
    MultiGetReply,
    MultiGetRequest,
    READ_ERR_DROPPED,
    READ_ERR_WRONG_SHARD,
    Tokens,
    Version,
    WaitMetricsRequest,
    WatchValueReply,
    WatchValueRequest,
)
from .log_system import PeekCursor
from .storage_metrics import StorageServerMetrics, derive_metrics_seed
from .watches import WatchManager
from .systemdata import (
    KEY_SERVERS_PREFIX,
    PRIVATE_PREFIX,
    decode_key_servers_key,
    decode_key_servers_value,
)

WAIT_FOR_VERSION_TIMEOUT = 1.0  # default; knob STORAGE_WAIT_VERSION_TIMEOUT

# named chaos site (tools/soak.py coverage report): the durability drain
# stalls, the MVCC window grows, and pinned/ordinary reads must keep
# serving off the epoch layers while ingest runs hot
SITE_EPOCH_STALL = ("server/storage.py", "storage-epoch-stall")


class StorageServer:
    def __init__(
        self,
        tag: int,
        log_config: AsyncVar,  # AsyncVar[LogSystemConfig]
        knobs: Knobs = None,
        uid: str = "",
        owned_ranges=None,  # [(begin, end)] | None = owns everything (tests)
        disk=None,  # SimDisk/RealDisk → durable engine; None = memory only
        peer_for_tag=None,  # remote mirror: tag → peer address for fetches
        device=None,  # the range index's device: None = the CUDA card
    ):
        self.tag = tag
        self.log_config = log_config
        self.knobs = knobs or Knobs()
        self.uid = uid
        self.device = device
        # epoch-batched MVCC core: mutation batches apply as
        # one epoch each, clears are native range tombstones, reads pin
        # O(1) snapshots that clamp the durability drain. The legacy
        # per-mutation map stays behind the knob for one-build A/B.
        self._epoch_mode = bool(self.knobs.STORAGE_EPOCH_BATCHING)
        self.data = EpochVersionedMap() if self._epoch_mode else VersionedMap()
        # scan leases: version → (deadline, pinned_at); a chunked read
        # that replied `more` holds its version here so the next chunk
        # (fetchKeys, backup pages, long client scans) doesn't race a
        # durability advance into TOO_OLD
        self._scan_pins: dict = {}
        self.version = AsyncVar(0)
        self.durable_version = 0
        self._followed_epoch = -1
        self.process = None
        self._cursor = None
        self.engine = (
            KeyValueStoreMemory(disk, f"storage-{uid}") if disk is not None else None
        )
        # version-ordered ops awaiting durability: ("mut", v, m) |
        # ("rows", v, rows) | ("own", v, (begin, end, persist_state))
        self._durable_queue: list = []
        # range → None | ("owned", rv) | ("adding", mv, sources) as of the
        # durable version — what reboot recovery restores
        self._persist_owned = KeyRangeMap(default=None)
        # device batched-read snapshot index (rebuilt per durability advance
        # when the knob is on; conflict-kernel key encoding)
        self._range_index = None
        # the error that took the index down (a build or delta that raised,
        # e.g. no card or a CUDA fault): from then on reads raise it
        self._index_fault = None
        # shard ownership: range → None (not ours) | ("owned", ready_version)
        # | ("adding", since_version) — the reference's shards map with
        # AddingShard state (storageserver.actor.cpp:1761 fetchKeys)
        self.own_all = owned_ranges is None
        self.owned = KeyRangeMap(default=None)
        for begin, end in owned_ranges or ():
            self.owned.insert(begin, end, ("owned", 0))
            # the SEEDED ownership must be durable too: the first meta
            # write otherwise records owned=[] and a reboot recovers the
            # data rows with no ownership (permanently unreadable shard —
            # found by the chaos soak via quiet_database)
            self._persist_owned.insert(begin, end, ("owned", 0))
        # (begin, end) → [(mutation, version)] buffered during a fetch
        self._fetch_buffers: dict = {}
        # (begin, end) → (sources, move_version): enough to re-fetch if a
        # recovery rolls the spliced snapshot away
        self._fetch_info: dict = {}
        # ownership transitions since the durable horizon, for rollback
        # undo: [(version, begin, end, prior [(b, e, state)])]
        self._shard_events: list = []
        self._fetch_generation = 0  # bumped on rollback: in-flight fetches restart
        self._peer_for_tag = peer_for_tag
        # StorageServerMetrics (storageserver.actor.cpp:510): query/mutation
        # traffic + version gauges for status and ratekeeper-style lag views
        self.stats = CounterCollection("Storage", uid)
        self._c_queries = self.stats.counter("finishedQueries")
        self._c_rows = self.stats.counter("rowsQueried")
        self._c_bytes_q = self.stats.counter("bytesQueried")
        self._c_mutations = self.stats.counter("mutations")
        self._c_mutation_bytes = self.stats.counter("mutationBytes")
        # client-observed read service time, version wait included (the
        # reference's readLatencyBands) — feeds the status workload section
        self._l_read = self.stats.latency("readLatency")
        # exact per-endpoint histogram next to the sampled percentiles
        # (FDB's readLatencyBands proper)
        self._b_read = self.stats.bands("readLatencyBands")
        # read pipeline: batched-read accounting — batch and
        # entry totals, entries-per-batch distribution, engine misses
        # answered by the range-index kernel vs per-key fallbacks, and
        # the batched interval-query's time (model time in sim, wall on a
        # real server)
        self._c_mg_batches = self.stats.counter("multiGetBatches")
        self._c_mg_keys = self.stats.counter("multiGetKeys")
        self._c_mgr_batches = self.stats.counter("multiGetRangeBatches")
        self._c_mgr_ranges = self.stats.counter("multiGetRangeRanges")
        self._c_mg_index = self.stats.counter("multiGetIndexKeys")
        self._c_mg_fallback = self.stats.counter("multiGetFallbackKeys")
        self._l_mg_size = self.stats.latency("multiGetEntriesPerBatch")
        self._l_batch_range = self.stats.latency("batchRangeSeconds")
        # storage engine: epoch-apply and snapshot-pin evidence
        # — flowlint's reg-role-metrics carries these names in its
        # role_required_counters config, so the surface cannot go dark
        self._c_epochs = self.stats.counter("epochsApplied")
        self._c_epoch_muts = self.stats.counter("epochMutations")
        self._c_tombstones = self.stats.counter("rangeTombstones")
        self._c_pins = self.stats.counter("snapshotsPinned")
        self._l_epoch_size = self.stats.latency("epochMutationsPerApply")
        self.stats.gauge("pinnedSnapshots", self._pinned_count)
        self.stats.gauge("oldestPinnedAgeSeconds", self._oldest_pin_age)
        # sim-only read-fault hook: fn(request, reply) → mutated reply
        # (drop / partial / too_old on a subset; tests + chaos soak prove
        # the client degrades to per-key reads without losing RYW)
        self._read_fault_injector = None
        self.stats.gauge("version", lambda: self.version.get())
        self.stats.gauge("durableVersion", lambda: self.durable_version)
        self.stats.gauge(
            "windowVersions", lambda: self.version.get() - self.durable_version
        )
        # watches & change feeds: committed-gated trigger
        # fan-out — the counter names ride flowlint's
        # role_required_counters manifest like the engine's do
        self._c_watch_reg = self.stats.counter("watchesRegistered")
        self._c_watch_fired = self.stats.counter("watchesFired")
        self._c_watch_cancel = self.stats.counter("watchesCancelled")
        self._c_feed_entries = self.stats.counter("feedEntriesStreamed")
        self._c_watch_fanout = self.stats.counter("watchFanoutBatches")
        self.watches = WatchManager(
            self.knobs,
            registered=self._c_watch_reg,
            fired=self._c_watch_fired,
            cancelled=self._c_watch_cancel,
            streamed=self._c_feed_entries,
            fanout_batches=self._c_watch_fanout,
        )
        self.stats.gauge("watchBytes", self.watches.bytes_held)
        self.stats.gauge("watchesParked", self.watches.parked_count)
        # keyspace telemetry: sampled byte/bandwidth estimates
        # + read-hot-range detection + waitMetrics push — the counter
        # names ride flowlint's role_required_counters manifest
        self._c_bytes_sampled = self.stats.counter("bytesSampled")
        self._c_hot_checks = self.stats.counter("hotRangeChecks")
        self._c_wait_fired = self.stats.counter("waitMetricsFired")
        self.metrics = StorageServerMetrics(
            self.knobs,
            derive_metrics_seed(uid, tag),
            c_bytes_sampled=self._c_bytes_sampled,
            c_hot_range_checks=self._c_hot_checks,
            c_wait_metrics_fired=self._c_wait_fired,
        )
        self.stats.gauge("sampleEntries", self.metrics.sample_entries)
        self.stats.gauge("waitMetricsActive", self.metrics.wait_active)
        self.stats.gauge("hotRanges", self.metrics.hot_ranges_status)

    # -- snapshot pins ----------------------------------------------------------

    def _pinned_count(self) -> int:
        n = len(self._scan_pins)
        if self._epoch_mode:
            n += self.data.pinned_count()
        return n

    def _oldest_pin_age(self) -> float:
        t = now()
        ages = [t - t0 for _d, t0 in self._scan_pins.values()]
        if self._epoch_mode:
            pin = self.data.oldest_pin()
            if pin is not None:
                ages.append(t - pin.pinned_at)
        return round(max(ages), 4) if ages else 0.0

    def _pin_read(self, version: Version):
        """Pin an O(1) snapshot for the duration of a read handler: the
        durability drain observes the pin and never compacts the layers
        under an in-flight read. Returns None on the legacy path."""
        if not self._epoch_mode:
            return None
        self._c_pins.add()
        return self.data.snapshot(version, pinned_at=now())

    def _note_scan_lease(self, version: Version) -> None:
        """A chunked read replied `more`: lease-pin its version so the
        follow-up chunk (fetchKeys, backup pages, long scans) is still
        servable. Refreshed per chunk; expires by deadline so an
        abandoned scan cannot wedge durability (the pin-lag cap bounds it
        absolutely)."""
        if not self._epoch_mode:
            return
        lease = self.knobs.STORAGE_SNAPSHOT_LEASE
        if lease <= 0:
            return
        old = self._scan_pins.get(version)
        self._c_pins.add()
        self._scan_pins[version] = (
            now() + lease,
            old[1] if old else now(),
        )

    def _clamp_to_pins(self, target: Version) -> Version:
        """The durability advance the pins allow: live pins hold the
        horizon at min(pinned) — but only up to STORAGE_PIN_MAX_LAG
        versions behind the tip, past which the advance proceeds and the
        overstaying pin goes TOO_OLD."""
        if not self._epoch_mode:
            return target
        t = now()
        self._scan_pins = {
            v: lease
            for v, lease in self._scan_pins.items()
            if lease[0] > t and v >= self.durable_version
        }
        floor = self.data.min_pinned()
        if self._scan_pins:
            sp = min(self._scan_pins)
            floor = sp if floor is None else min(floor, sp)
        if floor is None or floor >= target:
            return target
        cap = max(0, self.version.get() - self.knobs.STORAGE_PIN_MAX_LAG_VERSIONS)
        new_durable = max(min(target, floor), min(target, cap))
        if new_durable > floor:
            # the cap overrode the pins: overstayers go TOO_OLD now, so
            # the map-level clamp agrees with this advance
            for pin in self.data._pins.values():
                if pin.version < new_durable:
                    pin.invalidated = True
        return new_durable

    # -- mutation pull loop (update:2321) --------------------------------------

    async def pull_loop(self):
        self._cursor = PeekCursor(self.process, self.tag, self.log_config)
        while True:
            self._maybe_rollback()
            messages, end = await self._cursor.next(self.version.get())
            if buggify():
                await delay(0.002)  # lagging storage (FutureVersion paths)
            self._maybe_rollback()  # config may have flipped while parked
            for version, mutations in messages:
                if version <= self.version.get():
                    continue  # already applied (replica failover overlap)
                if self._epoch_mode:
                    self._apply_epoch_message(version, mutations)
                else:
                    for m in mutations:
                        self._apply(m, version)
            if end > self.version.get():
                self.version.set(end)
            # fire watches / open feed visibility up to the committed
            # frontier the tlogs piggybacked (clamped to what's applied)
            self.watches.advance_committed(
                min(self._cursor.known_committed, self.version.get()),
                now(),
                self._proc_addr(),
            )

    # -- epoch apply (one sorted merge per batch) --------------------------------

    def _apply_epoch_message(self, version: Version, mutations) -> None:
        """Apply one version's mutation batch as ONE epoch: the batch
        reduces to its final per-key entries (a set a later clear in the
        batch overwrote is dropped here, at build time) plus native range
        tombstones, then lands in the window — and the durable queue — as
        a single record. Atomic ops resolve against the epoch's pending
        state first, so chains within one batch compose exactly as the
        per-mutation path would."""
        entries: dict = {}
        clears: list = []
        # data clears only (shard-drop clears from _apply_private are NOT
        # data changes: their watchers fail WrongShardServer there and
        # the feed must not stream them as committed mutations)
        watch_clears: list = []
        acc = (entries, clears)
        for m in mutations:
            self._c_mutations.add()
            self._c_mutation_bytes.add(len(m.param1) + len(m.param2 or b""))
            if m.param1.startswith(PRIVATE_PREFIX):
                self._apply_private(m, version, epoch=acc)
                continue
            if not self.own_all:
                if m.type == MutationType.CLEAR_RANGE:
                    seen = set()
                    for b, e, state in self.owned.intersecting(m.param1, m.param2):
                        if state is not None and state[0] == "adding":
                            key = self._buffer_key_for(b)
                            if key is not None and key not in seen:
                                seen.add(key)
                                self._fetch_buffers[key].append((m, version))
                else:
                    state = self.owned[m.param1]
                    if state is not None and state[0] == "adding":
                        key = self._buffer_key_for(m.param1)
                        if key is not None:
                            self._fetch_buffers[key].append((m, version))
                            continue  # point mutation: buffered only
            if m.type == MutationType.SET_VALUE:
                entries[m.param1] = m.param2
            elif m.type == MutationType.CLEAR_RANGE:
                self._epoch_clear(acc, m.param1, m.param2)
                watch_clears.append((m.param1, m.param2))
            elif m.is_atomic():
                # None result (compare-and-clear) = point tombstone entry
                entries[m.param1] = apply_atomic(
                    m.type, self._epoch_base(acc, m.param1), m.param2
                )
            else:
                raise AssertionError(f"storage can't apply {m!r}")
        if entries or clears:
            self.data.apply_epoch(version, entries, clears)
            self._c_epochs.add()
            self._c_epoch_muts.add(len(entries) + len(clears))
            self._l_epoch_size.add(float(len(entries) + len(clears)))
            self.metrics.on_epoch(entries, clears)
            if self.engine is not None:
                self._durable_queue.append(("epoch", version, (entries, clears)))
            self.watches.on_epoch(version, entries, watch_clears, now())

    def _epoch_clear(self, acc, begin: bytes, end: bytes) -> None:
        entries, clears = acc
        clears.append((begin, end))
        self._c_tombstones.add()
        for k in [k for k in entries if begin <= k < end]:
            del entries[k]

    def _epoch_base(self, acc, key: bytes):
        """Base value for an atomic op inside a building epoch: the
        epoch's own pending state first (entry, else a pending clear
        covering the key), then the window's latest, then the engine."""
        entries, clears = acc
        if key in entries:
            return entries[key]
        for b, e in reversed(clears):
            if b <= key < e:
                return None
        known, v = self.data.latest_with_presence(key)
        if known:
            return v
        if self.engine is not None:
            return self.engine.read_value(key)
        return None

    def _maybe_rollback(self) -> None:
        """On an epoch change, cut back to the old generation's end version
        (see module doc)."""
        cfg = self.log_config.get()
        if cfg is None or cfg.epoch == self._followed_epoch:
            return
        if self._followed_epoch >= 0:
            boundary = None
            for old in cfg.old:
                if old.set.epoch == self._followed_epoch:
                    boundary = old.end_version
                    break
            if boundary is not None and self.version.get() > boundary:
                trace(
                    SevWarn,
                    "StorageRollback",
                    self.process.address if self.process else "ss",
                    Tag=self.tag,
                    From=self.version.get(),
                    To=boundary,
                )
                self.data.rollback_after(boundary)
                # staged watch/feed diffs above the boundary were never
                # acked: drop them unfired/unstreamed (no phantom to retract)
                self.watches.rollback_after(boundary)
                # scan leases above the boundary hold cut-off versions:
                # drop them (their next chunk re-reads and fails TOO_OLD
                # or FutureVersion like any reader of a dead version)
                self._scan_pins = {
                    v: lease
                    for v, lease in self._scan_pins.items()
                    if v <= boundary
                }
                self._rollback_shard_state(boundary)
                self._durable_queue = [
                    e for e in self._durable_queue if e[1] <= boundary
                ]
                self.version.set(boundary)
        self._followed_epoch = cfg.epoch

    def _rollback_shard_state(self, boundary: Version) -> None:
        """Undo shard-ownership effects above the epoch-end boundary:
        (a) ownership transitions whose metadata version was discarded are
        reverted to the prior state; (b) a move that *did* survive but
        whose snapshot was spliced at a rolled-back version is re-fetched
        (the spliced rows were just deleted by data.rollback_after)."""
        self._fetch_generation += 1  # in-flight fetches restart their splice
        for v, begin, end, prior in reversed(
            [e for e in self._shard_events if e[0] > boundary]
        ):
            for b, e, state in reversed(prior):
                self.owned.insert(b, e, state)
            self._fetch_buffers.pop((begin, end), None)
        self._shard_events = [e for e in self._shard_events if e[0] <= boundary]
        # surviving moves with a rolled-back splice: fetch again
        for b, e, state in list(self.owned.ranges()):
            if state is None or state[0] != "owned" or state[1] <= boundary:
                continue
            key = next(
                (
                    k
                    for k in self._fetch_info
                    if k[0] <= b and (k[1] is None or (e is not None and e <= k[1]))
                ),
                None,
            )
            if key is None:
                continue
            sources, move_version = self._fetch_info[key]
            if move_version > boundary:
                continue  # the move itself was undone by (a)
            trace(
                SevWarn,
                "FetchKeysRestart",
                self.process.address if self.process else "ss",
                Tag=self.tag,
                Begin=key[0],
            )
            self.owned.insert(key[0], key[1], ("adding", move_version))
            self._fetch_buffers[key] = []
            self.process.spawn(
                self._fetch_keys(key[0], key[1], sources, move_version)
            )

    def _apply(self, m, version: Version) -> None:
        self._c_mutations.add()
        self._c_mutation_bytes.add(len(m.param1) + len(m.param2 or b""))
        if m.param1.startswith(PRIVATE_PREFIX):
            self._apply_private(m, version)
            return
        # mutations inside a range still being fetched are buffered and
        # replayed over the snapshot when it lands (fetchKeys's splice)
        if not self.own_all:
            if m.type == MutationType.CLEAR_RANGE:
                seen = set()
                for b, e, state in self.owned.intersecting(m.param1, m.param2):
                    if state is not None and state[0] == "adding":
                        key = self._buffer_key_for(b)
                        if key is not None and key not in seen:
                            seen.add(key)
                            self._fetch_buffers[key].append((m, version))
            else:
                state = self.owned[m.param1]
                if state is not None and state[0] == "adding":
                    key = self._buffer_key_for(m.param1)
                    if key is not None:
                        self._fetch_buffers[key].append((m, version))
                        return  # point mutation: buffered only
        if m.type == MutationType.SET_VALUE:
            self.data.set(m.param1, m.param2, version)
            self.metrics.on_set(m.param1, len(m.param2 or b""))
            self.watches.on_epoch(version, {m.param1: m.param2}, (), now())
        elif m.type == MutationType.CLEAR_RANGE:
            self._window_clear(m.param1, m.param2, version)
            self.metrics.on_clear_range(m.param1, m.param2)
            self.watches.on_epoch(version, {}, ((m.param1, m.param2),), now())
        elif m.is_atomic():
            newv = apply_atomic(m.type, self._latest_value(m.param1), m.param2)
            if newv is None:
                self._window_clear(m.param1, m.param1 + b"\x00", version)
                self.metrics.on_clear_key(m.param1)
            else:
                self.data.set(m.param1, newv, version)
                self.metrics.on_set(m.param1, len(newv))
            self.watches.on_epoch(version, {m.param1: newv}, (), now())
        else:
            raise AssertionError(f"storage can't apply {m!r}")
        if self.engine is not None:
            self._durable_queue.append(("mut", version, m))

    def _latest_value(self, key: bytes):
        """Base value for atomic ops: the window's newest entry (or a
        newer range tombstone, in epoch mode), falling through to the
        engine for keys the durability advance dropped (drop_known) —
        else the in-memory result diverges from the engine's replay of
        the same op."""
        known, v = self.data.latest_with_presence(key)
        if known:
            return v
        if self.engine is not None:
            return self.engine.read_value(key)
        return None

    def _window_clear(self, begin: bytes, end: bytes, version: Version) -> None:
        """LEGACY-path clear in the MVCC window, tombstoning
        engine-resident keys too: a key dropped to the engine by
        drop_known has no window entry, so VersionedMap.clear_range alone
        would leave reads falling through to the engine's (pre-clear)
        value until the next durability advance. The epoch path records a
        native range tombstone instead and never materializes engine rows
        (_apply_epoch_message / EpochVersionedMap)."""
        if self.engine is not None:
            for k, _v in self.engine.read_range(begin, end):
                if k not in self.data._hist:
                    self.data._append(k, version, None)
        self.data.clear_range(begin, end, version)

    def _buffer_key_for(self, k: bytes):
        for (b, e) in self._fetch_buffers:
            if b <= k and (e is None or k < e):
                return (b, e)
        return None

    # -- shard assignment (privatized metadata; fetchKeys:1761) ----------------

    def _apply_private(self, m, version: Version, epoch=None) -> None:
        """Privatized metadata mutations: interpreted (shard-assignment
        changes), never stored as data (ApplyMetadataMutation's \\xff\\xff
        handling). ``epoch`` is the building (entries, clears) accumulator
        on the epoch-batched path: a shard-drop's data clear rides the
        epoch as a range tombstone instead of a per-mutation queue entry."""
        key = m.param1[len(PRIVATE_PREFIX) :]
        if not key.startswith(KEY_SERVERS_PREFIX):
            return
        begin = decode_key_servers_key(key)
        info = decode_key_servers_value(m.param2)
        end = info["end"]
        mine_now = self.tag in info["tags"]
        state = self.owned[begin]
        held = state is not None
        if mine_now and not held:
            # we're the destination: fetch the data (AddingShard). A
            # REMOTE mirror fetches from its own region first (the old
            # tags' mirror peers), with the primary's NEW team as
            # fallback — a lagging mirror can apply this mutation after
            # the primary's old team already dropped the range, and the
            # old mirror peer may drop it mid-fetch too; the new primary
            # team is guaranteed to hold it (finishMoveKeys gated on it).
            sources = list(info["old_addrs"])
            if self._peer_for_tag is not None:
                peers = [
                    a
                    for a in (
                        self._peer_for_tag(t) for t in info["old_tags"]
                    )
                    if a
                ]
                if peers:
                    sources = peers + list(info["addrs"])
            trace(
                SevInfo,
                "FetchKeysBegin",
                self.process.address,
                Tag=self.tag,
                Begin=begin,
                At=version,
            )
            self._shard_events.append(
                (version, begin, end, list(self.owned.intersecting(begin, end)))
            )
            self.owned.insert(begin, end, ("adding", version))
            self._fetch_buffers[(begin, end)] = []
            self._fetch_info[(begin, end)] = (tuple(sources), version)
            if self.engine is not None:
                self._durable_queue.append(
                    (
                        "own",
                        version,
                        (begin, end, ("adding", version, tuple(sources))),
                    )
                )
            self.process.spawn(
                self._fetch_keys(begin, end, sources, version)
            )
        elif not mine_now and held:
            # we were removed: drop the data and stop serving
            trace(
                SevInfo,
                "ShardDropped",
                self.process.address,
                Tag=self.tag,
                Begin=begin,
            )
            self._shard_events.append(
                (version, begin, end, list(self.owned.intersecting(begin, end)))
            )
            self.owned.insert(begin, end, None)
            self._fetch_buffers.pop((begin, end), None)
            self._fetch_info.pop((begin, end), None)
            clear_end = end or b"\xff\xff\xff\xff\xff"
            # parked watches in the dropped range fail over to the new
            # team NOW — the drop's clear below is not a data change and
            # must never fire them with value=None
            self.watches.fail_range(begin, clear_end, WrongShardServer)
            if epoch is not None:
                # epoch path: the drop's clear is a native range tombstone
                # in the building epoch (drained to the engine with it)
                self._epoch_clear(epoch, begin, clear_end)
            else:
                self._window_clear(begin, clear_end, version)
            if self.engine is not None:
                self._durable_queue.append(("own", version, (begin, end, None)))
                if epoch is None:
                    self._durable_queue.append(
                        (
                            "mut",
                            version,
                            Mutation(
                                MutationType.CLEAR_RANGE,
                                begin,
                                clear_end,
                            ),
                        )
                    )

    async def _fetch_keys(self, begin, end, sources, move_version):
        """Fetch [begin, end) from the old team at a snapshot, splice the
        buffered mutation stream on top, become readable
        (storageserver.actor.cpp:1761)."""
        generation = self._fetch_generation
        rows: list = []
        at_version = max(move_version, self.version.get())
        src_i = 0
        lo = begin
        while True:
            req = GetKeyValuesRequest(
                begin=lo,
                end=end if end is not None else b"\xff\xff\xff\xff\xff",
                version=at_version,
                limit=2 if buggify() else self.knobs.STORAGE_FETCH_KEYS_BATCH,
            )
            src = sources[src_i % len(sources)]
            from ..net.sim import Endpoint

            try:
                reply = await self.process.request(
                    Endpoint(src, Tokens.GET_KEY_VALUES), req
                )
            except TransactionTooOld:
                # fell out of the source's MVCC window: restart at a newer
                # snapshot; buffered mutations ≤ it are covered by it. A
                # REMOTE mirror lagging past the whole window would loop
                # forever re-picking its own stale version — jump forward
                # by half a window each round (the splice below waits for
                # the stream to catch up to at_version, so a snapshot
                # ahead of the stream stays correct)
                at_version = max(
                    self.version.get(),
                    at_version
                    + self.knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS // 2,
                )
                rows, lo = [], begin
                src_i += 1
                await delay(0.1)
                continue
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                src_i += 1
                await delay(0.1)
                continue
            rows.extend(reply.data)
            if not reply.more:
                break
            lo = reply.data[-1][0] + b"\x00"
        if generation != self._fetch_generation:
            return  # a rollback restarted this fetch; the new actor owns it
        # the snapshot may be AHEAD of our mutation stream (a lagging
        # mirror fetching at a fresh version): stay in 'adding' (stream
        # mutations keep buffering) until the stream reaches at_version,
        # or post-splice stream mutations ≤ at_version would double-apply
        # onto a snapshot that already contains them
        while self.version.get() < at_version:
            await self.version.on_change()
            if generation != self._fetch_generation:
                return
        cur = self.owned[begin]
        if cur is None or cur[0] != "adding":
            return  # the move was undone (rollback) or superseded
        # splice: snapshot(at_version) + buffered stream (> at_version)
        state = dict(rows)
        buffered = self._fetch_buffers.pop((begin, end), [])
        for m, v in buffered:
            if v <= at_version:
                continue
            if m.type == MutationType.SET_VALUE:
                state[m.param1] = m.param2
            elif m.type == MutationType.CLEAR_RANGE:
                for k in [k for k in state if m.param1 <= k < m.param2]:
                    del state[k]
            elif m.is_atomic():
                nv = apply_atomic(m.type, state.get(m.param1), m.param2)
                if nv is None:
                    state.pop(m.param1, None)
                else:
                    state[m.param1] = nv
        ready_version = self.version.get()
        if self._epoch_mode:
            # the spliced snapshot lands as ONE epoch: one sorted-index
            # merge instead of an insort per fetched row
            if state:
                self.data.apply_epoch(ready_version, dict(state))
        else:
            for k in sorted(state):
                self.data.set(k, state[k], ready_version)
        self.owned.insert(begin, end, ("owned", ready_version))
        if self.engine is not None:
            self._durable_queue.append(
                ("rows", ready_version, sorted(state.items()))
            )
            self._durable_queue.append(
                ("own", ready_version, (begin, end, ("owned", ready_version)))
            )
        trace(
            SevInfo,
            "FetchKeysDone",
            self.process.address,
            Tag=self.tag,
            Begin=begin,
            Rows=len(state),
            ReadyVersion=ready_version,
        )

    # -- durability / window advance (updateStorage:2536) ----------------------

    async def durability_loop(self):
        while True:
            await delay(
                0.02 if buggify() else self.knobs.STORAGE_DURABILITY_LAG
            )  # eager durability: shrink the in-memory MVCC window
            if self._epoch_mode and buggify(SITE_EPOCH_STALL):
                # chaos: the drain stalls and the window grows — reads
                # (pinned or not) must keep serving off the epoch layers
                await delay(0.25)
            new_durable = max(
                0,
                self.version.get() - self.knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS,
            )
            new_durable = self._clamp_to_pins(new_durable)
            if new_durable > self.durable_version:
                if self.engine is not None:
                    # the engine is mutated ahead of the window compaction:
                    # raise the window floor FIRST so a read at a version
                    # below the new horizon fails too_old instead of
                    # falling through to engine state newer than its
                    # snapshot (reads in (old, new] horizons still have
                    # their window entries until forget_before below)
                    self.data.oldest_version = new_durable
                    await self._make_durable(new_durable)
                self.durable_version = new_durable
                self.data.forget_before(
                    new_durable, drop_known=self.engine is not None
                )
                # shard events below the horizon can no longer roll back
                self._shard_events = [
                    e for e in self._shard_events if e[0] > new_durable
                ]
            if self._cursor is not None:
                # with a durable engine, tlogs may discard only what we've
                # PERSISTED — a reboot replays (durable, version] from them
                pop_to = (
                    self.durable_version if self.engine is not None
                    else self.version.get()
                )
                await self._cursor.pop(pop_to)

    async def _make_durable(self, new_durable: Version) -> None:
        """Drain the op queue through `new_durable` into the engine and
        commit, with the shard-assignment state as of that version — one
        atomic durability advance (updateStorage:2536)."""
        i = 0
        q = self._durable_queue
        while i < len(q) and q[i][1] <= new_durable:
            kind, _v, payload = q[i]
            if kind == "epoch":
                # one engine call per epoch: clears (range tombstones)
                # first, then the epoch's final entries — a single sorted
                # merge of the key index instead of per-key insorts
                entries, clears = payload
                self.engine.apply_epoch(entries, clears)
            elif kind == "mut":
                m = payload
                if m.type == MutationType.SET_VALUE:
                    self.engine.set(m.param1, m.param2)
                elif m.type == MutationType.CLEAR_RANGE:
                    self.engine.clear_range(m.param1, m.param2)
                elif m.is_atomic():
                    nv = apply_atomic(
                        m.type, self.engine.read_value(m.param1), m.param2
                    )
                    if nv is None:
                        self.engine.clear_range(m.param1, m.param1 + b"\x00")
                    else:
                        self.engine.set(m.param1, nv)
            elif kind == "rows":
                self.engine.apply_epoch(dict(payload))
            elif kind == "own":
                begin, end, state = payload
                self._persist_owned.insert(begin, end, state)
            i += 1
        del q[:i]
        self.engine.set(b"\xff\xff/local/meta", self._encode_local_meta(new_durable))
        if self._index_enabled():
            # update the index BEFORE the commit await: the drain above
            # mutated the engine synchronously, and a read interleaving
            # during the fsync must see index and key list in lockstep
            try:
                if self._range_index is None:
                    self.engine.track_dirty = True
                    self.engine.take_dirty()  # discard pre-index history
                    self._range_index = TorchRangeIndex(
                        list(self.engine._keys), device=self.device
                    )
                else:
                    added, removed = self.engine.take_dirty()
                    if added or removed:
                        self._range_index = self._range_index.apply_delta(
                            added, removed
                        )
            except Exception as e:
                # a failed build or delta fails the role: its reads raise
                # the fault instead of going to the engine bisect (or to an
                # index whose row count matches keys it no longer holds)
                self._range_index = None
                self._index_fault = e
                raise
        await self.engine.commit()

    def _encode_local_meta(self, durable: Version) -> bytes:
        import json

        entries = []
        for b, e, state in self._persist_owned.ranges():
            if state is None:
                continue
            entries.append(
                [
                    b.hex(),
                    e.hex() if e is not None else None,
                    list(state[:2]) + ([list(state[2])] if len(state) > 2 else []),
                ]
            )
        return json.dumps({"durable": durable, "owned": entries}).encode()

    async def _recover_durable_state(self) -> None:
        """Reboot path (restoreDurableState, storageserver.actor.cpp:2765):
        rows + shard assignment + durable version come back from the
        engine; the mutation stream resumes just above it."""
        await self.engine.recover()
        blob = self.engine.read_value(b"\xff\xff/local/meta")
        if blob is None:
            return  # brand new store
        import json

        meta = json.loads(blob.decode())
        durable = meta["durable"]
        self.version.set(durable)
        self.durable_version = durable
        self.data.oldest_version = durable
        self.data.latest_version = durable
        # the engine's shard assignment supersedes the manifest's seed list
        self.owned = KeyRangeMap(default=None)
        self._persist_owned = KeyRangeMap(default=None)
        for b_hex, e_hex, state in meta["owned"]:
            begin = bytes.fromhex(b_hex)
            end = bytes.fromhex(e_hex) if e_hex is not None else None
            if state[0] == "owned":
                self.owned.insert(begin, end, ("owned", min(state[1], durable)))
                self._persist_owned.insert(begin, end, ("owned", state[1]))
            elif state[0] == "adding":
                sources = tuple(state[2]) if len(state) > 2 else ()
                self.owned.insert(begin, end, ("adding", state[1]))
                self._persist_owned.insert(
                    begin, end, ("adding", state[1], sources)
                )
                self._fetch_buffers[(begin, end)] = []
                self._fetch_info[(begin, end)] = (sources, state[1])
                self.process.spawn(
                    self._fetch_keys(begin, end, list(sources), state[1])
                )
        trace(
            SevInfo,
            "StorageRecovered",
            self.process.address,
            Tag=self.tag,
            DurableVersion=durable,
            Rows=len(self.engine),
        )

    # -- version gate (waitForVersion:627) -------------------------------------

    async def _wait_for_version(self, version: Version):
        self._check_index_fault()
        if version < self.data.oldest_version:
            raise TransactionTooOld()
        deadline = delay(getattr(self.knobs, "STORAGE_WAIT_VERSION_TIMEOUT", WAIT_FOR_VERSION_TIMEOUT))
        while self.version.get() < version:
            which = await wait_for_any([self.version.on_change(), deadline])
            if which == 1:
                raise FutureVersion()

    # -- reads -----------------------------------------------------------------

    def _check_read(self, begin: bytes, end, version: Version) -> None:
        """Serve only shards we fully own with data complete at `version`
        (else wrong_shard_server — the client re-locates and retries)."""
        if self.own_all:
            return
        for _b, _e, state in self.owned.intersecting(begin, end):
            if state is None or state[0] != "owned" or version < state[1]:
                raise WrongShardServer()

    def _proc_addr(self) -> str:
        return getattr(self.process, "address", "") if self.process else ""

    async def get_value(self, req: GetValueRequest) -> GetValueReply:
        t0 = now()
        with span(
            "Storage.getValue", self._proc_addr(), storage=self.uid
        ) as sp:
            if buggify():
                await delay(0.001)  # slow replica (hedging/load-balance paths)
            t_wait = now()
            await self._wait_for_version(req.version)
            if sp.sampled and now() > t_wait:
                emit_span(
                    "Storage.waitVersion", self._proc_addr(), sp, t_wait, now()
                )
            self._check_read(req.key, req.key + b"\x00", req.version)
            t_eng = now()
            pin = self._pin_read(req.version)
            try:
                known, value = self.data.get_with_presence(req.key, req.version)
                if not known and self.engine is not None:
                    value = self.engine.read_value(req.key)
            finally:
                if pin is not None:
                    pin.release()
            if sp.sampled:
                emit_span("Storage.engine", self._proc_addr(), sp, t_eng, now())
                sp.event("StorageRead", kind="ReadDebug")
        dt = now() - t0
        self._c_queries.add()
        self._l_read.add(dt)
        self._b_read.add(dt)
        if value is not None:
            self._c_rows.add()
            self._c_bytes_q.add(len(req.key) + len(value))
            self.metrics.on_read(req.key, len(req.key) + len(value))
        return GetValueReply(value=value)

    async def get_key_values(self, req: GetKeyValuesRequest) -> GetKeyValuesReply:
        t0 = now()
        with span(
            "Storage.getRange", self._proc_addr(), storage=self.uid
        ) as sp:
            t_wait = now()
            await self._wait_for_version(req.version)
            if sp.sampled and now() > t_wait:
                emit_span(
                    "Storage.waitVersion", self._proc_addr(), sp, t_wait, now()
                )
            self._check_read(req.begin, req.end, req.version)
            # tiny replies force every caller through its `more`/windowing path
            limit = 1 if buggify() else req.limit
            t_eng = now()
            pin = self._pin_read(req.version)
            try:
                data = self._read_range_merged(
                    req.begin, req.end, req.version, limit + 1, req.reverse
                )
            finally:
                if pin is not None:
                    pin.release()
            if sp.sampled:
                emit_span(
                    "Storage.engine", self._proc_addr(), sp, t_eng, now(),
                    rows=len(data),
                )
                sp.event("StorageRead", kind="ReadDebug")
        more = len(data) > limit
        if more:
            # a continuation is coming at this same version: lease-pin it
            # so the next chunk doesn't race the durability drain TOO_OLD
            # (fetchKeys sources, backup pages, long client scans)
            self._note_scan_lease(req.version)
        dt = now() - t0
        self._c_queries.add()
        self._l_read.add(dt)
        self._b_read.add(dt)
        self._c_rows.add(min(len(data), limit))
        nbytes = sum(len(k) + len(v) for k, v in data[:limit])
        self._c_bytes_q.add(nbytes)
        self.metrics.on_read(req.begin, nbytes)
        return GetKeyValuesReply(data=data[:limit], more=more)

    def _owned_span(self, key: bytes, version: Version, before: bool = False):
        """(begin, end) of the owned-and-ready shard containing ``key`` (or
        the keys immediately below it, for backward walks); raises
        wrong_shard_server when this server can't serve it at ``version``."""
        if self.own_all:
            return b"", None
        b, e, state = (
            self.owned.range_before(key) if before else self.owned.range_for(key)
        )
        if state is None or state[0] != "owned" or version < state[1]:
            raise WrongShardServer()
        return b, e

    async def get_key(self, req: GetKeyRequest) -> GetKeyReply:
        t0 = now()
        with span("Storage.getKey", self._proc_addr(), storage=self.uid) as sp:
            try:
                return await self._get_key_impl(req, sp)
            finally:
                dt = now() - t0
                self._l_read.add(dt)
                self._b_read.add(dt)

    async def _get_key_impl(self, req: GetKeyRequest, sp) -> GetKeyReply:
        """Resolve a normalized key selector within this shard (getKeyQ,
        storageserver.actor.cpp:1288): walk ``offset`` keys forward from
        the anchor (or ``1 - offset`` backward), clamped to the shard —
        a walk that runs off the shard edge returns a partially-resolved
        selector repositioned at the boundary with the remaining offset,
        which the client's findKey loop carries to the adjacent shard.
        System keys (>= \\xff) are invisible: past-end resolves to \\xff,
        before-begin to b"" (the reference's non-system clamps)."""
        if buggify():
            await delay(0.001)  # slow replica (hedging/load-balance paths)
        t_wait = now()
        await self._wait_for_version(req.version)
        if sp.sampled and now() > t_wait:
            emit_span("Storage.waitVersion", self._proc_addr(), sp, t_wait, now())
        self._c_queries.add()
        return self._get_key_at(req)

    def _get_key_at(self, req: GetKeyRequest) -> GetKeyReply:
        """Post-version-gate selector resolution core, shared by the
        per-key getKey endpoint and multiGet's batched selector entries
        (which pay waitVersion once for the whole batch)."""
        k, off = req.key, req.offset
        before = off < 1
        o_begin, o_end = self._owned_span(k, req.version, before=before)
        # clamp to the CLIENT's located shard: a tag-routed server (static
        # clusters: own_all=True, shard map client-side) holds only its
        # shards' rows, so walking past the located bounds would misread
        # its local gap as the global keyspace edge
        s_begin = max(o_begin, req.begin)
        if o_end is None:
            s_end = req.end
        elif req.end is None:
            s_end = o_end
        else:
            s_end = min(o_end, req.end)
        if off >= 1:
            hi = SELECTOR_END if s_end is None else min(s_end, SELECTOR_END)
            rows = self._read_range_merged(k, max(k, hi), req.version, off, False)
            if len(rows) >= off:
                return GetKeyReply(key=rows[off - 1][0], resolved=True)
            if s_end is None or s_end >= SELECTOR_END:
                return GetKeyReply(key=SELECTOR_END, resolved=True)
            return GetKeyReply(key=s_end, offset=off - len(rows), resolved=False)
        needed = 1 - off
        hi = min(k, SELECTOR_END) if s_end is None else min(k, s_end, SELECTOR_END)
        rows = self._read_range_merged(
            s_begin, max(s_begin, hi), req.version, needed, True
        )
        if len(rows) >= needed:
            return GetKeyReply(key=rows[-1][0], resolved=True)
        if s_begin == b"":
            return GetKeyReply(key=b"", resolved=True)
        return GetKeyReply(key=s_begin, offset=off + len(rows), resolved=False)

    @staticmethod
    def _clear_covered(clears, key) -> bool:
        for b, e in clears:
            if b <= key < e:
                return True
        return False

    def _read_range_merged(self, begin, end, version, limit, reverse,
                           engine_bounds=None):
        """Window-over-engine merge (the reference's readRange:916 merge of
        the in-memory versioned tree with the durable engine). On the
        epoch path the window contributes native range tombstones too:
        engine rows they cover are masked without the window ever having
        materialized per-key tombstones for them.
        ``engine_bounds``: precomputed index row bounds for this range
        (multiGetRange resolves every range's bounds in one batched
        interval query)."""
        if self.engine is None:
            return self.data.range(
                begin, end, version, limit=limit, reverse=reverse
            )
        overlay, wclears = self.data.window_view(begin, end, version)
        if reverse:
            return self._merged_reverse(begin, end, overlay, limit, wclears)
        want = limit + len(overlay) + 1
        while True:
            base = self._engine_range(begin, end, want, bounds=engine_bounds)
            # the engine's local metadata rows (\xff\xff/local/...) are
            # not data — they must not leak into client scans or fetchKeys
            merged = {
                k: v
                for k, v in base
                if not k.startswith(PRIVATE_PREFIX)
                and not (wclears and self._clear_covered(wclears, k))
            }
            for k, v in overlay.items():
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = v
            rows = sorted(merged.items())
            exhausted = len(base) < want
            if len(rows) >= limit or exhausted:
                return rows[:limit]
            want *= 2

    def _merged_reverse(self, begin, end, overlay, limit, wclears=()):
        """Bounded chunked backward walk: each chunk reads the engine's
        LAST ``want`` rows below ``hi`` (O(want), kv/engine.py reverse
        read); inside [chunk_lo, hi) the engine rows are complete, so the
        overlay merge is exact there. Tombstone-heavy windows shrink a
        chunk's yield and the next chunk doubles — engine rows touched
        stay proportional to the limit, never the shard (the old path
        re-read the whole range through ``want = 1 << 30`` whenever the
        first chunk didn't cover it)."""
        out: list = []
        hi = end
        want = limit + len(overlay) + 1
        while True:
            base = self.engine.read_range(begin, hi, limit=want, reverse=True)
            exhausted = len(base) < want
            chunk_lo = begin if exhausted else base[-1][0]
            merged = {
                k: v
                for k, v in base
                if not k.startswith(PRIVATE_PREFIX)
                and not (wclears and self._clear_covered(wclears, k))
            }
            for k, v in overlay.items():
                if chunk_lo <= k < hi:
                    if v is None:
                        merged.pop(k, None)
                    else:
                        merged[k] = v
            out.extend(sorted(merged.items(), reverse=True))
            if len(out) >= limit or exhausted:
                return out[:limit]
            hi = chunk_lo
            want *= 2

    def _check_index_fault(self) -> None:
        """Raise the fault that took the index down in ``_make_durable``:
        once it has failed, no read of this role is served."""
        if self._index_fault is not None:
            raise self._index_fault.with_traceback(None)

    def _index_enabled(self) -> bool:
        flag = getattr(self.knobs, "STORAGE_TPU_INDEX", None)
        if flag is not None:
            return bool(flag)
        from ..runtime.loop import RealLoop, current_loop

        return not isinstance(current_loop(), RealLoop)

    def _engine_range(self, begin, end, want, bounds=None):
        """Durable-engine range rows, routed through the device range index
        when it is on (the snapshot's [lo, hi) row bounds come from the
        batched searchsorted kernel; rows materialize from the engine's
        sorted key list) — getRange coverage for the read-path index,
        falling back to the engine's own bisect otherwise. ``bounds``
        short-circuits the kernel query with row bounds the caller
        already resolved in a batched interval query (multiGetRange);
        they are valid only while no await has interleaved since.

        Codes are truncated, so the index bounds are approximate at code
        collisions: lo never overshoots (order-preserving codes) but the
        slice may include colliding keys below ``begin`` and the hi bound
        may cut a collision run short — the slice is extended through the
        run and post-filtered against the REAL byte keys."""
        self._check_index_fault()
        idx = self._range_index
        keys_list = self.engine._keys
        if bounds is None:
            if idx is None or idx.n != len(keys_list):
                return self.engine.read_range(begin, end, limit=want)
            t0 = now()
            lo, hi = idx.batch_range([begin], [end])
            lo, hi = int(lo[0]), int(hi[0])
            self._l_batch_range.add(now() - t0)
        else:
            lo, hi = bounds
        out = []
        j = lo
        n = len(keys_list)
        while j < n and (j < hi or keys_list[j] < end):
            k = keys_list[j]
            if k >= end:
                break
            if k >= begin:
                out.append((k, self.engine._map[k]))
                if len(out) >= want:
                    break
            j += 1
        return out

    # -- batched reads (the read pipeline's storage half) ------------------------

    def _multi_get_at(self, keys, version):
        """Point-read core shared by multiGet and the legacy batchGet:
        window hits answer locally; engine misses resolve through the
        device range-index snapshot in ONE vectorized kernel lookup
        (SURVEY.md's batched read-path primitive), falling back per-key
        while the index is off or mid-rebuild. Returns
        (values, [(index, READ_ERR_*)]) — runs after the batch's single
        waitVersion, with no awaits (index and engine stay in lockstep)."""
        out = [None] * len(keys)
        errors = []
        misses, miss_idx = [], []
        for i, k in enumerate(keys):
            try:
                self._check_read(k, k + b"\x00", version)
            except WrongShardServer:
                errors.append((i, READ_ERR_WRONG_SHARD))
                continue
            known, v = self.data.get_with_presence(k, version)
            if known:
                out[i] = v
            elif self.engine is not None:
                misses.append(k)
                miss_idx.append(i)
        if misses:
            self._check_index_fault()
            idx = self._range_index
            if idx is not None and idx.n == len(self.engine._keys):
                t0 = now()
                _rows, found = idx.batch_lookup(misses)
                self._l_batch_range.add(now() - t0)
                self._c_mg_index.add(len(misses))
                for j, i in enumerate(miss_idx):
                    if found[j]:
                        out[i] = self.engine._map.get(misses[j])
            else:
                self._c_mg_fallback.add(len(misses))
                for j, i in enumerate(miss_idx):
                    out[i] = self.engine.read_value(misses[j])
        return out, errors

    async def multi_get(self, req: MultiGetRequest) -> MultiGetReply:
        """The read pipeline's point endpoint: many gets — and selector
        resolutions — at ONE version in one RPC. waitVersion is paid once
        for the whole batch; per-entry failures come back as READ_ERR_*
        codes so one bad key fails only its own future (the client
        degrades it to a per-key read)."""
        t0 = now()
        n = len(req.keys) + len(req.selectors)
        with span(
            "Storage.multiGet", self._proc_addr(), storage=self.uid,
            keys=len(req.keys), selectors=len(req.selectors),
        ) as sp:
            if buggify():
                await delay(0.001)  # slow replica (hedging/load-balance paths)
            self._c_mg_batches.add()
            self._c_mg_keys.add(n)
            self._l_mg_size.add(float(n))
            t_wait = now()
            await self._wait_for_version(req.version)
            if sp.sampled and now() > t_wait:
                emit_span(
                    "Storage.waitVersion", self._proc_addr(), sp, t_wait, now()
                )
            t_eng = now()
            pin = self._pin_read(req.version)
            try:
                values, errors = self._multi_get_at(req.keys, req.version)
                sel_replies, sel_errors = [], []
                for i, sel in enumerate(req.selectors):
                    key, offset, begin, end = sel
                    greq = GetKeyRequest(
                        key=key, offset=offset, version=req.version,
                        begin=begin, end=end,
                    )
                    try:
                        sel_replies.append(self._get_key_at(greq))
                    except WrongShardServer:
                        sel_replies.append(None)
                        sel_errors.append((i, READ_ERR_WRONG_SHARD))
            finally:
                if pin is not None:
                    pin.release()
            if sp.sampled:
                emit_span(
                    "Storage.engine", self._proc_addr(), sp, t_eng, now(),
                    keys=n,
                )
                sp.event("StorageRead", kind="ReadDebug")
            reply = MultiGetReply(
                values=values, errors=errors,
                selectors=sel_replies, selector_errors=sel_errors,
            )
            inj = self._read_fault_injector
            if inj is not None:
                reply = inj(req, reply) or reply
            if buggify() and reply.values:
                # batched-read chaos: lose one entry — the client must
                # degrade exactly that key to the per-key path
                reply.errors = list(reply.errors) + [
                    (len(reply.values) - 1, READ_ERR_DROPPED)
                ]
        dt = now() - t0
        self._c_queries.add(n)
        self._l_read.add(dt)
        self._b_read.add(dt)
        for i, v in enumerate(reply.values):
            if v is not None:
                self._c_rows.add()
                self._c_bytes_q.add(len(req.keys[i]) + len(v))
                self.metrics.on_read(req.keys[i], len(req.keys[i]) + len(v))
        return reply

    async def multi_get_range(
        self, req: MultiGetRangeRequest
    ) -> MultiGetRangeReply:
        """getRange's multi sibling: several range windows at ONE version
        in one RPC. waitVersion once; every forward range's engine row
        bounds come from ONE TorchRangeIndex.batch_range interval query
        instead of N engine walks; reverse ranges keep the bounded
        backward walk per range."""
        t0 = now()
        with span(
            "Storage.multiGetRange", self._proc_addr(), storage=self.uid,
            ranges=len(req.ranges),
        ) as sp:
            self._c_mgr_batches.add()
            self._c_mgr_ranges.add(len(req.ranges))
            self._l_mg_size.add(float(len(req.ranges)))
            t_wait = now()
            await self._wait_for_version(req.version)
            if sp.sampled and now() > t_wait:
                emit_span(
                    "Storage.waitVersion", self._proc_addr(), sp, t_wait, now()
                )
            t_eng = now()
            pin = self._pin_read(req.version)
            any_more = False
            try:
                bounds = self._multi_engine_bounds(req.ranges)
                results, errors = [], []
                rows_total = 0
                for i, rng in enumerate(req.ranges):
                    begin, end, limit, reverse = rng
                    try:
                        self._check_read(begin, end, req.version)
                    except WrongShardServer:
                        results.append(None)
                        errors.append((i, READ_ERR_WRONG_SHARD))
                        continue
                    # tiny replies force every caller through its `more` path
                    limit_i = 1 if buggify() else limit
                    data = self._read_range_merged(
                        begin, end, req.version, limit_i + 1, reverse,
                        engine_bounds=None if bounds is None else bounds[i],
                    )
                    more = len(data) > limit_i
                    any_more = any_more or more
                    results.append(
                        GetKeyValuesReply(data=data[:limit_i], more=more)
                    )
                    rows_total += min(len(data), limit_i)
                    self._c_rows.add(min(len(data), limit_i))
                    nbytes = sum(len(k) + len(v) for k, v in data[:limit_i])
                    self._c_bytes_q.add(nbytes)
                    self.metrics.on_read(begin, nbytes)
            finally:
                if pin is not None:
                    pin.release()
            if any_more:
                self._note_scan_lease(req.version)
            if sp.sampled:
                emit_span(
                    "Storage.engine", self._proc_addr(), sp, t_eng, now(),
                    rows=rows_total,
                )
                sp.event("StorageRead", kind="ReadDebug")
            reply = MultiGetRangeReply(results=results, errors=errors)
            inj = self._read_fault_injector
            if inj is not None:
                reply = inj(req, reply) or reply
        dt = now() - t0
        self._c_queries.add(len(req.ranges))
        self._l_read.add(dt)
        self._b_read.add(dt)
        return reply

    def _multi_engine_bounds(self, ranges):
        """Per-range [lo, hi) engine row bounds from ONE batched interval
        query — the KeyRangeMap/readRange range lookups of the whole
        batch through the K5 search kernel (the secondary north
        star). None when the index can't serve (off / mid-rebuild / no
        engine); reverse ranges get None entries (bounded backward walk
        per range)."""
        self._check_index_fault()
        idx = self._range_index
        if (
            not ranges
            or self.engine is None
            or idx is None
            or idx.n != len(self.engine._keys)
        ):
            return None
        fwd = [i for i, r in enumerate(ranges) if not r[3]]
        if not fwd:
            return None
        t0 = now()
        los, his = idx.batch_range(
            [ranges[i][0] for i in fwd], [ranges[i][1] for i in fwd]
        )
        self._l_batch_range.add(now() - t0)
        self._c_mg_index.add(len(fwd))
        out = [None] * len(ranges)
        for j, i in enumerate(fwd):
            out[i] = (int(los[j]), int(his[j]))
        return out

    async def batch_get(self, req):
        """Legacy many-point-reads endpoint, now a thin adapter over the
        shared multiGet core (one batched read path to maintain).
        req = (keys, version) → [value | None]; any unservable key fails
        the whole request (the historical contract)."""
        keys, version = req
        t0 = now()
        with span(
            "Storage.batchGet", self._proc_addr(), storage=self.uid, keys=len(keys)
        ):
            await self._wait_for_version(version)
            pin = self._pin_read(version)
            try:
                out, errors = self._multi_get_at(keys, version)
            finally:
                if pin is not None:
                    pin.release()
            if errors:
                raise WrongShardServer()
        dt = now() - t0
        self._b_read.add(dt)
        return out

    async def watch_value(self, req: WatchValueRequest) -> WatchValueReply:  # flowlint: disable=reg-endpoint-span — long-poll: a span over a parked watch would read as minutes of latency
        """Park until the key's COMMITTED value differs from the
        watcher's belief (watchValue_impl:758): registration is an O(1)
        WatchManager entry, not a poll loop — the epoch apply path fires
        it when the committed frontier covers a version that changed the
        key. The shard moving away surfaces as wrong_shard_server
        (WatchManager.fail_range) and the client re-registers at the new
        team; registration past STORAGE_WATCH_LIMIT fails with the
        retryable TooManyWatches."""
        if buggify():
            await delay(0.002)  # watch registration races a change
        await self._wait_for_version(req.version)
        self._check_read(req.key, req.key + b"\x00", self.version.get())
        # immediate check at the newest committed version this server
        # knows: a change that landed while the registration was in
        # flight replies now instead of parking a watch that would never
        # fire. (At or below the client's GRV nothing uncommitted is
        # visible, so this read can never leak a rollback-doomed value.)
        at = min(max(self.watches.committed, req.version), self.version.get())
        known, v = self.data.get_with_presence(req.key, at)
        if not known and self.engine is not None:
            v = self.engine.read_value(req.key)
        if v != req.value:
            return WatchValueReply(value=v, version=at)
        # parent the eventual Storage.watchFire span to the TRACE ROOT
        # (not the client's rpc span): the fire is a sibling root, so
        # `cli trace breakdown` aggregates its own p50/p99 — the watch
        # notification latency number — instead of folding it into the
        # registration rpc's self time
        ctx = active_span()
        root = root_context(ctx.trace_id) if ctx is not None else None
        entry = self.watches.register(req.key, req.value, root)
        try:
            value, version = await entry.future
        finally:
            # fire already removed it; this covers caller-gone unwinds
            self.watches.deregister(entry)
        return WatchValueReply(value=value, version=version)

    async def feed_read(self, req: FeedReadRequest) -> FeedReadReply:  # flowlint: disable=reg-endpoint-span — long-poll: parked until the range has committed changes
        """One change-feed page: committed per-version diffs for
        [begin, end) above from_version, whole versions per page, paged
        with `more` past STORAGE_FEED_BATCH_ENTRIES. Long-polls while the
        range is quiet; the park cursor advances through verified-empty
        spans (and refreshes the subscriber's retention lease) so a quiet
        subscriber neither replays the world on wake nor goes TOO_OLD
        while parked. Resuming below the retention floor raises
        TransactionTooOld — the subscriber must re-snapshot."""
        if buggify():
            await delay(0.002)
        from_version = req.from_version
        limit = req.limit or self.knobs.STORAGE_FEED_BATCH_ENTRIES
        while True:
            self._check_read(req.begin, req.end, self.version.get())
            batches, next_version, more = self.watches.feed_collect(
                req.begin, req.end, from_version, limit, req.sub_id, now()
            )
            if batches or more:
                return FeedReadReply(
                    batches=batches, next_version=next_version, more=more
                )
            from_version = max(from_version, next_version)
            await self.version.on_change()

    def _sampled_range(self, begin: bytes, end: bytes):
        """(keys, stride): a stride-sampled slice of the engine's sorted
        keys in [begin, end) — the byte-sampling analog
        (storageserver.actor.cpp:2886 byteSampleApplySet): shard size
        estimation must not scan every row."""
        import bisect as _b

        if self.engine is None or not hasattr(self.engine, "_keys"):
            rows = dict(
                self._read_range_merged(begin, end, self.version.get(), 5000, False)
            )
            return (
                sorted(rows),
                1,
                (lambda k: len(k) + len(rows.get(k) or b"")),
            )
        ks = self.engine._keys
        lo = _b.bisect_left(ks, begin)
        hi = _b.bisect_left(ks, end)
        n = hi - lo
        stride = max(1, n // 64)
        keys = ks[lo:hi:stride]
        return keys, stride, (lambda k: len(k) + len(self.engine._map.get(k, b"")))

    async def get_shard_metrics(self, req) -> dict:  # flowlint: disable=reg-endpoint-span — admin/DD
        """Estimated bytes/rows for [begin, end) — the DD tracker's
        getShardMetrics source (DataDistributionTracker.actor.cpp:829)."""
        begin, end = req
        end = end if end is not None else b"\xff\xff"
        keys, stride, size_of = self._sampled_range(begin, end)
        est = sum(size_of(k) for k in keys) * stride
        return {"bytes": est, "rows": len(keys) * stride}

    async def get_split_key(self, req):  # flowlint: disable=reg-endpoint-span — admin/DD
        """A key splitting [begin, end) into roughly equal halves by
        sampled bytes (splitStorageMetrics analog); None when the range
        is too small to split."""
        begin, end = req
        end = end if end is not None else b"\xff\xff"
        keys, _stride, size_of = self._sampled_range(begin, end)
        if len(keys) < 4:
            return None
        total = sum(size_of(k) for k in keys)
        acc = 0
        for k in keys:
            acc += size_of(k)
            if acc * 2 >= total:
                return k if begin < k < end else None
        return None

    async def get_shard_state(self, req) -> bool:  # flowlint: disable=reg-endpoint-span — admin/DD
        """Is [begin, end) fully owned and readable? (the mover's readiness
        poll before finishMoveKeys — getShardStateQ in the reference)."""
        begin, end = req
        if self.own_all:
            return True
        for _b, _e, state in self.owned.intersecting(begin, end):
            if state is None or state[0] != "owned":
                return False
        return True

    # -- wiring ----------------------------------------------------------------

    async def _get_version(self, _req):  # flowlint: disable=reg-endpoint-span — liveness/lag poll
        """(version, durable_version, followed_epoch). The epoch qualifies
        the version — a raw version may still include a pre-recovery tail
        this server has not rolled back yet (it only rolls back once it
        sees the new epoch's config); durable_version is what a reboot
        would come back with (old tlog generations must outlive it)."""
        return (self.version.get(), self.durable_version, self._followed_epoch)

    async def _owned_ranges(self, _req) -> list:  # flowlint: disable=reg-endpoint-span — admin
        """[(begin, end)] this server currently OWNS — its applied view of
        the shard map. The failover promotion rebuilds the cluster shard
        map from the mirrors' own state (the coordinated snapshot may
        predate moves whose metadata relayed with the data)."""
        return [
            (b, e)
            for b, e, state in self.owned.ranges()
            if state is not None and state[0] == "owned"
        ]

    async def _metrics(self, _req) -> dict:  # flowlint: disable=reg-endpoint-span — metrics pull
        return self.stats.snapshot()

    async def wait_metrics(self, req) -> dict:  # flowlint: disable=reg-endpoint-span — long-poll
        """Threshold-band shard sizing: reply immediately when
        the sampled byte estimate for the range is outside the caller's
        [min_bytes, max_bytes] band, else park until a sampled mutation
        pushes it across (StorageMetrics.actor.h waitMetrics). Returns
        {"unsupported": True} when sampling is off so DD falls back to
        its range-scan path — NOT None, which is what the caller's
        timeout() yields and means re-arm."""
        if not self.metrics.enabled:
            return {"unsupported": True}
        if isinstance(req, WaitMetricsRequest):
            begin, end = req.begin, req.end
            min_bytes, max_bytes = req.min_bytes, req.max_bytes
        else:  # positional tuple, the test/admin convenience shape
            begin, end, min_bytes, max_bytes = req
        return await self.metrics.wait_metrics(begin, end, min_bytes, max_bytes)

    async def _metrics_history(self, _req) -> dict:  # flowlint: disable=reg-endpoint-span — metrics pull
        """The storage role's slice of the metrics-history ring; {}
        until the history loop has recorded a point."""
        h = self.stats.history
        return h.to_dict() if h is not None else {}

    def register_endpoints(self, process) -> None:
        self.process = process
        process.register(Tokens.GET_VALUE, self.get_value)
        process.register(Tokens.GET_KEY_VALUES, self.get_key_values)
        process.register(Tokens.GET_KEY, self.get_key)
        process.register(f"storage.version#{self.uid}", self._get_version)
        process.register(f"storage.ping#{self.uid}", self._ping)
        process.register(f"storage.metrics#{self.uid}", self._metrics)
        process.register(f"storage.ownedRanges#{self.uid}", self._owned_ranges)
        process.register(Tokens.GET_SHARD_STATE, self.get_shard_state)
        process.register(Tokens.GET_SHARD_METRICS, self.get_shard_metrics)
        process.register(Tokens.GET_SPLIT_KEY, self.get_split_key)
        process.register(Tokens.WAIT_METRICS, self.wait_metrics)
        process.register(f"storage.metricsHistory#{self.uid}", self._metrics_history)
        process.register(Tokens.WATCH_VALUE, self.watch_value)
        process.register(Tokens.FEED_READ, self.feed_read)
        process.register(Tokens.BATCH_GET, self.batch_get)
        process.register(Tokens.MULTI_GET, self.multi_get)
        process.register(Tokens.MULTI_GET_RANGE, self.multi_get_range)
        trace(SevInfo, "StorageServerUp", process.address, Tag=self.tag)

    def register(self, process) -> None:
        self.register_endpoints(process)
        process.spawn(self.pull_loop())
        process.spawn(self.durability_loop())
        process.spawn(self.stats.trace_loop(5.0, process.address))
        # static clusters host no Worker, so the history ring is fed here
        # (worker-hosted storage rides the Worker's history loop instead)
        process.spawn(self.stats.history_loop(self.knobs))

    async def run(self):
        """Worker-hosted lifetime: recover durable state first, then pull
        and persist until cancelled (role destroy / process kill)."""
        if self.engine is not None:
            await self._recover_durable_state()
        a = self.process.spawn(self.pull_loop())
        b = self.process.spawn(self.durability_loop())
        try:
            await forever()
        finally:
            a.cancel()
            b.cancel()

    async def _ping(self, _req):  # flowlint: disable=reg-endpoint-span — liveness
        return "pong"
