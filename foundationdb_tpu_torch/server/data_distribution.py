"""DataDistribution + Ratekeeper: shard placement repair and admission
control, run inside the master (as in the 6.0 reference —
masterserver.actor.cpp hosts both).

DataDistribution (fdbserver/DataDistribution.actor.cpp, simplified):
- failure-monitors every storage server (storageServerTracker:1558);
- walks the live shard map through the proxies' keyServers service and,
  for any shard whose team lost a member, rebuilds the team from healthy
  servers (fewest-shards-first — the spirit of DDTeamCollection's
  team building) and relocates with the MoveKeys protocol;
- also exposes the balance primitive tests/ManagementAPI drive directly
  (movekeys.move_shard).
Moves are serialized through one queue, like DataDistributionQueue's
in-flight limit (here: 1).

Ratekeeper (fdbserver/Ratekeeper.actor.cpp, simplified): computes a
cluster transaction rate from the worst storage-server version lag (the
"storage server write queue" signal — limitReason storage_server_write_-
queue_size); proxies poll it (getRate, MasterProxyServer.actor.cpp:85)
and gate GRVs through a token bucket, so client load backs off before
the MVCC window is overrun.

The port's copy of ``foundationdb_tpu/server/data_distribution.py``.
"""

from __future__ import annotations

from ..net.sim import Endpoint
from ..runtime.futures import delay, timeout
from ..runtime.trace import SevInfo, SevWarn, trace
from ..runtime.buggify import buggify
from .interfaces import GetKeyServersRequest, Tokens, WaitMetricsRequest
from .movekeys import merge_shards, move_shard, split_shard, take_move_keys_lock
from ..runtime.loop import Cancelled


class DataDistributor:
    def __init__(
        self,
        process,
        db,
        storage,
        knobs,
        replication: int,
        uid: str = "",
        zones: dict = None,  # tag → zone (policy-driven placement)
    ):
        self.process = process
        self.db = db  # Database over this epoch's proxies
        self.storage = list(storage)  # [StorageInterface]
        self.knobs = knobs
        self.replication = replication
        self.zones = dict(zones or {})
        # moveKeysLock owner id: this DD's claim on shard relocation;
        # a successor DD overwrites it and our movers abort (movekeys.py)
        self.uid = uid or f"dd-{process.address}"
        self.alive: dict[int, bool] = {s.tag: True for s in storage}
        self._last_move = -1e9  # relocation throttle (the move queue's
        #                         pacing — DataDistributionQueue's limits)
        # (shard begin, tag) → consecutive rounds a live member reported
        # the shard unreadable (e.g. it rebooted and lost an in-flight
        # fetch whose sources are gone) — treated like a dead member
        self._unready: dict = {}
        # waitMetrics push sizing (trackShardBytes): per-shard
        # byte estimates arrive as threshold-band pushes from the storage
        # servers' byte sample instead of poll-and-scan rounds
        self._shard_sizes: dict = {}  # (begin, end) → last pushed estimate
        self._shard_watches: dict = {}  # (begin, end) → watch actor Task
        self._no_samples: set = set()  # shards whose servers report unsupported

    async def run(self):
        monitor = self.process.spawn(self._failure_monitor())
        tracker = None
        try:
            await take_move_keys_lock(self.db, self.uid)
            tracker = self.process.spawn(self._size_tracker())
            while True:
                await delay(0.2 if buggify() else 1.0)  # eager repair races moves
                try:
                    await self._repair_once()
                except Cancelled:
                    raise  # actor-cancelled-swallow
                except Exception as e:
                    trace(
                        SevWarn, "DDRepairError", self.process.address, Err=repr(e)
                    )
        finally:
            monitor.cancel()  # dies with this DD, not with the process
            if tracker is not None:
                tracker.cancel()
            for task in self._shard_watches.values():
                task.cancel()
            self._shard_watches.clear()

    async def _failure_monitor(self):
        misses = {s.tag: 0 for s in self.storage}
        while True:
            await delay(self.knobs.HEARTBEAT_INTERVAL)
            for s in self.storage:
                try:
                    r = await timeout(
                        self.process.request(s.ep("ping"), None),
                        self.knobs.HEARTBEAT_INTERVAL * 2,
                    )
                    ok = r is not None
                except Cancelled:
                    raise  # actor-cancelled-swallow
                except Exception:
                    ok = False
                misses[s.tag] = 0 if ok else misses[s.tag] + 1
                was = self.alive[s.tag]
                now_alive = misses[s.tag] * self.knobs.HEARTBEAT_INTERVAL < (
                    self.knobs.FAILURE_TIMEOUT
                )
                if was and not now_alive:
                    trace(
                        SevWarn,
                        "DDStorageFailed",
                        self.process.address,
                        Tag=s.tag,
                        Address=s.address,
                    )
                self.alive[s.tag] = now_alive

    async def _check_member_readiness(self, shards, by_tag):
        from ..net.sim import Endpoint

        for begin, end, tags in shards:
            for t in tags:
                if not self.alive.get(t, False) or t not in by_tag:
                    continue
                key = (begin, t)
                try:
                    ready = await timeout(
                        self.process.request(
                            Endpoint(by_tag[t].address, Tokens.GET_SHARD_STATE),
                            (begin, end),
                        ),
                        1.0,
                    )
                except Cancelled:
                    raise  # actor-cancelled-swallow
                except Exception:
                    ready = None
                if ready:
                    self._unready.pop(key, None)
                else:
                    self._unready[key] = self._unready.get(key, 0) + 1

    async def _walk_shards(self):
        """[(begin, end, tags)] from the proxies' live keyInfo."""
        from .movekeys import walk_shards

        return [
            (b, e, tags) for b, e, _team, tags in await walk_shards(self.db)
        ]

    async def _get_excluded(self) -> set:
        from ..client.management import EXCLUDED_PREFIX

        async def body(tr):
            rows = await tr.get_range(
                EXCLUDED_PREFIX, EXCLUDED_PREFIX + b"\xff", snapshot=True
            )
            return {k[len(EXCLUDED_PREFIX) :].decode() for k, _v in rows}

        try:
            return await self.db.run(body, max_retries=3)
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception:
            return set()

    async def _size_tracker(self):
        """Shard size tracking + split/merge (DataDistributionTracker
        .actor.cpp:829 trackShardBytes + shardSplitter:340 /
        shardMerger:429): sampled byte estimates from a live member drive
        metadata-only splits of large shards and merges of adjacent cold
        same-team shards."""
        while True:
            await delay(self.knobs.DD_TRACKER_INTERVAL)
            try:
                await self._track_once()
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception as e:
                trace(
                    SevWarn, "DDTrackerError", self.process.address, Err=repr(e)
                )

    async def _watch_shard_metrics(self, begin, end, tags, by_tag):
        """Per-shard waitMetrics subscription actor (trackShardBytes):
        the first request carries a (-1, -1) band so the server replies
        immediately with its current estimate; every reply re-arms a
        band around the new estimate, capped so the split threshold is
        always a band edge (crossing DD_SHARD_MAX_BYTES always pushes).
        A timeout means the estimate stayed in-band — re-arm as-is. An
        {"unsupported"} reply (sampling off) demotes this shard to the
        range-scan fallback for this DD generation."""
        key = (begin, end)
        band = (-1, -1)
        while True:
            target = None
            for t in tags:
                if self.alive.get(t, False) and t in by_tag:
                    target = by_tag[t]
                    break
            if target is None:
                await delay(self.knobs.DD_TRACKER_INTERVAL)
                continue
            try:
                m = await timeout(
                    self.process.request(
                        Endpoint(target.address, Tokens.WAIT_METRICS),
                        WaitMetricsRequest(begin, end, band[0], band[1]),
                    ),
                    self.knobs.DD_WAIT_METRICS_TIMEOUT,
                )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                await delay(self.knobs.DD_TRACKER_INTERVAL)
                continue
            if m is None:
                continue  # timeout: estimate stayed inside the band; re-arm
            if m.get("unsupported"):
                self._no_samples.add(key)
                return
            est = int(m.get("bytes") or 0)
            self._shard_sizes[key] = est
            delta = max(est // 2, self.knobs.DD_SHARD_MAX_BYTES // 8, 1)
            lo, hi = max(0, est - delta), est + delta
            if est <= self.knobs.DD_SHARD_MAX_BYTES < hi:
                hi = self.knobs.DD_SHARD_MAX_BYTES
            band = (lo, hi)

    def _reconcile_watches(self, shards, by_tag) -> None:
        """Keep one watch actor per live shard: cancel watches whose
        boundaries a split/merge/move erased, spawn watches for new
        shards (shardTrackers map maintenance in the reference)."""
        want = {(b, e): tags for b, e, tags in shards}
        for key, task in list(self._shard_watches.items()):
            if key not in want:
                task.cancel()
                del self._shard_watches[key]
                self._shard_sizes.pop(key, None)
                self._no_samples.discard(key)
        for key, tags in want.items():
            if key in self._shard_watches or key in self._no_samples:
                continue
            self._shard_watches[key] = self.process.spawn(
                self._watch_shard_metrics(key[0], key[1], tags, by_tag)
            )

    async def _shard_bytes(self, begin, end, tags, by_tag):
        for t in tags:
            if not self.alive.get(t, False) or t not in by_tag:
                continue
            try:
                m = await timeout(
                    self.process.request(
                        Endpoint(by_tag[t].address, Tokens.GET_SHARD_METRICS),
                        (begin, end),
                    ),
                    1.0,
                )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                continue
            if m is not None:
                return m["bytes"]
        return None

    async def _track_once(self):
        shards = await self._walk_shards()
        by_tag = {s.tag: s for s in self.storage}
        use_push = bool(getattr(self.knobs, "DD_WAIT_METRICS_SIZING", True))
        if use_push:
            self._reconcile_watches(shards, by_tag)
        sizes = []
        for begin, end, tags in shards:
            key = (begin, end)
            if use_push and key not in self._no_samples:
                # None until the first push lands — skip the shard this
                # round rather than fall back to a full range scan
                sizes.append(self._shard_sizes.get(key))
            else:
                sizes.append(await self._shard_bytes(begin, end, tags, by_tag))
        # split the largest oversized shard (one structural change per
        # round keeps the tracker from racing its own boundary edits)
        worst_i, worst = None, self.knobs.DD_SHARD_MAX_BYTES
        for i, b in enumerate(sizes):
            if b is not None and b > worst:
                worst_i, worst = i, b
        if worst_i is not None:
            begin, end, tags = shards[worst_i]
            at = None
            for t in tags:
                if not self.alive.get(t, False) or t not in by_tag:
                    continue
                try:
                    at = await timeout(
                        self.process.request(
                            Endpoint(by_tag[t].address, Tokens.GET_SPLIT_KEY),
                            (begin, end),
                        ),
                        1.0,
                    )
                except Cancelled:
                    raise  # actor-cancelled-swallow
                except Exception:
                    continue
                break
            if at:
                trace(
                    SevInfo,
                    "DDShardSplit",
                    self.process.address,
                    Begin=begin,
                    At=at,
                    Bytes=worst,
                )
                await split_shard(self.db, at, lock_owner=self.uid)
            return
        # merge one adjacent cold pair with identical teams
        for (b1, e1, t1), (b2, _e2, t2), s1, s2 in zip(
            shards, shards[1:], sizes, sizes[1:]
        ):
            if (
                e1 == b2
                and set(t1) == set(t2)
                and s1 is not None
                and s2 is not None
                and s1 + s2 < self.knobs.DD_SHARD_MIN_BYTES
            ):
                trace(
                    SevInfo,
                    "DDShardMerge",
                    self.process.address,
                    Begin=b1,
                    Mid=b2,
                )
                await merge_shards(self.db, b1, lock_owner=self.uid)
                return

    async def _repair_once(self):
        shards = await self._walk_shards()
        excluded_addrs = await self._get_excluded()
        excluded_tags = {
            s.tag for s in self.storage if s.address in excluded_addrs
        }
        load = {s.tag: 0 for s in self.storage}
        for _b, _e, tags in shards:
            for t in tags:
                if t in load:
                    load[t] += 1
        by_tag = {s.tag: s for s in self.storage}
        await self._check_member_readiness(shards, by_tag)
        for begin, end, tags in shards:
            dead = [
                t
                for t in tags
                if not self.alive.get(t, False)
                or t in excluded_tags
                or self._unready.get((begin, t), 0) >= 4
            ]
            if not dead:
                continue
            healthy = [t for t in tags if t not in dead]
            candidates = sorted(
                (
                    t
                    for t, up in self.alive.items()
                    if up and t not in tags and t not in excluded_tags
                ),
                key=lambda t: load[t],
            )
            need = max(self.replication - len(healthy), 0)
            # policy-driven choice (ReplicationPolicy.h PolicyAcross over
            # zoneId): keep the rebuilt team's zones distinct when the
            # remaining topology allows; availability beats placement
            # otherwise
            if self.zones and need:
                used_zones = {self.zones.get(t) for t in healthy}
                distinct: list = []
                for t in candidates:
                    z = self.zones.get(t)
                    if z in used_zones:
                        continue
                    distinct.append(t)
                    used_zones.add(z)
                    if len(distinct) == need:
                        break
                if len(distinct) == need:
                    candidates = distinct + [
                        t for t in candidates if t not in distinct
                    ]
            # alive-but-unready members can be rebuilt in place: a
            # same-team re-move restarts their fetch from a healthy
            # source (otherwise a wedged member with no replacement
            # stays unreadable forever)
            rebuildable = [
                t
                for t in dead
                if self.alive.get(t, False) and t not in excluded_tags
            ]
            if need > len(candidates):
                candidates += rebuildable
            if need > len(candidates):
                trace(
                    SevWarn,
                    "DDNoReplacement",
                    self.process.address,
                    Begin=begin,
                    Need=need,
                )
                continue
            # cap at the replication factor: a mid-move union team (src ∪
            # dest) must not be finalized as an over-replicated team
            new_tags = (healthy + candidates[:need])[: self.replication]
            if not new_tags:
                continue
            # throttled move queue: repairs are paced so a burst of
            # failures doesn't saturate the cluster with relocations
            from ..runtime.loop import now as _now

            gap = self.knobs.DD_MOVE_THROTTLE - (_now() - self._last_move)
            if gap > 0:
                await delay(gap)
            self._last_move = _now()
            trace(
                SevInfo,
                "DDRelocating",
                self.process.address,
                Begin=begin,
                From=tags,
                To=tuple(new_tags),
            )
            await move_shard(
                self.db,
                begin,
                end,
                [by_tag[t] for t in new_tags],
                lock_owner=self.uid,
                rebuild_tags=tuple(t for t in rebuildable if t in new_tags),
            )
            for t in candidates[:need]:
                load[t] += 1


def _drain_factor(x, lo, hi) -> float:
    """1.0 while the signal is under its target, falling linearly to 0.0
    at its maximum (the reference updateRate's limit smoothing shape)."""
    if x is None or x <= lo:
        return 1.0
    if x >= hi:
        return 0.0
    return 1.0 - (x - lo) / (hi - lo)


def compute_rates(knobs, sig: dict) -> tuple[dict, str]:
    """Pure multi-signal controller (updateRate, Ratekeeper.actor.cpp):
    signals → cluster-wide per-class target rates + the limiting reason.

    Signals (any may be None = unknown, treated as healthy):
      version_lag      worst (last assigned − storage version)
      durability_lag   worst (storage version − durable version)
      tlog_queue_bytes worst tlog DiskQueue backlog
      busy_fraction    worst run-loop busy fraction (real loops only)
      band_overrun     fraction of proxy GRV/commit requests above
                       RK_BAND_SLO in the last interval
      kernel_state     worst conflict-kernel health state

    Classes drain in shed order: batch thresholds sit at
    RK_BATCH_SENSITIVITY of default's (batch rate may reach 0 — full
    shed); default is floored at RK_RATE_FLOOR; immediate throttles only
    when the MVCC window itself is threatened (or the kernel is FAILED)."""
    kernel_factor = {
        "DEGRADED": knobs.RK_KERNEL_DEGRADED_FACTOR,
        "FAILED_OVER": knobs.RK_KERNEL_FAILED_OVER_FACTOR,
        "FAILED": 0.1,
    }.get(sig.get("kernel_state"), 1.0)
    factors = {
        "storage_version_lag": _drain_factor(
            sig.get("version_lag"), knobs.RK_LAG_TARGET, knobs.RK_LAG_MAX
        ),
        "storage_durability_lag": _drain_factor(
            sig.get("durability_lag"),
            knobs.RK_DURABILITY_LAG_TARGET,
            knobs.RK_DURABILITY_LAG_MAX,
        ),
        "tlog_queue": _drain_factor(
            sig.get("tlog_queue_bytes"),
            knobs.RK_TLOG_QUEUE_TARGET,
            knobs.RK_TLOG_QUEUE_MAX,
        ),
        "run_loop_busy": _drain_factor(
            sig.get("busy_fraction"),
            knobs.RK_BUSY_FRACTION_TARGET,
            knobs.RK_BUSY_FRACTION_MAX,
        ),
        "latency_bands": _drain_factor(
            sig.get("band_overrun"),
            knobs.RK_BAND_OVERRUN_TARGET,
            knobs.RK_BAND_OVERRUN_MAX,
        ),
        "kernel_degraded": kernel_factor,
    }
    limiting = min(factors, key=factors.get)
    f_default = factors[limiting]
    if f_default >= 1.0:
        limiting = "workload"
    # batch: same signals through tighter thresholds (scale lo toward 0,
    # keep hi) so batch sheds first and fully (no floor)
    s = knobs.RK_BATCH_SENSITIVITY
    f_batch = min(
        _drain_factor(
            sig.get("version_lag"), knobs.RK_LAG_TARGET * s, knobs.RK_LAG_MAX
        ),
        _drain_factor(
            sig.get("durability_lag"),
            knobs.RK_DURABILITY_LAG_TARGET * s,
            knobs.RK_DURABILITY_LAG_MAX,
        ),
        _drain_factor(
            sig.get("tlog_queue_bytes"),
            knobs.RK_TLOG_QUEUE_TARGET * s,
            knobs.RK_TLOG_QUEUE_MAX,
        ),
        _drain_factor(
            sig.get("busy_fraction"),
            knobs.RK_BUSY_FRACTION_TARGET * s,
            knobs.RK_BUSY_FRACTION_MAX,
        ),
        _drain_factor(
            sig.get("band_overrun"),
            knobs.RK_BAND_OVERRUN_TARGET * s,
            knobs.RK_BAND_OVERRUN_MAX,
        ),
        kernel_factor * kernel_factor,  # kernel trouble bites batch twice
    )
    # immediate: only MVCC-window danger or a fully FAILED kernel
    f_immediate = _drain_factor(
        sig.get("version_lag"),
        knobs.RK_LAG_MAX,
        knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS,
    )
    if sig.get("kernel_state") == "FAILED":
        f_immediate = min(f_immediate, 0.5)
    floor = knobs.RK_MAX_TPS * knobs.RK_RATE_FLOOR
    rates = {
        "batch": knobs.RK_MAX_TPS * f_batch,
        "default": max(knobs.RK_MAX_TPS * f_default, floor),
        "immediate": max(knobs.RK_MAX_TPS * f_immediate, floor),
    }
    return rates, limiting


class Ratekeeper:
    """Multi-signal admission controller (updateRate, Ratekeeper.actor.cpp,
    grown from the single-signal lag controller): emits per-priority-class
    rates consumed by the proxies' admission queues (server/admission.py).

    Membership is LIVE: each control interval polls the cluster
    controller's worker registry and reads every hosted role's metrics
    (worker.metrics), so storage servers recruited after this Ratekeeper
    booted are visible to lag monitoring — the construction-time snapshot
    is only the fallback for the window before the registry answers."""

    def __init__(
        self,
        process,
        master,
        storage,
        knobs,
        uid: str,
        cc_address: str = "",
        n_proxies: int = 1,
    ):
        from ..runtime.stats import CounterCollection

        self.process = process
        self.master = master  # the Master (version authority) instance
        self.storage = list(storage)  # seed interfaces (registry fallback)
        self.knobs = knobs
        self.uid = uid
        self.cc_address = cc_address
        self.n_proxies = max(int(n_proxies), 1)
        full = float(self.knobs.RK_MAX_TPS)
        self.rates = {"batch": full, "default": full, "immediate": full}
        self.limiting = "workload"
        self.signals: dict = {}
        # per-proxy cumulative above-SLO band totals (overrun is an
        # interval rate, bands are lifetime-exact)
        self._band_last: dict[str, tuple] = {}
        # RatekeeperMetrics: its own CounterCollection + metrics endpoint
        # (the new-role-surface rule, ROADMAP standing guidance)
        self.stats = CounterCollection("Ratekeeper", uid)
        self._c_loops = self.stats.counter("controlLoops")
        self._c_registry = self.stats.counter("membershipPolls")
        self._c_registry_err = self.stats.counter("membershipErrors")
        self._c_fallback = self.stats.counter("seedFallbackPolls")
        self.stats.gauge("rates", lambda: {
            k: round(v, 2) for k, v in self.rates.items()
        })
        self.stats.gauge("limiting", lambda: self.limiting)
        self.stats.gauge("signals", lambda: dict(self.signals))
        self.stats.gauge("proxyCount", lambda: self.n_proxies)
        process.register(f"master.getRate#{uid}", self.get_rate)
        process.register(f"ratekeeper.metrics#{uid}", self._metrics)

    # back-compat scalar (status/tests read a single released rate)
    @property
    def rate(self) -> float:
        return self.rates["default"]

    async def get_rate(self, _req) -> dict:  # flowlint: disable=reg-endpoint-span — rate poll
        """The proxies' getRate poll (MasterProxyServer.actor.cpp:85):
        per-class rates already split across the proxy fleet."""
        return {
            "per_proxy": {
                k: v / self.n_proxies for k, v in self.rates.items()
            },
            "cluster": dict(self.rates),
            "released": self.rates["default"],
            "limiting": self.limiting,
        }

    async def _metrics(self, _req) -> dict:  # flowlint: disable=reg-endpoint-span — metrics pull
        return self.stats.snapshot()

    async def run(self):
        interval = self.knobs.RK_POLL_INTERVAL
        while True:
            await delay(interval)
            try:
                sig = await self._poll_signals()
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception as e:
                trace(
                    SevWarn, "RatekeeperPollError", self.process.address,
                    Err=repr(e),
                )
                continue
            if sig is None:
                continue
            self.signals = sig
            self._c_loops.add()
            target, limiting = compute_rates(self.knobs, sig)
            a = self.knobs.RK_RATE_SMOOTHING
            for k, v in target.items():
                self.rates[k] += a * (v - self.rates[k])
            self.limiting = limiting

    # -- signal collection -----------------------------------------------------

    async def _poll_signals(self):
        """One control sample over the LIVE cluster: registry → per-worker
        role metrics. Falls back to direct polls of the seed storage set
        when the registry is unreachable (early recovery, partitions)."""
        snaps = await self._registry_snapshots()
        if snaps is None:
            return await self._poll_seed_storage()
        sig: dict = {
            "version_lag": None,
            "durability_lag": None,
            "tlog_queue_bytes": None,
            "busy_fraction": None,
            "band_overrun": None,
            "kernel_state": None,
            "storage_count": 0,
        }
        from ..conflict.failover import health_rank

        band_now: dict[str, tuple] = {}
        worst_kernel = None
        for role_snaps, proc_snap in snaps:
            for rid, snap in (role_snaps or {}).items():
                kind = snap.get("kind")
                if kind == "storage":
                    v = snap.get("version") or 0
                    d = snap.get("durableVersion") or 0
                    sig["storage_count"] += 1
                    lag = self.master.last_assigned - v
                    dlag = v - d
                    if sig["version_lag"] is None or lag > sig["version_lag"]:
                        sig["version_lag"] = lag
                    if (
                        sig["durability_lag"] is None
                        or dlag > sig["durability_lag"]
                    ):
                        sig["durability_lag"] = dlag
                elif kind == "tlog":
                    q = max(snap.get("queueBytes") or 0, snap.get("memBytes") or 0)
                    if (
                        sig["tlog_queue_bytes"] is None
                        or q > sig["tlog_queue_bytes"]
                    ):
                        sig["tlog_queue_bytes"] = q
                elif kind == "resolver":
                    h = (snap.get("kernel") or {}).get("health") or {}
                    state = h.get("state")
                    if state and (
                        worst_kernel is None
                        or health_rank(state) > health_rank(worst_kernel)
                    ):
                        worst_kernel = state
                elif kind == "proxy":
                    above = total = 0
                    for key in ("grvLatencyBands", "commitLatencyBands"):
                        b = snap.get(key) or {}
                        total += b.get("count") or 0
                        for edge, n in (b.get("bands") or {}).items():
                            e = float("inf") if edge == "inf" else float(edge)
                            if e > self.knobs.RK_BAND_SLO:
                                above += n
                    band_now[rid] = (above, total)
            if proc_snap and proc_snap.get("personality") == "real":
                bf = proc_snap.get("busy_fraction") or 0.0
                if sig["busy_fraction"] is None or bf > sig["busy_fraction"]:
                    sig["busy_fraction"] = bf
        sig["kernel_state"] = worst_kernel
        # band overrun over the interval: diff cumulative per-proxy totals
        d_above = d_total = 0
        for rid, (above, total) in band_now.items():
            pa, pt = self._band_last.get(rid, (0, 0))
            if total >= pt:  # proxy restart resets its bands
                d_above += above - pa
                d_total += total - pt
        self._band_last = band_now
        if d_total > 0:
            sig["band_overrun"] = d_above / d_total
        if sig["storage_count"] == 0:
            # registry answered but no storage metrics yet — seed fallback
            seeded = await self._poll_seed_storage()
            if seeded is not None:
                sig["version_lag"] = seeded["version_lag"]
                sig["durability_lag"] = seeded["durability_lag"]
                sig["storage_count"] = seeded["storage_count"]
        return sig

    async def _registry_snapshots(self):
        """[(worker.metrics snapshot, process.metrics snapshot)] for every
        live registered worker, or None when the CC is unreachable."""
        if not self.cc_address:
            return None
        try:
            reply = await timeout(
                self.process.request(
                    Endpoint(self.cc_address, Tokens.CC_GET_WORKERS),
                    None,
                ),
                1.0,
            )
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception:
            reply = None
        if reply is None or not reply.workers:
            self._c_registry_err.add()
            return None
        self._c_registry.add()

        async def pull(address):
            async def one(token):
                try:
                    return await timeout(
                        self.process.request(Endpoint(address, token), None),
                        1.0,
                    )
                except Cancelled:
                    raise  # actor-cancelled-swallow
                except Exception:
                    return None

            mf = self.process.spawn(one("worker.metrics"))
            pf = self.process.spawn(one("process.metrics"))
            return await mf, await pf

        from ..runtime.futures import wait_for_all

        return await wait_for_all(
            [self.process.spawn(pull(d.address)) for d in reply.workers]
        )

    async def _poll_seed_storage(self):
        """The pre-registry fallback: direct version polls of the storage
        interfaces this Ratekeeper was constructed with."""
        self._c_fallback.add()
        lags, dlags = [], []
        for s in self.storage:
            try:
                r = await timeout(
                    self.process.request(s.ep("version"), None), 0.5
                )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                continue
            if r is not None:
                version, durable, _epoch = r
                lags.append(self.master.last_assigned - version)
                dlags.append(version - durable)
        if not lags:
            return None
        return {
            "version_lag": max(lags),
            "durability_lag": max(dlags),
            "tlog_queue_bytes": None,
            "busy_fraction": None,
            "band_overrun": None,
            "kernel_state": None,
            "storage_count": len(lags),
        }
