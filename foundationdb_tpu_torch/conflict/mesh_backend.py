"""Key-range partitioned ConflictSet over a list of CUDA cards — port of
``foundationdb_tpu/conflict/mesh_backend.py``.

``TorchMeshConflictSet`` puts the partitioned resolver (conflict/sharded.py)
behind the ConflictSet seam: P key-range partitions of the bucket grid are
spread over ``devices`` (by default one stack on one card; the reference's
mesh puts one partition on each device), and verdicts are bit-identical to
the single-grid resolver and to the JAX package's ``MeshConflictSet``
(tests/test_torch_mesh.py).

The host side mirrors the reference: a group of batches is stacked,
uploaded once to each distinct device and dispatched without waiting; the
pre-group snapshot keeps the original tensors while the group works on a
clone, so an overflow can replay from it. Collected per-partition
pressure drives the replay ladder (attempt 0: device rebalance of the overflowing partitions; 1+: host
reshard of those partitions from their live rows and the key sample; 3+:
grow every partition; where those give up, as under a sequential bulk
load, 6+: repivot on the device among the partition's live rows and the
replayed batches' own write endpoints, from the grid size before the
ladder) and flags partitions for a proactive rebalance
between groups (or growth, when the stacked fill fraction crosses
``grow_fill``).

The kernels are not compiled per shape, so the reference's re-warming of
recently dispatched shapes after a grid-shape change has no counterpart.
"""

# flowlint: disable-file=det-wall-clock — KernelMetrics phase timings
# measure HOST wall time of device work (encode/dispatch/collect/reshard)
# on purpose; they are evidence counters, never inputs to sim scheduling
# (same-seed replay is unaffected: no control flow reads them).

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import lanes_to_numpy, lanes_to_torch, ordered, resolve_device
from ..runtime.knobs import Knobs
from . import grid as G
from . import keys as K
from . import kernels
from . import sharded as SH
from .api import ConflictSet
from .torch_backend import (
    _INT32_REBASE_THRESHOLD,
    _VERDICT_TABLE,
    DEFAULT_GROW_FILL,
    DEFAULT_RESHARD_PRESSURE,
    KernelMetrics,
    KeyReservoir,
    _bucket,
    _pick_pivots,
    _pick_pivots_among,
    batch_nbytes,
    carry_work,
    check_batch_sizes,
    encode_transactions,
    stack_batches,
    to_device,
    upload,
)


def _lex_gt(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise lexicographic a > b over uint32 lanes (host numpy; numpy
    has no elementwise compare for the void keys of codes_to_bytes)."""
    a = np.asarray(a)
    b = np.broadcast_to(np.asarray(b), a.shape)
    gt = np.zeros(len(a), bool)
    eq = np.ones(len(a), bool)
    for i in range(a.shape[1]):
        gt |= eq & (a[:, i] > b[:, i])
        eq &= a[:, i] == b[:, i]
    return gt


class TorchMeshConflictSet(ConflictSet):
    def __init__(
        self,
        key_width: int = K.DEFAULT_KEY_WIDTH,
        capacity: int = 1 << 14,
        n_parts: int | None = None,
        reshard_pressure: float = DEFAULT_RESHARD_PRESSURE,
        grow_fill: float = DEFAULT_GROW_FILL,
        device=None,
        devices=None,
        exchange_timeout: float = Knobs.CONFLICT_DISPATCH_DEADLINE,
    ):
        """``devices=None`` keeps all partitions (``n_parts``, default 4) in
        one stack on ``device``. A list of devices (it may name one device
        more than once) spreads them, n_parts / len(devices) an entry in
        list order; ``n_parts`` then defaults to ``len(devices)``, one
        partition a device as in the reference's mesh, and ``device`` is
        not used. A list of lists is the reference's ``("part", "data")``
        mesh: each inner list is a row of ``data`` replicas that hold the
        same partitions and split the read slots (``sharded.Spread``);
        ``n_parts`` then defaults to the number of rows. A card that is not
        visible raises ``DeviceUnavailableError``. ``exchange_timeout``
        (seconds) bounds a card's wait for the other cards' H inside a
        group's launch; the resolver passes its CONFLICT_DISPATCH_DEADLINE."""
        super().__init__()
        if devices is None:
            devices = [device]
            n_parts = 4 if n_parts is None else n_parts
        rows = [[resolve_device(d) for d in row] for row in SH.device_grid(devices)]
        if n_parts is None:
            n_parts = len(rows)
        if n_parts % len(rows):
            raise ValueError(f"{n_parts} partitions do not split over {len(rows)} devices")
        self._rows = rows  # rows of data replicas
        self._devices = [d for row in rows for d in row]
        self._n_data = len(rows[0])
        self._device = self._devices[0]
        self._max_txns = kernels.MAX_TXNS if any(d.type == "cuda" for d in self._devices) else None
        self._width = key_width
        self._lanes = K.lanes_for_width(key_width)
        self._reshard_pressure = reshard_pressure
        self._grow_fill = grow_fill
        self._n_parts = n_parts
        # per-partition grid: capacity splits across partitions
        self._B = _bucket(max(8, capacity // 16 // n_parts))
        self._S = 32
        self._spread = self._fresh_spread()
        # the entries' distinct devices, each of which gets a group's batches
        self._targets = self._spread.devices()
        # the cards of a spread exchange H inside their launches through
        # mapped host memory (kernels.SpreadExchange), one buffer a spread
        self._exchange = (kernels.SpreadExchange()
                          if len(self._targets) > 1 and self._targets[0].type == "cuda" else None)
        self._exchange_timeout = exchange_timeout
        # (epoch, base) in one attribute, so the encode thread reads a pair
        # that belongs together: device versions are (version - base); 0 = never
        self._origin = (0, -1)
        self._rebase_deltas: dict[int, int] = {}  # epoch → the rebase that ended it
        self._inflight: list[dict] = []
        # occupancy-driven maintenance flags, set at collect from the
        # per-partition pressure, executed between groups
        self._rebalance_parts: set[int] = set()
        self._sample = KeyReservoir()
        self.metrics = KernelMetrics()
        self.metrics.gauge("occupancy", lambda: SH.spread_occupancy_stats(self._spread))
        self.metrics.gauge("stagingSlots", lambda: G.staging_slots(self._S))
        self.metrics.gauge("inflightGroups", lambda: len(self._inflight))

    def _fresh_spread(self) -> SH.Spread:
        return SH.make_spread(self._n_parts, self._B, self._S, self._lanes, self._rows)

    @property
    def _states(self) -> G.GridState | None:
        """The stacked state of all partitions (gathered onto the first
        device where the spread has several entries); None once closed."""
        return None if self._spread is None else self._spread.gather()

    def _upload(self, stacked: G.Batch) -> dict:
        """A host group on every distinct device of the spread, and where
        the rows have several replicas, each replica's slice of the read
        slots (contiguous, cut on the host) on each device that holds that
        replica: {"batch": {device: batch}, "reads": [(rb, re) an entry]}."""
        out = {"batch": {dev: upload(stacked, dev) for dev in self._targets}, "reads": None}
        if self._n_data > 1:
            slices = SH.split_reads(lanes_to_torch(stacked.rb), lanes_to_torch(stacked.re), self._n_data)
            moved = {}
            for e in self._spread.entries:
                key = (e.device, e.replica)
                if key not in moved:
                    moved[key] = tuple(to_device(x, e.device) for x in slices[e.replica])
            out["reads"] = [moved[(e.device, e.replica)] for e in self._spread.entries]
            self.metrics.h2d_bytes.add(sum(x.numel() * 4 for r in moved.values() for x in r))
        return out

    def _resolve(self, spread: SH.Spread, uploaded: dict, nows, olds_pre, olds_post):
        """The group through ``spread``: the group scan, one launch a card
        (one stack: ``resolve_many_sharded``; several entries:
        ``resolve_many_spread``, the cards' H exchanged inside the
        launches). Returns (verdicts, pressures, status): ``status`` the
        launches' exchange status, None on one card."""
        if len(spread.entries) == 1:
            e = spread.entries[0]
            _states, verdicts, pressures = SH.resolve_many_sharded(
                e.states, uploaded["batch"][e.device], nows, olds_pre, olds_post, (e.plo, e.phi)
            )
            return verdicts, pressures, None
        return SH.resolve_many_spread(
            spread, [uploaded["batch"][e.device] for e in spread.entries], nows, olds_pre, olds_post,
            uploaded["reads"], exchange=self._exchange, timeout_s=self._exchange_timeout,
        )

    def _sync(self) -> None:
        """Wait for the queued work of every card of the spread."""
        for dev in self._targets:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    @property
    def _base(self) -> int:
        return self._origin[1]

    @property
    def _base_epoch(self) -> int:
        return self._origin[0]

    # -- ConflictSet interface ------------------------------------------------

    def warm_compile(self) -> None:
        """Build the kernels (once, where any entry is a card) and run one
        sentinel group at the smoke shape on a scratch spread, which warms
        every card of it; logical state is untouched."""
        t0 = time.perf_counter()
        if self._max_txns is not None:
            kernels.build.load()
        b = encode_transactions([], self._width, 0)
        spread = self._fresh_spread()
        self._resolve(spread, self._upload(stack_batches([b], self._lanes)), [0], [0], [0])
        self._sync()
        self.metrics.note_shape((1, b.rb.shape[0], b.rb.shape[1], b.wb.shape[1], self._B), warm=True)
        self.metrics.warm_compiles.add()
        self.metrics.warm_s.add(time.perf_counter() - t0)

    def close(self) -> None:
        """Drop every entry's grids and partition bounds and the in-flight
        groups' tensors (see ``TorchConflictSet.close``)."""
        if self._spread is None:
            return
        occupancy = SH.spread_occupancy_stats(self._spread)
        self.metrics.gauge("occupancy", lambda: occupancy)
        for group in self._inflight:
            group.clear()
        self._inflight = []
        self._spread = None
        if self._exchange is not None:
            self._exchange.close()  # waits for the spread's launches first

    def clear(self, version: int) -> None:
        self._flush()
        self._spread = self._fresh_spread()
        self._origin = (self._base_epoch + 1, version - 1)
        self._rebase_deltas.clear()
        self.oldest_version = version

    def detect_batch(self, transactions, now, new_oldest_version):
        return self.detect_many([(transactions, now, new_oldest_version)])[0]

    def detect_many(self, work):
        if not work:
            return []
        check_batch_sizes((len(txs) for txs, _, _2 in work), self._max_txns)
        self._maybe_rebase(max(now for _, now, _2 in work))
        return self.detect_many_encoded(
            [(self.encode(txs), now, old) for txs, now, old in work]
        )

    def prepare(self, now: int) -> None:
        self._maybe_rebase(now)

    def encode(self, transactions):
        """Host encode (epoch and base read first, so a concurrent rebase is
        carried at dispatch and a concurrent clear surfaces as a
        StaleEncodingError, as in ``TorchConflictSet.encode``)."""
        check_batch_sizes([len(transactions)], self._max_txns)
        t0 = time.perf_counter()
        epoch, base = self._origin
        b = encode_transactions(
            transactions, self._width, base, sample_cb=self._sample.add
        )
        self.metrics.encode_s.add(time.perf_counter() - t0)
        return b, len(transactions), epoch

    def detect_many_encoded(self, work):
        return self.detect_many_encoded_async(work)()

    def detect_many_encoded_async(self, work):
        """Dispatch a group without waiting; returns a zero-arg callable
        yielding the verdict lists."""
        if not work:
            return lambda: []
        work = carry_work(work, self._base_epoch, self._rebase_deltas)
        counts, metas, batches = [], [], []
        for (b, n_real, _epoch), now, new_oldest in work:
            horizon = max(self.oldest_version, new_oldest)
            metas.append((now, self.oldest_version, horizon))
            self.oldest_version = horizon
            counts.append(n_real)
            batches.append(b)
        self.metrics.groups.add()
        self.metrics.batches.add(len(batches))
        self.metrics.txns.add(sum(counts))

        if self._rebalance_parts:
            # occupancy-driven maintenance between groups: drain, then grow
            # or rebalance the flagged partitions — a deliberate bubble
            self._flush()
            self.metrics.reshards_proactive.add()
            occ = SH.spread_occupancy_stats(self._spread)
            if occ["fillFraction"] >= self._grow_fill:
                self._grow()
            else:
                for p in sorted(self._rebalance_parts):
                    if self._reshard_device(p) > self._S:
                        self._host_reshard_partition(p)
            self._rebalance_parts.clear()

        stacked = stack_batches(batches, self._lanes)
        self.metrics.h2d_bytes.add(batch_nbytes(stacked) * len(self._targets))
        group = {
            "stacked": self._upload(stacked),
            "metas": metas,
            "counts": counts,
            "done": None,
        }
        self._dispatch(group)
        self._inflight.append(group)

        def result(group=group):
            return self._collect(group)

        return result

    # -- internals ------------------------------------------------------------

    def _dispatch(self, group) -> None:
        t0 = time.perf_counter()
        self.metrics.dispatches.add()
        metas = group["metas"]
        st = group["stacked"]["batch"][self._targets[0]]
        shape = (len(metas), st.rb.shape[-3], st.rb.shape[-2], st.wb.shape[-2])
        self.metrics.note_shape(shape + (self._B,))
        nows = [m[0] - self._base for m in metas]
        olds_pre = [max(m[1] - self._base, 0) for m in metas]
        olds_post = [max(m[2] - self._base, 0) for m in metas]
        # the snapshot keeps the ORIGINAL tensors (never written) for a
        # replay; the group updates a clone in place
        group["snapshot"] = self._spread
        spread = self._spread.clone()
        verdicts, pressures, status = self._resolve(spread, group["stacked"], nows, olds_pre, olds_post)
        self._spread = spread
        if verdicts.is_cuda:
            # verdicts, pressures and the exchange status are on the first
            # card, behind every card's launch (the pressures' and the
            # status's copies order them): one event there covers the group
            outs = [verdicts, pressures] + ([] if status is None else [status])
            hosts = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in outs]
            for h, x in zip(hosts, outs):
                h.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(verdicts.device))
            group["verdicts"], group["pressures"], group["event"] = hosts[0], hosts[1], done
            group["status"] = hosts[2] if status is not None else None
        else:
            group["verdicts"], group["pressures"], group["event"], group["status"] = verdicts, pressures, None, status
        self.metrics.dispatch_s.add(time.perf_counter() - t0)

    def _collect(self, group):
        if group["done"] is not None:
            return group["done"]
        while self._inflight and self._inflight[0] is not group:
            self._collect(self._inflight[0])
        assert self._inflight and self._inflight[0] is group
        t0 = time.perf_counter()
        S2 = G.staging_slots(self._S)
        overflowed = np.zeros(self._n_parts, dtype=bool)
        first_snapshot, first_B = group["snapshot"], self._B  # a replay re-snapshots
        for attempt in range(9):
            if group["event"] is not None:
                group["event"].synchronize()
            if group["status"] is not None:  # a card missing from the exchange: a kernel fault
                kernels.check_spread_status(group["status"])
            prs = group["pressures"].numpy()  # int32[G, P, 2]
            out = group["verdicts"].numpy()
            self.metrics.d2h_bytes.add(int(prs.nbytes) + int(out.nbytes))
            worst = prs.max(axis=0)  # [P, 2] over the group
            over = (worst[:, 0] > S2) | (worst[:, 1] > self._S)
            if not over.any():
                break
            overflowed |= over
            self.metrics.overflow_replays.add()
            self.metrics.replayed_groups.add(len(self._inflight))
            # the in-flight chain is abandoned: let every queued kernel
            # finish before the snapshot's buffers are read or reused
            self._sync()
            # rebalance the overflowing partitions from the pre-group
            # snapshot, then replay this group and everything after it.
            # Attempts 0-5 are the reference's: 0: device rebalance; 1+: host
            # reshard with the key sample; 3+: grow every partition first.
            # Where they do not converge (a bulk load once the sample holds
            # older keys), 6+: pivots among each overflowing partition's
            # live boundaries and the replayed groups' own write endpoints
            # (every partition that overflowed in this ladder), on the
            # device, at the grid size from before the ladder, doubled on
            # each attempt from 7 on
            self._spread = group["snapshot"]
            if attempt >= 6:
                self._spread, self._B = first_snapshot, first_B
                for _ in range(attempt - 6):
                    self._grow()
                for p in np.nonzero(overflowed)[0]:
                    self._merge_partition(int(p))
            else:
                if attempt >= 3:
                    self._grow()
                for p in np.nonzero(over)[0]:
                    if attempt == 0 and self._reshard_device(int(p)) <= self._S:
                        continue
                    self._host_reshard_partition(int(p))
            for g in self._inflight:
                self._dispatch(g)
        else:
            raise RuntimeError("mesh conflict grid reshard did not converge")

        # proactive-rebalance signal for the next group boundary
        self._rebalance_parts.update(
            int(p)
            for p in np.nonzero(
                (worst[:, 0] > int(S2 * self._reshard_pressure))
                | (worst[:, 1] > int(self._S * self._reshard_pressure))
            )[0]
        )
        table = _VERDICT_TABLE
        group["done"] = [
            [table[v] for v in out[g, : group["counts"][g]].tolist()]
            for g in range(len(group["counts"]))
        ]
        self.metrics.collect_s.add(time.perf_counter() - t0)
        for key in ("snapshot", "verdicts", "pressures", "event", "status", "stacked", "metas"):
            group.pop(key, None)
        self._inflight.pop(0)
        return group["done"]

    def _reshard_device(self, p: int) -> int:
        """Rebalance partition p on its device; returns the pressure (over
        S: the partition needs more than a rebalance)."""
        self._spread, pressure = SH.reshard_spread_partition(self._spread, p, self._B, self._S)
        self.metrics.reshards_device.add()
        return pressure

    def _host_reshard_partition(self, p: int) -> None:
        """Rebuild partition p's grid under pivots from its live boundaries
        ∪ the key sample clipped to its range; grows every partition when
        a balanced split cannot fit."""
        t0 = time.perf_counter()
        self.metrics.reshards_host.add()
        while True:
            shard = self._spread.partition(p)
            codes, _vers = G.live_rows(shard)
            lo = lanes_to_numpy(shard.pivots[0])  # the partition's lower bound
            cands = codes
            if self._sample:
                cands = np.concatenate([cands, K.encode_keys(self._sample.snapshot(), self._width)])
            keys = G.codes_to_bytes(np.ascontiguousarray(cands))
            _, uniq = np.unique(keys, return_index=True)
            cands = cands[uniq]
            # only candidates strictly above the lower bound and, but for
            # the last partition, below the next partition's first pivot
            keep = _lex_gt(cands, lo)
            if p + 1 < self._n_parts:
                hi = lanes_to_numpy(self._spread.partition(p + 1).pivots[0])
                keep &= _lex_gt(np.broadcast_to(hi, cands.shape), cands)
            cands = cands[keep]
            pivots = _pick_pivots(cands, self._B, self._lanes, lo=lo)
            try:
                new_shard = G.reshard(shard, pivots, self._B, self._S)
            except OverflowError:
                self._grow()
                continue
            self._spread = self._spread.set_partition(p, new_shard)
            self.metrics.reshard_s.add(time.perf_counter() - t0)
            return

    def _merge_partition(self, p: int) -> None:
        """Rebuild partition p's grid on the device under pivots among its
        live boundaries and the write endpoints of every in-flight group
        that fall in its range; grows every partition while a bucket
        overflows."""
        t0 = time.perf_counter()
        self.metrics.reshards_device.add()
        dev = self._spread.entries[self._spread.entry_of(p)[0]].device
        extra = torch.cat(
            [torch.cat([g["stacked"]["batch"][dev].wb, g["stacked"]["batch"][dev].we]).reshape(-1, self._lanes)
             for g in self._inflight]
        )
        if p + 1 < self._n_parts:
            hi = self._spread.partition(p + 1).pivots[0].to(dev)
            extra = extra[G.lex_lt(ordered(extra), ordered(hi))]
        while True:
            shard = self._spread.partition(p)
            codes, _vers = G.live_codes(shard)
            pivots = _pick_pivots_among(codes, extra, self._B)
            try:
                new_shard = G.reshard(shard, pivots, self._B, self._S)
            except OverflowError:
                self._grow()
                continue
            self._spread = self._spread.set_partition(p, new_shard)
            self.metrics.reshard_s.add(time.perf_counter() - t0)
            return

    def _grow(self) -> None:
        """Double every partition's bucket count: an on-device reshard of
        each entry's partitions folds their floors and rebalances them."""
        self._B *= 2
        self.metrics.capacity_growths.add()
        self._spread = SH.reshard_spread(self._spread, self._B, self._S)

    def _flush(self) -> None:
        while self._inflight:
            self._collect(self._inflight[0])

    def _maybe_rebase(self, now: int) -> None:
        if now - self._base < _INT32_REBASE_THRESHOLD:
            return
        self._flush()
        new_base = self.oldest_version - 1
        delta = new_base - self._base
        if delta > 0:
            self._spread = SH.rebase_spread(self._spread, int(delta))
            self._rebase_deltas[self._base_epoch] = int(delta)
            self._origin = (self._base_epoch + 1, new_base)
            self.metrics.rebases.add()
