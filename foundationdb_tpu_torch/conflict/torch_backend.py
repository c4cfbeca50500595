"""Host glue for the bucket-grid conflict index on the CUDA card — port of
``foundationdb_tpu/conflict/tpu_backend.py``.

``TorchConflictSet`` implements the ConflictSet interface (conflict/api.py):

- encodes byte-string conflict ranges to fixed-width lane codes
  (conflict/keys.py), padded *per transaction* (KR read / KW write range
  slots) so the intra-batch check is a dense [T, T] relation;
- tracks the int64→int32 version rebasing origin;
- owns the **reshard loop**: each group returns bucket pressure; on
  overflow the host rebuilds the grid under fresh pivots from the
  pre-group snapshot (a device rebalance, then pivots among the live
  boundaries and the replayed batches' own write endpoints, growing only
  when those cannot stage the replay) and replays the group — verdicts
  are deterministic, so callers never see it. Proactive reshards run between groups when
  pressure nears the slot capacity, growing the bucket count when the
  index fills.

The state lives on ``device`` (the CUDA card by default); with
``device="cpu"`` the same class runs the plain PyTorch versions of every
kernel — the deterministic twin the CPU tests use.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import SENTINEL, lanes_to_torch, ordered, resolve_device
from ..runtime.stats import CounterCollection
from . import grid as G
from . import keys as K
from . import kernels
from .api import CommitTransaction, ConflictSet, Verdict
from .errors import BatchTooLargeError, StaleEncodingError

_INT32_REBASE_THRESHOLD = 1 << 30
_SAMPLE_CAP = 131072
_VERDICT_TABLE = [Verdict(i) for i in range(3)]

# occupancy-driven reshard defaults: rebalance when collected pressure
# crosses this fraction of the slot ceiling; grow the bucket count when
# the live-row fill fraction does
DEFAULT_RESHARD_PRESSURE = 0.75
DEFAULT_GROW_FILL = 0.5


class KernelMetrics:
    """The conflict kernel's CounterCollection — per-phase wall-time
    latency samples, overflow-replay / reshard / growth counters,
    host↔device transfer bytes, and a shape-cache hit/miss tally. The
    counter names are those of the JAX backend, which status and the CLI
    read by name (``jitCache*`` counts first sightings of a stacked shape
    here; PyTorch compiles nothing per shape)."""

    def __init__(self, ident: str = ""):
        self.collection = CounterCollection("ConflictKernel", ident)
        c = self.collection.counter
        self.groups = c("groups")
        self.batches = c("batches")
        self.txns = c("txns")
        self.dispatches = c("deviceDispatches")
        self.overflow_replays = c("overflowReplays")
        self.replayed_groups = c("replayedGroups")
        self.reshards_device = c("reshardsDevice")
        self.reshards_host = c("reshardsHost")
        self.reshards_proactive = c("reshardsProactive")
        self.capacity_growths = c("capacityGrowths")
        self.rebases = c("rebases")
        self.h2d_bytes = c("hostToDeviceBytes")
        self.d2h_bytes = c("deviceToHostBytes")
        self.jit_hits = c("jitCacheHits")
        self.jit_misses = c("jitCacheMisses")
        self.warm_compiles = c("warmCompiles")
        self.encode_s = self.collection.latency("encodeSeconds")
        self.encode_overlap_s = self.collection.latency("encodeOverlapSeconds")
        self.dispatch_s = self.collection.latency("dispatchSeconds")
        self.collect_s = self.collection.latency("collectSeconds")
        self.reshard_s = self.collection.latency("reshardSeconds")
        self.warm_s = self.collection.latency("warmCompileSeconds")
        self._shapes: set = set()

    def note_shape(self, key, warm: bool = False) -> None:
        """A (G, T, KR, KW, B) stacked shape seen before is a hit, a fresh
        one a miss; ``warm=True`` seeds the set without counting either."""
        if key in self._shapes:
            if not warm:
                self.jit_hits.add()
        else:
            self._shapes.add(key)
            if not warm:
                self.jit_misses.add()

    def gauge(self, name: str, fn) -> None:
        self.collection.gauge(name, fn)

    def snapshot(self) -> dict:
        return self.collection.snapshot()


def batch_nbytes(batch: G.Batch) -> int:
    """Total bytes of a host-encoded batch (transfer accounting)."""
    return sum(int(a.nbytes) for a in batch)


def check_batch_sizes(sizes, limit) -> None:
    """Raise BatchTooLargeError for a batch of more than ``limit``
    transactions (None: any size). The backends call it before they touch
    their state, so a refused batch leaves no trace."""
    if limit is None:
        return
    for n in sizes:
        if n > limit:
            raise BatchTooLargeError(
                f"a batch of {n} transactions exceeds the card's limit of {limit} "
                f"(kernels.MAX_TXNS: K2's commit bitset)"
            )


def carry_payload(payload, epoch: int, rebase_deltas: dict):
    """An encoded payload ``(Batch, n_real, epoch)`` carried to the
    backend's current ``epoch``, or None when it cannot be. Encodings differ
    between version bases only in ``t_snap = max(snapshot - base, 0)``, so
    across rebases alone (``rebase_deltas``: epoch → the delta that ended
    it, always > 0) ``max(t_snap - shift, 0)`` is exactly the re-encoding. A
    ``clear`` ends its epoch with no entry: what was encoded before it stays
    stale. The JAX backend re-encodes instead (StaleEncodingError and a
    retry); a deep pipeline then re-encodes every payload in flight at a
    rebase."""
    b, n_real, e = payload
    shift = 0
    while e != epoch:
        d = rebase_deltas.get(e)
        if d is None:
            return None
        shift += d
        e += 1
    if shift:
        t_snap = np.maximum(b.t_snap.astype(np.int64) - shift, 0).astype(np.int32)
        b = b._replace(t_snap=t_snap)
    return b, n_real, epoch


def carry_work(work, epoch: int, rebase_deltas: dict) -> list:
    """``carry_payload`` over a group's work; raises StaleEncodingError if
    any payload cannot be carried, before anything changes."""
    out = []
    for payload, now, old in work:
        carried = carry_payload(payload, epoch, rebase_deltas)
        if carried is None:
            raise StaleEncodingError(
                "stale encoding: the version base was reset after encode()"
            )
        out.append((carried, now, old))
    return out


def _bucket(n: int, floor: int = 1) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


class KeyReservoir:
    """Bounded reservoir of raw endpoint keys feeding sample-seeded pivot
    selection."""

    __slots__ = ("keys", "_skip")

    def __init__(self):
        self.keys: list[bytes] = []
        self._skip = 0

    def add(self, key: bytes) -> None:
        self._skip += 1
        if len(self.keys) < _SAMPLE_CAP:
            self.keys.append(key)
        elif self._skip % 17 == 0:
            self.keys[self._skip % _SAMPLE_CAP] = key

    def __bool__(self) -> bool:
        return bool(self.keys)

    def snapshot(self) -> list[bytes]:
        """A copy of the keys. The resolver's encode thread adds keys while
        the device thread reshards from them; ``list()`` copies in one step
        under the GIL, where iterating the live list can see it grow."""
        return list(self.keys)


def encode_transactions(
    transactions, width: int, base: int, sample_cb=None
) -> G.Batch:
    """Encode a commit batch into the kernel's padded Batch of HOST numpy
    arrays (uint32 lanes); ``upload`` moves it to the device."""
    n = max(len(transactions), 1)
    # pad T to a coarse grid: powers of two up to 512, then multiples of
    # 512 — a 2500-txn batch costs 2560 rows of work, not 4096
    T = _bucket(n, 8) if n <= 512 else ((n + 511) // 512) * 512
    KR = _bucket(
        max((len(t.read_conflict_ranges) for t in transactions), default=0)
        or 1
    )
    KW = _bucket(
        max((len(t.write_conflict_ranges) for t in transactions), default=0)
        or 1
    )
    sent = K.max_sentinel(width)
    rb = np.tile(sent, (T, KR, 1))
    re = np.tile(sent, (T, KR, 1))
    wb = np.tile(sent, (T, KW, 1))
    we = np.tile(sent, (T, KW, 1))
    t_snap = np.zeros(T, np.int32)
    t_has_reads = np.zeros(T, bool)

    r_begins, r_ends, w_begins, w_ends = [], [], [], []
    r_pos, w_pos = [], []
    for t, tr in enumerate(transactions):
        t_snap[t] = max(tr.read_snapshot - base, 0)
        t_has_reads[t] = bool(tr.read_conflict_ranges)
        for i, (b, e) in enumerate(tr.read_conflict_ranges):
            r_begins.append(b)
            r_ends.append(e)
            r_pos.append((t, i))
        for i, (b, e) in enumerate(tr.write_conflict_ranges):
            w_begins.append(b)
            w_ends.append(e)
            w_pos.append((t, i))
            if sample_cb is not None:
                sample_cb(b)
                sample_cb(e)

    if r_begins:
        cb = K.encode_keys(r_begins, width, round_up=False)
        ce = K.encode_keys(r_ends, width, round_up=True)
        for (t, i), eb, ee in zip(r_pos, cb, ce):
            rb[t, i] = eb
            re[t, i] = ee
    if w_begins:
        cb = K.encode_keys(w_begins, width, round_up=False)
        ce = K.encode_keys(w_ends, width, round_up=True)
        for (t, i), eb, ee in zip(w_pos, cb, ce):
            wb[t, i] = eb
            we[t, i] = ee

    return G.Batch(
        rb=rb, re=re, wb=wb, we=we, t_snap=t_snap, t_has_reads=t_has_reads
    )


def stack_batches(batches: list[G.Batch], lanes: int) -> G.Batch:
    """Stack host-encoded batches into one [G, ...] group (host numpy),
    padding every field to the group's max (T, KR, KW) with sentinel rows."""
    T = max(b.rb.shape[0] for b in batches)
    KR = max(b.rb.shape[1] for b in batches)
    KW = max(b.wb.shape[1] for b in batches)
    sent_row = np.full(lanes, 0xFFFFFFFF, dtype=np.uint32)

    def pad3(a, k):
        t, kk, _L = a.shape
        if t == T and kk == k:
            return a
        out = np.tile(sent_row, (T, k, 1))
        out[:t, :kk] = a
        return out

    def pad1(a, dtype):
        if a.shape[0] == T:
            return a
        out = np.zeros(T, dtype)
        out[: a.shape[0]] = a
        return out

    return G.Batch(
        rb=np.stack([pad3(b.rb, KR) for b in batches]),
        re=np.stack([pad3(b.re, KR) for b in batches]),
        wb=np.stack([pad3(b.wb, KW) for b in batches]),
        we=np.stack([pad3(b.we, KW) for b in batches]),
        t_snap=np.stack([pad1(b.t_snap, np.int32) for b in batches]),
        t_has_reads=np.stack([pad1(b.t_has_reads, bool) for b in batches]),
    )


def sentinel_batch(T: int, KR: int, KW: int, lanes: int) -> G.Batch:
    """An all-sentinel (fully inactive) host batch at an exact padded shape."""
    sent_row = np.full(lanes, 0xFFFFFFFF, dtype=np.uint32)
    return G.Batch(
        rb=np.tile(sent_row, (T, KR, 1)),
        re=np.tile(sent_row, (T, KR, 1)),
        wb=np.tile(sent_row, (T, KW, 1)),
        we=np.tile(sent_row, (T, KW, 1)),
        t_snap=np.zeros(T, np.int32),
        t_has_reads=np.zeros(T, bool),
    )


def upload(batch: G.Batch, device: torch.device) -> G.Batch:
    """Host numpy Batch → tensors on ``device``. To a CUDA card the copies
    go through pinned memory and do not block the host."""
    out = []
    for a in batch:
        t = lanes_to_torch(a) if a.dtype != bool else torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return G.Batch(*out)


def _quantiles(n_cands: int, n_buckets: int) -> np.ndarray:
    """The indices of ≤ n_buckets-1 quantile pivots among n_cands sorted
    candidates."""
    n_piv = min(n_buckets - 1, n_cands)
    if n_piv <= 0:
        return np.zeros(0, dtype=np.int64)
    step = n_cands / (n_piv + 1)
    idx = np.minimum((np.arange(1, n_piv + 1) * step).astype(np.int64), n_cands - 1)
    return np.unique(idx)


def _pick_pivots(
    cands: np.ndarray, n_buckets: int, lanes: int, lo: np.ndarray = None
) -> np.ndarray:
    """≤ n_buckets-1 quantile pivots from sorted unique candidate codes
    (uint32[N, lanes], all strictly above ``lo``); bucket 0 always starts
    at ``lo`` (the empty key for a full-range grid)."""
    if lo is None:
        lo = np.zeros((1, lanes), dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32).reshape(1, lanes)
    return np.concatenate([lo, cands[_quantiles(len(cands), n_buckets)]], axis=0)


def _pick_pivots_among(codes: torch.Tensor, extra: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """``_pick_pivots`` on the device: quantile pivots among the live
    boundaries ``codes`` (int32[N, L] in key order, row 0 the lower bound)
    and the ``extra`` codes; all-sentinel rows of ``extra`` are ignored."""
    extra = extra[~(extra == SENTINEL).all(dim=1)]
    lo = codes[:1]
    cands = G.sorted_unique(torch.cat([codes, extra]))
    cands = cands[G.lex_lt(ordered(lo), ordered(cands))]
    idx = torch.from_numpy(_quantiles(cands.shape[0], n_buckets)).to(cands.device)
    return torch.cat([lo, cands[idx]])


class TorchConflictSet(ConflictSet):
    def __init__(
        self,
        key_width: int = K.DEFAULT_KEY_WIDTH,
        capacity: int = 1 << 14,
        reshard_pressure: float = DEFAULT_RESHARD_PRESSURE,
        grow_fill: float = DEFAULT_GROW_FILL,
        device=None,
    ):
        super().__init__()
        self._device = resolve_device(device)
        # the most transactions a batch may hold: the kernels' limit on the
        # card, none on the CPU
        self._max_txns = kernels.MAX_TXNS if self._device.type == "cuda" else None
        self._width = key_width
        self._lanes = K.lanes_for_width(key_width)
        self._reshard_pressure = reshard_pressure
        self._grow_fill = grow_fill
        # grid shape: B buckets × S slots with ~2× slack over `capacity`
        # boundaries; shallow buckets (S = 32) over many pivots
        self._B = _bucket(max(8, capacity // 16))
        self._S = 32
        self._state = G.make_state(self._B, self._S, self._lanes, self._device)
        # (epoch, base) in one attribute, so the encode thread reads a pair
        # that belongs together: device versions are (version - base); 0 = never
        self._origin = (0, -1)
        self._rebase_deltas: dict[int, int] = {}  # epoch → the rebase that ended it
        self._sample = KeyReservoir()
        self._resharded_once = False
        self._rebalance_wanted = False
        # dispatched-but-uncollected groups, in dispatch order
        self._inflight: list[dict] = []
        self.metrics = KernelMetrics()
        self._last_pressure = (0, 0)  # (max staged, max kept) at last collect
        self.metrics.gauge("occupancy", lambda: G.occupancy_stats(self._state))
        self.metrics.gauge("stagingSlots", lambda: G.staging_slots(self._S))
        self.metrics.gauge("lastMaxStagedRows", lambda: self._last_pressure[0])
        self.metrics.gauge("lastMaxKeptRows", lambda: self._last_pressure[1])
        self.metrics.gauge("inflightGroups", lambda: len(self._inflight))

    @property
    def _base(self) -> int:
        return self._origin[1]

    @property
    def _base_epoch(self) -> int:
        return self._origin[0]

    # -- ConflictSet interface ------------------------------------------------

    def warm_compile(self) -> None:
        """Build the kernels (on the card) and run one sentinel batch at the
        smoke shape (1 group, T=8, KR=KW=1) on a SCRATCH grid, so the first
        real commit batch pays neither (the kernels are not built per
        shape). Logical state and the version base are untouched."""
        t0 = time.perf_counter()
        if self._device.type == "cuda":
            kernels.build.load()
        T, KR, KW = 8, 1, 1  # encode_transactions' shape for an empty batch
        scratch = G.make_state(self._B, self._S, self._lanes, self._device)
        stacked = upload(
            stack_batches([sentinel_batch(T, KR, KW, self._lanes)], self._lanes),
            self._device,
        )
        _state, verdicts, _p = G.resolve_many(scratch, stacked, [0], [0], [0])
        verdicts.cpu()  # wait for the device
        self.metrics.note_shape((1, T, KR, KW, self._B), warm=True)
        self.metrics.warm_compiles.add()
        self.metrics.warm_s.add(time.perf_counter() - t0)

    def _flush(self) -> None:
        while self._inflight:
            self._collect(self._inflight[0])

    def close(self) -> None:
        """Drop the grid and the in-flight groups' tensors, so the card's
        memory is freed now, whatever still holds this object (the
        resolver's role is destroyed). The metrics stay readable, the last
        occupancy with them; the set resolves nothing afterwards. A second
        call frees only what a call in flight stored since the first."""
        if self._state is None:
            return
        occupancy = G.occupancy_stats(self._state)
        self.metrics.gauge("occupancy", lambda: occupancy)
        for group in self._inflight:
            group.clear()
        self._inflight = []
        self._state = None

    def clear(self, version: int) -> None:
        self._flush()
        self._state = G.make_state(self._B, self._S, self._lanes, self._device)
        self._origin = (self._base_epoch + 1, version - 1)
        self._rebase_deltas.clear()
        self._resharded_once = False
        self.oldest_version = version

    def detect_batch(
        self, transactions: list[CommitTransaction], now: int, new_oldest_version: int
    ) -> list[Verdict]:
        return self.detect_many([(transactions, now, new_oldest_version)])[0]

    def detect_many(
        self, work: list[tuple[list[CommitTransaction], int, int]]
    ) -> list[list[Verdict]]:
        """Resolve many (transactions, now, new_oldest) batches in one
        group dispatch."""
        if not work:
            return []
        check_batch_sizes((len(txs) for txs, _, _2 in work), self._max_txns)
        self._maybe_rebase(max(now for _, now, _2 in work))
        return self.detect_many_encoded(
            [(self.encode(txs), now, old) for txs, now, old in work]
        )

    def prepare(self, now: int) -> None:
        """Call before encode() when driving the encoded/async path
        directly: rebases the int32 version origin when ``now`` drifts far
        from the base (flushes in-flight work first)."""
        self._maybe_rebase(now)

    def encode(self, transactions: list[CommitTransaction]):
        """Pre-encode a batch for detect_many_encoded. Encodings are
        base-relative (epoch stamp): one made before a rebase is carried
        across it at dispatch (``carry_payload``), one made before a
        ``clear`` is stale (StaleEncodingError). Epoch and base are read
        FIRST and as one pair, so a concurrent rebase or clear is always
        visible and a payload never carries one epoch with another's base."""
        check_batch_sizes([len(transactions)], self._max_txns)
        t0 = time.perf_counter()
        epoch, base = self._origin
        b = encode_transactions(
            transactions, self._width, base, sample_cb=self._sample.add
        )
        self.metrics.encode_s.add(time.perf_counter() - t0)
        return b, len(transactions), epoch

    def detect_many_encoded(self, work) -> list[list[Verdict]]:
        """work: list of ((Batch, n_real, epoch), now, new_oldest)."""
        return self.detect_many_encoded_async(work)()

    def detect_many_encoded_async(self, work):
        """Dispatch a group without waiting; returns a zero-arg callable
        yielding the verdict lists. Further groups may be dispatched before
        collecting: the inter-group state dependency lives on the device
        and the stream orders it."""
        if not work:
            return lambda: []
        # validate every encoding BEFORE mutating the horizon
        work = carry_work(work, self._base_epoch, self._rebase_deltas)
        counts = []
        metas = []  # (now, oldest_pre, oldest_post) absolute versions
        batches = []
        for (b, n_real, _epoch), now, new_oldest in work:
            horizon = max(self.oldest_version, new_oldest)
            metas.append((now, self.oldest_version, horizon))
            self.oldest_version = horizon
            counts.append(n_real)
            batches.append(b)

        self.metrics.groups.add()
        self.metrics.batches.add(len(batches))
        self.metrics.txns.add(sum(counts))

        if not self._resharded_once:
            self._reshard(self._state)
        elif self._rebalance_wanted:
            # occupancy-driven maintenance: drain the pipeline and
            # rebalance/grow BETWEEN groups — a one-group bubble instead of
            # an overflow replay of every in-flight group later
            self._flush()
            self.metrics.reshards_proactive.add()
            self._reshard(self._state, grow=self._wants_growth())
            self._rebalance_wanted = False

        group = {
            "stacked": self._stack(batches),
            "metas": metas,
            "counts": counts,
            "done": None,
        }
        self._dispatch(group)
        self._inflight.append(group)

        def result(group=group):
            return self._collect(group)

        return result

    def _dispatch(self, group) -> None:
        t0 = time.perf_counter()
        metas = group["metas"]
        st = group["stacked"]
        self.metrics.dispatches.add()
        shape = (len(metas), st.rb.shape[-3], st.rb.shape[-2], st.wb.shape[-2])
        self.metrics.note_shape(shape + (self._B,))
        nows = [m[0] - self._base for m in metas]
        olds_pre = [max(m[1] - self._base, 0) for m in metas]
        olds_post = [max(m[2] - self._base, 0) for m in metas]
        # the group updates its state in place, so the pre-group snapshot
        # keeps the ORIGINAL tensors (never written: a replay can always
        # start from them) and the group works on a clone
        group["snapshot"] = self._state
        state, verdicts, pressure = G.resolve_many(
            G.clone_state(self._state), st, nows, olds_pre, olds_post
        )
        self._state = state
        if self._device.type == "cuda":
            # start the device→host copies NOW into pinned buffers; the
            # event recorded behind them is what _collect waits on
            v_host = torch.empty(verdicts.shape, dtype=verdicts.dtype, pin_memory=True)
            p_host = torch.empty(pressure.shape, dtype=pressure.dtype, pin_memory=True)
            v_host.copy_(verdicts, non_blocking=True)
            p_host.copy_(pressure, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            group["verdicts"], group["pressure"], group["event"] = v_host, p_host, done
        else:
            group["verdicts"], group["pressure"], group["event"] = verdicts, pressure, None
        self.metrics.dispatch_s.add(time.perf_counter() - t0)

    def _collect(self, group) -> list[list[Verdict]]:
        if group["done"] is not None:
            return group["done"]
        # collect in dispatch order (a replay there invalidates everything
        # after)
        while self._inflight and self._inflight[0] is not group:
            self._collect(self._inflight[0])
        assert self._inflight and self._inflight[0] is group
        t0 = time.perf_counter()
        S2 = G.staging_slots(self._S)
        for attempt in range(7):
            if group["event"] is not None:
                group["event"].synchronize()
            pr = group["pressure"].numpy()
            out = group["verdicts"].numpy()
            self.metrics.d2h_bytes.add(int(pr.nbytes) + int(out.nbytes))
            if int(pr[0]) <= S2 and int(pr[1]) <= self._S:
                break
            self.metrics.overflow_replays.add()
            self.metrics.replayed_groups.add(len(self._inflight))
            # the in-flight chain is ABANDONED for a replay: let every
            # queued kernel finish before the snapshot's and the abandoned
            # groups' buffers are read or reused
            if self._device.type == "cuda":
                torch.cuda.current_stream(self._device).synchronize()
            # rebuild the grid under fresh pivots from the pre-group
            # snapshot, then replay this group and everything after it.
            # Attempt 0: device rebalance (it can only split between live
            # boundaries, and the first reshard takes the host path whose
            # pivots also come from the recent key sample); 1+: pivots among
            # the live boundaries and the replayed groups' own write
            # endpoints, on the device, with the grid doubled on each
            # attempt from 2 on: the best pivots could not stage the replay
            if attempt == 0:
                self._reshard(group["snapshot"])
            else:
                self._reshard_merge(group["snapshot"], grow=attempt >= 2)
            for g in self._inflight:
                self._dispatch(g)
        else:
            raise RuntimeError("conflict grid reshard did not converge")
        self._last_pressure = (int(pr[0]), int(pr[1]))
        self.metrics.collect_s.add(time.perf_counter() - t0)
        if int(pr[1]) > int(self._S * self._reshard_pressure) or int(
            pr[0]
        ) > int(S2 * self._reshard_pressure):
            # occupancy crossed the reshard threshold: rebalance now with
            # nothing else in flight, else at the next dispatch
            if len(self._inflight) == 1:
                self.metrics.reshards_proactive.add()
                self._reshard(self._state, grow=self._wants_growth())
                self._rebalance_wanted = False
            else:
                self._rebalance_wanted = True
        table = _VERDICT_TABLE
        group["done"] = [
            [table[v] for v in out[g, : group["counts"][g]].tolist()]
            for g in range(len(group["counts"]))
        ]
        # collected groups are never re-dispatched: drop what pins memory
        for key in ("snapshot", "verdicts", "pressure", "event", "stacked", "metas"):
            group.pop(key, None)
        self._inflight.pop(0)
        return group["done"]

    # -- internals ------------------------------------------------------------

    def _wants_growth(self) -> bool:
        occ = G.occupancy_stats(self._state)
        return occ["fillFraction"] >= self._grow_fill

    def _stack(self, batches: list[G.Batch]) -> G.Batch:
        stacked = stack_batches(batches, self._lanes)
        self.metrics.h2d_bytes.add(batch_nbytes(stacked))
        return upload(stacked, self._device)

    def _reshard(self, from_state: G.GridState, grow: bool = False) -> None:
        """Rebuild the grid under fresh pivots: on the device
        (grid.reshard_device, balancing on the LIVE boundaries) unless this
        is the first reshard, which takes the host path whose pivots also
        come from the recent key sample."""
        t0 = time.perf_counter()
        if self._resharded_once:
            if grow:
                self._B *= 2
                self.metrics.capacity_growths.add()
            while True:
                state, pressure = G.reshard_device(from_state, self._B, self._S)
                if int(pressure) <= self._S:
                    self._state = state
                    self.metrics.reshards_device.add()
                    self.metrics.reshard_s.add(time.perf_counter() - t0)
                    return
                # quantile split can't fit: more buckets and retry
                self._B *= 2
                self.metrics.capacity_growths.add()
        self._reshard_host_sampled(from_state, grow=grow)
        self.metrics.reshards_host.add()
        self.metrics.reshard_s.add(time.perf_counter() - t0)

    def _reshard_merge(self, from_state: G.GridState, grow: bool = False) -> None:
        """Rebuild the grid on the device with pivots among its live
        boundaries and the write endpoints of every in-flight group, so that
        a batch whose writes all land past the live boundaries, as a bulk
        load's do, gets buckets of its own. Grows the grid first if asked
        to, and while a bucket overflows."""
        t0 = time.perf_counter()
        if grow:
            self._B *= 2
            self.metrics.capacity_growths.add()
        codes, _vers = G.live_codes(from_state)
        extra = torch.cat(
            [torch.cat([g["stacked"].wb, g["stacked"].we]).reshape(-1, self._lanes)
             for g in self._inflight]
        )
        while True:
            pivots = _pick_pivots_among(codes, extra, self._B)
            try:
                self._state = G.reshard(from_state, pivots, self._B, self._S)
                break
            except OverflowError:
                self._B *= 2
                self.metrics.capacity_growths.add()
        self._resharded_once = True
        self.metrics.reshards_device.add()
        self.metrics.reshard_s.add(time.perf_counter() - t0)

    def _reshard_host_sampled(
        self, from_state: G.GridState, grow: bool = False
    ) -> None:
        """Host reshard: pivots from live boundaries ∪ the key sample."""
        if grow:
            self._B *= 2
            self.metrics.capacity_growths.add()
        state = from_state
        L = self._lanes
        codes, _vers = G.live_rows(state)
        if self._sample:
            codes = np.concatenate(
                [codes, K.encode_keys(self._sample.snapshot(), self._width)]
            )
        keys = G.codes_to_bytes(np.ascontiguousarray(codes))
        _, uniq_idx = np.unique(keys, return_index=True)
        cands = codes[uniq_idx]  # sorted unique (void sort = lane order)
        cands = cands[cands.any(axis=1)]  # pivot 0 (zero code) is implicit

        n_live = int(state.count.sum())
        if n_live * 2 > self._B * self._S:
            self._B *= 2

        while True:
            pivot_codes = _pick_pivots(cands, self._B, L)
            try:
                self._state = G.reshard(state, pivot_codes, self._B, self._S)
                break
            except OverflowError:
                # the quantile split still left a bucket over capacity
                self._B *= 2
                self.metrics.capacity_growths.add()
        self._resharded_once = True

    def _maybe_rebase(self, now: int) -> None:
        if now - self._base < _INT32_REBASE_THRESHOLD:
            return
        self._flush()  # in-flight groups were encoded against the old base
        new_base = self.oldest_version - 1
        delta = new_base - self._base
        if delta > 0:
            self._state = G.rebase(self._state, int(delta))
            self._rebase_deltas[self._base_epoch] = int(delta)
            self._origin = (self._base_epoch + 1, new_base)
            self.metrics.rebases.add()
