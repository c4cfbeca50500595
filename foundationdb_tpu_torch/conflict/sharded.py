"""Key-range partitioned resolver over a list of CUDA cards — port of
``foundationdb_tpu/conflict/sharded.py``.

The JAX package shards the bucket grid over a device mesh: each device
owns one key-range partition as its own ``GridState``, clips every
transaction's conflict ranges to its partition, resolves against its grid,
and a ``pmax`` over the mesh makes the history verdict H and the
intra-batch overlap matrix global before the greedy commit, so verdicts
equal a single grid's bit for bit. Here a ``Spread`` holds one entry per
device of a list (a device may appear more than once); each entry holds a
contiguous run of the P partitions as the leading axis of ONE stacked
``GridState`` on its device (fields [k, B, ...], contiguous, so
``grid.view(k * B, S, L + 1)`` is the flat view). On the card a group is
ONE launch of the group scan a card (``csrc/scan.cu``): a spread of one
entry is the whole stack on one card (``resolve_many_sharded``), and a
spread of several entries (``resolve_many_spread``) hands each card's
launch every entry on that card (``kernels.spread_plan``), batch after
batch:

- every entry checks its reads against its partitions, each read clipped
  in registers, and the entries' history verdicts OR into one H of the
  card; across cards each launch publishes its H into a mapped host
  buffer and ORs in the others' (the reference's ``pmax``; one process
  over several cards, as ``shard_map`` is, so no collective library);
- K2 runs once a card on the unclipped, replicated batch (below) with
  that H, and every entry stages and merges its clipped writes; the
  verdicts come from entry 0's card and the per-partition pressures from
  replica 0 of every row, gathered on entry 0's device in partition order.

The plain version of a group is the loop of ``resolve_one_spread`` a
batch at a time (``resolve_many_spread_loop``: on CPU tensors the plain
steps, with the H of the entries exchanged by ``exchange``, plain copies;
on CUDA tensors the standalone kernels a batch an entry, kept as the
group scan's yardstick).

The entries form a grid of rows × ``n_data`` (the reference's ``("part",
"data")`` mesh): row r holds partitions r·k … r·k + k − 1, and each of its
``n_data`` entries holds a replica of them. Replica d of a row reads only
the read slots [d·KR'/D, (d+1)·KR'/D) of every batch (``split_reads``: KR
padded with inactive sentinel rows to KR', a multiple of D; the reference
refuses a KR that is not one), so its K6 history covers its partitions and
its read slice, and the exchange ORs H over all rows × D entries (the
reference's ``pmax(("part", "data"))``). K2 runs on the whole unclipped
batch (once a card in the scan, on every entry in the loop). That equals the reference's ``pmax`` of the
per-slice overlap matrices over both axes because every read slot lies in
exactly one data slice: the OR over the slices of their overlap matrices is
the matrix of all the slots. Every replica merges the same clipped writes
into its copy; the pressures come from replica 0 of each row, as the
reference's ``P("part")`` output reads one replica.

The launches of the cards of a group are queued together, each on its
card's current stream, and never wait on one another outside the kernel;
PyTorch orders the pressures' copies between two cards behind the current
streams of both, so the spread adds no streams and no events of its own.

Within one entry, as the standalone kernels of the loop run it:

- history (K6): one launch over all partitions, each read clipped to its
  partition in registers, H OR-ed over the partitions;
- intra-batch commit: the existing K2 once, on the UNCLIPPED ranges. For
  ranges with begin <= end the OR over partitions of the clipped overlap
  matrices equals the unclipped matrix: two overlapping ranges share an
  [x, y) with x below the all-0xFF code, and the partition holding x sees
  the clipped pair overlap; a clipped overlap is always an overlap;
- merge (K6): the clip, then the K3 staging and merge launches over the
  flat [P·B] view; staging ranks each clipped write endpoint against its
  own partition's pivots and offsets its bucket id by p·B, the carry
  restarts at each partition, and the pressure is per partition;
- maintenance (K7): ``rebase_parts`` (one launch over the flat view),
  ``reshard_parts`` (a partition axis in the reshard kernel) and
  ``reshard_partition`` (the same kernel on one partition's slice).

Every function takes CUDA tensors (kernels) or CPU tensors (the plain
versions, which the CPU tests hold to the JAX package exactly).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import SENTINEL, lanes_to_torch, ordered
from . import grid as G
from . import kernels

_I32 = torch.int32

# a stacked state crosses the numpy boundary like a single one
states_from_numpy = G.state_from_numpy
states_to_numpy = G.state_to_numpy


def make_sharded_states(
    n_parts: int, n_buckets: int, n_slots: int, lanes: int, device
) -> G.GridState:
    """Stacked per-partition GridStates, leading axis [n_parts]. Each
    partition's buckets pre-split its key range uniformly on the first
    uint32 lane; pivot rows carry version 0 (the empty history)."""
    return states_from_numpy(*_sharded_arrays(n_parts, n_buckets, n_slots, lanes), device)


def _sharded_arrays(n_parts: int, n_buckets: int, n_slots: int, lanes: int) -> tuple:
    """``make_sharded_states``' arrays in numpy (uint32 lanes, int32 words)."""
    step = (1 << 32) // n_parts
    sub = max(step // n_buckets, 1)
    n_sub = min(n_buckets, step // sub)
    pivots = np.full((n_parts, n_buckets, lanes), 0xFFFFFFFF, dtype=np.uint32)
    grid = np.full(
        (n_parts, n_buckets, n_slots, lanes + 1), 0xFFFFFFFF, dtype=np.uint32
    )
    grid[..., lanes] = 0
    count = np.zeros((n_parts, n_buckets), np.int32)
    pivots[:, :n_sub] = 0
    pivots[:, :n_sub, 0] = (
        np.arange(n_parts, dtype=np.uint64)[:, None] * step
        + np.arange(n_sub, dtype=np.uint64)[None, :] * sub
    )
    grid[:, :n_sub, 0, :lanes] = pivots[:, :n_sub]
    count[:, :n_sub] = 1
    zeros = np.zeros((n_parts, n_buckets), np.int32)
    return pivots, grid, count, zeros, zeros


def partition_bounds(lanes: int, n_parts: int, device):
    """(plo, phi) int32 lanes [P, L]: partition p owns [plo[p], phi[p]);
    the last partition's phi is the all-0xFF code."""
    step = (1 << 32) // n_parts
    plo = np.zeros((n_parts, lanes), np.uint32)
    plo[:, 0] = np.arange(n_parts, dtype=np.uint64) * step
    phi = np.zeros((n_parts, lanes), np.uint32)
    phi[:, 0] = plo[:, 0].astype(np.uint64) + step
    phi[-1] = 0xFFFFFFFF
    return lanes_to_torch(plo, device), lanes_to_torch(phi, device)


def clip(b: torch.Tensor, e: torch.Tensor, plo: torch.Tensor, phi: torch.Tensor):
    """Intersect ranges [b, e) with [plo, phi) (lanes broadcast along the
    last axis); an empty intersection leaves b >= e, which the kernels'
    lex b < e activity checks treat as inactive."""
    b2 = torch.where(G.lex_lt(ordered(b), ordered(plo))[..., None], plo, b)
    e2 = torch.where(G.lex_lt(ordered(phi), ordered(e))[..., None], phi, e)
    return b2, e2


def partition(states: G.GridState, p: int) -> G.GridState:
    """Partition p's GridState: views into the stacked tensors."""
    return G.GridState(*(x[p] for x in states))


def flat_view(states: G.GridState) -> G.GridState:
    """The stacked state as one grid of P·B buckets (views)."""
    P, B, S, Lp1 = states.grid.shape
    return G.GridState(
        states.pivots.view(P * B, Lp1 - 1),
        states.grid.view(P * B, S, Lp1),
        states.count.view(P * B),
        states.bmax.view(P * B),
        states.floor.view(P * B),
    )


def set_partition(states: G.GridState, p: int, shard: G.GridState) -> G.GridState:
    """A new stacked state equal to ``states`` with partition p replaced
    (the JAX ``.at[p].set``): ``states`` itself is left intact, since a
    group's snapshot may share its tensors."""
    out = G.GridState(*(x.clone() for x in states))
    for full, part in zip(out, shard):
        full[p] = part
    return out


class Entry(NamedTuple):
    """One device's share of a spread: its contiguous run of partitions as
    one stacked state, their bounds, and which replica of its row it is
    (the data slice of the read slots it checks)."""

    device: torch.device
    states: G.GridState  # [k, B, S, L + 1], ...
    plo: torch.Tensor  # [k, L]
    phi: torch.Tensor  # [k, L]
    replica: int = 0


class Spread:
    """P key-range partitions spread over a grid of devices: ``entries``
    in row-major order, ``n_data`` replicas a row; partition p sits on row
    p // k, k = P / rows, in every replica of it. The grids are updated in
    place by a batch; the other operations return a new spread and leave
    this one intact, as a group's snapshot may share its tensors."""

    def __init__(self, entries, n_data: int = 1):
        self.entries = tuple(entries)
        self.n_data = n_data
        self.n_rows = len(self.entries) // n_data
        self.per_entry = self.entries[0].states.grid.shape[0]
        self.n_parts = self.per_entry * self.n_rows

    def devices(self) -> list:
        """The distinct devices of the entries, in entry order."""
        return list(dict.fromkeys(e.device for e in self.entries))

    def entry_of(self, p: int) -> tuple[int, int]:
        """(entry of replica 0 of p's row, partition within the entry) of
        global partition p."""
        row, i = divmod(p, self.per_entry)
        return row * self.n_data, i

    def leads(self) -> list:
        """Replica 0 of every row, in partition order."""
        return list(self.entries[:: self.n_data])

    def partition(self, p: int) -> G.GridState:
        """Partition p's GridState (replica 0's): views into its tensors."""
        e, i = self.entry_of(p)
        return partition(self.entries[e].states, i)

    def replace_row(self, p: int, fn) -> "Spread":
        """A new spread with ``fn`` applied to the stack of every replica of
        partition p's row (the other rows are shared)."""
        e0, _i = self.entry_of(p)
        entries = list(self.entries)
        for e in range(e0, e0 + self.n_data):
            entries[e] = entries[e]._replace(states=fn(entries[e].states))
        return Spread(entries, self.n_data)

    def set_partition(self, p: int, shard: G.GridState) -> "Spread":
        """A new spread with partition p replaced in every replica (its
        row's stacks are copied; the other rows are shared)."""
        _e, i = self.entry_of(p)

        def put(states):
            dev = states.grid.device
            return set_partition(states, i, G.GridState(*(x.to(dev) for x in shard)))

        return self.replace_row(p, put)

    def map(self, fn) -> "Spread":
        """A new spread with ``fn`` applied to every entry's stack."""
        return Spread((e._replace(states=fn(e.states)) for e in self.entries), self.n_data)

    def clone(self) -> "Spread":
        return self.map(G.clone_state)

    def gather(self, device=None) -> G.GridState:
        """The one stacked state (replica 0 of every row), in partition
        order, on ``device`` (entry 0's by default): the layout of one stack
        and of the JAX mesh. A one-entry spread returns its own tensors."""
        device = self.entries[0].device if device is None else torch.device(device)
        if len(self.entries) == 1 and self.entries[0].device == device:
            return self.entries[0].states
        return G.GridState(*(
            torch.cat([x.to(device) for x in xs]) for xs in zip(*(e.states for e in self.leads()))
        ))

    def counts(self) -> np.ndarray:
        """int32[P, B] live rows per bucket, read back from replica 0 of
        every row."""
        return np.concatenate([e.states.count.cpu().numpy() for e in self.leads()])

    def replicas_equal(self) -> bool:
        """Whether every replica of every row holds its row's replica 0's
        state, array by array (read back to the host; a check, not on the
        path)."""
        for e0 in range(0, len(self.entries), self.n_data):
            lead = [x.cpu() for x in self.entries[e0].states]
            for e in self.entries[e0 + 1 : e0 + self.n_data]:
                if not all(torch.equal(a, b.cpu()) for a, b in zip(lead, e.states)):
                    return False
        return True


def device_grid(devices) -> list:
    """``devices`` as rows of replicas: a flat list is one replica a row
    (``data`` = 1); a list of lists is rows × ``data``, every row as long."""
    rows = [list(r) if isinstance(r, (list, tuple)) else [r] for r in devices]
    if not rows or any(len(r) != len(rows[0]) for r in rows) or not rows[0]:
        raise ValueError(f"devices {devices!r} are not rows of one length")
    return rows


def spread_from_numpy(pivots, grid, count, bmax, floor, devices) -> Spread:
    """A stacked state's numpy arrays ([P, ...], as ``states_from_numpy``
    takes them) spread over ``devices`` (``device_grid``): P must be a
    multiple of the number of rows, and each row gets the next P / rows
    partitions, a copy in each of its replicas."""
    P = grid.shape[0]
    rows = device_grid(devices) if devices else []
    if not rows or P % len(rows):
        raise ValueError(f"{P} partitions do not split over {len(rows)} rows of devices")
    k = P // len(rows)
    plo, phi = partition_bounds(grid.shape[-1] - 1, P, None)
    entries = []
    for r, row in enumerate(rows):
        part = slice(r * k, (r + 1) * k)
        for d, device in enumerate(row):
            states = states_from_numpy(pivots[part], grid[part], count[part], bmax[part], floor[part], device)
            dev = states.grid.device
            entries.append(Entry(dev, states, plo[part].to(dev), phi[part].to(dev), d))
    return Spread(entries, len(rows[0]))


def gather_to_numpy(spread: Spread) -> tuple:
    """The spread's stacked state as numpy arrays (``states_to_numpy``)."""
    return states_to_numpy(spread.gather("cpu"))


def make_spread(n_parts: int, n_buckets: int, n_slots: int, lanes: int, devices) -> Spread:
    """``make_sharded_states`` spread over ``devices``."""
    return spread_from_numpy(*_sharded_arrays(n_parts, n_buckets, n_slots, lanes), devices)


# ---------------------------------------------------------------------------
# K6: one batch over all partitions


def history_conflicts_sharded(states, batch: G.Batch, plo, phi) -> torch.Tensor:
    """bool[T]: some read range, clipped to a partition, overlaps a gap of
    that partition with version > the txn snapshot (H OR-ed over the
    partitions — the reference's pmax)."""
    if batch.rb.is_cuda:
        return kernels.history_parts(
            *states, plo, phi, batch.rb, batch.re, batch.t_snap
        )
    return history_conflicts_sharded_plain(states, batch, plo, phi)


def history_conflicts_sharded_plain(states, batch: G.Batch, plo, phi) -> torch.Tensor:
    H = torch.zeros(batch.rb.shape[0], dtype=torch.bool, device=batch.rb.device)
    for p in range(states.grid.shape[0]):
        rb, re = clip(batch.rb, batch.re, plo[p], phi[p])
        H |= G.history_conflicts_plain(partition(states, p), batch._replace(rb=rb, re=re))
    return H


def stage_writes_sharded(states, batch: G.Batch, commit, plo, phi) -> G.Staged:
    """Stage the committed writes of every partition at once: clip each
    write to each partition (torch glue), then stage the clipped endpoints
    over the flat [P·B] view, each partition ranked against its own
    pivots with its bucket ids offset by p·B — one kernel launch on the
    card, vectorised torch on the CPU."""
    S = states.grid.shape[2]
    wb, we = clip(batch.wb, batch.we, plo[:, None, None, :], phi[:, None, None, :])
    if wb.is_cuda:
        return G.Staged(*kernels.stage_parts(wb, we, commit, states.pivots, G.staging_slots(S)))
    return _stage_clipped_plain(states, wb, we, commit)


def _stage_clipped_plain(states, wb, we, commit) -> G.Staged:
    """Plain version of the staging launch: rank the clipped endpoints
    ``wb``/``we`` [P, T, KW, L] against each partition's pivots (a batched
    two-level rank), offset the bucket ids by p·B and ``_stage`` them."""
    P, B, S, Lp1 = states.grid.shape
    L = Lp1 - 1
    codes, evs, okok = G._write_events(wb, we, commit)  # [P, 2W, ...]
    bkt = G._rank(ordered(codes), ordered(states.pivots), strict=False)
    offs = torch.arange(P, dtype=_I32, device=bkt.device)[:, None] * B
    bkt = torch.where(okok, bkt + offs, torch.full_like(bkt, P * B))
    n2w = codes.shape[1]
    return G._stage(
        codes.reshape(P * n2w, L), evs.reshape(-1), bkt.reshape(-1),
        P * B, P, S, P * min(n2w, B),
    )


def merge_writes_sharded(states, batch: G.Batch, commit, now: int, oldest: int, plo, phi):
    """Merge the committed writes, clipped to each partition, into the
    stacked state IN PLACE. Returns int32[P, 2] pressures (per partition:
    max staged rows in a bucket, max kept rows in a bucket)."""
    st = stage_writes_sharded(states, batch, commit, plo, phi)
    max_kept = G.merge_staged(flat_view(states), st, now, oldest, states.grid.shape[0])
    return torch.stack([st.max_staged, max_kept], dim=-1)


def exchange(flags: list) -> list:
    """The reference's ``pmax`` of bool[T] flags over the entries: OR-ed on
    entry 0's device, then copied back to every entry's device (no copy
    where entries share a device)."""
    dev0 = flags[0].device
    total = flags[0]
    for f in flags[1:]:
        total = total | f.to(dev0, non_blocking=True)
    return [total.to(f.device, non_blocking=True) for f in flags]


def split_reads(rb: torch.Tensor, re: torch.Tensor, n_data: int) -> list:
    """The read slots (the axis before the lanes) of ``rb``/``re`` cut into
    ``n_data`` contiguous slices, one a replica: the slots are first padded
    with inactive sentinel ranges (begin = end = the all-0xFF code) to the
    next multiple of ``n_data``, so no slice is empty and no verdict
    changes. Returns [(rb_d, re_d)] in replica order."""
    if n_data == 1:
        return [(rb, re)]
    KR = rb.shape[-2]
    pad = -KR % n_data
    if pad:
        fill = rb.new_full((*rb.shape[:-2], pad, rb.shape[-1]), SENTINEL)
        rb, re = torch.cat([rb, fill], dim=-2), torch.cat([re, fill], dim=-2)
    w = (KR + pad) // n_data
    return [(rb[..., d * w : (d + 1) * w, :].contiguous(), re[..., d * w : (d + 1) * w, :].contiguous())
            for d in range(n_data)]


def resolve_one_spread(spread: Spread, batches: list, now: int, oldest_pre: int, oldest_post: int,
                       reads: list | None = None):
    """One batch through all P partitions of ``spread``; ``batches`` holds
    the whole batch on each entry's device and ``reads`` (where the spread
    has ``n_data`` > 1) each entry's slice of its read slots
    (``split_reads``), as (rb, re) on its device. On CUDA tensors the
    standalone kernels. Updates the grids IN PLACE; returns (verdicts
    int8[T], pressure int32[P, 2]), both on entry 0's device."""
    if reads is None:
        if spread.n_data > 1:
            raise ValueError(f"a spread of {spread.n_data} replicas a row needs each entry's read slice")
        reads = [(b.rb, b.re) for b in batches]
    Hs = exchange([
        history_conflicts_sharded(e.states, b._replace(rb=rb, re=re), e.plo, e.phi)
        for e, b, (rb, re) in zip(spread.entries, batches, reads)
    ])
    verdicts, pressures = None, []
    for e, b, H in zip(spread.entries, batches, Hs):
        too_old = b.t_has_reads & (b.t_snap < oldest_pre)
        commit = G.intra_batch_commits(b, H | too_old)
        pressure = merge_writes_sharded(e.states, b, commit, now, oldest_post, e.plo, e.phi)
        if e.replica == 0:
            pressures.append(pressure)
        if verdicts is None:
            verdicts = (~commit).to(torch.int8).masked_fill(too_old, G.TOO_OLD)
    dev0 = spread.entries[0].device
    return verdicts, torch.cat([p.to(dev0, non_blocking=True) for p in pressures])


def resolve_many_spread_loop(spread: Spread, batches: list, nows, oldests_pre, oldests_post,
                             reads: list | None = None):
    """G batches in order, a batch at a time through ``resolve_one_spread``
    (the reference's on-device scan as a host loop): on CPU tensors the
    plain version of ``resolve_many_spread``, on the card its loop of
    standalone kernels (K6 history, K2, K6 staging and merge an entry a
    batch), kept as a yardstick; ``batches`` holds the stacked group on each entry's device and
    ``reads`` each entry's stacked read slice. Updates the grids IN PLACE.
    Returns (verdicts int8[G, T], pressures int32[G, P, 2]) on entry 0's
    device — the per-batch pressures, not a group max."""
    verdicts, pressures = [], []
    for g in range(batches[0].rb.shape[0]):
        views = {id(b): G.Batch(*(x[g] for x in b)) for b in batches}
        slices = None if reads is None else {id(r): (r[0][g], r[1][g]) for r in reads}
        v, p = resolve_one_spread(
            spread, [views[id(b)] for b in batches],
            int(nows[g]), int(oldests_pre[g]), int(oldests_post[g]),
            None if reads is None else [slices[id(r)] for r in reads],
        )
        verdicts.append(v)
        pressures.append(p)
    return torch.stack(verdicts), torch.stack(pressures)


def resolve_many_spread(spread: Spread, batches: list, nows, oldests_pre, oldests_post,
                        reads: list | None = None, exchange=None, timeout_s: float | None = None,
                        phase_ns=None):
    """A group through every entry of ``spread`` (``batches``: the stacked
    group on each entry's device; ``reads``: each entry's stacked read
    slice where the rows have several replicas, ``split_reads``). On the
    card ONE launch a distinct card (``kernels.resolve_many_spread``, the
    group scan over the card's entries: history of every entry into one H,
    the H of the cards exchanged inside the launches through ``exchange``
    (a ``kernels.SpreadExchange``, one a spread; a spread over several
    cards needs one, and ``timeout_s``, the bound of a card's wait for the
    others' H), K2 once a card, every entry's writes staged and
    merged, clipped in the kernel), with no torch op between batches; on
    the CPU the plain loop, ``resolve_many_spread_loop``. Updates the grids
    IN PLACE. Returns (verdicts int8[G, T], pressures int32[G, P, 2] — the
    per-batch pressures of replica 0 of each row —, status) on entry 0's
    device: ``status`` int32 [cards], the launches' exchange status
    (``kernels.check_spread_status`` once they are done), None where there
    is nothing to exchange. ``phase_ns`` (one stamp buffer a distinct card,
    in ``kernels.spread_plan``'s card order) times each card's launch."""
    if not spread.entries[0].states.grid.is_cuda:
        return (*resolve_many_spread_loop(spread, batches, nows, oldests_pre, oldests_post, reads), None)
    n_batches, T = batches[0].rb.shape[:2]
    plan = kernels.spread_plan([e.device for e in spread.entries], spread.n_data, n_batches, T)
    if reads is None:
        if spread.n_data > 1:
            raise ValueError(f"a spread of {spread.n_data} replicas a row needs each entry's read slice")
        reads = [(b.rb, b.re) for b in batches]
    if plan.exchange is not None and exchange is None:
        raise ValueError("a spread over several cards exchanges H through a kernels.SpreadExchange")
    S = spread.entries[0].states.grid.shape[2]
    outs = kernels.resolve_many_spread(
        plan, [(*e.states, e.plo, e.phi) for e in spread.entries], reads,
        [tuple(batches[table[0]]) for table in plan.tables],
        [G.version_rows(nows, oldests_pre, oldests_post, card) for card in plan.cards],
        G.staging_slots(S), exchange, timeout_s, phase_ns=phase_ns,
    )
    dev0 = spread.entries[0].device
    pressures = lead_pressures(plan, [out.pressures for out in outs], dev0)
    status = None
    if plan.exchange is not None:
        status = torch.cat([out.status.to(dev0, non_blocking=True) for out in outs])
    return outs[0].verdicts, pressures, status


def lead_pressures(plan, pressures: list, device) -> torch.Tensor:
    """The per-batch pressures [G, P, 2] of a spread's group from each
    card's launch (``pressures[c]`` [E_c, G, k, 2], every entry of card
    c's table): those of replica 0 of every row (``plan.rows``), one copy
    a card that holds any to ``device``, put in row order."""
    parts, order = [], []
    for x, rows in zip(pressures, plan.rows):
        if rows:
            parts.append(_take(x, [p for p, _r in rows]).to(device, non_blocking=True))
            order += [r for _p, r in rows]
    stacked = torch.cat(parts) if len(parts) > 1 else parts[0]  # [rows, G, k, 2]
    stacked = _take(stacked, sorted(range(len(order)), key=order.__getitem__))
    return stacked.permute(1, 0, 2, 3).reshape(stacked.shape[1], -1, 2)


def _take(t: torch.Tensor, idx: list) -> torch.Tensor:
    """``t[idx]`` along the first axis without waiting for the card: a
    view where ``idx`` is evenly spaced (every layout of one card, rows of
    replicas), else an index copied from pinned memory (a Python list as an
    index is a pageable copy, which waits for the stream)."""
    if idx == list(range(t.shape[0])):
        return t
    step = idx[1] - idx[0] if len(idx) > 1 else 1
    if step > 0 and idx == list(range(idx[0], idx[0] + step * len(idx), step)):
        return t[idx[0] : idx[-1] + 1 : step]
    index = torch.tensor(idx, dtype=torch.long)
    if t.is_cuda:
        index = index.pin_memory().to(t.device, non_blocking=True)
    return t.index_select(0, index)


def resolve_many_sharded(states, batches: G.Batch, nows, oldests_pre,
                         oldests_post, bounds=None):
    """A group through the P partitions stacked in ``states`` on one device
    (a spread of one entry), with their ``bounds`` (plo, phi) (by default
    the even split of ``partition_bounds``): on the card ONE launch of the
    group scan (``kernels.resolve_many``, each read and write clipped to its
    partitions in the kernel, the versions one pinned copy), on the CPU
    ``grid.resolve_many_plain``. Updates ``states`` IN PLACE. Returns
    (states, verdicts int8[G, T], pressures int32[G, P, 2])."""
    P, _B, S, Lp1 = states.grid.shape
    dev = states.grid.device
    bounds = tuple(bounds) if bounds is not None else partition_bounds(Lp1 - 1, P, dev)
    if states.grid.is_cuda:
        vers = G.version_rows(nows, oldests_pre, oldests_post, dev)
        verdicts, pressures, _gmax = kernels.resolve_many(
            *states, bounds, *batches, vers, G.staging_slots(S)
        )
        return states, verdicts, pressures
    verdicts, pressures = G.resolve_many_plain(states, batches, nows, oldests_pre, oldests_post, bounds)
    return states, verdicts, pressures


# ---------------------------------------------------------------------------
# K7: maintenance over partitions


def reshard_parts(states, n_buckets: int, n_slots: int):
    """``grid.reshard_device`` on every partition (the reference's vmap in
    ``MeshConflictSet._grow``). Returns (new stacked states, int32[P]
    pressures)."""
    if states.grid.is_cuda:
        out = kernels.maint_reshard_parts(
            states.grid, states.count, states.floor, n_buckets, n_slots
        )
        return G.GridState(*out[:5]), out[5]
    P, B, S, _ = states.grid.shape
    used = torch.arange(S, device=states.grid.device) < states.count[..., None]
    return reshard_parts_plain(states, used.reshape(P, B * S), n_buckets, n_slots)


def reshard_parts_plain(states, used, n_buckets: int, n_slots: int):
    P = states.grid.shape[0]
    outs = [
        G.reshard_device_plain(partition(states, p), used[p], n_buckets, n_slots)
        for p in range(P)
    ]
    new = G.GridState(*(torch.stack(xs) for xs in zip(*(o[0] for o in outs))))
    return new, torch.stack([o[1] for o in outs])


def reshard_partition(states, p: int, n_buckets: int, n_slots: int):
    """Rebalance partition p's grid on the device (host-driven, between
    batches). Returns (new stacked states, pressure int): pressure >
    n_slots means the partition needs a larger grid."""
    one = G.GridState(*(x[p : p + 1] for x in states))
    new, pressure = reshard_parts(one, n_buckets, n_slots)
    return set_partition(states, p, partition(new, 0)), int(pressure[0])


def rebase_parts(states, delta: int) -> G.GridState:
    """``grid.rebase`` on every partition (the reference's vmap in
    ``MeshConflictSet._maybe_rebase``): rebase is per bucket, so the
    stack is rebased as its flat [P·B] view. Returns a new state."""
    if states.grid.is_cuda:
        grid, bmax, floor = kernels.maint_rebase_parts(
            states.grid, states.count, states.floor, delta
        )
        return G.GridState(states.pivots, grid, states.count, bmax, floor)
    return rebase_parts_plain(states, delta)


def rebase_parts_plain(states, delta: int) -> G.GridState:
    P, B, S, Lp1 = states.grid.shape
    flat = G.rebase_plain(flat_view(states), delta)
    return G.GridState(
        states.pivots, flat.grid.view(P, B, S, Lp1), states.count,
        flat.bmax.view(P, B), flat.floor.view(P, B),
    )


def reshard_spread(spread: Spread, n_buckets: int, n_slots: int) -> Spread:
    """``reshard_parts`` on every entry (the capacity growth)."""
    return spread.map(lambda states: reshard_parts(states, n_buckets, n_slots)[0])


def reshard_spread_partition(spread: Spread, p: int, n_buckets: int, n_slots: int):
    """``reshard_partition`` of global partition p in every replica of its
    row. Returns (new spread, pressure int): replica 0's, which every
    replica equals."""
    _e, i = spread.entry_of(p)
    pressures = []

    def one(states):
        states, pressure = reshard_partition(states, i, n_buckets, n_slots)
        pressures.append(pressure)
        return states

    spread = spread.replace_row(p, one)
    return spread, pressures[0]


def rebase_spread(spread: Spread, delta: int) -> Spread:
    """``rebase_parts`` on every entry."""
    return spread.map(lambda states: rebase_parts(states, delta))


def stacked_occupancy_stats(states: G.GridState) -> dict:
    """Per-partition occupancy gauges over a stacked state. Reads only the
    small count array."""
    return occupancy_stats(states.count.cpu().numpy(), states.grid.shape[2])


def spread_occupancy_stats(spread: Spread) -> dict:
    """``stacked_occupancy_stats`` of the gathered spread, from the counts."""
    return occupancy_stats(spread.counts(), spread.entries[0].states.grid.shape[2])


def occupancy_stats(counts: np.ndarray, S: int) -> dict:
    """The gauges from the live rows per bucket, int32[n_parts, B]."""
    n_parts, B = counts.shape
    per_part = counts.sum(axis=1)
    worst = int(counts.max(initial=0))
    return {
        "partitions": int(n_parts),
        "liveRows": int(per_part.sum()),
        "liveRowsPerPartition": [int(x) for x in per_part],
        "usedBuckets": int((counts > 0).sum()),
        "bucketCount": int(n_parts * B),
        "slotCapacity": int(S),
        "maxBucketRows": worst,
        "slotHeadroom": int(S - worst),
        "fillFraction": round(float(per_part.sum()) / float(n_parts * B * S), 6),
    }
