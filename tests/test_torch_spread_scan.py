"""The spread's group scan on the CPU: the plain version of
``sharded.resolve_many_spread`` (the loop a spread of several entries
runs on CPU tensors, and the yardstick the card's one launch a card is
held to) against the JAX package's ``build_sharded_resolver_many`` on
conftest's 8 virtual CPU devices, over ``part`` × ``data`` meshes of
4 × 1, 2 × 2 and 4 × 2, exactly: verdicts, per-batch pressures [G, P, 2]
and every replica's state, through groups of 3 to 5 batches, one of which
overflows a partition's staging and one of which crosses the int32 rebase
threshold's neighbourhood; then the launch planner ``kernels.spread_plan``
(cards, entry tables, exchange buffer, pressure rows), the exchange
timeout's fault class and its bound, the resolver's dispatch deadline,
none of which needs a card."""

import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from foundationdb_tpu.conflict import grid as JG
from foundationdb_tpu.conflict import sharded as JS
from foundationdb_tpu_torch.conflict import grid as G
from foundationdb_tpu_torch.conflict import kernels
from foundationdb_tpu_torch.conflict import sharded as TS
from foundationdb_tpu_torch.conflict import torch_backend as TB
from foundationdb_tpu_torch.conflict.api import CommitTransaction
from foundationdb_tpu_torch.conflict.errors import KernelFaultError, KernelTimeoutError, as_kernel_fault
from foundationdb_tpu_torch.conflict.mesh_backend import TorchMeshConflictSet
from foundationdb_tpu_torch.runtime.knobs import Knobs
from foundationdb_tpu_torch.server.resolver import Resolver

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

CPU = torch.device("cpu")
WIDTH, LANES = 12, 3
T, KR, KW = 32, 2, 2  # every batch padded to this shape: KR a multiple of every data axis here
B, S = 16, 32
S2 = G.staging_slots(S)
NEAR_REBASE = (1 << 30) - 8


def _key(i: int, prefix: int | None = None) -> bytes:
    """First byte over 0-255 (every partition owns traffic), or ``prefix``."""
    first = i * 256 // 3000 % 256 if prefix is None else prefix
    return bytes([first]) + b"%06d" % i


def _groups():
    """Two groups: (random, a run of 40 ranges into one bucket of the
    partition holding first byte 0x90 — past its staging slots —, random,
    random), then five random batches just under the int32 rebase."""
    rnd = random.Random(18)
    end = b"\xff" * 40  # encodes to the all-0xFF code

    def txns(n, snap):
        out = []
        for _ in range(n):
            reads = []
            for _r in range(rnd.randrange(0, KR + 1)):
                a = rnd.randrange(3000)
                reads.append((_key(a), _key(a + 1 + rnd.randrange(6))))
            c = rnd.randrange(3000)
            writes = [(_key(c), _key(c + 1 + rnd.randrange(6)))]
            if rnd.random() < 0.2:  # a clear across partitions, or to the end
                lo = bytes([rnd.randrange(200)])
                writes.append((lo, end if rnd.random() < 0.3 else bytes([rnd.randrange(lo[0] + 1, 256)])))
            out.append(CommitTransaction(snap - rnd.randrange(16), reads, writes))
        return out

    run = [CommitTransaction(30, [], [(_key(i, 0x90), _key(i + 1, 0x90))]) for i in range(40)]
    hi = NEAR_REBASE
    return [
        [(txns(24, 20), 40, 0), (run, 41, 0), (txns(24, 22), 42, 1), (txns(24, 30), 43, 2)],
        [(txns(24, hi - 20 + g), hi + g, hi - 30 + 4 * g) for g in range(5)],
    ]


def _encoded(work, horizon):
    """The group's host batches stacked at (T, KR, KW), and its (now,
    oldest_pre, oldest_post) columns, as the backends encode them (base 0)."""
    batches, cols = [], [[], [], []]
    for txs, now, old in work:
        batches.append(TB.encode_transactions(txs, WIDTH, 0))
        post = max(horizon, old)
        for c, x in zip(cols, (now, horizon, post)):
            c.append(x)
        horizon = post
    stacked = TB.stack_batches(batches + [TB.sentinel_batch(T, KR, KW, LANES)], LANES)
    return G.Batch(*(x[:-1] for x in stacked)), [np.asarray(c, np.int32) for c in cols]


def _jax_mesh(n_part, n_data):
    return Mesh(np.array(jax.devices()[: n_part * n_data]).reshape(n_part, n_data), ("part", "data"))


def _assert_replicas_equal_jax(spread, jstates):
    """Every replica of every row holds its row's slice of the JAX stack."""
    want = [np.asarray(x) for x in jstates]
    k = spread.per_entry
    for n, e in enumerate(spread.entries):
        row = n // spread.n_data
        for field, a, b in zip(G.GridState._fields, want, TS.states_to_numpy(e.states)):
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a[row * k : (row + 1) * k], b, err_msg=f"entry {n} {field}")


@pytest.mark.parametrize("n_part,n_data", [(4, 1), (2, 2), (4, 2)], ids=["4x1", "2x2", "4x2"])
def test_plain_spread_group_matches_jax_sharded_resolver_many(n_part, n_data):
    mesh = _jax_mesh(n_part, n_data)
    step = JS.build_sharded_resolver_many(mesh, lanes=LANES)
    init = TS.states_to_numpy(TS.make_sharded_states(n_part, B, S, LANES, CPU))
    spec = jax.tree.map(lambda _: NamedSharding(mesh, P("part")), JG.GridState(0, 0, 0, 0, 0))
    jstates = jax.device_put(JG.GridState(*(jnp.asarray(x) for x in init)), spec)
    spread = TS.spread_from_numpy(*init, [[CPU] * n_data for _ in range(n_part)])
    assert (spread.n_rows, spread.n_data, len(spread.entries)) == (n_part, n_data, n_part * n_data)
    horizon, overflowed = 0, False
    for work in _groups():
        stacked, cols = _encoded(work, horizon)
        horizon = int(cols[2][-1])
        jstates, jv, jp = step(jstates, JG.Batch(*(jnp.asarray(x) for x in stacked)), *cols)
        batch = TB.upload(stacked, CPU)
        slices = TS.split_reads(batch.rb, batch.re, n_data)
        reads = [slices[e.replica] for e in spread.entries] if n_data > 1 else None
        tv, tp, status = TS.resolve_many_spread(spread, [batch] * len(spread.entries), *cols, reads)
        assert status is None  # nothing to exchange on the CPU
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        assert tp.shape == (len(work), n_part, 2)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        _assert_replicas_equal_jax(spread, jstates)
        assert spread.replicas_equal()
        overflowed |= bool((tp[..., 0] > S2).any())
    assert overflowed  # the run of 40 ranges overflowed its partition's staging


@pytest.mark.parametrize("n_part,n_data", [(4, 1), (4, 2)], ids=["4x1", "4x2"])
def test_the_smokes_plain_spread_group_equals_the_plain_loop(n_part, n_data):
    """``chip_smoke.plain_spread_group``, the plain version the card's
    launch is timed and held against, gives the plain loop's verdicts,
    pressures and states through the overflow and near-rebase groups, and
    ``spread_bound`` charges the group's work to the one device here."""
    spread = TS.spread_from_numpy(*TS.states_to_numpy(TS.make_sharded_states(n_part, B, S, LANES, CPU)),
                                  [[CPU] * n_data for _ in range(n_part)])
    horizon = 0
    for work in _groups():
        stacked, cols = _encoded(work, horizon)
        horizon = int(cols[2][-1])
        batch = TB.upload(stacked, CPU)
        slices = TS.split_reads(batch.rb, batch.re, n_data)
        reads = [slices[e.replica] for e in spread.entries] if n_data > 1 else None
        before, smoke = spread.clone(), spread.clone()
        tv, tp, _status = TS.resolve_many_spread(spread, [batch] * len(spread.entries), *cols, reads)
        sv, sp = chip_smoke.plain_spread_group(smoke, [batch] * len(spread.entries), cols, reads)
        for a, b in zip((sv, sp, *chip_smoke.spread_states(smoke)), (tv, tp, *chip_smoke.spread_states(spread))):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        kept = [x.clone() for x in chip_smoke.spread_states(before)]
        ms, by, per_card = chip_smoke.spread_bound(before, [batch] * len(spread.entries), cols, reads)
        assert per_card == {"cpu": ms} and ms > 0 and by in ("bytes", "operations")
        assert all(a.equal(b) for a, b in zip(kept, chip_smoke.spread_states(before)))  # on a clone


def test_the_spread_needs_each_entrys_read_slice_when_rows_have_replicas():
    spread = TS.make_spread(2, B, S, LANES, [[CPU] * 2] * 2)
    stacked, cols = _encoded(_groups()[0][:1], 0)
    batch = TB.upload(stacked, CPU)
    with pytest.raises(ValueError, match="read slice"):
        TS.resolve_many_spread(spread, [batch] * 4, *cols)


# --- the launch planner ------------------------------------------------------

def _cuda(i: int) -> torch.device:
    return torch.device("cuda", i)  # a device name: building one needs no card


def test_spread_plan_of_four_entries_on_one_card():
    """``[cuda:0] * 4``: one launch, every entry in its table, every entry
    a row whose pressures it gives, nothing to exchange."""
    plan = kernels.spread_plan([_cuda(0)] * 4, 1, 40, 2500)
    assert plan.cards == (_cuda(0),)
    assert plan.tables == ((0, 1, 2, 3),)
    assert plan.rows == (((0, 0), (1, 1), (2, 2), (3, 3)),)
    assert plan.exchange is None


def test_spread_plan_of_four_by_two_on_one_card():
    """4 × 2 over ``[cuda:0] * 8``: one launch of eight entries; replica 0
    of each row (table positions 0, 2, 4, 6) gives rows 0-3."""
    plan = kernels.spread_plan([_cuda(0)] * 8, 2, 40, 2500)
    assert plan.cards == (_cuda(0),) and plan.tables == (tuple(range(8)),)
    assert plan.rows == (((0, 0), (2, 1), (4, 2), (6, 3)),)
    assert plan.exchange is None


def test_spread_plan_over_four_cards_and_its_exchange_buffer():
    """One partition a card over ``cuda:0 .. cuda:3``: four launches in
    card order, each its entry and row; the exchange buffer holds, for
    each launch parity, batch and card, an int32 flag (16-byte aligned as a
    whole) and ceil(2500 / 32) = 79 words of H padded to 80."""
    plan = kernels.spread_plan([_cuda(i) for i in range(4)], 1, 40, 2500)
    assert plan.cards == tuple(_cuda(i) for i in range(4))
    assert plan.tables == ((0,), (1,), (2,), (3,))
    assert plan.rows == (((0, 0),), ((0, 1),), ((0, 2),), ((0, 3),))
    x = plan.exchange
    assert (x.cards, x.slots, x.words) == (4, 40, 80)
    assert x.flags == (0, 2 * 40 * 4) and x.data == (320, 2 * 40 * 4 * 80)
    assert x.total == 320 + 25_600 and x.data[0] % 4 == 0


def test_spread_plan_in_rows_of_two_cards():
    """Rows of two cards (``[[cuda:0, cuda:1], [cuda:2, cuda:3]]``,
    entries in row-major order): a launch a card, one entry each; the
    pressures come from replica 0 of each row, on cards 0 and 2."""
    plan = kernels.spread_plan([_cuda(0), _cuda(1), _cuda(2), _cuda(3)], 2, 8, 100)
    assert plan.tables == ((0,), (1,), (2,), (3,))
    assert plan.rows == (((0, 0),), (), ((0, 1),), ())
    assert (plan.exchange.cards, plan.exchange.words, plan.exchange.slots) == (4, 4, 8)


def test_spread_plan_of_entries_interleaved_over_two_cards():
    """Entries alternate over two cards (a list that repeats devices): each
    card's table keeps entry order, card 0 holds entry 0, and a card may
    hold replica-0 entries of several rows."""
    plan = kernels.spread_plan([_cuda(1), _cuda(0), _cuda(1), _cuda(0)], 1, 3, 64)
    assert plan.cards == (_cuda(1), _cuda(0))
    assert plan.tables == ((0, 2), (1, 3))
    assert plan.rows == (((0, 0), (1, 2)), ((0, 1), (1, 3)))
    assert plan.exchange.words == 4 and plan.exchange.flags == (0, 12)


def test_spread_plan_refusals():
    with pytest.raises(ValueError):  # 5 entries do not make rows of 2
        kernels.spread_plan([_cuda(0)] * 5, 2, 1, 8)
    with pytest.raises(ValueError):  # more entries on a card than its launch's table holds
        kernels.spread_plan([_cuda(0)] * (kernels.MAX_CARD_ENTRIES + 1), 1, 1, 8)
    assert len(kernels.spread_plan([_cuda(0)] * kernels.MAX_CARD_ENTRIES, 1, 1, 8).tables[0]) == 32


@pytest.mark.parametrize("cards,n_data", [
    ([0] * 4, 1),  # [cuda:0] * 4
    ([0] * 8, 2),  # 4 x 2 over [cuda:0] * 8: leads at table positions 0, 2, 4, 6
    ([0, 1, 2, 3], 1),  # one partition a card
    ([0, 1, 2, 3], 2),  # rows of two cards: cards 1 and 3 hold no lead
    ([1, 0, 1, 0], 1),  # entries alternating over two cards
    ([0, 0, 1, 1, 0, 0, 1, 1], 2),  # rows of replicas interleaved over two cards
], ids=["4x1", "4x2", "four-cards", "rows-of-two-cards", "alternating", "interleaved-rows"])
def test_lead_pressures_gathers_replica_0_of_every_row_in_row_order(cards, n_data):
    """What each card's launch gives (every entry of its table, [E_c, G, k,
    2]) gathered into the group's [G, P, 2]: the pressures of replica 0 of
    every row, in partition order, here on CPU tensors whose values name
    their (batch, entry, partition)."""
    G_, k = 3, 2
    plan = kernels.spread_plan(cards, n_data, G_, 64)

    def value(g, i, p):  # batch g, entry i, partition p
        return 1000 * g + 10 * i + p

    per_card = [torch.tensor([[[[value(g, i, p), -value(g, i, p)] for p in range(k)] for g in range(G_)]
                              for i in table]) for table in plan.tables]
    got = TS.lead_pressures(plan, per_card, CPU)
    rows = len(cards) // n_data
    want = torch.tensor([[[value(g, r * n_data, p), -value(g, r * n_data, p)] for r in range(rows) for p in range(k)]
                         for g in range(G_)])
    assert torch.equal(got, want)


def test_scan_plan_gives_each_entry_a_block_of_scratch():
    """The card's own pieces (H, commit, K2's bitset, the merge rows) once,
    then one block of every entry's pieces a stride apart, each 16-byte
    aligned; one entry keeps the one-stack scan's sizes."""
    one = kernels.scan_plan(40, 2560, 1, 1, 3, 1, 8192, 32, 16, n_sms=132)
    four = kernels.scan_plan(40, 2560, 1, 1, 3, 1, 8192, 32, 16, n_sms=132, entries=4)
    assert four.entries == 4 and four.entry_words == one.entry_words > 0
    shared = sum(-(-one.offsets[p][1] // 4) * 4 for p in kernels.SCAN_SHARED)
    assert one.words == shared + one.entry_words
    assert four.words == shared + 4 * one.entry_words
    assert {p: n for p, (_o, n) in four.offsets.items()} == {p: n for p, (_o, n) in one.offsets.items()}
    assert all(o % 4 == 0 for o, _n in four.offsets.values()) and four.entry_words % 4 == 0
    assert set(kernels.SCAN_SHARED) | set(kernels.SCAN_ENTRY) == set(kernels.SCAN_PIECES)
    with pytest.raises(ValueError):
        kernels.scan_plan(1, 64, 1, 1, 3, 1, 512, 32, 16, n_sms=132, entries=kernels.MAX_CARD_ENTRIES + 1)


def test_scan_plan_sizes_global_merge_rows_by_every_entrys_buckets():
    """Past 111 lanes the merge's rows are global scratch, a plane for each
    warp of the grid that a touched bucket of any entry may take."""
    one = kernels.scan_plan(1, 8, 1, 1, 128, 1, 64, 32, 16, n_sms=132)
    four = kernels.scan_plan(1, 8, 1, 1, 128, 1, 64, 32, 16, n_sms=132, entries=4)
    assert one.U == 16 and not one.rows_in_smem
    assert one.offsets["rows"][1] == 16 * 64 * 130 and four.offsets["rows"][1] == 64 * 64 * 130


def test_spread_phase_ms_reads_the_exchange_column():
    """A spread's timer has the exchange's column after history; the host
    side names the phases by the stamps' width."""
    n = len(kernels.SPREAD_PHASES)
    assert kernels.SPREAD_PHASES[2] == "exchange" and n == len(kernels.SCAN_PHASES) + 1
    stamps = torch.arange(n + 1, dtype=torch.int64)[None] * 1000
    out = kernels.scan_phase_ms(stamps)
    assert list(out["phases"]) == list(kernels.SPREAD_PHASES)
    assert out["phases"]["exchange"] == 0.001


def test_an_exchange_timeout_is_a_kernel_fault():
    """A card that waited past its bound for another card's H sets its
    launch's status; ``check_spread_status`` raises the timeout, which the
    guard and the resolver classify as a kernel fault (and fail over)."""
    kernels.check_spread_status(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(kernels.ExchangeTimeoutError, match=r"cards \[1, 3\]") as e:
        kernels.check_spread_status(torch.tensor([0, 1, 0, 1], dtype=torch.int32))
    assert isinstance(e.value, KernelTimeoutError) and isinstance(e.value, KernelFaultError)
    assert as_kernel_fault(e.value) is e.value and not e.value.transient


@pytest.mark.parametrize("backend, kw", [
    ("torch_mesh", {"devices": [CPU] * 2, "n_parts": 2}),
    ("torch1", {"device": "cpu"}),
])
def test_the_resolvers_dispatch_deadline_bounds_the_exchange(backend, kw):
    """The resolver hands its CONFLICT_DISPATCH_DEADLINE to the device
    backend as the spread's bound on a card's wait for the others' H; the
    one grid, which has no other card to wait for, is built without it. A
    spread built outside a resolver takes the knob's default."""
    r = Resolver(knobs=Knobs(CONFLICT_DISPATCH_DEADLINE=0.7), backend=backend, uid="r0", capacity=256, **kw)
    try:
        cs = r.cs.primary
        if backend == "torch_mesh":
            assert isinstance(cs, TorchMeshConflictSet) and cs._exchange_timeout == 0.7
        else:
            assert type(cs).__name__ == "TorchConflictSet"
    finally:
        r.close()
    mesh = TorchMeshConflictSet(key_width=WIDTH, capacity=256, n_parts=2, devices=[CPU] * 2)
    assert mesh._exchange_timeout == Knobs.CONFLICT_DISPATCH_DEADLINE
    mesh.close()
