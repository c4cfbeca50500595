"""The port's copies of the key-value core (``kv/``: the MVCC window maps,
``KeyRangeMap``, key selectors, atomic ops, the disk queue and the memory
engine) held against the JAX package's: the same seeded numpy op stream
goes through both, and every observation (return values, and the type of
every error raised) must be identical."""

import numpy as np
import pytest

from foundationdb_tpu.kv import atomic as j_atomic
from foundationdb_tpu.kv import engine as j_engine
from foundationdb_tpu.kv import keyrange_map as j_krm
from foundationdb_tpu.kv import mutations as j_mut
from foundationdb_tpu.kv import selector as j_sel
from foundationdb_tpu.kv import versioned_map as j_vm
from foundationdb_tpu.kv.diskqueue import DiskQueue as JDiskQueue
from foundationdb_tpu.net.sim import Sim as JSim
from foundationdb_tpu.runtime import loop as j_loop
from foundationdb_tpu.runtime.futures import spawn as j_spawn
from foundationdb_tpu_torch.kv import atomic as t_atomic
from foundationdb_tpu_torch.kv import engine as t_engine
from foundationdb_tpu_torch.kv import keyrange_map as t_krm
from foundationdb_tpu_torch.kv import mutations as t_mut
from foundationdb_tpu_torch.kv import selector as t_sel
from foundationdb_tpu_torch.kv import versioned_map as t_vm
from foundationdb_tpu_torch.kv.diskqueue import DiskQueue as TDiskQueue
from foundationdb_tpu_torch.net.sim import Sim as TSim
from foundationdb_tpu_torch.runtime import loop as t_loop
from foundationdb_tpu_torch.runtime.futures import spawn as t_spawn

SEEDS = range(3)


@pytest.fixture(autouse=True)
def _no_loop_left():
    yield
    t_loop.set_loop(None)
    j_loop.set_loop(None)


def _key(rs, n=40):
    return b"k%03d" % rs.randint(n)


def _val(rs):
    return bytes(rs.randint(0, 256, size=rs.randint(0, 9)).astype(np.uint8))


def _observe(fn, *args, **kw):
    """The call's result, or the name of the error it raised."""
    try:
        return fn(*args, **kw)
    except (AssertionError, Exception) as e:  # noqa: B014 — the error type is the observation
        return ("raised", type(e).__name__)


def _vm_stream(vm_mod, atomic_mod, mut_mod, cls_name, seed, n_ops=600):
    """Writes (sets, clears, atomics applied to the latest value), reads at
    random versions in and below the window (get, get_with_presence,
    range forward and reverse, window_view), pinned snapshots,
    forget_before and rollback_after."""
    rs = np.random.RandomState(seed)
    vm = getattr(vm_mod, cls_name)()
    epoch = cls_name == "EpochVersionedMap"
    atomics = sorted(mut_mod.ATOMIC_OPS)
    out, snaps = [], []
    v = 1
    for _ in range(n_ops):
        op = rs.randint(12)
        v += int(rs.randint(0, 3))
        lo = vm.oldest_version
        rv = int(rs.randint(max(lo - 2, 0), v + 1))
        a, b = sorted((_key(rs), _key(rs)))
        if op <= 2:
            vm.set(_key(rs), _val(rs), v)
        elif op == 3:
            vm.clear_range(a, b, v)
        elif op == 4:
            k, t = _key(rs), atomics[rs.randint(len(atomics))]
            nv = _observe(atomic_mod.apply_atomic, t, vm.latest(k), _val(rs))
            out.append(("atomic", int(t), nv))
            if isinstance(nv, bytes):
                vm.set(k, nv, v)
        elif op == 5:
            out.append(_observe(vm.get_with_presence, _key(rs), rv))
            out.append(_observe(vm.get, _key(rs), rv))
        elif op == 6:
            out.append(_observe(vm.range, a, b, rv, limit=int(rs.randint(1, 8)), reverse=bool(rs.randint(2))))
        elif op == 7:
            ov, clears = vm.window_view(a, b, max(rv, lo))
            out.append((sorted(ov.items()), list(clears)))
        elif op == 8:
            out.append(("latest", vm.latest_with_presence(_key(rs))))
        elif op == 9:
            vm.forget_before(int(rs.randint(lo, v + 1)), drop_known=bool(rs.randint(2)))
            out.append(("oldest", vm.oldest_version))
        elif op == 10 and epoch:
            if snaps and rs.randint(2):
                s = snaps.pop(rs.randint(len(snaps)))
                out.append(("snap", s.valid, _observe(s.get_with_presence, _key(rs)),
                            _observe(s.range, a, b, limit=5)))
                s.release()
            else:
                s = _observe(vm.snapshot, rv)
                if isinstance(s, tuple):
                    out.append(s)
                else:
                    snaps.append(s)
            out.append(("pins", vm.min_pinned(), vm.pinned_count()))
        elif op == 11 and rs.randint(8) == 0:
            vm.rollback_after(int(rs.randint(vm.oldest_version, v + 1)))
            v = vm.latest_version
        out.append(("keys", list(vm)[:3], len(list(vm)), vm.latest_version))
    return out


@pytest.mark.parametrize("cls_name", ["VersionedMap", "EpochVersionedMap"])
@pytest.mark.parametrize("seed", SEEDS)
def test_versioned_maps_equal_the_jax_package(cls_name, seed):
    got = _vm_stream(t_vm, t_atomic, t_mut, cls_name, seed)
    want = _vm_stream(j_vm, j_atomic, j_mut, cls_name, seed)
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_sorted_keys_equals_the_jax_package(seed):
    rs = np.random.RandomState(seed)
    for _ in range(50):
        keys = sorted({_key(rs, 500) for _ in range(rs.randint(0, 60))})
        new = sorted({_key(rs, 500) for _ in range(rs.randint(1, 40))} - set(keys))
        got = _observe(t_vm.merge_sorted_keys, list(keys), new)
        assert got == _observe(j_vm.merge_sorted_keys, list(keys), new)
        if new:
            assert got[0] == sorted(keys + new)


def _krm_stream(krm_mod, seed, n_ops=300):
    rs = np.random.RandomState(seed)
    m = krm_mod.KeyRangeMap(default=0)
    out = []
    for _ in range(n_ops):
        a, b = sorted((_key(rs), _key(rs)))
        end = None if rs.randint(6) == 0 else b
        op = rs.randint(7)
        if op <= 1:
            m.insert(a, end, int(rs.randint(4)))
        elif op == 2:
            d = int(rs.randint(1, 3))
            m.modify(a, end, lambda x, d=d: x + d)
        elif op == 3:
            m.coalesce()
        elif op == 4:
            k = _key(rs)
            out.append((m[k], m.range_for(k), _observe(m.range_before, k)))
        elif op == 5:
            out.append(m.intersecting(a, end))
        out.append(list(m.ranges()))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_keyrange_map_equals_the_jax_package(seed):
    assert _krm_stream(t_krm, seed) == _krm_stream(j_krm, seed)


def _selector_stream(sel_mod, seed):
    rs = np.random.RandomState(seed)
    keys = [_key(rs, 200) for _ in range(60)] + [b"\xff/sys", b"\xff\xff"]
    KS = sel_mod.KeySelector
    out = [sel_mod.SELECTOR_END]
    for _ in range(200):
        k = _key(rs, 220)
        make = [KS.last_less_than, KS.last_less_or_equal, KS.first_greater_than,
                KS.first_greater_or_equal][rs.randint(4)]
        s = make(k) + int(rs.randint(-4, 5))
        s = s - int(rs.randint(0, 2))
        out.append((s.key, s.or_equal, s.offset, s.normalized(), repr(s)))
        out.append(sel_mod.resolve(keys, s))
        out.append(sel_mod.resolve(keys, s.normalized()))
        c = sel_mod.as_selector(k)
        out.append((c.key, c.or_equal, c.offset))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_selectors_equal_the_jax_package(seed):
    assert _selector_stream(t_sel, seed) == _selector_stream(j_sel, seed)


@pytest.mark.parametrize("mtype", [t.name for t in t_mut.MutationType])
def test_apply_atomic_equals_the_jax_package(mtype):
    """Every MutationType, atomic or not (those raise the same error), over
    seeded operands of every length 0-9 and an absent existing value."""
    rs = np.random.RandomState(len(mtype))
    for _ in range(200):
        existing = None if rs.randint(5) == 0 else _val(rs)
        param = _val(rs)
        got = _observe(t_atomic.apply_atomic, t_mut.MutationType[mtype], existing, param)
        want = _observe(j_atomic.apply_atomic, j_mut.MutationType[mtype], existing, param)
        assert got == want


def _in_sim(sim_cls, spawn, seed, body):
    sim = sim_cls(seed)
    sim.activate()
    return sim.run_until_done(spawn(body(sim)), limit=1e6)


def _diskqueue_run(sim_cls, spawn, dq_cls, seed):
    """Pushes, commits, pops, a compaction, and a kill that loses what was
    not synced, then a recovery: offsets, entries and counters observed."""
    rs = np.random.RandomState(seed)

    async def body(sim):
        disk = sim.disk("m0")
        out = []
        dq = dq_cls(disk, "q")
        out.append(await dq.recover())
        offsets = []
        for i in range(120):
            offsets.append(dq.push(bytes([i % 256]) * int(rs.randint(1, 300))))
            if rs.randint(4) == 0:
                await dq.commit()
            if rs.randint(10) == 0 and offsets:
                dq.pop(offsets[rs.randint(len(offsets))])
            if rs.randint(40) == 0:
                out.append(("compact", await dq.compact()))
        await dq.commit()
        out.append((offsets, dq.popped_offset, dq.bytes_used, dq.commits, dq.group_joins))
        dq.push(b"unsynced tail")
        disk.on_kill()
        dq2 = dq_cls(disk, "q")
        out.append(await dq2.recover())
        out.append((dq2.popped_offset, dq2.bytes_used, sim.loop.now()))
        return out

    return _in_sim(sim_cls, spawn, seed, body)


@pytest.mark.parametrize("seed", SEEDS)
def test_diskqueue_on_a_sim_disk_equals_the_jax_package(seed):
    assert _diskqueue_run(TSim, t_spawn, TDiskQueue, seed) == _diskqueue_run(JSim, j_spawn, JDiskQueue, seed)


def _engine_run(sim_cls, spawn, eng_mod, seed):
    """Sets, range clears and whole epochs on a KeyValueStoreMemory with
    dirty tracking on, commits (past the snapshot threshold), reads, then a
    kill and a recovery of a fresh engine from the same disk."""
    rs = np.random.RandomState(seed)

    async def body(sim):
        disk = sim.disk("m0")
        eng = eng_mod.KeyValueStoreMemory(disk, "kv")
        eng.SNAPSHOT_AFTER_BYTES = 4096
        await eng.recover()
        eng.track_dirty = True
        out = []
        for i in range(60):
            op = rs.randint(3)
            if op == 0:
                for _ in range(rs.randint(1, 20)):
                    eng.set(_key(rs, 300), _val(rs))
            elif op == 1:
                a, b = sorted((_key(rs, 300), _key(rs, 300)))
                eng.clear_range(a, b)
            else:
                entries = {_key(rs, 300): (None if rs.randint(4) == 0 else _val(rs))
                           for _ in range(rs.randint(1, 30))}
                a, b = sorted((_key(rs, 300), _key(rs, 300)))
                eng.apply_epoch({k: v for k, v in entries.items() if v is not None}, [(a, b)])
            if rs.randint(3) == 0:
                out.append(("dirty",) + eng.take_dirty())
            if rs.randint(4) == 0:
                await eng.commit()
            a, b = sorted((_key(rs, 300), _key(rs, 300)))
            out.append((eng.read_value(_key(rs, 300)), eng.read_range(a, b, limit=5),
                        eng.read_range(a, b, limit=4, reverse=True), len(eng), eng.keys_moved))
        await eng.commit()
        out.append((list(eng._keys), eng.dq.commits))
        disk.on_kill()
        eng2 = eng_mod.KeyValueStoreMemory(disk, "kv")
        await eng2.recover()
        out.append((list(eng2._keys), sorted(eng2._map.items()), sim.loop.now()))
        return out

    return _in_sim(sim_cls, spawn, seed, body)


@pytest.mark.parametrize("seed", SEEDS)
def test_memory_engine_on_a_sim_disk_equals_the_jax_package(seed):
    got = _engine_run(TSim, t_spawn, t_engine, seed)
    want = _engine_run(JSim, j_spawn, j_engine, seed)
    assert got == want
    assert any(o[1] and o[2] for o in got if o[0] == "dirty")
