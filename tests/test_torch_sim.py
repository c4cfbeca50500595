"""The port's deterministic world (``net/sim.py`` with ``net/files.py``,
``net/metrics.py`` and the ``runtime/`` modules it builds on: locality,
serialize, validation, profiler) held against the JAX package's. A ``Sim``
of each package with the same seed runs the same actors: the clock, the
order in which every request is delivered and answered, the transport
counters and the profiler's step counters must be identical, with chaos off
and on, through clogs, a partition and a process kill and reboot. The
other modules go through the same seeded op streams in both packages."""

import numpy as np
import pytest

from foundationdb_tpu.kv import mutations as j_mut
from foundationdb_tpu.net import sim as j_sim
from foundationdb_tpu.runtime import buggify as j_buggify
from foundationdb_tpu.runtime import futures as j_futures
from foundationdb_tpu.runtime import locality as j_loc
from foundationdb_tpu.runtime import loop as j_loop
from foundationdb_tpu.runtime import rng as j_rng
from foundationdb_tpu.runtime import serialize as j_ser
from foundationdb_tpu.runtime import validation as j_val
from foundationdb_tpu_torch.kv import mutations as t_mut
from foundationdb_tpu_torch.net import sim as t_sim
from foundationdb_tpu_torch.runtime import buggify as t_buggify
from foundationdb_tpu_torch.runtime import futures as t_futures
from foundationdb_tpu_torch.runtime import locality as t_loc
from foundationdb_tpu_torch.runtime import loop as t_loop
from foundationdb_tpu_torch.runtime import rng as t_rng
from foundationdb_tpu_torch.runtime import serialize as t_ser
from foundationdb_tpu_torch.runtime import validation as t_val

PORT = (t_sim, t_futures)
JAX = (j_sim, j_futures)


@pytest.fixture(autouse=True)
def _no_loop_left():
    yield
    for loop, bug in ((t_loop, t_buggify), (j_loop, j_buggify)):
        loop.set_loop(None)
        bug.set_buggify(bug.Buggify(None))


def _world(mods, seed, chaos):
    """Five processes that ping each other through seeded delays, with a
    clog, a partition and its heal, a kill with a reboot, and writes to a
    SimDisk; every delivery and reply is logged with the clock."""
    sim_mod, fut = mods
    sim = sim_mod.Sim(seed, chaos=chaos)
    sim.activate()
    log = []
    addrs = [f"p{i}" for i in range(5)]

    def boot(p):
        async def serve(req):
            log.append(("deliver", sim.loop.now(), p.address, req, p.reboots))
            await fut.delay(sim.loop.random.random01() * 0.01)
            return (p.address, req)

        async def run(_p):
            p.register("echo", serve)
            await fut.delay(0)

        return run

    procs = {a: None for a in addrs}
    for a in addrs:
        procs[a] = sim.new_process(a)
        procs[a].boot = boot(procs[a])
        procs[a].spawn(procs[a].boot(procs[a]))

    async def client(src, n):
        rnd = sim.loop.random
        for i in range(n):
            dst = addrs[rnd.random_int(0, len(addrs))]
            try:
                rep = await fut.timeout(procs[src].request(sim_mod.Endpoint(dst, "echo"), (src, i)), 0.5, "timed out")
                log.append(("reply", sim.loop.now(), src, rep))
            except Exception as e:  # broken promises and timeouts are part of the run
                log.append(("error", sim.loop.now(), src, type(e).__name__))
            await fut.delay(rnd.random01() * 0.02)

    async def chaos_driver():
        await fut.delay(0.05)
        sim.clog_pair("p0", "p1", 0.1)
        await fut.delay(0.05)
        sim.partition("p2", "p3")
        await fut.delay(0.1)
        sim.heal()
        sim.kill_process("p4", reboot_in=0.2)
        disk = sim.disk("p1")
        f = disk.open("f")
        await f.write(0, b"durable")
        await f.sync()
        await f.write(7, b"-lost")
        disk.on_kill()
        log.append(("disk", sim.loop.now(), bytes(await f.read(0, 64)), disk.total_bytes()))

    actors = [procs[a].spawn(client(a, 25)) for a in addrs[:4]] + [procs["p0"].spawn(chaos_driver())]
    sim.run_until_done(fut.spawn(fut.wait_for_all(actors)), limit=100.0)
    snap = sim.transport_metrics.stats.snapshot()
    prof = sim.loop.profiler.snapshot()
    return {
        "log": log,
        "now": sim.loop.now(),
        "transport": {k: v for k, v in snap.items() if k != "id"},
        "steps": (prof["steps"], {b: prof["bands"][b]["steps"] for b in prof["bands"]}),
        "fired": len(sim.buggify.fired),
        "reboots": procs["p4"].reboots,
    }


@pytest.mark.parametrize("chaos", [False, True], ids=["calm", "chaos"])
@pytest.mark.parametrize("seed", range(3))
def test_sim_runs_the_same_schedule_as_the_jax_package(seed, chaos):
    got, want = _world(PORT, seed, chaos), _world(JAX, seed, chaos)
    assert got["log"] == want["log"]
    assert got == want
    assert got["reboots"] == 1
    # the partition and the kill showed: a lost request timed out, one to
    # the dead process broke
    assert any(e[0] == "reply" and e[3] == "timed out" for e in got["log"])
    assert any(e[0] == "error" for e in got["log"])
    assert got["log"][-1][0] != "disk" or got["log"][-1][2] == b"durable"


@pytest.mark.parametrize("seed", range(3))
def test_serialize_equals_the_jax_package(seed):
    rs = np.random.RandomState(seed)
    for _ in range(50):
        ints = [int(x) for x in rs.randint(0, 2**31, size=4)]
        blob = bytes(rs.randint(0, 256, size=rs.randint(0, 40)).astype(np.uint8))
        out = []
        for ser in (t_ser, j_ser):
            w = ser.BinaryWriter().u8(ints[0] % 256).u32(ints[1]).i64(-ints[2]).u64(ints[3]).bytes_(blob)
            data = w.raw(b"tail").data()
            r = ser.BinaryReader(data)
            out.append((data, r.u8(), r.u32(), r.i64(), r.u64(), r.bytes_(), r.remaining()))
        assert out[0] == out[1]
        muts = {
            int(t): [(int(rs.randint(14)), blob + b"%d" % i, blob[::-1]) for i in range(rs.randint(0, 4))]
            for t in rs.randint(0, 5, size=3)
        }
        enc = [
            ser.write_tagged_messages(ints[0], {t: [mm.Mutation(mm.MutationType(a), b, c) for a, b, c in ms]
                                                for t, ms in muts.items()})
            for ser, mm in ((t_ser, t_mut), (j_ser, j_mut))
        ]
        assert enc[0] == enc[1]
        dec = [ser.read_tagged_messages(enc[0]) for ser in (t_ser, j_ser)]
        assert dec[0][0] == dec[1][0] == ints[0]
        assert {t: [(int(m.type), m.param1, m.param2) for m in ms] for t, ms in dec[0][1].items()} == \
            {t: [(int(m.type), m.param1, m.param2) for m in ms] for t, ms in dec[1][1].items()}


def _policies(loc, rng_mod, seed):
    rnd = rng_mod.DeterministicRandom(seed)
    cands = [(f"m{i}", loc.Locality.of(f"m{i}", zone=f"z{i % 3}", dc=f"dc{i % 2}")) for i in range(9)]
    out = []
    for pol in (loc.PolicyOne(), loc.PolicyAcross(2), loc.PolicyAcross(3, "zone"),
                loc.PolicyAnd([loc.PolicyAcross(2, "dc"), loc.PolicyAcross(2)]),
                loc.policy_for(1), loc.policy_for(3)):
        picks = list(cands)
        for _ in range(3):
            i, j = rnd.random_int(0, 9), rnd.random_int(0, 9)
            picks[i], picks[j] = picks[j], picks[i]
        sel = pol.select(picks)
        out.append((repr(pol), pol.replicas(), sel and [a for a, _l in sel],
                    pol.validate([l for _a, l in picks[:3]]), cands[seed][1].get("zone")))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_locality_policies_equal_the_jax_package(seed):
    assert _policies(t_loc, t_rng, seed) == _policies(j_loc, j_rng, seed)


def _oracles(val, seed):
    rs = np.random.RandomState(seed)
    d, p, out = val.DurabilityOracle(), val.PrefilterOracle(), []
    for _ in range(100):
        v = int(rs.randint(1, 1000))
        op = rs.randint(4)
        try:
            if op == 0:
                d.note_acked(v)
            elif op == 1:
                d.check_recovery(v, int(rs.randint(9)))
            elif op == 2:
                a = int(rs.randint(0, 50))
                p.note_committed(v, [(b"%03d" % a, b"%03d" % (a + int(rs.randint(1, 5))))], int(rs.randint(0, 300)))
            else:
                a = int(rs.randint(0, 50))
                p.check_rejection(v, [(b"%03d" % a, b"%03d" % (a + 2))])
            out.append(("ok", d.max_acked, p.min_floor))
        except AssertionError as e:
            out.append(("violation", str(e)))
    return out, d.violations, p.violations, p.rejections_checked


@pytest.mark.parametrize("seed", range(3))
def test_validation_oracles_equal_the_jax_package(seed):
    got = _oracles(t_val, seed)
    assert got == _oracles(j_val, seed)
    assert got[1] and got[2]  # both oracles caught something
