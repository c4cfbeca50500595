"""The port's coordinators (foundationdb_tpu_torch/server/coordination.py)
beside the JAX package's: ``tests/test_coordination.py``'s five cases run in
both packages on the same seeds, and what each saw (values read, the
fencing error, the election's winners and losers with their sim times,
the leader a monitor converged on, the trace events) must be equal."""

import importlib

import pytest

from commit_slice import plain
from dynamic_slice import collect_garbage

PACKAGES = ("foundationdb_tpu", "foundationdb_tpu_torch")


def _mods(pkg):
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    return mod("net.sim"), mod("runtime.futures"), mod("server.coordination"), mod("runtime.trace")


def make_coords(C, sim, n=3):
    sim.activate()
    addrs = []
    for i in range(n):
        C.CoordinatorServer().register(sim.new_process(f"coord{i}"))
        addrs.append(f"coord{i}")
    return addrs


def roundtrip(S, F, C):
    sim = S.Sim(seed=1)
    coords = make_coords(C, sim)
    p = sim.new_process("master0")

    async def go():
        prev = await C.CoordinatedState(p, coords).read()
        cs = C.CoordinatedState(p, coords)
        await cs.read()
        await cs.write({"epoch": 1})
        return prev, await C.CoordinatedState(p, coords).read()

    return sim, sim.run_until_done(p.spawn(go()), limit=60)


def fencing(S, F, C):
    sim = S.Sim(seed=2)
    coords = make_coords(C, sim)
    p1, p2 = sim.new_process("masterA"), sim.new_process("masterB")

    async def go():
        seen = []
        cs1 = C.CoordinatedState(p1, coords)
        await cs1.read()
        await cs1.write({"owner": "A"})
        cs2 = C.CoordinatedState(p2, coords)
        seen.append(await cs2.read())
        try:
            await cs1.write({"owner": "A2"})
            seen.append("A2 written")
        except C.ClusterStateChanged as e:
            seen.append(plain(e))
        await cs2.write({"owner": "B"})
        seen.append(await C.CoordinatedState(p1, coords).read())
        return seen

    return sim, sim.run_until_done(p1.spawn(go()), limit=60)


def minority_failure(S, F, C):
    sim = S.Sim(seed=3)
    coords = make_coords(C, sim, n=5)
    sim.kill_process("coord0")
    sim.kill_process("coord3")
    p = sim.new_process("master0")

    async def go():
        cs = C.CoordinatedState(p, coords)
        await cs.read()
        await cs.write("still-works")
        return await C.CoordinatedState(p, coords).read()

    return sim, sim.run_until_done(p.spawn(go()), limit=60)


def election(S, F, C):
    sim = S.Sim(seed=4)
    coords = make_coords(C, sim)
    pa, pb = sim.new_process("workerA"), sim.new_process("workerB")
    events = []

    async def campaign(p, info, name):
        while True:
            lead = await C.try_become_leader(p, coords, info)
            events.append((sim.loop.now(), name, "won"))
            await lead.lost
            events.append((sim.loop.now(), name, "lost"))

    pa.spawn(campaign(pa, C.LeaderInfo(address="workerA", priority=2, change_id=101), "A"))
    pb.spawn(campaign(pb, C.LeaderInfo(address="workerB", priority=1, change_id=102), "B"))
    sim.run(until=10)
    at_10 = list(events)
    t_kill = sim.loop.now()
    sim.kill_process("workerA")
    sim.run(until=t_kill + 30, stop_when=lambda: events and events[-1][1:] == ("B", "won"))
    return sim, (at_10, events)


def monitor(S, F, C):
    sim = S.Sim(seed=5)
    coords = make_coords(C, sim)
    pw, pc = sim.new_process("workerA"), sim.new_process("client0")
    seen = F.AsyncVar(None)

    async def campaign():
        lead = await C.try_become_leader(pw, coords, C.LeaderInfo(address="workerA", priority=1, change_id=7))
        await lead.lost

    pw.spawn(campaign())
    pc.spawn(C.monitor_leader(pc, coords, seen))
    sim.run(until=15)
    return sim, seen.get()


CASES = {f.__name__: f for f in (roundtrip, fencing, minority_failure, election, monitor)}


def _run(pkg, case):
    S, F, C, T = _mods(pkg)
    saved = T.trace_log()
    log = T.TraceLog()
    T.set_trace_log(log)
    try:
        sim, got = CASES[case](S, F, C)
        events = [sorted((k, plain(v)) for k, v in e.items() if k != "Backtrace") for e in log.events]
        return plain(got), events, sim.loop.now()
    finally:
        T.set_trace_log(saved)
        collect_garbage(pkg)


@pytest.mark.parametrize("case", list(CASES))
def test_coordination_equals_the_jax_package(case):
    port, ref = _run("foundationdb_tpu_torch", case), _run("foundationdb_tpu", case)
    assert port == ref
    got = port[0]
    if case == "roundtrip":
        assert got == [None, [("epoch", 1)]]
    elif case == "fencing":
        assert got == [[("owner", "A")], ["error", "ClusterStateChanged"], [("owner", "B")]]
    elif case == "minority_failure":
        assert got == "still-works"
    elif case == "election":
        at_10, events = got
        assert [e[1:] for e in at_10 if e[1] == "A"] == [["A", "won"]]
        assert events[-1][1:] == ["B", "won"]
    else:
        assert dict(got[1:])["address"] == "workerA"
