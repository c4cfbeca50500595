"""One seeded tlog → storage server run, the same in either package.

``run_storage(pkg, ...)`` builds the storage slice on a ``Sim`` of the
package named by ``pkg`` (``"foundationdb_tpu"`` or
``"foundationdb_tpu_torch"``): one tlog and one storage server, each on its
own ``SimDisk``, and a client process that stands in for the proxy. Every
write goes in through the tlog's commit endpoint; every read goes through a
storage endpoint at the last committed version. It returns a transcript of
plain Python values (every reply field for field, the index codes after
each durability epoch, the storage counters and the sim clock at the end),
so two packages' runs compare with ``==``.

Imports neither package at module level: the card tests import it on a
machine without JAX.
"""

from __future__ import annotations

import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np

STEP = 1_000_000  # versions a commit: the default 5M-version MVCC window is 5 commits


def package(pkg: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    sim, futures = mod("net.sim"), mod("runtime.futures")
    log_system, interfaces = mod("server.log_system"), mod("server.interfaces")
    mutations = mod("kv.mutations")
    return SimpleNamespace(
        Sim=sim.Sim, Endpoint=sim.Endpoint, Knobs=mod("runtime.knobs").Knobs,
        AsyncVar=futures.AsyncVar, delay=futures.delay, spawn=futures.spawn,
        TLog=mod("server.tlog").TLog, StorageServer=mod("server.storage").StorageServer,
        TLogInterface=log_system.TLogInterface, TLogSet=log_system.TLogSet,
        LogSystemConfig=log_system.LogSystemConfig, I=interfaces, Tokens=interfaces.Tokens,
        Mutation=mutations.Mutation, MutationType=mutations.MutationType,
        set_loop=mod("runtime.loop").set_loop,
        set_buggify=mod("runtime.buggify").set_buggify, Buggify=mod("runtime.buggify").Buggify,
    )


def plain(x):
    """A reply as plain values: dataclasses become (class name, fields)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, plain(getattr(x, f.name))) for f in dataclasses.fields(x)
        )
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, BaseException):
        return ("error", type(x).__name__)
    return x


def key(n: int) -> bytes:
    return b"k%06d" % n


def workload(seed: int, n_keys: int, commit_size: int):
    """Seeded commits: 3 epochs of writes. The first two put ``n_keys`` / 2
    new keys each in commits of ``commit_size``; the second also clears
    single keys and a few short ranges and ADDs to present keys; the third
    is one commit of new keys and single-key clears (an index delta).
    Returns the epochs and the ids of every key written."""
    rs = np.random.RandomState(seed)
    ids = rs.choice(10 * n_keys, size=n_keys + n_keys // 8, replace=False)
    first, second, third = ids[: n_keys // 2], ids[n_keys // 2 : n_keys], ids[n_keys:]
    epochs = []
    for part, extra in ((first, False), (second, True)):
        commits = []
        for c in range(0, len(part), commit_size):
            muts = [("set", key(int(i)), b"v%d-%d" % (int(i), c)) for i in part[c : c + commit_size]]
            if extra:
                present = first[rs.choice(len(first), size=commit_size // 10, replace=False)]
                for i in present[: len(present) // 2]:
                    muts.append(("clear", key(int(i)), key(int(i)) + b"\x00"))
                for i in present[len(present) // 2 :]:
                    muts.append(("add", key(int(i)), int(rs.randint(1, 1000)).to_bytes(8, "little")))
                a = int(rs.randint(0, 10 * n_keys - 50))
                muts.append(("clear", key(a), key(a + int(rs.randint(1, 40)))))
            commits.append(muts)
        epochs.append(commits)
    gone = second[rs.choice(len(second), size=len(third), replace=False)]
    epochs.append([[("set", key(int(i)), b"n%d" % int(i)) for i in third]
                   + [("clear", key(int(i)), key(int(i)) + b"\x00") for i in gone]])
    return epochs, ids


def queries(rs, written, n_keys: int, n: int):
    """One round of reads over the key space: ``n`` point keys (70 % of them
    drawn from the written ones, as ``bench.py``'s lookups), ``n`` ranges (a
    quarter reverse), a few single reads and selectors."""
    pts = [key(int(rs.choice(written) if rs.rand() < 0.7 else rs.randint(0, 10 * n_keys)))
           for _ in range(n)]
    ranges = []
    for _ in range(n):
        a = int(rs.randint(0, 10 * n_keys))
        ranges.append((key(a), key(a + int(rs.randint(1, 200))), int(rs.randint(1, 12)),
                       bool(rs.rand() < 0.25)))
    sels = [(key(int(rs.randint(0, 10 * n_keys))), int(rs.randint(-3, 4))) for _ in range(8)]
    return pts, ranges, sels


def run_storage(pkg: str, seed: int = 0, chaos: bool = False, n_keys: int = 2000,
                commit_size: int = 250, n_queries: int = 256, **storage_kw) -> dict:
    """The transcript of one run (see the module docstring). ``storage_kw``
    goes to ``StorageServer`` (the port takes ``device``)."""
    P = package(pkg)
    I, MT = P.I, P.MutationType
    knobs = P.Knobs(STORAGE_TPU_INDEX=True)
    sim = P.Sim(seed, knobs=knobs, chaos=chaos)
    sim.activate()
    try:
        tlog = P.TLog(knobs, tags=frozenset({0}), epoch=0, log_id="tlog0", disk=sim.disk("tlog0"))
        tlog.register_instance(sim.new_process("tlog0"))
        logs = (P.TLogInterface(address="tlog0", log_id="tlog0", tags=(0,)),)
        config = P.AsyncVar(P.LogSystemConfig(epoch=0, current=P.TLogSet(epoch=0, logs=logs)))
        ss = P.StorageServer(tag=0, log_config=config, knobs=knobs, uid="ss0",
                             disk=sim.disk("ss0"), **storage_kw)
        ss.register(sim.new_process("ss0"))
        client = sim.new_process("client")
        commit_ep = P.Endpoint("tlog0", "tlog.commit#tlog0")
        kinds = {"set": MT.SET_VALUE, "clear": MT.CLEAR_RANGE, "add": MT.ADD}
        rs = np.random.RandomState(seed + 1)
        out = {"replies": [], "codes": []}
        state = {"v": 0}

        async def commit(muts):
            prev, v = state["v"], state["v"] + STEP
            msgs = [P.Mutation(kinds[k], a, b) for k, a, b in muts]
            req = I.TLogCommitRequest(prev_version=prev, version=v, messages={0: msgs} if msgs else {},
                                      known_committed=prev)
            await client.request(commit_ep, req)
            state["v"] = v

        async def until_durable(target):
            for _ in range(200):
                if ss.durable_version >= target and ss._range_index is not None and (
                    ss._range_index.n == len(ss.engine._keys)
                ):
                    out["codes"].append(ss._range_index._codes_np.tolist())
                    return
                await commit([])
                await P.delay(0.2)
            raise AssertionError(f"durability stalled at {ss.durable_version} below {target}")

        async def read_round():
            v = state["v"]
            pts, ranges, sels = queries(rs, written, n_keys, n_queries)

            async def ask(token, req):
                try:
                    return plain(await client.request(P.Endpoint("ss0", token), req))
                except Exception as e:  # a reply's error is part of the transcript
                    return plain(e)

            rep = out["replies"]
            rep.append(await ask(P.Tokens.MULTI_GET, I.MultiGetRequest(
                keys=pts, selectors=[(k, o, b"", None) for k, o in sels], version=v)))
            rep.append(await ask(P.Tokens.MULTI_GET_RANGE, I.MultiGetRangeRequest(ranges=ranges, version=v)))
            for b, e, limit, reverse in ranges[:4]:
                rep.append(await ask(P.Tokens.GET_KEY_VALUES, I.GetKeyValuesRequest(
                    begin=b, end=e, version=v, limit=limit, reverse=reverse)))
            for k in pts[:4]:
                rep.append(await ask(P.Tokens.GET_VALUE, I.GetValueRequest(key=k, version=v)))
            for k, o in sels[:4]:
                rep.append(await ask(P.Tokens.GET_KEY, I.GetKeyRequest(key=k, offset=o, version=v)))

        epochs, written = workload(seed, n_keys, commit_size)

        async def main():
            for commits in epochs:
                for i, muts in enumerate(commits):
                    await commit(muts)
                    if i == len(commits) // 2:
                        await read_round()  # part in the window, part durable
                await until_durable(state["v"])
                await read_round()
            return True

        sim.run_until_done(client.spawn(main()), limit=10_000.0)
        out["counters"] = {k: v for k, v in ss.stats.snapshot().items()}
        out["now"] = sim.loop.now()
        out["durable"] = ss.durable_version
        out["index_rows"] = ss._range_index.n
        return out
    finally:  # leave no loop and no armed chaos behind for the next test
        P.set_loop(None)
        P.set_buggify(P.Buggify(None))
