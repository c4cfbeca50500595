"""The port's storage slice (tlog → storage server on the port's ``Sim``, the
durable keys served through ``TorchRangeIndex`` on the CPU) held against the
JAX package's (``TpuRangeIndex`` on JAX CPU), with the same seed and the same
run (``storage_slice.run_storage``): about 2,000 keys in commits of 250,
with clears and ADD atomics, three durability epochs, read rounds of 256
queries in the middle and at the end of each. Every reply of ``multiGet``
(with selectors), ``multiGetRange`` (forward and reverse), ``getKeyValues``,
``getValue`` and ``getKey`` must be equal field for field, the index codes
equal after each epoch, and the storage counters and the sim clock equal at
the end; once with chaos on, so buggify draws go through both packages."""

import pytest
import torch

import foundationdb_tpu.server.storage  # noqa: F401  (the reference run_storage drives)
from foundationdb_tpu_torch.conflict.errors import DeviceUnavailableError
from foundationdb_tpu_torch.net.sim import Sim
from foundationdb_tpu_torch.runtime.futures import AsyncVar
from foundationdb_tpu_torch.runtime.knobs import Knobs
from foundationdb_tpu_torch.ops.range_index import TorchRangeIndex
from foundationdb_tpu_torch.server.storage import StorageServer
from storage_slice import STEP, key, package, run_storage

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


@pytest.mark.parametrize("seed, chaos", [(0, False), (1, True)], ids=["calm", "chaos"])
def test_storage_slice_equals_the_jax_package(seed, chaos):
    port = run_storage("foundationdb_tpu_torch", seed=seed, chaos=chaos, device="cpu")
    ref = run_storage("foundationdb_tpu", seed=seed, chaos=chaos)
    assert len(port["replies"]) == len(ref["replies"]) == 3 * 2 * (2 + 4 + 4 + 4)
    for i, (a, b) in enumerate(zip(port["replies"], ref["replies"])):
        assert a == b, f"reply {i} differs"
    assert len(port["codes"]) == 3
    assert port["codes"] == ref["codes"]
    assert port["counters"] == ref["counters"]
    assert port["now"] == ref["now"]
    assert port["durable"] == ref["durable"]
    # the run reached both read paths: index-served misses and, before the
    # first durability advance built the index, the engine bisect
    assert port["counters"]["multiGetIndexKeys"] > 0
    assert port["counters"]["multiGetFallbackKeys"] > 0


def test_storage_index_without_a_card_raises():
    """The index on and no device given means the CUDA card: without one the
    first durability advance raises, and nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    sim = Sim(3, knobs=Knobs(STORAGE_TPU_INDEX=True))
    sim.activate()
    ss = StorageServer(tag=0, log_config=AsyncVar(None), knobs=sim.knobs, disk=sim.disk("d0"))
    ss.engine.set(b"a", b"1")
    ss.version.set(2 * sim.knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS)
    with pytest.raises(DeviceUnavailableError, match="CUDA"):
        sim.run_until_done(sim.new_process("ss0").spawn(ss.durability_loop()), limit=10.0)
    assert ss._range_index is None and ss.durable_version == 0


@pytest.mark.parametrize("fault", ["no_card", "delta"])
def test_a_failed_index_fails_the_role_through_register(fault, monkeypatch):
    """The role as ``register()`` runs it, its durability loop an actor of
    its process: when the index build (no card) or a later delta (a CUDA
    error, raised here on the CPU) fails there, every later read raises that
    fault. None is served by the engine bisect, and none by an index that no
    longer matches the engine's keys: the delta adds as many keys as it
    clears, so the row count alone would still match."""
    if fault == "no_card" and torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    cuda_error = RuntimeError("CUDA error: an illegal memory access was encountered")

    def failing_delta(self, added, removed):
        raise cuda_error

    P = package("foundationdb_tpu_torch")
    I, MT = P.I, P.MutationType
    knobs = P.Knobs(STORAGE_TPU_INDEX=True)
    sim = P.Sim(5, knobs=knobs)
    sim.activate()
    try:
        tlog = P.TLog(knobs, tags=frozenset({0}), epoch=0, log_id="tlog0", disk=sim.disk("tlog0"))
        tlog.register_instance(sim.new_process("tlog0"))
        logs = (P.TLogInterface(address="tlog0", log_id="tlog0", tags=(0,)),)
        config = P.AsyncVar(P.LogSystemConfig(epoch=0, current=P.TLogSet(epoch=0, logs=logs)))
        ss = P.StorageServer(tag=0, log_config=config, knobs=knobs, uid="ss0", disk=sim.disk("ss0"),
                             **({"device": "cpu"} if fault == "delta" else {}))
        ss.register(sim.new_process("ss0"))
        client = sim.new_process("client")
        st = {"v": 0}

        async def commit(muts):
            prev, v = st["v"], st["v"] + STEP
            await client.request(P.Endpoint("tlog0", "tlog.commit#tlog0"), I.TLogCommitRequest(
                prev_version=prev, version=v, messages={0: muts} if muts else {}, known_committed=prev))
            st["v"] = v

        async def until(cond):
            for _ in range(200):
                if cond():
                    return
                await commit([])
                await P.delay(0.2)
            raise AssertionError("the durability loop never got there")

        async def ask(token, req):
            try:
                await client.request(P.Endpoint("ss0", token), req)
            except Exception as e:
                return e
            return None

        async def main():
            await commit([P.Mutation(MT.SET_VALUE, key(i), b"v") for i in range(0, 200, 2)])
            if fault == "delta":
                await until(lambda: ss._range_index is not None and ss._range_index.n == len(ss.engine._keys))
                monkeypatch.setattr(TorchRangeIndex, "apply_delta", failing_delta)
                await commit([P.Mutation(MT.SET_VALUE, key(i), b"w") for i in range(1, 11, 2)]
                             + [P.Mutation(MT.CLEAR_RANGE, key(i), key(i) + b"\x00") for i in range(0, 10, 2)])
            await until(lambda: ss._index_fault is not None)
            v = st["v"]
            pts = [key(i) for i in range(20)]
            return [
                await ask(P.Tokens.MULTI_GET, I.MultiGetRequest(keys=pts, version=v)),
                await ask(P.Tokens.MULTI_GET_RANGE, I.MultiGetRangeRequest(
                    ranges=[(key(0), key(50), 10, False), (key(0), key(50), 10, True)], version=v)),
                await ask(P.Tokens.GET_KEY_VALUES, I.GetKeyValuesRequest(
                    begin=key(0), end=key(50), version=v, limit=10)),
                await ask(P.Tokens.GET_VALUE, I.GetValueRequest(key=key(2), version=v)),
            ]

        errors = sim.run_until_done(client.spawn(main()), limit=1_000.0)
        want = DeviceUnavailableError if fault == "no_card" else RuntimeError
        assert [type(e) for e in errors] == [want] * 4, errors
        if fault == "delta":
            assert all(e is cuda_error for e in errors)
        else:
            assert all("CUDA" in str(e) for e in errors)
        assert ss._range_index is None
        counters = ss.stats.snapshot()
        assert counters["multiGetFallbackKeys"] == 0 and counters["multiGetIndexKeys"] == 0
    finally:
        P.set_loop(None)
        P.set_buggify(P.Buggify(None))


# -- flowlint: the storage counters the status surfaces read by name ----------


def test_flowlint_role_required_counters_guards_surface():
    """Twin of ``tests/test_storage_engine.py``'s case: the port's config
    pins the storage engine counters, and a pinned name the port's
    ``StorageServer`` does not register flags reg-role-metrics on the port's
    tree."""
    from foundationdb_tpu_torch.tools.flowlint import lint, load_config

    config = load_config()
    assert "epochsApplied" in config["role_required_counters"]["storage"]
    config["role_required_counters"] = {"storage": ["definitelyMissingCtr"]}
    hits = [f for f in lint(config=config).failing
            if f.rule == "reg-role-metrics" and "definitelyMissingCtr" in f.detail]
    assert [f.relpath for f in hits] == ["foundationdb_tpu_torch/server/storage.py"]


_WORKER = """\
class Worker:
    def _make_widget(self, h):
        from .widget import Widget
        w = Widget()
        return w
"""

_ROLE = """\
from ..runtime.stats import CounterCollection

class Widget:
    def __init__(self):
        self.stats = CounterCollection("widget")
        self._c_a = self.stats.counter("bytesSampled")
        self._c_b = self.stats.counter("waitMetricsFired")

    def register_instance(self, process):
        process.register(f"widget.metrics#{id(self)}", self._metrics)

    async def _metrics(self, _req):  # flowlint: disable=reg-endpoint-span
        return self.stats.snapshot()
"""


def test_flowlint_pins_storage_telemetry_counters(tmp_path):
    """Twin of ``tests/test_storage_metrics.py``'s case: the five telemetry
    counters are pinned in the port's config, and the port's rule flags a
    dropped pin with the exact ``<Class>-counter-<name>`` detail."""
    from foundationdb_tpu_torch.tools.flowlint import lint, load_config

    pinned = set(load_config()["role_required_counters"]["storage"])
    assert {"bytesSampled", "sampleEntries", "hotRangeChecks", "waitMetricsActive",
            "waitMetricsFired"} <= pinned, pinned

    def run(role_src):
        pkg = tmp_path / "foundationdb_tpu_torch" / "server"
        pkg.mkdir(parents=True, exist_ok=True)
        (pkg / "worker.py").write_text(_WORKER)
        (pkg / "widget.py").write_text(role_src)
        return lint(root=tmp_path, config={
            "include": ["foundationdb_tpu_torch"],
            "exclude": [],
            "sim_scope": [],
            "host_only": {},
            "baseline": "baseline.json",
            "worker_module": "foundationdb_tpu_torch/server/worker.py",
            "role_exempt": [],
            "span_roles": [],
            "role_required_counters": {"widget": ["bytesSampled", "waitMetricsFired"]},
        })

    res = run(_ROLE)
    assert not res.failing, [f.format() for f in res.failing]
    res = run(_ROLE.replace('        self._c_b = self.stats.counter("waitMetricsFired")\n', ""))
    assert any(f.rule == "reg-role-metrics" and f.detail == "Widget-counter-waitMetricsFired"
               for f in res.failing), [f.format() for f in res.failing]
    assert not any(f.detail == "Widget-counter-bytesSampled" for f in res.failing)
