"""The port's dynamic cluster (coordinators → cluster controller → master
recovery → recruited roles, with data distribution, the Ratekeeper, log
routers and the management API) held against the JAX package's on the
CPU: every scenario of ``tests/dynamic_slice.py`` with ``oracle``
resolvers in both packages gives the same transcript (every client value,
commit version and error class, every live role's counters, the recovery
counts and versions, the shard map, the trace events and the sim clock),
and what the reference's own tests assert holds in it. The device
backends (``torch`` / ``tpu1``, ``torch_mesh`` / ``mesh``) are in
``tests/test_torch_dynamic_device.py``.

Also: a dynamic cluster without a card raises before it makes a process,
and a configuration without ``conflict_backend`` recruits ``torch``
resolvers. ``Database(sim, coordinators=...)`` and the multi-region
options are tested in ``tests/test_torch_commit_path.py``."""

import pytest
import torch

import dynamic_slice as DS

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

JAX, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"


@pytest.fixture(autouse=True)
def _free_the_clusters():
    """A test's abandoned cluster is freed before the next test runs, so
    its actors' ``finally`` blocks cannot reach a later test's Sim."""
    yield
    DS.collect_garbage(PORT)


def check_outcome(name: str, t: dict) -> None:
    """The reference test's asserts over a transcript: every read returned
    the last value a put acknowledged for its key, every put was
    acknowledged in the end, and each scenario's own outcome held."""
    written, acked, reads = {}, set(), 0
    rows = t["client"]
    for row in rows:
        if row[0] == "put" and len(row) == 4:
            written[row[1]] = row[2]
            acked.add(row[1])
        elif row[0] == "get" and len(row) == 4:
            reads += 1
            assert row[2] == written[row[1]], row
    assert acked >= {r[1] for r in rows if r[0] == "put"}
    assert reads or name in ("ratekeeper", "log_routers", "device_survives_recovery")
    found = {r[0]: r for r in rows}
    if name == "device_survives_recovery":
        assert found["stale commit"][1] == ["error", "TransactionTooOld"]
        assert found["check"][2] == [b"v0", b"later"] + [b"v%d" % i for i in range(2, 10)] + [b"ok"]
    elif name == "dd_rereplicates":
        assert all(3 not in tags and len(tags) == 2 for _b, _e, tags in found["shards"][1])
    elif name == "ratekeeper":
        rates = found["rates"][1]
        assert rates and all(dict(r).keys() == {"batch", "default", "immediate"} for r in rates)
        assert all(v > 0 for r in rates for _k, v in r)
    elif name == "move_shard":
        assert sorted(found["tags"][1]) == [0, 1] and found["source owns"][1] is None
    elif name == "log_routers":
        assert [r[1] for r in rows if r[0] == "converged"] == [True, True]
    elif name == "exclude":
        excluded = [r[1] for r in rows if r[0] == "excluded"]
        assert len(excluded[0]) == 1 and excluded[1] == []
    elif name == "configure":
        assert len(found["status"][1]) == 2
    if name.startswith(("kill_", "repeated", "cc_", "device_", "move_survives")):
        assert max(rc for _a, _id, rc, _rv in t["recoveries"]) >= 2  # a recovery happened


@pytest.mark.parametrize("scenario", list(DS.SCENARIOS))
def test_dynamic_cluster_equals_the_jax_package_on_oracle(scenario):
    port = DS.run_dynamic(PORT, [scenario], "oracle", device="cpu")[scenario]
    ref = DS.run_dynamic(JAX, [scenario], "oracle")[scenario]
    for part in ("client", "guards", "recoveries", "shards", "roles", "events", "now"):
        assert port[part] == ref[part], part
    check_outcome(scenario, port)


def _sim():
    from foundationdb_tpu_torch.net.sim import Sim

    sim = Sim(0)
    sim.activate()
    return sim


def test_a_dynamic_cluster_without_a_card_raises_before_it_makes_a_process():
    """``device=None`` is the card: without one ``DynamicCluster`` raises
    ``DeviceUnavailableError`` before the sim holds any process, for every
    backend (a recruitment that raised inside a worker would only be
    traced, and the master would retry it forever)."""
    from foundationdb_tpu_torch.conflict.errors import DeviceUnavailableError
    from foundationdb_tpu_torch.server.cluster import ClusterConfig, DynamicCluster

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    sim = _sim()
    for cfg in (ClusterConfig(), ClusterConfig(conflict_backend="oracle"), ClusterConfig(remote_dc="dc2")):
        with pytest.raises(DeviceUnavailableError, match="CUDA"):
            DynamicCluster(sim, cfg, n_coordinators=3)
    assert not sim.processes


def test_a_config_without_a_backend_recruits_torch_resolvers(monkeypatch):
    """The master's default backend is the port's ``torch`` (the card), not
    the host ``oracle``: a configuration without the key must not resolve
    on the host without anyone noticing."""
    from foundationdb_tpu_torch.runtime.futures import delay, spawn
    from foundationdb_tpu_torch.server.cluster import ClusterConfig, DynamicCluster

    as_dict = ClusterConfig.as_dict
    monkeypatch.setattr(ClusterConfig, "as_dict",
                        lambda self: {k: v for k, v in as_dict(self).items() if k != "conflict_backend"})
    sim = _sim()
    cluster = DynamicCluster(sim, ClusterConfig(n_resolvers=2), device="cpu")
    assert "conflict_backend" not in cluster.config.as_dict()

    async def go():
        await delay(5.0)
        return sorted(type(h.obj.cs._cs).__name__ for p in sim.processes.values()
                      if getattr(p, "worker", None) is not None and p.alive
                      for h in p.worker.roles.values() if h.kind == "resolver")

    assert sim.run_until_done(spawn(go()), limit=60.0) == ["TorchConflictSet"] * 2
