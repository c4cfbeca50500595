"""The port's client (foundationdb_tpu_torch/client/: Database, Transaction,
the read coalescer, load balancing) held against the JAX package's on a
4-storage static cluster with the oracle resolver, same seed, same
scenarios (``commit_slice.run_commit``): read-your-writes over storage,
every atomic op, versionstamped keys and values, forward, reverse and
limited ranges and selectors across shards under an overlay of
uncommitted writes and clears, batched GRVs, and same-tick gets that the
read coalescer sends as storage multiGets. Each storage server has its
durable engine and a 0.2 s MVCC window, so reads of durable keys go
through the engine and its range index (on the CPU here).
Each runs with the read coalescer on (the default), off, and at pipeline
depth 1. Every value the client sees and every storage counter (multiGet
batches, keys and index keys among them) must be equal: the tolerance is
exact."""

import functools

import pytest
import torch

from commit_slice import run_commit

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

SCENARIOS = ("read_your_writes", "atomics", "versionstamps", "ranges", "overlay_limits",
             "reverse_across_shards", "grv_batching", "coalesced_reads", "durable_reads")
WINDOW = (("MAX_READ_TRANSACTION_LIFE_VERSIONS", 200_000),)
SHAPE = (("n_storage", 4), ("n_proxies", 2))
CONFIGS = {
    "coalescing": WINDOW,
    "no-coalescing": WINDOW + (("CLIENT_READ_COALESCING", False),),
    "depth-1": WINDOW + (("CLIENT_READ_PIPELINE_DEPTH", 1),),
}


@functools.lru_cache(maxsize=None)
def _pair(config):
    common = dict(scenarios=SCENARIOS, seed=12, backend="oracle", shape=dict(SHAPE),
                  knobs=dict(CONFIGS[config]))
    return (run_commit("foundationdb_tpu_torch", device="cpu", **common),
            run_commit("foundationdb_tpu", **common))


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_client_scenario_equals_the_jax_package(config, scenario):
    port, ref = _pair(config)
    assert port["scenarios"][scenario], "the scenario recorded nothing"
    assert port["scenarios"][scenario] == ref["scenarios"][scenario]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_storage_and_proxy_counters_equal_the_jax_package(config):
    port, ref = _pair(config)
    for part in ("storages", "proxies", "master", "now"):
        assert port[part] == ref[part], part
    multi = sum(dict(s)["multiGetKeys"] for s in port["storages"])
    index = sum(dict(s)["multiGetIndexKeys"] for s in port["storages"])
    if config == "no-coalescing":
        assert multi == 0  # every read its own getValue
    else:  # same-tick gets went out as multiGets, durable misses to the index
        assert multi > 0 and index > 0


def test_coalesced_gets_share_multigets():
    """45 same-tick gets of 5 transactions at one read version: fewer
    multiGet requests than keys, and every value the one stored."""
    port, _ = _pair("coalescing")
    values = port["scenarios"]["coalesced_reads"][1][0]
    assert len(values) == 45
    want = [b"v%d" % ((7 * j + i) % 45) if (7 * j + i) % 45 < 40 else None
            for i in range(5) for j in range(9)]
    assert values == want
    calls = sum(dict(s)["multiGetBatches"] for s in port["storages"])
    keys = sum(dict(s)["multiGetKeys"] for s in port["storages"])
    assert 0 < calls < keys


def test_key_helpers_equal_the_jax_package():
    from foundationdb_tpu.client import key_after as j_after, strinc as j_strinc
    from foundationdb_tpu_torch.client import KeySelector, key_after, strinc

    for k in (b"a", b"ab\xff", b"\x00", b"z\xff\xff"):
        assert strinc(k) == j_strinc(k) and key_after(k) == j_after(k)
    with pytest.raises(ValueError):
        strinc(b"\xff\xff")
    assert KeySelector.first_greater_or_equal(b"k").normalized() == (b"k", 1)
