"""Phase 16's storage gate (``chip_smoke.check_storage_indexes``) on
synthetic status documents, on the CPU.

A storage server answers multiGet from its engine while its index is off
or behind its engine (``server/storage.py`` ``_multi_get_at``), as after a
restart until its first durability advance rebuilds the index. The gate
counts only the reads after a status document that shows every index
current: a fallback in the rebuild window passes, one while the index is
current fails, and so does a server whose index is not on the card."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

NAMES = {"127.0.0.1:4601": "storage-4601", "127.0.0.1:4602": "storage-4602"}


def server(fallback=0, index_keys=0, device="cuda", current=True, launches=10):
    return {"kind": "storage", "indexDevice": device, "indexCurrent": current, "indexLaunches": launches,
            "multiGetIndexKeys": index_keys, "multiGetFallbackKeys": fallback, "durableVersion": 100}


def doc(ss0, ss1, ss1_addr="127.0.0.1:4602"):
    """A status document of two storage servers, ss-0 and ss-1, each in a
    worker process of its own (and a resolver, which the storage half
    ignores)."""
    return {"cluster": {"workers": {
        "127.0.0.1:4601": {"metrics": {"ss-0": ss0, "resolver-2-1": {"kind": "resolver"}}},
        ss1_addr: {"metrics": {"ss-1": ss1}},
    }}}


def test_a_restarted_servers_fallback_during_its_rebuild_passes():
    # the restarted process's server answered one key from its engine
    # before its index was rebuilt: not current, so no base yet
    rebuilding = doc(server(0, 500), server(1, 0, current=False, device=None))
    assert not chip_smoke.indexes_current(rebuilding, "cuda", NAMES)
    with pytest.raises(AssertionError, match="base status"):
        chip_smoke.check_storage_indexes(rebuilding, rebuilding, "cuda", NAMES)
    base = doc(server(0, 500), server(1, 0))
    assert chip_smoke.indexes_current(base, "cuda", NAMES)
    # the rebuild window's fallback stays in the lifetime count, not in the delta
    after = chip_smoke.check_storage_indexes(base, doc(server(0, 900), server(1, 300)), "cuda", NAMES)
    assert after["ss-1"]["fallbackDelta"] == 0 and after["ss-1"]["multiGetFallbackKeys"] == 1
    assert after["ss-1"]["indexKeysDelta"] == 300 and after["ss-0"]["indexKeysDelta"] == 400


def test_a_fallback_after_the_index_caught_up_fails():
    base = doc(server(0, 500), server(1, 0))
    with pytest.raises(AssertionError, match="storage indexes"):
        chip_smoke.check_storage_indexes(base, doc(server(0, 900), server(2, 300)), "cuda", NAMES)
    with pytest.raises(AssertionError, match="storage indexes"):
        chip_smoke.check_storage_indexes(base, doc(server(1, 900), server(1, 300)), "cuda", NAMES)


@pytest.mark.parametrize("ss1", [
    server(0, 300, device="cpu"),  # the index on the CPU, not the card
    server(0, 300, device=None, current=False),  # no index at all
    server(0, 300, current=False),  # an index behind its engine
    server(0, 300, launches=0),  # K5 never launched in its process
], ids=["cpu_index", "no_index", "behind", "no_launch"])
def test_a_server_without_the_cards_index_fails(ss1):
    base = doc(server(0, 500), server(0, 0))
    with pytest.raises(AssertionError, match="storage indexes"):
        chip_smoke.check_storage_indexes(base, doc(server(0, 900), ss1), "cuda", NAMES)


def test_the_gate_on_the_cpu_takes_the_cpu_index_without_launches():
    base = doc(server(0, 500, device="cpu", launches=0), server(0, 0, device="cpu", launches=0))
    after = doc(server(0, 900, device="cpu", launches=0), server(0, 300, device="cpu", launches=0))
    assert set(chip_smoke.check_storage_indexes(base, after, "cpu", NAMES)) == {"ss-0", "ss-1"}
    with pytest.raises(AssertionError, match="index"):
        chip_smoke.check_storage_indexes(base, after, "cuda", NAMES)


def test_a_restart_between_the_base_and_the_reads_fails():
    """A server restarted since the base (its counters reset, in the same
    process slot or another) is not held by that base, and neither is a
    document that lacks a server."""
    base = doc(server(0, 500), server(1, 400))
    with pytest.raises(AssertionError, match="storage indexes"):
        chip_smoke.check_storage_indexes(base, doc(server(0, 900), server(0, 20)), "cuda", NAMES)
    base = doc(server(0, 500), server(0, 0))
    moved = doc(server(0, 900), server(0, 300), ss1_addr="127.0.0.1:4603")
    with pytest.raises(AssertionError, match="storage indexes"):
        chip_smoke.check_storage_indexes(base, moved, "cuda", dict(NAMES, **{"127.0.0.1:4603": "storage-4603"}))
    one = doc(server(0, 900), server(0, 300))
    del one["cluster"]["workers"]["127.0.0.1:4602"]
    with pytest.raises(AssertionError, match="storage indexes"):
        chip_smoke.check_storage_indexes(base, one, "cuda", NAMES)


@pytest.mark.parametrize("which", ["ss-0", "ss-1"])
def test_a_server_whose_index_answered_no_read_fails(which):
    """A server no read reached since the base (the load balancer sent
    every read to the other replica) is not held by the gate: its index
    keys must have grown, the restarted server's as the other's."""
    base = doc(server(0, 500), server(1, 0))
    idle = {"ss-0": doc(server(0, 500), server(1, 300)), "ss-1": doc(server(0, 900), server(1, 0))}[which]
    with pytest.raises(AssertionError, match="storage indexes"):
        chip_smoke.check_storage_indexes(base, idle, "cuda", NAMES)


def test_storage_addresses_names_each_servers_process():
    """The direct reads before each gate go to these addresses."""
    d = doc(server(), server())
    assert chip_smoke.storage_addresses(d) == {"ss-0": "127.0.0.1:4601", "ss-1": "127.0.0.1:4602"}
