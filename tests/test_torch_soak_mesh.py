"""The soak's ``tpu`` draw on a host of several devices: the JAX package's
mesh on ``tests/conftest.py``'s 8 virtual devices against the port's
``torch_mesh`` with 8 partitions, for seeds 0 and 3 (``tests/soak_slice.py``).
The transcripts are equal but for one transfer count: the port's mesh
uploads a group's batches once and replays them from the card after an
overflow, where the reference puts them on its devices again, so the
kernel sections' ``hostToDeviceBytes`` leave the comparison here.

Then ``mixed_soak(seed=1, duration=6.0)`` (``tests/test_storage_engine.py``)
and a ``watch_storm`` of 300 watchers give the reference's results and
transcript; the mixed soak's client rates per wall second are the host's
and stay out."""

import pytest
import torch

from soak_cases import PORT, REFERENCE
from soak_slice import run_soak

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads


def _without_transfer_bytes(transcript):
    events = []
    for e in transcript["events"]:
        e = dict(e)
        if "kernel" in e:
            e["kernel"] = [kv for kv in e["kernel"] if kv[0] != "hostToDeviceBytes"]
        events.append(sorted(e.items()))
    return {**transcript, "events": events}


@pytest.mark.parametrize("seed", [0, 3])
def test_soak_on_the_mesh_equals_the_reference(seed):
    port = _without_transfer_bytes(run_soak(PORT, "run_one", seed, mesh=True))
    assert port == _without_transfer_bytes(run_soak(REFERENCE, "run_one", seed, mesh=True))
    summary = dict(port["summary"])
    assert dict(summary["config"])["conflict_backend"] == "torch_mesh"
    assert any(g[-1] == "TorchMeshConflictSet" for g in port["guards"])


WALL = ("wall_s", "ops_per_s", "reads_per_s", "writes_per_s", "txn_per_s")


def _mixed_soak(pkg):
    out = run_soak(pkg, "mixed_soak", 1, duration=6.0)
    summary = dict(out["summary"])
    summary["clients"] = [kv for kv in summary["clients"] if kv[0] not in WALL]
    return {**out, "summary": summary}


def test_mixed_soak_equals_the_reference():
    port = _mixed_soak(PORT)
    assert port == _mixed_soak(REFERENCE)
    out = port["summary"]
    assert out["probe_samples"] >= 8 and dict(out["storage_engine"])["epochs_applied"] > 0


def test_watch_storm_equals_the_reference():
    port = run_soak(PORT, "watch_storm", 0, watchers=300, keys=30)
    assert port == run_soak(REFERENCE, "watch_storm", 0, watchers=300, keys=30)
    out = dict(port["summary"])
    assert out["parked_now"] == 300 and out["fired"] == 300
