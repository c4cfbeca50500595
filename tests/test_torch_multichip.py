"""The port's multi-card entry points (foundationdb_tpu_torch/tools/
multichip.py) held to the JAX package's ``__graft_entry__.py`` on the CPU:
the dry run's figures against the JAX dry run's printed line, run here on
conftest's 8 virtual devices; ``entry()``'s one step against the JAX
``entry()``'s verdicts, pressure and state; a small sweep with every
verdict equal to the port's ``native``; and the card by default."""

import re

import numpy as np
import pytest
import torch

import __graft_entry__ as J
from foundationdb_tpu.conflict import grid as JG
from foundationdb_tpu_torch.conflict import grid as G
from foundationdb_tpu_torch.conflict.errors import DeviceUnavailableError
from foundationdb_tpu_torch.tools import multichip as M

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

LINE = re.compile(
    r"dryrun_multichip OK: mesh part=(\d+) data=(\d+), (\d+)/(\d+) committed, pressure per part "
    r"(\[.*\]); \w+\((\d+) parts\) verdict parity on (\d+) txns; resolutionBalancing moved (\d+) "
    r"boundaries, post-move resolver txns (\[.*\])"
)


def figures(line: str) -> dict:
    m = LINE.search(line)
    assert m, line
    part, data, committed, txns, pressure, parts, parity, moves, gained = m.groups()
    return {"n_part": int(part), "n_data": int(data), "committed": int(committed), "txns": int(txns),
            "pressure": eval(pressure), "parts": int(parts), "parity": int(parity), "moves": int(moves),
            "gained": eval(gained)}


def test_dryrun_multichip_reports_the_jax_dry_runs_figures(capsys):
    J.dryrun_multichip(8)
    want = figures(capsys.readouterr().out)
    lines = []
    got = M.dryrun_multichip(8, device="cpu", log=lines.append)
    assert figures(lines[0]) == want
    assert {k: got[k] for k in ("n_part", "n_data", "committed", "txns", "pressure", "parity", "moves", "gained")} \
        == {k: want[k] for k in ("n_part", "n_data", "committed", "txns", "pressure", "parity", "moves", "gained")}
    # the figures of the reference's record of this run (MULTICHIP_r05.json)
    assert (got["n_part"], got["n_data"], got["committed"], got["parity"], got["moves"]) == (4, 2, 63, 144, 1)
    assert got["pressure"] == [[6, 9], [4, 9], [6, 13], [4, 9]] and got["gained"] == [42, 58]
    assert got["replicas_equal"] and got["devices"] == ["cpu"] * 8


def test_entry_step_equals_the_jax_entry():
    jfn, jargs = J.entry()
    jstate, jv, jp = jfn(*jargs)
    fn, args = M.entry(device="cpu")
    state, verdicts, pressure = fn(*args)
    np.testing.assert_array_equal(np.asarray(jv), verdicts.numpy())
    np.testing.assert_array_equal(np.asarray(jp), pressure.numpy())
    for field, a, b in zip(JG.GridState._fields, jstate, G.state_to_numpy(state)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=field)
    assert args[0].grid.shape == (256, 32, 9) and args[1].rb.shape == (256, 2, 8)


def test_small_sweep_equals_native():
    lines = []
    out = M.dryrun_sweep(4, 2, 48, device="cpu", log=lines.append)
    assert [r["parts"] for r in out["rows"]] == [1, 2, 4] and out["txns"] == 96
    assert all(r["txn_s"] > 0 for r in out["rows"]) and out["rows"][0]["ratio"] == 1.0
    assert lines[-1].startswith("dryrun_sweep OK: 96 txns x 3 configs, parity vs native on all")


def test_the_entry_points_run_on_the_card_by_default(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs on it")
    with pytest.raises(DeviceUnavailableError):
        M.entry()
    with pytest.raises(DeviceUnavailableError):
        M.dryrun_multichip(8)
    with pytest.raises(DeviceUnavailableError):
        M.dryrun_sweep(2, 1, 8)
    with pytest.raises(DeviceUnavailableError):
        M.main(["-n", "2"])


def test_card_devices_places_one_partition_a_card_where_there_are_enough(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert M.card_devices(4) == [torch.device("cuda", i) for i in range(4)]
    assert M.card_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert M.card_devices(8) == [torch.device("cuda", 0)] * 8
    assert M.card_devices(3, "cpu") == [torch.device("cpu")] * 3
