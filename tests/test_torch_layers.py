"""The port's layers (``foundationdb_tpu_torch/layers/``: tuple, subspace,
directory, and the watches they are tested with) held against the JAX
package's on the CPU: each case of ``tests/test_layers.py`` gives the same
transcript in both packages (``tests/workload_slice.py``), with ``oracle``
resolvers and with the port's ``torch`` against the JAX ``tpu1``. The
tuple case packs the reference test's tuples and 300 seeded nested tuples
of every element type: the bytes, the unpacked values and the ranges are
equal."""

import pytest
import torch

import workload_slice as WS

torch.set_num_threads(2)  # the suite runs in several xdist workers: cap each one's intra-op threads

PURE = ("tuple_pack", "tuple_ordering", "subspace")
CLUSTER = ("directory_layer", "watch_fires_on_change", "transaction_watch_after_commit",
           "set_then_watch_baseline", "clear_then_watch", "watch_on_clear")


def _same(case, backend="oracle"):
    port = WS.run_case(WS.PORT, case, backend)
    assert port == WS.run_case(WS.REFERENCE, case, backend)
    return port["rec"]


@pytest.mark.parametrize("case", PURE)
def test_tuple_and_subspace_equal_the_reference(case):
    rec = _same(case)
    if case == "tuple_pack":  # every tuple round-trips
        assert len(rec) == 308 and all(t == unpacked for t, _packed, unpacked, _range in rec)


@pytest.mark.parametrize("backend", ["oracle", "torch"])
@pytest.mark.parametrize("case", CLUSTER)
def test_layer_cases_on_a_cluster_equal_the_reference(case, backend):
    rec = _same(case, backend)
    if case == "directory_layer":
        (prefix, reopened, listing, (other, both)), (gone,), _now = rec
        assert reopened == [prefix, b"alice"] and listing == ["users"]
        assert other != prefix and both == ["events", "users"] and gone is False
    else:  # a watch does not fire early, then fires with the new value
        fired = rec[-2][0]
        assert fired == {"watch_on_clear": None, "watch_fires_on_change": b"v1",
                         "transaction_watch_after_commit": b"b", "set_then_watch_baseline": b"theirs",
                         "clear_then_watch": b"back"}[case]
        assert [False] in rec or case == "watch_on_clear"
