"""The port's wire codec (foundationdb_tpu_torch/net/wire.py) held to the
JAX package's: every registered struct of the port, built the way
``tests/test_wire_codec.py`` builds it, must reproduce the checked-in
``tests/golden_wire.json`` bytes on both codec paths and decode back; the
hot commit and read-path messages too; and the two packages' registries
hold the same structs."""

import dataclasses
import json
import os
import random

import pytest

from foundationdb_tpu.net import wire as j_wire
from foundationdb_tpu_torch.net import wire

from test_wire_codec import GOLDEN, canonical_instance, fields_equal, fuzz_value


@pytest.fixture(autouse=True)
def _compiled_codec_after():
    yield
    wire.set_compiled_codec(True)


def registered_dataclasses(w):
    return {name: e for name, e in sorted(w._struct_by_name.items()) if isinstance(e, type)}


def hot_messages():
    """The hot commit and read-path messages, as the port's
    ``tools/perf.py`` builds them from its own classes."""
    from foundationdb_tpu_torch.tools.perf import _hot_message_set

    return _hot_message_set()


def test_the_port_registers_the_structs_of_the_jax_package():
    port, ref = registered_dataclasses(wire), registered_dataclasses(j_wire)
    assert set(port) == set(ref)
    for name, cls in port.items():
        assert [f.name for f in dataclasses.fields(cls)] == [f.name for f in dataclasses.fields(ref[name])]
    assert set(wire._struct_by_name) == set(j_wire._struct_by_name)
    assert wire.PROTOCOL_VERSION == j_wire.PROTOCOL_VERSION


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "interp"])
def test_golden_bytes_reproduced_by_the_port(compiled):
    with open(GOLDEN) as f:
        golden = json.load(f)
    wire.set_compiled_codec(compiled)
    regd = registered_dataclasses(wire)
    assert set(golden["structs"]) <= set(regd)
    for name, entry in golden["structs"].items():
        cls = regd[name]
        assert [fl.name for fl in dataclasses.fields(cls)] == entry["fields"], name
        inst = canonical_instance(cls)
        got = wire.encode_value(inst)
        assert got.hex() == entry["hex"], f"{name}: bytes drifted"
        assert fields_equal(wire.decode_value(got), inst), f"{name}: decode round-trip"
    msgs = hot_messages()
    assert len(msgs) == len(golden["hot"])
    for want, msg in zip(golden["hot"], msgs):
        got = wire.encode_value(msg)
        assert got.hex() == want, type(msg).__name__
        assert wire.encode_value(wire.decode_value(got)) == got


def test_fuzzed_fields_encode_to_the_jax_bytes():
    """Random field trees through every struct: the port's compiled and
    interpretive encodings and the JAX package's are the same bytes."""
    rnd = random.Random(1807)
    ref = registered_dataclasses(j_wire)
    for name, cls in registered_dataclasses(wire).items():
        for _ in range(4):
            vals = [fuzz_value(rnd) for _ in dataclasses.fields(cls)]
            wire.set_compiled_codec(True)
            compiled = wire.encode_value(cls(*vals))
            wire.set_compiled_codec(False)
            interp = wire.encode_value(cls(*vals))
            assert compiled == interp == j_wire.encode_value(ref[name](*vals)), name


def test_frames_and_the_handshake_match():
    payloads = [wire.encode_value(m) for m in hot_messages()]
    assert wire.encode_frame(payloads[6]) == j_wire.encode_frame(payloads[6])
    assert wire.encode_super_frame(payloads) == j_wire.encode_super_frame(payloads)
    buf = bytearray(b"".join(wire.encode_frame(p) for p in payloads))
    assert wire.decode_frames(bytearray(buf)) == j_wire.decode_frames(bytearray(buf)) == payloads
    assert wire.handshake_bytes("10.0.0.1:4500") == j_wire.handshake_bytes("10.0.0.1:4500")
    assert wire.parse_handshake(bytearray(wire.handshake_bytes("10.0.0.1:4500")))[0] == "10.0.0.1:4500"
