"""Binding conformance machinery.

The analog of bindings/bindingtester/ (bindingtester.py:1 + the stack-
machine spec in spec/bindingApiTester.txt): a stack machine interprets
tuple-packed instruction streams stored IN the database, exercising the
full client API surface; seeded generators produce the streams; and a
serial-MVCC model database acts as the second "binding" whose results
the real client's must match instruction for instruction.

The port's copy of ``foundationdb_tpu/bindings/``: the generator draws the
same streams from a seed, and the machine and the model log the same
bytes, as the JAX package's do.
"""

from .model import ModelDatabase
from .stack_machine import StackMachine

__all__ = ["ModelDatabase", "StackMachine"]
