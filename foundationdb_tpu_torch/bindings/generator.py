"""Seeded instruction-stream generator for the stack machine.

The analog of bindingtester's test generators (bindingtester/tests/
api.py): emit weighted random instruction sequences that keep the data
stack balanced and the keyspace confined, exercising reads, writes,
clears, atomics, conflict ranges, multiple named transactions, tuple
ops, and the GET_READ_VERSION/SET_READ_VERSION pattern. The same stream
runs against the real client and the model oracle; everything the
machine pushes must match.
"""

from __future__ import annotations

import random

from ..layers import tuple as T

ATOMIC_NAMES = ["ADD", "AND", "OR", "XOR", "MAX", "MIN", "BYTE_MIN", "BYTE_MAX"]


class StreamGenerator:
    def __init__(self, seed: int, data_prefix=b"bt/d/", keyspace=40):
        self.rnd = random.Random(seed)
        self.data_prefix = data_prefix
        self.keyspace = keyspace
        self.ins: list[tuple] = []

    def key(self) -> bytes:
        return self.data_prefix + b"%03d" % self.rnd.randrange(self.keyspace)

    def value(self) -> bytes:
        return b"v%06d" % self.rnd.randrange(1 << 20)

    def emit(self, *ins):
        self.ins.append(tuple(ins))

    def _suffix(self, weights=(8, 1, 1)) -> str:
        return self.rnd.choices(["", "_SNAPSHOT", "_DATABASE"], weights)[0]

    def gen_set(self):
        suffix = self.rnd.choices(["", "_DATABASE"], (6, 1))[0]
        self.emit("PUSH", self.value())
        self.emit("PUSH", self.key())
        self.emit("SET" + suffix)
        if suffix:
            self.emit("POP")

    def gen_get(self):
        self.emit("PUSH", self.key())
        self.emit("GET" + self._suffix())

    def gen_clear(self):
        suffix = self.rnd.choices(["", "_DATABASE"], (6, 1))[0]
        self.emit("PUSH", self.key())
        self.emit("CLEAR" + suffix)
        if suffix:
            self.emit("POP")

    def gen_clear_range(self):
        a, b = sorted([self.key(), self.key()])
        if a == b:
            b = a + b"\x00"
        suffix = self.rnd.choices(["", "_DATABASE"], (6, 1))[0]
        self.emit("PUSH", b)
        self.emit("PUSH", a)
        self.emit("CLEAR_RANGE" + suffix)
        if suffix:
            self.emit("POP")

    def gen_get_range(self):
        a, b = sorted([self.key(), self.key()])
        if a == b:
            b = a + b"\x00"
        self.emit("PUSH", self.rnd.choice([0, 1]))  # STREAMING_MODE (ignored)
        self.emit("PUSH", self.rnd.choice([0, 1]))  # REVERSE
        self.emit("PUSH", self.rnd.choice([0, 3, 10]))  # LIMIT (0 = all)
        self.emit("PUSH", b)
        self.emit("PUSH", a)
        self.emit("GET_RANGE" + self._suffix())

    def gen_get_range_starts_with(self):
        self.emit("PUSH", self.rnd.choice([0, 1]))
        self.emit("PUSH", self.rnd.choice([0, 1]))
        self.emit("PUSH", self.rnd.choice([0, 5]))
        self.emit("PUSH", self.data_prefix)
        self.emit("GET_RANGE_STARTS_WITH" + self._suffix())

    def gen_get_key(self):
        # anchors inside the data keyspace with small offsets: walks stay
        # cheap, while edge offsets still escape the prefix (exercising
        # the clamp-to-prefix-window spec behavior on both sides)
        self.emit("PUSH", self.data_prefix)
        self.emit("PUSH", self.rnd.randrange(-3, 5))  # OFFSET
        self.emit("PUSH", self.rnd.choice([0, 1]))  # OR_EQUAL
        self.emit("PUSH", self.key())
        self.emit("GET_KEY" + self._suffix())

    def gen_get_range_selector(self):
        a, b = sorted([self.key(), self.key()])
        self.emit("PUSH", self.data_prefix)
        self.emit("PUSH", self.rnd.choice([0, 1]))  # STREAMING_MODE (ignored)
        self.emit("PUSH", self.rnd.choice([0, 1]))  # REVERSE
        self.emit("PUSH", self.rnd.choice([0, 4, 12]))  # LIMIT (0 = all)
        self.emit("PUSH", self.rnd.randrange(-2, 4))  # END_OFFSET
        self.emit("PUSH", self.rnd.choice([0, 1]))  # END_OR_EQUAL
        self.emit("PUSH", b)
        self.emit("PUSH", self.rnd.randrange(-2, 4))  # BEGIN_OFFSET
        self.emit("PUSH", self.rnd.choice([0, 1]))  # BEGIN_OR_EQUAL
        self.emit("PUSH", a)
        self.emit("GET_RANGE_SELECTOR" + self._suffix())

    def gen_atomic(self):
        suffix = self.rnd.choices(["", "_DATABASE"], (6, 1))[0]
        op = self.rnd.choice(ATOMIC_NAMES)
        val = (
            self.rnd.randrange(1 << 30).to_bytes(8, "little")
            if op in ("ADD", "AND", "OR", "XOR")
            else self.value()
        )
        self.emit("PUSH", val)
        self.emit("PUSH", self.key())
        self.emit("PUSH", op)
        self.emit("ATOMIC_OP" + suffix)
        if suffix:
            self.emit("POP")

    def gen_conflict_range(self):
        a, b = sorted([self.key(), self.key()])
        if a == b:
            b = a + b"\x00"
        which = self.rnd.choice(
            ["READ_CONFLICT_RANGE", "WRITE_CONFLICT_RANGE"]
        )
        self.emit("PUSH", b)
        self.emit("PUSH", a)
        self.emit(which)

    def gen_conflict_key(self):
        which = self.rnd.choice(["READ_CONFLICT_KEY", "WRITE_CONFLICT_KEY"])
        self.emit("PUSH", self.key())
        self.emit(which)

    def gen_commit(self):
        self.emit("COMMIT")
        self.emit("NEW_TRANSACTION")

    def gen_switch_transaction(self):
        name = b"tr%d" % self.rnd.randrange(3)
        self.emit("PUSH", name)
        self.emit("USE_TRANSACTION")

    def gen_read_version(self):
        self.emit("GET_READ_VERSION")
        if self.rnd.random() < 0.5:
            self.emit("SET_READ_VERSION")

    def gen_stack_noise(self):
        roll = self.rnd.random()
        if roll < 0.3:
            self.emit("PUSH", self.rnd.randrange(100))
            self.emit("PUSH", self.rnd.randrange(100))
            self.emit("SUB")
        elif roll < 0.5:
            self.emit("PUSH", self.value())
            self.emit("PUSH", self.value())
            self.emit("CONCAT")
        elif roll < 0.7:
            n = self.rnd.randrange(1, 4)
            for _ in range(n):
                self.emit("PUSH", self.value())
            self.emit("PUSH", n)
            self.emit("TUPLE_PACK")
        elif roll < 0.8:
            n = self.rnd.randrange(1, 3)
            for _ in range(n):
                self.emit("PUSH", self.key())
            self.emit("PUSH", n)
            self.emit("TUPLE_SORT")
        elif roll < 0.9:
            self.emit("PUSH", self.key())
            self.emit("PUSH", 1)
            self.emit("TUPLE_RANGE")
        else:
            self.emit("PUSH", self.value())
            self.emit("DUP")
            self.emit("POP")

    GENERATORS = [
        (gen_set, 22),
        (gen_get, 18),
        (gen_clear, 6),
        (gen_clear_range, 4),
        (gen_get_range, 8),
        (gen_get_range_starts_with, 3),
        (gen_get_key, 6),
        (gen_get_range_selector, 5),
        (gen_atomic, 10),
        (gen_conflict_range, 3),
        (gen_conflict_key, 2),
        (gen_commit, 12),
        (gen_switch_transaction, 5),
        (gen_read_version, 4),
        (gen_stack_noise, 6),
    ]

    def generate(
        self,
        n_ops: int,
        result_prefix=b"bt/r/",
        machine_prefix=b"bt/i",
    ) -> list[tuple]:
        """``machine_prefix`` must match the StackMachine's prefix: it is
        the DEFAULT transaction's name, and the tail settle must commit
        it or trailing writes on it are silently dropped."""
        fns = [f for f, _w in self.GENERATORS]
        weights = [w for _f, w in self.GENERATORS]
        self.emit("NEW_TRANSACTION")
        while len(self.ins) < n_ops:
            self.rnd.choices(fns, weights)[0](self)
        # settle every named transaction, then log the stack
        for name in (b"tr0", b"tr1", b"tr2", machine_prefix):
            self.emit("PUSH", name)
            self.emit("USE_TRANSACTION")
            self.emit("COMMIT")
        self.emit("PUSH", result_prefix)
        self.emit("LOG_STACK")
        return self.ins


async def store_instructions(db, prefix: bytes, instructions) -> None:
    """Write the stream into the database as the spec stores it: one
    tuple-packed instruction per key under the prefix's tuple range."""
    for lo in range(0, len(instructions), 200):
        chunk = instructions[lo : lo + 200]

        async def body(tr, lo=lo, chunk=chunk):
            for off, ins in enumerate(chunk):
                tr.set(T.pack((prefix, lo + off)), T.pack(ins))

        await db.run(body)
