"""Seeded deterministic PRNG — the analog of flow/DeterministicRandom.h.

Every source of nondeterminism in simulation (task latencies, clogging,
buggify activation, workload data) draws from one of these, so a failing run
replays exactly from its seed.
"""

from __future__ import annotations

import random as _random


class DeterministicRandom:
    def __init__(self, seed: int):
        self.seed = seed
        self._r = _random.Random(seed)

    def random01(self) -> float:
        return self._r.random()

    def random_int(self, lo: int, hi: int) -> int:
        """Uniform in [lo, hi) — matches the reference's randomInt convention."""
        return self._r.randrange(lo, hi)

    def random_choice(self, seq):
        return seq[self._r.randrange(0, len(seq))]

    def random_unique_id(self) -> str:
        return f"{self._r.getrandbits(64):016x}"

    def coinflip(self, p: float = 0.5) -> bool:
        return self._r.random() < p

    def shuffle(self, lst) -> None:
        self._r.shuffle(lst)

    def fork(self) -> "DeterministicRandom":
        """Derive an independent deterministic stream."""
        return DeterministicRandom(self._r.getrandbits(63))
