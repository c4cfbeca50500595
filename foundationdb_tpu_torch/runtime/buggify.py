"""BUGGIFY — seeded random activation of rare code paths in simulation.

The analog of flow/flow.h:54-67 + flow/flow.cpp:178-199: each call site is
identified by (file, line); per run, a site is first decided "enabled" with
probability p_enabled, and an enabled site then fires with p_fire per
evaluation. Outside simulation every site is off.
"""

from __future__ import annotations

import inspect
from typing import Optional

from .rng import DeterministicRandom


class Buggify:
    def __init__(self, rng: Optional[DeterministicRandom], p_enabled=0.25, p_fire=0.25):
        self.rng = rng
        self.p_enabled = p_enabled
        self.p_fire = p_fire
        self._sites: dict[tuple[str, int], bool] = {}
        self.fired: set[tuple[str, int]] = set()

    def __call__(self, site: Optional[tuple] = None, _depth: int = 1) -> bool:
        if self.rng is None:
            return False
        if site is None:
            fr = inspect.currentframe()
            for _ in range(_depth):
                fr = fr.f_back
            site = (fr.f_code.co_filename, fr.f_lineno)
        if site not in self._sites:
            self._sites[site] = self.rng.coinflip(self.p_enabled)
        if self._sites[site] and self.rng.coinflip(self.p_fire):
            self.fired.add(site)
            return True
        return False


_buggify = Buggify(None)


def set_buggify(b: Buggify) -> None:
    global _buggify
    _buggify = b


def buggify(site: Optional[tuple] = None) -> bool:
    # _depth=2: attribute the site to the caller of this wrapper, not the
    # wrapper itself — otherwise every call site collapses to one key.
    return _buggify(site, _depth=2)


def mark_fired(site: tuple) -> None:
    """Record an externally-decided chaos event (e.g. the kernel fault
    injector's own seeded-RNG rolls, conflict/faults.py) in this run's
    buggify coverage, so the soak's fired-site report sees every fault
    source — not only the buggify()-gated ones. No-op outside simulation."""
    if _buggify.rng is not None:
        _buggify.fired.add(site)
