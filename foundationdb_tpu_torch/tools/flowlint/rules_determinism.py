"""Determinism rules: sim-reachable code may not observe the host.

Simulation replays bit-identically from a seed only while every input is
loop-derived: virtual time (``loop.now()`` / ``delay()``), forked seeded
RNGs (``loop.random.fork()``), loop-issued UIDs. One ``time.time()`` or
module-level ``random.random()`` in sim-reachable code breaks the
same-seed byte-identical span guarantee in a way no tier-1 test localizes.

These rules flag *calls*. A bare reference (``now_fn=time.perf_counter``)
is dependency injection — the caller decides which personality's clock to
plug in — and is deliberately allowed.

Host-side tools (fdbmonitor, tcp_soak, …) are exempted via the
``host_only`` manifest in config.json, not ad hoc: the engine never feeds
them to ``scope="sim"`` rules, and `cli lint` prints the manifest so the
exemption stays visible.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Module, Rule

WALL_CLOCK = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "datetime.date.today",
}

ENTROPY = {
    "os.urandom",
    "os.getrandom",
    "uuid.uuid1",
    "uuid.uuid4",
    "secrets.token_bytes",
    "secrets.token_hex",
    "secrets.token_urlsafe",
    "secrets.randbits",
    "secrets.randbelow",
    "secrets.choice",
}


def _calls(mod: Module) -> Iterator[tuple[ast.Call, str]]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            dotted = mod.dotted(node.func)
            if dotted:
                yield node, dotted


class WallClockRule(Rule):
    id = "det-wall-clock"
    title = "wall-clock read in sim-reachable code (use loop.now())"
    scope = "sim"

    def check_module(self, mod: Module, config: dict) -> Iterator[Finding]:
        for node, dotted in _calls(mod):
            if dotted in WALL_CLOCK:
                yield mod.finding(
                    self.id,
                    node,
                    dotted,
                    f"{dotted}() reads the host clock; sim time must come "
                    f"from loop.now() (replay would diverge from its seed)",
                )


class SleepRule(Rule):
    id = "det-sleep"
    title = "time.sleep stalls the deterministic loop (use delay())"
    scope = "sim"

    def check_module(self, mod: Module, config: dict) -> Iterator[Finding]:
        for node, dotted in _calls(mod):
            if dotted == "time.sleep":
                yield mod.finding(
                    self.id,
                    node,
                    dotted,
                    "time.sleep() blocks the single-threaded loop in real "
                    "wall time; use await delay() (virtual time)",
                )


class EntropyRule(Rule):
    id = "det-entropy"
    title = "OS entropy in sim-reachable code (use loop.random)"
    scope = "sim"

    def check_module(self, mod: Module, config: dict) -> Iterator[Finding]:
        for node, dotted in _calls(mod):
            if dotted in ENTROPY:
                yield mod.finding(
                    self.id,
                    node,
                    dotted,
                    f"{dotted}() draws OS entropy; derive ids/bytes from the "
                    f"seeded loop RNG (loop.random / DeterministicRandom.fork)",
                )


class UnseededRandomRule(Rule):
    id = "det-unseeded-random"
    title = "module-level / unseeded random (fork the loop RNG instead)"
    scope = "sim"

    def check_module(self, mod: Module, config: dict) -> Iterator[Finding]:
        for node, dotted in _calls(mod):
            bad = None
            if dotted.startswith("random."):
                tail = dotted[len("random.") :]
                if tail == "Random":
                    if not node.args and not node.keywords:
                        bad = "random.Random() unseeded (OS-entropy default)"
                elif tail == "SystemRandom":
                    bad = "random.SystemRandom is OS entropy by construction"
                elif "." not in tail:  # module-level helpers share one global state
                    bad = f"module-level random.{tail}() uses the global RNG"
            elif dotted.startswith("numpy.random."):
                tail = dotted[len("numpy.random.") :]
                if not (tail == "default_rng" and (node.args or node.keywords)):
                    bad = f"numpy.random.{tail}() global/unseeded numpy RNG"
            if bad:
                yield mod.finding(
                    self.id,
                    node,
                    dotted,
                    f"{bad}; sim code draws from loop.random (seeded, "
                    f"forkable) so failures replay from their seed",
                )


RULES: list[Rule] = [
    WallClockRule(),
    SleepRule(),
    EntropyRule(),
    UnseededRandomRule(),
]
