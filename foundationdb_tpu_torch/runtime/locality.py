"""Process locality + replication policy combinators.

The analog of the reference's ``fdbrpc/Locality.h`` (process locality keys:
machine / zone / datacenter) and ``fdbrpc/ReplicationPolicy.h:99-160``
(``PolicyOne`` / ``PolicyAcross`` / ``PolicyAnd``): declarative placement
constraints used for storage team building and tlog replica sets, so a
"2-replica" cluster puts its replicas in two different failure domains
instead of two processes on one machine.

A policy answers two questions:

- ``validate(localities)`` — does this concrete replica set satisfy the
  constraint?
- ``select(candidates)`` — choose a minimal satisfying set from
  ``(item, Locality)`` pairs, or None if impossible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence


@dataclass(frozen=True)
class Locality:
    """Where a process lives (fdbrpc/Locality.h). ``zone`` is the failure
    domain replication policies speak about by default; ``machine``
    defaults to the zone and ``dc`` groups zones into regions."""

    machine: str = ""
    zone: str = ""
    dc: str = ""

    def get(self, field: str) -> str:
        return getattr(self, field)

    @classmethod
    def of(cls, machine: str, zone: str = None, dc: str = "dc0") -> "Locality":
        return cls(machine=machine, zone=zone or machine, dc=dc)


class ReplicationPolicy:
    """Base combinator (fdbrpc/ReplicationPolicy.h:99)."""

    def replicas(self) -> int:
        raise NotImplementedError

    def validate(self, localities: Sequence[Locality]) -> bool:
        raise NotImplementedError

    def select(
        self, candidates: Sequence[tuple[Any, Locality]]
    ) -> Optional[list[Any]]:
        raise NotImplementedError


class PolicyOne(ReplicationPolicy):
    """Any single replica (ReplicationPolicy.h:110 PolicyOne)."""

    def replicas(self) -> int:
        return 1

    def validate(self, localities) -> bool:
        return len(localities) >= 1

    def select(self, candidates):
        return [candidates[0][0]] if candidates else None

    def __repr__(self):
        return "One()"


class PolicyAcross(ReplicationPolicy):
    """``n`` groups with distinct values of ``field``, each group
    satisfying ``inner`` (ReplicationPolicy.h:119 PolicyAcross) — e.g.
    Across(2, "zone", One()) = two replicas in two different zones."""

    def __init__(self, n: int, field: str = "zone", inner: ReplicationPolicy = None):
        self.n = n
        self.field = field
        self.inner = inner or PolicyOne()

    def replicas(self) -> int:
        return self.n * self.inner.replicas()

    def _groups(self, pairs):
        groups: dict[str, list] = {}
        for item, loc in pairs:
            groups.setdefault(loc.get(self.field), []).append((item, loc))
        return groups

    def validate(self, localities) -> bool:
        groups: dict[str, list] = {}
        for loc in localities:
            groups.setdefault(loc.get(self.field), []).append(loc)
        good = sum(1 for g in groups.values() if self.inner.validate(g))
        return good >= self.n

    def select(self, candidates):
        groups = self._groups(candidates)
        # favor the emptiest constraint first: groups with the most
        # candidates give the inner policy the best chance
        picked: list[Any] = []
        done = 0
        for _val, group in sorted(
            groups.items(), key=lambda kv: -len(kv[1])
        ):
            if done == self.n:
                break
            inner_pick = self.inner.select(group)
            if inner_pick is not None:
                picked.extend(inner_pick)
                done += 1
        return picked if done == self.n else None

    def __repr__(self):
        return f"Across({self.n},{self.field},{self.inner!r})"


class PolicyAnd(ReplicationPolicy):
    """All sub-policies must hold on the same set
    (ReplicationPolicy.h:146 PolicyAnd)."""

    def __init__(self, policies: Sequence[ReplicationPolicy]):
        self.policies = list(policies)

    def replicas(self) -> int:
        return max(p.replicas() for p in self.policies)

    def validate(self, localities) -> bool:
        return all(p.validate(localities) for p in self.policies)

    def select(self, candidates):
        # greedy: select for the strictest policy (most replicas), then
        # verify the rest; on failure, widen by adding candidates from
        # uncovered groups until all validate or we run out
        ordered = sorted(self.policies, key=lambda p: -p.replicas())
        picked = ordered[0].select(candidates)
        if picked is None:
            return None
        loc_of = {id(i): l for i, l in candidates}
        sel = list(picked)
        rest = [c for c in candidates if c[0] not in sel]
        while not self.validate([loc_of[id(i)] for i in sel]):
            if not rest:
                return None
            sel.append(rest.pop(0)[0])
        return sel

    def __repr__(self):
        return f"And({self.policies!r})"


def policy_for(replication: int, field: str = "zone") -> ReplicationPolicy:
    """The default policy for an N-replica configuration: N distinct
    failure domains (DatabaseConfiguration's single/double/triple)."""
    if replication <= 1:
        return PolicyOne()
    return PolicyAcross(replication, field)
