"""ConsistencyCheck — replica equality + shard-map sanity.

The analog of fdbserver/workloads/ConsistencyCheck.actor.cpp, run after
every test via checkConsistency (tester.actor.cpp:740): walk the shard
map, read every shard's data DIRECTLY from each replica at one read
version, and require byte-identical results; verify the shard map tiles
the keyspace with team sizes matching the replication factor.
"""

from __future__ import annotations

from ..errors import FdbError
from ..net.sim import BrokenPromise, Endpoint
from ..runtime.futures import delay
from ..server.interfaces import (
    GetKeyServersRequest,
    GetKeyValuesRequest,
    Tokens,
)
from . import Workload


class ConsistencyCheckWorkload(Workload):
    def __init__(self, db, rng, replication: int = None, **kw):
        super().__init__(db, rng, **kw)
        self.replication = replication

    async def check(self) -> bool:
        # drain in-flight relocations first (QuietDatabase.actor.cpp:1 —
        # checkConsistency quiets the database before reading replicas)
        from .quiet import quiet_database

        await quiet_database(self.db)
        for attempt in range(30):
            try:
                return await self._check_once()
            except (BrokenPromise, FdbError):
                # a relocation/recovery slipped in after the quiet: settle
                # and retry
                await delay(1.0)
        raise AssertionError("consistency check could not complete")

    async def _check_once(self) -> bool:
        tr = self.db.transaction()
        version = await tr.get_read_version()

        # walk the shard map
        shards = []
        key = b""
        while True:
            reply = await self.db._proxy_request(
                Tokens.GET_KEY_SERVERS, GetKeyServersRequest(key=key)
            )
            shards.append((reply.begin, reply.end, tuple(reply.team)))
            if reply.end is None:
                break
            key = reply.end

        # shard-map sanity: tiles the keyspace, teams are sane
        assert shards[0][0] == b"", shards[0]
        for (b1, e1, t1), (b2, _e2, _t2) in zip(shards, shards[1:]):
            assert e1 == b2, f"shard map gap/overlap at {e1!r} vs {b2!r}"
            assert len(t1) == len(set(t1)), f"duplicate replica in {t1}"
        assert shards[-1][1] is None
        if self.replication is not None:
            for b, _e, team in shards:
                assert len(team) == self.replication, (b, team)

        # replica equality per shard at one version
        for begin, end, team in shards:
            datas = []
            for addr in team:
                rows = []
                lo = begin
                while True:
                    req = GetKeyValuesRequest(
                        begin=lo,
                        end=end if end is not None else b"\xff\xff",
                        version=version,
                        limit=1000,
                    )
                    reply = await self.db.client.request(
                        Endpoint(addr, Tokens.GET_KEY_VALUES), req
                    )
                    rows.extend(reply.data)
                    if not reply.more:
                        break
                    lo = reply.data[-1][0] + b"\x00"
                datas.append(rows)
            for other in datas[1:]:
                assert other == datas[0], (
                    f"replica divergence in [{begin!r}, {end!r}) team {team}: "
                    f"{len(datas[0])} vs {len(other)} rows"
                )
        return True
