"""Sideband workload: external (causal) consistency.

The analog of fdbserver/workloads/Sideband.actor.cpp: a mutator commits a
key, then tells a checker out-of-band. The checker's subsequently-started
transaction MUST see the key — if its GRV could lag the reported commit
version, causality is broken (the getLiveCommittedVersion guarantee the
proxy/master pair provides).
"""

from __future__ import annotations

from ..errors import CommitUnknownResult, FdbError
from ..runtime.futures import PromiseStream, StreamClosed
from . import Workload


class SidebandWorkload(Workload):
    def __init__(
        self, db, rng, messages=25, prefix=b"sideband/", checker_db=None, **kw
    ):
        super().__init__(db, rng, **kw)
        self.messages = messages
        self.prefix = prefix
        # the checker reads through its own client (and so its own proxy
        # choices) — causality must hold *across* clients, not just within
        # one client's GRV stream
        self.checker_db = checker_db or db
        self.stream: PromiseStream = PromiseStream()
        self.checked = 0

    async def _mutator(self):
        for i in range(self.messages):
            key = self.prefix + b"%04d" % i
            while True:
                tr = self.db.transaction()
                tr.set(key, b"sent")
                try:
                    version = await tr.commit()
                    break
                except CommitUnknownResult:
                    # did it land? A read that sees the key gives a read
                    # version ≥ the commit version — a valid (stronger)
                    # causality bound to report to the checker
                    async def probe(t):
                        return await t.get(key), await t.get_read_version()

                    got, rv = await self.db.run(probe)
                    if got == b"sent":
                        version = rv
                        break
                except FdbError as e:
                    await tr.on_error(e)
            self.stream.send((i, version))
        self.stream.close()

    async def _checker(self):
        while True:
            try:
                i, version = await self.stream.next()
            except StreamClosed:
                return
            tr = self.checker_db.transaction()
            got = await tr.get(self.prefix + b"%04d" % i)
            assert got == b"sent", (
                f"causality violation: message {i} committed at {version} "
                f"but invisible at read version {tr._read_version}"
            )
            assert tr._read_version >= version
            self.checked += 1

    async def start(self):
        from ..runtime.futures import spawn, wait_for_all

        await wait_for_all([spawn(self._mutator()), spawn(self._checker())])

    async def check(self) -> bool:
        return self.checked == self.messages
