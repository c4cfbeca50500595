"""BackupToFile workload: a backup taken DURING concurrent traffic (and
whatever fault workloads share the spec) restores every acknowledged
write.

The analog of fdbserver/workloads/BackupCorrectness: submit a continuous
backup, keep writing while the snapshot runs, discontinue, snapshot the
source truth, restore, and compare byte-for-byte."""

from __future__ import annotations

from . import Workload
from ..backup import BackupAgent, BackupContainer
from ..backup.agent import restore
from ..runtime.futures import delay


class BackupWorkload(Workload):
    def __init__(
        self,
        db,
        rng,
        sim=None,
        writes=30,
        prefix=b"bk/",
        container_url=None,  # e.g. "blobstore://blobhost:80/bk/soak"
        **kw,
    ):
        super().__init__(db, rng, **kw)
        self.sim = sim
        self.writes = writes
        self.prefix = prefix
        self.container_url = container_url
        self.ok = False

    def _make_container(self):
        """Parameterized over the container scheme
        (fdbclient/BackupContainer.actor.cpp:1 URL dispatch): the default
        file-style disk container, or a blobstore:// target whose HTTP
        bytes ride the sim network."""
        if self.container_url:
            from ..backup.blobstore import open_container

            return open_container(
                self.container_url,
                sim=self.sim,
                process=self.db.client,
            )
        return BackupContainer(
            self.sim.disk("backup-workload-store"), "soak"
        )

    async def start(self):
        container = self._make_container()
        # capture ONLY our prefix: a whole-keyspace restore would roll
        # back concurrent workloads' later writes
        agent = BackupAgent(
            self.db,
            container,
            uid="soak",
            begin=self.prefix,
            end=self.prefix + b"\xff",
        )
        await agent.submit()
        for i in range(self.writes):

            async def w(tr, i=i):
                tr.set(self.prefix + b"k%04d" % i, b"v%d" % i)
                if i and self.rng.coinflip(0.2):
                    tr.clear(self.prefix + b"k%04d" % (i - 1))

            await self.db.run(w)
            if self.rng.coinflip(0.2):
                await delay(0.05)
        await agent.wait_snapshot_complete()
        await agent.discontinue()

        async def snap(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff")

        source = await self.db.run(snap)
        await restore(self.db, container)
        restored = await self.db.run(snap)
        if restored != source:
            print(
                f"Backup: restore mismatch {len(restored)} vs "
                f"{len(source)} rows"
            )
            return
        self.ok = True

    async def check(self) -> bool:
        return self.ok
