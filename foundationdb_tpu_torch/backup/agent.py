"""Backup and DR agents.

BackupAgent — the analog of fdbclient/FileBackupAgent.actor.cpp: a backup
is (1) a mutation-log capture registered under \\xff/logRanges/ (the
proxies duplicate committed mutations into the \\xff\\x02 backup-log
keyspace from that moment), then (2) a consistent range snapshot taken
chunk-by-chunk through TaskBucket tasks, while (3) a drain loop moves the
accumulating log keyspace into the container. Because the capture starts
BEFORE the snapshot version, snapshot + log replay reconstructs any
version ≥ the snapshot's — the reference's restorability invariant.

DrAgent — the analog of fdbclient/DatabaseBackupAgent.actor.cpp: the same
capture machinery, but the drain applies mutations to a second cluster
instead of files, giving asynchronous cluster-to-cluster replication.

Restore replays container contents: clear the range, load the snapshot,
apply the mutation log in version order (fdbrestore).
"""

from __future__ import annotations

import struct

from ..kv.mutations import Mutation, MutationType
from ..layers.subspace import Subspace
from ..layers.taskbucket import TaskBucket, run_agent
from ..runtime.futures import Future, delay
from ..runtime.serialize import BinaryReader, read_mutation
from ..server.systemdata import (
    BACKUP_LOG_PREFIX,
    log_ranges_key,
    log_ranges_value,
)

SNAPSHOT_CHUNK_ROWS = 1000
DRAIN_BATCH = 500


class _CaptureBase:
    def __init__(self, db, uid: str, begin: bytes = b"", end=b"\xff"):
        self.db = db
        self.uid = uid
        self.begin = begin
        self.end = end
        self.dest = BACKUP_LOG_PREFIX + uid.encode() + b"/"
        self.stopped = Future()

    async def _start_capture(self) -> None:
        async def body(tr):
            tr.set(
                log_ranges_key(self.uid),
                log_ranges_value(self.begin, self.end, self.dest),
            )

        await self.db.run(body)

    async def _stop_capture(self) -> None:
        async def body(tr):
            tr.clear(log_ranges_key(self.uid))

        await self.db.run(body)

    async def _drain_chunk(self):
        """Pop up to DRAIN_BATCH captured log entries, in version order."""

        async def body(tr):
            rows = await tr.get_range(
                self.dest, self.dest + b"\xff", limit=DRAIN_BATCH
            )
            for k, _v in rows:
                tr.clear(k)
            return rows

        return await self.db.run(body)


class BackupAgent(_CaptureBase):
    def __init__(self, db, container, uid: str = "backup", begin=b"", end=b"\xff"):
        super().__init__(db, uid, begin, end)
        self.container = container
        self.bucket = TaskBucket(
            Subspace(raw_prefix=b"\xff\x02/tasks/" + uid.encode() + b"/")
        )
        self._drainer = None
        self._worker = None

    async def submit(self) -> None:
        """Start the backup: begin the capture, queue snapshot tasks, and
        run the drain + task agents (submitBackup + the agent loops)."""
        await self.container.reset()  # stale files of a prior same-name run
        await self._start_capture()
        # snapshot version: one consistent cut ≥ capture start; every
        # chunk task reads AT this version (a per-chunk version would make
        # the log-replay boundary ill-defined and double-apply atomics)
        async def snap_meta(tr):
            await tr.get_read_version()
            return tr._read_version

        snapshot_version = await self.db.run(snap_meta)
        self._snapshot_version = snapshot_version
        await self.container.write_meta(
            {
                "uid": self.uid,
                "begin": self.begin.hex(),
                "end": self.end.hex() if self.end is not None else "inf",
                "snapshot_version": snapshot_version,
                "complete_through": None,
            }
        )

        async def queue_task(tr):
            await self.bucket.add_task(
                tr, "snapshot_chunk", begin=self.begin.hex(), index=0
            )

        await self.db.run(queue_task)
        self._worker = self.db.client.spawn(
            run_agent(
                self.db,
                self.bucket,
                {"snapshot_chunk": self._snapshot_chunk},
                self.stopped,
            )
        )
        self._drainer = self.db.client.spawn(self._drain_loop())

    async def _snapshot_chunk(self, db, params) -> None:
        """One chunked range dump at the backup's snapshot version; queues
        its successor (the reference's BackupRangeTaskFunc splitting)."""
        begin = bytes.fromhex(params["begin"])
        index = int(params["index"])

        async def body(tr):
            tr.set_read_version(self._snapshot_version)
            rows = await tr.get_range(
                begin, self.end, limit=SNAPSHOT_CHUNK_ROWS, snapshot=True
            )
            return rows

        rows = await db.run(body)
        await self.container.write_snapshot_chunk(index, rows)
        if len(rows) >= SNAPSHOT_CHUNK_ROWS:
            nxt = rows[-1][0] + b"\x00"

            async def queue_next(tr):
                await self.bucket.add_task(
                    tr, "snapshot_chunk", begin=nxt.hex(), index=index + 1
                )

            await db.run(queue_next)

    async def _drain_loop(self) -> None:
        while not self.stopped.is_ready():
            rows = await self._drain_chunk()
            if rows:
                await self.container.append_log_chunk(rows)
            else:
                await delay(0.5)

    async def wait_snapshot_complete(self, timeout_s: float = 300.0) -> None:
        waited = 0.0
        while not await self.bucket.is_empty(self.db):
            await delay(0.5)
            waited += 0.5
            if waited > timeout_s:
                raise TimeoutError("snapshot tasks did not finish")

    async def discontinue(self) -> None:
        """Stop the backup: end the capture, drain the tail, close out
        (discontinueBackup)."""
        await self._stop_capture()
        while True:
            rows = await self._drain_chunk()
            if not rows:
                break
            await self.container.append_log_chunk(rows)
        self.stopped._set(None)
        meta = await self.container.read_meta()
        meta["complete_through"] = "end"
        await self.container.write_meta(meta)


def _log_entry_version(log_key: bytes) -> int:
    """The commit version embedded in a backup-log key (…<8B version><4B n>)."""
    return struct.unpack(">Q", log_key[-12:-4])[0]


async def restore(db, container) -> int:
    """fdbrestore: clear the target range, load the snapshot, replay the
    mutation log in version order. Log entries at or below the snapshot
    version are already reflected in the snapshot and must be skipped —
    replaying them would double-apply non-idempotent atomic ops. Returns
    rows restored."""
    meta = await container.read_meta()
    begin = bytes.fromhex(meta["begin"])
    end = b"\xff" if meta["end"] == "inf" else bytes.fromhex(meta["end"])
    snapshot_version = meta.get("snapshot_version", 0)
    snapshot = await container.read_snapshot()
    log = [
        (k, v)
        for k, v in await container.read_log()
        if _log_entry_version(k) > snapshot_version
    ]

    async def clear_body(tr):
        tr.clear_range(begin, end)

    await db.run(clear_body)

    for i in range(0, len(snapshot), 500):
        chunk = snapshot[i : i + 500]

        async def load(tr, chunk=chunk):
            for k, v in chunk:
                tr.set(k, v)

        await db.run(load)

    for i in range(0, len(log), 500):
        chunk = log[i : i + 500]

        async def apply(tr, chunk=chunk):
            for _log_key, blob in chunk:
                m = read_mutation(BinaryReader(blob))
                _apply_to_txn(tr, m)

        await db.run(apply)
    # rows loaded + log mutations replayed (a backup begun before any
    # write has an EMPTY snapshot and everything in the log)
    return len(snapshot) + len(log)


def _apply_to_txn(tr, m: Mutation) -> None:
    if m.type == MutationType.SET_VALUE:
        tr.set(m.param1, m.param2)
    elif m.type == MutationType.CLEAR_RANGE:
        tr.clear_range(m.param1, m.param2)
    else:
        tr.atomic_op(m.type, m.param1, m.param2)


class DrAgent(_CaptureBase):
    """Asynchronous replication into a destination cluster: capture on the
    source, apply on the destination (DatabaseBackupAgent)."""

    def __init__(self, src_db, dest_db, uid: str = "dr", begin=b"", end=b"\xff"):
        super().__init__(src_db, uid, begin, end)
        self.dest_db = dest_db
        self._runner = None

    async def start(self, initial_sync: bool = True) -> None:
        await self._start_capture()
        self._sync_version = 0
        if initial_sync:
            # seed the destination with ONE consistent snapshot (the DR
            # "backup" phase): a single source transaction so every row is
            # from the same version; captured entries at or below it are
            # already included and must not re-apply (atomics!)
            async def read_all(tr):
                rows = await tr.get_range(self.begin, self.end, snapshot=True)
                return tr._read_version, rows

            self._sync_version, rows = await self.db.run(read_all)
            for i in range(0, len(rows), SNAPSHOT_CHUNK_ROWS):
                chunk = rows[i : i + SNAPSHOT_CHUNK_ROWS]

                async def write(tr, chunk=chunk):
                    for k, v in chunk:
                        tr.set(k, v)

                await self.dest_db.run(write)
        self._runner = self.db.client.spawn(self._apply_loop())

    async def _apply_rows(self, rows) -> None:
        rows = [
            (k, blob)
            for k, blob in rows
            if _log_entry_version(k) > self._sync_version
        ]
        if not rows:
            return

        async def apply(tr, rows=rows):
            for _k, blob in rows:
                m = read_mutation(BinaryReader(blob))
                _apply_to_txn(tr, m)

        await self.dest_db.run(apply)

    async def _apply_loop(self) -> None:
        while not self.stopped.is_ready():
            rows = await self._drain_chunk()
            if not rows:
                await delay(0.5)
                continue
            await self._apply_rows(rows)

    async def stop(self) -> None:
        await self._stop_capture()
        # final drain
        while True:
            rows = await self._drain_chunk()
            if not rows:
                break
            await self._apply_rows(rows)
        self.stopped._set(None)
