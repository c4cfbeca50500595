"""BackupContainer: where backups live.

The analog of fdbclient/BackupContainer.actor.cpp: an abstraction over the
backup destination holding range-snapshot files, mutation-log files, and a
metadata document. Backed by a SimDisk (deterministic tests) or a RealDisk
directory (the `file://` container of the reference; a blob-store backend
slots in behind the same interface)."""

from __future__ import annotations

import json

from ..runtime.serialize import BinaryReader, BinaryWriter


class BackupContainer:
    def __init__(self, disk, name: str):
        self.disk = disk
        self.name = name
        # continue after existing log files — two container handles on the
        # same backup must not overwrite each other's chunks
        self._log_seq = 0
        for fname in self.disk.list():
            if fname.startswith(f"{name}.log."):
                self._log_seq = max(
                    self._log_seq, int(fname.rsplit(".", 1)[1]) + 1
                )

    async def reset(self) -> None:
        """Delete every file of this backup (a fresh submit must not merge
        with a previous same-name run's chunks at restore time)."""
        for fname in list(self.disk.list()):
            if fname.startswith(f"{self.name}."):
                self.disk.remove(fname)
        self._log_seq = 0

    # -- metadata --------------------------------------------------------------

    async def write_meta(self, meta: dict) -> None:
        f = self.disk.open(f"{self.name}.meta.json")
        blob = json.dumps(meta).encode()
        await f.truncate(0)
        await f.write(0, blob)
        await f.sync()

    async def read_meta(self) -> dict:
        f = self.disk.open(f"{self.name}.meta.json")
        raw = await f.read(0, f.size())
        return json.loads(raw.decode()) if raw else {}

    # -- range snapshot files --------------------------------------------------

    async def write_snapshot_chunk(self, index: int, rows: list) -> None:
        w = BinaryWriter()
        w.u32(len(rows))
        for k, v in rows:
            w.bytes_(k).bytes_(v)
        f = self.disk.open(f"{self.name}.snap.{index:06d}")
        await f.truncate(0)
        await f.write(0, w.data())
        await f.sync()

    async def read_snapshot(self) -> list:
        rows = []
        for fname in sorted(self.disk.list()):
            if not fname.startswith(f"{self.name}.snap."):
                continue
            f = self.disk.open(fname)
            r = BinaryReader(await f.read(0, f.size()))
            n = r.u32()
            for _ in range(n):
                rows.append((r.bytes_(), r.bytes_()))
        return rows

    # -- mutation-log files ----------------------------------------------------

    async def append_log_chunk(self, entries: list) -> None:
        """entries: [(log_key, serialized_mutation)] in key (version) order."""
        w = BinaryWriter()
        w.u32(len(entries))
        for k, v in entries:
            w.bytes_(k).bytes_(v)
        f = self.disk.open(f"{self.name}.log.{self._log_seq:06d}")
        self._log_seq += 1
        await f.truncate(0)
        await f.write(0, w.data())
        await f.sync()

    async def read_log(self) -> list:
        entries = []
        for fname in sorted(self.disk.list()):
            if not fname.startswith(f"{self.name}.log."):
                continue
            f = self.disk.open(fname)
            r = BinaryReader(await f.read(0, f.size()))
            n = r.u32()
            for _ in range(n):
                entries.append((r.bytes_(), r.bytes_()))
        entries.sort()  # log keys embed the version: sorts into commit order
        return entries
