"""DiskQueue: the durable push/pop queue under the TLog and the memory
storage engine.

The analog of fdbserver/DiskQueue.actor.cpp: an append-only entry log with
per-entry CRC framing, an atomically-updated meta record holding the popped
frontier, and crash recovery that replays valid entries and discards any
torn tail (the reference's checksummed two-file ring; here one data file
per generation with copy-compaction when the popped prefix dominates,
which preserves the same guarantees on the IAsyncFile model).

Durability contract (what the TLog's commit ack means):
- ``push()`` buffers; ``commit()`` writes + fsyncs — after commit returns,
  every pushed entry survives a kill.
- ``pop(upto)`` logically discards entries with offset < upto; persisted
  with the next commit; compaction reclaims space by copying the live
  suffix into a fresh file and atomically switching the meta record.
- ``recover()`` returns [(offset, payload)] of all live entries, stopping
  at the first bad CRC (a torn write from a kill — everything before it
  was acknowledged, everything after never was).
"""

from __future__ import annotations

import struct
import zlib

from ..runtime.futures import Future

_META_MAGIC = b"FDBQMETA"
_ENTRY_HDR = struct.Struct("<II")  # length, crc32


class DiskQueue:
    def __init__(self, disk, name: str):
        self.disk = disk
        self.name = name
        self._meta = disk.open(f"{name}.meta")
        self._file = None
        self._file_id = 0
        self._popped = 0  # offset: entries below are discarded
        self._end = 0  # append position (committed + buffered)
        self._buffer: list[bytes] = []
        self._buffer_base = 0
        self._pop_dirty = False
        self._push_gen = 0  # bumped per push; compaction aborts if raced
        self._flip_pending = None  # Future while a compaction meta-flip runs
        # group commit: concurrent commit() callers coalesce —
        # one physical write+fsync round covers every caller whose pushes
        # and pops it observed; followers whose work the round made
        # durable return without their own fsync
        self._commit_active = None  # Future while a commit round runs
        self._durable_end = 0  # highest append offset a round made durable
        self._durable_pop = 0  # highest popped frontier made durable
        self.commits = 0  # physical write+fsync rounds
        self.group_joins = 0  # commit() calls satisfied by another round
        self.fsync_seconds = 0.0  # cumulative time inside write+fsync rounds

    # -- recovery --------------------------------------------------------------

    async def recover(self) -> list[tuple[int, bytes]]:
        """Open (or create) the queue; return live [(offset, payload)]."""
        meta = await self._meta.read(0, 64)
        if len(meta) >= 28 and meta[:8] == _META_MAGIC:
            (crc,) = struct.unpack_from("<I", meta, 24)
            if crc == zlib.crc32(meta[:24]):
                self._file_id, self._popped = struct.unpack_from("<QQ", meta, 8)
        self._file = self.disk.open(f"{self.name}.{self._file_id}.data")
        raw = await self._file.read(0, self._file.size())
        out: list[tuple[int, bytes]] = []
        pos = 0
        while pos + _ENTRY_HDR.size <= len(raw):
            length, crc = _ENTRY_HDR.unpack_from(raw, pos)
            payload = raw[pos + _ENTRY_HDR.size : pos + _ENTRY_HDR.size + length]
            if len(payload) < length or zlib.crc32(payload) != crc:
                break  # torn tail from a kill: never acknowledged
            if pos >= self._popped:
                out.append((pos, payload))
            pos += _ENTRY_HDR.size + length
        self._buffer_base = pos
        # entries pushed before recovery (lazy first-commit open) keep
        # their relative offsets above the recovered end
        shift = pos - 0
        if self._buffer and shift:
            raise AssertionError("pushes preceded recovery of a non-empty queue")
        self._end = pos + sum(len(b) for b in self._buffer)
        await self._file.truncate(pos)  # drop the torn tail for clean appends
        return out

    # -- operation -------------------------------------------------------------

    def push(self, payload: bytes) -> int:
        """Queue an entry; returns its offset (valid after next commit)."""
        self._push_gen += 1
        offset = self._end
        self._buffer.append(
            _ENTRY_HDR.pack(len(payload), zlib.crc32(payload)) + payload
        )
        self._end += _ENTRY_HDR.size + len(payload)
        return offset

    async def commit(self) -> None:
        """Make all pushed entries (and any pop) durable.

        Group-committed: while a round's write+fsync is in flight, later
        callers park on it; a caller whose pushes/pops the finished round
        covered returns WITHOUT another fsync (N concurrent committers →
        a bounded number of fsync rounds, not N). The durability contract
        is unchanged: after commit() returns, everything pushed before
        the call survives a kill."""
        from ..runtime.buggify import buggify
        from ..runtime.futures import Future, delay

        if buggify():
            await delay(0.002)  # slow fsync (stalls the commit quorum)
        target_end = self._end
        target_pop = self._popped
        while self._commit_active is not None:
            await self._commit_active
            if (
                self._durable_end >= target_end
                and self._durable_pop >= target_pop
            ):
                self.group_joins += 1
                return
        self._commit_active = Future()
        try:
            while self._flip_pending is not None:
                # a compaction has swapped files but not yet flipped the meta
                # record: committing (and acking!) into the new file before
                # the flip is durable would lose the entry if we crash with
                # the meta still naming the old file
                await self._flip_pending
            if self._file is None:
                # lazy open for a freshly created queue (first commit wins;
                # the tlog's version gate serializes callers)
                await self.recover()
            from ..runtime.loop import now

            t0 = now()
            end_now = self._end
            pop_now = self._popped
            if self._buffer:
                blob = b"".join(self._buffer)
                base = self._buffer_base
                self._buffer = []
                self._buffer_base = self._end
                await self._file.write(base, blob)
            await self._file.sync()
            if self._pop_dirty:
                await self._write_meta()
                self._pop_dirty = False
            self._durable_end = max(self._durable_end, end_now)
            self._durable_pop = max(self._durable_pop, pop_now)
            self.commits += 1
            self.fsync_seconds += now() - t0
        finally:
            done, self._commit_active = self._commit_active, None
            done._set(None)

    async def read_entry(self, offset: int, end: int) -> bytes:
        """Read back one pushed entry by its [offset, end) coordinates —
        the tlog's spill-by-reference path (spilled payloads live only
        here). CRC-checked; the entry must have been committed."""
        raw = await self._file.read(offset, end - offset)
        length, crc = _ENTRY_HDR.unpack_from(raw, 0)
        payload = raw[_ENTRY_HDR.size : _ENTRY_HDR.size + length]
        if len(payload) != length or zlib.crc32(payload) != crc:
            raise IOError(f"diskqueue {self.name}: bad entry at {offset}")
        return payload

    def pop(self, upto_offset: int) -> None:
        if upto_offset > self._popped:
            self._popped = upto_offset
            self._pop_dirty = True

    async def compact(self) -> int:
        """Reclaim the popped prefix: copy live data to a fresh file, then
        atomically switch the meta record (write-new-then-flip ordering).
        Returns the offset shift applied (0 if nothing happened) so
        callers can rebase any offsets they cached."""
        if (
            self._popped == 0
            or self._buffer
            or self._flip_pending is not None
            or self._commit_active is not None
        ):
            # an in-flight commit round holds a reference into the current
            # file; swapping under its write/sync awaits could land an
            # acked entry only in the about-to-be-removed file
            return 0
        gen = self._push_gen
        live = await self._file.read(0, self._file.size())
        live = live[self._popped :]
        new_id = self._file_id + 1
        new_file = self.disk.open(f"{self.name}.{new_id}.data")
        await new_file.truncate(0)
        if live:
            await new_file.write(0, live)
        await new_file.sync()
        if self._push_gen != gen:
            # a push raced our copy; its offset assumes the old layout —
            # abandon this compaction attempt (the file is retried later)
            self.disk.remove(f"{self.name}.{new_id}.data")
            return 0
        # swap synchronously (no awaits until the meta flip below): pushes
        # from here on use new-file coordinates and commit() blocks on the
        # flip, so nothing acked can land only in an unreachable file
        old_id, shift = self._file_id, self._popped
        self._file_id, self._popped = new_id, 0
        self._end -= shift
        self._buffer_base -= shift
        self._durable_end = max(0, self._durable_end - shift)
        self._durable_pop = 0
        self._file = new_file
        self._flip_pending = Future()
        try:
            await self._write_meta()  # the flip: synced meta names new file
        finally:
            flip, self._flip_pending = self._flip_pending, None
            flip._set(None)
        self.disk.remove(f"{self.name}.{old_id}.data")
        return shift

    async def _write_meta(self) -> None:
        body = _META_MAGIC + struct.pack("<QQ", self._file_id, self._popped)
        blob = body + struct.pack("<I", zlib.crc32(body))
        await self._meta.write(0, blob)
        await self._meta.sync()

    @property
    def popped_offset(self) -> int:
        return self._popped

    @property
    def bytes_used(self) -> int:
        return self._end - self._popped
