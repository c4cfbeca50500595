"""Async file I/O: the durability substrate, virtualized for simulation.

The analog of fdbrpc/IAsyncFile.h with its two personalities:

- ``SimFile`` — the simulator's file (AsyncFileNonDurable.actor.h): writes
  land in an unsynced overlay with modeled latency; ``sync()`` promotes
  them to durable content; a process kill DROPS (or partially applies —
  the corruption model of :460-505) everything unsynced. Files live in
  the machine's ``SimDisk`` and survive reboot, which is exactly what
  makes restart tests meaningful.
- ``RealFile`` — plain OS files (AsyncFileEIO's job); used outside the
  simulator (benchmarks, the native engine's siblings).

Only whole-value page semantics are needed by the engines here (DiskQueue
pages, snapshot blobs), so the API is a minimal subset: read / write /
truncate / sync / size.
"""

from __future__ import annotations

import os

from ..runtime.futures import delay


class DiskFault(IOError):
    """An injected io_error or disk-full (flow/FaultInjection.h:26,
    sim2.actor.cpp:676 SimDiskSpace). Surfaces from SimFile ops; the
    owning role treats it like any fatal disk error (role death →
    recovery replaces it)."""


class SimDisk:
    """All files of one simulated machine; survives process reboot."""

    def __init__(self, sim, machine: str):
        self.sim = sim
        self.machine = machine
        self.files: dict[str, "SimFile"] = {}
        # fault injection (machine-scoped, like the reference's per-
        # machine io_error injection): probability an op raises, and an
        # optional capacity that makes writes past it fail as disk-full
        self.io_error_p = 0.0
        self.capacity: int = None

    def open(self, path: str) -> "SimFile":
        f = self.files.get(path)
        if f is None:
            f = self.files[path] = SimFile(self.sim, path, disk=self)
        return f

    def total_bytes(self) -> int:
        return sum(f.size() for f in self.files.values())

    def inject_io_errors(self, p: float) -> None:
        """Arm (p > 0) or disarm per-op io_error injection."""
        self.io_error_p = p

    def set_capacity(self, capacity) -> None:
        """None = unlimited; otherwise writes that would grow the disk
        past ``capacity`` bytes raise disk-full."""
        self.capacity = capacity

    def _maybe_fault(self, grew: int = 0) -> None:
        if (
            self.io_error_p > 0.0
            and self.sim.loop.random.coinflip(self.io_error_p)
        ):
            raise DiskFault(f"injected io_error on {self.machine}")
        if (
            grew > 0
            and self.capacity is not None
            and self.total_bytes() + grew > self.capacity
        ):
            raise DiskFault(f"disk full on {self.machine}")

    def exists(self, path: str) -> bool:
        return path in self.files

    def list(self) -> list[str]:
        return sorted(self.files)

    def remove(self, path: str) -> None:
        self.files.pop(path, None)

    def on_kill(self) -> None:
        """Machine kill: unsynced writes are lost — and, buggify-style,
        a random prefix of them may have reached the platter
        (AsyncFileNonDurable:460-505's KILLED mode)."""
        rng = self.sim.loop.random
        for f in self.files.values():
            f.lose_unsynced(rng)


class SimFile:
    SYNC_TIME = 0.0005  # defaults; knobs SIM_FILE_SYNC_TIME/_WRITE_TIME
    WRITE_TIME = 0.00005

    def _sync_time(self):
        k = getattr(self.sim, "knobs", None)
        return getattr(k, "SIM_FILE_SYNC_TIME", self.SYNC_TIME)

    def _write_time(self):
        k = getattr(self.sim, "knobs", None)
        return getattr(k, "SIM_FILE_WRITE_TIME", self.WRITE_TIME)

    def __init__(self, sim, path: str, disk: "SimDisk" = None):
        self.sim = sim
        self.path = path
        self.disk = disk
        self._durable = bytearray()
        # unsynced ops in submission order: ("write", offset, bytes) |
        # ("trunc", size). One ordered list, replayed in sequence, so a
        # truncate never retroactively clips a write submitted after it and a
        # write submitted before a truncate never resurrects bytes beyond it —
        # orderings a real disk can't produce.
        self._pending_ops: list[tuple] = []

    # -- IAsyncFile ------------------------------------------------------------

    def _fault(self, grew: int = 0) -> None:
        if self.disk is not None:
            self.disk._maybe_fault(grew)

    async def write(self, offset: int, data: bytes) -> None:
        await delay(self._write_time())
        if self.disk is not None and self.disk.capacity is not None:
            # size() replays every pending op — only pay for it when a
            # disk-full window is actually armed
            self._fault(grew=max(0, offset + len(data) - self.size()))
        else:
            self._fault()
        self._pending_ops.append(("write", offset, bytes(data)))

    async def read(self, offset: int, length: int) -> bytes:
        await delay(self._write_time())
        self._fault()
        img = self._image()
        return bytes(img[offset : offset + length])

    async def sync(self) -> None:
        await delay(self._sync_time())
        self._fault()
        self._durable = self._image()
        self._pending_ops = []

    async def truncate(self, size: int) -> None:
        await delay(self._write_time())
        self._fault()
        self._pending_ops.append(("trunc", size))

    def size(self) -> int:
        return len(self._image())

    # -- sim internals ---------------------------------------------------------

    def _image(self) -> bytearray:
        img = bytearray(self._durable)
        for op in self._pending_ops:
            if op[0] == "write":
                _, offset, data = op
                if len(img) < offset:
                    img.extend(b"\x00" * (offset - len(img)))
                img[offset : offset + len(data)] = data
            else:
                del img[op[1] :]
        return img

    def lose_unsynced(self, rng) -> None:
        """Kill semantics: each unsynced op independently may or may not
        have hit the disk (the nondurable file's page-wise coinflip),
        replayed in submission order so surviving ops keep their sequencing."""
        self._pending_ops = [op for op in self._pending_ops if rng.coinflip(0.5)]
        self._durable = self._image()
        self._pending_ops = []


class RealDisk:
    """OS directory as a disk (for benches and the native engine path)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def open(self, path: str) -> "RealFile":
        return RealFile(os.path.join(self.root, path))

    def exists(self, path: str) -> bool:
        return os.path.exists(os.path.join(self.root, path))

    def list(self) -> list[str]:
        return sorted(os.listdir(self.root))

    def remove(self, path: str) -> None:
        p = os.path.join(self.root, path)
        if os.path.exists(p):
            os.unlink(p)


class RealFile:
    def __init__(self, path: str):
        self.path = path
        flags = os.O_RDWR | os.O_CREAT
        self._fd = os.open(path, flags, 0o644)

    async def write(self, offset: int, data: bytes) -> None:
        os.pwrite(self._fd, data, offset)

    async def read(self, offset: int, length: int) -> bytes:
        return os.pread(self._fd, length, offset)

    async def sync(self) -> None:
        os.fsync(self._fd)

    async def truncate(self, size: int) -> None:
        os.ftruncate(self._fd, size)

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def close(self) -> None:
        os.close(self._fd)
