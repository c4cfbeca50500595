"""LogRouter: the remote region's asynchronous log relay.

The analog of fdbserver/LogRouter.actor.cpp:391 (logRouterCore): each
router owns a slice of the storage tags, pulls their mutation streams from
the PRIMARY region's tag-partitioned log system (an ordinary cross-
generation PeekCursor with the "router" pop-consumer class, so primary
tlogs retain data until the remote region has relayed it), buffers them,
and re-serves tlog-SHAPED peek/pop endpoints — remote storage servers
follow a router exactly as they would a tlog, with the unmodified
PeekCursor machinery.

Memory is bounded: past ROUTER_BUFFER_BYTES of unacked payload per tag
the pull loop parks until remote storage pops (backpressure; the primary
tlogs then retain — and spill — on our behalf, which is exactly the
reference's behavior when a remote region falls behind).

The port's copy of ``foundationdb_tpu/server/log_router.py``.
"""

from __future__ import annotations

import bisect

from ..runtime.futures import AsyncVar, delay, wait_for_any
from ..runtime.knobs import Knobs
from ..runtime.stats import CounterCollection
from ..runtime.trace import SevInfo, trace
from .interfaces import TLogPeekReply, TLogPeekRequest, TLogPopRequest, Version
from .log_system import PeekCursor


class LogRouter:
    def __init__(
        self,
        knobs: Knobs = None,
        tags: tuple = (),
        epoch: int = 0,
        uid: str = "",
        log_config: AsyncVar = None,  # primary LogSystemConfig
        first_version: Version = 0,
    ):
        self.knobs = knobs or Knobs()
        self.tags = tuple(tags)
        self.epoch = epoch
        self.uid = uid
        self.log_config = log_config
        self.first_version = first_version
        self.process = None
        # per tag: ascending [(version, mutations)], parallel version list
        self._buf: dict[int, list] = {t: [] for t in self.tags}
        self._buf_versions: dict[int, list] = {t: [] for t in self.tags}
        self._buf_bytes: dict[int, int] = {t: 0 for t in self.tags}
        self._version: dict[int, AsyncVar] = {
            t: AsyncVar(first_version) for t in self.tags
        }
        self._popped: dict[int, Version] = {t: first_version for t in self.tags}
        self._cursors: dict[int, PeekCursor] = {}
        self.stats = CounterCollection("LogRouter", uid)
        self._c_relayed = self.stats.counter("versionsRelayed")
        self.stats.gauge(
            "minRelayed",
            lambda: min(
                (v.get() for v in self._version.values()), default=0
            ),
        )
        self.stats.gauge(
            "bufferBytes", lambda: sum(self._buf_bytes.values())
        )

    def relayed_version(self) -> Version:
        """Lowest relayed version across tags — the region's replication
        frontier (what _track_tlog_recovery waits on). A tagless router
        relays nothing, so its frontier is vacuously infinite."""
        return min((v.get() for v in self._version.values()), default=1 << 62)

    async def _pull(self, tag: int):
        cursor = PeekCursor(
            self.process, tag, self.log_config, consumer="router"
        )
        self._cursors[tag] = cursor
        begin = self.first_version
        while True:
            # backpressure: park while this tag's unacked buffer is full
            while self._buf_bytes[tag] > self.knobs.ROUTER_BUFFER_BYTES:
                await delay(0.1)
            msgs, end = await cursor.next(begin)
            for v, ms in msgs:
                if v <= begin:
                    continue
                self._buf[tag].append((v, ms))
                self._buf_versions[tag].append(v)
                self._buf_bytes[tag] += _rough_bytes(ms)
            if end > self._version[tag].get():
                self._version[tag].set(end)
                self._c_relayed.add()
            begin = max(begin, end)

    # -- tlog-shaped service ---------------------------------------------------

    async def peek(self, req: TLogPeekRequest) -> TLogPeekReply:
        tag = req.tag
        if tag not in self._buf:
            return TLogPeekReply(messages=[], end_version=0)
        while self._version[tag].get() < req.begin:
            await self._version[tag].on_change()
        ver = self._version[tag].get()
        i = bisect.bisect_left(self._buf_versions[tag], req.begin)
        out = [(v, ms) for v, ms in self._buf[tag][i:] if v <= ver]
        return TLogPeekReply(messages=out, end_version=ver)

    async def pop(self, req: TLogPopRequest):
        tag = req.tag
        if tag not in self._buf or req.upto <= self._popped[tag]:
            return None
        self._popped[tag] = req.upto
        keep = bisect.bisect_right(self._buf_versions[tag], req.upto)
        dropped = self._buf[tag][:keep]
        self._buf[tag] = self._buf[tag][keep:]
        self._buf_versions[tag] = self._buf_versions[tag][keep:]
        self._buf_bytes[tag] -= sum(_rough_bytes(ms) for _v, ms in dropped)
        # release the primary's retention for this tag
        cursor = self._cursors.get(tag)
        if cursor is not None:
            await cursor.pop(req.upto)
        return None

    async def _get_version(self, _req):
        return self.relayed_version()

    async def _metrics(self, _req) -> dict:
        return self.stats.snapshot()

    def register_instance(self, process) -> None:
        """tlog-shaped tokens: remote storage's PeekCursor needs no
        special casing to follow a router."""
        self.process = process
        process.register(f"tlog.peek#{self.uid}", self.peek)
        process.register(f"tlog.pop#{self.uid}", self.pop)
        process.register(f"tlog.ping#{self.uid}", self._ping)
        process.register(f"router.version#{self.uid}", self._get_version)
        process.register(f"router.metrics#{self.uid}", self._metrics)
        trace(
            SevInfo,
            "LogRouterUp",
            process.address,
            Uid=self.uid,
            Tags=list(self.tags),
        )

    async def _ping(self, _req):
        return "pong"


def _rough_bytes(ms) -> int:
    try:
        return sum(
            len(m.param1) + len(m.param2 or b"") + 9 for m in ms
        )
    except Exception:
        return 64
