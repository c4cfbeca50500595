"""resolutionBalancing: move key-range boundaries between resolver roles
by observed load.

The analog of fdbserver/masterserver.actor.cpp:896 (resolutionBalancing)
+ Resolver.actor.cpp:276-284 (iops sampling + ResolutionSplitRequest):
the master polls every resolver's cumulative conflict-range op count,
and when the busiest outweighs the least busy by both an absolute and a
relative margin, asks the busiest for a split key carving off half the
difference from the edge adjacent to the least busy's range, then hands
the move to the version authority (Master.set_resolver_changes). The
moves piggyback on version grants (masterserver.actor.cpp:806 →
MasterProxyServer.actor.cpp:370), so every proxy applies them in its own
grant order at a definite version; during the MVCC transition window
proxies fan reads out to every era's owner (each still holds its era's
write history — verdicts stay exact, no fencing, no re-route race).

The balancer keeps its own view of the partition (it initiated every
move in this epoch; recovery resets both the map and the balancer).
"""

from __future__ import annotations

from ..kv.keyrange_map import KeyRangeMap
from ..net.sim import Endpoint
from ..runtime.futures import delay, wait_for_all
from ..runtime.loop import Cancelled


class ResolutionBalancer:
    def __init__(self, knobs, resolver_map: KeyRangeMap, master, proxy_ids):
        """``resolver_map``: the recruitment-time partition (copied);
        ``master``: the epoch's version authority (Master object — the
        balancer runs on the master's process, as in the reference);
        ``proxy_ids``: the uids proxies identify themselves with in
        getCommitVersion requests."""
        self.knobs = knobs
        self.map = KeyRangeMap()
        for b, e, v in resolver_map.ranges():
            self.map.insert(b, e, v)
        self.master = master
        self.proxy_ids = list(proxy_ids)
        self._last_ops: dict[tuple, int] = {}
        self.moves = 0  # observable: how many boundary moves recorded

    def _segments(self):
        """Contiguous (begin, end, iface) segments in key order."""
        return list(self.map.ranges())

    async def _poll(self, process):
        """{(addr, uid): ops since last poll} over current roles."""
        ifaces = {}
        for _b, _e, iface in self._segments():
            ifaces[(iface.address, iface.uid)] = iface
        futs, keys = [], []
        for key, iface in ifaces.items():
            futs.append(
                process.request(
                    Endpoint(
                        iface.address,
                        f"resolver.resolutionMetrics#{iface.uid}",
                    ),
                    None,
                )
            )
            keys.append(key)
        replies = await wait_for_all(futs)
        out = {}
        for key, rep in zip(keys, replies):
            total = rep["ops"]
            out[key] = total - self._last_ops.get(key, 0)
            self._last_ops[key] = total
        return out, ifaces

    async def step(self, process) -> bool:
        """One balancing pass; returns True if a move was recorded."""
        loads, ifaces = await self._poll(process)
        if len(loads) < 2:
            return False
        busiest = max(loads, key=loads.get)
        laziest = min(loads, key=loads.get)
        diff = loads[busiest] - loads[laziest]
        if diff < self.knobs.RESOLUTION_BALANCE_MIN_OPS:
            return False
        if loads[busiest] < self.knobs.RESOLUTION_BALANCE_RATIO * max(
            loads[laziest], 1
        ):
            return False

        # candidate segments of the busiest, preferring ones that ADJOIN a
        # segment of the laziest (shift the shared boundary); non-adjacent
        # segments follow as fallbacks (the map tolerates non-contiguous
        # ownership). Try candidates IN ORDER until one yields a usable
        # split — a cold adjacent segment with no sampled load must not
        # livelock the balancer while a hot non-adjacent one exists.
        segs = self._segments()
        adjacent, fallback = [], []
        for i, (b, e, iface) in enumerate(segs):
            if (iface.address, iface.uid) != busiest:
                continue
            if i > 0 and (
                segs[i - 1][2].address,
                segs[i - 1][2].uid,
            ) == laziest:
                adjacent.append((i, True))  # prefix joins the predecessor
            elif i + 1 < len(segs) and (
                segs[i + 1][2].address,
                segs[i + 1][2].uid,
            ) == laziest:
                adjacent.append((i, False))  # suffix joins the successor
            else:
                fallback.append((i, False))

        begin = end = src = key = front = None
        for i, fr in adjacent + fallback:
            b, e, s = segs[i]
            split = await process.request(
                Endpoint(s.address, f"resolver.splitPoint#{s.uid}"),
                {
                    "begin": b,
                    "end": e,
                    "front": fr,
                    "target_ops": diff // 2,
                },
            )
            k = split["key"]
            if k > b and (e is None or k < e):
                begin, end, src, key, front = b, e, s, k, fr
                break
        if key is None:
            return False  # no segment has a usable split

        dst = ifaces[laziest]
        if front:
            mv_begin, mv_end = begin, key
        else:
            mv_begin, mv_end = key, end
        if not self.master.set_resolver_changes(
            [(mv_begin, mv_end, dst)], self.proxy_ids
        ):
            return False  # previous set still being delivered
        self.map.insert(mv_begin, mv_end, dst)
        self.moves += 1
        from ..runtime.trace import SevInfo, trace

        trace(
            SevInfo,
            "ResolutionBalanced",
            getattr(process, "address", ""),
            Begin=mv_begin[:32],
            End=(mv_end or b"<inf>")[:32],
            From=f"{src.address}#{src.uid}",
            To=f"{dst.address}#{dst.uid}",
        )
        return True

    async def run(self, process) -> None:
        """The master-side actor: poll/balance forever."""
        from ..runtime.trace import SevWarn, trace

        failures = 0
        while True:
            await delay(self.knobs.RESOLUTION_BALANCING_INTERVAL)
            try:
                await self.step(process)
                failures = 0
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception as e:
                # a resolver mid-restart is survivable (recovery replaces
                # this balancer with the epoch), but PERSISTENT failure
                # means balancing is silently dead — give the operator a
                # signal, with backoff so it isn't per-interval spam
                failures += 1
                if failures in (3, 30, 300):
                    trace(
                        SevWarn,
                        "ResolutionBalancerFailing",
                        getattr(process, "address", ""),
                        Failures=failures,
                        Err=repr(e)[:200],
                    )
