"""Coordinators: generation register, leader election, coordinated state.

The analog of fdbserver/Coordination.actor.cpp (localGenerationReg:125,
leaderRegister:203, coordinationServer:413), LeaderElection.actor.cpp
(tryBecomeLeaderInternal:78) and CoordinatedState.actor.cpp
(CoordinatedStateImpl:59). These are the only majority-quorum protocols in
the system; everything else fences through them:

- **Generation register** — a per-key Paxos-register-style cell. ``read(gen)``
  raises the register's read generation; ``write(gen, value)`` succeeds only
  if no higher read generation has been seen. A new master adopting a higher
  generation therefore *fences* any older master's pending writes at a
  majority of coordinators.
- **Leader register** — candidates keep their candidacy alive by re-polling;
  each coordinator nominates the best live candidate; a candidate that sees
  itself nominated by a majority is the leader (here: the cluster
  controller). Lease expiry (no re-poll) drops a dead leader.
- **CoordinatedState** — read/write of the DBCoreState blob through a
  majority of generation registers, the mechanism that makes master
  recovery exclusive (masterserver.actor.cpp READING/WRITING_CSTATE).

The port's copy of ``foundationdb_tpu/server/coordination.py``: the same
registers, two-slot persistence through the port's ``net/wire.py``
codec, election and leader monitor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..net.sim import Endpoint
from ..runtime.futures import (
    AsyncVar,
    Future,
    delay,
    quorum,
    wait_for_any,
)
from ..runtime.loop import Cancelled, now
from ..runtime.buggify import buggify
from ..runtime.trace import SevInfo, SevWarn, trace

CANDIDATE_LEASE = 3.0  # candidacy expires if not re-polled (s)
POLL_DELAY = 0.5  # candidate / monitor re-poll cadence


class Tokens:
    GEN_POLL = "coord.genPoll"
    GEN_READ = "coord.genRead"
    GEN_WRITE = "coord.genWrite"
    CANDIDACY = "coord.candidacy"
    LEADER_HEARTBEAT = "coord.leaderHeartbeat"
    GET_LEADER = "coord.getLeader"


# -- wire types ---------------------------------------------------------------

Generation = tuple  # (counter, uid) — totally ordered, uid breaks ties


@dataclass
class GenPollRequest:
    key: str = "db"


@dataclass
class GenPollReply:
    read_gen: Generation = (0, 0)
    write_gen: Generation = (0, 0)


@dataclass
class GenReadRequest:
    key: str = "db"
    gen: Generation = (0, 0)


@dataclass
class GenReadReply:
    value: Any = None
    write_gen: Generation = (0, 0)
    read_gen: Generation = (0, 0)  # after raising to req.gen


@dataclass
class GenWriteRequest:
    key: str = "db"
    gen: Generation = (0, 0)
    value: Any = None


@dataclass
class GenWriteReply:
    ok: bool = False
    read_gen: Generation = (0, 0)  # the fencing generation on conflict


@dataclass(frozen=True)
class LeaderInfo:
    """A candidate/leader identity. Higher (priority, change_id) wins —
    the reference packs priority into the high bits of changeID."""

    address: str = ""
    priority: int = 0
    change_id: int = 0

    def order(self):
        return (self.priority, self.change_id)


@dataclass
class CandidacyRequest:
    key: str = "db"
    candidate: LeaderInfo = None
    prev_change_id: int = -1  # long-poll: reply when nominee differs


@dataclass
class GetLeaderRequest:
    key: str = "db"
    prev_change_id: int = -1


@dataclass
class LeaderReply:
    nominee: Optional[LeaderInfo] = None


# -- coordinator server -------------------------------------------------------


@dataclass
class _Register:
    value: Any = None
    read_gen: Generation = (0, 0)
    write_gen: Generation = (0, 0)


@dataclass
class LeaderHeartbeatRequest:
    key: str = "db"
    leader: LeaderInfo = None


@dataclass
class _LeaderState:
    candidates: dict = field(default_factory=dict)  # address → (info, lease_deadline)
    leaders: dict = field(default_factory=dict)  # address → (info, lease_deadline)
    nominee: Optional[LeaderInfo] = None
    change: AsyncVar = field(default_factory=lambda: AsyncVar(0))


class CoordinatorServer:
    """One coordinator process: generation registers + leader registers,
    keyed by cluster key (coordinationServer, Coordination.actor.cpp:413)."""

    def __init__(self, disk=None):
        self.registers: dict[str, _Register] = {}
        self.leaders: dict[str, _LeaderState] = {}
        self.process = None
        # durable generation registers (the reference's OnDemandStore,
        # Coordination.actor.cpp:125 localGenerationReg): without this a
        # whole-cluster restart forgets the coordinated state and the
        # tlogs' durable tail is never replayed — found by the
        # restarting-test tier, which lost acked writes
        self.disk = disk
        self._persist_busy: Future = None
        self._reg_seq: dict[str, int] = {}  # per-key slot sequence

    @staticmethod
    def _parse_slot(raw: bytes):
        """(seq, decoded) from a slot record, or None when short/corrupt."""
        import struct
        import zlib

        from ..net import wire

        if len(raw) < 16:
            return None
        seq, length, crc = struct.unpack_from("<QII", raw, 0)
        payload = raw[16 : 16 + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            return None
        try:
            return seq, wire.decode_value(bytes(payload))
        except Exception:
            return None

    def _read_file(self, fname: str) -> bytes:
        f = self.disk.open(fname)
        if hasattr(f, "_image"):
            return bytes(f._image())
        with open(f.path, "rb") as fh:  # RealFile: synchronous boot read
            return fh.read()

    def _load(self) -> None:
        keys = set()
        for fname in self.disk.list():
            if fname.startswith("coordreg-") and fname[-2:] in (".a", ".b"):
                keys.add(fname[len("coordreg-"):-2])
        for key in keys:
            best = None
            for slot in ("a", "b"):
                fname = f"coordreg-{key}.{slot}"
                if not self.disk.exists(fname):
                    continue
                parsed = self._parse_slot(self._read_file(fname))
                if parsed and (best is None or parsed[0] > best[0]):
                    best = parsed
            if best is None:
                continue
            self._reg_seq[key] = best[0]
            _key, value, read_gen, write_gen = best[1]
            r = self._reg(key)
            r.value, r.read_gen, r.write_gen = value, read_gen, write_gen

    async def _persist(self, key: str) -> None:
        """Durably record a register BEFORE replying (the promise/accept
        of this register round must survive restart). TWO alternating
        slot files with seq + checksum: a crash mid-write corrupts only
        the slot being written, never the previously durable record (a
        truncate-and-rewrite could durably lose a promised read_gen and
        re-open the split-brain this persistence exists to prevent).
        Serialized: slot rewrites must not interleave."""
        if self.disk is None:
            return
        import struct
        import zlib

        from ..net import wire

        while self._persist_busy is not None:
            await self._persist_busy
        self._persist_busy = Future()
        try:
            r = self._reg(key)
            seq = self._reg_seq.get(key, 0) + 1
            self._reg_seq[key] = seq
            payload = wire.encode_value(
                (key, r.value, r.read_gen, r.write_gen)
            )
            blob = (
                struct.pack("<QII", seq, len(payload), zlib.crc32(payload))
                + payload
            )
            slot = "a" if seq % 2 else "b"
            f = self.disk.open(f"coordreg-{key}.{slot}")
            await f.truncate(0)
            await f.write(0, blob)
            await f.sync()
        finally:
            busy, self._persist_busy = self._persist_busy, None
            busy._set(None)

    # -- generation register (localGenerationReg:125) --------------------------

    def _reg(self, key: str) -> _Register:
        return self.registers.setdefault(key, _Register())

    async def gen_poll(self, req: GenPollRequest) -> GenPollReply:
        r = self._reg(req.key)
        return GenPollReply(read_gen=r.read_gen, write_gen=r.write_gen)

    async def gen_read(self, req: GenReadRequest) -> GenReadReply:
        r = self._reg(req.key)
        if req.gen > r.read_gen:
            r.read_gen = req.gen
            await self._persist(req.key)  # the PROMISE must survive restart
        return GenReadReply(value=r.value, write_gen=r.write_gen, read_gen=r.read_gen)

    async def gen_write(self, req: GenWriteRequest) -> GenWriteReply:
        r = self._reg(req.key)
        if req.gen >= r.read_gen and req.gen >= r.write_gen:
            r.value = req.value
            r.write_gen = req.gen
            if req.gen > r.read_gen:
                r.read_gen = req.gen
            await self._persist(req.key)  # accept durable before the ack
            return GenWriteReply(ok=True, read_gen=r.read_gen)
        return GenWriteReply(ok=False, read_gen=r.read_gen)

    # -- leader register (leaderRegister:203) ----------------------------------

    def _leader(self, key: str) -> _LeaderState:
        return self.leaders.setdefault(key, _LeaderState())

    def _recompute(self, key: str) -> None:
        """The reference's nomination rule (leaderRegister,
        Coordination.actor.cpp:252-275): prefer a live heartbeating LEADER;
        among mere candidates pick the best by the total (priority,
        change_id) order — total order is what makes split votes across
        coordinators converge — and displace a live leader only for a
        candidate of strictly higher priority (leaderChangeRequired)."""
        st = self._leader(key)
        t = now()
        st.candidates = {
            a: (info, dl) for a, (info, dl) in st.candidates.items() if dl > t
        }
        st.leaders = {
            a: (info, dl) for a, (info, dl) in st.leaders.items() if dl > t
        }
        best_leader = None
        for info, _dl in st.leaders.values():
            if best_leader is None or info.order() > best_leader.order():
                best_leader = info
        best_cand = None
        for info, _dl in st.candidates.values():
            if best_cand is None or info.order() > best_cand.order():
                best_cand = info
        best = best_leader
        if best is None or (
            best_cand is not None and best_cand.priority > best.priority
        ):
            best = best_cand
        if (best and best.change_id) != (st.nominee and st.nominee.change_id):
            st.nominee = best
            st.change.set(st.change.get() + 1)
            trace(
                SevInfo,
                "LeaderNominee",
                self.process.address if self.process else "coord",
                Key=key,
                Nominee=best.address if best else None,
            )

    async def candidacy(self, req: CandidacyRequest) -> LeaderReply:
        if buggify():
            await delay(0.01)  # slow nomination (election churn)
        st = self._leader(req.key)
        st.candidates[req.candidate.address] = (
            req.candidate,
            now() + CANDIDATE_LEASE,
        )
        self._recompute(req.key)
        # long-poll: answer when the nominee is not what the candidate knows
        while st.nominee is not None and st.nominee.change_id == req.prev_change_id:
            await st.change.on_change()
        return LeaderReply(nominee=st.nominee)

    async def leader_heartbeat(self, req: LeaderHeartbeatRequest) -> bool:
        """An elected leader keeps its seat alive; True iff it is still
        this coordinator's nominee (leaderHeartbeat:228)."""
        st = self._leader(req.key)
        st.leaders[req.leader.address] = (req.leader, now() + CANDIDATE_LEASE)
        # the leader stops campaigning; drop its candidate entry
        st.candidates.pop(req.leader.address, None)
        self._recompute(req.key)
        return (
            st.nominee is not None
            and st.nominee.change_id == req.leader.change_id
        )

    async def get_leader(self, req: GetLeaderRequest) -> LeaderReply:
        st = self._leader(req.key)
        self._recompute(req.key)
        while st.nominee is None or st.nominee.change_id == req.prev_change_id:
            await st.change.on_change()
        return LeaderReply(nominee=st.nominee)

    async def _tick(self):
        """Purge expired candidacies even with no traffic (lease expiry is
        what detects a dead leader)."""
        while True:
            await delay(POLL_DELAY)
            for key in list(self.leaders):
                self._recompute(key)

    def register(self, process) -> None:
        self.process = process
        if self.disk is not None:
            self._load()
        process.register(Tokens.GEN_POLL, self.gen_poll)
        process.register(Tokens.GEN_READ, self.gen_read)
        process.register(Tokens.GEN_WRITE, self.gen_write)
        process.register(Tokens.CANDIDACY, self.candidacy)
        process.register(Tokens.LEADER_HEARTBEAT, self.leader_heartbeat)
        process.register(Tokens.GET_LEADER, self.get_leader)
        process.spawn(self._tick())


# -- client-side quorum helpers -----------------------------------------------


def _majority(n: int) -> int:
    return n // 2 + 1


async def _quorum_request(process, coordinators: list[str], token: str, req):
    """Send ``req`` to every coordinator; resolve with a majority of replies."""
    futs = [process.request(Endpoint(c, token), req) for c in coordinators]
    return await quorum(futs, _majority(len(coordinators)))


class ClusterStateChanged(Exception):
    """A newer generation fenced this master's coordinated-state handle."""


class CoordinatedState:
    """Read/write the DBCoreState through a coordinator majority with
    generation fencing (CoordinatedStateImpl, CoordinatedState.actor.cpp:59).
    Usage (one per master recovery attempt):

        cs = CoordinatedState(process, coordinators)
        prev = await cs.read()      # adopts a generation > all it saw
        ...recruit new systems...
        await cs.write(new_state)   # fenced: fails if a newer gen read
    """

    def __init__(self, process, coordinators: list[str], key: str = "db"):
        self.process = process
        self.coordinators = coordinators
        self.key = key
        self.gen: Generation = (0, 0)
        self._read_done = False

    async def read(self) -> Any:
        if buggify():
            await delay(0.005)  # slow coordinated-state read (recovery race)
        # phase 0: discover the highest generation out there
        polls = await _quorum_request(
            self.process, self.coordinators, Tokens.GEN_POLL, GenPollRequest(self.key)
        )
        top = max(max(p.read_gen, p.write_gen) for p in polls)
        from ..runtime.loop import current_loop

        uid = current_loop().random.random_int(0, 1 << 30)
        self.gen = (top[0] + 1, uid)
        # phase 1: read at our generation (raises read_gen at a majority)
        reads = await _quorum_request(
            self.process,
            self.coordinators,
            Tokens.GEN_READ,
            GenReadRequest(self.key, self.gen),
        )
        for r in reads:
            if r.read_gen > self.gen:
                raise ClusterStateChanged(f"fenced by {r.read_gen}")
        self._read_done = True
        best = max(reads, key=lambda r: r.write_gen)
        return best.value

    async def write(self, value: Any) -> None:
        assert self._read_done, "CoordinatedState.write before read"
        if buggify():
            await delay(0.005)  # widen the read→write fencing window
        writes = await _quorum_request(
            self.process,
            self.coordinators,
            Tokens.GEN_WRITE,
            GenWriteRequest(self.key, self.gen, value),
        )
        for w in writes:
            if not w.ok:
                raise ClusterStateChanged(f"fenced by {w.read_gen}")


# -- leader election (client side) --------------------------------------------


async def try_become_leader(
    process,
    coordinators: list[str],
    info: LeaderInfo,
    key: str = "db",
) -> "Leadership":
    """Campaign until ``info`` is nominated by a majority of coordinators
    (tryBecomeLeaderInternal, LeaderElection.actor.cpp:78). Returns a
    Leadership whose ``lost`` future fires when a majority stops nominating
    us. The caller keeps the returned object alive."""
    from ..runtime.futures import spawn

    trace(
        SevInfo,
        "CandidacyStarted",
        process.address,
        Key=key,
        Priority=info.priority,
        ChangeId=info.change_id,
    )

    async def _settle(fut):
        """Swallow per-coordinator failures (a dead coordinator is a lost
        vote, not a lost election)."""
        try:
            return await fut
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception:
            return None

    while True:
        votes = {}  # coordinator → nominee change_id
        futs = {
            c: spawn(
                _settle(
                    process.request(
                        Endpoint(c, Tokens.CANDIDACY),
                        CandidacyRequest(key=key, candidate=info, prev_change_id=-1),
                    )
                )
            )
            for c in coordinators
        }
        need = _majority(len(coordinators))
        pending = dict(futs)
        while pending:
            fs = list(pending.values())
            idx = await wait_for_any(fs + [delay(POLL_DELAY * 2)])
            if idx >= len(fs):
                break  # re-campaign (refresh leases)
            addr = list(pending.keys())[idx]
            f = pending.pop(addr)
            reply = f.get()
            if reply is None:
                continue
            if reply.nominee is not None:
                votes[addr] = reply.nominee
            mine = sum(
                1 for n in votes.values() if n.change_id == info.change_id
            )
            if mine >= need:
                for other in pending.values():
                    other.cancel()
                trace(
                    SevInfo,
                    "ElectionWon",
                    process.address,
                    Key=key,
                    Votes=mine,
                    Need=need,
                )
                lead = Leadership(process, coordinators, info, key)
                lead.start()
                return lead
        await delay(POLL_DELAY * (0.5 + 0.5 * process.sim.loop.random.random01()))


class Leadership:
    """Holds leadership by re-polling candidacy; ``lost`` fires when a
    majority of coordinators no longer nominate us."""

    def __init__(self, process, coordinators, info: LeaderInfo, key: str):
        self.process = process
        self.coordinators = coordinators
        self.info = info
        self.key = key
        self.lost: Future = Future()
        self._actor = None

    def start(self):
        self._actor = self.process.spawn(self._hold())

    async def _hold(self):
        """Keep the seat with leader heartbeats (no longer a candidate —
        the heartbeat set is preferred by the registers, which is what
        stops later candidates with luckier change_ids from stealing)."""
        misses = 0
        while True:
            await delay(POLL_DELAY)
            held = 0
            futs = [
                self.process.request(
                    Endpoint(c, Tokens.LEADER_HEARTBEAT),
                    LeaderHeartbeatRequest(key=self.key, leader=self.info),
                )
                for c in self.coordinators
            ]
            for f in futs:
                try:
                    still_nominee = await f
                except Cancelled:
                    raise  # actor-cancelled-swallow
                except Exception:
                    continue
                if still_nominee:
                    held += 1
            if held >= _majority(len(self.coordinators)):
                misses = 0
            else:
                misses += 1
                if misses >= 2:
                    trace(
                        SevWarn, "LeadershipLost", self.process.address, Key=self.key
                    )
                    if not self.lost.is_ready():
                        self.lost._set(None)
                    return


async def monitor_leader(
    process, coordinators: list[str], out: AsyncVar, key: str = "db"
):
    """Track the current leader into ``out`` (fdbclient/MonitorLeader:
    believe whichever nominee a majority of coordinators report)."""
    while True:
        counts: dict[int, tuple[LeaderInfo, int]] = {}
        futs = [
            process.request(
                Endpoint(c, Tokens.GET_LEADER), GetLeaderRequest(key=key)
            )
            for c in coordinators
        ]
        for f in futs:
            try:
                reply = await timeoutish(f, POLL_DELAY * 2)
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                continue
            if reply is not None and reply.nominee is not None:
                info, n = counts.get(reply.nominee.change_id, (reply.nominee, 0))
                counts[reply.nominee.change_id] = (info, n + 1)
        for info, n in counts.values():
            if n >= _majority(len(coordinators)):
                cur = out.get()
                if cur is None or cur.change_id != info.change_id:
                    trace(
                        SevInfo,
                        "LeaderChanged",
                        process.address,
                        Leader=info.address,
                        ChangeId=info.change_id,
                    )
                    out.set(info)
        await delay(POLL_DELAY)


async def timeoutish(fut: Future, seconds: float):
    which = await wait_for_any([fut, delay(seconds)])
    if which == 0:
        return fut.get()
    fut.cancel()
    return None
