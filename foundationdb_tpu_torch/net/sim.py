"""Deterministic cluster simulation: processes, network, faults.

The analog of the reference's Sim2 (fdbrpc/sim2.actor.cpp:720 — virtual
time, per-process scheduling, connection clogging/latency, kill/reboot) built
on the runtime event loop. Every "process" is a container of actors with an
address; messages between processes are scheduled with seeded random latency;
fault APIs mirror ISimulator (fdbrpc/simulator.h:148-155,263):

  clog_pair(a, b, secs)   — delay all a→b traffic
  partition(a, b)/heal()  — drop a↔b traffic
  kill_process / reboot   — cancel all actors of a process (optionally
                            rerunning its boot function)

Determinism: latency and loss draw from the loop's DeterministicRandom; a
whole cluster run replays bit-identically from its seed (§4 of SURVEY.md —
the primary correctness strategy).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..runtime.futures import ActorCollection, Cancelled, Future, spawn
from ..runtime.locality import Locality
from ..runtime.buggify import buggify
from ..runtime.knobs import Knobs
from ..runtime.loop import EventLoop, TaskPriority, set_loop
from ..runtime.trace import SevError, SevInfo, SevWarn, trace


class BrokenPromise(Exception):
    """Request to a dead/unknown endpoint (flow's broken_promise)."""


class TransportTruncated(BrokenPromise):
    """A transport fault ate this request (the sim's super-frame
    truncation / partial-flush site — the transport chaos sites).
    Subclassing BrokenPromise makes it retryable through every existing
    failure path (loadbalance rotation, commit_unknown handling) while
    staying distinctly typed: per-request degradation, never a wedged
    connection."""


class Endpoint:
    """(process address, token) — fdbrpc/FlowTransport.h:28-49."""

    __slots__ = ("address", "token")

    def __init__(self, address: str, token: str):
        self.address = address
        self.token = token

    def __repr__(self):
        return f"{self.address}:{self.token}"


class SimProcess:
    def __init__(self, sim: "Sim", address: str, machine: str, boot=None, locality=None):
        self.sim = sim
        self.address = address
        self.machine = machine
        self.locality = locality or Locality.of(machine)
        self.boot = boot  # async fn(process) rerun on reboot
        self.endpoints: dict[str, Callable] = {}  # token → async handler
        self.actors = ActorCollection(on_error=self._on_actor_error)
        self.alive = True
        self.reboots = 0

    def _on_actor_error(self, err: BaseException, observed: bool = False) -> None:
        """Unhandled actor death is LOUD: SevError with traceback (the
        reference's unhandled-error → TraceEvent("...Error") + death path,
        flow/ActorCollection.actor.cpp). BrokenPromise is routine in sim
        (requests racing kills), and propagated Cancelled is its moral
        equivalent (awaiting a cancelled sibling) — warn, don't scream."""
        import traceback as _tb

        sev = SevWarn if isinstance(err, (BrokenPromise, Cancelled)) else SevError
        trace(
            sev,
            "UnhandledActorError",
            self.address,
            Err=repr(err),
            Backtrace="".join(
                _tb.format_exception(type(err), err, err.__traceback__)
            )[-2000:],
        )

    def register(self, token: str, handler: Callable) -> Endpoint:
        self.endpoints[token] = handler
        return Endpoint(self.address, token)

    def spawn(
        self, coro, priority: int = TaskPriority.DEFAULT, name: str = None
    ) -> Future:
        fut = spawn(coro, priority, name)
        self.actors.add(fut)
        return fut

    def request(self, ep: "Endpoint", payload: Any) -> Future:
        """RPC originating from this process (its address is the source)."""
        return self.sim.request(self.address, ep, payload)


class Sim:
    """One simulated cluster world bound to one event loop."""

    def __init__(
        self, seed: int = 0, knobs: Optional[Knobs] = None, chaos: bool = False
    ):
        self.loop = EventLoop(seed)
        self.knobs = knobs or Knobs()
        # run-loop profiler, SIM personality: deterministic per-actor step
        # counters + virtual starvation samples; no wall-dependent trace
        # events (SlowTask is the real personality's)
        from ..runtime import profiler as _profiler

        _profiler.install(self.loop, knobs=self.knobs, wall=False, ident="sim")
        # chaos=True arms BUGGIFY sites (flow/flow.h:60) with this sim's
        # seeded rng; activate() installs it so concurrent test sims
        # cannot cross-contaminate
        from ..runtime.buggify import Buggify

        self.buggify = Buggify(self.loop.random.fork() if chaos else None)
        self.processes: dict[str, SimProcess] = {}
        self.disks: dict[str, Any] = {}  # machine → SimDisk (survives reboot)
        self._clogged_until: dict[tuple[str, str], float] = {}
        self._partitioned: set[tuple[str, str]] = set()
        # simulation-only durability oracle (fdbrpc/sim_validation.h:38):
        # acked commit versions vs recovery end versions
        from ..runtime.validation import DurabilityOracle, PrefilterOracle

        self.validation = DurabilityOracle()
        # differential oracle for the proxy conflict pre-filter
        # every pre-rejection re-proven conservative
        self.prefilter_oracle = PrefilterOracle()
        # transport counters (net/metrics.py) — parity with RealWorld so
        # the worker's transport.metrics endpoint answers on both
        # personalities (sim has no frames; messages count per delivery)
        from .metrics import TransportMetrics

        self.transport_metrics = TransportMetrics("sim")
        # modeled wire frames: sends to the same destination within one
        # event-loop tick would share a super-frame on the real transport
        # (gen-7 frame batching), so they share one modeled frame here —
        # makes messagesPerFrame meaningful on sim benches (the watch-storm
        # "one super-frame per connection" evidence) without a real wire.
        # {(src, dst) → (tick, messages_in_open_frame)}
        self._open_frames: dict = {}
        # transport chaos: armed EXPLICITLY with a dedicated
        # rng (tools/soak.py draws it at the very END of its sequence) so
        # the main chaos stream — and every pinned seed riding it — stays
        # byte-identical whether or not faults are armed
        self._transport_fault_rng = None
        self._transport_fault_p = 0.0
        self._transport_fault_windows = None

    def arm_transport_faults(self, rng, p: float = 0.01, windows=None) -> None:
        """Arm the super-frame truncation fault site: while armed, each
        delivery is independently eaten with probability ``p``, failing
        THAT request's reply with the typed retryable TransportTruncated
        (the observable semantics of a torn super-frame on the real
        transport: the lost tail's requests fail, everything else
        proceeds). ``windows`` bounds the chaos to [(t0, t1), ...] sim-time
        episodes — like every duration-bounded fault workload (clogging,
        disk failure): sustained per-message loss on RECOVERY-critical
        RPCs keeps the commit epoch in a permanent recovery storm, which
        is an unreachable regime for a real torn flush (the connection
        re-establishes). None = always on (unit tests)."""
        self._transport_fault_rng = rng
        self._transport_fault_p = p
        self._transport_fault_windows = list(windows) if windows else None

    def _transport_fault_fires(self) -> bool:
        if self._transport_fault_rng is None:
            return False
        if self._transport_fault_windows is not None:
            t = self.loop.now()
            if not any(t0 <= t < t1 for t0, t1 in self._transport_fault_windows):
                return False
        return self._transport_fault_rng.coinflip(self._transport_fault_p)

    def disk(self, machine: str):
        """The machine's persistent SimDisk (files survive kill/reboot)."""
        d = self.disks.get(machine)
        if d is None:
            from .files import SimDisk

            d = self.disks[machine] = SimDisk(self, machine)
        return d

    # -- world construction ---------------------------------------------------

    def new_process(
        self, address: str, machine: str = None, boot=None, zone: str = None,
        dc: str = "dc0",
    ) -> SimProcess:
        machine = machine or address
        loc = Locality.of(machine, zone=zone, dc=dc)
        p = SimProcess(self, address, machine, boot, locality=loc)
        self.processes[address] = p
        if boot is not None:
            p.spawn(boot(p))
        return p

    def kill_zone(self, zone: str) -> list[str]:
        """Kill every process in a failure domain (the simulator's
        machine/zone kill, fdbrpc/simulator.h:148 KillType)."""
        killed = []
        for addr, p in list(self.processes.items()):
            if p.alive and p.locality.zone == zone:
                self.kill_process(addr)
                killed.append(addr)
        return killed

    # -- messaging ------------------------------------------------------------

    def _latency(self) -> float:
        if buggify():
            return self.knobs.SIM_MAX_LATENCY * 10  # network hiccup
        # Sim2's networkLatency shape (sim2.actor.cpp:1618, Knobs.cpp:106):
        # almost always MIN + FAST·a (~0.5 ms average), with a rare long
        # tail up to SIM_MAX_LATENCY — not uniform; a uniform draw put the
        # AVERAGE hop at (MIN+MAX)/2 and tripled the commit budget
        k = self.knobs
        a = self.loop.random.random01()
        p_fast = 0.999
        if a <= p_fast:
            return k.SIM_MIN_LATENCY + k.SIM_FAST_LATENCY / p_fast * a
        a = (a - p_fast) / (1 - p_fast)
        return k.SIM_MIN_LATENCY + k.SIM_MAX_LATENCY * a

    def _deliverable(self, src: str, dst: str) -> bool:
        return (src, dst) not in self._partitioned and (
            dst,
            src,
        ) not in self._partitioned

    def _delivery_time(self, src: str, dst: str) -> float:
        t = self.loop.now() + self._latency()
        clog = self._clogged_until.get((src, dst), 0.0)
        return max(t, clog)

    def request(self, src: str, ep: Endpoint, payload: Any) -> Future:
        """One RPC: request and reply each traverse the simulated network.
        The reply future errors with BrokenPromise if the destination is dead
        or unreachable — callers retry exactly like the reference's clients.

        The caller's active span context rides the envelope (the analog of
        FlowTransport attaching the span to the packet header): the handler
        actor is spawned under it, so server-side spans become children of
        the client's without any request dataclass carrying trace fields."""
        from ..runtime import trace as _trace

        span_ctx = _trace.active_span()
        reply: Future = Future()
        self._count_send(src, ep.address)
        if self._transport_fault_fires():
            # transport-truncate chaos site: this request rode the torn
            # tail of a super-frame — typed retryable failure for THIS
            # caller only, delivered with reply latency like any error
            from ..runtime.buggify import mark_fired

            mark_fired(("transport", "transport-truncate"))
            self.transport_metrics.truncation_faults.add(1)
            self._reply_err(ep.address, src, reply, TransportTruncated(str(ep)))
            return reply

        def deliver():
            self.transport_metrics.messages_received.add(1)
            dst = self.processes.get(ep.address)
            if dst is None or not dst.alive or ep.token not in dst.endpoints:
                # reply travels dst→src
                self._reply_err(ep.address, src, reply, BrokenPromise(str(ep)))
                return
            handler = dst.endpoints[ep.token]

            async def run_and_reply():
                try:
                    # the handler runs inline in this actor (owned by the
                    # destination process, so kill_process cancels it
                    # mid-flight); routine request errors are relayed to the
                    # caller and must NOT latch the process's actor-failure
                    # channel, hence no separate spawn
                    result = await handler(payload)
                except Cancelled:
                    self._reply_err(ep.address, src, reply, BrokenPromise(str(ep)))
                    return
                except BaseException as e:
                    self._reply_err(ep.address, src, reply, e)
                    return
                self._reply_ok(ep.address, src, reply, result)

            prev = _trace.swap_active_span(span_ctx)
            try:
                # run-loop attribution: the dispatch wrapper is anonymous
                # plumbing — name the task after the HANDLER so profiler
                # output reads "StorageServer.get_value", not run_and_reply
                dst.spawn(
                    run_and_reply(),
                    name=getattr(handler, "__qualname__", None),
                )
            finally:
                _trace.swap_active_span(prev)

        if not self._deliverable(src, ep.address):
            # dropped on the floor: the caller's timeout/failure monitor acts
            return reply
        self.loop.call_at(self._delivery_time(src, ep.address), deliver)
        return reply

    def _count_send(self, src: str, dst: str) -> None:
        """Message + modeled-frame accounting for one sim send. Same-tick
        sends to the same destination share one frame when frame batching
        is on (what the real transport's flush coalescing does to a
        fan-out burst); each flush's depth feeds messagesPerFlush."""
        m = self.transport_metrics
        m.messages_sent.add(1)
        if not getattr(self.knobs, "TRANSPORT_FRAME_BATCHING", True):
            m.frames_sent.add(1)
            m.frames_received.add(1)
            m.messages_per_flush.add(1.0)
            return
        t = self.loop.now()
        key = (src, dst)
        open_frame = self._open_frames.get(key)
        if open_frame is not None and open_frame[0] == t:
            self._open_frames[key] = (t, open_frame[1] + 1)
            return
        if open_frame is not None:
            m.messages_per_flush.add(float(open_frame[1]))
        if len(self._open_frames) > 4096:
            # stale open frames from dead pairs: flush everything not on
            # the current tick (their frames were already counted)
            for k, (tk, n) in list(self._open_frames.items()):
                if tk != t:
                    m.messages_per_flush.add(float(n))
                    del self._open_frames[k]
        self._open_frames[key] = (t, 1)
        m.frames_sent.add(1)
        m.frames_received.add(1)

    def _reply_ok(self, src: str, dst: str, reply: Future, value) -> None:
        if not self._deliverable(src, dst):
            return
        self._count_send(src, dst)
        self.loop.call_at(
            self._delivery_time(src, dst),
            lambda: (
                self.transport_metrics.messages_received.add(1),
                reply._set(value),
            ),
        )

    def _reply_err(self, src: str, dst: str, reply: Future, err) -> None:
        if not self._deliverable(src, dst):
            return
        self._count_send(src, dst)
        self.loop.call_at(
            self._delivery_time(src, dst),
            lambda: (
                self.transport_metrics.messages_received.add(1),
                reply._set_error(err),
            ),
        )

    # -- fault injection (ISimulator analog) ----------------------------------

    def clog_pair(self, a: str, b: str, seconds: float) -> None:
        until = self.loop.now() + seconds
        self._clogged_until[(a, b)] = max(self._clogged_until.get((a, b), 0), until)
        self._clogged_until[(b, a)] = max(self._clogged_until.get((b, a), 0), until)
        trace(SevInfo, "Clog", "sim", A=a, B=b, Until=until)

    def partition(self, a: str, b: str) -> None:
        self._partitioned.add((a, b))
        trace(SevWarn, "Partition", "sim", A=a, B=b)

    def heal(self, a: str = None, b: str = None) -> None:
        if a is None:
            self._partitioned.clear()
        else:
            self._partitioned.discard((a, b))
            self._partitioned.discard((b, a))

    def kill_process(self, address: str, reboot_in: Optional[float] = None) -> None:
        p = self.processes.get(address)
        if p is None or not p.alive:
            return
        trace(SevWarn, "KillProcess", address, RebootIn=reboot_in)
        p.alive = False
        p.actors.cancel_all()
        p.endpoints.clear()
        disk = self.disks.get(p.machine)
        if disk is not None:
            disk.on_kill()  # unsynced writes lost (AsyncFileNonDurable)
        if reboot_in is not None and p.boot is not None:
            self.loop.call_at(self.loop.now() + reboot_in, lambda: self.reboot(address))

    def reboot(self, address: str) -> None:
        p = self.processes.get(address)
        if p is None or p.alive or p.boot is None:
            return
        trace(SevInfo, "RebootProcess", address)
        p.alive = True
        p.reboots += 1
        p.actors = ActorCollection(on_error=p._on_actor_error)
        p.spawn(p.boot(p))

    # -- running --------------------------------------------------------------

    def activate(self) -> None:
        set_loop(self.loop)
        from ..runtime.buggify import set_buggify

        set_buggify(self.buggify)

    def run(self, until: float = float("inf"), stop_when=None) -> float:
        self.activate()
        return self.loop.run(until, stop_when)

    def run_until_done(self, fut: Future, limit: float = 1e9) -> Any:
        self.activate()
        self.loop.run(until=limit, stop_when=fut.is_ready)
        if not fut.is_ready():
            raise TimeoutError(f"simulation did not finish by t={limit}")
        return fut.get()
