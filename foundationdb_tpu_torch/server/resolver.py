"""Resolver role: ordered MVCC conflict detection over a ConflictSet backend.

The analog of fdbserver/Resolver.actor.cpp (resolveBatch:71-260). The two
essential mechanisms, mirrored:

- **prev_version chaining** (Resolver.actor.cpp:104-122): commit batches from
  any number of proxies are applied in one global version order by waiting
  until the resolver's version equals the batch's prev_version. The master's
  (prev, version) pairs form a linked list over batches; no other
  coordination is needed.
- **reply caching** (outstandingBatches:159): a proxy may retransmit a batch
  it never heard back about; resolution is not idempotent (committed writes
  entered the history), so replies are cached by version and replayed.

The conflict check itself is the pluggable ConflictSet seam
(conflict/api.py): "oracle" in small sims, "native" C++ skip list, or the
CUDA bucket-grid kernels, "torch" on one grid or "torch_mesh" over key-range
partitions.

The port's copy of ``foundationdb_tpu/server/resolver.py``. The device
backends run on the CUDA card unless ``Resolver(..., device="cpu")`` asks
for their plain versions; the reference's ``tpu`` auto-upgrade to the mesh
on a multi-device host is not ported (one card). Recovery differs on
purpose (``_resolve_pipelined``): only a kernel fault is recovered (any
other error leaves ``resolve`` as raised); recovery runs on the device
thread, in line with the dispatches; and a batch that was dispatched on a
backend that a recovery has since replaced is re-resolved, in version
order, on the current one, with new dispatches held back (the fence) until
those are done. The reference lets such batches keep verdicts that miss
the faulted batch's writes, and their own writes miss the rebuilt backend.
"""

from __future__ import annotations

from ..conflict.api import Verdict
from ..conflict.failover import DEVICE_BACKENDS, GuardedConflictSet, KernelFailedError
from ..conflict.errors import ConflictSetClosedError, as_kernel_fault
from ..conflict.faults import KernelFaultError, KernelTimeoutError
from ..net.sim import BrokenPromise
from ..runtime.futures import Future, VersionGate, delay
from ..runtime.knobs import Knobs
from ..runtime.buggify import buggify
from ..runtime.loop import Cancelled, now
from ..runtime.stats import CounterCollection
from ..runtime.trace import SevInfo, SevWarn, emit_span, span, trace
from .interfaces import ResolveBatchReply, ResolveBatchRequest, Tokens, Version

_TIMED_OUT = object()  # timeout() sentinel (None is a legal future value)


class ResolverRetired(BrokenPromise, ConflictSetClosedError):
    """A resolve that was in flight when its resolver was retired
    (``Resolver.close``, at ``worker._destroy``): it ends as a request to a
    destroyed role's endpoint does, in ``BrokenPromise``, which the proxy
    passes on and a client maps to ``commit_unknown_result`` and retries.
    The TCP transport carries it as ``broken_promise``. It is also the
    closed guard's ``ConflictSetClosedError`` that it replaces. (The
    reference's retired resolver still answers: it has no closed guard.)"""


class _Fenced(Exception):
    """A dispatch job found the fence up: the batch resolves in order."""


class _SerialExecutor:
    """Daemon thread(s) running submitted thunks, resolving their futures
    back on the event loop via ``loop.post``. The resolver's device waits
    (a collect blocks until the card is done, the first dispatch until the
    kernels are built) run here so the worker's loop keeps servicing
    heartbeats/elections — the role-thread split of the reference's
    onMainThread bridging (flow/ThreadHelper.actor.h). With
    ``n_threads == 1`` submission order is execution order (the device
    pipeline's requirement); the resolver's ENCODE executor may run more
    threads (CONFLICT_ENCODE_THREADS) since encodes are independent."""

    def __init__(self, n_threads: int = 1):
        import queue
        import threading

        self._q = queue.Queue()
        self._n = max(1, int(n_threads))
        self._depth = 0  # submitted-but-unfinished jobs (observability)
        for _ in range(self._n):
            t = threading.Thread(target=self._run, daemon=True)
            t.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            fn, fut, loop = job

            def finish(outcome, fut=fut, loop=loop):
                # runs ON the loop thread: resolve + retire the external
                # work marker in one scheduled step
                err, result = outcome
                self._depth -= 1
                loop.external_end()
                if err is not None:
                    fut._set_error(err)
                else:
                    fut._set(result)

            # the posted completion must bind THIS job's finish by value:
            # captured by closure name, the next loop iteration rebinds
            # `finish` before the loop thread drains the post, and job N's
            # outcome resolves job N+1's future (observed as warm_compile's
            # None delivered to a dispatch await once the double-buffered
            # pipeline kept more than one job in flight)
            try:
                outcome = (None, fn())
            except BaseException as e:
                outcome = (e, None)
            loop.post(lambda fin=finish, out=outcome: fin(out))

    def depth(self) -> int:
        """Jobs submitted but not yet finished (the encodeQueueDepth
        gauge). GIL-atomic int reads; staleness is fine for a gauge."""
        return self._depth

    def submit(self, fn, loop) -> Future:
        fut: Future = Future()
        loop.external_begin()  # loop must not exit while this is in flight
        self._depth += 1
        self._q.put((fn, fut, loop))
        return fut

    def stop(self) -> None:
        for _ in range(self._n):
            self._q.put(None)


class Resolver:
    def __init__(
        self,
        knobs: Knobs = None,
        backend: str = "oracle",
        first_version: Version = 0,
        uid: str = "",
        device=None,
        **backend_kw,
    ):
        self.knobs = knobs or Knobs()
        if backend in DEVICE_BACKENDS:
            # thread the cluster knobs into the device index (the capacity
            # knob existed but never reached the backend — randomized sim
            # runs silently tested the default capacity only); the
            # occupancy thresholds drive the proactive reshard/grow
            # decisions between batches
            backend_kw.setdefault("capacity", self.knobs.CONFLICT_SET_CAPACITY)
            backend_kw.setdefault(
                "reshard_pressure", self.knobs.CONFLICT_RESHARD_PRESSURE
            )
            backend_kw.setdefault("grow_fill", self.knobs.CONFLICT_GROW_FILL)
            # a spread's bounded wait for another card's H inside a launch
            backend_kw.setdefault("exchange_timeout", self.knobs.CONFLICT_DISPATCH_DEADLINE)
        # device-fault injection (sim-only): seeded from the sim loop's RNG
        # under the CONFLICT_FAULT_INJECTION knob; chaos soaks arm the
        # named kernel-fault buggify sites through it (conflict/faults.py)
        injector = backend_kw.pop("fault_injector", None)
        if injector is None and backend in DEVICE_BACKENDS:
            injector = self._make_injector()
        # every backend rides behind the fault-tolerance guard
        # (conflict/failover.py): bounded journal of committed write
        # ranges, HEALTHY→DEGRADED→FAILED_OVER→HEALTHY state machine, and
        # journal-replay failover to native/oracle. ``device`` (None: the
        # card) reaches every build of the device backend; the host
        # backends ignore it. A missing card or unbuildable kernels raise
        # out of here (conflict/errors.py DeviceUnavailableError)
        self.cs = GuardedConflictSet(
            backend,
            knobs=self.knobs,
            uid=uid,
            fault_injector=injector,
            device=device,
            **backend_kw,
        )
        if first_version:
            # a post-recovery resolver starts with empty history at the
            # recovery version: snapshots older than it must be TOO_OLD
            # (the reference recreates its ConflictSet via
            # clearConflictSet at recovery, SkipList.cpp:1097)
            self.cs.clear(first_version)
        self.gate = VersionGate(first_version)
        # backends with an async dispatch path (the device kernels) pipeline:
        # batch N+1 is dispatched to the device while N's verdicts are in
        # flight — the device threads the history state, so dispatch order
        # alone fixes the outcome. Post-collect bookkeeping (reply cache,
        # state-txn echoes) still runs in version order via reply_gate.
        self._pipelined = self.cs.pipelined
        self.reply_gate = VersionGate(first_version)
        # the double buffer's depth: a batch's encode starts once its
        # predecessor is at the head of the version chain (_resolve_traced)
        self.encode_gate = VersionGate(first_version)
        # up from a kernel fault until no batch dispatched before its
        # recovery is left: batches resolve in version order meanwhile
        self._fence = False
        self.uid = uid
        self._exec: _SerialExecutor = None  # created lazily on a RealLoop
        # dedicated encode executor (double buffering): batch N's host
        # encode runs here while batch N-1's device scan occupies the
        # device thread — the run loop never blocks on either.
        # CONFLICT_ENCODE_THREADS=0 disables the overlap (encode runs
        # inside the dispatch job on the device thread, the serial shape)
        self._encode_exec: _SerialExecutor = None
        self.cs.encode_queue_fn = self._encode_queue_depth
        self._replies: dict[Version, ResolveBatchReply] = {}  # version → cached
        self._proxy_lrv: dict[str, Version] = {}  # proxy → last receive version
        # version → [(committed, mutations)] for system-keyspace txns —
        # forwarded to every proxy so each applies metadata changes in
        # version order (recentStateTransactions, Resolver.actor.cpp:170)
        self._state_txns: dict[Version, list] = {}
        # ResolverStats (Resolver.actor.cpp:48): batch/txn traffic
        self.stats = CounterCollection("Resolver", uid)
        self._c_batches = self.stats.counter("resolveBatchIn")
        self._c_txns = self.stats.counter("transactions")
        self._c_conflicts = self.stats.counter("conflicts")
        self._c_too_old = self.stats.counter("tooOld")
        self._l_resolve = self.stats.latency("resolveLatency")
        # per-endpoint latency bands (exact histogram next to the sampled
        # percentiles; surfaced through resolver.metrics + status)
        self._b_resolve = self.stats.bands("resolveLatencyBands")
        self.stats.gauge("version", lambda: self.gate.version)
        # device-kernel observability: the torch/torch_mesh backends carry a
        # KernelMetrics CounterCollection (per-phase wall time, overflow
        # replays, reshard/transfer counters, occupancy); the guard adds a
        # `health` subsection (state machine, failover/retry/deadline
        # counters, journal depth). Snapshot it as a nested section so
        # resolver.metrics / the status document / the periodic
        # ResolverMetrics trace all carry it with no extra wiring.
        self.stats.gauge("kernel", self.cs.metrics.snapshot)
        # build the kernels and run the smoke shape at construction (on
        # the device thread when one exists) so the first real commit
        # batch does not pay the kernel build under its dispatch deadline
        self._warm: Future = None
        self._warm_seen = False
        if self._pipelined:
            try:
                self._warm = self._submit(self.cs.warm_compile)
            except RuntimeError:  # no active loop (direct tool use)
                self.cs.warm_compile()
        # per-range load sample for resolutionBalancing
        # (Resolver.actor.cpp:276-284 iopsSample): conflict-range begin
        # keys → op counts, decayed by halving at the cap; cumulative op
        # count is the master's balance metric (it diffs between polls)
        self._load_sample: dict[bytes, int] = {}
        self._load_ops = 0

    @property
    def version(self) -> Version:
        return self.gate.version

    async def resolve(self, req: ResolveBatchRequest) -> ResolveBatchReply:
        if req.version in self._replies:
            return self._replies[req.version]
        t_total = now()
        # resolve span under the proxy's batch span (RPC-envelope parent);
        # child spans attribute version-chain queueing vs kernel time
        rsp = span(
            "Resolver.resolve",
            self._proc_addr(),
            resolver=self.uid,
            txns=len(req.transactions),
            version=req.version,
        )
        try:
            return await self._resolve_traced(req, rsp, t_total)
        except ConflictSetClosedError as e:
            if isinstance(e, ResolverRetired):
                raise
            raise ResolverRetired(f"resolver {self.uid} was retired: {e}") from e
        finally:
            rsp.finish()

    def _proc_addr(self) -> str:
        return getattr(self.process, "address", "") if getattr(self, "process", None) else ""

    async def _resolve_traced(self, req, rsp, t_total) -> ResolveBatchReply:
        # double buffering: batch N's host encode is submitted BEFORE its
        # version-chain wait, so it runs on the encode executor while
        # batch N-1 is dispatched and on the device — the dispatch below
        # deadline-waits on the future. A backend swap between now and then
        # surfaces as StaleEncodingError (re-encode + retry); the device
        # backends carry a payload across a rebase. The encode waits for
        # batch N-1 to reach the head of the chain: one batch encodes
        # ahead. The reference submits every arrived batch's encode at
        # once; with a pipeline's worth queued, the encode thread holds the
        # GIL against the device thread's many short releases (each launch
        # and torch op waits out a switch interval), and the first batches
        # after such a burst passed the dispatch deadline on the card.
        enc_fut = None
        txns = None
        if (
            self._pipelined
            and self.knobs.CONFLICT_ENCODE_THREADS > 0
            and req.version not in self._replies
        ):
            txns = self._txns(req)
            await self.encode_gate.wait_until(req.prev_version)
            enc_fut = self._submit_encode(
                lambda txns=txns: self.cs.encode(txns)
            )
        # ordered application: wait for our turn in the version chain
        await self.gate.wait_until(req.prev_version)
        self.encode_gate.advance_to(req.version)  # the next batch may encode
        if rsp.sampled and now() > t_total:
            emit_span("Resolver.queue", self._proc_addr(), rsp, t_total, now())
        if req.version in self._replies:  # resolved while waiting (dup)
            return self._replies[req.version]
        if req.prev_version < self.gate.version:
            if (
                self._pipelined
                and req.version <= self.gate.version
                and req.version > self.reply_gate.version
            ):
                # retransmit of a batch whose original is still in flight
                # on the device: wait for its reply to materialize
                await self.reply_gate.wait_until(req.version)
                if req.version in self._replies:
                    return self._replies[req.version]
            # stale retransmit of an already-superseded batch with no cached
            # reply: everything in it lost (proxy will have failed anyway)
            return ResolveBatchReply(
                committed=[Verdict.CONFLICT] * len(req.transactions)
            )

        if txns is None:
            txns = self._txns(req)
        self._sample_load(req.transactions)
        for t in req.transactions:
            if getattr(t, "debug_id", ""):
                from ..runtime.trace import SevInfo, trace

                trace(
                    SevInfo, "CommitDebug", "",
                    Id=t.debug_id, Event="Resolving", Resolver=self.uid,
                )
        if buggify():
            await delay(0.001)  # slow resolver (pipeline under jitter)
        t_resolve = now()
        window = self.knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS
        oldest = max(0, req.version - window)
        if self._pipelined:
            if self.cs.failed:
                # the kernel AND its fallback are gone (kernel.health =
                # FAILED, SevError already traced by the guard): fail fast
                # with a typed error so recovery replaces this resolver.
                # Both gates still advance, or the NEXT batch in the
                # version chain would block forever at wait_until.
                self.gate.advance_to(req.version)
                self.reply_gate.advance_to(req.version)
                raise KernelFailedError(
                    f"conflict kernel failed: {self.cs.last_error}"
                )
            verdicts = await self._resolve_pipelined(
                req, txns, oldest, rsp, t_resolve, enc_fut
            )
        else:
            verdicts = self.cs.detect_batch(
                txns, now=req.version, new_oldest_version=oldest
            )
            if rsp.sampled:
                emit_span(
                    "Resolver.detect", self._proc_addr(), rsp,
                    t_resolve, now(), backend=self.cs.backend_name,
                )
        # journal this batch's committed write ranges (version order: the
        # pipelined path reaches here only after reply_gate.wait_until, the
        # sync path is gate-ordered end to end) — the failover layer's
        # replay source (conflict/failover.py)
        committed_ranges = []
        for t, v in zip(req.transactions, verdicts):
            if int(v) == int(Verdict.COMMITTED):
                committed_ranges.extend(t.write_conflict_ranges)
        self.cs.record_committed(req.version, committed_ranges, oldest)
        # feed the sim-only prefilter oracle at the journal site, BEFORE
        # the reply carrying feedback is built: its history is then a
        # superset of any proxy summary (runtime/validation.py)
        proc = getattr(self, "process", None)
        oracle = getattr(getattr(proc, "sim", None), "prefilter_oracle", None)
        if oracle is not None and committed_ranges:
            oracle.note_committed(req.version, committed_ranges, oldest)
        self._l_resolve.add(now() - t_resolve)
        self._b_resolve.add(now() - t_total)

        if req.state_txn_indices:
            self._state_txns[req.version] = [
                (
                    int(verdicts[i]) == int(Verdict.COMMITTED),
                    list(req.transactions[i].mutations),
                )
                for i in req.state_txn_indices
            ]
        # echo state txns for every version this proxy hasn't seen yet
        state = [
            (v, entries)
            for v, entries in sorted(self._state_txns.items())
            if req.last_receive_version < v <= req.version
        ]
        # prefilter feedback: echo the write ranges committed
        # in (last_receive_version, version] straight from the journal —
        # the same entries the failover layer replays, so the proxy's
        # summary can never claim more than authoritative history. Walk
        # newest-first so the cap drops the OLDEST ranges (truncation
        # only delays learning — conservative). The journal floor is the
        # resolver's forget horizon: it jumps on failover/capacity
        # pressure, telling the proxy to shrink its summary with us.
        feedback = []
        floor = 0
        if self.knobs.PROXY_CONFLICT_PREFILTER:
            budget = self.knobs.PREFILTER_FEEDBACK_MAX_RANGES
            for v, ranges in reversed(self.cs.journal.entries):
                if v <= req.last_receive_version or budget <= 0:
                    break
                if v > req.version:
                    continue
                take = ranges[:budget]
                feedback.append((v, list(take)))
                budget -= len(take)
            floor = max(oldest, self.cs.journal.floor)
        reply = ResolveBatchReply(
            committed=[int(v) for v in verdicts],
            state_mutations=state,
            committed_ranges=feedback,
            version_floor=floor,
        )
        self._c_batches.add()
        self._c_txns.add(len(verdicts))
        self._c_conflicts.add(
            sum(1 for v in verdicts if int(v) == int(Verdict.CONFLICT))
        )
        self._c_too_old.add(
            sum(1 for v in verdicts if int(v) == int(Verdict.TOO_OLD))
        )

        self._replies[req.version] = reply
        # retire cached replies once EVERY proxy has moved past them — one
        # proxy's progress must not delete another's retransmit window
        if req.requesting_proxy:
            self._proxy_lrv[req.requesting_proxy] = req.last_receive_version
            horizon = min(self._proxy_lrv.values())
            for v in [v for v in self._replies if v < horizon]:
                del self._replies[v]
            for v in [v for v in self._state_txns if v < horizon]:
                del self._state_txns[v]

        if self._pipelined:
            self.reply_gate.advance_to(req.version)
            if self._fence and self.gate.version == req.version:
                # no batch after this one has dispatched: every batch the
                # fence held back is resolved, pipelining resumes
                self._fence = False
        else:
            self.gate.advance_to(req.version)
        return reply

    def _submit(self, fn) -> Future:
        """Run ``fn`` on the resolver's device thread (RealLoop) or inline
        (sim loops stay single-threaded for determinism)."""
        from ..runtime.loop import current_loop

        loop = current_loop()
        post = getattr(loop, "post", None)
        if post is None:
            fut: Future = Future()
            try:
                fut._set(fn())
            except BaseException as e:
                fut._set_error(e)
            return fut
        if self._exec is None:
            self._exec = _SerialExecutor()
        return self._exec.submit(fn, loop)

    def _submit_encode(self, fn) -> Future:
        """Run ``fn`` on the encode executor (RealLoop; sized by
        CONFLICT_ENCODE_THREADS) or inline (sim loops stay
        single-threaded for determinism)."""
        from ..runtime.loop import current_loop

        loop = current_loop()
        post = getattr(loop, "post", None)
        if post is None or self.knobs.CONFLICT_ENCODE_THREADS <= 0:
            fut: Future = Future()
            try:
                fut._set(fn())
            except BaseException as e:
                fut._set_error(e)
            return fut
        if self._encode_exec is None:
            self._encode_exec = _SerialExecutor(
                n_threads=self.knobs.CONFLICT_ENCODE_THREADS
            )
        return self._encode_exec.submit(fn, loop)

    def _encode_queue_depth(self) -> int:
        return self._encode_exec.depth() if self._encode_exec else 0

    def _make_injector(self):
        """Sim-only seeded kernel-fault injector (conflict/faults.py) when
        the CONFLICT_FAULT_INJECTION knob is on."""
        if not self.knobs.CONFLICT_FAULT_INJECTION:
            return None
        from ..runtime.loop import RealLoop, current_loop

        try:
            loop = current_loop()
        except RuntimeError:
            return None
        if isinstance(loop, RealLoop) or getattr(loop, "random", None) is None:
            return None  # never inject faults outside simulation
        from ..conflict.faults import KernelFaultInjector

        return KernelFaultInjector(loop.random.fork())

    async def _deadline_wait(self, fut: Future, deadline: float, stage: str = "", spent: dict | None = None):
        """Await ``fut`` under the batch's dispatch deadline; a miss
        abandons the (possibly wedged) device executor and raises
        KernelTimeoutError into the recovery path. ``spent`` (when given)
        adds this wait's seconds under ``stage`` (encode, dispatch,
        collect, stall), and a miss traces ``KernelDeadlineMissed`` with
        the window's split so far."""
        t0 = now()
        budget = deadline - t0
        timed_out = _TIMED_OUT
        if budget > 0:
            from ..runtime.futures import timeout

            r = await timeout(fut, budget, default=timed_out)
        else:
            r = timed_out
        if spent is not None:
            spent[stage] = spent.get(stage, 0.0) + (now() - t0)
        if r is timed_out:
            self.cs.note_deadline()
            if spent is not None:
                n_txns, n_ranges = spent.get("batch", (0, 0))
                trace(
                    SevWarn, "KernelDeadlineMissed", self._proc_addr(),
                    Resolver=self.uid, Stage=stage, Transactions=n_txns, Ranges=n_ranges,
                    **{f"{k.title().replace('_', '')}Seconds": round(v, 6) for k, v in spent.items()
                       if k != "batch"},
                )
            # up before the abandoned thread can run another queued
            # dispatch: those jobs find it and leave the backend alone
            self._fence = True
            self._abandon_executor()
            raise KernelTimeoutError(
                "conflict dispatch deadline "
                f"({self.knobs.CONFLICT_DISPATCH_DEADLINE}s) exceeded"
            )
        return r

    @staticmethod
    def _real_clock() -> bool:
        from ..runtime.loop import RealLoop, current_loop

        try:
            return isinstance(current_loop(), RealLoop)
        except RuntimeError:
            return False

    def _abandon_executor(self) -> None:
        """A wedged device call may hold the serial executor's thread
        forever: drop it (daemon thread) and lazily build a fresh one, so
        recovery and later batches never queue behind the hang. The encode
        executor gets the same treatment — a deadline miss cannot tell
        which side is wedged, and encode threads are as abandonable."""
        if self._exec is not None:
            ex, self._exec = self._exec, None
            ex.stop()  # parks a stop marker BEHIND the wedged job: harmless
        if self._encode_exec is not None:
            ex, self._encode_exec = self._encode_exec, None
            ex.stop()

    def _txns(self, req) -> list:
        """The conflict set reads only ``read_snapshot`` and the two range
        lists, which a ``TransactionData`` carries: the request's
        transactions go to the backend as they are. (The reference copies
        each into a ``CommitTransaction`` on the loop thread, a Python
        object per transaction that nothing needs.)"""
        return req.transactions

    async def _dispatch_collect(self, req, txns, oldest, rsp, t_resolve, enc_fut, slot):
        """Device dispatch/collect with a per-batch deadline
        (CONFLICT_DISPATCH_DEADLINE) and bounded in-place retry with
        backoff for transient faults. Retries happen BEFORE the gate
        advances, so no later batch has dispatched and version order is
        preserved; everything past the retry budget raises into
        _recover_resolve. ``enc_fut`` is this batch's already-running
        host encode (double buffering) — the deadline covers it too, and
        a retry discards it (re-encode: the payload may be stale or from
        a swapped backend). ``slot["gen"]`` receives the backend generation
        the dispatch ran on."""
        knobs = self.knobs
        deadline = now() + knobs.CONFLICT_DISPATCH_DEADLINE
        async_encode = knobs.CONFLICT_ENCODE_THREADS > 0
        # where the window goes on a real clock (KernelDeadlineMissed): the
        # batch's size, the encode job's own seconds once it is done, and
        # each wait. A simulation's misses are its injected stalls, which
        # its fault trace names already
        spent = None
        if self._real_clock():
            spent = {"batch": (len(txns), sum(len(t.read_conflict_ranges) + len(t.write_conflict_ranges)
                                              for t in txns))}

        # all device-facing conflict-set work runs on one serial executor
        # (RealLoop) or inline (sim): dispatch jobs enqueue in gate order
        # here, collect jobs interleave behind later dispatches — so the
        # device pipelines across batches while the loop never blocks
        # on a device wait (a first-shape compile can outlast
        # FAILURE_TIMEOUT and flap the whole worker otherwise). Host
        # encode runs on the SEPARATE encode executor so it overlaps the
        # device scan instead of queueing behind it.
        attempt = 0
        while True:
            t_attempt = now()
            try:
                if async_encode:
                    if enc_fut is None:
                        enc_fut = self._submit_encode(
                            lambda: self.cs.encode(txns)
                        )
                    t_need = now()
                    enc, enc_s = await self._deadline_wait(enc_fut, deadline, "encode", spent)
                    if spent is not None:
                        spent["encode_job"] = enc_s
                    # encode-overlap evidence: of enc_s seconds of host
                    # encode, only the wait just paid was on the critical
                    # path — the rest hid behind the device scan
                    self.cs.note_encode_overlap(enc_s, now() - t_need)
                    # injected encode-side stall (sim): a wedged encode
                    # thread rides under — or hits — the same deadline
                    stall = self.cs.take_stall()
                    if stall:
                        waiter = (
                            Future() if stall == float("inf") else delay(stall)
                        )
                        await self._deadline_wait(waiter, deadline, "stall", spent)

                    def dispatch(enc=enc, version=req.version, oldest=oldest):
                        self._enter_dispatch(slot)
                        self.cs.prepare(version)  # version-base rebase window
                        return self.cs.detect_many_encoded_async(
                            [(enc, version, oldest)]
                        )

                else:  # legacy shape: encode inside the dispatch job

                    def dispatch(txns=txns, version=req.version, oldest=oldest):
                        self._enter_dispatch(slot)
                        self.cs.prepare(version)
                        enc, _enc_s = self.cs.encode(txns)
                        return self.cs.detect_many_encoded_async(
                            [(enc, version, oldest)]
                        )

                handle = await self._deadline_wait(
                    self._submit(dispatch), deadline, "dispatch", spent
                )
                break
            except Cancelled:
                raise
            except KernelFaultError as e:
                enc_fut = None  # stale/failed encode: next attempt re-encodes
                if not e.transient or attempt >= knobs.CONFLICT_DISPATCH_RETRIES:
                    raise
                attempt += 1
                self.cs.note_retry()
                trace(
                    SevWarn, "KernelDispatchRetry", self._proc_addr(),
                    Resolver=self.uid, Attempt=attempt, Err=repr(e),
                )
                if rsp.sampled:
                    emit_span(
                        "Resolver.kernelRetry", self._proc_addr(), rsp,
                        t_attempt, now(), attempt=attempt,
                        err=type(e).__name__,
                    )
                # bounded exponential backoff before the next attempt
                await delay(knobs.CONFLICT_RETRY_BACKOFF * (1 << (attempt - 1)))
        # the device now owns the (prev → version) ordering for this
        # batch: open the gate and yield so the next batch in the
        # chain dispatches before we block on this one's verdicts
        # (the phase overlap of MasterProxyServer.actor.cpp:353,
        # applied at the resolver↔device boundary)
        self.gate.advance_to(req.version)
        await delay(0)
        stall = self.cs.take_stall()
        if stall:
            # injected device stall (sim): the dispatch completes late —
            # or, for a hang, never — and the deadline decides which
            waiter = Future() if stall == float("inf") else delay(stall)
            await self._deadline_wait(waiter, deadline, "stall", spent)
        if rsp.sampled:
            # kernel phases as child spans: dispatch (encode +
            # device enqueue) vs collect (verdict readback) — the
            # same split KernelMetrics samples in aggregate
            emit_span(
                "Resolver.kernelDispatch", self._proc_addr(), rsp,
                t_resolve, now(), backend=self.cs.backend_name,
                attempts=attempt + 1,
            )
        t_collect = now()
        verdicts = (await self._deadline_wait(self._submit(handle), deadline, "collect", spent))[0]
        if rsp.sampled:
            emit_span(
                "Resolver.kernelCollect", self._proc_addr(), rsp,
                t_collect, now(),
            )
        return verdicts

    def _enter_dispatch(self, slot: dict) -> None:
        """First step of a dispatch job, on the device thread: a job that
        finds the fence up leaves the backend alone (``_Fenced``), any
        other notes the backend generation it dispatches on."""
        if self._fence:
            raise _Fenced()
        slot["gen"] = self.cs.generation

    def _release(self, version: Version) -> None:
        # both gates advance even when a batch raises, or the NEXT batch in
        # the version chain would block forever at wait_until
        self.gate.advance_to(version)
        self.reply_gate.advance_to(version)

    async def _resolve_pipelined(self, req, txns, oldest, rsp, t_resolve, enc_fut):
        """The device path for one batch, in three outcomes decided at the
        head of the reply chain (every earlier batch resolved and
        journaled):

        - dispatched on the current backend, no fault: its verdicts stand;
        - a kernel fault of the current backend: recovery re-resolves it on
          a backend rebuilt from the journal (conflict/failover.py), and
          raises the fence;
        - dispatched on a backend a recovery has since replaced, or held
          back by the fence: re-resolved on the current backend, in order.

        Recovery and in-order resolves run as jobs of the device thread,
        behind the dispatches already queued there, and a dispatch job that
        finds the fence up does not touch the backend; the fence comes down
        once no batch dispatched before the recovery is left. So the
        current backend takes batches in version order only. Anything that
        is not a kernel fault leaves ``resolve`` as raised, with both gates
        advanced."""
        slot: dict = {}
        fault = None
        verdicts = None
        try:
            if self._warm is not None and not self._warm_seen:
                # a warm-up that failed (an unbuildable kernel, a defect)
                # fails the first batch instead of passing unseen
                self._warm_seen = True
                await self._warm
            if not self._fence:
                verdicts = await self._dispatch_collect(
                    req, txns, oldest, rsp, t_resolve, enc_fut, slot
                )
        except _Fenced:
            pass
        except BaseException as e:
            fault = as_kernel_fault(e)
            if fault is None:
                if not isinstance(e, Cancelled):
                    # earlier batches journal first, as after a fault
                    await self.reply_gate.wait_until(req.prev_version)
                self._release(req.version)
                raise
            self._fence = True
        try:
            await self.reply_gate.wait_until(req.prev_version)
            current = slot.get("gen", self.cs.generation) == self.cs.generation
            if fault is not None and current:
                verdicts = await self._recover_resolve(req, txns, oldest, rsp, fault)
            elif verdicts is None or not current:
                trace(
                    SevInfo, "ResolveInOrder", self._proc_addr(),
                    Resolver=self.uid, Version=req.version,
                    Dispatched=verdicts is not None or fault is not None,
                )
                verdicts = await self._submit(
                    lambda: self.cs.detect_batch(
                        txns, now=req.version, new_oldest_version=oldest
                    )
                )
            else:
                self.cs.note_ok()
        except BaseException:
            self._release(req.version)
            raise
        self.gate.advance_to(req.version)
        return verdicts

    async def _recover_resolve(self, req, txns, oldest, rsp, err):
        """The device path faulted for this batch: re-resolve it on a
        journal-rebuilt backend — failing over to native/oracle after
        repeated strikes (conflict/failover.py) — as a job of the device
        thread, at the head of the reply chain (earlier batches have
        journaled their committed writes)."""
        t0 = now()
        verdicts = await self._submit(
            lambda: self.cs.recover_resolve(txns, req.version, oldest, err=err)
        )
        if rsp.sampled:
            emit_span(
                "Resolver.kernelRecover", self._proc_addr(), rsp,
                t0, now(), backend=self.cs.backend_name,
                health=self.cs.health,
            )
        return verdicts

    def close(self) -> None:
        """Retire the role (worker._destroy): stop the device + encode
        threads and free the conflict set's device memory now. The role's
        actors hold the resolver in reference cycles, which only the
        collector frees, and never while it is frozen (``gc.freeze``)."""
        if self._exec is not None:
            self._exec.stop()
            self._exec = None
        if self._encode_exec is not None:
            self._encode_exec.stop()
            self._encode_exec = None
        self.cs.close()

    # -- load sampling / repartitioning (resolutionBalancing) ------------------

    def _sample_load(self, transactions) -> None:
        cap = self.knobs.RESOLUTION_SAMPLE_KEYS
        sample = self._load_sample
        for t in transactions:
            for b, _e in t.read_conflict_ranges:
                sample[b] = sample.get(b, 0) + 1
                self._load_ops += 1
            for b, _e in t.write_conflict_ranges:
                sample[b] = sample.get(b, 0) + 1
                self._load_ops += 1
        if len(sample) > cap:
            # decay-halve and drop the ones that vanish: recent hot keys
            # survive, one-off keys age out. Halving alone doesn't bound
            # the dict when > cap distinct keys stay warm — keep the top
            # `cap` by count so the rebuild can't run on every batch
            decayed = {k: v >> 1 for k, v in sample.items() if v >> 1 > 0}
            if len(decayed) > cap:
                keep = sorted(decayed, key=decayed.get, reverse=True)[:cap]
                decayed = {k: decayed[k] for k in keep}
            self._load_sample = decayed

    async def _resolution_metrics(self, _req) -> dict:  # flowlint: disable=reg-endpoint-span — metrics pull
        """Cumulative conflict-range op count (the master's balancer diffs
        between polls — ResolutionMetricsRequest)."""
        return {"ops": self._load_ops, "version": self.gate.version}

    async def _split_point(self, req: dict) -> dict:  # flowlint: disable=reg-endpoint-span — admin/balance
        """Find a key carving ~target_ops of sampled load off one end of
        [begin, end) (ResolutionSplitRequest: front=True carves a prefix,
        else a suffix). Returns {'key': split_key, 'ops': carved}."""
        begin, end = req["begin"], req["end"]
        keys = sorted(
            k
            for k in self._load_sample
            if begin <= k and (end is None or k < end)
        )
        if not keys:
            return {"key": begin, "ops": 0}
        target = req.get("target_ops", 0)
        acc = 0
        if req.get("front", True):
            for k in keys:
                if acc >= target and k != begin:
                    return {"key": k, "ops": acc}
                acc += self._load_sample[k]
            return {"key": keys[-1], "ops": acc - self._load_sample[keys[-1]]}
        for k in reversed(keys):
            acc += self._load_sample[k]
            if acc >= target and k != begin:
                return {"key": k, "ops": acc}
        # no split inside the segment; the caller rejects key <= begin
        return {"key": keys[0], "ops": acc}

    async def _metrics(self, _req) -> dict:  # flowlint: disable=reg-endpoint-span — metrics pull
        return self.stats.snapshot()

    def register(self, process) -> None:
        self.process = process
        process.register(Tokens.RESOLVE, self.resolve)
        process.register(f"resolver.metrics#{self.uid}", self._metrics)
        process.register(
            f"resolver.resolutionMetrics#{self.uid}", self._resolution_metrics
        )
        process.register(f"resolver.splitPoint#{self.uid}", self._split_point)

    def register_instance(self, process) -> None:
        self.process = process
        process.register(f"{Tokens.RESOLVE}#{self.uid}", self.resolve)
        process.register(f"resolver.ping#{self.uid}", self._ping)
        process.register(f"resolver.metrics#{self.uid}", self._metrics)
        process.register(
            f"resolver.resolutionMetrics#{self.uid}", self._resolution_metrics
        )
        process.register(f"resolver.splitPoint#{self.uid}", self._split_point)

    async def _ping(self, _req):  # flowlint: disable=reg-endpoint-span — liveness
        return "pong"
