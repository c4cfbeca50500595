"""fdbcli analog: the operator shell, driving a Database + cluster
controller with the same command vocabulary (fdbcli/fdbcli.actor.cpp —
get/set/clear/getrange/status/configure/exclude/include/...).

Commands are strings; `execute` returns the printed output, so the shell
works both interactively and from tests/scripts (the sim is the
deployment environment here, as everywhere in this codebase).

The port's copy of ``foundationdb_tpu/tools/cli.py``: every command and its
output are the reference's, over the port's client and management API;
``lint`` runs the port's own ``tools/flowlint`` over the port's tree."""

from __future__ import annotations

import json
import shlex

from ..client import management
from ..runtime.loop import Cancelled


class FdbCli:
    def __init__(self, db, coordinators: list[str] = None):
        self.db = db
        self.coordinators = coordinators or []

    async def execute(self, line: str) -> str:
        parts = shlex.split(line)
        if not parts:
            return ""
        cmd, args = parts[0].lower(), parts[1:]
        handler = getattr(self, f"_cmd_{cmd}", None)
        if handler is None:
            return f"ERROR: unknown command `{cmd}`"
        try:
            return await handler(args)
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception as e:
            return f"ERROR: {e!r}"

    # -- data ------------------------------------------------------------------

    async def _cmd_get(self, args) -> str:
        (key,) = args

        async def body(tr):
            return await tr.get(key.encode())

        v = await self.db.run(body)
        if v is None:
            return f"`{key}': not found"
        return f"`{key}' is `{v.decode(errors='replace')}'"

    async def _cmd_set(self, args) -> str:
        key, value = args

        async def body(tr):
            tr.set(key.encode(), value.encode())

        await self.db.run(body)
        return "Committed"

    async def _cmd_clear(self, args) -> str:
        (key,) = args

        async def body(tr):
            tr.clear(key.encode())

        await self.db.run(body)
        return "Committed"

    async def _cmd_clearrange(self, args) -> str:
        begin, end = args

        async def body(tr):
            tr.clear_range(begin.encode(), end.encode())

        await self.db.run(body)
        return "Committed"

    async def _cmd_getrange(self, args) -> str:
        begin, end = args[0], args[1]
        limit = int(args[2]) if len(args) > 2 else 25

        async def body(tr):
            return await tr.get_range(begin.encode(), end.encode(), limit=limit)

        rows = await self.db.run(body)
        out = ["Range limited to {} keys".format(limit)]
        for k, v in rows:
            out.append(
                f"`{k.decode(errors='replace')}' is"
                f" `{v.decode(errors='replace')}'"
            )
        return "\n".join(out)

    # -- ops -------------------------------------------------------------------

    async def _cmd_status(self, args) -> str:
        doc = await management.get_status(self.coordinators, self.db.client)
        if args and args[0] == "json":
            return json.dumps(doc, indent=2, default=str)
        c = doc.get("cluster", {})
        lines = [
            f"Cluster controller: {c.get('controller')}",
            f"Recovered: {c.get('recovered')} (recovery #{c.get('recovery_count')})",
            f"Master: {c.get('master')}",
            f"Workers: {len(c.get('workers', {}))}",
            f"Coordinators: {', '.join(c.get('coordinators', []))}",
        ]
        logs = c.get("logs")
        if logs:
            lines.append(
                f"Log epoch: {logs['epoch']} "
                f"({len(logs['current'])} tlogs, "
                f"{logs['old_generations']} old generations)"
            )
        proxies = doc.get("client", {}).get("proxies")
        if proxies:
            lines.append(f"Proxies: {', '.join(proxies)}")
        probe = doc.get("latency_probe") or {}
        if probe.get("commit_seconds") is not None:
            lines.append(
                "Latency probe: GRV "
                f"{probe.get('grv_seconds', 0) * 1000:.1f} ms, read "
                f"{probe.get('read_seconds', 0) * 1000:.1f} ms, commit "
                f"{probe.get('commit_seconds', 0) * 1000:.1f} ms "
                f"({probe.get('probes_completed', 0)} probes, "
                f"{probe.get('probe_errors', 0)} errors)"
            )
        wl = doc.get("workload") or {}
        tx = wl.get("transactions") or {}
        if tx:
            def hz(section):
                return (tx.get(section) or {}).get("hz") or 0

            lines.append(
                f"Workload: {hz('started'):.0f} started/s, "
                f"{hz('committed'):.0f} committed/s, "
                f"{hz('conflicted'):.0f} conflicted/s, "
                f"abort rate {wl.get('abort_rate') or 0:.2f}"
            )
        pf = wl.get("prefiltered") or {}
        if (wl.get("prefilter") or {}).get("checks", {}).get("counter") or pf.get(
            "counter"
        ):
            pfs = wl.get("prefilter") or {}
            checks = (pfs.get("checks") or {}).get("counter") or 0
            lines.append(
                f"Prefilter: {pf.get('counter') or 0} pre-rejected "
                f"({pf.get('hz') or 0:.0f}/s) of {checks} checks, "
                f"{(pfs.get('feedback_ranges') or {}).get('counter', 0)} "
                f"feedback ranges learned"
            )
        ops = wl.get("operations") or {}
        rb = ops.get("reads_batched") or {}
        if rb.get("counter"):
            mb = ops.get("multiget_batches") or {}
            mrb = ops.get("multiget_range_batches") or {}
            idx_r = ops.get("index_reads") or {}
            idx_f = ops.get("index_fallbacks") or {}
            lines.append(
                f"Read pipeline: {rb.get('hz') or 0:.0f} batched reads/s "
                f"({(mb.get('hz') or 0) + (mrb.get('hz') or 0):.0f} batches/s; "
                f"{rb.get('counter', 0)} total, "
                f"index {idx_r.get('counter', 0)} / "
                f"fallback {idx_f.get('counter', 0)})"
            )
        se = (doc.get("workload") or {}).get("storage_engine") or {}
        if (se.get("epochs_applied") or {}).get("counter"):
            ea = se["epochs_applied"]
            em = se.get("epoch_mutations") or {}
            n_epochs = ea.get("counter") or 0
            n_muts = em.get("counter") or 0
            age = se.get("oldest_pinned_age_seconds") or 0
            lines.append(
                f"Storage engine: {n_epochs} epochs applied "
                f"({n_muts} mutations, "
                f"{n_muts / max(n_epochs, 1):.1f} muts/epoch, "
                f"{ea.get('hz') or 0:.0f} epochs/s), "
                f"{(se.get('range_tombstones') or {}).get('counter', 0)} "
                f"range tombstones, "
                f"{(se.get('snapshots_pinned') or {}).get('counter', 0)} "
                f"snapshots pinned ({se.get('pinned_now') or 0} now"
                + (f", oldest {age:.1f}s" if age else "")
                + ")"
            )
        tl = (doc.get("workload") or {}).get("tlog") or {}
        if tl.get("fsync_rounds"):
            rounds = tl.get("fsync_rounds") or 0
            joins = tl.get("group_joins") or 0
            lines.append(
                f"TLog: {rounds} fsync rounds, {joins} group joins "
                f"({(rounds + joins) / max(rounds, 1):.1f} commits/round), "
                f"{tl.get('fsync_seconds') or 0:.2f}s in fsync, "
                f"pipeline depth {tl.get('pipeline_depth') or 0}"
            )
        wa = (doc.get("workload") or {}).get("watches") or {}
        if (wa.get("registered") or {}).get("counter") or wa.get("parked_now"):
            fired = (wa.get("fired") or {}).get("counter") or 0
            batches = (wa.get("fanout_batches") or {}).get("counter") or 0
            lines.append(
                f"Watches: {wa.get('parked_now') or 0} parked "
                f"({wa.get('watch_bytes_now') or 0} bytes), "
                f"{(wa.get('registered') or {}).get('counter', 0)} registered, "
                f"{fired} fired in {batches} fan-out batches, "
                f"{(wa.get('cancelled') or {}).get('counter', 0)} cancelled, "
                f"{(wa.get('feed_entries_streamed') or {}).get('counter', 0)} "
                f"feed entries streamed"
            )
        hot = wl.get("hot_ranges") or []
        if hot:
            tops = ", ".join(
                f"[{r.get('begin', '')!r},{r.get('end', '')!r}) "
                f"x{r.get('density', 0):.0f}"
                for r in hot[:3]
            )
            lines.append(f"Hot ranges: {tops} (see `hotranges`)")
        tr = (doc.get("transport") or {}).get("total") or {}
        if tr.get("messagesSent"):
            lines.append(
                f"Transport: {tr.get('messagesSent', 0)} msgs in "
                f"{tr.get('framesSent', 0)} frames "
                f"({tr.get('messagesPerFrame', 0):.1f} msgs/frame), "
                f"loopback {tr.get('loopbackMessages', 0)} / "
                f"tcp {tr.get('tcpMessages', 0)}, "
                f"{tr.get('bytesSent', 0)} bytes out"
                + (
                    f", {tr['truncationFaults']} truncation faults"
                    if tr.get("truncationFaults")
                    else ""
                )
            )
        bands = wl.get("latency_bands") or {}
        for leg in ("grv", "read", "commit"):
            b = bands.get(leg) or {}
            if b.get("count"):
                parts = [
                    f"<= {edge}s: {n}"
                    for edge, n in sorted(
                        (b.get("bands") or {}).items(),
                        key=lambda kv: float("inf") if kv[0] == "inf" else float(kv[0]),
                    )
                    if n
                ]
                lines.append(
                    f"Latency bands [{leg}] ({b['count']} reqs): "
                    + ", ".join(parts)
                )
        kern = doc.get("kernel") or {}
        if kern:
            lines.append(
                f"Conflict kernel: {kern.get('state', '?')}"
                f" ({kern.get('failovers', 0)} failovers, "
                f"{kern.get('device_rebuilds', 0)} rebuilds, "
                f"{kern.get('retries', 0)} retries, "
                f"{kern.get('deadline_hits', 0)} deadline hits, "
                f"{kern.get('promotions', 0)} promotions)"
            )
        qos = doc.get("qos") or {}
        if qos:
            rate = qos.get("released_transactions_per_second")
            lines.append(
                f"QoS: {qos.get('transactions_committed_total', 0)} committed, "
                f"{qos.get('conflicts_total', 0)} conflicts"
                + (f", released rate {rate:.0f} tps" if rate else "")
                + (
                    f", limiting: {qos['limiting']}"
                    if qos.get("limiting")
                    else ""
                )
            )
            rpc = qos.get("released_per_class") or {}
            apc = qos.get("admitted_per_class") or {}
            if rpc or apc:
                parts = []
                for c in ("batch", "default", "immediate"):
                    granted = rpc.get(c)
                    admitted = (apc.get(c) or {}).get("hz") or 0
                    parts.append(
                        f"{c} {admitted:.0f}/s"
                        + (
                            f" (granted {granted:.0f})"
                            if granted is not None
                            else ""
                        )
                    )
                lines.append("Admission: " + ", ".join(parts))
            shed = qos.get("throttled_total") or 0
            if shed:
                tpc = qos.get("throttled_per_class") or {}
                lines.append(
                    f"Throttled: {shed} shed ("
                    + ", ".join(
                        f"{c} {tpc.get(c, 0)}"
                        for c in ("batch", "default", "immediate")
                    )
                    + ")"
                )
            tenants = qos.get("tenants") or {}
            if tenants:
                tparts = [
                    f"{t or '<none>'}: {s.get('admitted', 0)} adm"
                    + (
                        f"/{s.get('throttled', 0)} shed"
                        if s.get("throttled")
                        else ""
                    )
                    for t, s in tenants.items()
                ]
                lines.append("Tenants (top): " + ", ".join(tparts))
        lines.extend(_format_run_loop(doc.get("run_loop") or {}))
        if args and args[0] == "details":
            # machine/process sections (fdbcli `status details`)
            machines = doc.get("machines", {})
            if machines:
                lines.append("")
                lines.append(f"{len(machines)} machines:")
                for m, info in sorted(machines.items()):
                    lines.append(
                        f"  {m}: {info['processes']} processes, "
                        f"{info['memory_kb'] / 1024:.0f} MB, worst loop lag "
                        f"{info['worst_run_loop_lag'] * 1000:.1f} ms"
                    )
            procs = doc.get("processes", {})
            if procs:
                lines.append("")
                lines.append(f"{len(procs)} processes:")
                for a, sm in sorted(procs.items()):
                    roles = ",".join(
                        doc["cluster"]["workers"].get(a, {}).get("roles", [])
                    )
                    lines.append(
                        f"  {a:24s} lag {1000 * (sm.get('RunLoopLag') or 0):6.2f} ms  "
                        f"actors {sm.get('Actors', '?'):>4}  "
                        f"mem {((sm.get('MemoryKB') or 0) / 1024):6.0f} MB  "
                        f"[{roles}]"
                    )
            data = doc.get("data") or {}
            if data:
                lines.append("")
                lines.append(
                    "Data: storage version spread "
                    f"{data.get('storage_version_spread', 0)}"
                )
            resolvers = doc.get("resolvers") or {}
            if resolvers:
                lines.append("")
                lines.append(f"{len(resolvers)} resolvers:")
                for uid, snap in sorted(resolvers.items()):
                    k = snap.get("kernel") or {}
                    occ = (k.get("occupancy") or {}) if k else {}
                    h = (k.get("health") or {}) if k else {}
                    ov = (k.get("encodeOverlapSeconds") or {}) if k else {}
                    extra = (
                        f"  kernel: {occ.get('liveRows', 0)} rows "
                        f"{occ.get('fillFraction', 0):.1%} full, "
                        f"{k.get('overflowReplays', 0)} replays, "
                        f"{k.get('reshardsDevice', 0)}+"
                        f"{k.get('reshardsHost', 0)} reshards "
                        f"({k.get('reshardsProactive', 0)} proactive), "
                        f"enc overlap p50 "
                        f"{1000 * (ov.get('p50') or 0):.2f} ms "
                        f"over {ov.get('count', 0)}, "
                        f"encQ {k.get('encodeQueueDepth', 0)}"
                        if occ
                        else ""
                    )
                    if h:
                        extra += (
                            f"  health: {h.get('state', '?')} on "
                            f"{h.get('backend', '?')}, "
                            f"{h.get('failovers', 0)} failovers, "
                            f"journal {h.get('journalDepth', 0)}"
                            f"@{h.get('journalFloor', 0)}"
                        )
                    lines.append(
                        f"  {uid} @ {snap.get('address', '?')}: "
                        f"{snap.get('transactions', 0)} txns, "
                        f"{snap.get('conflicts', 0)} conflicts{extra}"
                    )
        return "\n".join(lines)

    async def _cmd_hotranges(self, args) -> str:
        """hotranges [N] — the cluster's hottest key ranges by sampled
        read-bytes ÷ size density (the reference's
        getReadHotRanges surfaced through status `workload.hot_ranges`),
        plus the byte-sampling evidence backing the estimates."""
        n = int(args[0]) if args else 5
        doc = await management.get_status(self.coordinators, self.db.client)
        wl = doc.get("workload") or {}
        hot = wl.get("hot_ranges") or []
        bs = wl.get("byte_sampling") or {}
        lines = []
        if not hot:
            lines.append(
                "no hot ranges (sampling off, no reads, or all densities "
                "under STORAGE_HOT_RANGE_MIN_DENSITY)"
            )
        else:
            lines.append(f"{len(hot[:n])} hot range(s), hottest first:")
            lines.append(
                f"{'density':>8}  {'read bytes':>11}  {'size':>9}  "
                f"{'storage':14s}  range"
            )
            for r in hot[:n]:
                lines.append(
                    f"{r.get('density', 0):8.1f}  {r.get('read_bytes', 0):11d}  "
                    f"{r.get('bytes', 0):9d}  {r.get('storage', '?'):14s}  "
                    f"[{r.get('begin', '')!r}, {r.get('end', '')!r})"
                )
        lines.append(
            f"Byte sample: {(bs.get('sample_entries') or 0)} entries, "
            f"{(bs.get('bytes_sampled') or {}).get('counter', 0)} bytes sampled, "
            f"{(bs.get('hot_range_checks') or {}).get('counter', 0)} bucket checks; "
            f"waitMetrics {(bs.get('wait_metrics_active') or 0)} armed / "
            f"{(bs.get('wait_metrics_fired') or {}).get('counter', 0)} fired"
        )
        return "\n".join(lines)

    async def _cmd_metrics(self, args) -> str:
        """metrics                    — list roles with metrics history
        metrics <kind>            — list that kind's recorded counters
        metrics <kind> <counter>  — sparkline + timeline of the counter
        Reads every worker's `worker.metricsHistory` ring
        (runtime/timeseries.py) and merges roles of a kind."""
        from ..net.sim import Endpoint
        from ..runtime.futures import timeout as _timeout
        from .trace_analyze import sparkline

        kind = args[0] if args else None
        counter = args[1] if len(args) > 1 else None
        doc = await management.get_status(self.coordinators, self.db.client)
        workers = (doc.get("cluster") or {}).get("workers") or {}
        rings: dict = {}  # uid → history dict (with "kind")
        for addr in workers:
            try:
                h = await _timeout(
                    self.db.client.request(
                        Endpoint(addr, "worker.metricsHistory"), None
                    ),
                    2.0,
                )
            except Cancelled:
                raise  # actor-cancelled-swallow
            except Exception:
                h = None
            for uid, d in (h or {}).items():
                rings[uid] = d
        if not rings:
            return "no metrics history (METRICS_HISTORY_ENABLED off, or no points yet)"
        if kind is None:
            kinds: dict = {}
            for d in rings.values():
                kinds[d.get("kind") or "?"] = kinds.get(d.get("kind") or "?", 0) + 1
            return "roles with history: " + ", ".join(
                f"{k} ({n})" for k, n in sorted(kinds.items())
            )
        matching = {u: d for u, d in rings.items() if d.get("kind") == kind}
        if not matching:
            return f"no `{kind}' roles with metrics history"
        if counter is None:
            names: set = set()
            for d in matching.values():
                for _t, vals in d.get("points") or []:
                    names.update(vals)
            return f"{kind} counters: " + ", ".join(sorted(names))
        # sum the counter across roles of the kind, per snapshot tick
        merged: dict = {}  # rounded t → summed value
        for d in matching.values():
            for t, vals in d.get("points") or []:
                if counter in vals:
                    tk = round(t, 1)
                    merged[tk] = merged.get(tk, 0) + vals[counter]
        if not merged:
            return f"counter `{counter}' not in any {kind} history"
        pts = sorted(merged.items())
        vals = [v for _t, v in pts]
        lines = [
            f"{kind}.{counter} over {len(pts)} points "
            f"[t={pts[0][0]:g}..{pts[-1][0]:g}]:",
            "  " + sparkline(vals),
            f"  min {min(vals):g}  max {max(vals):g}  last {vals[-1]:g}",
        ]
        return "\n".join(lines)

    async def _cmd_trace(self, args) -> str:
        """trace                      — list sampled traces
        trace <trace-id>          — waterfall for one trace
        trace breakdown           — aggregate critical-path breakdown
        Any argument naming an existing file is loaded as a JSONL trace
        file (per-process files merge; rolled siblings included); with no
        files, this process's in-memory TraceLog serves (the sim case,
        where every role shares it)."""
        import os as _os

        from ..runtime.trace import trace_log
        from . import trace_analyze as ta

        files = [a for a in args if _os.path.exists(a) or a.endswith(".jsonl")]
        sel = [a for a in args if a not in files]
        events = ta.load_events(files) if files else trace_log().events
        if sel and sel[0] == "breakdown":
            return ta.format_critical_path(ta.critical_path(events))
        if sel:
            return ta.format_waterfall(events, sel[0])
        traces = ta.spans_by_trace(events)
        if not traces:
            return "no sampled traces (set TRACE_SAMPLE_RATE or a debug id)"
        lines = [f"{len(traces)} sampled traces:"]
        for tid, spans in sorted(traces.items())[:25]:
            t0 = min(s.get("Begin") or 0.0 for s in spans)
            t1 = max((s.get("Begin") or 0.0) + (s.get("Dur") or 0.0) for s in spans)
            names = ",".join(
                sorted({r.get("Name", "?") for r in ta._roots(spans)})
            )
            lines.append(
                f"  {tid}: {len(spans)} spans, {(t1 - t0) * 1000:.3f} ms  [{names}]"
            )
        if len(traces) > 25:
            lines.append(f"  ... and {len(traces) - 25} more")
        return "\n".join(lines)

    async def _cmd_top(self, args) -> str:
        """top [N] — hottest actors by run-loop busy time, merged across
        the cluster's loops (the profiler's answer to "who is holding the
        run loop"; fdbtop-style view of runtime/profiler.py)."""
        n = int(args[0]) if args else 10
        rl = {}
        try:
            doc = await management.get_status(self.coordinators, self.db.client)
            rl = doc.get("run_loop") or {}
        except Cancelled:
            raise  # actor-cancelled-swallow
        except Exception:
            rl = {}
        if not rl:
            # no cluster/status (or profiler off everywhere): fall back to
            # this process's own loop
            from ..runtime.loop import current_loop

            prof = getattr(current_loop(), "profiler", None)
            if prof is None:
                return "no run-loop profiler (RUN_LOOP_PROFILER knob off)"
            rl = {"local": prof.snapshot(top=max(n, 10))}
        loops = _dedupe_loops(rl)
        merged: dict[str, dict] = {}
        for _addr, snap in loops.values():
            for a in snap.get("hot_actors") or []:
                m = merged.setdefault(
                    a["name"], {"steps": 0, "busy_seconds": 0.0, "max_ms": 0.0}
                )
                m["steps"] += a.get("steps") or 0
                m["busy_seconds"] += a.get("busy_seconds") or 0.0
                m["max_ms"] = max(m["max_ms"], a.get("max_ms") or 0.0)
        if not merged:
            return "no run-loop samples yet"
        slow = sum(s.get("slow_tasks") or 0 for _a, s in loops.values())
        lines = [
            f"hot actors by run-loop busy time "
            f"({len(loops)} loop(s), {slow} slow tasks):",
            f"{'busy ms':>10}  {'steps':>8}  {'max ms':>8}  actor",
        ]
        rows = sorted(
            merged.items(),
            key=lambda kv: (-kv[1]["busy_seconds"], -kv[1]["steps"], kv[0]),
        )[:n]
        for name, m in rows:
            lines.append(
                f"{m['busy_seconds'] * 1000:10.2f}  {m['steps']:8d}  "
                f"{m['max_ms']:8.2f}  {name}"
            )
        return "\n".join(lines)

    async def _cmd_profile(self, args) -> str:
        """profile start [hz]        — begin sampling this loop's thread
        profile stop [path]       — stop; print folded stacks (or write)
        profile <seconds> [path]  — sample for a duration, then dump
        Folded-stack output (`a;b;c 42` lines) feeds flamegraph.pl or
        speedscope directly (runtime/profiler.py FlameProfiler)."""
        from ..runtime.futures import delay
        from ..runtime.loop import current_loop

        prof = getattr(current_loop(), "profiler", None)
        if prof is None:
            return "ERROR: no run-loop profiler (RUN_LOOP_PROFILER knob off)"
        if not args:
            return "ERROR: profile start [hz] | stop [path] | <seconds> [path]"
        if args[0] == "start":
            hz = float(args[1]) if len(args) > 1 else None
            flame = prof.flame_start(hz)
            return f"sampling loop thread at {flame.hz:g} Hz"
        if args[0] == "stop":
            return self._finish_profile(prof, args[1] if len(args) > 1 else None)
        seconds = float(args[0])
        prof.flame_start()
        await delay(seconds)
        return self._finish_profile(prof, args[1] if len(args) > 1 else None)

    def _finish_profile(self, prof, path) -> str:
        flame = prof.flame
        samples = flame.samples if flame is not None else 0
        folded = prof.flame_stop()
        if not folded:
            return "(no samples — was the loop idle, or sampling never started?)"
        if path:
            with open(path, "w") as f:
                f.write(folded + "\n")
            return (
                f"wrote {len(folded.splitlines())} folded stacks "
                f"({samples} samples) to {path}"
            )
        return folded

    async def _cmd_exclude(self, args) -> str:
        if not args:
            ex = await management.get_excluded(self.db)
            return "Excluded: " + (", ".join(ex) if ex else "(none)")
        await management.exclude_servers(self.db, list(args))
        await management.wait_for_excluded(self.db, list(args))
        return f"Excluded {len(args)} server(s); data redistributed"

    async def _cmd_include(self, args) -> str:
        await management.include_servers(self.db, list(args) or None)
        return "Included"

    # -- backup (the fdbbackup personalities, fdbbackup/backup.actor.cpp) ------

    def _container_for(self, name: str):
        """Container URL dispatch (BackupContainer.actor.cpp:1): a
        blobstore://host:port/bucket/name target over real HTTP, or the
        default disk-backed container."""
        if name.startswith("blobstore://"):
            from ..backup.blobstore import open_container
            from ..runtime.loop import current_loop

            return open_container(name, loop=current_loop())
        from ..backup import BackupContainer

        return BackupContainer(self.db.sim.disk("backup-store"), name)

    async def _cmd_backup(self, args) -> str:
        """backup start <container-or-url> | backup discontinue"""
        from ..backup import BackupAgent

        sub = args[0]
        if sub == "start":
            name = args[1] if len(args) > 1 else "backup"
            container = self._container_for(name)
            agent = BackupAgent(self.db, container, uid=name)
            await agent.submit()
            await agent.wait_snapshot_complete()
            self._backup_agents = getattr(self, "_backup_agents", {})
            self._backup_agents[name] = agent
            return f"The backup on tag `{name}' was successfully submitted"
        if sub == "discontinue":
            name = args[1] if len(args) > 1 else "backup"
            agent = getattr(self, "_backup_agents", {}).get(name)
            if agent is None:
                return f"ERROR: no running backup `{name}'"
            await agent.discontinue()
            return f"The backup on tag `{name}' was successfully discontinued"
        return "ERROR: backup start|discontinue"

    async def _cmd_restore(self, args) -> str:
        from ..backup.agent import restore

        name = args[0] if args else "backup"
        n = await restore(self.db, self._container_for(name))
        return f"Restored {n} snapshot rows (+ mutation log)"

    async def _cmd_force_failover(self, args) -> str:
        """force_failover <dc> — promote a region after primary loss
        (force_recovery_with_data_loss)."""
        if not args:
            return "ERROR: force_failover <dc>"
        await management.force_failover(
            self.coordinators, self.db.client, args[0]
        )
        return f"Failover to region `{args[0]}' initiated"

    async def _cmd_lint(self, args) -> str:
        """lint [--json] — run flowlint over this checkout (no cluster
        needed; also available as `python -m foundationdb_tpu_torch.tools.cli
        lint`). Prints per-rule fail/baseline/disabled counts and the
        host-only manifest."""
        return _run_lint(list(args))[1]

    async def _cmd_configure(self, args) -> str:
        changes = {}
        for a in args:
            k, _, v = a.partition("=")
            changes[k] = v
        await management.configure(
            self.db, self.coordinators, self.db.client, **changes
        )
        return "Configuration changed; recovery triggered"


def _dedupe_loops(run_loop: dict) -> dict:
    """loop_id → (address, snapshot). Every sim process reports the ONE
    loop the whole sim shares; summing those would multiply every counter
    by the worker count, so consumers aggregate loops, not processes."""
    loops: dict = {}
    for addr, snap in sorted(run_loop.items()):
        if snap:
            loops.setdefault(snap.get("loop_id") or addr, (addr, snap))
    return loops


def _format_run_loop(run_loop: dict) -> list:
    """`cli status` lines for the status document's run_loop section:
    loop totals plus per-priority-band starvation latency (worst observed
    percentiles across loops — stats.LatencySample.merge)."""
    from ..runtime.profiler import BAND_ORDER
    from ..runtime.stats import LatencySample

    loops = _dedupe_loops(run_loop)
    if not loops:
        return []
    steps = sum(s.get("steps") or 0 for _a, s in loops.values())
    slow = sum(s.get("slow_tasks") or 0 for _a, s in loops.values())
    worst_addr, worst = max(
        loops.values(), key=lambda kv: kv[1].get("busy_fraction") or 0.0
    )
    lines = [
        f"Run loop: {len(loops)} loop(s), {steps} steps, {slow} slow tasks, "
        f"busiest {worst_addr} at {(worst.get('busy_fraction') or 0):.1%} busy"
    ]
    for band in BAND_ORDER:
        merged = LatencySample.merge(
            [
                ((s.get("bands") or {}).get(band) or {}).get("starvation")
                for _a, s in loops.values()
            ]
        )
        if merged["count"]:
            lines.append(
                f"  starvation [{band}]: {merged['count']} tasks, worst "
                f"p95 {merged['p95'] * 1000:.2f} ms, "
                f"p99 {merged['p99'] * 1000:.2f} ms"
            )
    return lines


def _run_lint(args: list) -> tuple:
    """(exit_code, rendered_output) for the flowlint static analyzer —
    shared by the `lint` subcommand and the in-shell `lint` command."""
    import json as _json

    from .flowlint import lint, load_config
    from .flowlint.__main__ import render

    config = load_config()
    result = lint(config=config)
    if "--json" in args:
        out = _json.dumps(result.to_json(), indent=2)
    else:
        out = render(result, config)
    return (0 if result.clean else 1), out


def main(argv=None) -> int:
    """fdbcli over real TCP: connect to a running cluster's coordinators.

      python -m foundationdb_tpu_torch.tools.cli -C 127.0.0.1:4500 --exec "set k v"

    Without --exec, reads commands from stdin (one per line). The `lint`
    subcommand runs the flowlint static analyzer instead (no cluster):

      python -m foundationdb_tpu_torch.tools.cli lint [--json]
    """
    import argparse
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "lint":
        rc, out = _run_lint(argv[1:])
        print(out, flush=True)
        return rc

    ap = argparse.ArgumentParser(prog="fdbcli")
    ap.add_argument("-C", "--cluster", required=True, help="coordinator list")
    ap.add_argument("--exec", dest="cmds", action="append", default=[])
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--tls-cert", default=None)
    ap.add_argument("--tls-key", default=None)
    ap.add_argument("--tls-ca", default=None)
    args = ap.parse_args(argv)

    from ..client.database import Database
    from ..net.tcp import RealWorld
    from ..runtime.futures import spawn

    coordinators = [c for c in args.cluster.split(",") if c]
    tls = None
    if args.tls_cert or args.tls_key or args.tls_ca:
        if not (args.tls_cert and args.tls_key and args.tls_ca):
            ap.error("--tls-cert, --tls-key and --tls-ca go together")
        tls = dict(
            certfile=args.tls_cert, keyfile=args.tls_key, cafile=args.tls_ca
        )
    world = RealWorld("127.0.0.1:0", tls=tls)
    world.activate()
    db = Database.from_coordinators(world, coordinators)
    cli = FdbCli(db, coordinators)

    def run_one(line: str) -> int:
        try:
            out = world.run_until_done(spawn(cli.execute(line)), args.timeout)
        except TimeoutError:
            print("ERROR: timed out", flush=True)
            return 1
        print(out, flush=True)
        return 1 if out.startswith("ERROR") else 0

    rc = 0
    try:
        if args.cmds:
            for line in args.cmds:
                rc |= run_one(line)
        else:
            for line in sys.stdin:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if line in ("exit", "quit"):
                    break
                rc |= run_one(line)
    finally:
        world.close()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
