"""Trace-file consumer: summarize a JSONL trace (plus its rolled
siblings) the way an operator reads the reference's XML traces — event
rates, the loudest SevWarn+ types, per-role metrics timelines from the
periodic ``*Metrics`` CounterCollection events — and read the span layer
(runtime/trace.py): per-trace waterfalls and an aggregate critical-path
breakdown ("p50 read = client rpc X ms + storage engine Z ms + ...").

  python -m foundationdb_tpu_torch.tools.trace_analyze trace.jsonl [more.jsonl ...]
      [--top N] [--spans] [--trace TRACE_ID] [--slow-tasks] [--json]

Multiple trace files merge in time order — a TCP cluster writes one file
per fdbserver, and a trace's spans scatter across all of them. Rolled
siblings (path.N) of every file are always included.

`analyze()` / `format_summary()` / `spans_by_trace()` / `critical_path()`
are importable so tests and other tools (the status pipeline's consumers,
perf's bench capture) use the same aggregation the CLI prints."""

from __future__ import annotations

import json
import os

_META_FIELDS = ("Severity", "Type", "Time", "Machine", "ID", "Elapsed")
_WARN_SEVERITIES = ("Warn", "WarnAlways", "Error")


def _read_jsonl(path: str) -> list[dict]:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                continue  # a roll can truncate the last line
    return events


def load_events(path, keep_files: int = 10) -> list[dict]:
    """Events from one path or a LIST of paths — each with any rolled
    siblings (path.N oldest first, then the live file) — merged in time
    order. One roll must not hide the run's history, and one process's
    file must not hide the rest of the cluster's: TCP clusters write one
    trace file per fdbserver, so span consumers hand every per-process
    file to one call and get a single timeline back."""
    roots = [path] if isinstance(path, (str, os.PathLike)) else list(path)
    events = []
    for root in roots:
        paths = [
            f"{root}.{i}"
            for i in range(keep_files, 0, -1)
            if os.path.exists(f"{root}.{i}")
        ]
        if os.path.exists(root):
            paths.append(root)
        for p in paths:
            events.extend(_read_jsonl(p))
    if len(roots) > 1:
        # merge across processes: stable sort keeps each file's intra-tick
        # emission order for same-time events
        events.sort(key=lambda e: e.get("Time") or 0.0)
    return events


def analyze(events: list[dict], top: int = 10) -> dict:
    """Aggregate a trace into the operator summary (pure function)."""
    by_type: dict[str, int] = {}
    by_severity: dict[str, int] = {}
    warn_types: dict[str, int] = {}
    times = []
    timelines: dict[str, dict] = {}
    for e in events:
        t = e.get("Type", "?")
        by_type[t] = by_type.get(t, 0) + 1
        sev = str(e.get("Severity", "?"))
        by_severity[sev] = by_severity.get(sev, 0) + 1
        if sev in _WARN_SEVERITIES:
            warn_types[t] = warn_types.get(t, 0) + 1
        when = e.get("Time")
        if isinstance(when, (int, float)):
            times.append(when)
        if t.endswith("Metrics"):
            key = f"{t}#{e.get('ID') or e.get('Machine') or ''}"
            tl = timelines.setdefault(
                key,
                {
                    "points": 0,
                    "first_time": when,
                    "last_time": when,
                    "first": {},
                    "last": {},
                },
            )
            tl["points"] += 1
            tl["last_time"] = when
            for k, v in e.items():
                if k in _META_FIELDS or not isinstance(v, (int, float)):
                    continue
                tl["first"].setdefault(k, v)
                tl["last"][k] = v
    span = (max(times) - min(times)) if len(times) > 1 else 0.0
    top_types = sorted(by_type.items(), key=lambda kv: -kv[1])[:top]
    top_warns = sorted(warn_types.items(), key=lambda kv: -kv[1])[:top]
    return {
        "events": len(events),
        "time_span_seconds": round(span, 3),
        "events_per_second": round(len(events) / span, 2) if span > 0 else None,
        "by_severity": by_severity,
        "top_types": top_types,
        "top_warn_types": top_warns,
        "timelines": timelines,
    }


def format_summary(summary: dict) -> str:
    lines = [
        f"{summary['events']} events over {summary['time_span_seconds']}s"
        + (
            f" ({summary['events_per_second']}/s)"
            if summary["events_per_second"]
            else ""
        ),
        "severity: "
        + ", ".join(f"{k}={v}" for k, v in sorted(summary["by_severity"].items())),
        "",
        "top event types:",
    ]
    for t, n in summary["top_types"]:
        lines.append(f"  {n:8d}  {t}")
    if summary["top_warn_types"]:
        lines.append("")
        lines.append("top SevWarn+ types:")
        for t, n in summary["top_warn_types"]:
            lines.append(f"  {n:8d}  {t}")
    if summary["timelines"]:
        lines.append("")
        lines.append("role metrics timelines (counter deltas first→last):")
        for key, tl in sorted(summary["timelines"].items()):
            deltas = []
            for k, last in tl["last"].items():
                first = tl["first"].get(k, 0)
                if isinstance(last, (int, float)) and last != first:
                    deltas.append(f"{k}+{round(last - first, 3)}")
            span = (tl["last_time"] or 0) - (tl["first_time"] or 0)
            lines.append(
                f"  {key}: {tl['points']} points over {round(span, 1)}s  "
                + (" ".join(deltas[:8]) if deltas else "(no movement)")
            )
    return "\n".join(lines)


# -- timeline mode (metrics history) -------------------------------------------

_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values: list) -> str:
    """Unicode block sparkline for a numeric series (shared with the
    `cli metrics` renderer)."""
    if not values:
        return ""
    lo, hi = min(values), max(values)
    if hi == lo:
        return _SPARK_CHARS[0] * len(values)
    span = hi - lo
    return "".join(
        _SPARK_CHARS[min(len(_SPARK_CHARS) - 1, int((v - lo) / span * len(_SPARK_CHARS)))]
        for v in values
    )


def timeline_series(events: list[dict], counter: str = None) -> dict:
    """Full per-counter series from the periodic ``*Metrics`` trace
    events: timeline key (``Type#ID``) → {counter: [(t, value)]}. The
    offline twin of the live metrics-history ring — `analyze()` keeps
    only first/last, this keeps every point so --timeline can draw the
    shape between them. ``counter`` filters to one counter name."""
    out: dict[str, dict] = {}
    for e in events:
        t = e.get("Type", "?")
        if not t.endswith("Metrics"):
            continue
        when = e.get("Time")
        if not isinstance(when, (int, float)):
            continue
        key = f"{t}#{e.get('ID') or e.get('Machine') or ''}"
        series = out.setdefault(key, {})
        for k, v in e.items():
            if k in _META_FIELDS or not isinstance(v, (int, float)):
                continue
            if isinstance(v, bool) or (counter and k != counter):
                continue
            series.setdefault(k, []).append((when, v))
    return {k: v for k, v in out.items() if v}


def format_timeline(tls: dict, counter: str = None, width: int = 60) -> str:
    """Sparkline timelines for every (role, counter) series — bounded to
    ``width`` points by tail-keeping (the newest shape is the signal)."""
    if not tls:
        return (
            f"no points for counter {counter!r} in any *Metrics event"
            if counter
            else "no *Metrics events (trace too short, or metrics loops off)"
        )
    lines = []
    for key in sorted(tls):
        series = tls[key]
        lines.append(f"{key}:")
        for name in sorted(series):
            pts = series[name][-width:]
            vals = [v for _t, v in pts]
            lines.append(
                f"  {name:32s} {sparkline(vals)}  "
                f"[{min(vals):g}..{max(vals):g}] last {vals[-1]:g} "
                f"({len(series[name])} pts)"
            )
    return "\n".join(lines)


# -- slow-task mode (run-loop profiler, runtime/profiler.py) -------------------


def slow_tasks(events: list[dict], top: int = 10) -> dict:
    """Aggregate ``Type="SlowTask"`` events (the run-loop profiler's
    blocking-callback attribution) across the merged multi-file timeline:
    per-actor count / total / worst busy time, plus which processes and
    priority bands the stalls hit. The table an operator reads to answer
    "who blocked the loop, where, and for how long"."""
    rows: dict[str, dict] = {}
    total = 0
    for e in events:
        if e.get("Type") != "SlowTask":
            continue
        total += 1
        name = e.get("Actor") or "?"
        r = rows.setdefault(
            name,
            {
                "actor": name,
                "count": 0,
                "total_ms": 0.0,
                "max_ms": 0.0,
                "bands": set(),
                "machines": set(),
            },
        )
        r["count"] += 1
        ms = e.get("BusyMs") or 0.0
        r["total_ms"] += ms
        if ms > r["max_ms"]:
            r["max_ms"] = ms
        if e.get("Band"):
            r["bands"].add(str(e["Band"]))
        if e.get("Machine"):
            r["machines"].add(str(e["Machine"]))
    actors = sorted(rows.values(), key=lambda r: (-r["total_ms"], r["actor"]))[:top]
    return {
        "events": total,
        "actors": [
            {
                "actor": r["actor"],
                "count": r["count"],
                "total_ms": round(r["total_ms"], 3),
                "max_ms": round(r["max_ms"], 3),
                "bands": sorted(r["bands"]),
                "machines": sorted(r["machines"]),
            }
            for r in actors
        ],
    }


def format_slow_tasks(st: dict) -> str:
    if not st["events"]:
        return "no SlowTask events (loop never blocked past RUN_LOOP_SLOW_TASK_MS)"
    lines = [
        f"{st['events']} SlowTask events; top actors by total loop time held:",
        f"{'total ms':>10}  {'max ms':>8}  {'count':>6}  actor [bands] @ machines",
    ]
    for r in st["actors"]:
        lines.append(
            f"{r['total_ms']:10.2f}  {r['max_ms']:8.2f}  {r['count']:6d}  "
            f"{r['actor']} [{','.join(r['bands'])}] @ {','.join(r['machines'])}"
        )
    return "\n".join(lines)


# -- span mode (distributed traces, runtime/trace.py) --------------------------


def spans_by_trace(events: list[dict]) -> dict:
    """trace_id → [span event] (Begin-ordered), merged across processes."""
    out: dict[str, list[dict]] = {}
    for e in events:
        if e.get("Type") == "Span" and e.get("Trace"):
            out.setdefault(e["Trace"], []).append(e)
    for spans in out.values():
        spans.sort(key=lambda s: (s.get("Begin") or 0.0, s.get("SpanId") or ""))
    return out


def _span_children(spans: list[dict]) -> dict:
    kids: dict[str, list[dict]] = {}
    for s in spans:
        kids.setdefault(s.get("Parent") or "", []).append(s)
    return kids


def _roots(spans: list[dict]) -> list[dict]:
    """Spans whose parent is the trace root or isn't in this trace (a hop
    whose file is missing): the waterfall's top level."""
    ids = {s.get("SpanId") for s in spans}
    return [s for s in spans if (s.get("Parent") or "") not in ids]


def format_waterfall(events: list[dict], trace_id: str, width: int = 48) -> str:
    """One trace's spans as an indented waterfall with time bars."""
    spans = spans_by_trace(events).get(trace_id)
    if not spans:
        return f"no spans for trace {trace_id!r}"
    t0 = min(s.get("Begin") or 0.0 for s in spans)
    t1 = max((s.get("Begin") or 0.0) + (s.get("Dur") or 0.0) for s in spans)
    total = max(t1 - t0, 1e-9)
    kids = _span_children(spans)
    lines = [f"trace {trace_id}: {total * 1000:.3f} ms, {len(spans)} spans"]

    def render(s, depth):
        b = (s.get("Begin") or 0.0) - t0
        d = s.get("Dur") or 0.0
        lo = int(b / total * width)
        hi = max(lo + 1, int((b + d) / total * width))
        bar = " " * lo + "█" * (hi - lo)
        lines.append(
            f"  +{b * 1000:8.3f} ms {d * 1000:8.3f} ms "
            f"|{bar:<{width}}| "
            + "  " * depth
            + f"{s.get('Name', '?')} @ {s.get('Machine', '')}"
        )
        for c in kids.get(s.get("SpanId"), []):
            render(c, depth + 1)

    for r in _roots(spans):
        render(r, 0)
    return "\n".join(lines)


def _interval_union(ivs: list) -> float:
    """Total length covered by a set of (begin, end) intervals."""
    total, cur_b, cur_e = 0.0, None, None
    for b, e in sorted(ivs):
        if e <= b:
            continue
        if cur_e is None or b > cur_e:
            if cur_e is not None:
                total += cur_e - cur_b
            cur_b, cur_e = b, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_b
    return total


def critical_path(events: list[dict], root_prefix: str = "") -> dict:
    """Aggregate stage attribution across traces: for each root-span name
    (optionally filtered by prefix, e.g. "Client."), the p50/mean total
    and the mean SELF time of every span name under it. Self time is a
    span's duration minus the UNION of its children's intervals (clipped
    to the span) — concurrent children and both sides of an RPC hop
    (e.g. the proxy's resolve stage and the resolver's own span cover the
    same wall time) are counted once, so per trace the stages sum to the
    root duration and named stages account for the whole measured
    latency, unattributed wire/queue time landing in each parent's self
    time."""
    by_trace = spans_by_trace(events)
    per_root: dict[str, dict] = {}
    for spans in by_trace.values():
        ids = {s.get("SpanId"): s for s in spans}
        kids = _span_children(spans)

        def self_times(root, acc):
            stack = [root]
            while stack:
                s = stack.pop()
                cs = kids.get(s.get("SpanId"), [])
                b = s.get("Begin") or 0.0
                d = s.get("Dur") or 0.0
                covered = _interval_union(
                    [
                        (
                            max(b, c.get("Begin") or 0.0),
                            min(b + d, (c.get("Begin") or 0.0) + (c.get("Dur") or 0.0)),
                        )
                        for c in cs
                    ]
                )
                name = s.get("Name", "?")
                acc[name] = acc.get(name, 0.0) + max(0.0, d - covered)
                stack.extend(cs)

        for r in _roots(spans):
            name = r.get("Name", "?")
            if root_prefix and not name.startswith(root_prefix):
                continue
            agg = per_root.setdefault(name, {"totals": [], "stages": {}})
            agg["totals"].append(r.get("Dur") or 0.0)
            acc: dict[str, float] = {}
            self_times(r, acc)
            for st, t in acc.items():
                agg["stages"][st] = agg["stages"].get(st, 0.0) + t

    out = {}
    for name, agg in per_root.items():
        totals = sorted(agg["totals"])
        n = len(totals)
        mean = sum(totals) / n
        stages = [
            {
                "stage": st,
                "mean_ms": round(t / n * 1000, 4),
                "share": round((t / n) / mean, 4) if mean > 0 else 0.0,
            }
            for st, t in sorted(agg["stages"].items(), key=lambda kv: -kv[1])
        ]
        out[name] = {
            "traces": n,
            "p50_ms": round(totals[n // 2] * 1000, 4),
            # nearest-rank p99 — the tail number watch-latency SLOs cite
            "p99_ms": round(totals[min(n - 1, (n * 99) // 100)] * 1000, 4),
            "mean_ms": round(mean * 1000, 4),
            "stages": stages,
            # named-stage coverage of the mean (== 1.0 by construction
            # when every span nests; <1 flags spans lost to missing files)
            "coverage": round(
                sum(s["mean_ms"] for s in stages) / (mean * 1000), 4
            )
            if mean > 0
            else 0.0,
        }
    return out


def format_critical_path(cp: dict) -> str:
    if not cp:
        return "no sampled spans (set TRACE_SAMPLE_RATE or a debug id)"
    lines = []
    for name, agg in sorted(cp.items()):
        lines.append(
            f"{name}: p50 {agg['p50_ms']:.3f} ms / p99 {agg['p99_ms']:.3f} ms "
            f"over {agg['traces']} traces "
            f"(stage coverage {agg['coverage']:.0%})"
        )
        for s in agg["stages"]:
            lines.append(
                f"    {s['mean_ms']:9.3f} ms  {s['share']:6.1%}  {s['stage']}"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="trace-analyze")
    ap.add_argument(
        "trace",
        nargs="+",
        help="JSONL trace file(s) — per-process files merge; rolled "
        "siblings always included",
    )
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--spans",
        action="store_true",
        help="span mode: critical-path breakdown (and waterfalls via --trace)",
    )
    ap.add_argument("--trace-id", default=None, help="render one trace's waterfall")
    ap.add_argument(
        "--slow-tasks",
        action="store_true",
        dest="slow_tasks",
        help="top-N table of SlowTask events (run-loop blocking attribution)",
    )
    ap.add_argument(
        "--timeline",
        action="store_true",
        help="sparkline timelines of the periodic *Metrics counters "
        "(every point, not just first→last deltas)",
    )
    ap.add_argument(
        "--counter",
        default=None,
        help="with --timeline: restrict to one counter name",
    )
    args = ap.parse_args(argv)
    events = load_events(args.trace)
    if args.timeline:
        tls = timeline_series(events, counter=args.counter)
        if args.json:
            print(json.dumps(tls, indent=1, default=str))
        else:
            print(format_timeline(tls, counter=args.counter))
        return 0
    if args.trace_id:
        print(format_waterfall(events, args.trace_id))
        return 0
    if args.slow_tasks:
        st = slow_tasks(events, top=args.top)
        if args.json:
            print(json.dumps(st, indent=1, default=str))
        else:
            print(format_slow_tasks(st))
        return 0
    if args.spans:
        cp = critical_path(events)
        if args.json:
            print(json.dumps(cp, indent=1, default=str))
        else:
            print(format_critical_path(cp))
        return 0
    summary = analyze(events, top=args.top)
    if args.json:
        print(json.dumps(summary, indent=1, default=str))
    else:
        print(format_summary(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
