"""Transaction debug chains: assemble where a sampled commit's time went.

The analog of reading g_traceBatch's CommitDebug attach-id events
(MasterProxyServer.actor.cpp:345-358, Resolver.actor.cpp:83) back into a
latency breakdown. Every pipeline stage traces
``CommitDebug Id=<id> Event=<stage>``; ``chain()`` collects one id's
events in time order with per-hop deltas, ``format_chain()`` renders the
breakdown a human reads to see where the milliseconds went.

In simulation all processes share one TraceLog, so the chain assembles
directly; for real clusters pass the merged events from the per-process
trace files (each fdbserver writes --tracefile JSON lines).

The port's copy of ``foundationdb_tpu/tools/commit_chain.py``: the same
stages and rendering over the port's trace log.
"""

from __future__ import annotations

from ..runtime.trace import trace_log

# Stage vocabulary, unified with the span layer (runtime/trace.py): the
# commit stages are emitted through Span.event (Type=CommitDebug — the
# historical stream, byte-stable for existing consumers) and the read/GRV
# stages through the same API with Type=ReadDebug, so read chains never
# leak into commit-only chains. Order = pipeline order, used to break
# same-time ties.
COMMIT_STAGES = [
    "ClientCommitStart",
    "ProxyReceived",
    "GotCommitVersion",
    "Resolving",
    "Resolved",
    "Logged",
    "Replied",
    "ClientCommitDone",
]
READ_STAGES = [
    "ClientGRVStart",
    "ClientGRVDone",
    "ClientReadStart",
    "StorageRead",
    "ClientReadRetry",
    "ClientReadDone",
]
# watch lifecycle spans: Client.watch covers register→fire on
# the client, Storage.watchFire the server-side queue→fire interval — kept
# after the read stages so the historical prefix stays byte-stable
WATCH_STAGES = [
    "Client.watch",
    "Storage.watchFire",
]
# conflict pre-filter: Proxy.prefilter is the span for a
# local pre-rejection (probe→not_committed, no batch), Prefiltered its
# CommitDebug event — appended so the historical prefix stays byte-stable
PREFILTER_STAGES = [
    "Proxy.prefilter",
    "Prefiltered",
]
STAGE_ORDER = COMMIT_STAGES + READ_STAGES + WATCH_STAGES + PREFILTER_STAGES

# event Types that carry chain stages; chain() reads only the commit
# stream by default (output stability), full_chain() reads both
CHAIN_TYPES = ("CommitDebug", "ReadDebug")


def chain(debug_id: str, events: list = None, types=("CommitDebug",)) -> list[dict]:
    """Time-ordered debug events for one id (ties broken by pipeline
    stage order). Default: the CommitDebug stream only — exactly the
    historical output; pass ``types=CHAIN_TYPES`` (or use full_chain) to
    include the read-path stages."""
    evs = events if events is not None else trace_log().events
    rank = {s: i for i, s in enumerate(STAGE_ORDER)}
    out = [
        e
        for e in evs
        if e.get("Type") in types and e.get("Id") == debug_id
    ]
    out.sort(key=lambda e: (e["Time"], rank.get(e.get("Event"), 99)))
    return out


def full_chain(debug_id: str, events: list = None) -> list[dict]:
    """Commit AND read/GRV stages for one id, time-ordered."""
    return chain(debug_id, events, types=CHAIN_TYPES)


def format_chain(debug_id: str, events: list = None) -> str:
    evs = chain(debug_id, events)
    if not evs:
        return f"no CommitDebug events for id {debug_id!r}"
    t0 = evs[0]["Time"]
    prev = t0
    lines = [f"commit {debug_id}: {((evs[-1]['Time'] - t0) * 1000):.3f} ms total"]
    for e in evs:
        where = e.get("Proxy") or e.get("Resolver") or e.get("Machine") or ""
        lines.append(
            f"  +{(e['Time'] - t0) * 1000:7.3f} ms "
            f"(Δ {(e['Time'] - prev) * 1000:6.3f}) "
            f"{e.get('Event', '?'):18s} {where}"
        )
        prev = e["Time"]
    return "\n".join(lines)


def sampled_ids(events: list = None) -> list[str]:
    """Every debug id seen, in first-appearance order."""
    evs = events if events is not None else trace_log().events
    seen, out = set(), []
    for e in evs:
        if e.get("Type") == "CommitDebug" and e.get("Id") not in seen:
            seen.add(e["Id"])
            out.append(e["Id"])
    return out
