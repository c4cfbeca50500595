"""Structured trace events — the analog of flow/Trace.cpp TraceEvent.

Events are dicts with severity, type, time, and process identity, collected
per run (and optionally mirrored to a JSONL file, the counterpart of the
reference's rolling XML trace logs — like the reference, the file rolls at
a size threshold, keeping a bounded set of numbered predecessors). A
SevError event marks the run failed — exactly the simulator's pass/fail
criterion (SURVEY.md §3.4).

Distributed spans (the analog of flow/Tracing.h Span/SpanContext) live
here too: a ``Span`` is a timed interval inside one trace, emitted as a
``Type="Span"`` event when it finishes, so spans share the TraceLog's
JSONL files, rolling, and consumers. The ambient *active* span context is
carried per-actor by the futures machinery (runtime/futures.py saves and
restores it around every actor step, so it survives awaits and is
inherited at spawn) and across RPCs by the network envelopes (net/sim.py,
net/tcp.py) — servers inherit the caller's context without any request
dataclass knowing about tracing. Unsampled traces cost one None check:
``span()`` returns the shared no-op span unless an ancestor was sampled.

Determinism: span ids count up per event loop (not per process image), and
sampling decisions draw from seeded RNGs, so two same-seed sim runs emit
byte-identical span sets.
"""

from __future__ import annotations

import json
import os
from typing import Optional

SevDebug, SevInfo, SevWarn, SevWarnAlways, SevError = 5, 10, 20, 30, 40

_SEV_NAMES = {5: "Debug", 10: "Info", 20: "Warn", 30: "WarnAlways", 40: "Error"}

# the reference rolls trace files at 10 MB (TraceLog's maxLogsSize /
# rollsize, flow/Trace.cpp) and prunes old ones; same defaults here —
# overridable per-log (tools pass Knobs.TRACE_ROLL_BYTES / _KEEP)
DEFAULT_ROLL_BYTES = 10 << 20
DEFAULT_ROLL_KEEP = 10


class TraceLog:
    def __init__(
        self,
        path: Optional[str] = None,
        min_severity: int = SevInfo,
        max_file_bytes: int = DEFAULT_ROLL_BYTES,
        keep_files: int = DEFAULT_ROLL_KEEP,
    ):
        self.events: list[dict] = []
        self.error_count = 0
        self.min_severity = min_severity
        self.path = path
        self.max_file_bytes = max_file_bytes
        self.keep_files = max(1, keep_files)
        self.rolls = 0
        self._file = open(path, "a") if path else None
        self._file_bytes = os.path.getsize(path) if path else 0

    def log(self, severity: int, event_type: str, time: float, process: str, **fields):
        if severity < self.min_severity:
            return
        ev = {
            "Severity": _SEV_NAMES.get(severity, severity),
            "Type": event_type,
            "Time": round(time, 6),
            "Machine": process,
            **fields,
        }
        self.events.append(ev)
        if severity >= SevError:
            self.error_count += 1
        if self._file:
            line = json.dumps(ev, default=str) + "\n"
            self._file.write(line)
            self._file.flush()
            self._file_bytes += len(line)
            if self.max_file_bytes and self._file_bytes >= self.max_file_bytes:
                self._roll()

    def _roll(self) -> None:
        """Rotate path → path.1 → … → path.N (oldest deleted), then reopen
        a fresh file. The live handle closes promptly so rolled files
        never pin descriptors."""
        self._file.close()
        self._file = None
        oldest = f"{self.path}.{self.keep_files}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.keep_files - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._file = open(self.path, "a")
        self._file_bytes = 0
        self.rolls += 1

    def rolled_paths(self) -> list[str]:
        """Existing rolled siblings, oldest first (for trace consumers)."""
        if not self.path:
            return []
        out = []
        for i in range(self.keep_files, 0, -1):
            p = f"{self.path}.{i}"
            if os.path.exists(p):
                out.append(p)
        return out

    def of_type(self, event_type: str) -> list[dict]:
        return [e for e in self.events if e["Type"] == event_type]

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


_global_log = TraceLog(min_severity=SevInfo)


def set_trace_log(log: TraceLog) -> None:
    global _global_log
    _global_log = log


def trace_log() -> TraceLog:
    return _global_log


def trace(severity: int, event_type: str, process: str = "", **fields) -> None:
    from .loop import _current

    t = _current.now() if _current is not None else 0.0
    _global_log.log(severity, event_type, t, process, **fields)


# -- distributed spans ---------------------------------------------------------

SPAN_EVENT = "Span"

# the ambient active context: the SpanContext of the span (local or remote
# parent) the currently-running actor is inside. Mutated ONLY through
# swap_active_span — the futures machinery and the RPC dispatch paths own
# the save/restore discipline.
_active_span: Optional["SpanContext"] = None


class SpanContext:
    """(trace_id, span_id) of a sampled span — what crosses RPC hops.
    Only sampled contexts exist as objects; an unsampled trace is simply
    the absence of one (the reference's Span::context with sampled bit)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}/{self.span_id})"


class Span:
    """One timed stage of a trace. Emits a ``Type="Span"`` event at
    finish; ``with span(...)`` activates it as the ambient context so
    child spans and outbound RPCs inherit it."""

    __slots__ = ("name", "context", "parent_id", "process", "begin", "tags", "_prev", "_done")

    def __init__(self, name: str, context: SpanContext, parent_id: str, process: str, tags: dict):
        from .loop import _current

        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.process = process
        self.begin = _current.now() if _current is not None else 0.0
        self.tags = tags
        self._prev = None
        self._done = False

    @property
    def sampled(self) -> bool:
        return True

    def tag(self, **kw) -> "Span":
        self.tags.update(kw)
        return self

    def event(self, event: str, kind: str = "CommitDebug", **fields) -> None:
        """Point annotation on this span's trace — emitted in the debug
        stream (tools/commit_chain.py's input), so the debug chains are
        now a span-layer product. Commit stages keep the ``CommitDebug``
        type (chain() output stays byte-stable for existing consumers);
        read-path stages use ``ReadDebug`` and join only opt-in chains."""
        trace(
            SevInfo, kind, self.process,
            Id=self.context.trace_id, Event=event, **fields,
        )

    def finish(self, end: Optional[float] = None) -> None:
        if self._done:
            return
        self._done = True
        from .loop import _current

        t = end if end is not None else (_current.now() if _current is not None else 0.0)
        trace(
            SevInfo, SPAN_EVENT, self.process,
            Trace=self.context.trace_id,
            SpanId=self.context.span_id,
            Parent=self.parent_id,
            Name=self.name,
            Begin=round(self.begin, 6),
            Dur=round(max(0.0, t - self.begin), 6),
            **self.tags,
        )

    # -- context-manager activation
    def __enter__(self) -> "Span":
        self._prev = swap_active_span(self.context)
        return self

    def __exit__(self, *exc) -> bool:
        swap_active_span(self._prev)
        self.finish()
        return False


class _NullSpan:
    """Shared no-op span for unsampled traces — every method is inert so
    instrumentation sites need no sampled-or-not branches."""

    __slots__ = ()
    sampled = False
    context = None

    def tag(self, **kw):
        return self

    def event(self, event: str, **fields) -> None:
        pass

    def finish(self, end=None) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


def active_span() -> Optional[SpanContext]:
    return _active_span


def swap_active_span(ctx: Optional[SpanContext]) -> Optional[SpanContext]:
    global _active_span
    prev = _active_span
    _active_span = ctx
    return prev


def _next_span_id(process: str) -> str:
    """Span ids count up PER EVENT LOOP (same-seed sim runs replay the
    same ids) and carry the process name (distinct OS processes in a TCP
    cluster cannot collide inside one trace)."""
    from .loop import _current

    if _current is not None:
        n = getattr(_current, "_span_seq", 0) + 1
        _current._span_seq = n
    else:  # no loop (import-time/tooling): never travels, uniqueness moot
        n = 0
    return f"{process}:{n}" if process else f":{n}"


def span(name: str, process: str = "", parent=None, **tags):
    """Open a span under ``parent`` (a SpanContext/Span) or, by default,
    the ambient active context. No sampled ancestor → the no-op span."""
    ctx = parent.context if isinstance(parent, Span) else parent
    if ctx is None:
        ctx = _active_span
    if ctx is None:
        return NULL_SPAN
    return Span(name, SpanContext(ctx.trace_id, _next_span_id(process)), ctx.span_id, process, tags)


def emit_span(name: str, process: str, parent, begin: float, end: float, **tags) -> Optional[str]:
    """Record an already-elapsed stage as a finished span (batch pipelines
    measure first, attribute after). Returns the span id, or None when
    ``parent`` is unsampled."""
    ctx = parent.context if isinstance(parent, Span) else parent
    if ctx is None:
        return None
    sp = Span(name, SpanContext(ctx.trace_id, _next_span_id(process)), ctx.span_id, process, tags)
    sp.begin = begin
    sp.finish(end)
    return sp.context.span_id


def annotate(event: str, process: str = "", kind: str = "ReadDebug", **fields) -> None:
    """Point annotation on the ambient trace (no-op when unsampled) —
    emitted into the debug stream so tools/commit_chain.py full chains
    carry it."""
    if _active_span is not None:
        trace(SevInfo, kind, process, Id=_active_span.trace_id, Event=event, **fields)


def root_context(trace_id: str) -> SpanContext:
    """The root of a new sampled trace: spans parented to it carry
    Parent="" (waterfall roots). The trace_id doubles as the transaction
    debug id, so CommitDebug chains and spans share one identity."""
    return SpanContext(trace_id, "")
