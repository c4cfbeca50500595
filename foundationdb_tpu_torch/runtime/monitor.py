"""SystemMonitor: periodic process-health trace events.

The analog of flow/SystemMonitor.cpp (systemMonitor → ProcessMetrics /
MachineMetrics / NetworkMetrics): every interval, one trace event with the
process's vitals — run-loop lag (scheduling delay of a zero-delay timer,
the reference's S2Pri/loop-busyness signal), live actor count, posted-
queue depth, memory use, and event-loop personality. Used by real servers
(tools/fdbserver spawns it per process) and available to sims.

The port's copy of ``foundationdb_tpu/runtime/monitor.py``. Its samples
are host values (memory, lag) and stay out of every transcript."""

from __future__ import annotations

from .loop import current_loop, now
from .trace import SevInfo, trace


def memory_kb() -> tuple[int, int]:
    """(current RSS KB, peak RSS KB). ``ru_maxrss`` is the lifetime
    HIGH-WATER mark, not the current footprint — reporting it as MemoryKB
    made a post-spike process look permanently bloated. Current RSS comes
    from /proc/self/statm when available (Linux); elsewhere both report
    the rusage peak."""
    peak = 0
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except Exception:
        pass
    cur = peak
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])  # resident field
        import os

        cur = pages * os.sysconf("SC_PAGE_SIZE") // 1024
    except Exception:
        pass
    return cur, peak


async def system_monitor(process, interval: float = 5.0):
    from .futures import delay

    loop = current_loop()
    last = now()
    while True:
        before = now()
        await delay(interval)
        lag = max(0.0, (now() - before) - interval)
        rss_kb, peak_kb = memory_kb()
        coll = getattr(process, "actors", None)
        n_actors = len(getattr(coll, "_actors", []) or [])
        sample = dict(
            Elapsed=round(now() - last, 3),
            RunLoopLag=round(lag, 6),
            Actors=n_actors,
            Endpoints=len(getattr(process, "endpoints", {}) or {}),
            QueueDepth=len(getattr(loop, "_queue", []) or []),
            MemoryKB=rss_kb,
            PeakMemoryKB=peak_kb,
        )
        # run-loop profiler vitals (runtime/profiler.py) when installed:
        # the headline numbers an operator scans ProcessMetrics for before
        # reaching for `cli top` / the process.metrics snapshot
        prof = getattr(loop, "profiler", None)
        if prof is not None:
            sample["LoopSteps"] = prof._c_steps.value
            sample["SlowTasks"] = prof._c_slow.value
            sample["LoopBusyFraction"] = round(prof.busy_fraction(), 6)
        # latest sample stays readable on demand (the status document's
        # machine/process sections pull it through worker.systemMetrics)
        process.last_process_metrics = sample
        trace(
            SevInfo,
            "ProcessMetrics",
            getattr(process, "address", ""),
            **sample,
        )
        last = now()
