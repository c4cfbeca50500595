"""What the soak's parity tests share: a soak run in both packages, held
to ``==`` (``same``), or, where kernel faults are armed, held to the
reference across the faults (``same_across_kernel_faults``).

The port's resolver takes a kernel fault on purpose otherwise than the
reference's (ROADMAP §C: one batch encodes ahead, and recovery
re-resolves in version order behind a fence), so with kernel-fault
injection armed the injector's draws fall on other batches, and the two
runs' traces part at or after the first kernel fault. What does not
depend on which batches the faults hit is held to the reference's:

- the trace up to where the runs part, which reaches the first kernel
  fault and holds at least a third of the port's events;
- the summary, but for the three counts the faults' timing decides (the
  buggify sites fired, their number, and the pre-filter rejections the
  oracle re-checked);
- the rows the ConsistencyCheck reads at the end of the run from the
  workloads that write each drawn operation exactly once, from their own
  random stream, whatever the commit timing (``ORDER_FREE``):
  KernelChaos's counters, per-increment markers and availability probe
  (its exact ledger), Cycle's ring, Sideband's messages and
  ApiCorrectness's keys. The other workloads redraw what they write when
  a transaction retries, so their rows follow the timing.

The port's run also passes every check of ``run_one`` (the workloads'
oracles, the exact ledger of ``KernelChaosWorkload``, the
ConsistencyCheck, the prefilter oracle) and replays to the same
transcript from its seed."""

from soak_slice import run_soak

REFERENCE, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"
# the summary's counts that follow which batches the kernel faults hit
DRAWN = ("buggify_fired", "buggify_sites", "prefilter_rejections_checked")
# the key prefixes of the workloads whose rows do not follow commit timing
ORDER_FREE = (b"kchaos/", b"cycle/", b"sideband/", b"apicheck/")


def same(seed, fn="run_one", mesh=False, **kw) -> dict:
    port = run_soak(PORT, fn, seed, mesh=mesh, **kw)
    ref = run_soak(REFERENCE, fn, seed, mesh=mesh, **kw)
    for part in ("summary", "roles", "guards", "recoveries", "now", "events", "image"):
        assert port[part] == ref[part], part
    return port


def first_kernel_event(events) -> int:
    return next((i for i, e in enumerate(events) if dict(e)["Type"].startswith("Kernel")), len(events))


def order_free_rows(image) -> list:
    return [(k, v) for k, v in image if k.startswith(ORDER_FREE)]


def same_across_kernel_faults(seed, **kw) -> dict:
    port = run_soak(PORT, "run_one", seed, **kw)
    ref = run_soak(REFERENCE, "run_one", seed, **kw)
    summary, ref_summary = dict(port["summary"]), dict(ref["summary"])
    assert summary["kernel_faults_armed"] and "KernelChaosWorkload" in summary["workloads"]
    assert sorted(summary) == sorted(ref_summary)
    for key in summary:
        if key not in DRAWN:
            assert summary[key] == ref_summary[key], key
    events, ref_events = port["events"], ref["events"]
    cut = next((i for i, (a, b) in enumerate(zip(events, ref_events)) if a != b), min(len(events), len(ref_events)))
    assert first_kernel_event(events) <= cut and 3 * cut >= len(events), (cut, len(events))
    rows = order_free_rows(port["image"])
    assert any(k.startswith(b"kchaos/m/") for k, _v in rows)
    assert {k.split(b"/")[0] + b"/" for k, _v in rows} == set(ORDER_FREE)
    assert rows == order_free_rows(ref["image"])
    assert run_soak(PORT, "run_one", seed, **kw) == port
    return port


def kernel_sites(transcript) -> list:
    return [s for s in dict(transcript["summary"])["buggify_sites"] if s.startswith("kernel-")]
