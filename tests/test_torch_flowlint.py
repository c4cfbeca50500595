"""The port's flowlint (``foundationdb_tpu_torch/tools/flowlint``) held to
the JAX package's analyzer, and the port's tree held clean by it.

- Every case of ``tests/test_flowlint.py`` runs on the port, its per-rule
  fixtures parametrized, at the port's relpaths.
- Parity: each fixture snippet, flagged and near-miss, gives the same
  ``(rule, line, scope, detail, message)`` findings in both packages'
  ``lint_source`` (relpath prefix mapped); the port's ``lint`` over the
  JAX package's tree, with that package's config and baseline passed in,
  gives its ``LintResult.to_json()`` but ``seconds``; and the synthetic
  worker/role trees of ``tests/test_collection_audit.py`` give the same
  findings in both.
- The gate: the port's tree has no unsuppressed finding under its own
  config and baseline, within the reference's 10 s budget.
- ``python -m foundationdb_tpu_torch.tools.flowlint``: the reference's
  flags (``--json``, ``--no-baseline``, ``--write-baseline``,
  ``--list-rules``, paths) and exit codes.
"""

import json
import time

import pytest

from foundationdb_tpu.tools import flowlint as ref_flowlint
from foundationdb_tpu.tools.flowlint import core as ref_core
from foundationdb_tpu_torch.tools.flowlint import (
    all_rules,
    format_baseline,
    lint,
    lint_source,
    load_baseline,
    load_config,
)
from foundationdb_tpu_torch.tools.flowlint.core import DEFAULT_ROOT
from test_flowlint import FIXTURES

REF_PKG = "foundationdb_tpu"
PORT_PKG = "foundationdb_tpu_torch"
SIM = f"{PORT_PKG}/runtime/mod.py"  # a sim-reachable relpath for fixtures


def rule_hits(src, rule, relpath=SIM):
    return [f for f in lint_source(src, relpath=relpath) if f.rule == rule]


# ---------------------------------------------------------------------------
# The cases of tests/test_flowlint.py, on the port


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_flags_and_near_miss(rule):
    flagged, near_miss = FIXTURES[rule]
    assert rule_hits(flagged, rule), f"{rule}: must flag the minimal snippet"
    assert not rule_hits(near_miss, rule), f"{rule}: must pass the near-miss"


def test_every_shipped_rule_has_a_fixture():
    PROJECT_RULES_TESTED_ELSEWHERE = {"reg-role-metrics", "reg-endpoint-span"}
    ids = {r.id for r in all_rules()}
    covered = set(FIXTURES) | PROJECT_RULES_TESTED_ELSEWHERE
    assert ids == covered, (
        f"rules without fixtures: {ids - covered}; "
        f"fixtures without rules: {covered - ids}"
    )


DROPPED_SPAWN = (
    "from ..runtime.futures import spawn\n"
    "async def work():\n"
    "    return 1\n"
    "def boot():\n"
    "    spawn(work())\n"
)
HELD_SPAWN = (
    "from ..runtime.futures import spawn\n"
    "async def work():\n"
    "    return 1\n"
    "def boot(actors):\n"
    "    actors.add(spawn(work()))\n"
)
DROPPED_IN_INIT = (
    "class C:\n"
    "    def __init__(self):\n"
    "        self.warm_up()\n"
    "    async def warm_up(self):\n"
    "        return 1\n"
)
RETRY_NEAR_MISSES = (
    # bounded for-loop
    "async def f(ep):\n"
    "    for _attempt in range(5):\n"
    "        try:\n"
    "            return await ep()\n"
    "        except Exception:\n"
    "            pass\n",
    # the client's on_error backoff idiom
    "async def f(db, body):\n"
    "    tr = db.transaction()\n"
    "    while True:\n"
    "        try:\n"
    "            return await body(tr)\n"
    "        except Cancelled:\n"
    "            raise\n"
    "        except Exception as e:\n"
    "            await tr.on_error(e)\n",
    # a handler that exits the loop
    "async def f(ep):\n"
    "    while True:\n"
    "        try:\n"
    "            return await ep()\n"
    "        except Exception:\n"
    "            break\n",
    # not a retry loop: no error swallowed around the await
    "async def f(var):\n"
    "    while True:\n"
    "        await var.on_change()\n",
)
NO_AWAIT_IN_TRY = (
    "async def f(x):\n"
    "    try:\n"
    "        y = x + 1\n"
    "    except Exception:\n"
    "        y = 0\n"
    "    return y\n"
)
RERAISE = (
    "async def f(fut):\n"
    "    try:\n"
    "        await fut\n"
    "    except Exception:\n"
    "        raise\n"
)
WALL = "import time\ndef f():\n    return time.time(){}\n"
FILE_DISABLE = (
    "# flowlint: disable-file=det-wall-clock\n"
    "import time\n"
    "def f():\n"
    "    return time.time()\n"
    "def g():\n"
    "    return time.monotonic()\n"
)


def test_dropped_bare_spawn_flagged_but_held_spawn_passes():
    assert [f.detail for f in rule_hits(DROPPED_SPAWN, "actor-dropped-future")] == ["spawn"]
    assert not rule_hits(HELD_SPAWN, "actor-dropped-future")


def test_dropped_self_method_coroutine_in_init():
    hits = rule_hits(DROPPED_IN_INIT, "actor-dropped-future")
    assert [f.detail for f in hits] == ["self.warm_up"]
    assert hits[0].scope == "C.__init__"


def test_unbounded_retry_accepts_bounds_and_exits():
    for src in RETRY_NEAR_MISSES:
        assert not rule_hits(src, "actor-unbounded-retry"), src


def test_cancelled_swallow_requires_an_await_in_try():
    assert not rule_hits(NO_AWAIT_IN_TRY, "actor-cancelled-swallow")


def test_cancelled_swallow_reraise_passes():
    assert not rule_hits(RERAISE, "actor-cancelled-swallow")


def test_host_only_manifest_exempts_determinism_not_ad_hoc():
    src = WALL.format("")
    host = f"{PORT_PKG}/tools/tcp_soak.py"  # in the checked-in manifest
    assert rule_hits(src, "det-wall-clock", relpath=SIM)
    assert not rule_hits(src, "det-wall-clock", relpath=host)
    assert host in load_config()["host_only"]


def test_inline_disable_suppresses_only_named_rule_on_that_line():
    assert rule_hits(WALL.format(""), "det-wall-clock")
    assert not rule_hits(WALL.format("  # flowlint: disable=det-wall-clock"), "det-wall-clock")
    assert rule_hits(WALL.format("  # flowlint: disable=det-sleep"), "det-wall-clock")


def test_file_level_disable():
    assert not rule_hits(FILE_DISABLE, "det-wall-clock")


def _mini_tree(tmp_path, baseline_entries=None):
    pkg = tmp_path / PORT_PKG / "runtime"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text(
        "import time\n"
        "def f():\n"
        "    return time.time()\n"
    )
    config = {
        "include": [PORT_PKG],
        "exclude": ["scratch", "tests"],
        "sim_scope": [PORT_PKG],
        "host_only": {},
        "baseline": "baseline.json",
        "role_exempt": [],
        "span_roles": [],
        "worker_module": f"{PORT_PKG}/server/worker.py",
    }
    if baseline_entries is not None:
        (tmp_path / "baseline.json").write_text(json.dumps({"entries": baseline_entries}))
    return config


def test_baseline_round_trip(tmp_path):
    config = _mini_tree(tmp_path)
    first = lint(root=tmp_path, config=config)
    assert len(first.failing) == 1 and first.failing[0].rule == "det-wall-clock"
    (tmp_path / "baseline.json").write_text(
        format_baseline(first.failing, {first.failing[0].key: "known wall read"})
    )
    second = lint(root=tmp_path, config=config)
    assert second.clean
    assert [f.key for f in second.baselined] == [first.failing[0].key]
    assert not second.stale_baseline
    third = lint(root=tmp_path, config=config, baseline={})
    assert [f.key for f in third.failing] == [first.failing[0].key]


def test_stale_baseline_entries_are_reported(tmp_path):
    gone = f"{PORT_PKG}/gone.py::f::det-sleep::time.sleep"
    config = _mini_tree(tmp_path, baseline_entries={gone: "?"})
    assert lint(root=tmp_path, config=config).stale_baseline == [gone]


def test_baseline_key_is_line_churn_stable(tmp_path):
    config = _mini_tree(tmp_path)
    key0 = lint(root=tmp_path, config=config).failing[0].key
    mod = tmp_path / PORT_PKG / "runtime" / "mod.py"
    mod.write_text("# a new leading comment shifts every line\n" + mod.read_text())
    assert lint(root=tmp_path, config=config).failing[0].key == key0


def test_tree_is_flowlint_clean_within_budget():
    t0 = time.perf_counter()
    result = lint()
    elapsed = time.perf_counter() - t0
    assert not result.parse_errors, result.parse_errors
    assert not result.failing, "unsuppressed flowlint findings:\n" + "\n".join(
        f.format() for f in result.failing
    )
    assert result.baselined, "baseline.json no longer guards any live site"
    assert not result.stale_baseline, ", ".join(result.stale_baseline)
    assert len(result.disabled) >= 3
    assert result.files > 100
    assert elapsed < 10.0, f"flowlint took {elapsed:.1f}s — over the tier-1 budget"


def test_host_only_manifest_points_at_real_files():
    for rel in load_config()["host_only"]:
        assert (DEFAULT_ROOT / rel).exists(), f"host_only manifest rot: {rel}"


def test_cli_json_output_is_machine_readable():
    from foundationdb_tpu_torch.tools.cli import _run_lint

    rc, out = _run_lint(["--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["clean"] is True
    assert set(doc["per_rule"]) == {r.id for r in all_rules()}


# ---------------------------------------------------------------------------
# The port's own configuration: what it walks and what it grandfathers


def test_port_config_and_baseline_name_only_the_port():
    """The default root is the repository; the port walks its own package,
    its baseline holds exactly the JAX package's four readwrite.py entries
    at the port's path (with their reasons), and its only host-only entry
    beyond the JAX package's (renamed, bench_capture aside) is the kernels'
    nvcc build."""
    config = load_config()
    ref = ref_core.load_config()
    assert DEFAULT_ROOT == ref_core.DEFAULT_ROOT
    assert config["include"] == [PORT_PKG]
    assert config["baseline"] == f"{PORT_PKG}/tools/flowlint/baseline.json"
    assert config["sim_scope"] == [
        p.replace(REF_PKG, PORT_PKG, 1) for p in ref["sim_scope"]
    ] + [f"{PORT_PKG}/device.py"]
    host = {k.replace(REF_PKG, PORT_PKG, 1): v for k, v in ref["host_only"].items()
            if not k.endswith("bench_capture.py")}
    host[f"{PORT_PKG}/conflict/kernels/build.py"] = (
        "nvcc build of the kernels at first use; its timer is build evidence, never control flow"
    )
    assert config["host_only"] == host
    for key in ("role_required_counters", "span_roles", "role_exempt",
                "process_metrics_endpoint", "transport_metrics_endpoint"):
        assert config[key] == ref[key], key
    ref_entries = ref_core.load_baseline(ref_core.DEFAULT_ROOT, ref)
    assert load_baseline(DEFAULT_ROOT, config) == {
        k.replace(REF_PKG, PORT_PKG, 1): v for k, v in ref_entries.items()
    }
    assert len(ref_entries) == 4


# ---------------------------------------------------------------------------
# Parity with the JAX package's analyzer


def _findings(findings, pkg):
    return [
        (f.rule, f.relpath.replace(pkg, "<pkg>", 1), f.line, f.scope, f.detail, f.message)
        for f in findings
    ]


SNIPPETS = {
    **{f"{rule}-flagged": pair[0] for rule, pair in FIXTURES.items()},
    **{f"{rule}-near-miss": pair[1] for rule, pair in FIXTURES.items()},
    "dropped-spawn": DROPPED_SPAWN,
    "held-spawn": HELD_SPAWN,
    "dropped-in-init": DROPPED_IN_INIT,
    **{f"retry-near-miss-{i}": src for i, src in enumerate(RETRY_NEAR_MISSES)},
    "no-await-in-try": NO_AWAIT_IN_TRY,
    "reraise": RERAISE,
    "wall": WALL.format(""),
    "wall-disabled": WALL.format("  # flowlint: disable=det-wall-clock"),
    "wall-other-disabled": WALL.format("  # flowlint: disable=det-sleep"),
    "file-disable": FILE_DISABLE,
}


@pytest.mark.parametrize("where", ["runtime/mod.py", "tools/tcp_soak.py", "tools/perf.py"])
@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_lint_source_equals_the_jax_package(name, where):
    """Each fixture, in a sim-reachable module, a host-only one and a tool,
    gives the same findings (message included) in both analyzers."""
    src = SNIPPETS[name]
    port = lint_source(src, relpath=f"{PORT_PKG}/{where}")
    ref = ref_flowlint.lint_source(src, relpath=f"{REF_PKG}/{where}")
    assert _findings(port, PORT_PKG) == _findings(ref, REF_PKG)


def _without_seconds(result):
    doc = result.to_json()
    doc.pop("seconds")
    return doc


def test_port_analyzer_over_the_jax_tree_equals_the_jax_analyzer():
    """The port's engine and rules, given the JAX package's tree, config and
    baseline, reproduce that package's result exactly (every failing,
    disabled and baselined finding, the per-rule counts, the stale keys)."""
    config = ref_core.load_config()
    baseline = ref_core.load_baseline(ref_core.DEFAULT_ROOT, config)
    ref = ref_flowlint.lint(root=ref_core.DEFAULT_ROOT, config=config, baseline=baseline)
    port = lint(root=DEFAULT_ROOT, config=config, baseline=baseline)
    assert port.files == ref.files > 100
    assert ref.disabled and ref.baselined
    assert _without_seconds(port) == _without_seconds(ref)


# ---------------------------------------------------------------------------
# The registration rules: tests/test_collection_audit.py's lint cases


@pytest.fixture(scope="module")
def tree():
    return lint()


def test_every_server_role_registers_metrics(tree):
    hits = [f for f in tree.failing if f.rule == "reg-role-metrics"]
    assert not hits, hits
    assert load_config()["role_exempt"] == ["master"]


def test_rpc_endpoints_open_spans_or_are_exempted_inline(tree):
    hits = [f for f in tree.failing if f.rule == "reg-endpoint-span"]
    assert not hits, hits
    disabled = [f for f in tree.disabled if f.rule == "reg-endpoint-span"]
    assert len(disabled) >= 10, len(disabled)


_WORKER = """\
class Worker:
    def _make_widget(self, h):
        from .widget import Widget
        w = Widget()
        return w
"""

_ROLE_OK = """\
from ..runtime.stats import CounterCollection

class Widget:
    def __init__(self):
        self.stats = CounterCollection("widget")

    def register_instance(self, process):
        process.register(f"widget.metrics#{id(self)}", self._metrics)
        process.register("widget.work", self.work)

    async def _metrics(self, _req):  # flowlint: disable=reg-endpoint-span
        return self.stats.snapshot()

    async def work(self, req):
        from ..runtime.trace import span
        with span("Widget.work"):
            return req
"""


def _lint_tree(tmp_path, worker_src, role_src, span_roles=("widget",), required_counters=None):
    """The synthetic tree linted by the port; the JAX package's analyzer
    must find the same on the same tree under its package's name."""
    results = {}
    for pkg, run in ((PORT_PKG, lint), (REF_PKG, ref_flowlint.lint)):
        root = tmp_path / pkg.replace("_", "")
        d = root / pkg / "server"
        d.mkdir(parents=True, exist_ok=True)
        (d / "worker.py").write_text(worker_src)
        (d / "widget.py").write_text(role_src)
        config = {
            "include": [pkg],
            "exclude": [],
            "sim_scope": [],
            "host_only": {},
            "baseline": "baseline.json",
            "worker_module": f"{pkg}/server/worker.py",
            "role_exempt": [],
            "span_roles": list(span_roles),
        }
        if required_counters is not None:
            config["role_required_counters"] = required_counters
        results[pkg] = run(root=root, config=config)
    port, ref = results[PORT_PKG], results[REF_PKG]
    assert _findings(port.failing, PORT_PKG) == _findings(ref.failing, REF_PKG)
    assert _findings(port.disabled, PORT_PKG) == _findings(ref.disabled, REF_PKG)
    return port


def test_rule_fixture_role_with_metrics_and_spans_passes(tmp_path):
    res = _lint_tree(tmp_path, _WORKER, _ROLE_OK)
    assert not res.failing, [f.format() for f in res.failing]


def test_rule_fixture_missing_counter_collection_flagged(tmp_path):
    role = _ROLE_OK.replace('        self.stats = CounterCollection("widget")\n', "        pass\n")
    res = _lint_tree(tmp_path, _WORKER, role)
    assert any(f.rule == "reg-role-metrics" and f.detail == "Widget-stats" for f in res.failing)


def test_rule_fixture_missing_metrics_endpoint_flagged(tmp_path):
    role = _ROLE_OK.replace("widget.metrics#", "widget.admin#")
    res = _lint_tree(tmp_path, _WORKER, role)
    assert any(f.rule == "reg-role-metrics" and f.detail == "Widget-endpoint" for f in res.failing)


def test_rule_fixture_unresolvable_factory_flagged(tmp_path):
    worker = _WORKER + (
        "\n"
        "    def _make_mystery(self, h):\n"
        "        return object()\n"
    )
    res = _lint_tree(tmp_path, worker, _ROLE_OK)
    assert any(
        f.rule == "reg-role-metrics" and f.detail == "unresolved-mystery" for f in res.failing
    )


def test_rule_fixture_required_counter_dropped_flags(tmp_path):
    role = _ROLE_OK.replace(
        '        self.stats = CounterCollection("widget")\n',
        '        self.stats = CounterCollection("widget")\n'
        '        self._c_a = self.stats.counter("prefiltered")\n'
        '        self._c_b = self.stats.counter("prefilterChecks")\n',
    )
    required = {"widget": ["prefiltered", "prefilterChecks"]}
    res = _lint_tree(tmp_path / "intact", _WORKER, role, required_counters=required)
    assert not res.failing, [f.format() for f in res.failing]
    dropped = role.replace('        self._c_b = self.stats.counter("prefilterChecks")\n', "")
    res = _lint_tree(tmp_path / "dropped", _WORKER, dropped, required_counters=required)
    assert any(
        f.rule == "reg-role-metrics" and f.detail == "Widget-counter-prefilterChecks"
        for f in res.failing
    )
    assert not any(f.detail == "Widget-counter-prefiltered" for f in res.failing)


def test_rule_fixture_spanless_endpoint_flagged_and_disable_exempts(tmp_path):
    spanless = _ROLE_OK.replace(
        "        from ..runtime.trace import span\n"
        '        with span("Widget.work"):\n'
        "            return req\n",
        "        return req\n",
    )
    res = _lint_tree(tmp_path, _WORKER, spanless)
    assert any(f.rule == "reg-endpoint-span" and f.detail == "Widget.work" for f in res.failing)
    assert any(f.rule == "reg-endpoint-span" and f.detail == "Widget._metrics" for f in res.disabled)


# ---------------------------------------------------------------------------
# python -m foundationdb_tpu_torch.tools.flowlint: the reference's flags and exit codes


def test_main_flags_and_exit_codes(capsys):
    from foundationdb_tpu.tools.flowlint.__main__ import main as ref_main
    from foundationdb_tpu_torch.tools.flowlint.__main__ import main

    assert main([]) == 0
    assert "clean: no unsuppressed findings" in capsys.readouterr().out
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert ref_main(["--list-rules"]) == 0
    assert listed == capsys.readouterr().out and len(listed.splitlines()) == 10
    # without the baseline the four grandfathered sites fail; a path
    # argument narrows what is reported
    assert main(["--json", "--no-baseline", f"{PORT_PKG}/workloads"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert sorted(f["key"] for f in doc["failing"]) == sorted(load_baseline(DEFAULT_ROOT, load_config()))
    assert main(["--no-baseline", f"{PORT_PKG}/server"]) == 0
    assert "clean" in capsys.readouterr().out


def test_write_baseline_grandfathers_and_keeps_reasons(tmp_path, capsys):
    from foundationdb_tpu_torch.tools.flowlint.__main__ import main

    mod = tmp_path / PORT_PKG / "runtime" / "mod.py"
    mod.parent.mkdir(parents=True)
    mod.write_text("import time\ndef f():\n    return time.time()\n")
    baseline = tmp_path / load_config()["baseline"]
    baseline.parent.mkdir(parents=True)
    assert main(["--root", str(tmp_path)]) == 1
    assert "FAILED: 1 unsuppressed finding(s)" in capsys.readouterr().out
    assert main(["--root", str(tmp_path), "--write-baseline"]) == 0
    assert "1 entries (1 newly grandfathered)" in capsys.readouterr().out
    key = f"{PORT_PKG}/runtime/mod.py::f::det-wall-clock::time.time"
    doc = json.loads(baseline.read_text())
    assert doc["entries"] == {key: "grandfathered by flowlint --write-baseline"}
    doc["entries"][key] = "reviewed"
    baseline.write_text(json.dumps(doc))
    assert main(["--root", str(tmp_path), "--write-baseline"]) == 0
    assert json.loads(baseline.read_text())["entries"] == {key: "reviewed"}
    assert main(["--root", str(tmp_path)]) == 0
