"""Registration-integrity rules (re-homed from tests/test_collection_audit).

The metrics-registration lint and the span lint used to live as per-test
regexes over ``inspect.getsource``. Here they are real cross-module AST
rules: worker.py's ``_make_<kind>`` factories are resolved to the role
class they instantiate (via the factory's relative import), and the class
body is analyzed in its home module — so findings land on the class/handler
definition line, where an inline ``# flowlint: disable=`` can carry the
exemption *at the site* instead of in a faraway allowlist dict.

- ``reg-role-metrics``: every recruitable role class owns a
  ``self.stats = CounterCollection(...)`` and registers a ``*.metrics#``
  endpoint — otherwise its traffic is invisible to status/trace and every
  bench capture built on them. When the config names a
  ``process_metrics_endpoint`` token, the rule also requires the Worker
  class itself to register it: the run-loop profiler's per-process
  snapshot (runtime/profiler.py) is worker-level, not per-role, and a
  worker that drops the endpoint silently blinds the status document's
  ``run_loop`` section and ``cli top``.
- ``reg-endpoint-span``: every RPC endpoint a proxy/storage/resolver
  registers (``process.register(token, self.handler)``) opens a
  distributed-trace span in its handler — or carries an explicit inline
  exemption on the handler's ``def`` line (admin/liveness endpoints,
  long-polls).
"""

from __future__ import annotations

import ast
import posixpath
from typing import Iterator, Optional

from .core import Finding, Module, Rule

SPAN_CALL_NAMES = {"span", "emit_span"}


def _resolve_relative(from_relpath: str, node: ast.ImportFrom) -> Optional[str]:
    """Map a relative ImportFrom inside ``from_relpath`` to a repo relpath
    (``from .tlog import TLog`` in server/worker.py -> server/tlog.py)."""
    if node.level == 0 or not node.module:
        return None
    base = posixpath.dirname(from_relpath)
    for _ in range(node.level - 1):
        base = posixpath.dirname(base)
    return posixpath.join(base, *node.module.split(".")) + ".py"


def _find_class(mod: Module, name: str) -> Optional[ast.ClassDef]:
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _role_classes(
    modules: dict[str, Module], config: dict
) -> Iterator[tuple[str, str, Module, Optional[ast.ClassDef], Optional[Finding]]]:
    """Yield (kind, class_name, home_module, classdef, unresolved_finding)
    for every ``Worker._make_<kind>`` factory, resolving the instantiated
    class through the factory's own relative imports."""
    worker_rel = config.get("worker_module", "foundationdb_tpu_torch/server/worker.py")
    worker = modules.get(worker_rel)
    if worker is None:
        return
    exempt = set(config.get("role_exempt", []))
    wcls = _find_class(worker, "Worker")
    if wcls is None:
        return
    for meth in wcls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not meth.name.startswith("_make_"):
            continue
        kind = meth.name[len("_make_") :]
        if kind in exempt:
            continue
        # classes this factory imports, name -> home relpath
        imported: dict[str, str] = {}
        for n in ast.walk(meth):
            if isinstance(n, ast.ImportFrom):
                rel = _resolve_relative(worker_rel, n)
                if rel:
                    for a in n.names:
                        imported[a.asname or a.name] = rel
        # the class it instantiates
        cls_name = None
        for n in ast.walk(meth):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name)
                and n.func.id in imported
            ):
                cls_name = n.func.id
                break
        if cls_name is None:
            yield kind, "", worker, None, worker.finding(
                "reg-role-metrics",
                meth,
                f"unresolved-{kind}",
                f"_make_{kind} instantiates no class this rule can resolve "
                f"— add the role to role_exempt (with a reason) or "
                f"construct the role class from a relative import",
            )
            continue
        home_rel = imported[cls_name]
        home = modules.get(home_rel)
        cdef = _find_class(home, cls_name) if home is not None else None
        if cdef is None:
            yield kind, cls_name, worker, None, worker.finding(
                "reg-role-metrics",
                meth,
                f"missing-{kind}",
                f"_make_{kind} instantiates {cls_name} but "
                f"{home_rel}:{cls_name} was not found in the walked tree",
            )
            continue
        yield kind, cls_name, home, cdef, None


def _has_stats_collection(cdef: ast.ClassDef) -> bool:
    for n in ast.walk(cdef):
        targets = []
        if isinstance(n, ast.Assign):
            targets = n.targets
            value = n.value
        elif isinstance(n, ast.AnnAssign) and n.value is not None:
            targets = [n.target]
            value = n.value
        else:
            continue
        for t in targets:
            if (
                isinstance(t, ast.Attribute)
                and t.attr == "stats"
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
                and isinstance(value, ast.Call)
            ):
                fn = value.func
                name = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", "")
                if name == "CounterCollection":
                    return True
    return False


def _has_metrics_endpoint(cdef: ast.ClassDef) -> bool:
    for n in ast.walk(cdef):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            if ".metrics#" in n.value:
                return True
    return False


STATS_REGISTRATION_METHODS = {"counter", "latency", "bands", "gauge"}


def _registered_stat_names(cdef: ast.ClassDef) -> set:
    """String names registered on the class's CounterCollection: the
    first literal argument of every ``self.stats.counter/latency/bands/
    gauge(...)`` call in the class body."""
    out: set = set()
    for n in ast.walk(cdef):
        if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)):
            continue
        if n.func.attr not in STATS_REGISTRATION_METHODS:
            continue
        target = n.func.value
        if not (
            isinstance(target, ast.Attribute)
            and target.attr == "stats"
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            continue
        if n.args and isinstance(n.args[0], ast.Constant) and isinstance(
            n.args[0].value, str
        ):
            out.add(n.args[0].value)
    return out


def _registers_token(cdef: ast.ClassDef, token: str) -> bool:
    """True when the class body contains a ``*.register(<token>, ...)``
    call with the token as a literal first argument."""
    for n in ast.walk(cdef):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "register"
            and n.args
            and isinstance(n.args[0], ast.Constant)
            and n.args[0].value == token
        ):
            return True
    return False


class RoleMetricsRule(Rule):
    id = "reg-role-metrics"
    title = "every recruitable role class owns CounterCollection + *.metrics#"
    scope = "project"

    def check_project(
        self, modules: dict[str, Module], config: dict
    ) -> Iterator[Finding]:
        yield from self._check_worker_process_metrics(modules, config)
        for kind, cls_name, home, cdef, unresolved in _role_classes(
            modules, config
        ):
            if unresolved is not None:
                yield unresolved
                continue
            if not _has_stats_collection(cdef):
                yield home.finding(
                    self.id,
                    cdef,
                    f"{cls_name}-stats",
                    f"role `{kind}`: {cls_name} never assigns self.stats = "
                    f"CounterCollection(...) — its traffic is invisible to "
                    f"status/trace aggregation",
                )
            if not _has_metrics_endpoint(cdef):
                yield home.finding(
                    self.id,
                    cdef,
                    f"{cls_name}-endpoint",
                    f"role `{kind}`: {cls_name} registers no `*.metrics#` "
                    f"endpoint — the status aggregator cannot pull it",
                )
            # config-keyed counter manifest: counters a status/cli surface
            # depends on by NAME (e.g. the storage-engine epoch/pin
            # counters behind the `Storage engine:` line) must stay
            # registered — renaming or dropping one silently blanks the
            # surface, so the config pins the contract here
            required = (config.get("role_required_counters") or {}).get(kind)
            if required:
                present = _registered_stat_names(cdef)
                for name in required:
                    if name not in present:
                        yield home.finding(
                            self.id,
                            cdef,
                            f"{cls_name}-counter-{name}",
                            f"role `{kind}`: {cls_name} no longer registers "
                            f"the `{name}` counter that "
                            f"role_required_counters pins — the status/cli "
                            f"surface built on it has gone dark",
                        )

    # worker-level (not per-role) observability endpoints: each config key
    # opts the check in (synthetic fixture trees without the key opt out),
    # naming the endpoint token the Worker class itself must register
    WORKER_ENDPOINT_KEYS = (
        (
            "process_metrics_endpoint",
            "worker-process-metrics",
            "the run-loop profiler's per-process snapshot (slow tasks, "
            "starvation bands, hot actors) would be invisible to the "
            "status document's run_loop section and `cli top`",
        ),
        (
            "transport_metrics_endpoint",
            "worker-transport-metrics",
            "the transport counters (frames vs messages, loopback/tcp "
            "split, truncation faults — net/metrics.py) would be "
            "invisible to the status document's transport section and "
            "the `cli status` Transport line",
        ),
    )

    def _check_worker_process_metrics(
        self, modules: dict[str, Module], config: dict
    ) -> Iterator[Finding]:
        worker_rel = config.get(
            "worker_module", "foundationdb_tpu_torch/server/worker.py"
        )
        worker = modules.get(worker_rel)
        if worker is None:
            return
        wcls = _find_class(worker, "Worker")
        node = wcls or (worker.tree.body[0] if worker.tree.body else worker.tree)
        for key, detail, consequence in self.WORKER_ENDPOINT_KEYS:
            token = config.get(key)
            if not token:
                continue
            if wcls is not None and _registers_token(wcls, token):
                continue
            yield worker.finding(
                self.id,
                node,
                detail,
                f"the Worker never registers the `{token}` endpoint — "
                f"{consequence}",
            )


def _registered_handlers(cdef: ast.ClassDef) -> dict[str, int]:
    """handler method name -> line of the registering call, for every
    ``process.register(token, self.<handler>)`` in the class body."""
    out: dict[str, int] = {}
    for n in ast.walk(cdef):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "register"
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "process"
            and len(n.args) >= 2
            and isinstance(n.args[1], ast.Attribute)
            and isinstance(n.args[1].value, ast.Name)
            and n.args[1].value.id == "self"
        ):
            out.setdefault(n.args[1].attr, n.lineno)
    return out


def _method(cdef: ast.ClassDef, name: str):
    for n in cdef.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == name:
            return n
    return None


def _opens_span(meth: ast.AST) -> bool:
    for n in ast.walk(meth):
        if isinstance(n, ast.Call):
            fn = n.func
            name = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", "")
            if name in SPAN_CALL_NAMES:
                return True
    return False


class EndpointSpanRule(Rule):
    id = "reg-endpoint-span"
    title = "every proxy/storage/resolver RPC endpoint opens a span"
    scope = "project"

    def check_project(
        self, modules: dict[str, Module], config: dict
    ) -> Iterator[Finding]:
        wanted = set(config.get("span_roles", ["proxy", "resolver", "storage"]))
        seen_kinds = set()
        for kind, cls_name, home, cdef, unresolved in _role_classes(
            modules, config
        ):
            if kind not in wanted or cdef is None:
                continue
            seen_kinds.add(kind)
            handlers = _registered_handlers(cdef)
            if not handlers:
                yield home.finding(
                    self.id,
                    cdef,
                    f"{cls_name}-no-endpoints",
                    f"role `{kind}`: the rule found no "
                    f"process.register(token, self.handler) calls in "
                    f"{cls_name} — the lint itself has gone blind, fix its "
                    f"pattern before shipping endpoints dark",
                )
                continue
            for name in sorted(handlers):
                meth = _method(cdef, name)
                if meth is None:
                    yield home.finding(
                        self.id,
                        cdef,
                        f"{cls_name}.{name}-missing",
                        f"role `{kind}`: registered handler self.{name} is "
                        f"not a method of {cls_name}",
                    )
                    continue
                if not _opens_span(meth):
                    yield home.finding(
                        self.id,
                        meth,
                        f"{cls_name}.{name}",
                        f"role `{kind}`: endpoint handler {cls_name}.{name} "
                        f"opens no trace span — it would be invisible in "
                        f"the read/commit waterfalls; open a span "
                        f"(runtime/trace.py) or put an inline exemption on "
                        f"its def line",
                    )
        for kind in sorted(wanted - seen_kinds):
            # a span_roles entry that matches no _make_ factory is a config
            # rot signal, not silence
            worker_rel = config.get(
                "worker_module", "foundationdb_tpu_torch/server/worker.py"
            )
            worker = modules.get(worker_rel)
            if worker is not None:
                yield worker.finding(
                    self.id,
                    worker.tree.body[0] if worker.tree.body else worker.tree,
                    f"stale-span-role-{kind}",
                    f"span_roles names `{kind}` but no _make_{kind} factory "
                    f"exists — update flowlint config.json",
                )


RULES: list[Rule] = [RoleMetricsRule(), EndpointSpanRule()]
