"""flowlint core: the AST lint engine, suppression + baseline machinery.

The Python analog of the reference's actor-compiler discipline
(flow/actorcompiler/ActorCompiler.cs): the C# compiler *rejects* code that
breaks the actor model before it can flake a simulation run. Here the same
invariants (seeded RNG forks only, virtual time only, no blocking calls in
actors, Cancelled must propagate, every role observable) are enforced by a
whole-tree static pass instead of a code generator.

Three layers:

- ``Module``: one parsed source file — AST, import-alias tables, scope map
  (line → enclosing qualname), and ``# flowlint: disable=`` comments.
- ``Rule``: either per-module (``check_module``) or whole-project
  (``check_project``, for cross-module resolution like worker-role →
  role-class → metrics registration).
- ``lint()``: walks the configured tree, applies scoping (sim-reachable
  dirs, host-only manifest, excludes), splits findings into failing /
  inline-disabled / baseline-grandfathered.

Findings key on ``relpath::scope::rule::detail`` — stable under line churn,
so the checked-in baseline survives unrelated edits while still pinning the
exact (file, function, rule, symbol) it grandfathers.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional

DISABLE_RE = re.compile(
    r"#\s*flowlint:\s*(disable(?:-file)?)\s*=\s*([A-Za-z0-9_\-, ]+)"
)

_PKG_DIR = Path(__file__).resolve().parent
DEFAULT_ROOT = _PKG_DIR.parents[2]  # repo root (…/foundationdb_tpu_torch/tools/flowlint)
DEFAULT_CONFIG_PATH = _PKG_DIR / "config.json"


# ---------------------------------------------------------------------------
# Findings


@dataclass(frozen=True)
class Finding:
    rule: str
    relpath: str  # posix, relative to the lint root
    line: int
    scope: str  # qualname of the innermost enclosing def/class, or <module>
    detail: str  # the offending symbol/name — part of the stable key
    message: str

    @property
    def key(self) -> str:
        return f"{self.relpath}::{self.scope}::{self.rule}::{self.detail}"

    def format(self) -> str:
        return f"{self.relpath}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.relpath,
            "line": self.line,
            "scope": self.scope,
            "detail": self.detail,
            "message": self.message,
            "key": self.key,
        }


# ---------------------------------------------------------------------------
# Parsed module


class Module:
    """One source file: AST + the derived tables every rule needs."""

    def __init__(self, root: Path, relpath: str, text: Optional[str] = None):
        self.relpath = relpath
        self.path = root / relpath
        self.text = self.path.read_text() if text is None else text
        self.tree = ast.parse(self.text, filename=relpath)
        self.line_disables: dict[int, set[str]] = {}
        self.file_disables: set[str] = set()
        for i, ln in enumerate(self.text.splitlines(), 1):
            m = DISABLE_RE.search(ln)
            if m:
                rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
                if m.group(1) == "disable-file":
                    self.file_disables |= rules
                else:
                    self.line_disables.setdefault(i, set()).update(rules)
        # import alias tables (collected over the WHOLE tree — server code
        # imports inside functions all the time)
        self.aliases: dict[str, str] = {}  # local name -> module ("os", "time")
        self.from_names: dict[str, str] = {}  # local name -> dotted origin
        self._scopes: list[tuple[int, int, str]] = []  # (start, end, qualname)
        self._collect(self.tree, [])

    def _collect(self, node: ast.AST, stack: list[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                for a in child.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(child, ast.ImportFrom):
                mod = ("." * child.level) + (child.module or "")
                for a in child.names:
                    self.from_names[a.asname or a.name] = f"{mod}.{a.name}"
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                qual = ".".join(stack + [child.name])
                self._scopes.append(
                    (child.lineno, child.end_lineno or child.lineno, qual)
                )
                self._collect(child, stack + [child.name])
            else:
                self._collect(child, stack)

    def scope_at(self, line: int) -> str:
        best = "<module>"
        best_start = 0
        for start, end, qual in self._scopes:
            if start <= line <= end and start >= best_start:
                best, best_start = qual, start
        return best

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute chain to a dotted origin through the
        module's import aliases: ``_os.urandom`` -> ``os.urandom``,
        ``datetime.now`` (after ``from datetime import datetime``) ->
        ``datetime.datetime.now``."""
        parts: list[str] = []
        n = node
        while isinstance(n, ast.Attribute):
            parts.append(n.attr)
            n = n.value
        if not isinstance(n, ast.Name):
            return None
        base = n.id
        if base in self.aliases:
            parts.append(self.aliases[base])
        elif base in self.from_names:
            parts.append(self.from_names[base])
        else:
            parts.append(base)
        return ".".join(reversed(parts))

    def suppressed(self, finding: Finding) -> bool:
        if finding.rule in self.file_disables:
            return True
        return finding.rule in self.line_disables.get(finding.line, ())

    def finding(self, rule: str, node: ast.AST, detail: str, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule, self.relpath, line, self.scope_at(line), detail, message)


# ---------------------------------------------------------------------------
# Rules


class Rule:
    """Base rule. ``scope`` picks which files the engine feeds it:

    - ``"sim"``: sim-reachable modules only (config ``sim_scope`` minus the
      ``host_only`` manifest) — the determinism rules;
    - ``"all"``: every walked module — the actor-discipline rules;
    - ``"project"``: called once with the whole module set — the
      cross-module registration-integrity rules.
    """

    id: str = ""
    title: str = ""
    scope: str = "all"

    def check_module(self, mod: Module, config: dict) -> Iterator[Finding]:
        return iter(())

    def check_project(
        self, modules: dict[str, Module], config: dict
    ) -> Iterator[Finding]:
        return iter(())


def all_rules() -> list[Rule]:
    from . import rules_actors, rules_determinism, rules_registration

    return (
        rules_determinism.RULES + rules_actors.RULES + rules_registration.RULES
    )


# ---------------------------------------------------------------------------
# Config / walking


def load_config(path: Optional[Path] = None) -> dict:
    with open(path or DEFAULT_CONFIG_PATH) as f:
        return json.load(f)


def _under(relpath: str, prefix: str) -> bool:
    return relpath == prefix or relpath.startswith(prefix.rstrip("/") + "/")


def iter_relpaths(root: Path, config: dict) -> Iterator[str]:
    excludes = config.get("exclude", [])
    for inc in config.get("include", ["foundationdb_tpu_torch"]):
        base = root / inc
        if base.is_file():
            yield inc
            continue
        for p in sorted(base.rglob("*.py")):
            rel = p.relative_to(root).as_posix()
            if any(_under(rel, ex) for ex in excludes):
                continue
            yield rel


def sim_reachable(relpath: str, config: dict) -> bool:
    if relpath in config.get("host_only", {}):
        return False
    return any(_under(relpath, p) for p in config.get("sim_scope", []))


# ---------------------------------------------------------------------------
# Baseline


def load_baseline(root: Path, config: dict) -> dict[str, str]:
    rel = config.get("baseline")
    if not rel:
        return {}
    path = root / rel
    if not path.exists():
        return {}
    with open(path) as f:
        doc = json.load(f)
    return dict(doc.get("entries", {}))


def format_baseline(findings: Iterable[Finding], reasons: dict[str, str]) -> str:
    entries = {}
    for f in sorted(findings, key=lambda f: f.key):
        entries[f.key] = reasons.get(f.key, "grandfathered by flowlint --write-baseline")
    doc = {
        "_comment": (
            "flowlint baseline: grandfathered findings, keyed "
            "path::scope::rule::detail (line-churn stable). New violations "
            "fail tier-1; these are visible and counted, not invisible. "
            "Regenerate with `python -m foundationdb_tpu_torch.tools.flowlint "
            "--write-baseline` and REVIEW the diff — shrink only."
        ),
        "entries": entries,
    }
    return json.dumps(doc, indent=2, sort_keys=False) + "\n"


# ---------------------------------------------------------------------------
# Engine


@dataclass
class LintResult:
    failing: list[Finding] = field(default_factory=list)
    disabled: list[Finding] = field(default_factory=list)  # inline-suppressed
    baselined: list[Finding] = field(default_factory=list)
    stale_baseline: list[str] = field(default_factory=list)
    files: int = 0
    seconds: float = 0.0
    parse_errors: list[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.failing and not self.parse_errors

    def per_rule(self) -> dict[str, dict[str, int]]:
        out: dict[str, dict[str, int]] = {
            r.id: {"fail": 0, "disabled": 0, "baseline": 0} for r in all_rules()
        }
        for bucket, items in (
            ("fail", self.failing),
            ("disabled", self.disabled),
            ("baseline", self.baselined),
        ):
            for f in items:
                out.setdefault(f.rule, {"fail": 0, "disabled": 0, "baseline": 0})[
                    bucket
                ] += 1
        return out

    def to_json(self) -> dict:
        return {
            "clean": self.clean,
            "files": self.files,
            "seconds": round(self.seconds, 3),
            "failing": [f.to_json() for f in self.failing],
            "disabled": [f.to_json() for f in self.disabled],
            "baselined": [f.to_json() for f in self.baselined],
            "stale_baseline": list(self.stale_baseline),
            "parse_errors": list(self.parse_errors),
            "per_rule": self.per_rule(),
        }


def lint(
    root: Optional[Path] = None,
    config: Optional[dict] = None,
    rules: Optional[list[Rule]] = None,
    baseline: Optional[dict[str, str]] = None,
    paths: Optional[list[str]] = None,
    now: Callable[[], float] = None,
) -> LintResult:
    """Run the analyzer. ``paths`` filters the walked set (CLI convenience);
    project-scope rules always see the full module set so cross-module
    resolution cannot be defeated by a narrow invocation."""
    import time as _time

    # clock is injected (a *reference* to perf_counter, never a call here) —
    # the same dependency-injection shape det-wall-clock accepts tree-wide
    now = now or _time.perf_counter
    t0 = now()
    root = Path(root) if root is not None else DEFAULT_ROOT
    config = config if config is not None else load_config()
    rules = rules if rules is not None else all_rules()
    baseline = baseline if baseline is not None else load_baseline(root, config)

    result = LintResult()
    modules: dict[str, Module] = {}
    for rel in iter_relpaths(root, config):
        try:
            modules[rel] = Module(root, rel)
        except SyntaxError as e:
            result.parse_errors.append(f"{rel}: {e}")
    result.files = len(modules)

    wanted = None
    if paths:
        wanted = {p.rstrip("/") for p in paths}

    raw: list[Finding] = []
    for rel, mod in modules.items():
        sim = sim_reachable(rel, config)
        for rule in rules:
            if rule.scope == "project":
                continue
            if rule.scope == "sim" and not sim:
                continue
            raw.extend(rule.check_module(mod, config))
    for rule in rules:
        if rule.scope == "project":
            raw.extend(rule.check_project(modules, config))

    seen_keys: set[str] = set()
    for f in sorted(raw, key=lambda f: (f.relpath, f.line, f.rule, f.detail)):
        if wanted is not None and not any(_under(f.relpath, w) for w in wanted):
            continue
        mod = modules.get(f.relpath)
        if mod is not None and mod.suppressed(f):
            result.disabled.append(f)
        elif f.key in baseline:
            seen_keys.add(f.key)
            result.baselined.append(f)
        else:
            result.failing.append(f)
    if wanted is None:
        result.stale_baseline = sorted(set(baseline) - seen_keys)
    result.seconds = now() - t0
    return result


def lint_source(
    text: str,
    relpath: str = "foundationdb_tpu_torch/mod.py",
    config: Optional[dict] = None,
    rules: Optional[list[Rule]] = None,
) -> list[Finding]:
    """Lint one in-memory snippet with the per-module rules — the fixture
    entry point (tests feed minimal flag/near-miss sources through here)."""
    config = config if config is not None else load_config()
    rules = rules if rules is not None else all_rules()
    mod = Module(Path("."), relpath, text=text)
    sim = sim_reachable(relpath, config)
    out: list[Finding] = []
    for rule in rules:
        if rule.scope == "project":
            continue
        if rule.scope == "sim" and not sim:
            continue
        for f in rule.check_module(mod, config):
            if not mod.suppressed(f):
                out.append(f)
    return sorted(out, key=lambda f: (f.line, f.rule, f.detail))
