"""Actor-discipline rules: the contracts ``async def`` bodies live by.

The reference's actor compiler enforces these shapes as hard compile
errors (flow/actorcompiler/ActorCompiler.cs); Python will happily create a
coroutine and drop it on the floor, or let ``except Exception`` eat the
``Cancelled`` a dying actor must die by (runtime/loop.py: Cancelled
subclasses Exception precisely so naive handlers are *visible* to this
rule rather than silently immune).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from .core import Finding, Module, Rule

BLOCKING = {
    "time.sleep",
    "os.system",
    "os.popen",
    "os.wait",
    "os.waitpid",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.Popen",
    "select.select",
    "socket.create_connection",
    "urllib.request.urlopen",
    "requests.get",
    "requests.post",
    "requests.request",
    "input",
}

CANCELLED_NAMES = {"Cancelled"}
BROAD_NAMES = {"Exception", "BaseException"}


def _async_defs(mod: Module) -> tuple[set[str], dict[str, set[str]]]:
    """(module-level async def names, class name -> async method names)."""
    mod_level: set[str] = set()
    methods: dict[str, set[str]] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.AsyncFunctionDef):
            mod_level.add(node.name)
        elif isinstance(node, ast.ClassDef):
            methods[node.name] = {
                n.name for n in node.body if isinstance(n, ast.AsyncFunctionDef)
            }
    return mod_level, methods


def _walk_in_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Walk without descending into nested function/class definitions —
    their bodies run in a different execution context."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            yield from _walk_in_scope(child)


def _contains(node: ast.AST, kinds) -> bool:
    return any(isinstance(n, kinds) for n in _walk_in_scope(node))


class DroppedFutureRule(Rule):
    id = "actor-dropped-future"
    title = "coroutine/Future created and discarded"
    scope = "all"

    def check_module(self, mod: Module, config: dict) -> Iterator[Finding]:
        mod_async, cls_async = _async_defs(mod)
        yield from self._scan(mod, mod.tree, mod_async, cls_async, None)

    def _scan(
        self,
        mod: Module,
        node: ast.AST,
        mod_async: set[str],
        cls_async: dict[str, set[str]],
        cls: Optional[str],
    ) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            here = child.name if isinstance(child, ast.ClassDef) else cls
            if isinstance(child, ast.Expr) and isinstance(child.value, ast.Call):
                yield from self._check_call(
                    mod, child.value, mod_async, cls_async, cls
                )
            yield from self._scan(mod, child, mod_async, cls_async, here)

    def _check_call(
        self, mod: Module, call: ast.Call, mod_async, cls_async, cls
    ) -> Iterator[Finding]:
        fn = call.func
        # bare spawn(...) from runtime.futures: the returned Future is the
        # ONLY handle on the actor — dropping it means its error can never
        # be observed. process.spawn()/world.spawn() are fine: they park the
        # future in the process's ActorCollection, where death is loud.
        if isinstance(fn, ast.Name):
            origin = mod.from_names.get(fn.id, "")
            if fn.id == "spawn" and (origin.endswith("futures.spawn") or not origin):
                yield mod.finding(
                    self.id,
                    call,
                    "spawn",
                    "bare spawn() with the Future discarded — no one can "
                    "see this actor die; hold it (ActorCollection / "
                    "process.spawn) or await it",
                )
            elif fn.id in mod_async:
                yield mod.finding(
                    self.id,
                    call,
                    fn.id,
                    f"{fn.id}() creates a coroutine that is never awaited "
                    f"or spawned — the body will NEVER run",
                )
        elif (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "self"
            and cls is not None
            and fn.attr in cls_async.get(cls, ())
        ):
            yield mod.finding(
                self.id,
                call,
                f"self.{fn.attr}",
                f"self.{fn.attr}() creates a coroutine that is never "
                f"awaited or spawned — the body will NEVER run",
            )


class BlockingCallRule(Rule):
    id = "actor-blocking-call"
    title = "blocking call inside an async def"
    scope = "all"

    def check_module(self, mod: Module, config: dict) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for inner in _walk_in_scope(node):
                if isinstance(inner, ast.Call):
                    dotted = mod.dotted(inner.func)
                    if dotted in BLOCKING:
                        yield mod.finding(
                            self.id,
                            inner,
                            dotted,
                            f"{dotted}() blocks inside actor "
                            f"`{node.name}` — every other actor on the loop "
                            f"stalls with it; use the async analog",
                        )


def _handler_names(h: ast.ExceptHandler) -> set[str]:
    t = h.type
    if t is None:
        return {"<bare>"}
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    names = set()
    for e in elts:
        if isinstance(e, ast.Name):
            names.add(e.id)
        elif isinstance(e, ast.Attribute):
            names.add(e.attr)
    return names


class CancelledSwallowRule(Rule):
    id = "actor-cancelled-swallow"
    title = "broad except around an await can swallow Cancelled"
    scope = "all"

    def check_module(self, mod: Module, config: dict) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for inner in _walk_in_scope(node):
                if isinstance(inner, ast.Try):
                    yield from self._check_try(mod, inner)

    def _check_try(self, mod: Module, t: ast.Try) -> Iterator[Finding]:
        # only await-bearing try bodies matter: Cancelled is thrown at the
        # actor's current await point, nowhere else
        if not any(
            _contains(s, (ast.Await,)) or isinstance(s, ast.Await) for s in t.body
        ):
            return
        cancelled_handled = False
        for h in t.handlers:
            names = _handler_names(h)
            if names & CANCELLED_NAMES:
                cancelled_handled = True
                continue
            broad = "<bare>" in names or bool(names & BROAD_NAMES)
            if not broad or cancelled_handled:
                continue
            reraises = any(
                isinstance(n, ast.Raise) for n in _walk_in_scope(h)
            ) or any(isinstance(n, ast.Raise) for n in h.body)
            if not reraises:
                label = "<bare>" if "<bare>" in names else sorted(names & BROAD_NAMES)[0]
                yield mod.finding(
                    self.id,
                    h,
                    f"except-{label}",
                    f"`except {label if label != '<bare>' else ''}` wraps an "
                    f"await and neither re-raises nor passes Cancelled on — "
                    f"a cancelled actor would linger; add "
                    f"`except Cancelled: raise` above it",
                )


class UnboundedRetryRule(Rule):
    """A `while True:` retry loop in an actor that swallows errors around
    an await with no deadline, attempt bound, or backoff spins hot against
    a dead dependency — and in simulation it can spin in zero virtual
    time, starving every other actor on the loop. The reference's retry
    idiom always carries delay()/timeout() (genericactors' retry shapes);
    the resolver's kernel dispatch retry (server/resolver.py) is the
    bounded+backoff template."""

    id = "actor-unbounded-retry"
    title = "unbounded retry loop around an await (no deadline/bound/backoff)"
    scope = "all"

    # call names (resolved through import aliases) that bound a retry loop:
    # a sleep between attempts, an overall deadline, or the client's
    # on_error (bounded exponential backoff + re-raise of non-retryables)
    BOUNDING = {"delay", "timeout", "yield_now", "on_error"}

    def check_module(self, mod: Module, config: dict) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for inner in _walk_in_scope(node):
                if isinstance(inner, ast.While) and self._const_true(inner.test):
                    yield from self._check_loop(mod, node, inner)

    @staticmethod
    def _const_true(test: ast.AST) -> bool:
        return isinstance(test, ast.Constant) and bool(test.value)

    def _check_loop(
        self, mod: Module, fn: ast.AsyncFunctionDef, loop: ast.While
    ) -> Iterator[Finding]:
        # a RETRY loop: a try whose body awaits, with a non-Cancelled
        # handler that neither re-raises nor exits the loop — control
        # falls back to the loop top on every failure
        retry = False
        for t in _walk_in_scope(loop):
            if not isinstance(t, ast.Try):
                continue
            if not any(
                _contains(s, (ast.Await,)) or isinstance(s, ast.Await)
                for s in t.body
            ):
                continue
            for h in t.handlers:
                if _handler_names(h) & CANCELLED_NAMES:
                    continue
                exits = any(
                    isinstance(n, (ast.Raise, ast.Break, ast.Return))
                    for n in _walk_in_scope(h)
                )
                if not exits:
                    retry = True
        if not retry:
            return
        # bounded if the loop body contains ANY backoff/deadline call —
        # delay() between attempts, timeout() around the await
        for n in _walk_in_scope(loop):
            if isinstance(n, ast.Call):
                dotted = mod.dotted(n.func) or ""
                if dotted.rsplit(".", 1)[-1] in self.BOUNDING:
                    return
        yield mod.finding(
            self.id,
            loop,
            fn.name,
            f"`while True` retry loop in actor `{fn.name}` swallows errors "
            f"with no deadline, attempt bound, or backoff — a dead "
            f"dependency spins it hot forever; add delay()/timeout() or a "
            f"bounded for-loop",
        )


RULES: list[Rule] = [
    DroppedFutureRule(),
    BlockingCallRule(),
    CancelledSwallowRule(),
    UnboundedRetryRule(),
]
