"""Thread-model discovery over the project symbol table.

Which code runs on which thread is, like "inside a compiled region", a dynamic property
that this codebase keeps lexically decidable: every worker thread is
spawned by ``threading.Thread(target=self._run, ...)``,
``threading.Timer(t, fn)``, or ``pool.submit(self._flush, ...)`` on a
declared ``ThreadPoolExecutor``. This module finds those spawn sites,
resolves the targets through project.py, and computes two closures the
concurrency rules consume:

* **worker closure** — for each function, which spawn targets can reach it
  through direct calls (with the call path, for finding traces). Edges
  here are DIRECT calls only — deliberately narrower than callgraph.py,
  whose callback edges ("passed as an argument, assumed invoked") would
  make every spawn target caller-reachable through its own spawn site.
* **caller reachability** — whether the function can also run on an
  external caller's thread: the fixpoint seeded by functions with no
  in-edges (API surface: nothing in the project calls them, so only
  external callers do) and by module-scope calls, propagated along direct
  calls. A spawn target is caller-reachable only if something also CALLS
  it directly.

Unresolvable targets (``pool.submit(task)`` where ``task`` is a local
closure, lambdas, stdlib callables like ``server.serve_forever``) are
skipped: the model under-approximates, the rules stay silent there, and
the runtime sanitizer (sanitizer.py) exists precisely to catch what this
lexical model cannot see.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from .locks import DeclaredTypes, collect_declared_types, ctor_kind
from .project import FunctionInfo, ModuleInfo, ProjectIndex
from .regions import dotted_name, unwrap_partial
from .rules import _own_statements, _root, _tail, _walk_no_nested_defs

__all__ = ["ThreadEntry", "ThreadModel"]

_POOL_NAME_HINTS = ("pool", "executor", "workers")
CALLER = "<caller>"


@dataclasses.dataclass
class ThreadEntry:
    """One spawn site: a project function handed to a thread/timer/pool."""

    qualname: str  # the target function
    kind: str  # "thread" | "timer" | "pool"
    spawner: str  # qualname of the spawning function, or "<module ...>"
    file: str
    line: int

    @property
    def label(self) -> str:
        noun = {
            "thread": "thread",
            "timer": "timer thread",
            "pool": "pool worker",
        }[self.kind]
        name = self.qualname.rsplit(".", 1)[-1]
        return f"{noun} {name}() [spawned at {self.file}:{self.line}]"


class ThreadModel:
    def __init__(
        self, index: ProjectIndex, types: Optional[DeclaredTypes] = None
    ):
        self.index = index
        self.types = types or collect_declared_types(index)
        self.entries: dict = {}  # target qualname -> [ThreadEntry]
        self.edges: dict = {}  # caller qualname -> [(callee qualname, line)]
        self.worker_paths: dict = {}  # func -> {target: ((caller, callee, line), ...)}
        self.caller_reachable: set = set()
        self.spawning_classes: set = set()  # "mod.Class"
        self._module_called: set = set()
        self._build()

    # -------------------------------------------------------------- queries
    def worker_targets(self, qualname: str) -> list:
        """Spawn targets whose closure contains this function, sorted."""
        return sorted(self.worker_paths.get(qualname, ()))

    def contexts(self, qualname: str) -> set:
        """Execution contexts: spawn-target qualnames plus CALLER."""
        out = set(self.worker_paths.get(qualname, ()))
        if qualname in self.caller_reachable:
            out.add(CALLER)
        return out

    def is_pool_target(self, target: str) -> bool:
        return any(e.kind == "pool" for e in self.entries.get(target, ()))

    def context_label(self, context: str) -> str:
        if context == CALLER:
            return "the caller's thread"
        entries = self.entries.get(context)
        if entries:
            return entries[0].label
        return context

    def trace_to(self, qualname: str, target: str) -> list:
        """Human-readable hops: spawn site -> ... -> function."""
        entries = self.entries.get(target, ())
        hops = [f"spawned: {entries[0].label}"] if entries else []
        for caller, callee, line in self.worker_paths.get(qualname, {}).get(
            target, ()
        ):
            cfi = self.index.functions.get(caller)
            loc = f"{cfi.path}:{line}" if cfi else str(line)
            hops.append(f"{_short(caller)} calls {_short(callee)} ({loc})")
        return hops

    # ------------------------------------------------------------- building
    def _build(self) -> None:
        index = self.index
        for mi in index.modules.values():
            local_fns = sorted(
                (
                    fi
                    for fi in index.functions.values()
                    if fi.path == mi.path
                ),
                key=lambda f: f.qualname,
            )
            scopes = [(None, mi.tree.body)]
            scopes.extend((fi, fi.node.body) for fi in local_fns)
            for scope, body in scopes:
                local_pools = _local_pool_names(body)
                for node in _walk_no_nested_defs(_own_statements(body)):
                    if not isinstance(node, ast.Call):
                        continue
                    callee = index.resolve_call(mi, node.func, scope)
                    if callee is not None:
                        if scope is not None:
                            self.edges.setdefault(
                                scope.qualname, []
                            ).append((callee.qualname, node.lineno))
                        else:
                            self._module_called.add(callee.qualname)
                    self._scan_spawn(node, mi, scope, local_pools)
        self._close_workers()
        self._close_callers()

    def _scan_spawn(self, node, mi, scope, local_pools) -> None:
        name = dotted_name(node.func) or ""
        tail = _tail(name)
        target_expr = None
        kind = None
        if tail == "Thread" and _root(name) in ("threading", "Thread"):
            kind = "thread"
            for kw in node.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
        elif tail == "Timer" and _root(name) in ("threading", "Timer"):
            kind = "timer"
            if len(node.args) >= 2:
                target_expr = node.args[1]
            for kw in node.keywords:
                if kw.arg == "function":
                    target_expr = kw.value
        elif tail == "submit" and isinstance(node.func, ast.Attribute):
            if self._is_pool(node.func.value, scope, local_pools):
                kind = "pool"
                if node.args:
                    target_expr = node.args[0]
        if kind is None or target_expr is None:
            return
        target = self.index.resolve_call(
            mi, unwrap_partial(target_expr), scope
        )
        if target is None:
            return
        spawner = (
            scope.qualname if scope else f"<module {mi.modname}>"
        )
        entry = ThreadEntry(
            qualname=target.qualname,
            kind=kind,
            spawner=spawner,
            file=mi.path,
            line=node.lineno,
        )
        self.entries.setdefault(target.qualname, []).append(entry)
        for fi in (scope, target):
            if fi is not None and fi.class_name:
                self.spawning_classes.add(f"{fi.modname}.{fi.class_name}")

    def _is_pool(self, receiver, scope, local_pools) -> bool:
        rname = dotted_name(receiver) or ""
        parts = rname.split(".")
        if (
            parts
            and parts[0] == "self"
            and len(parts) == 2
            and scope is not None
            and scope.class_name
        ):
            cq = f"{scope.modname}.{scope.class_name}"
            if self.types.attr_kind(cq, parts[1]) == "pool":
                return True
        if len(parts) == 1 and parts[0] in local_pools:
            return True
        return bool(rname) and any(
            h in rname.lower() for h in _POOL_NAME_HINTS
        )

    def _close_workers(self) -> None:
        for target in sorted(self.entries):
            frontier = [(target, ())]
            seen = {target}
            self.worker_paths.setdefault(target, {})[target] = ()
            while frontier:
                qual, path = frontier.pop(0)
                for callee, line in self.edges.get(qual, ()):
                    if callee in seen:
                        continue
                    seen.add(callee)
                    hop = path + ((qual, callee, line),)
                    self.worker_paths.setdefault(callee, {})[target] = hop
                    frontier.append((callee, hop))

    def _close_callers(self) -> None:
        targets = set(self.entries)
        in_deg: dict = {q: 0 for q in self.index.functions}
        for caller, outs in self.edges.items():
            for callee, _line in outs:
                if callee in in_deg:
                    in_deg[callee] += 1
        roots = {
            q
            for q, d in in_deg.items()
            if d == 0 and q not in targets
        }
        roots |= self._module_called - targets
        reach = set(roots)
        frontier = sorted(roots)
        while frontier:
            qual = frontier.pop()
            for callee, _line in self.edges.get(qual, ()):
                if callee not in reach:
                    reach.add(callee)
                    frontier.append(callee)
        self.caller_reachable = reach


def _short(qualname: str) -> str:
    parts = qualname.split(".")
    return ".".join(parts[-2:]) if len(parts) > 1 else qualname


def _local_pool_names(body) -> set:
    """Names bound to a pool constructor inside one scope body, including
    ``with ThreadPoolExecutor(...) as pool:``."""
    out: set = set()
    for node in _walk_no_nested_defs(_own_statements(body)):
        if isinstance(node, ast.Assign) and ctor_kind(node.value) == "pool":
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if (
                    ctor_kind(item.context_expr) == "pool"
                    and isinstance(item.optional_vars, ast.Name)
                ):
                    out.add(item.optional_vars.id)
    return out
