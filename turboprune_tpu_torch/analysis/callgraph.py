"""Call graph + compiled-region reachability + interprocedural summaries.

Built on project.py's symbol table. Three products, all consumed by
interproc.py:

1. **Edges** — ``caller -> (callee, line)`` for every resolved call, plus
   "passed as a callback" edges (a project function handed to another call
   is assumed invokable there; over-approximate on purpose, reachability
   wants no false negatives on resolved names).

2. **Compiled entries** — functions whose bodies run compiled. Lexical
   entries come straight from regions.py (``compile`` and ``fake``
   regions); the interprocedural ones are the package's two factory idioms
   that the lexical layer documents as its blind spot:

   * higher-order compiling — ``compile_forward(train_forward, device)``
     where the factory's body does ``torch.compile(fn, ...)``: the argument
     bound to the compiled parameter becomes an entry;
   * closure factories — ``f = make_forward(...)`` returns a nested def, so
     when ``f`` later flows into ``torch.compile`` (directly or via a
     higher-order factory) the NESTED function is the entry.

3. **Summaries** — per-function facts the rules consume: which params a
   function compiles, which nested def it returns, whether it returns a
   CUDA-graph callable (a ``reduce-overhead`` compile, or a nested def
   calling one), whether it (transitively) issues a collective, and
   whether it constructs a fresh ``torch.compile`` on every call. Each
   summary memoizes and carries a witness path.

Depth is bounded (``MAX_DEPTH``) and cycles short-circuit: the analysis
must terminate on any input, including mutually recursive helpers.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from .project import FunctionInfo, ModuleInfo, ProjectIndex
from .regions import (
    build_compiled_regions,
    compile_mode,
    dotted_name,
    is_compile_wrapper,
    unwrap_partial,
)
from .rules import (
    _own_statements,
    _walk_no_nested_defs,
    is_collective_call,
)

__all__ = ["CallGraph", "MAX_DEPTH"]

MAX_DEPTH = 10


def _fmt(fi: FunctionInfo) -> str:
    return f"{fi.name} ({fi.location()})"


@dataclasses.dataclass
class Reach:
    """How a function comes to run compiled: the entry plus the chain."""

    entry: FunctionInfo
    entry_reason: str
    path: tuple  # ((FunctionInfo, call line), ...) from entry to target

    def trace(self) -> list:
        hops = [f"compiled entry {_fmt(self.entry)} [{self.entry_reason}]"]
        hops.extend(f"{_fmt(fi)} called at line {line}" for fi, line in self.path)
        return hops


class CallGraph:
    def __init__(self, index: ProjectIndex, sources: Optional[dict] = None):
        self.index = index
        self.sources = sources or {}
        self.edges: dict = {}  # qualname -> [(FunctionInfo, line)]
        self.entries: dict = {}  # qualname -> reason
        self.regions_by_module: dict = {}  # modname -> list[CompiledRegion]
        self.reachable: dict = {}  # qualname -> Reach
        self._memo: dict = {}
        self._build()

    # -------------------------------------------------------------- helpers
    def _own_calls(self, fi: FunctionInfo):
        for node in _walk_no_nested_defs(_own_statements(fi.node.body)):
            if isinstance(node, ast.Call):
                yield node

    def _func_from_expr(self, expr, mi, scope, local_fns) -> Optional[FunctionInfo]:
        """A call argument that denotes a project function: a bare name, a
        factory-result local, or partial(<one of those>, ...)."""
        expr = unwrap_partial(expr)
        if isinstance(expr, ast.Name):
            if expr.id in local_fns:
                return local_fns[expr.id]
            return self.index.resolve_call(mi, expr, scope)
        return None

    def _scopes(self, mi: ModuleInfo):
        yield None, mi.tree.body
        for fi in self.index.functions.values():
            if fi.modname == mi.modname and fi.path == mi.path:
                yield fi, fi.node.body

    def _local_fns(self, mi, scope, body) -> dict:
        """name -> FunctionInfo for factory-result/alias locals in a scope."""
        out: dict = {}
        for node in _walk_no_nested_defs(_own_statements(body)):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            if not isinstance(target, ast.Name):
                continue
            value = node.value
            if isinstance(value, ast.Call):
                callee = self.index.resolve_call(mi, value.func, scope)
                if callee is not None:
                    ret = self.returns_nested(callee)
                    if ret is not None:
                        out[target.id] = ret
            elif isinstance(value, ast.Name):
                fi = self.index.resolve_call(mi, value, scope)
                if fi is not None:
                    out[target.id] = fi
        return out

    # -------------------------------------------------------------- building
    def _build(self) -> None:
        for mi in self.index.modules.values():
            self.regions_by_module[mi.modname] = build_compiled_regions(
                mi.tree, self.sources.get(mi.path, ""))

        # lexical entries: compiled functions and fakes that are indexed
        for mi in self.index.modules.values():
            for region in self.regions_by_module[mi.modname]:
                if region.kind not in ("compile", "fake"):
                    continue
                fi = self.index.function_for_node(region.node)
                if fi is not None:
                    self.entries.setdefault(fi.qualname, region.reason)

        for fi in self.index.functions.values():
            mi = self.index.modules.get(fi.modname)
            if mi is None:
                continue
            edges = self.edges.setdefault(fi.qualname, [])
            for call in self._own_calls(fi):
                callee = self.index.resolve_call(mi, call.func, fi)
                if callee is not None:
                    edges.append((callee, call.lineno))
                for arg in list(call.args) + [k.value for k in call.keywords]:
                    passed = self._func_from_expr(arg, mi, fi, {})
                    if passed is not None:
                        edges.append((passed, call.lineno))

        for mi in self.index.modules.values():
            for scope, body in self._scopes(mi):
                self._detect_entries(mi, scope, body)

        self._compute_reachability()

    def _detect_entries(self, mi, scope, body) -> None:
        local_fns = self._local_fns(mi, scope, body)
        where = _fmt(scope) if scope else f"module scope ({mi.path})"
        for call in _walk_no_nested_defs(_own_statements(body)):
            if not isinstance(call, ast.Call):
                continue
            if is_compile_wrapper(call.func):
                for arg in call.args[:1]:
                    fi = self._func_from_expr(arg, mi, scope, local_fns)
                    if fi is None and isinstance(arg, ast.Call):
                        # torch.compile(make_fn(...)): the def make_fn returns
                        factory = self.index.resolve_call(mi, arg.func, scope)
                        fi = self.returns_nested(factory) if factory is not None else None
                    if fi is not None:
                        self.entries.setdefault(
                            fi.qualname,
                            f"passed to {dotted_name(call.func)} at "
                            f"{mi.path}:{call.lineno} in {where}",
                        )
                continue
            callee = self.index.resolve_call(mi, call.func, scope)
            if callee is None:
                continue
            compiled = self.compiles_params(callee)
            if not compiled:
                continue
            bound = isinstance(call.func, ast.Attribute)
            for param, arg in callee.arg_to_param(call, bound):
                if param not in compiled:
                    continue
                fi = self._func_from_expr(arg, mi, scope, local_fns)
                if fi is not None:
                    self.entries.setdefault(
                        fi.qualname,
                        f"compiled via {_fmt(callee)} (param {param!r}), "
                        f"called at {mi.path}:{call.lineno} in {where}",
                    )

    def _compute_reachability(self) -> None:
        frontier = []
        for qual, reason in self.entries.items():
            fi = self.index.functions.get(qual)
            if fi is None:
                continue
            self.reachable[qual] = Reach(entry=fi, entry_reason=reason, path=())
            frontier.append(fi)
        depth = 0
        while frontier and depth < MAX_DEPTH:
            depth += 1
            nxt = []
            for fi in frontier:
                reach = self.reachable[fi.qualname]
                for callee, line in self.edges.get(fi.qualname, ()):
                    if callee.qualname in self.reachable:
                        continue
                    self.reachable[callee.qualname] = Reach(
                        entry=reach.entry,
                        entry_reason=reach.entry_reason,
                        path=reach.path + ((callee, line),),
                    )
                    nxt.append(callee)
            frontier = nxt

    # ------------------------------------------------------------- summaries
    def _memoized(self, key, compute, in_progress_value=None):
        if key in self._memo:
            return self._memo[key]
        self._memo[key] = in_progress_value  # cycle guard
        self._memo[key] = compute()
        return self._memo[key]

    def compiles_params(self, fi: FunctionInfo) -> dict:
        """Param names this function hands to ``torch.compile``, with the
        line it happens on: ``{param: line}``."""

        def compute():
            out = {}
            params = set(fi.params)
            for call in self._own_calls(fi):
                if not is_compile_wrapper(call.func) or not call.args:
                    continue
                target = unwrap_partial(call.args[0])
                if isinstance(target, ast.Name) and target.id in params:
                    out.setdefault(target.id, call.lineno)
            return out

        return self._memoized(("compiles", fi.qualname), compute, {})

    def returns_nested(self, fi: FunctionInfo, _depth: int = 0) -> Optional[FunctionInfo]:
        """The nested def this function returns (closure-factory pattern),
        also when it returns a function object rebuilt from the nested
        def's code (``types.FunctionType(region.__code__, ...)``): the
        runtime code object is then the nested def's."""
        if _depth > MAX_DEPTH:
            return None

        def compute():
            mi = self.index.modules.get(fi.modname)
            nested = [n for n in fi.node.body
                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            for node in _walk_no_nested_defs(_own_statements(fi.node.body)):
                if not isinstance(node, ast.Return) or node.value is None:
                    continue
                value = unwrap_partial(node.value)
                if isinstance(value, ast.Name):
                    found = self.index.functions.get(f"{fi.qualname}.{value.id}")
                    if found is not None:
                        return found
                elif isinstance(value, ast.Call) and mi is not None:
                    if (dotted_name(value.func) or "").endswith("FunctionType") and len(nested) == 1:
                        return self.index.functions.get(f"{fi.qualname}.{nested[0].name}")
                    callee = self.index.resolve_call(mi, value.func, fi)
                    if callee is not None and callee.qualname != fi.qualname:
                        inner = self.returns_nested(callee, _depth + 1)
                        if inner is not None:
                            return inner
            return None

        return self._memoized(("retnested", fi.qualname), compute)

    def cudagraph_factory(self, fi: FunctionInfo, _depth: int = 0) -> Optional[str]:
        """A witness when this function returns a callable that runs under
        CUDA graphs: ``torch.compile(..., mode="reduce-overhead")`` itself,
        a local bound to one, or a nested def that calls such a local."""
        if _depth > MAX_DEPTH:
            return None

        def compute():
            graphed = {}
            for node in _walk_no_nested_defs(_own_statements(fi.node.body)):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and is_compile_wrapper(node.value.func)
                    and compile_mode(node.value) in ("reduce-overhead", "max-autotune")
                ):
                    graphed[node.targets[0].id] = node.value.lineno
            for node in _walk_no_nested_defs(_own_statements(fi.node.body)):
                if not isinstance(node, ast.Return) or node.value is None:
                    continue
                value = node.value
                if (
                    isinstance(value, ast.Call)
                    and is_compile_wrapper(value.func)
                    and compile_mode(value) in ("reduce-overhead", "max-autotune")
                ):
                    return f"{_fmt(fi)} returns a CUDA-graph compile (line {value.lineno})"
                if isinstance(value, ast.Name):
                    if value.id in graphed:
                        return (f"{_fmt(fi)} returns a CUDA-graph compile "
                                f"(line {graphed[value.id]})")
                    nested = self.index.functions.get(f"{fi.qualname}.{value.id}")
                    if nested is not None:
                        for sub in ast.walk(nested.node):
                            if isinstance(sub, ast.Call) and dotted_name(sub.func) in graphed:
                                return (f"{_fmt(fi)} returns {value.id}(), which calls a "
                                        f"CUDA-graph compile (line {graphed[dotted_name(sub.func)]})")
            return None

        return self._memoized(("cudagraph", fi.qualname), compute)

    def collective_witness(self, fi: FunctionInfo, _depth: int = 0):
        """Call-path to a collective this function (transitively) issues,
        as a list of hop strings; None when it provably issues none we can
        see. Uniform internal guards (a world-size check) do NOT clear it:
        ONE rank calling this under a rank branch still posts the
        collective that the other ranks never reach."""
        if _depth > MAX_DEPTH:
            return None

        def compute():
            mi = self.index.modules.get(fi.modname)
            for call in self._own_calls(fi):
                if is_collective_call(call):
                    return [f"{dotted_name(call.func)} ({fi.path}:{call.lineno})"]
            if mi is None:
                return None
            for call in self._own_calls(fi):
                callee = self.index.resolve_call(mi, call.func, fi)
                if callee is None or callee.qualname == fi.qualname:
                    continue
                inner = self.collective_witness(callee, _depth + 1)
                if inner is not None:
                    return [f"{_fmt(callee)} called at line {call.lineno}"] + inner
            return None

        return self._memoized(("collective", fi.qualname), compute)

    def constructs_compile(self, fi: FunctionInfo, _depth: int = 0):
        """``(line, witness)`` when EVERY call of this function builds a
        fresh ``torch.compile`` — the construction (or an unguarded call to
        another constructor) sits outside any If/Try and before any early
        return. A construction behind a cache lookup stays silent."""
        if _depth > MAX_DEPTH:
            return None

        def compute():
            mi = self.index.modules.get(fi.modname)
            returns = [n.lineno for n in _walk_no_nested_defs(_own_statements(fi.node.body))
                       if isinstance(n, ast.Return)]
            first_return = min(returns) if returns else 10**9

            def visit(node):
                if isinstance(node, (ast.If, ast.IfExp, ast.Try, ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
                    return None
                if isinstance(node, ast.Call) and node.lineno <= first_return:
                    if is_compile_wrapper(node.func):
                        return (node.lineno,
                                f"{_fmt(fi)} builds {dotted_name(node.func)} at line {node.lineno}")
                    if mi is not None:
                        callee = self.index.resolve_call(mi, node.func, fi)
                        if callee is not None and callee.qualname != fi.qualname:
                            inner = self.constructs_compile(callee, _depth + 1)
                            if inner is not None:
                                return (node.lineno, f"{_fmt(fi)} -> {inner[1]}")
                for child in ast.iter_child_nodes(node):
                    hit = visit(child)
                    if hit is not None:
                        return hit
                return None

            for stmt in fi.node.body:
                hit = visit(stmt)
                if hit is not None:
                    return hit
            return None

        return self._memoized(("constructs", fi.qualname), compute)
