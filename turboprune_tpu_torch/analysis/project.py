"""Project-wide symbol table: modules, functions, and import resolution.

The per-file layer (regions.py) deliberately stops at module boundaries —
its documented blind spot is a function compiled at a distant call site
(train/steps.py's forwards, handed to ``torch.compile`` inside
``compile_forward``).
This module supplies the missing half: it parses every analyzed module
once, records every module-level function, every method, and every nested
def under a stable qualified name, and resolves the names a call site uses
(including relative imports and package ``__init__`` re-exports, the two
idioms this repo leans on) back to those definitions. callgraph.py builds
edges and compiled-region reachability on top; interproc.py turns both into findings.

Resolution is deliberately bounded — no type inference, no instance
attribute tracking. What IS resolved, because the repo's style makes it
both common and decidable:

* plain calls to module-level functions (same module or imported),
* dotted calls through module aliases (``masking.apply_masks``),
* ``self.method()`` inside a class body,
* re-export chains (``from .parallel import is_primary`` where
  parallel/__init__.py itself imports it from ``.multihost``),
* nested defs by name inside their enclosing function.

Everything else resolves to None and the interprocedural rules stay
silent — the contract is the same as the lexical layer's: zero false
negatives on the RESOLVED patterns, no claims about the rest.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, Optional

from .regions import dotted_name, param_names

__all__ = ["FunctionInfo", "ModuleInfo", "ProjectIndex", "module_name_for"]

_MAX_RESOLVE_DEPTH = 16


def module_name_for(path) -> str:
    """Dotted module name, walking up through ``__init__.py`` packages.

    ``<root>/turboprune_tpu_torch/train/steps.py`` -> "turboprune_tpu_torch.train.steps";
    a file outside any package (tests/test_x.py) is just its stem."""
    p = Path(path).resolve()
    parts = [p.stem] if p.name != "__init__.py" else []
    d = p.parent
    while (d / "__init__.py").exists():
        parts.insert(0, d.name)
        parent = d.parent
        if parent == d:
            break
        d = parent
    return ".".join(parts) if parts else p.stem


@dataclasses.dataclass
class FunctionInfo:
    """One function/method/nested def the project knows by qualified name."""

    qualname: str  # module.func / module.Class.method / module.outer.inner
    modname: str
    name: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    path: str
    class_name: Optional[str] = None
    parent: Optional[str] = None  # enclosing function qualname for nested defs
    is_bound_method: bool = False  # True: calls via self.m() skip param 0

    @property
    def params(self) -> list:
        return param_names(self.node)

    @property
    def positional_params(self) -> list:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args]

    def arg_to_param(self, call: ast.Call, bound: bool) -> list:
        """Map a call's arguments onto this function's parameter names.

        Returns ``[(param_name, arg_expr), ...]``; unmatched *args/**kwargs
        style arguments are dropped (no claim is better than a wrong one).
        ``bound`` is True for ``obj.m(...)`` calls where the first positional
        parameter is the receiver."""
        pos = self.positional_params
        offset = 1 if (bound and self.is_bound_method and pos) else 0
        out = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            j = i + offset
            if j < len(pos):
                out.append((pos[j], arg))
        names = set(self.params)
        for kw in call.keywords:
            if kw.arg and kw.arg in names:
                out.append((kw.arg, kw.value))
        return out

    def location(self) -> str:
        return f"{self.path}:{self.node.lineno}"


def _has_decorator(node, name: str) -> bool:
    return any(
        dotted_name(d) is not None and dotted_name(d).rsplit(".", 1)[-1] == name
        for d in node.decorator_list
    )


@dataclasses.dataclass
class ModuleInfo:
    """One parsed module: its tree plus local name bindings from imports."""

    modname: str
    path: str
    tree: ast.Module
    is_package: bool  # file is an __init__.py
    bindings: dict = dataclasses.field(default_factory=dict)  # name -> symbol

    def _anchor(self, level: int) -> list:
        """Base package parts for a ``from .`` / ``from ..`` import."""
        parts = self.modname.split(".")
        if not self.is_package:
            parts = parts[:-1]
        cut = level - 1
        return parts[: len(parts) - cut] if cut else parts

    def record_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.bindings[alias.asname] = alias.name
                    else:
                        head = alias.name.split(".", 1)[0]
                        self.bindings[head] = head
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = self._anchor(node.level)
                    target = ".".join(base + ([node.module] if node.module else []))
                else:
                    target = node.module or ""
                for alias in node.names:
                    local = alias.asname or alias.name
                    self.bindings[local] = (
                        f"{target}.{alias.name}" if target else alias.name
                    )


class ProjectIndex:
    """Symbol table over a set of modules, with call-name resolution."""

    def __init__(self):
        self.modules: dict = {}  # modname -> ModuleInfo
        self.functions: dict = {}  # qualname -> FunctionInfo
        self.by_node: dict = {}  # id(ast node) -> FunctionInfo

    # ------------------------------------------------------------- building
    @classmethod
    def build(cls, contexts: Iterable) -> "ProjectIndex":
        """Index from parsed per-file contexts (anything with .path/.tree)."""
        index = cls()
        for ctx in contexts:
            index.add_module(ctx.path, ctx.tree)
        return index

    def add_module(self, path, tree: ast.Module) -> None:
        modname = module_name_for(path)
        mi = ModuleInfo(
            modname=modname,
            path=str(path),
            tree=tree,
            is_package=Path(path).name == "__init__.py",
        )
        mi.record_imports()
        self.modules[modname] = mi
        self._index_scope(mi, tree.body, prefix=modname, class_name=None)

    def _index_scope(self, mi, body, prefix: str, class_name, parent=None):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{node.name}"
                bound = class_name is not None and not _has_decorator(
                    node, "staticmethod"
                )
                fi = FunctionInfo(
                    qualname=qual,
                    modname=mi.modname,
                    name=node.name,
                    node=node,
                    path=mi.path,
                    class_name=class_name,
                    parent=parent,
                    is_bound_method=bound,
                )
                self.functions[qual] = fi
                self.by_node[id(node)] = fi
                # nested defs live under the function's qualname
                self._index_scope(
                    mi, node.body, prefix=qual, class_name=None, parent=qual
                )
            elif isinstance(node, ast.ClassDef):
                self._index_scope(
                    mi,
                    node.body,
                    prefix=f"{prefix}.{node.name}",
                    class_name=node.name,
                    parent=None,
                )
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                # conditional defs (TYPE_CHECKING guards, try/except imports)
                self._index_scope_stmts(node, mi, prefix, class_name, parent)

    def _index_scope_stmts(self, stmt, mi, prefix, class_name, parent):
        for field in ("body", "orelse", "finalbody", "handlers"):
            sub = getattr(stmt, field, None)
            if not sub:
                continue
            if field == "handlers":
                for h in sub:
                    self._index_scope(mi, h.body, prefix, class_name, parent)
            else:
                self._index_scope(mi, sub, prefix, class_name, parent)

    # ------------------------------------------------------------ resolving
    def function_for_node(self, node) -> Optional[FunctionInfo]:
        return self.by_node.get(id(node))

    def resolve_symbol(self, sym: str, _depth: int = 0) -> Optional[FunctionInfo]:
        """Follow a fully-dotted symbol through re-export chains."""
        if _depth > _MAX_RESOLVE_DEPTH:
            return None
        fi = self.functions.get(sym)
        if fi is not None:
            return fi
        # peel the longest module prefix, then follow its import bindings
        mod = sym
        while "." in mod:
            mod = mod.rsplit(".", 1)[0]
            mi = self.modules.get(mod)
            if mi is None:
                continue
            rest = sym[len(mod) + 1 :]
            head, _, tail = rest.partition(".")
            if head in mi.bindings:
                target = mi.bindings[head] + (f".{tail}" if tail else "")
                return self.resolve_symbol(target, _depth + 1)
            return self.functions.get(sym)
        return None

    def resolve_call(
        self,
        modinfo: ModuleInfo,
        func: ast.AST,
        scope: Optional[FunctionInfo] = None,
    ) -> Optional[FunctionInfo]:
        """Resolve a call's func expression to a project function, or None.

        ``scope`` is the enclosing function (for ``self.m()`` and nested-def
        resolution); None means module scope."""
        name = dotted_name(func)
        if not name:
            return None
        parts = name.split(".")
        # self.method() inside a class body
        if parts[0] == "self" and scope is not None and scope.class_name:
            if len(parts) == 2:
                return self.functions.get(
                    f"{scope.modname}.{scope.class_name}.{parts[1]}"
                )
            return None
        if len(parts) == 1:
            # nested def of an enclosing function (walk the parent chain)
            s = scope
            while s is not None:
                fi = self.functions.get(f"{s.qualname}.{parts[0]}")
                if fi is not None:
                    return fi
                s = self.functions.get(s.parent) if s.parent else None
            # sibling method referenced bare inside a class? (not a pattern
            # here — plain name next tries module level, then imports)
            fi = self.functions.get(f"{modinfo.modname}.{parts[0]}")
            if fi is not None:
                return fi
            if parts[0] in modinfo.bindings:
                return self.resolve_symbol(modinfo.bindings[parts[0]])
            return None
        # dotted: resolve the head through imports / local classes
        head, rest = parts[0], ".".join(parts[1:])
        if head in modinfo.bindings:
            return self.resolve_symbol(f"{modinfo.bindings[head]}.{rest}")
        # Class.method in the same module
        return self.functions.get(f"{modinfo.modname}.{name}")

    def module_for_path(self, path) -> Optional[ModuleInfo]:
        p = str(path)
        for mi in self.modules.values():
            if mi.path == p:
                return mi
        return None
