"""Lexical compiled-region detection for the PyTorch port.

"Runs compiled" is a dynamic property, but in this package it is almost
always visible lexically. A **compiled region** is any of:

* ``compile`` — a function decorated with ``torch.compile`` (bare, called,
  or through ``functools.partial``) or passed to ``torch.compile(f, ...)``:
  dynamo traces its body into a graph, so a host read there is a graph
  break and a device sync;
* ``capture`` — the body of a ``with torch.cuda.graph(...)`` block: the
  work is recorded once and replayed without Python, so a host read there
  either fails the capture or is frozen into it;
* ``fake`` — a ``torch.library`` custom op's fake implementation
  (``@op.register_fake`` / ``torch.library.register_fake``): it runs on
  FakeTensors under the compiler, which hold no data;
* ``hot-loop`` — a per-batch loop the package declares hot with a
  ``# torchlint: hot-loop`` comment on (or alone on the line above) its
  ``for``/``while``: the loops of ``train_epoch``, of the evaluation and of
  the serving batcher's worker. Nothing is traced there, but a host sync
  per iteration stalls the device every step.

For each region the analyzer records which names hold tensors
(``traced``): a compiled function's parameters, except ``self`` and those
annotated with a non-tensor type; a fake's parameters whose custom op
annotates them ``Tensor``; a hot loop's targets and the names its body
binds from calls. ``float(scale)`` of a Python float is fine, ``float(x)``
of a tensor is a sync.

Known blind spot, by design: a function compiled at a distant call site
(``compile_forward(train_forward, device)``) is not marked here; the
project layer (callgraph.py) marks it through the call.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Optional

__all__ = [
    "CompiledRegion",
    "build_compiled_regions",
    "compile_mode",
    "dotted_name",
    "is_compile_wrapper",
    "is_fake_registration",
    "literal_str_seq",
    "param_names",
    "partial_bindings",
    "unwrap_partial",
]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.graph`` -> "torch.cuda.graph"; None for non-name
    expressions."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def is_compile_wrapper(func: ast.AST) -> bool:
    """True for ``torch.compile`` / ``torch.compiler.compile`` (a bare
    ``compile`` is Python's builtin and does not count)."""
    name = dotted_name(func)
    if not name:
        return False
    parts = name.split(".")
    return len(parts) >= 2 and parts[0] == "torch" and parts[-1] == "compile"


def compile_mode(call: ast.Call) -> Optional[str]:
    """The literal ``mode=`` of a ``torch.compile`` call, or None."""
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            return kw.value.value
    return None


def _is_capture_call(node: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (a CUDA-graph capture context)."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func) or ""
    return name.endswith("cuda.graph")


def is_fake_registration(func: ast.AST) -> bool:
    """``op.register_fake`` / ``torch.library.register_fake`` /
    ``torch.library.impl_abstract``."""
    name = dotted_name(func) or ""
    return name.rsplit(".", 1)[-1] in ("register_fake", "impl_abstract")


def _is_partial(func: ast.AST) -> bool:
    return dotted_name(func) in ("partial", "functools.partial")


def literal_str_seq(node: ast.AST) -> Optional[list]:
    """``"x"`` or ``("x", "y")``/``["x"]`` -> list of strings; else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant) and isinstance(elt.value, str)):
                return None
            out.append(elt.value)
        return out
    return None


def param_names(fn: ast.AST) -> list:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    return names


def _params(fn: ast.AST) -> list:
    a = fn.args
    out = list(a.posonlyargs + a.args + a.kwonlyargs)
    if a.vararg:
        out.append(a.vararg)
    return out


def unwrap_partial(node: ast.AST) -> ast.AST:
    """partial(f, ...) -> f (one level is all the package uses)."""
    return partial_bindings(node)[0]


def partial_bindings(node: ast.AST) -> tuple:
    """``partial(f, a, b, kw=c)`` -> ``(f, 2, frozenset({"kw"}))``; anything
    that is not a partial call -> ``(node, 0, frozenset())``."""
    if isinstance(node, ast.Call) and _is_partial(node.func) and node.args:
        kw = frozenset(k.arg for k in node.keywords if k.arg)
        return node.args[0], len(node.args) - 1, kw
    return node, 0, frozenset()


@dataclasses.dataclass
class CompiledRegion:
    """One compiled region: a function body, a capture block or a loop."""

    node: ast.AST  # FunctionDef / Lambda / With / For / While
    start: int
    end: int
    reason: str  # human-readable: how this code ends up compiled or hot
    kind: str  # "compile" | "capture" | "fake" | "hot-loop"
    traced: frozenset  # names that hold tensors there

    def walk(self):
        """The nodes of the region's own code: a function's body (a
        lambda's expression), a block's or a loop's body — not a ``with``
        item or a loop's iterable."""
        body = [self.node.body] if isinstance(self.node, ast.Lambda) else self.node.body
        for stmt in body:
            yield from ast.walk(stmt)


def _non_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    return "Tensor" not in ast.unparse(ann)


def _function_region(fn, reason, kind, n_bound=0, bound_kw=frozenset(), tensor_params=None):
    params = _params(fn)[n_bound:]
    if tensor_params is not None:
        traced = [p.arg for i, p in enumerate(params) if i in tensor_params]
    else:
        traced = [p.arg for p in params
                  if p.arg != "self" and p.arg not in bound_kw
                  and not _non_tensor_annotation(p.annotation)]
    return CompiledRegion(
        node=fn,
        start=fn.lineno,
        end=fn.end_lineno or fn.lineno,
        reason=reason,
        kind=kind,
        traced=frozenset(traced),
    )


_HOT_LOOP_RE = re.compile(r"#\s*torchlint:\s*hot-loop\b")


def hot_loop_lines(source: str) -> set:
    """Lines a ``# torchlint: hot-loop`` comment declares: its own, and the
    next line when the comment stands alone."""
    out: set = set()
    for i, line in enumerate(source.splitlines(), start=1):
        m = _HOT_LOOP_RE.search(line)
        if m is None:
            continue
        out.add(i)
        if not line[: m.start()].strip():
            out.add(i + 1)
    return out


def _loop_bound_names(loop: ast.AST) -> set:
    """A hot loop's tensor-holding names: its targets and every name its
    body binds from a call (``out = step(state, batch)``)."""
    names: set = set()
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        names.update(n.id for n in ast.walk(loop.target) if isinstance(n, ast.Name))
    for node in ast.walk(loop):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            for t in node.targets:
                names.update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))
    return names


def _custom_ops(tree: ast.Module) -> dict:
    """name -> FunctionDef for ``@torch.library.custom_op(...)`` defs."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if (dotted_name(target) or "").endswith("custom_op"):
                    out[node.name] = node
    return out


def fake_target(dec_or_call: ast.AST, ops: dict):
    """The custom-op def a fake registration belongs to: ``op`` of
    ``@op.register_fake``, or the op named by a ``"ns::name"`` string."""
    func = dec_or_call.func if isinstance(dec_or_call, ast.Call) else dec_or_call
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        if func.value.id in ops:
            return ops[func.value.id]
    if isinstance(dec_or_call, ast.Call) and dec_or_call.args:
        first = dec_or_call.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return ops.get(first.value.rsplit("::", 1)[-1])
    return None


def _tensor_positions(op) -> Optional[set]:
    if op is None:
        return None
    return {i for i, p in enumerate(_params(op))
            if p.annotation is not None and "Tensor" in ast.unparse(p.annotation)}


def build_compiled_regions(tree: ast.Module, source: str = "") -> list:
    """All lexical compiled regions of a module, sorted by position."""
    defs: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
    ops = _custom_ops(tree)
    regions: dict = {}

    def add(region: CompiledRegion) -> None:
        regions.setdefault((region.start, region.end, region.kind), region)

    def add_callable(node, reason, kind, tensor_params=None) -> None:
        node, n_bound, bound_kw = partial_bindings(node)
        if isinstance(node, ast.Lambda) or (isinstance(node, ast.Name) and node.id in defs):
            fn = node if isinstance(node, ast.Lambda) else defs[node.id]
            add(_function_region(fn, reason, kind, n_bound, bound_kw, tensor_params))

    hot = hot_loop_lines(source) if source else set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                call = dec if isinstance(dec, ast.Call) else None
                if is_compile_wrapper(dec) or (call and is_compile_wrapper(call.func)):
                    add(_function_region(node, f"@{dotted_name(call.func if call else dec)}",
                                         "compile"))
                elif call and _is_partial(call.func) and call.args and is_compile_wrapper(
                        call.args[0]):
                    add(_function_region(node, f"@partial({dotted_name(call.args[0])}, ...)",
                                         "compile"))
                elif is_fake_registration(call.func if call else dec):
                    op = fake_target(dec, ops)
                    add(_function_region(node, f"fake of {op.name if op else '?'}", "fake",
                                         tensor_params=_tensor_positions(op)))
        elif isinstance(node, ast.Call):
            if is_compile_wrapper(node.func) and node.args:
                add_callable(node.args[0], f"passed to {dotted_name(node.func)}", "compile")
            elif is_fake_registration(node.func) and node.args:
                op = fake_target(node, ops)
                fn = node.args[-1]
                add_callable(fn, f"fake of {op.name if op else '?'}", "fake",
                             _tensor_positions(op))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(_is_capture_call(item.context_expr) for item in node.items):
                add(CompiledRegion(node=node, start=node.lineno,
                                   end=node.end_lineno or node.lineno,
                                   reason="a torch.cuda.graph capture", kind="capture",
                                   traced=frozenset()))
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.While)) and node.lineno in hot:
            add(CompiledRegion(node=node, start=node.lineno,
                               end=node.end_lineno or node.lineno,
                               reason="a declared hot loop", kind="hot-loop",
                               traced=frozenset(_loop_bound_names(node))))
    return sorted(regions.values(), key=lambda r: (r.start, r.end, r.kind))
