"""Interprocedural checks: the per-file rules, fired through call chains.

Three of the torch rules have failure modes that routinely live one or
more calls away from the pattern the per-file layer matches:

* ``compiled-host-sync`` — the ``.item()``/``.cpu()`` sits in a helper
  called from a compiled forward, not in the forward itself;
* ``collective-order`` — the call under ``if is_primary():`` is a benign-
  looking wrapper whose callee graph ends in ``dist.all_reduce``;
* ``recompile-hazard`` — the ``torch.compile`` is constructed inside a
  factory that a loop calls every iteration;

and ``cudagraph-output-reuse`` recognises a CUDA-graph callable built by a
factory in another module (``compile_forward`` on CUDA). Each finding
reuses the per-file rule id (same waiver syntax, same ``--select``
vocabulary) and carries a ``trace``: the call path from the compiled
entry / rank branch / factory to the flagged line. Findings that
duplicate a per-file finding at the same (file, line, rule) are dropped
by the caller — the lexical message is the more precise one.

Resolution limits are inherited from project.py: unresolved calls are
silent, resolved ones are exact. Depth bounds live in callgraph.py.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .callgraph import CallGraph, _fmt
from .core import RULES, is_test_file
from .project import ProjectIndex
from .regions import dotted_name
from .rules import (
    CompiledHostSyncRule,
    CudagraphOutputReuseRule,
    RecompileHazardRule,
    _own_statements,
    _walk_no_nested_defs,
    host_sync_call,
    is_collective_call,
    rank_conditional_test,
)

__all__ = ["check_project", "ProjectView"]


class ProjectView:
    """What the per-file dataflow rules may ask the project about."""

    def __init__(self, graph: CallGraph, modinfo):
        self.graph = graph
        self.index = graph.index
        self.mi = modinfo

    def cudagraph_factory(self, call: ast.Call, scope_node):
        """A witness when the call's callee returns a CUDA-graph callable."""
        scope = self.index.function_for_node(scope_node) if scope_node is not None else None
        callee = self.index.resolve_call(self.mi, call.func, scope)
        if callee is None:
            return None
        return self.graph.cudagraph_factory(callee)


def _in_spans(line: int, spans) -> bool:
    return any(s <= line <= e for s, e in spans)


def _host_sync_findings(graph: CallGraph, contexts) -> Iterator:
    """Host syncs in functions that run compiled through a call chain but
    are not lexically marked (the lexical layer covers those)."""
    rule = CompiledHostSyncRule()
    lexical = {id(r.node) for regions in graph.regions_by_module.values() for r in regions}
    for qual, reach in graph.reachable.items():
        fi = graph.index.functions.get(qual)
        if fi is None or id(fi.node) in lexical:
            continue
        ctx = contexts.get(fi.path)
        if ctx is None:
            continue
        spans = [(r.start, r.end) for r in graph.regions_by_module.get(fi.modname, ())]
        trace = reach.trace()
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call) or _in_spans(node.lineno, spans):
                continue
            label = host_sync_call(node)
            if label:
                yield ctx.finding(
                    rule, node,
                    f"{label} in {fi.name}(), which runs compiled — waits for "
                    "the device inside the graph (a graph break); hoist it "
                    "past the compiled boundary",
                    trace=trace + [f"{fi.name} ({fi.path}:{node.lineno})"],
                )


def _collective_findings(graph: CallGraph, contexts) -> Iterator:
    """Calls under a rank-conditional branch whose callees (transitively)
    issue a collective. Direct collectives under the branch are the
    per-file rule's findings and are skipped here."""
    rule_obj = RULES["collective-order"]
    index = graph.index
    for mi in index.modules.values():
        ctx = contexts.get(mi.path)
        if ctx is None:
            continue
        scopes = [(None, mi.tree.body)]
        scopes.extend((fi, fi.node.body) for fi in index.functions.values() if fi.path == mi.path)
        seen: set = set()
        for scope, body in scopes:
            for node in _walk_no_nested_defs(_own_statements(body)):
                if not isinstance(node, ast.If) or not rank_conditional_test(node):
                    continue
                for branch in (node.body, node.orelse):
                    for stmt in branch:
                        for sub in ast.walk(stmt):
                            if not isinstance(sub, ast.Call) or is_collective_call(sub):
                                continue
                            callee = index.resolve_call(mi, sub.func, scope)
                            if callee is None:
                                continue
                            witness = graph.collective_witness(callee)
                            if witness is None or (sub.lineno, sub.col_offset) in seen:
                                continue
                            seen.add((sub.lineno, sub.col_offset))
                            yield ctx.finding(
                                rule_obj, sub,
                                f"{dotted_name(sub.func)}(...) under a rank-conditional "
                                f"branch transitively issues a collective "
                                f"({' -> '.join(witness)}) — ranks that skip the "
                                "branch never post it and the world hangs; run it "
                                "on every rank",
                                trace=[f"{_fmt(callee)} called at {mi.path}:{sub.lineno}"]
                                + witness,
                            )


def _recompile_findings(graph: CallGraph, contexts) -> Iterator:
    """Loop call sites of functions that build a fresh torch.compile on
    every call (a factory called per iteration)."""
    rule = RecompileHazardRule()
    index = graph.index
    for mi in index.modules.values():
        ctx = contexts.get(mi.path)
        if ctx is None or ctx.is_test:
            continue
        scopes = [(None, mi.tree.body)]
        scopes.extend((fi, fi.node.body) for fi in index.functions.values() if fi.path == mi.path)
        for scope, body in scopes:
            yield from _recompile_scan(rule, ctx, mi, index, graph, scope,
                                       _own_statements(body), 0)


def _recompile_scan(rule, ctx, mi, index, graph, scope, stmts, loops) -> Iterator:
    for stmt in stmts:
        in_loop = loops + (1 if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)) else 0)
        if in_loop:
            for node in _walk_no_nested_defs([stmt]):
                if not isinstance(node, ast.Call):
                    continue
                callee = index.resolve_call(mi, node.func, scope)
                if callee is None:
                    continue
                hit = graph.constructs_compile(callee)
                if hit is None:
                    continue
                _line, witness = hit
                yield ctx.finding(
                    rule, node,
                    f"{dotted_name(node.func)}(...) called in a loop builds a "
                    f"fresh torch.compile every iteration ({witness}) — hoist "
                    "the factory call out of the loop or cache its result",
                    trace=[witness],
                )
        else:
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    yield from _recompile_scan(rule, ctx, mi, index, graph, scope,
                                               _own_statements(sub), loops)
            for h in getattr(stmt, "handlers", []) or []:
                yield from _recompile_scan(rule, ctx, mi, index, graph, scope,
                                           _own_statements(h.body), loops)


def check_project(index: ProjectIndex, contexts: dict) -> Iterator:
    """All interprocedural findings over the indexed project.

    ``contexts`` maps file path -> ModuleContext (the same parsed trees
    the per-file pass used)."""
    graph = CallGraph(index, {path: ctx.source for path, ctx in contexts.items()})

    findings: list = list(_host_sync_findings(graph, contexts))
    findings.extend(_collective_findings(graph, contexts))
    findings.extend(_recompile_findings(graph, contexts))

    # concurrency layer: thread model + locksets (project-only rules)
    from .concurrency_rules import concurrency_findings

    findings.extend(concurrency_findings(index, contexts))

    # the CUDA-graph dataflow re-run with the project view (duplicates of
    # the per-file pass are dropped by the caller)
    reuse = CudagraphOutputReuseRule()
    for mi in index.modules.values():
        ctx = contexts.get(mi.path)
        if ctx is None:
            continue
        findings.extend(reuse.check_project(ctx, ProjectView(graph, mi)))

    for f in findings:
        rule = RULES.get(f.rule)
        if rule is not None and rule.skip_in_tests and is_test_file(f.file):
            continue
        yield f
