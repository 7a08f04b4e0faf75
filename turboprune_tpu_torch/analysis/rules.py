"""The torchlint rule set: nine failure classes of a PyTorch/CUDA training
and serving stack, one for each failure class the JAX package's graftlint
rules guard against.

| JAX rule                     | torchlint rule                |
|------------------------------|-------------------------------|
| ``jit-host-sync``            | ``compiled-host-sync``        |
| ``retrace-hazard``           | ``recompile-hazard``          |
| ``static-argnames-mismatch`` | ``custom-op-fake-mismatch``   |
| ``rng-key-reuse``            | ``implicit-global-rng``       |
| ``collective-order``         | ``collective-order``          |
| ``donated-arg-reuse``        | ``cudagraph-output-reuse``    |
| ``broad-except``             | ``broad-except`` (a copy)     |
| ``debug-in-hot-path``        | ``debug-in-compiled-region``  |
| ``unhashable-width-overrides`` | ``unhashable-width-overrides`` |

Every rule says WHY its pattern matters on the GPU, because the finding
message is what a contributor sees. Severities: "error" for patterns that
corrupt results, break a graph or deadlock; "warning" for patterns that
burn time or hide failures. The CLI gates on both. Each rule has a bad
snippet and a good twin in tests/test_torch_analysis.py; change a rule
and its snippets together.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from .core import ModuleContext, Rule, register
from .regions import (
    compile_mode,
    dotted_name,
    fake_target,
    is_compile_wrapper,
    is_fake_registration,
    param_names,
)

# ------------------------------------------------------------------ helpers

# Attribute reads that are metadata, not device values: names only under
# these are not synced by a float()/int()/bool() or a truth test.
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "size", "device", "dim", "numel", "is_cuda",
    "layout", "requires_grad", "stride", "element_size", "is_floating_point",
}


def _tail(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def _root(name: Optional[str]) -> str:
    return name.split(".", 1)[0] if name else ""


def _target_names(t: ast.AST) -> list:
    """Top-level assignable dotted names of an assignment target —
    ``self.state, m`` -> ["self.state", "m"] (NOT the nested "self")."""
    if isinstance(t, (ast.Tuple, ast.List)):
        out = []
        for e in t.elts:
            out.extend(_target_names(e))
        return out
    if isinstance(t, ast.Starred):
        return _target_names(t.value)
    name = dotted_name(t)
    return [name] if name else []


def _traced_name_hits(expr: ast.AST, traced: frozenset) -> list:
    """Names of tensors used as VALUES in ``expr`` — occurrences under a
    metadata attribute (``.shape``, ``.size(0)``, ``.dtype``, ...) do not
    count."""
    shielded: set = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            for inner in ast.walk(node.value):
                if isinstance(inner, ast.Name):
                    shielded.add(id(inner))
        elif isinstance(node, ast.Call) and dotted_name(node.func) in ("len", "isinstance"):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Name):
                    shielded.add(id(inner))
    return [
        n
        for n in ast.walk(expr)
        if isinstance(n, ast.Name) and n.id in traced and id(n) not in shielded
    ]


def _function_scopes(tree: ast.Module):
    """(scope_node, scope_body, param_names) for the module and each def —
    nested defs are yielded separately and excluded from their parent's
    body walk. scope_node is None for module scope."""
    yield None, _own_statements(tree.body), []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, _own_statements(node.body), param_names(node)


def _own_statements(body):
    """The statement list with nested function/class defs snipped out (they
    form their own scopes)."""
    return [
        stmt
        for stmt in body
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
    ]


def _walk_no_nested_defs(stmts):
    """Walk statements without descending into nested def/class bodies."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            stack.append(child)


def _enclosing_map(tree: ast.AST) -> dict:
    """id(node) -> parent node."""
    parents: dict = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


# Host reads of a tensor, by method.
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


def host_sync_call(node: ast.Call) -> Optional[str]:
    """A label for a call that waits for the device (``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``,
    ``<stream or event>.synchronize()``), else None."""
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in SYNC_METHODS:
            return f".{f.attr}()"
        if f.attr == "synchronize":
            name = dotted_name(f)
            return f"{name}()" if name and name.startswith("torch") else ".synchronize()"
    return None


# ------------------------------------------------------ 1 compiled-host-sync


def _truth_hits(test: ast.AST, traced: frozenset) -> list:
    """Tensors whose truth value a test reads (a device sync)."""
    if isinstance(test, ast.Name):
        return [test] if test.id in traced else []
    if isinstance(test, ast.BoolOp):
        return [h for v in test.values for h in _truth_hits(v, traced)]
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _truth_hits(test.operand, traced)
    if isinstance(test, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in test.ops):
            return []
        return _traced_name_hits(test, traced)
    if isinstance(test, ast.Call):
        name = dotted_name(test.func) or ""
        if _tail(name) in ("any", "all", "equal", "allclose", "is_nonzero"):
            return _traced_name_hits(test, traced)
        return []
    if isinstance(test, ast.Subscript):
        return _traced_name_hits(test.value, traced)
    return []


@register
class CompiledHostSyncRule(Rule):
    """Host-device syncs inside compiled regions and declared hot loops.

    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float(t)``, a
    tensor's truth value or ``torch.cuda.synchronize()`` inside a
    ``torch.compile``'d body is a graph break (under ``fullgraph=True``, an
    error) and a device round trip; inside a CUDA-graph capture it fails
    the capture or freezes one value into every replay; inside a fake it
    reads a FakeTensor that has no data; inside a hot loop it stalls the
    device once per step.
    """

    id = "compiled-host-sync"
    severity = "error"
    description = (
        "host sync (.item()/.tolist()/.cpu()/.numpy()/float(t)/tensor truth "
        "test/torch.cuda.synchronize()) inside a compiled region or a "
        "declared hot loop"
    )
    doc_why = (
        "a graph break (an error under fullgraph=True) and a device round "
        "trip per call; in a capture or a fake it fails outright, in a hot "
        "loop it idles the card every step"
    )

    def check(self, ctx: ModuleContext) -> Iterator:
        for region in ctx.compiled_regions:
            yield from self.check_region(ctx, region)

    def check_region(self, ctx, region) -> Iterator:
        for node in region.walk():
            if isinstance(node, ast.Call):
                label = host_sync_call(node)
                if label is not None:
                    yield ctx.finding(
                        self, node,
                        f"{label} inside {region.reason} — waits for the "
                        "device; return the tensor and read it outside",
                    )
                elif (
                    isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int", "bool")
                    and node.args
                ):
                    hits = _traced_name_hits(node.args[0], region.traced)
                    if hits:
                        yield ctx.finding(
                            self, node,
                            f"{node.func.id}({hits[0].id}) of a tensor inside "
                            f"{region.reason} — a host read of a device value; "
                            "keep it a tensor (shape/dtype reads are fine)",
                        )
            elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                hits = _truth_hits(node.test, region.traced)
                if hits:
                    yield ctx.finding(
                        self, node,
                        f"truth value of tensor {hits[0].id!r} inside "
                        f"{region.reason} — data-dependent control flow "
                        "syncs the device (and breaks the graph); use "
                        "torch.where or decide on the host beforehand",
                    )


# --------------------------------------------------------- 2 recompile-hazard


def _under_cache_guard(node: ast.AST, parents: dict, stop: ast.AST) -> bool:
    """True when ``node`` sits in the body of an ``if key not in cache:``
    (a memoizing guard) below ``stop``."""
    cur = parents.get(id(node))
    while cur is not None and cur is not stop:
        if isinstance(cur, ast.If) and isinstance(cur.test, ast.Compare) and any(
            isinstance(op, ast.NotIn) for op in cur.test.ops
        ):
            return True
        cur = parents.get(id(cur))
    return False


@register
class RecompileHazardRule(Rule):
    """``torch.compile`` built where its cache cannot help.

    dynamo caches compiled graphs on the code object of the function it
    traces, at most ``recompile_limit`` (8) guard sets each: a
    ``torch.compile`` constructed in a loop (not behind a cache lookup),
    of a fresh lambda, or built and called in one expression compiles per
    call and soon hits the limit; ``torch._dynamo.reset()`` in package code
    throws away every compiled graph of the process. Tests are exempt.
    """

    id = "recompile-hazard"
    severity = "warning"
    skip_in_tests = True
    description = (
        "torch.compile constructed in a loop without a cache / of a fresh "
        "lambda / built-and-called inline, or torch._dynamo.reset() in "
        "package code"
    )
    doc_why = (
        "each of these compiles again per call: seconds of inductor work per "
        "step, and the 9th guard set of one code object raises under "
        "fullgraph"
    )

    def check(self, ctx: ModuleContext) -> Iterator:
        parents = _enclosing_map(ctx.tree)
        reported: set = set()

        def report(node, msg):
            if node.lineno not in reported:
                reported.add(node.lineno)
                yield ctx.finding(self, node, msg)

        def visit(node, loop, funcs):
            if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
                loop = node
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                funcs += 1
                loop = None
            if isinstance(node, ast.Call):
                name = dotted_name(node.func) or ""
                if name.endswith("_dynamo.reset"):
                    yield from report(
                        node,
                        "torch._dynamo.reset() in package code — drops every "
                        "compiled graph of the process; the next call of each "
                        "recompiles",
                    )
                if is_compile_wrapper(node.func):
                    if loop is not None and not _under_cache_guard(node, parents, loop):
                        yield from report(
                            node,
                            f"{name} constructed inside a loop with no cache "
                            "lookup — compiles every iteration; hoist it or "
                            "keep it in a dict behind 'if key not in cache'",
                        )
                    elif funcs and node.args and isinstance(node.args[0], ast.Lambda):
                        yield from report(
                            node,
                            "torch.compile of a lambda inside a function — a "
                            "fresh code object per call means a fresh compile "
                            "per call; def it at module scope",
                        )
                if funcs and isinstance(node.func, ast.Call) and is_compile_wrapper(
                    node.func.func
                ):
                    yield from report(
                        node,
                        "torch.compile built and invoked in one expression "
                        "inside a function — the compiled callable is "
                        "discarded; cache it",
                    )
            for child in ast.iter_child_nodes(node):
                yield from visit(child, loop, funcs)

        yield from visit(ctx.tree, None, 0)


# ------------------------------------------------- 3 custom-op-fake-mismatch


@register
class CustomOpFakeMismatchRule(Rule):
    """A ``torch.library.custom_op`` without a fake, or a fake whose
    parameters differ from the op's.

    The compiler runs an op's fake implementation to learn its outputs'
    shapes and dtypes: an op without one cannot be traced (dynamo breaks
    the graph, or raises under ``fullgraph``), and a fake whose parameter
    list drifted from the op's binds arguments to the wrong names and
    reports wrong output metadata.
    """

    id = "custom-op-fake-mismatch"
    severity = "error"
    description = (
        "torch.library.custom_op with no register_fake, or a fake whose "
        "parameters differ from the op's"
    )
    doc_why = (
        "without a fake the compiled step cannot trace the op (graph break, "
        "an error under fullgraph); a drifted fake binds arguments to the "
        "wrong names"
    )

    def check(self, ctx: ModuleContext) -> Iterator:
        ops = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if _tail(dotted_name(target)) == "custom_op":
                        ops[node.name] = node
        if not ops:
            return
        fakes: dict = {}  # op name -> [fake def]
        defs = {n.name: n for n in ast.walk(ctx.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    func = dec.func if isinstance(dec, ast.Call) else dec
                    if is_fake_registration(func):
                        op = fake_target(dec, ops)
                        if op is not None:
                            fakes.setdefault(op.name, []).append(node)
            elif isinstance(node, ast.Call) and is_fake_registration(node.func) and node.args:
                op = fake_target(node, ops)
                fn = node.args[-1]
                if op is not None and isinstance(fn, ast.Name) and fn.id in defs:
                    fakes.setdefault(op.name, []).append(defs[fn.id])
        for name, op in ops.items():
            if name not in fakes:
                yield ctx.finding(
                    self, op,
                    f"custom op {name}() has no register_fake — torch.compile "
                    "cannot trace it; register a fake that returns empty "
                    "outputs of the right shape and dtype",
                )
                continue
            want = param_names(op)
            for fake in fakes[name]:
                got = param_names(fake)
                if got != want:
                    yield ctx.finding(
                        self, fake,
                        f"fake of {name}() takes ({', '.join(got)}) but the op "
                        f"takes ({', '.join(want)}) — arguments bind to the "
                        "wrong names under the compiler",
                    )


# ---------------------------------------------------- 4 implicit-global-rng

_RANDOM_FUNCS = {
    "rand", "randn", "randint", "rand_like", "randn_like", "randint_like",
    "randperm", "bernoulli", "multinomial", "normal", "poisson",
}
_RANDOM_METHODS = {
    "normal_", "uniform_", "bernoulli_", "random_", "exponential_",
    "cauchy_", "log_normal_", "geometric_",
}
# nn.init's in-place samplers (they take generator= too)
_INIT_FUNCS = {
    "normal_", "uniform_", "trunc_normal_", "kaiming_normal_",
    "kaiming_uniform_", "xavier_normal_", "xavier_uniform_", "orthogonal_",
    "sparse_",
}


def random_draw(node: ast.Call) -> Optional[str]:
    """The name of a random draw (a torch sampler, an in-place sampler
    method, an nn.init sampler), else None."""
    name = dotted_name(node.func) or ""
    parts = name.split(".")
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in _RANDOM_FUNCS:
        return name
    if "init" in parts[:-1] and parts[-1] in _INIT_FUNCS:
        return name
    if isinstance(node.func, ast.Attribute) and node.func.attr in _RANDOM_METHODS and (
        "init" not in parts[:-1]
    ):
        return f".{node.func.attr}()"
    return None


@register
class ImplicitGlobalRngRule(Rule):
    """A random draw from the process-global generator, or a generator
    re-seeded to a constant inside a loop.

    A draw without ``generator=`` reads torch's global stream: its values
    depend on every other draw anywhere in the process (a data loader, a
    test, an earlier level), so a run stops being reproducible from its
    seed, and two subsystems silently share one stream. A generator
    re-seeded to the same constant on every iteration draws the same
    numbers every iteration. Tests are exempt.
    """

    id = "implicit-global-rng"
    severity = "error"
    skip_in_tests = True
    description = (
        "torch.rand*/randperm/bernoulli/multinomial/normal_/uniform_/"
        "nn.init sampler without generator=, or a generator re-seeded to a "
        "constant inside a loop"
    )
    doc_why = (
        "draws from the global stream depend on every other draw in the "
        "process: runs stop reproducing from their seed, and subsystems "
        "share randomness"
    )

    def check(self, ctx: ModuleContext) -> Iterator:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = random_draw(node)
                if name and not any(kw.arg == "generator" for kw in node.keywords):
                    yield ctx.finding(
                        self, node,
                        f"{name} draws from torch's global generator — pass "
                        "generator= (a torch.Generator seeded from the run's "
                        "seed) so the draw is reproducible and owned",
                    )

        def visit(node, in_loop):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                in_loop = False
            if (
                in_loop
                and isinstance(node, ast.Call)
                and _tail(dotted_name(node.func)) == "manual_seed"
                and node.args
                and isinstance(node.args[0], ast.Constant)
            ):
                yield ctx.finding(
                    self, node,
                    f"manual_seed({node.args[0].value!r}) inside a loop — every "
                    "iteration draws the same numbers; seed from the "
                    "iteration (or seed once outside)",
                )
            for child in ast.iter_child_nodes(node):
                body_of_loop = isinstance(node, (ast.For, ast.While, ast.AsyncFor)) and (
                    child in node.body or child in node.orelse)
                yield from visit(child, in_loop or body_of_loop)

        yield from visit(ctx.tree, False)


# --------------------------------------------------------- 5 collective-order

# torch.distributed collectives (and point-to-point ops a peer waits on).
# Generic words count only under dist / torch.distributed.
_DIST_GENERIC = {"broadcast", "reduce", "gather", "scatter", "barrier", "send", "recv",
                 "isend", "irecv"}
_DIST_SPECIFIC = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "broadcast_object_list",
    "monitored_barrier", "all_to_all", "all_to_all_single", "gather_object",
    "scatter_object_list", "batch_isend_irecv",
}
# The port's collective-bearing wrappers (parallel/).
_PORT_COLLECTIVES = {
    "average_gradients", "all_reduce_sums", "broadcast_module", "broadcast_object",
    "check_state_equality", "assert_width_agreement", "sync_hosts", "ring_shift",
}
COLLECTIVE_TAILS = _DIST_SPECIFIC | _PORT_COLLECTIVES


def is_collective_call(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    if not name:
        return False
    tail = _tail(name)
    if tail in COLLECTIVE_TAILS:
        return True
    return tail in _DIST_GENERIC and (
        _root(name) == "dist" or name.startswith("torch.distributed.")
    )


# Rank-dependent truth sources: a branch on these is taken by SOME ranks.
_RANK_SOURCES = {"process_index", "is_primary", "get_rank", "rank", "local_rank",
                 "data_rank", "global_rank"}


def rank_conditional_test(node: ast.If) -> bool:
    """True when an ``if`` branches on process identity (not on uniform
    world-size guards)."""
    names = {_tail(dotted_name(n)) for n in ast.walk(node.test) if dotted_name(n)}
    return bool(names & _RANK_SOURCES)


@register
class CollectiveOrderRule(Rule):
    """Collectives under rank-conditional control flow.

    Every rank of a process group must post the same collectives in the
    same order: an ``all_reduce`` or ``broadcast_object`` under ``if
    is_primary():`` (or ``rank == 0``) runs on one rank only, and the rest
    wait in their next collective until NCCL's timeout kills the job.
    Guards on the world size are uniform and not flagged.
    """

    id = "collective-order"
    severity = "error"
    description = (
        "torch.distributed collective (or a parallel/ wrapper that issues "
        "one) inside an is_primary()/process_index()/rank-conditional "
        "branch — not every rank reaches it"
    )
    doc_why = (
        "ranks that skip the branch never post the collective: the world "
        "hangs until the NCCL timeout, with no traceback of the cause"
    )

    def check(self, ctx: ModuleContext) -> Iterator:
        seen: set = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.If) or not rank_conditional_test(node):
                continue
            for branch in (node.body, node.orelse):
                for stmt in branch:
                    for sub in ast.walk(stmt):
                        if (
                            isinstance(sub, ast.Call)
                            and is_collective_call(sub)
                            and (sub.lineno, sub.col_offset) not in seen
                        ):
                            seen.add((sub.lineno, sub.col_offset))
                            yield ctx.finding(
                                self, sub,
                                f"{dotted_name(sub.func)} under a rank-"
                                "conditional branch — ranks that skip it never "
                                "post the collective and the world hangs; run "
                                "it on every rank and use the result on one",
                            )


# -------------------------------------------------- 6 cudagraph-output-reuse


def _is_cudagraph_compile(call: ast.AST) -> bool:
    return (
        isinstance(call, ast.Call)
        and is_compile_wrapper(call.func)
        and compile_mode(call) in ("reduce-overhead", "max-autotune")
    )


@register
class CudagraphOutputReuseRule(Rule):
    """An output of a CUDA-graph replay held across the next replay.

    A ``torch.compile(mode="reduce-overhead")`` callable runs its graph
    under CUDA graphs: its outputs live in the graph's static memory, which
    the next call overwrites. A ``torch.cuda.CUDAGraph``'s captured outputs
    are likewise rewritten by every ``replay()``. A name bound to such an
    output and read after the next call silently holds the next call's
    numbers; ``.clone()`` it (or copy it out) first.
    """

    id = "cudagraph-output-reuse"
    severity = "error"
    description = (
        "output of a reduce-overhead compiled call or a CUDA-graph replay "
        "read after the next call/replay without .clone()"
    )
    doc_why = (
        "the next replay overwrites the graph's static output memory: the "
        "held tensor silently shows the next step's values"
    )

    def check(self, ctx: ModuleContext) -> Iterator:
        for scope, body, _params in _function_scopes(ctx.tree):
            yield from self._check_scope(ctx, body, scope)

    def check_project(self, ctx: ModuleContext, view) -> Iterator:
        for scope, body, _params in _function_scopes(ctx.tree):
            yield from self._check_scope(ctx, body, scope, view)

    def _check_scope(self, ctx, body, scope=None, view=None) -> Iterator:
        graphed: dict = {}  # callable name -> witness
        graphs: dict = {}  # CUDAGraph name -> static output names
        live: dict = {}  # alias -> (source callable/graph, line)
        stale: dict = {}  # alias -> (source, line of the overwriting call)
        findings: dict = {}

        def flag(expr):
            for n in ast.walk(expr):
                name = dotted_name(n)
                if (
                    name in stale
                    and isinstance(n, (ast.Name, ast.Attribute))
                    and isinstance(getattr(n, "ctx", None), ast.Load)
                ):
                    key = (n.lineno, name)
                    if key not in findings:
                        src, line = stale[name]
                        findings[key] = ctx.finding(
                            self, n,
                            f"{name!r} holds an output of {src} that the call "
                            f"at line {line} overwrote — clone() it before "
                            "the next call, or read it first",
                        )

        def overwrite(src, line):
            for alias, (s, _l) in list(live.items()):
                if s == src:
                    stale[alias] = (src, line)
                    del live[alias]

        def calls_in(expr):
            for sub in ast.walk(expr):
                if not isinstance(sub, ast.Call):
                    continue
                fname = dotted_name(sub.func)
                if fname in graphed:
                    overwrite(fname, sub.lineno)
                elif (
                    isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "replay"
                    and dotted_name(sub.func.value) in graphs
                ):
                    overwrite(dotted_name(sub.func.value), sub.lineno)

        def source_of(value):
            """The graphed callable or graph whose output ``value`` is."""
            if isinstance(value, ast.Call) and dotted_name(value.func) in graphed:
                return dotted_name(value.func)
            if isinstance(value, ast.Subscript):
                return source_of(value.value)
            name = dotted_name(value)
            if name in live:
                return live[name][0]
            for g, outs in graphs.items():
                if name in outs:
                    return g
            return None

        def bind(targets, value):
            src = source_of(value) if value is not None else None
            for t in targets:
                for name in _target_names(t):
                    stale.pop(name, None)
                    live.pop(name, None)
                    if src is not None:
                        live[name] = (src, getattr(value, "lineno", 0))

        def visit(stmts):
            for stmt in stmts:
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    value = stmt.value
                    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                    if value is None:
                        continue
                    spec = None
                    if _is_cudagraph_compile(value):
                        spec = f"torch.compile(mode={compile_mode(value)!r})"
                    elif view is not None and isinstance(value, ast.Call):
                        spec = view.cudagraph_factory(value, scope)
                    if spec is not None:
                        for t in targets:
                            name = dotted_name(t)
                            if name:
                                graphed[name] = spec
                        continue
                    if (
                        isinstance(value, ast.Call)
                        and _tail(dotted_name(value.func)) == "CUDAGraph"
                    ):
                        for t in targets:
                            name = dotted_name(t)
                            if name:
                                graphs[name] = set()
                        continue
                    flag(value)
                    calls_in(value)
                    bind(targets, value)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    captured = [
                        dotted_name(item.context_expr.args[0])
                        for item in stmt.items
                        if isinstance(item.context_expr, ast.Call)
                        and (dotted_name(item.context_expr.func) or "").endswith("cuda.graph")
                        and item.context_expr.args
                    ]
                    for item in stmt.items:
                        flag(item.context_expr)
                    if captured and captured[0] in graphs:
                        for node in _walk_no_nested_defs(stmt.body):
                            if isinstance(node, ast.Assign):
                                for t in node.targets:
                                    graphs[captured[0]].update(_target_names(t))
                        continue
                    visit(_own_statements(stmt.body))
                elif isinstance(stmt, ast.If):
                    flag(stmt.test)
                    calls_in(stmt.test)
                    visit(_own_statements(stmt.body))
                    visit(_own_statements(stmt.orelse))
                elif isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
                    head = stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor)) else stmt.test
                    flag(head)
                    calls_in(head)
                    loop_body = _own_statements(stmt.body)
                    visit(loop_body)
                    visit(loop_body)  # a value held into the next iteration
                    visit(_own_statements(stmt.orelse))
                elif isinstance(stmt, ast.Try):
                    visit(_own_statements(stmt.body))
                    for h in stmt.handlers:
                        visit(_own_statements(h.body))
                    visit(_own_statements(stmt.orelse))
                    visit(_own_statements(stmt.finalbody))
                elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                else:
                    flag(stmt)
                    calls_in(stmt)

        visit(body)
        yield from findings.values()


# ------------------------------------------------------------ 7 broad-except


@register
class BroadExceptRule(Rule):
    """``except:``/``except Exception:`` that swallows silently.

    A config knob that silently did nothing is the fault class the port
    has hit before; broad handlers are how such bugs hide — an OOM, a shape
    error, a corrupt checkpoint all collapse into "the fallback path ran".
    A broad catch is acceptable only when it RECORDS what it ate
    (log/print/traceback) or re-raises; degrade-don't-die paths that report
    through other channels (serve/batcher.py's futures) carry an inline
    waiver whose reason names the channel.
    """

    id = "broad-except"
    severity = "warning"
    description = (
        "bare/Exception-wide except that neither logs, re-raises, nor "
        "records the suppressed error"
    )
    doc_why = (
        'silent degradation is how "the config knob did nothing" bugs '
        "survive review"
    )

    _BROAD = {"Exception", "BaseException"}
    _EVIDENCE_CALLS = {
        "print",
        "warn",
        "warning",
        "error",
        "exception",
        "critical",
        "info",
        "debug",
        "log",
        "format_exc",
        "print_exc",
        "fail",
    }
    _EVIDENCE_ROOTS = {"logging", "logger", "warnings", "traceback", "log"}

    def _is_broad(self, handler: ast.ExceptHandler) -> Optional[str]:
        t = handler.type
        if t is None:
            return "bare except"
        names = (
            [dotted_name(e) for e in t.elts]
            if isinstance(t, ast.Tuple)
            else [dotted_name(t)]
        )
        for name in names:
            if name and _tail(name) in self._BROAD:
                return f"except {_tail(name)}"
        return None

    def _has_evidence(self, handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if (
                    _tail(name) in self._EVIDENCE_CALLS
                    or _root(name) in self._EVIDENCE_ROOTS
                ):
                    return True
        return False

    def check(self, ctx: ModuleContext) -> Iterator:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = self._is_broad(node)
            if broad and not self._has_evidence(node):
                yield ctx.finding(
                    self,
                    node,
                    f"{broad} swallows the error without logging or "
                    "re-raising — narrow the type, or record what was "
                    "suppressed so real failures stay visible",
                )


# ------------------------------------------------ 8 debug-in-compiled-region

_LOG_ROOTS = {"logging", "logger", "log", "_log", "_logger", "LOG", "LOGGER"}
_LOG_TAILS = {"debug", "info", "warning", "warn", "error", "exception", "critical", "log"}


@register
class DebugInCompiledRegionRule(Rule):
    """Debug output inside a traced region.

    A ``print``, ``breakpoint()``, ``pdb.set_trace()`` or logging call
    inside a ``torch.compile``'d body is a graph break — an error under
    ``fullgraph=True``, a split graph (and a host round trip) otherwise;
    inside a CUDA-graph capture or a fake it runs once at capture or
    tracing time and never again. (A declared hot loop is not traced, so
    this rule leaves its logging alone.)
    """

    id = "debug-in-compiled-region"
    severity = "warning"
    description = (
        "print/breakpoint/pdb/logging inside a torch.compile'd function, a "
        "CUDA-graph capture or a custom op's fake"
    )
    doc_why = (
        "a graph break (an error under fullgraph=True); in a capture or a "
        "fake it prints once, at capture time, and never again"
    )

    def check(self, ctx: ModuleContext) -> Iterator:
        for region in ctx.compiled_regions:
            if region.kind == "hot-loop":
                continue
            for node in region.walk():
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func) or ""
                msg = None
                if name in ("print", "breakpoint"):
                    msg = f"{name}() inside {region.reason}"
                elif _tail(name) in ("set_trace", "breakpoint") and _root(name) in ("pdb", "ipdb"):
                    msg = f"{name}() inside {region.reason}"
                elif _root(name) in _LOG_ROOTS and _tail(name) in _LOG_TAILS and "." in name:
                    msg = f"{name}() inside {region.reason}"
                if msg:
                    yield ctx.finding(
                        self, node,
                        msg + " — a graph break (an error under fullgraph); "
                        "remove it or move it outside the region",
                    )


# ------------------------------------------ 9 unhashable-width-overrides

_OVERRIDE_TAILS = ("width_overrides", "nm_overrides")


def _is_dict_expr(node: ast.AST) -> bool:
    return isinstance(node, (ast.Dict, ast.DictComp)) or (
        isinstance(node, ast.Call) and dotted_name(node.func) == "dict"
    )


@register
class UnhashableWidthOverridesRule(Rule):
    """A raw ``width_overrides`` / ``nm_overrides`` dict used as a cache key.

    The port caches per-plan models and compiled steps on the plan's
    override signature (``pruning_harness._plan_eval_cache`` and
    ``_plan_step_cache``, keyed by ``as_override_tuple()`` /
    ``width_key()`` / ``nm_key()``). Keying on the dict itself raises
    ``TypeError: unhashable type: 'dict'`` at the lookup, far from where the
    dict was built, and a key built from ``str(dict)`` depends on insertion
    order. Normalize with ``tuple(sorted(d.items()))`` (what
    ``as_override_tuple`` does). Tests are exempt.
    """

    id = "unhashable-width-overrides"
    severity = "warning"
    skip_in_tests = True
    description = (
        "width_overrides/nm_overrides dict used as (part of) a cache key — "
        "unhashable; normalize with tuple(sorted(d.items())) / "
        "as_override_tuple()"
    )
    doc_why = (
        "a dict key raises TypeError: unhashable at the cache lookup, far "
        "from the plan that built it"
    )

    _KEY_METHODS = {"get", "setdefault", "pop", "__contains__"}

    def check(self, ctx: ModuleContext) -> Iterator:
        for _scope, body, _params in _function_scopes(ctx.tree):
            dict_names: dict = {}  # name -> line of a dict-valued binding
            keys: list = []  # (node, key expr)
            for node in _walk_no_nested_defs(body):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        for name in _target_names(t):
                            dict_names.setdefault(name, []).append(
                                (node.lineno, _is_dict_expr(node.value)
                                 or _tail(dotted_name(node.value)) in _OVERRIDE_TAILS))
                elif isinstance(node, ast.Subscript) and not isinstance(node.slice, ast.Slice):
                    keys.append((node, node.slice))
                elif isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
                ):
                    keys.append((node, node.left))
                elif (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._KEY_METHODS
                    and node.args
                ):
                    keys.append((node, node.args[0]))
            for node, key in keys:
                parts = key.elts if isinstance(key, ast.Tuple) else [key]
                for part in parts:
                    verdict = None
                    name = dotted_name(part)
                    if _is_dict_expr(part):
                        verdict = "a dict literal"
                    elif name and _tail(name) in _OVERRIDE_TAILS:
                        verdict = f"{name!r} (a dict)"
                    elif name in dict_names:
                        prior = [b for b in dict_names[name] if b[0] <= node.lineno]
                        if prior and max(prior)[1]:
                            verdict = f"{name!r}, last assigned a dict"
                    if verdict:
                        yield ctx.finding(
                            self, node,
                            f"cache key holds {verdict} — dicts are unhashable "
                            "(TypeError at the lookup); key on "
                            "tuple(sorted(d.items())) / as_override_tuple()",
                        )
                        break
