"""Lockset abstract interpretation over ``with lock:`` / acquire-release
regions, plus the interprocedural lock-acquisition-order graph.

This is the concurrency half of what regions.py does for compiled regions: a
lexically-decidable approximation of a dynamic property. A lock is "known"
when its identity is decidable the same way project.py decides call
targets — a ``self._lock`` attribute assigned ``threading.Lock()`` (or
RLock/Condition) in a method of the class, a module-level global, or a
function local (including enclosing-function locals, for closure workers).
``with self._lock:`` pushes it for the body; a statement-level
``lock.acquire()`` / ``lock.release()`` pair tracks linearly within one
statement list. Everything else (locks passed as parameters, locks fetched
from containers, ``with self._factory(key):``) is NOT tracked, and the
rules built on top stay silent there — same zero-false-positive contract
as the rest of torchlint.

Two other products live here because they need the same declared-type
scan:

* ``# guarded-by: <lock>`` comments on ``self.X = ...`` assignments — the
  machine-checked documentation of which lock protects which shared field
  (consumed by the unsynchronized-shared-mutation rule, rendered in
  README's catalog);
* per-function summaries (attribute accesses with the lockset held at the
  access, call sites with the lockset held at the call, acquisitions with
  the locks already held) that concurrency_rules.py and threads.py turn
  into findings.

Approximations, by design (documented here once, relied on by the rule
fixtures):

* container METHOD calls (``self._ring.append(x)``) count as reads of the
  binding, not writes — CPython makes single deque/dict ops atomic, and
  flagging every queue/deque use would bury the real signal. Rebinds
  (``self.x = v``) and subscript stores (``self.d[k] = v``, including
  ``+=``) are writes.
* an acquire inside a branch does not extend the lockset past the branch
  (under-approximation of "held": no false "is guarded" claims leak out of
  an If arm, at the cost of missing branch-balanced hand-rolled locking).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Iterator, Optional

from .project import FunctionInfo, ProjectIndex
from .regions import dotted_name
from .rules import _own_statements, _root, _tail

__all__ = [
    "AttrAccess",
    "Acquisition",
    "CallSite",
    "CheckThenAct",
    "DeclaredTypes",
    "FuncLockInfo",
    "LOCK_KINDS",
    "LockAnalysis",
    "OrderEdge",
    "build_order_graph",
    "collect_declared_types",
    "collect_guards",
    "ctor_kind",
    "find_cycles",
    "parse_guard_comments",
]

_MAX_DEPTH = 10

# Constructor tail -> declared kind. Bare tails are accepted (the repo
# imports ThreadPoolExecutor unqualified); dotted tails must hang off a
# stdlib concurrency root so ``mylib.Queue()`` stays untyped.
_CTOR_KINDS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "Semaphore": "lock",
    "BoundedSemaphore": "lock",
    "Event": "event",
    "Barrier": "event",
    "Queue": "queue",
    "LifoQueue": "queue",
    "PriorityQueue": "queue",
    "SimpleQueue": "queue",
    "Thread": "thread",
    "Timer": "thread",
    "ThreadPoolExecutor": "pool",
    "ProcessPoolExecutor": "pool",
}
_CTOR_ROOTS = {"threading", "queue", "multiprocessing", "concurrent", "futures"}

# Kinds that participate in locksets (an Event/Queue is synchronization,
# but holding one is not a critical section).
LOCK_KINDS = frozenset({"lock", "rlock", "condition"})


def ctor_kind(node: ast.AST) -> Optional[str]:
    """``threading.Lock()`` -> "lock"; None for non-sync constructors."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted_name(node.func)
    if not name:
        return None
    tail = _tail(name)
    if tail not in _CTOR_KINDS:
        return None
    if "." in name and _root(name) not in _CTOR_ROOTS:
        return None
    return _CTOR_KINDS[tail]


def _assign_targets(stmt: ast.AST) -> list:
    """(target_expr, value) pairs for Assign/AnnAssign statements."""
    if isinstance(stmt, ast.Assign):
        return [(t, stmt.value) for t in stmt.targets]
    if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        return [(stmt.target, stmt.value)]
    return []


@dataclasses.dataclass
class DeclaredTypes:
    """Where sync objects live: class attributes and module globals."""

    class_attrs: dict  # ("mod.Class", attr) -> kind
    module_names: dict  # (modname, name) -> kind

    def attr_kind(self, class_qual: str, attr: str) -> Optional[str]:
        return self.class_attrs.get((class_qual, attr))


def collect_declared_types(index: ProjectIndex) -> DeclaredTypes:
    class_attrs: dict = {}
    module_names: dict = {}
    for mi in index.modules.values():
        for stmt in mi.tree.body:
            for target, value in _assign_targets(stmt):
                kind = ctor_kind(value)
                if kind and isinstance(target, ast.Name):
                    module_names[(mi.modname, target.id)] = kind
    for fi in index.functions.values():
        if fi.class_name is None:
            continue
        cq = f"{fi.modname}.{fi.class_name}"
        for node in ast.walk(fi.node):
            for target, value in _assign_targets(node):
                kind = ctor_kind(value)
                if (
                    kind
                    and isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    class_attrs.setdefault((cq, target.attr), kind)
    return DeclaredTypes(class_attrs=class_attrs, module_names=module_names)


# --------------------------------------------------------------- guarded-by

_GUARD_RE = re.compile(r"guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")


def parse_guard_comments(source: str) -> dict:
    """line -> (lock attribute name, standalone) from ``# guarded-by: _lock``
    comments (tokenizer-based, same as waiver parsing: a ``#`` in a string
    is not a comment). ``standalone`` is True for comment-only lines — only
    those may annotate the assignment BELOW them; an inline guard on the
    previous attribute's assignment must not leak downward."""
    out: dict = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                m = _GUARD_RE.search(tok.string)
                if m:
                    standalone = tok.line.lstrip().startswith("#")
                    out[tok.start[0]] = (m.group(1), standalone)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return {}
    return out


def collect_guards(index: ProjectIndex, contexts: dict) -> dict:
    """("mod.Class", attr) -> guarding lock attribute name.

    A guard comment annotates the ``self.X = ...`` assignment that
    initializes the field: inline on any line of the assignment, or on a
    standalone comment line directly above it."""
    guards: dict = {}
    by_path: dict = {}
    for fi in index.functions.values():
        if fi.class_name is not None:
            by_path.setdefault(fi.path, []).append(fi)
    for path, fis in by_path.items():
        ctx = contexts.get(path)
        if ctx is None:
            continue
        comments = parse_guard_comments(ctx.source)
        if not comments:
            continue
        for fi in fis:
            cq = f"{fi.modname}.{fi.class_name}"
            for node in ast.walk(fi.node):
                for target, _value in _assign_targets(node):
                    if not (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                    ):
                        continue
                    span = range(
                        node.lineno - 1, (node.end_lineno or node.lineno) + 1
                    )
                    for line in span:
                        hit = comments.get(line)
                        if hit is None:
                            continue
                        lock, standalone = hit
                        if line < node.lineno and not standalone:
                            continue  # inline guard of the line above
                        guards[(cq, target.attr)] = lock
                        break
    return guards


# ------------------------------------------------------- per-function walk


@dataclasses.dataclass
class AttrAccess:
    """One ``self.X`` touch, with the lockset held at that point."""

    attr: str
    write: bool
    line: int
    held: frozenset  # lock ids


@dataclasses.dataclass
class Acquisition:
    lock: str  # lock id
    kind: str  # "lock" | "rlock" | "condition"
    line: int
    held_before: tuple  # lock ids already held when this one is taken


@dataclasses.dataclass
class CallSite:
    node: ast.Call
    line: int
    held: frozenset  # lock ids (may be empty)


@dataclasses.dataclass
class CheckThenAct:
    """``if k not in self.d: self.d[k] = ...`` with the lockset at the If."""

    attr: str
    line: int
    held: frozenset


@dataclasses.dataclass
class FuncLockInfo:
    accesses: list  # [AttrAccess]
    acquisitions: list  # [Acquisition]
    calls: list  # [CallSite]
    check_then_acts: list  # [CheckThenAct]
    local_types: dict  # local name -> kind (sync ctors assigned in-body)


_MUTATING_CTX = (ast.Store, ast.Del)


class LockAnalysis:
    """Memoized lockset walks + transitive-acquisition summaries."""

    def __init__(self, index: ProjectIndex, contexts: dict):
        self.index = index
        self.types = collect_declared_types(index)
        self.guards = collect_guards(index, contexts)
        self._info: dict = {}
        self._acq_memo: dict = {}

    # ------------------------------------------------------------ identity
    def lock_name(self, class_qual: str, attr: str) -> str:
        return f"{class_qual}.{attr}"

    def declared_kind(
        self, expr: ast.AST, fi: Optional[FunctionInfo]
    ) -> Optional[tuple]:
        """(lock_id, kind) for a decidable sync-object expression; None
        otherwise. Covers ``self.X``, module globals, function locals and
        enclosing-function locals (closures)."""
        name = dotted_name(expr)
        if not name:
            return None
        parts = name.split(".")
        if parts[0] == "self" and len(parts) == 2 and fi and fi.class_name:
            cq = f"{fi.modname}.{fi.class_name}"
            kind = self.types.attr_kind(cq, parts[1])
            if kind:
                return (f"{cq}.{parts[1]}", kind)
            return None
        if len(parts) == 1:
            s = fi
            while s is not None:
                kind = self.info(s).local_types.get(parts[0])
                if kind:
                    return (f"{s.qualname}.<local>.{parts[0]}", kind)
                s = (
                    self.index.functions.get(s.parent)
                    if s.parent
                    else None
                )
            if fi is not None:
                kind = self.types.module_names.get((fi.modname, parts[0]))
                if kind:
                    return (f"{fi.modname}.{parts[0]}", kind)
        return None

    def lock_id(
        self, expr: ast.AST, fi: Optional[FunctionInfo]
    ) -> Optional[tuple]:
        """declared_kind restricted to lockset-participating kinds."""
        hit = self.declared_kind(expr, fi)
        if hit and hit[1] in LOCK_KINDS:
            return hit
        return None

    # ------------------------------------------------------------- walking
    def info(self, fi: FunctionInfo) -> FuncLockInfo:
        cached = self._info.get(fi.qualname)
        if cached is not None:
            return cached
        info = FuncLockInfo([], [], [], [], {})
        self._info[fi.qualname] = info  # pre-seed: local lookup may re-enter
        for stmt in _own_statements(fi.node.body):
            for target, value in _assign_targets(stmt):
                kind = ctor_kind(value)
                if kind and isinstance(target, ast.Name):
                    info.local_types.setdefault(target.id, kind)
        self._walk_stmts(fi, info, _own_statements(fi.node.body), [])
        return info

    def _walk_stmts(self, fi, info, stmts, held) -> None:
        """``held`` is a list of (lock_id, kind); linear acquire/release at
        statement level mutates the local copy so later statements in the
        SAME list see it."""
        held = list(held)
        for stmt in stmts:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                pushed = []
                for item in stmt.items:
                    self._scan_expr(fi, info, item.context_expr, held)
                    lid = self.lock_id(item.context_expr, fi)
                    if lid:
                        info.acquisitions.append(
                            Acquisition(
                                lid[0],
                                lid[1],
                                stmt.lineno,
                                tuple(l for l, _ in held),
                            )
                        )
                        pushed.append(lid)
                self._walk_stmts(
                    fi, info, _own_statements(stmt.body), held + pushed
                )
                continue
            hit = self._acquire_release(stmt, fi)
            if hit is not None:
                lid, op = hit
                if op == "acquire":
                    info.acquisitions.append(
                        Acquisition(
                            lid[0],
                            lid[1],
                            stmt.lineno,
                            tuple(l for l, _ in held),
                        )
                    )
                    held.append(lid)
                else:
                    for i in range(len(held) - 1, -1, -1):
                        if held[i][0] == lid[0]:
                            del held[i]
                            break
                continue
            if isinstance(stmt, ast.If):
                cta = self._check_then_act(stmt)
                if cta is not None:
                    info.check_then_acts.append(
                        CheckThenAct(
                            cta,
                            stmt.lineno,
                            frozenset(l for l, _ in held),
                        )
                    )
            # compound statements: scan this level's expressions, recurse
            # into bodies with the current lockset
            compound = False
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub and isinstance(sub, list):
                    compound = True
                    self._walk_stmts(fi, info, _own_statements(sub), held)
            for h in getattr(stmt, "handlers", []) or []:
                compound = True
                self._walk_stmts(fi, info, _own_statements(h.body), held)
            if compound:
                for field in ("test", "iter", "subject"):
                    sub = getattr(stmt, field, None)
                    if sub is not None:
                        self._scan_expr(fi, info, sub, held)
            else:
                self._scan_expr(fi, info, stmt, held)

    def _acquire_release(self, stmt, fi) -> Optional[tuple]:
        """((lock_id, kind), "acquire"|"release") for a statement-level
        ``lock.acquire()`` / ``ok = lock.acquire(...)`` / ``lock.release()``."""
        value = None
        if isinstance(stmt, ast.Expr):
            value = stmt.value
        elif isinstance(stmt, ast.Assign):
            value = stmt.value
        if not (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)
            and value.func.attr in ("acquire", "release")
        ):
            return None
        lid = self.lock_id(value.func.value, fi)
        if lid is None:
            return None
        return lid, value.func.attr

    def _scan_expr(self, fi, info, node, held) -> None:
        """Record attribute accesses and call sites in one statement or
        expression, without descending into nested defs (own scopes)."""
        held_ids = frozenset(l for l, _ in held)
        subscript_writes: set = set()
        stack = [node]
        flat: list = []
        while stack:
            n = stack.pop()
            flat.append(n)
            for child in ast.iter_child_nodes(n):
                if isinstance(
                    child,
                    (
                        ast.FunctionDef,
                        ast.AsyncFunctionDef,
                        ast.ClassDef,
                        ast.Lambda,
                    ),
                ):
                    continue
                stack.append(child)
        for n in flat:
            if (
                isinstance(n, ast.Subscript)
                and isinstance(n.ctx, _MUTATING_CTX)
                and isinstance(n.value, ast.Attribute)
            ):
                subscript_writes.add(id(n.value))
        cq = (
            f"{fi.modname}.{fi.class_name}"
            if fi is not None and fi.class_name
            else None
        )
        for n in flat:
            if isinstance(n, ast.Call):
                info.calls.append(CallSite(n, n.lineno, held_ids))
            elif (
                isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name)
                and n.value.id == "self"
            ):
                write = isinstance(n.ctx, _MUTATING_CTX) or id(n) in (
                    subscript_writes
                )
                if not write and cq is not None:
                    # using (not rebinding) a declared sync object is not a
                    # shared-state access
                    if self.types.attr_kind(cq, n.attr):
                        continue
                info.accesses.append(
                    AttrAccess(n.attr, write, n.lineno, held_ids)
                )

    @staticmethod
    def _check_then_act(stmt: ast.If) -> Optional[str]:
        """The ``self.<attr>`` container of an
        ``if k not in self.d: self.d[k] = ...`` (or ``.get(k) is None``)
        pattern; None when the If is not that shape."""
        test = stmt.test
        container = None
        if (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], ast.NotIn)
        ):
            container = dotted_name(test.comparators[0])
        elif (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Is)
            and isinstance(test.left, ast.Call)
            and isinstance(test.left.func, ast.Attribute)
            and test.left.func.attr == "get"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
        ):
            container = dotted_name(test.left.func.value)
        if not container:
            return None
        parts = container.split(".")
        if len(parts) != 2 or parts[0] != "self":
            return None
        attr = parts[1]
        for sub in ast.walk(stmt):
            if (
                isinstance(sub, ast.Subscript)
                and isinstance(sub.ctx, ast.Store)
                and dotted_name(sub.value) == container
            ):
                return attr
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in ("add", "append", "setdefault", "update")
                and dotted_name(sub.func.value) == container
            ):
                return attr
        return None

    # ----------------------------------------------------------- summaries
    def transitive_acquires(
        self, fi: FunctionInfo, _depth: int = 0
    ) -> dict:
        """lock_id -> (kind, witness hops) for every tracked lock this
        function may take, directly or through resolved callees. Memoized;
        cycles short-circuit to the partial result."""
        memo = self._acq_memo.get(fi.qualname)
        if memo is not None:
            return memo
        out: dict = {}
        self._acq_memo[fi.qualname] = out  # cycle guard
        info = self.info(fi)
        for a in info.acquisitions:
            out.setdefault(
                a.lock,
                (
                    a.kind,
                    [f"{fi.name} acquires {a.lock} ({fi.path}:{a.line})"],
                ),
            )
        if _depth >= _MAX_DEPTH:
            return out
        mi = self.index.modules.get(fi.modname)
        if mi is None:
            return out
        for cs in info.calls:
            callee = self.index.resolve_call(mi, cs.node.func, fi)
            if callee is None or callee.qualname == fi.qualname:
                continue
            for lid, (kind, wit) in self.transitive_acquires(
                callee, _depth + 1
            ).items():
                out.setdefault(
                    lid,
                    (
                        kind,
                        [
                            f"{fi.name} -> {callee.name} "
                            f"({fi.path}:{cs.line})"
                        ]
                        + wit,
                    ),
                )
        return out


# ------------------------------------------------------------- order graph


@dataclasses.dataclass
class OrderEdge:
    """src held while dst is acquired, with the first witness site."""

    src: str
    dst: str
    file: str
    line: int
    witness: list  # human-readable hops


def build_order_graph(analysis: LockAnalysis) -> dict:
    """(src, dst) -> OrderEdge over the whole project. A self-edge
    (L, L) means a non-reentrant lock is re-acquired while held — an
    immediate deadlock, reported by the same cycle rule. Reentrant locks
    (RLock, and Conditions built on them) do not self-edge."""
    edges: dict = {}

    def add(src, dst, file, line, witness):
        edges.setdefault(
            (src, dst), OrderEdge(src, dst, file, line, witness)
        )

    for qual in sorted(analysis.index.functions):
        fi = analysis.index.functions[qual]
        info = analysis.info(fi)
        for a in info.acquisitions:
            for h in a.held_before:
                if h != a.lock:
                    add(
                        h,
                        a.lock,
                        fi.path,
                        a.line,
                        [
                            f"{fi.name} holds {h} and acquires "
                            f"{a.lock} ({fi.path}:{a.line})"
                        ],
                    )
                elif a.kind == "lock":
                    add(
                        h,
                        a.lock,
                        fi.path,
                        a.line,
                        [
                            f"{fi.name} re-acquires non-reentrant "
                            f"{a.lock} while holding it "
                            f"({fi.path}:{a.line})"
                        ],
                    )
        mi = analysis.index.modules.get(fi.modname)
        if mi is None:
            continue
        for cs in info.calls:
            if not cs.held:
                continue
            callee = analysis.index.resolve_call(mi, cs.node.func, fi)
            if callee is None or callee.qualname == fi.qualname:
                continue
            for lid, (kind, wit) in analysis.transitive_acquires(
                callee
            ).items():
                for h in sorted(cs.held):
                    hop = (
                        f"{fi.name} holds {h} and calls {callee.name} "
                        f"({fi.path}:{cs.line})"
                    )
                    if h != lid:
                        add(h, lid, fi.path, cs.line, [hop] + wit)
                    elif kind == "lock":
                        add(h, lid, fi.path, cs.line, [hop] + wit)
    return edges


def find_cycles(edges: dict) -> list:
    """Deterministic list of cycles in the acquisition-order graph, each a
    list of lock ids (``[a, b]`` = a->b->a; ``[a]`` = self-deadlock).
    One representative cycle per strongly-connected component."""
    adj: dict = {}
    for src, dst in edges:
        adj.setdefault(src, []).append(dst)
        adj.setdefault(dst, [])
    for dsts in adj.values():
        dsts.sort()

    # Tarjan's SCC, iterative, deterministic over sorted nodes.
    index_of: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    sccs: list = []
    counter = [0]

    def strongconnect(root):
        work = [(root, iter(adj[root]))]
        index_of[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index_of:
                    index_of[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(adj[nxt])))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index_of[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index_of[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(sorted(comp))

    for node in sorted(adj):
        if node not in index_of:
            strongconnect(node)

    cycles: list = []
    for comp in sccs:
        if len(comp) > 1:
            cycles.append(comp)
        elif (comp[0], comp[0]) in edges:
            cycles.append(comp)
    cycles.sort()
    return cycles


def cycle_witness(cycle: list, edges: dict) -> Iterator:
    """The OrderEdges backing one cycle, in a stable order."""
    nodes = set(cycle)
    for key in sorted(edges):
        if key[0] in nodes and key[1] in nodes:
            yield edges[key]
