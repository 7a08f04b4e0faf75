"""Concurrency rules: the thread model (threads.py) and lockset
interpretation (locks.py) turned into findings.

Five rules. Four are ``project_only`` — they need the symbol table, the
spawn-site closure, and the interprocedural acquisition graph, so they
fire exclusively from ``check_project`` (per-file mode skips them, and
per-file stale-waiver accounting treats their waivers as out of scope,
exactly like the conf rules). ``cv-wait-no-predicate-loop`` is lexical
and runs per-file like any other rule.

* ``unsynchronized-shared-mutation`` — a ``self.X`` written outside
  ``__init__`` in a thread-spawning class, where a write and another
  access can run on different threads with no common lock. When the field
  carries a ``# guarded-by: <lock>`` annotation the rule switches from
  heuristic to contract checking: EVERY access outside ``__init__`` must
  hold the named lock, thread model or not.
* ``lock-order-inversion`` — a cycle in the interprocedural
  lock-acquisition-order graph, including the degenerate self-cycle (a
  non-reentrant lock re-acquired while held: guaranteed deadlock).
* ``blocking-call-under-lock`` — device_put / AOT lower+compile /
  ``torch.compile`` / a device ``synchronize()`` /
  ``queue.get`` / ``time.sleep`` / socket I/O / ``Future.result`` /
  thread+pool joins while holding a tracked lock, directly or through a
  resolved callee (with the witness chain in the trace). ``Condition
  .wait()`` under its OWN condition is exempt — wait releases that lock.
* ``check-then-act-race`` — ``if k not in self.d: self.d[k] = ...`` with
  an empty lockset, in classes that spawn threads (or functions inside a
  worker closure).
* ``cv-wait-no-predicate-loop`` — ``Condition.wait()`` whose innermost
  enclosing loop is not a ``while`` (spurious wakeups and stolen
  notifications; a ``for`` does not re-test the predicate).

The ``unsynchronized-shared-mutation`` message format is a stable
contract: the runtime sanitizer (sanitizer.py) parses it back into a
``(class, attribute)`` key via :func:`shared_mutation_key` to diff
runtime-observed races against the static findings.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from .core import RULES, Finding, ModuleContext, Rule, register
from .locks import (
    LockAnalysis,
    _assign_targets,
    build_order_graph,
    ctor_kind,
    cycle_witness,
    find_cycles,
)
from .regions import dotted_name
from .rules import _root, _tail
from .threads import CALLER, ThreadModel

__all__ = [
    "concurrency_findings",
    "shared_mutation_key",
    "static_race_keys",
]

_MAX_DEPTH = 10

_SOCKET_TAILS = {"recv", "recv_into", "accept", "connect", "sendall"}


# ------------------------------------------------------------ registration


class _ProjectConcurrencyRule(Rule):
    """Needs the thread model + lockset layer: project mode only."""

    project_only = True
    skip_in_tests = True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        return iter(())


@register
class UnsynchronizedSharedMutationRule(_ProjectConcurrencyRule):
    id = "unsynchronized-shared-mutation"
    severity = "error"
    description = (
        "self.* attribute written on one thread and accessed on another "
        "with no common lock (or in violation of its # guarded-by: "
        "annotation)"
    )
    doc_why = (
        "torn and stale reads on the serving hot path — races that only "
        "reproduce under production load, never in single-threaded tests"
    )


@register
class LockOrderInversionRule(_ProjectConcurrencyRule):
    id = "lock-order-inversion"
    severity = "error"
    description = (
        "cycle in the interprocedural lock-acquisition-order graph "
        "(opposite-order deadlock, or a non-reentrant self-acquire)"
    )
    doc_why = (
        "two threads acquiring in opposite orders deadlock with no "
        "traceback — requests hang until the process is killed"
    )


@register
class BlockingCallUnderLockRule(_ProjectConcurrencyRule):
    id = "blocking-call-under-lock"
    severity = "warning"
    description = (
        "sleep/queue/socket/Future/AOT-compile blocking operation while "
        "holding a lock, directly or through a resolved callee"
    )
    doc_why = (
        "seconds of blocking work under a lock head-of-line-blocks every "
        "thread behind it — one cold-bucket compile can stall the whole "
        "serving fleet"
    )


@register
class CheckThenActRaceRule(_ProjectConcurrencyRule):
    id = "check-then-act-race"
    severity = "warning"
    description = (
        "unguarded 'if k not in self.d: self.d[k] = ...' in thread-aware "
        "code (both threads see 'missing', both insert)"
    )
    doc_why = (
        "both threads see the missing state and both act — double "
        "compiles, double closes, lost idempotence (the PrefetchEngine "
        "close() bug class)"
    )


@register
class CvWaitNoPredicateLoopRule(Rule):
    id = "cv-wait-no-predicate-loop"
    severity = "error"
    skip_in_tests = True
    description = (
        "Condition.wait() whose innermost enclosing loop is not a while "
        "(spurious wakeup / stolen notification loses the signal)"
    )
    doc_why = (
        "spurious wakeups and stolen signals are legal; an if-guarded "
        "wait proceeds on a false predicate — the classic lost-wakeup "
        "hang"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        cond_names: set = set()
        for node in ast.walk(ctx.tree):
            for target, value in _assign_targets(node):
                if ctor_kind(value) == "condition":
                    name = dotted_name(target)
                    if name:
                        cond_names.add(name)
        if not cond_names:
            return
        hits: list = []
        self._scan(ctx.tree, None, cond_names, hits)
        for node, recv in hits:
            yield ctx.finding(
                self,
                node,
                f"{recv}.wait() is not re-checked in a while loop — "
                "condition waits wake spuriously and notifications can be "
                f"consumed by another waiter; use 'while not <predicate>: "
                f"{recv}.wait()'",
            )

    def _scan(self, node, loop, cond_names, hits) -> None:
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "wait"
        ):
            recv = dotted_name(node.func.value)
            if recv in cond_names and loop != "while":
                hits.append((node, recv))
        if isinstance(node, (ast.While, ast.For, ast.AsyncFor)):
            kind = "while" if isinstance(node, ast.While) else "for"
            body = set(map(id, node.body))
            for child in ast.iter_child_nodes(node):
                self._scan(
                    child,
                    kind if id(child) in body else loop,
                    cond_names,
                    hits,
                )
            return
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            for child in ast.iter_child_nodes(node):
                self._scan(child, None, cond_names, hits)
            return
        for child in ast.iter_child_nodes(node):
            self._scan(child, loop, cond_names, hits)


# ------------------------------------------------------- sanitizer contract

_MUTATION_KEY_RE = re.compile(r"^self\.(\w+) of (\w+) ")


def shared_mutation_key(message: str) -> Optional[tuple]:
    """(class_name, attr) from an unsynchronized-shared-mutation message;
    the sanitizer uses this to match runtime-observed races to static
    findings (waived or not — a waiver is still an explanation)."""
    m = _MUTATION_KEY_RE.match(message)
    return (m.group(2), m.group(1)) if m else None


def static_race_keys(findings) -> set:
    """All (class_name, attr) keys claimed by static mutation findings."""
    out: set = set()
    for f in findings:
        if f.rule == UnsynchronizedSharedMutationRule.id:
            key = shared_mutation_key(f.message)
            if key:
                out.add(key)
    return out


# --------------------------------------------------------------- the checker


def _short_lock(lock_id: str) -> str:
    parts = lock_id.replace(".<local>", "").split(".")
    return ".".join(parts[-2:]) if len(parts) > 1 else lock_id


def _mk(rule_id: str, file: str, line: int, message: str, trace) -> Finding:
    rule = RULES[rule_id]
    return Finding(
        file=file,
        line=line,
        col=0,
        rule=rule_id,
        severity=rule.severity,
        message=message,
        trace=list(trace) or None,
    )


def _classify_blocking(call: ast.Call, fi, analysis) -> Optional[tuple]:
    """(label, own_condition_lock_id_or_None) for a directly-blocking
    call; None otherwise. The second slot is set only for
    ``Condition.wait()`` so the caller can exempt the condition's own
    lock (wait releases it while blocked)."""
    f = call.func
    name = dotted_name(f)
    tail = _tail(name)
    root = _root(name)
    if name:
        if tail == "sleep" and root in ("time", "sleep"):
            return ("time.sleep()", None)
        if tail in ("device_put", "device_get") and root in ("jax", tail):
            return (f"jax.{tail}()", None)
        if tail == "urlopen":
            return ("urlopen()", None)
    if not isinstance(f, ast.Attribute):
        return None
    a = f.attr
    if a == "block_until_ready":
        return (".block_until_ready()", None)
    if a == "synchronize":
        return ("device .synchronize()", None)
    if a == "lower" and (call.args or call.keywords):
        # jit(f).lower(sample) traces; str.lower() takes no arguments
        return ("AOT .lower()", None)
    if a == "compile" and root != "re":
        return ("AOT .compile()", None)
    if a == "result":
        return ("Future.result()", None)
    if a in _SOCKET_TAILS:
        return (f"socket .{a}()", None)
    hit = analysis.declared_kind(f.value, fi)
    if hit is None:
        return None
    rid, kind = hit
    if a in ("get", "put") and kind == "queue":
        return (f"queue .{a}()", None)
    if a == "join" and kind in ("thread", "pool"):
        return (f"{kind} .join()", None)
    if a == "shutdown" and kind == "pool":
        wait_false = any(
            kw.arg == "wait"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is False
            for kw in call.keywords
        )
        if not wait_false:
            return ("pool .shutdown(wait=True)", None)
    if a == "wait" and kind in ("condition", "event"):
        return (f"{kind} .wait()", rid if kind == "condition" else None)
    return None


class _Checker:
    def __init__(self, index, contexts):
        self.index = index
        self.contexts = contexts
        self.analysis = LockAnalysis(index, contexts)
        self.model = ThreadModel(index, self.analysis.types)
        self._blk_memo: dict = {}

    def _functions(self):
        for qual in sorted(self.index.functions):
            yield self.index.functions[qual]

    # ------------------------------------------- unsynchronized mutation
    def mutation_findings(self) -> Iterator[Finding]:
        per_class: dict = {}
        for fi in self._functions():
            if fi.class_name is None or fi.name == "__init__":
                continue
            cq = f"{fi.modname}.{fi.class_name}"
            info = self.analysis.info(fi)
            for acc in info.accesses:
                per_class.setdefault(cq, {}).setdefault(
                    acc.attr, []
                ).append((fi, acc))
        for cq in sorted(per_class):
            cls = cq.rsplit(".", 1)[-1]
            for attr in sorted(per_class[cq]):
                accs = sorted(
                    per_class[cq][attr],
                    key=lambda t: (t[0].path, t[1].line),
                )
                guard = self.analysis.guards.get((cq, attr))
                if guard is not None:
                    yield from self._guard_violations(
                        cq, cls, attr, guard, accs
                    )
                    continue
                if cq not in self.model.spawning_classes:
                    continue
                yield from self._heuristic_conflict(cq, cls, attr, accs)

    def _guard_violations(self, cq, cls, attr, guard, accs):
        gid = f"{cq}.{guard}"
        bad = [(fi, a) for fi, a in accs if gid not in a.held]
        if not bad:
            return
        fi, a = bad[0]
        trace = [
            f"{bfi.name} ({bfi.path}:{ba.line}) "
            f"{'writes' if ba.write else 'reads'} without {guard}"
            for bfi, ba in bad[:4]
        ]
        yield _mk(
            UnsynchronizedSharedMutationRule.id,
            fi.path,
            a.line,
            f"self.{attr} of {cls} is declared '# guarded-by: {guard}' "
            f"but {fi.name}() accesses it without holding self.{guard} "
            f"({len(bad)} unguarded site(s)) — either take the lock or "
            "fix the annotation",
            trace,
        )

    def _heuristic_conflict(self, cq, cls, attr, accs):
        writes = [(fi, a) for fi, a in accs if a.write]
        for wfi, w in writes:
            wctx = self.model.contexts(wfi.qualname)
            if not wctx:
                continue
            for afi, a in accs:
                if a is w:
                    continue
                actx = self.model.contexts(afi.qualname)
                if not actx:
                    continue
                union = wctx | actx
                multi = len(union) > 1 or any(
                    c != CALLER and self.model.is_pool_target(c)
                    for c in union
                )
                if not multi or (w.held & a.held):
                    continue
                wlbl = self._ctx_label(wctx)
                albl = self._ctx_label(actx)
                trace = self._thread_trace(wfi, wctx)
                trace.append(
                    f"write: {wfi.name} ({wfi.path}:{w.line}) on {wlbl}"
                )
                trace.append(
                    f"conflicting "
                    f"{'write' if a.write else 'read'}: {afi.name} "
                    f"({afi.path}:{a.line}) on {albl}"
                )
                yield _mk(
                    UnsynchronizedSharedMutationRule.id,
                    wfi.path,
                    w.line,
                    f"self.{attr} of {cls} is written by {wfi.name}() on "
                    f"{wlbl} and accessed by {afi.name}() on {albl} with "
                    "no common lock — torn/lost update; guard both sides "
                    "with one lock and document it as "
                    "'# guarded-by: <lock>'",
                    trace,
                )
                return  # one finding per (class, attr)

    def _ctx_label(self, ctxs) -> str:
        return " / ".join(
            sorted(self.model.context_label(c) for c in ctxs)
        )

    def _thread_trace(self, fi, ctxs) -> list:
        for c in sorted(ctxs):
            if c != CALLER:
                return self.model.trace_to(fi.qualname, c)
        return [f"{fi.name} runs on the caller's thread"]

    # ------------------------------------------------ lock-order inversion
    def order_findings(self) -> Iterator[Finding]:
        edges = build_order_graph(self.analysis)
        for cycle in find_cycles(edges):
            wits = list(cycle_witness(cycle, edges))
            first = wits[0]
            if len(cycle) == 1:
                msg = (
                    f"lock-order cycle: non-reentrant "
                    f"{_short_lock(cycle[0])} is re-acquired while "
                    "already held — guaranteed self-deadlock; use an "
                    "RLock or split the critical section"
                )
            else:
                path = " -> ".join(
                    _short_lock(c) for c in cycle + [cycle[0]]
                )
                msg = (
                    f"lock-order cycle: {path} — threads taking these "
                    "locks in opposite orders deadlock; impose one "
                    "global acquisition order"
                )
            trace = [hop for e in wits for hop in e.witness][:8]
            yield _mk(
                LockOrderInversionRule.id, first.file, first.line, msg, trace
            )

    # --------------------------------------------- blocking call under lock
    def blocking_witness(self, fi, _depth: int = 0) -> Optional[list]:
        if fi.qualname in self._blk_memo:
            return self._blk_memo[fi.qualname]
        self._blk_memo[fi.qualname] = None  # cycle guard
        info = self.analysis.info(fi)
        calls = sorted(info.calls, key=lambda c: c.line)
        for cs in calls:
            hit = _classify_blocking(cs.node, fi, self.analysis)
            if hit is not None and hit[1] is None:
                wit = [f"{fi.name} calls {hit[0]} ({fi.path}:{cs.line})"]
                self._blk_memo[fi.qualname] = wit
                return wit
        if _depth >= _MAX_DEPTH:
            return None
        mi = self.index.modules.get(fi.modname)
        if mi is None:
            return None
        for cs in calls:
            callee = self.index.resolve_call(mi, cs.node.func, fi)
            if callee is None or callee.qualname == fi.qualname:
                continue
            sub = self.blocking_witness(callee, _depth + 1)
            if sub:
                wit = [
                    f"{fi.name} -> {callee.name} ({fi.path}:{cs.line})"
                ] + sub
                self._blk_memo[fi.qualname] = wit
                return wit
        return None

    def blocking_findings(self) -> Iterator[Finding]:
        for fi in self._functions():
            mi = self.index.modules.get(fi.modname)
            info = self.analysis.info(fi)
            for cs in sorted(info.calls, key=lambda c: c.line):
                if not cs.held:
                    continue
                hit = _classify_blocking(cs.node, fi, self.analysis)
                if hit is not None:
                    label, own = hit
                    held = cs.held - {own} if own else cs.held
                    if not held:
                        continue
                    held_s = ", ".join(
                        _short_lock(h) for h in sorted(held)
                    )
                    yield _mk(
                        BlockingCallUnderLockRule.id,
                        fi.path,
                        cs.line,
                        f"{label} while holding {held_s} in {fi.name}() "
                        "— every thread contending for the lock stalls "
                        "behind the blocking call; move it outside the "
                        "critical section",
                        [f"{fi.name} holds {held_s} ({fi.path}:{cs.line})"],
                    )
                    continue
                if mi is None:
                    continue
                callee = self.index.resolve_call(mi, cs.node.func, fi)
                if callee is None or callee.qualname == fi.qualname:
                    continue
                wit = self.blocking_witness(callee)
                if wit:
                    held_s = ", ".join(
                        _short_lock(h) for h in sorted(cs.held)
                    )
                    yield _mk(
                        BlockingCallUnderLockRule.id,
                        fi.path,
                        cs.line,
                        f"{callee.name}(...) called while holding "
                        f"{held_s} in {fi.name}() transitively blocks "
                        f"({wit[-1].strip()}) — move the blocking work "
                        "outside the critical section",
                        [
                            f"{fi.name} holds {held_s} "
                            f"({fi.path}:{cs.line})"
                        ]
                        + wit,
                    )

    # ------------------------------------------------------ check-then-act
    def cta_findings(self) -> Iterator[Finding]:
        for fi in self._functions():
            if fi.name == "__init__":
                continue
            cq = (
                f"{fi.modname}.{fi.class_name}" if fi.class_name else None
            )
            thread_aware = (
                cq in self.model.spawning_classes
                or fi.qualname in self.model.worker_paths
            )
            if not thread_aware:
                continue
            info = self.analysis.info(fi)
            for c in info.check_then_acts:
                if c.held:
                    continue
                ctxs = self.model.contexts(fi.qualname)
                trace = (
                    [f"runs on: {self._ctx_label(ctxs)}"]
                    if ctxs
                    else [f"{fi.name} ({fi.path}:{c.line})"]
                )
                yield _mk(
                    CheckThenActRaceRule.id,
                    fi.path,
                    c.line,
                    f"check-then-act on self.{c.attr} in {fi.name}() "
                    "without a lock — two threads can both see 'missing' "
                    "and both insert; hold the container's lock across "
                    "the test and the store",
                    trace,
                )


def concurrency_findings(index, contexts) -> Iterator[Finding]:
    """All project-mode concurrency findings (interproc.py hook)."""
    checker = _Checker(index, contexts)
    yield from checker.mutation_findings()
    yield from checker.order_findings()
    yield from checker.blocking_findings()
    yield from checker.cta_findings()
