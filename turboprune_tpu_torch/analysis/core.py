"""torchlint core: findings, waivers, the rule registry, and the runner.

The PyTorch/CUDA port fails in ways generic linters never see: a stray
``.item()`` inside a ``torch.compile``'d body is a graph break and a host
sync, a ``torch.compile`` built per call recompiles every time, a draw from
the global generator ties every caller to one stream, a collective under a
rank branch hangs the world, and a CUDA-graph output read after the next
replay holds the next step's numbers. The rules live here, run on every
change, and gate through tests/test_torch_analysis.py's self-gate.

Design: pure stdlib ``ast`` — importing this package never imports torch
(the analyzer has to run where no accelerator stack is installed). Rules
are small ``ast`` visitors registered in ``RULES``; the runner parses each
file once, hands every rule a shared :class:`ModuleContext` (source, tree,
lazily-built compiled-region index), and applies inline waivers afterwards
so waived findings still appear in reports (auditable, not invisible).

Waiver syntax, the port's own tag (the JAX package's ``graftlint:`` tag is
not read here, and this tag is not read there)::

    x = bad_thing()  # torchlint: disable=rule-id[,other-rule] -- reason

A waiver comment alone on a line applies to the next code line (for sites
where the waived statement is long). The reason text is optional to the
parser but required by convention: it doubles as documentation of WHY the
site is exempt.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from pathlib import Path
from typing import Iterable, Iterator, Optional, Sequence

__all__ = [
    "Finding",
    "Waiver",
    "Rule",
    "RULES",
    "register",
    "ModuleContext",
    "AnalysisResult",
    "analyze_source",
    "analyze_files",
    "analyze_paths",
    "analyze_project",
    "is_test_file",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``trace`` (project mode) is the call-path from a compiled entry /
    collective sink / recompiling factory to the flagged site, one hop per string —
    present so a reviewer can audit an interprocedural finding (or its
    waiver) without re-deriving the chain by hand."""

    file: str
    line: int
    col: int
    rule: str
    severity: str  # "error" | "warning"
    message: str
    waived: bool = False
    waiver_reason: Optional[str] = None
    trace: Optional[list] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Waiver:
    """A parsed ``# torchlint: disable=...`` comment."""

    file: str
    line: int  # line the comment sits on
    rules: frozenset
    reason: Optional[str]
    applies_to: int  # line whose findings it waives
    used: bool = False

    def as_dict(self) -> dict:
        return {
            "file": self.file,
            "line": self.line,
            "rules": sorted(self.rules),
            "reason": self.reason,
            "applies_to": self.applies_to,
            "used": self.used,
        }


_WAIVER_RE = re.compile(
    r"torchlint:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
    r"(?:\s*--\s*(.*\S))?\s*$"
)


def parse_waivers(source: str, file: str) -> list:
    """Extract waivers via the tokenizer (a ``#`` inside a string literal is
    not a comment). A comment-only line waives the NEXT code line."""
    comments: list[tuple[int, str, bool]] = []  # (line, text, standalone)
    code_lines: set[int] = set()
    try:
        tokens = list(
            tokenize.generate_tokens(io.StringIO(source).readline)
        )
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return []
    for tok in tokens:
        if tok.type == tokenize.COMMENT:
            standalone = tok.line.strip().startswith("#")
            comments.append((tok.start[0], tok.string, standalone))
        elif tok.type not in (
            tokenize.NL,
            tokenize.NEWLINE,
            tokenize.INDENT,
            tokenize.DEDENT,
            tokenize.ENDMARKER,
        ):
            for ln in range(tok.start[0], tok.end[0] + 1):
                code_lines.add(ln)

    waivers = []
    for line, text, standalone in comments:
        m = _WAIVER_RE.search(text)
        if not m:
            continue
        rules = frozenset(r.strip() for r in m.group(1).split(","))
        if standalone:
            later = [ln for ln in code_lines if ln > line]
            applies_to = min(later) if later else line
        else:
            applies_to = line
        waivers.append(
            Waiver(
                file=file,
                line=line,
                rules=rules,
                reason=m.group(2),
                applies_to=applies_to,
            )
        )
    return waivers


def is_test_file(path) -> bool:
    """Test files get a few deliberately looser rules (``skip_in_tests``):
    tests build throwaway compiled functions and draw from the global
    generator on purpose."""
    p = Path(path)
    if any(part == "tests" for part in p.parts):
        return True
    return p.name.startswith("test_") or p.name == "conftest.py"


class ModuleContext:
    """Everything a rule needs about one file, parsed once."""

    def __init__(self, path, source: str):
        self.path = str(path)
        self.source = source
        self.tree = ast.parse(source)  # caller handles SyntaxError
        self.is_test = is_test_file(path)
        self._regions = None

    @property
    def compiled_regions(self):
        """Lazily-built lexical compiled-region index (regions.py)."""
        if self._regions is None:
            from .regions import build_compiled_regions

            self._regions = build_compiled_regions(self.tree, self.source)
        return self._regions

    def finding(
        self,
        rule: "Rule",
        node: ast.AST,
        message: str,
        trace: Optional[list] = None,
    ) -> Finding:
        return Finding(
            file=self.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            rule=rule.id,
            severity=rule.severity,
            message=message,
            trace=trace,
        )


class Rule:
    """Base class: subclass, set ``id``/``severity``/``description``,
    implement ``check``, and decorate with :func:`register`."""

    id: str = ""
    severity: str = "error"
    description: str = ""
    # True: rule does not run on tests/conftest files (see is_test_file).
    skip_in_tests: bool = False
    # True: rule needs the project layer (symbol table / thread model) and
    # fires only from check_project; the per-file pass skips it and
    # per-file stale-waiver accounting treats its waivers as out of scope.
    project_only: bool = False
    # Why the hazard matters on the GPU — the third column of the README
    # rule catalog, which `--rule-docs` generates from this registry.
    doc_why: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError


RULES: dict = {}


def register(cls):
    rule = cls()
    assert rule.id and rule.id not in RULES, f"bad rule id {rule.id!r}"
    RULES[rule.id] = rule
    return cls


@dataclasses.dataclass
class AnalysisResult:
    findings: list  # every Finding, waived ones flagged
    waivers: list  # every Waiver, used ones flagged
    files_analyzed: int
    # True for analyze_project results; per-file results leave it False so
    # stale accounting can scope waivers to the rules the mode can fire.
    project: bool = False

    @property
    def unwaived(self) -> list:
        return [f for f in self.findings if not f.waived]

    @property
    def waived(self) -> list:
        return [f for f in self.findings if f.waived]

    @property
    def unused_waivers(self) -> list:
        """Waivers that matched nothing. In per-file mode (including
        ``--changed``), waivers naming only project-scope rules are out of
        scope — they CANNOT match there and only project mode may call
        them stale (which the project self-gate does). The project-only
        set is derived from the conf-rule registry (plus the ``conf-``
        prefix as a guard for rules not yet registered), so a new conf
        rule never reintroduces the false-stale bug by omission."""
        unused = [w for w in self.waivers if not w.used]
        if self.project:
            return unused
        from .conf_rules import CONF_RULES  # lazy: conf_rules imports core

        project_only = set(CONF_RULES) | {
            rid for rid, r in RULES.items() if r.project_only
        }
        return [
            w
            for w in unused
            if not all(
                r in project_only or r.startswith("conf-") for r in w.rules
            )
        ]


def _apply_waivers(
    findings: list, waivers: list
) -> list:
    by_line: dict[int, list] = {}
    for w in waivers:
        by_line.setdefault(w.applies_to, []).append(w)
    out = []
    for f in findings:
        hit = None
        for w in by_line.get(f.line, ()):
            if f.rule in w.rules:
                hit = w
                break
        if hit is not None:
            hit.used = True
            out.append(
                dataclasses.replace(f, waived=True, waiver_reason=hit.reason)
            )
        else:
            out.append(f)
    return out


def _parse_error_finding(file: str, e: SyntaxError) -> Finding:
    return Finding(
        file=file,
        line=e.lineno or 1,
        col=(e.offset or 1) - 1,
        rule="parse-error",
        severity="error",
        message=f"file does not parse: {e.msg}",
    )


def _run_rules_dedup(ctx: ModuleContext, select=None) -> list:
    """Per-file rules over one parsed module, exact duplicates collapsed
    (nested compiled regions can surface the same node twice)."""
    findings = []
    for rule in RULES.values():
        if rule.project_only:
            continue  # fires from check_project, never per-file
        if select and rule.id not in select:
            continue
        if rule.skip_in_tests and ctx.is_test:
            continue
        findings.extend(rule.check(ctx))
    seen: set = set()
    unique = []
    for f in sorted(findings, key=lambda f: (f.line, f.col, f.rule)):
        key = (f.line, f.col, f.rule, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique


def analyze_source(
    source: str,
    path="<string>",
    select: Optional[Sequence[str]] = None,
) -> tuple:
    """Run every (selected) rule over one module. Returns
    ``(findings, waivers)`` with waivers already applied."""
    file = str(path)
    waivers = parse_waivers(source, file)
    try:
        ctx = ModuleContext(file, source)
    except SyntaxError as e:
        return _apply_waivers([_parse_error_finding(file, e)], waivers), waivers
    return _apply_waivers(_run_rules_dedup(ctx, select), waivers), waivers


def iter_python_files(paths: Iterable) -> list:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(
                f
                for f in sorted(p.rglob("*.py"))
                if "__pycache__" not in f.parts
            )
        elif p.suffix == ".py":
            files.append(p)
        else:
            raise FileNotFoundError(f"not a .py file or directory: {p}")
    return files


def analyze_paths(
    paths: Iterable,
    select: Optional[Sequence[str]] = None,
) -> AnalysisResult:
    """Analyze every ``.py`` under ``paths`` (files or directories)."""
    all_findings: list = []
    all_waivers: list = []
    files = iter_python_files(paths)
    for f in files:
        findings, waivers = analyze_source(
            f.read_text(encoding="utf-8"), f, select=select
        )
        all_findings.extend(findings)
        all_waivers.extend(waivers)
    all_findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return AnalysisResult(
        findings=all_findings,
        waivers=all_waivers,
        files_analyzed=len(files),
    )


def _conf_root_for(path: Path) -> Path:
    """Best-effort conf root for a yaml analyzed WITHOUT project context:
    the tree up to (and including) the last ``conf`` path component, so
    group-shaped paths still resolve; else the file's directory."""
    parts = path.parts
    if "conf" in parts[:-1]:
        idx = max(i for i, c in enumerate(parts[:-1]) if c == "conf")
        return Path(*parts[: idx + 1])
    return path.parent


def analyze_files(
    files: Iterable,
    select: Optional[Sequence[str]] = None,
) -> AnalysisResult:
    """Per-file mode over an explicit mixed list of ``.py`` and
    ``.yaml``/``.yml`` files (the ``--changed`` surface): Python files get
    the per-file rules; yaml files get the schema-independent conf checks
    (parse errors, duplicate keys, defaults shape — no project symbol
    table, so the schema cross-checks stay project mode's job)."""
    from .conf_rules import analyze_conf

    py_files: list = []
    yaml_files: list = []
    for f in files:
        p = Path(f)
        if p.suffix == ".py":
            py_files.append(p)
        elif p.suffix in (".yaml", ".yml"):
            yaml_files.append((p, _conf_root_for(p)))
        else:
            raise FileNotFoundError(f"not a .py/.yaml file: {p}")
    all_findings: list = []
    all_waivers: list = []
    for f in py_files:
        findings, waivers = analyze_source(
            f.read_text(encoding="utf-8"), f, select=select
        )
        all_findings.extend(findings)
        all_waivers.extend(waivers)
    if yaml_files:
        conf_findings, conf_waivers = analyze_conf(yaml_files, {})
        conf_findings = [
            f for f in conf_findings if not select or f.rule in select
        ]
        all_findings.extend(
            _apply_waivers_by_file(conf_findings, conf_waivers)
        )
        all_waivers.extend(conf_waivers)
    all_findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return AnalysisResult(
        findings=all_findings,
        waivers=all_waivers,
        files_analyzed=len(py_files) + len(yaml_files),
    )


# ----------------------------------------------------------- project mode


def _yaml_root(file: Path, root: Path) -> Path:
    """The conf root for one yaml: the passed directory, advanced through
    a leading ``conf`` component so ``<repo>/conf/<group>/<option>.yaml``
    resolves its group whether the caller passed the repo root or conf/
    itself."""
    try:
        rel = file.relative_to(root)
    except ValueError:
        return root
    while rel.parts and rel.parts[0] == "conf":
        root = root / "conf"
        rel = file.relative_to(root)
    return root


def _collect_project_files(paths) -> tuple:
    """``(py_files, [(yaml_file, conf_root), ...])`` under ``paths``.

    A directory contributes its ``.py`` tree to the symbol table and its
    ``.yaml``/``.yml`` tree to the config rules. Overlapping paths dedupe
    (deepest conf root wins, so group resolution stays correct)."""
    py_files: list = []
    yaml_roots: dict = {}
    for p in paths:
        p = Path(p)
        if p.is_dir():
            py_files.extend(
                f
                for f in sorted(p.rglob("*.py"))
                if "__pycache__" not in f.parts
            )
            for pattern in ("*.yaml", "*.yml"):
                for f in sorted(p.rglob(pattern)):
                    root = _yaml_root(f, p)
                    key = f.resolve()
                    prior = yaml_roots.get(key)
                    if prior is None or len(str(root)) > len(str(prior[1])):
                        yaml_roots[key] = (f, root)
        elif p.suffix == ".py":
            py_files.append(p)
        elif p.suffix in (".yaml", ".yml"):
            yaml_roots.setdefault(p.resolve(), (p, p.parent))
        else:
            raise FileNotFoundError(
                f"not a .py/.yaml file or directory: {p}"
            )
    seen_py: set = set()
    unique_py: list = []
    for f in py_files:
        key = Path(f).resolve()
        if key not in seen_py:
            seen_py.add(key)
            unique_py.append(f)
    return unique_py, sorted(yaml_roots.values(), key=lambda t: str(t[0]))


def _apply_waivers_by_file(findings: list, waivers: list) -> list:
    by_file: dict = {}
    for w in waivers:
        by_file.setdefault(w.file, []).append(w)
    grouped: dict = {}
    for f in findings:
        grouped.setdefault(f.file, []).append(f)
    out: list = []
    for file, fs in grouped.items():
        out.extend(_apply_waivers(fs, by_file.get(file, [])))
    return out


def _project_file_scan(args) -> tuple:
    """Process-pool worker: parse one file and run the per-file rules.

    Returns ``(file, source, findings, waivers, parsed)``. Module-level
    (picklable) on purpose; the lazy imports re-register the rule set when
    the pool uses the spawn start method (fork inherits it)."""
    path, select = args
    from . import concurrency_rules, rules  # noqa: F401

    p = Path(path)
    source = p.read_text(encoding="utf-8")
    file = str(p)
    waivers = parse_waivers(source, file)
    try:
        ctx = ModuleContext(file, source)
    except SyntaxError as e:
        return file, source, [_parse_error_finding(file, e)], waivers, False
    return file, source, _run_rules_dedup(ctx, select), waivers, True


# Below this, process-pool startup dominates: run serial.
_MIN_PARALLEL_FILES = 8


def _scan_project_files(py_files, select, jobs) -> list:
    """Per-file scans for project mode, parallel when it pays.

    Output order equals input order either way (``Executor.map`` preserves
    it), and the final sort makes finding order deterministic, so
    ``--jobs`` can never change a report. Pool failures
    (sandboxes without semaphores, missing /dev/shm) fall back to serial."""
    if jobs is None or jobs <= 0:
        jobs = os.cpu_count() or 1
    args = [(str(f), tuple(select) if select else None) for f in py_files]
    if jobs > 1 and len(args) >= _MIN_PARALLEL_FILES:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        try:
            # Spawn, not fork: analyze_project is also called from inside
            # test processes that have already imported torch (multithreaded
            # — forking it can deadlock the child). _project_file_scan
            # lazy-imports the rule modules precisely so spawned workers
            # can bootstrap from an empty interpreter.
            with ProcessPoolExecutor(
                max_workers=jobs,
                mp_context=multiprocessing.get_context("spawn"),
            ) as pool:
                return list(pool.map(_project_file_scan, args, chunksize=4))
        except (OSError, PermissionError, ImportError):
            pass
    return [_project_file_scan(a) for a in args]


def analyze_project(
    paths: Iterable,
    select: Optional[Sequence[str]] = None,
    jobs: Optional[int] = None,
) -> AnalysisResult:
    """Whole-project mode: per-file rules PLUS the interprocedural layer
    (symbol table + call graph; rules fire through call chains with a
    call-path trace) PLUS the config static analysis over ``*.yaml`` files
    against the schema dataclasses. Waivers come from Python comments and
    from ``# torchlint: disable=...`` YAML comments alike; stale-waiver
    accounting spans both layers (this is the mode the pre-PR gate runs).

    ``jobs`` widens the per-file half across a process pool (None/0 =
    one per CPU, 1 = serial); the interprocedural layer stays in-process
    on a re-parse of the same sources."""
    from .conf_rules import analyze_conf
    from .interproc import check_project
    from .project import ProjectIndex

    py_files, yaml_files = _collect_project_files(paths)
    raw_findings: list = []
    all_waivers: list = []
    contexts: dict = {}
    for file, source, findings, waivers, parsed in _scan_project_files(
        py_files, select, jobs
    ):
        all_waivers.extend(waivers)
        raw_findings.extend(findings)
        if parsed:
            contexts[file] = ModuleContext(file, source)

    # interprocedural layer (dedup: a site already flagged per-file keeps
    # its per-file finding; the interprocedural twin is dropped)
    index = ProjectIndex.build(contexts.values())
    seen = {(f.file, f.line, f.rule) for f in raw_findings}
    for f in check_project(index, contexts):
        if select and f.rule not in select:
            continue
        if (f.file, f.line, f.rule) not in seen:
            seen.add((f.file, f.line, f.rule))
            raw_findings.append(f)

    # config rules
    conf_findings, conf_waivers = analyze_conf(yaml_files, contexts)
    raw_findings.extend(
        f for f in conf_findings if not select or f.rule in select
    )
    all_waivers.extend(conf_waivers)

    findings = _apply_waivers_by_file(raw_findings, all_waivers)
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return AnalysisResult(
        findings=findings,
        waivers=all_waivers,
        files_analyzed=len(py_files) + len(yaml_files),
        project=True,
    )
