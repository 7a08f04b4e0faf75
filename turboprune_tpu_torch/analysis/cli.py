"""torchlint CLI: ``python -m turboprune_tpu_torch.analysis [paths...]``.

Exit codes (the JAX package's contract):
  0 — analyzed clean: zero unwaived findings
  1 — at least one unwaived finding (or a failed runtime mode)
  2 — usage / environment error (bad path, unknown rule in --select,
      git unavailable for --changed, CUDA asked for and absent)

Modes:

* per-file (default) — the lexical rules over the given paths;
* ``--project`` — per-file PLUS the interprocedural layer (symbol table +
  call graph, rules fire through call chains with call-path traces) PLUS
  the config rules over every ``*.yaml`` under the paths, against the
  port's schema. The port's gate: ``--project turboprune_tpu_torch conf
  tests/test_torch_*.py tests/torch_port_*.py run_*_torch.py
  chip_smoke.py``;
* ``--changed [BASE]`` — per-file rules over only the ``.py``/``.yaml``
  files changed vs ``git merge-base HEAD BASE`` (default ``main``), plus
  untracked files;
* ``--sanitize [TARGET]`` — graftsan, the runtime mirror of the
  concurrency rules (sanitizer.py): wrap ``threading.Lock``/``RLock``/
  ``Condition``, drive the PrefetchEngine / FleetEngine load drives (or a
  ``file.py:builder`` target), fail on observed lock-order cycles and on
  shared-attribute races the static rules did not predict;
* ``--exec-manifest [emit|diff|print]`` — statically enumerate the compile
  surface (compiled entries, torch.compile sites, CUDA-graph captures,
  custom ops and their fakes, bucket sets, plan kinds) into
  analysis/exec_manifest.json; ``diff`` fails when the surface has drifted
  from the checked-in manifest (exec_manifest.py);
* ``--compile-audit [TARGET]`` — the runtime mirror of the manifest
  (compile_audit.py): record dynamo's compiles, graph breaks and
  recompiles over the serving / train drives, and fail on any the
  manifest does not explain;
* ``--rule-docs`` — print the generated rule-catalog markdown table (the
  source of README.md's torch rule-catalog block).

The runtime modes (``--sanitize``, ``--compile-audit``) run on
``--device cuda`` (the default) or ``--device cpu``; without CUDA the
default is a usage error, never a silent CPU run. The JAX package's
``--jaxpr-audit`` has no counterpart here.

With no paths it analyzes the ``turboprune_tpu_torch`` package (with
``--project``, plus ``conf/``).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

from .conf_rules import CONF_RULES
from .core import RULES, analyze_files, analyze_paths, analyze_project
from .reporters import render_json, render_sarif, render_text

_EPILOG = """\
exit codes:
  0  analyzed clean: zero unwaived findings (exec-manifest diff: no
     drift; compile audit: every compile attributed, no graph break, no
     recompile past the manifest)
  1  at least one unwaived finding (sanitize: observed lock-order cycle
     or a race with no static finding; exec-manifest diff: compile
     surface drifted vs the checked-in manifest; compile audit: a graph
     break, a compile no manifest entry explains, a recompile past the
     manifest's allowance, or a compiled (plan, bucket) outside the
     declared surface)
  2  usage or environment error (bad path, unknown rule in --select,
     git unavailable for --changed, --device cuda without CUDA, missing
     manifest)
"""


def _default_paths() -> list:
    return [str(Path(__file__).resolve().parents[1])]


def _default_project_paths() -> list:
    pkg = Path(__file__).resolve().parents[1]
    paths = [str(pkg)]
    conf = pkg.parent / "conf"
    if conf.is_dir():
        paths.append(str(conf))
    return paths


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m turboprune_tpu_torch.analysis",
        description=(
            "torchlint: static analysis of the PyTorch/CUDA port (host "
            "syncs in compiled regions, recompile hazards, custom-op fakes, "
            "the global generator, rank-conditional collectives, CUDA-graph "
            "output reuse, swallowed exceptions; --project adds "
            "interprocedural call-chain analysis, the thread rules and "
            "conf/ schema cross-checking)"
        ),
        epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files or directories (default: the turboprune_tpu_torch package)",
    )
    p.add_argument(
        "--project",
        action="store_true",
        help=(
            "whole-project mode: interprocedural compiled-region/collective/"
            "recompile analysis over the call graph, the thread rules, plus "
            "conf/*.yaml schema cross-checks, on top of the per-file rules"
        ),
    )
    p.add_argument(
        "--changed",
        nargs="?",
        const="main",
        metavar="BASE",
        help=(
            "lint only .py/.yaml files changed vs the merge-base of HEAD "
            "and BASE (default: main), plus untracked files"
        ),
    )
    p.add_argument(
        "--sanitize",
        nargs="?",
        const="all",
        metavar="TARGET",
        help=(
            "graftsan runtime concurrency sanitizer: wrap "
            "threading.Lock/RLock/Condition, drive TARGET ('pipeline', "
            "'fleet', 'all', or 'file.py:builder' returning a callable) "
            "under threaded load, fail on observed lock-order cycles and "
            "on shared-attribute races with no static "
            "unsynchronized-shared-mutation finding (a sanitizer-only "
            "race is a static blind spot)"
        ),
    )
    p.add_argument(
        "--exec-manifest",
        nargs="?",
        const="diff",
        choices=("emit", "diff", "print"),
        metavar="MODE",
        help=(
            "executable-set manifest (exec_manifest.py): statically "
            "enumerate every compiled entry, torch.compile site, CUDA-graph "
            "capture, custom op, bucket set and plan kind; 'emit' writes "
            "analysis/exec_manifest.json, 'diff' (default) rebuilds and "
            "fails on drift vs the checked-in file, 'print' dumps the "
            "fresh manifest"
        ),
    )
    p.add_argument(
        "--compile-audit",
        nargs="?",
        const="all",
        metavar="TARGET",
        help=(
            "runtime mirror of the executable manifest "
            "(compile_audit.py): record dynamo's compiles over TARGET "
            "('serve', 'train', 'all', or 'file.py:builder' whose "
            "builder(device) returns a callable) and fail on a graph break, "
            "a compile in no manifest entry, a recompile past the "
            "manifest, or a compiled (plan, bucket) outside it"
        ),
    )
    p.add_argument(
        "--rule-docs",
        action="store_true",
        help=(
            "print the README rule-catalog markdown table generated from "
            "the rule registries (README.md's torch rule-catalog block "
            "must match — tests/test_torch_analysis.py gates it)"
        ),
    )
    p.add_argument(
        "--jobs",
        type=int,
        default=0,
        metavar="N",
        help=(
            "process-pool width for --project's per-file half "
            "(0 = one per CPU, 1 = serial; finding order is identical "
            "either way)"
        ),
    )
    p.add_argument(
        "--device",
        default="cuda",
        help=(
            "device of the runtime modes (--sanitize, --compile-audit): "
            "cuda (default; an error without CUDA) or cpu"
        ),
    )
    p.add_argument(
        "--format",
        choices=("text", "json", "sarif"),
        default=None,
        help="report format (default: text; sarif renders CI annotations)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="machine-readable JSON report (alias for --format json)",
    )
    p.add_argument(
        "--show-waived",
        action="store_true",
        help="include waived findings in the text report",
    )
    p.add_argument(
        "--select",
        metavar="RULES",
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )
    return p


def _changed_python_files(base: str) -> list:
    """Lintable files changed vs the merge-base of HEAD and ``base``
    (NOT the base tip: diffing against an advanced main would drag in
    every file main changed and miss nothing-but-noise), plus untracked
    files. Py and yaml both count — per-file rules for the former, the
    schema-independent conf checks for the latter."""
    merge = subprocess.run(
        ["git", "merge-base", "HEAD", base],
        capture_output=True,
        text=True,
    )
    diff_base = (
        merge.stdout.strip()
        if merge.returncode == 0 and merge.stdout.strip()
        else base
    )
    files: list = []
    for cmd in (
        ["git", "diff", "--name-only", diff_base, "--"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        proc = subprocess.run(
            cmd, capture_output=True, text=True, check=True
        )
        files.extend(proc.stdout.splitlines())
    out = []
    seen = set()
    for f in files:
        if (
            f.endswith((".py", ".yaml", ".yml"))
            and f not in seen
            and Path(f).exists()
        ):
            seen.add(f)
            out.append(f)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    all_rules = {**{r.id: r for r in RULES.values()}, **CONF_RULES}
    if args.list_rules:
        width = max(len(r) for r in all_rules)
        for rule in RULES.values():
            print(f"{rule.id:<{width}}  [{rule.severity}] {rule.description}")
        for rule in CONF_RULES.values():
            print(
                f"{rule.id:<{width}}  [{rule.severity}] [project] "
                f"{rule.description}"
            )
        return 0

    modes = [
        name
        for name, on in (
            ("--project", args.project),
            ("--changed", bool(args.changed)),
            ("--sanitize", bool(args.sanitize)),
            ("--exec-manifest", bool(args.exec_manifest)),
            ("--compile-audit", bool(args.compile_audit)),
            ("--rule-docs", args.rule_docs),
        )
        if on
    ]
    if len(modes) > 1:
        print(
            f"{' and '.join(modes)} are mutually exclusive",
            file=sys.stderr,
        )
        return 2

    fmt = args.format or ("json" if args.json else "text")

    select = None
    if args.select:
        select = [r.strip() for r in args.select.split(",") if r.strip()]
        unknown = [r for r in select if r not in all_rules]
        if unknown:
            print(
                f"unknown rule(s): {', '.join(unknown)} "
                f"(known: {', '.join(sorted(all_rules))})",
                file=sys.stderr,
            )
            return 2

    if args.sanitize:
        from .sanitizer import SanitizeError, run_sanitize

        try:
            return run_sanitize(args.sanitize, device=args.device)
        except SanitizeError as e:
            print(f"torchlint --sanitize: {e}", file=sys.stderr)
            return 2

    if args.rule_docs:
        from .reporters import render_rule_docs

        print(render_rule_docs(), end="")
        return 0

    if args.exec_manifest:
        from .exec_manifest import run_exec_manifest

        try:
            return run_exec_manifest(args.exec_manifest, paths=args.paths)
        except ValueError as e:
            print(f"torchlint --exec-manifest: {e}", file=sys.stderr)
            return 2

    if args.compile_audit:
        from .compile_audit import AuditError, run_compile_audit

        try:
            return run_compile_audit(args.compile_audit, device=args.device)
        except AuditError as e:
            print(f"torchlint --compile-audit: {e}", file=sys.stderr)
            return 2

    try:
        if args.changed:
            if args.paths:
                print(
                    "--changed takes no paths (it derives them from git)",
                    file=sys.stderr,
                )
                return 2
            try:
                files = _changed_python_files(args.changed)
            except (subprocess.CalledProcessError, OSError) as e:
                detail = getattr(e, "stderr", "") or str(e)
                print(
                    f"torchlint --changed: git failed: {detail.strip()}",
                    file=sys.stderr,
                )
                return 2
            if not files:
                print(
                    f"torchlint: no lintable files changed vs {args.changed}"
                )
                return 0
            result = analyze_files(files, select=select)
        elif args.project:
            result = analyze_project(
                args.paths or _default_project_paths(),
                select=select,
                jobs=args.jobs or None,
            )
        else:
            result = analyze_paths(
                args.paths or _default_paths(), select=select
            )
    except (FileNotFoundError, OSError) as e:
        print(f"torchlint: {e}", file=sys.stderr)
        return 2

    if fmt == "json":
        print(render_json(result))
    elif fmt == "sarif":
        print(render_sarif(result))
    else:
        print(render_text(result, show_waived=args.show_waived))
    return 1 if result.unwaived else 0
