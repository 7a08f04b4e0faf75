"""Executable-set manifest: statically bound the port's compile surface.

Serving and the compiled train step live by ONE property: the set of
graphs a process can ever compile is finite and known before it boots
(warm-up compiles all of them; steady state never compiles). This module
writes that property down. It statically enumerates

* **entries** — every function that runs compiled: the lexical
  ``torch.compile`` regions and custom-op fakes (regions.py) and the
  functions compiled through a factory (``compile_forward(train_forward,
  device)``; a bucket's region function rebuilt by ``_region_function``),
  found by the call graph (callgraph.py). A compile's code object is
  attributed to the entry whose span holds its first line;
* **compile_sites** — every ``torch.compile(...)`` call, with what it
  compiles and its ``mode``/``backend`` keywords;
* **captures** — every ``with torch.cuda.graph(...)`` block;
* **custom_ops** — every ``torch.library.custom_op`` and the line of its
  ``register_fake`` (None when it has none);
* **bucket_sets** — every declared batch-bucket set: literal int tuples
  assigned to bucket-named symbols in the package and bucket-named lists
  in ``conf/**/*.yaml``;
* **plan_kinds** — the plan kinds ``plan_signature()`` can lead with
  (``masked``, ``compact``, ``nm``, ``mixed``): the vocabulary a serving
  bucket's cache key may carry;
* **recompiles** — how many recompiles of one code object the surface
  allows (0: each entry compiles once per guard set it was built for).

It is checked in as ``exec_manifest.json`` next to this file;
``--exec-manifest diff`` fails when the code grows an entry, a compile
site, a capture, an op, a bucket or a plan kind the manifest does not
list (re-emit to accept), and ``--compile-audit`` (compile_audit.py) holds
a real run to it.

Pure stdlib at import time, like the rest of the package; the yaml parse
degrades to a regex scan when PyYAML is unavailable.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path
from typing import Optional

from .core import _collect_project_files, is_test_file
from .project import ProjectIndex
from .regions import (
    build_compiled_regions,
    dotted_name,
    fake_target,
    is_compile_wrapper,
    is_fake_registration,
    unwrap_partial,
)

__all__ = [
    "MANIFEST_PATH",
    "build_manifest",
    "covers",
    "entry_for",
    "load_manifest",
    "run_exec_manifest",
]

MANIFEST_PATH = Path(__file__).resolve().parent / "exec_manifest.json"
MANIFEST_VERSION = 1


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def _rel(path) -> str:
    p = Path(path).resolve()
    try:
        return p.relative_to(_repo_root()).as_posix()
    except ValueError:
        return p.as_posix()


def _default_paths() -> list:
    pkg = Path(__file__).resolve().parents[1]
    paths = [pkg]
    conf = pkg.parent / "conf"
    if conf.is_dir():
        paths.append(conf)
    return paths


# ----------------------------------------------------------- python scans


def _int_seq(node: ast.AST) -> Optional[list]:
    """A literal tuple/list of >= 1 ints -> the ints; else None."""
    if not isinstance(node, (ast.Tuple, ast.List)) or not node.elts:
        return None
    out = []
    for e in node.elts:
        if not (isinstance(e, ast.Constant) and isinstance(e.value, int)
                and not isinstance(e.value, bool)):
            return None
        out.append(e.value)
    return out


def _bucket_named(name: Optional[str]) -> bool:
    return bool(name) and "bucket" in name.lower()


def _py_bucket_sets(tree, rel) -> dict:
    """``{"<file>:<symbol>": [ints]}`` for bucket declarations in one
    module (the sequence may sit behind a default_factory lambda)."""
    out: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        names = [t.id for t in targets if isinstance(t, ast.Name) and _bucket_named(t.id)]
        if not names:
            continue
        seq = _int_seq(value)
        if seq is None:
            for sub in ast.walk(value):
                seq = _int_seq(sub)
                if seq is not None:
                    break
        if seq is not None:
            for name in names:
                out[f"{rel}:{name}"] = seq
    return out


def _plan_kinds(tree, rel) -> dict:
    """The string each ``return ("<kind>", ...)`` of a ``plan_signature``
    leads with."""
    out: dict = {}
    for fn in ast.walk(tree):
        if not (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and fn.name == "plan_signature"):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Return) and isinstance(node.value, ast.Tuple)
                    and node.value.elts and isinstance(node.value.elts[0], ast.Constant)
                    and isinstance(node.value.elts[0].value, str)):
                out.setdefault(node.value.elts[0].value, f"{rel}:{node.lineno}")
    return out


def _def_start(fn) -> int:
    """First line of a def's code object: its first decorator, if any."""
    return min([fn.lineno] + [d.lineno for d in getattr(fn, "decorator_list", [])])


def _site_target(arg: ast.AST, mi, index, graph, scope) -> str:
    """What a ``torch.compile`` call compiles, by name: a function, the
    nested def a factory call returns, or the parameter it is handed."""
    node = unwrap_partial(arg)
    if isinstance(node, ast.Lambda):
        return "<lambda>"
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Call):
        callee = index.resolve_call(mi, node.func, scope)
        if callee is not None:
            nested = graph.returns_nested(callee)
            if nested is not None:
                return nested.name
        return dotted_name(node.func) or "?"
    return "?"


def _keywords(call: ast.Call) -> dict:
    return {kw.arg: kw.value.value for kw in call.keywords
            if kw.arg in ("mode", "backend", "fullgraph", "dynamic")
            and isinstance(kw.value, ast.Constant)}


def _scan_python(py_files) -> dict:
    """The manifest's Python half over the package. Test files and this
    analysis package are excluded: the manifest bounds what SHIPPING code
    compiles, and the audit's own drives compile on purpose."""
    from .callgraph import CallGraph
    from .rules import _own_statements, _walk_no_nested_defs

    analysis_dir = Path(__file__).resolve().parent
    parsed = []
    for f in py_files:
        if is_test_file(f) or Path(f).resolve().parent == analysis_dir:
            continue
        try:
            source = Path(f).read_text(encoding="utf-8")
            parsed.append((str(f), ast.parse(source), source))
        except SyntaxError:
            continue  # the lint gate owns parse errors

    class _Ctx:  # the minimal shape ProjectIndex.build consumes
        def __init__(self, path, tree):
            self.path, self.tree = path, tree

    index = ProjectIndex.build(_Ctx(p, t) for p, t, _ in parsed)
    graph = CallGraph(index, {p: s for p, _, s in parsed})
    out = {"entries": [], "compile_sites": [], "captures": [], "custom_ops": [],
           "bucket_sets": {}, "plan_kinds": {}}

    for qual, reason in graph.entries.items():
        fi = index.functions.get(qual)
        if fi is None or reason.startswith("fake of"):
            continue  # a fake runs under the compiler, never as a frame of its own
        out["entries"].append({
            "name": fi.name, "file": _rel(fi.path), "line": _def_start(fi.node),
            "end": fi.node.end_lineno or fi.node.lineno,
            "reason": reason.split(" (")[0].split(" at ")[0],
        })
    for path, tree, source in parsed:
        rel = _rel(path)
        for r in build_compiled_regions(tree, source):
            if r.kind == "capture":
                out["captures"].append({"file": rel, "line": r.start, "end": r.end})
        ops = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    call = dec if isinstance(dec, ast.Call) else None
                    if call and (dotted_name(call.func) or "").endswith("custom_op"):
                        qualified = call.args[0].value if call.args and isinstance(
                            call.args[0], ast.Constant) else node.name
                        ops[node.name] = {"op": qualified, "file": rel,
                                          "line": node.lineno, "fake": None}
        fakes = {o: None for o in ops}
        op_defs = {n.name: n for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name in ops}
        for node in ast.walk(tree):
            regs = []
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                regs = [d for d in node.decorator_list
                        if is_fake_registration(d.func if isinstance(d, ast.Call) else d)]
            elif isinstance(node, ast.Call) and is_fake_registration(node.func):
                regs = [node]
            for reg in regs:
                op = fake_target(reg, op_defs)
                if op is not None and fakes[op.name] is None:
                    fakes[op.name] = node.lineno
        for name, row in ops.items():
            row["fake"] = fakes[name]
            out["custom_ops"].append(row)
        out["bucket_sets"].update(_py_bucket_sets(tree, rel))
        out["plan_kinds"].update(_plan_kinds(tree, rel))
        mi = index.module_for_path(path)
        if mi is None:
            continue
        scopes = [(None, mi.tree.body)]
        scopes.extend((fi, fi.node.body) for fi in index.functions.values() if fi.path == mi.path)
        for scope, body in scopes:
            for node in _walk_no_nested_defs(_own_statements(body)):
                if isinstance(node, ast.Call) and is_compile_wrapper(node.func) and node.args:
                    out["compile_sites"].append({
                        "target": _site_target(node.args[0], mi, index, graph, scope),
                        "file": rel, "line": node.lineno, **_keywords(node),
                    })
    return out


# ------------------------------------------------------------- yaml scans

_YAML_BUCKET_RE = re.compile(r"^(\w*bucket\w*)\s*:\s*\[([0-9,\s]+)\]", re.MULTILINE)


def _walk_yaml(data, prefix, out) -> None:
    if isinstance(data, dict):
        for k, v in data.items():
            key = str(k)
            if (_bucket_named(key) and isinstance(v, list) and v
                    and all(isinstance(i, int) and not isinstance(i, bool) for i in v)):
                out[f"{prefix}:{key}"] = list(v)
            else:
                _walk_yaml(v, prefix, out)
    elif isinstance(data, list):
        for v in data:
            _walk_yaml(v, prefix, out)


def _yaml_bucket_sets(yaml_files) -> dict:
    out: dict = {}
    for f, _root in yaml_files:
        rel = _rel(f)
        try:
            text = Path(f).read_text(encoding="utf-8")
        except OSError:
            continue
        try:
            import yaml

            _walk_yaml(yaml.safe_load(text), rel, out)
        except Exception:  # torchlint: disable=broad-except -- no PyYAML / unparsable yaml degrades to the regex scan; the conf rules own yaml errors
            for m in _YAML_BUCKET_RE.finditer(text):
                vals = [int(x) for x in m.group(2).split(",") if x.strip()]
                if vals:
                    out[f"{rel}:{m.group(1)}"] = vals
    return out


# ------------------------------------------------------------ the manifest


def build_manifest(paths=None) -> dict:
    """The static compile-surface manifest over ``paths`` (default: the
    package + conf/). Deterministic: everything sorted, paths repo-relative
    posix — same tree, same JSON, so ``diff`` is a pure content check."""
    py_files, yaml_files = _collect_project_files(paths or _default_paths())
    scan = _scan_python(py_files)
    scan["bucket_sets"].update(_yaml_bucket_sets(yaml_files))
    for key in ("entries", "compile_sites", "captures", "custom_ops"):
        scan[key].sort(key=lambda e: (e["file"], e["line"], e.get("name", e.get("target", ""))))
    buckets = sorted({b for vals in scan["bucket_sets"].values() for b in vals})
    return {
        "version": MANIFEST_VERSION,
        "entries": scan["entries"],
        "compile_sites": scan["compile_sites"],
        "captures": scan["captures"],
        "custom_ops": scan["custom_ops"],
        "bucket_sets": {k: scan["bucket_sets"][k] for k in sorted(scan["bucket_sets"])},
        "buckets": buckets,
        "plan_kinds": {k: scan["plan_kinds"][k] for k in sorted(scan["plan_kinds"])},
        "recompiles": 0,
    }


def load_manifest(path=None) -> Optional[dict]:
    p = Path(path) if path else MANIFEST_PATH
    if not p.is_file():
        return None
    return json.loads(p.read_text(encoding="utf-8"))


def entry_for(manifest: dict, file: str, line: int) -> Optional[dict]:
    """The manifest entry whose span holds a compiled code object's first
    line (``file`` repo-relative), or None."""
    for e in manifest.get("entries", ()):
        if e["file"] == file and e["line"] <= line <= e["end"]:
            return e
    return None


def covers(manifest: dict, plan_kind: str, bucket: int) -> bool:
    """Is (plan kind, bucket) inside the statically-declared surface?"""
    return plan_kind in manifest.get("plan_kinds", {}) and int(bucket) in set(
        manifest.get("buckets", ()))


def _dumps(manifest: dict) -> str:
    return json.dumps(manifest, indent=1, sort_keys=True) + "\n"


def _diff_lists(name, old, new, print_fn) -> int:
    o = {json.dumps(x, sort_keys=True) for x in old}
    n = {json.dumps(x, sort_keys=True) for x in new}
    bad = 0
    for item in sorted(n - o):
        print_fn(f"  + {name}: {item}")
        bad += 1
    for item in sorted(o - n):
        print_fn(f"  - {name}: {item}")
        bad += 1
    return bad


def run_exec_manifest(mode: str = "diff", paths=None, print_fn=print) -> int:
    """CLI: ``emit`` writes the manifest, ``print`` dumps it, ``diff``
    rebuilds and compares to the checked-in file — exit 1 on drift, with
    the drift itemized."""
    if mode not in ("emit", "diff", "print"):
        raise ValueError(f"unknown --exec-manifest mode {mode!r}; expected emit, diff or print")
    manifest = build_manifest(paths)
    if mode == "print":
        print_fn(_dumps(manifest).rstrip("\n"))
        return 0
    summary = (f"{len(manifest['entries'])} entries, "
               f"{len(manifest['compile_sites'])} compile sites, "
               f"{len(manifest['captures'])} captures, "
               f"{len(manifest['custom_ops'])} custom ops, "
               f"buckets {manifest['buckets']}, plan kinds {sorted(manifest['plan_kinds'])}")
    if mode == "emit":
        MANIFEST_PATH.write_text(_dumps(manifest), encoding="utf-8")
        print_fn(f"exec-manifest: wrote {_rel(MANIFEST_PATH)} ({summary})")
        return 0
    checked_in = load_manifest()
    if checked_in is None:
        print_fn(f"exec-manifest: {_rel(MANIFEST_PATH)} missing — run "
                 "--exec-manifest emit and commit it")
        return 1
    bad = 0
    for key in ("entries", "compile_sites", "captures", "custom_ops"):
        bad += _diff_lists(key, checked_in.get(key, []), manifest[key], print_fn)
    for key in ("bucket_sets", "plan_kinds"):
        old, new = checked_in.get(key, {}), manifest[key]
        for k in sorted(set(old) | set(new)):
            if old.get(k) != new.get(k):
                print_fn(f"  ~ {key}[{k}]: {old.get(k)} -> {new.get(k)}")
                bad += 1
    for key in ("buckets", "recompiles"):
        if checked_in.get(key) != manifest[key]:
            print_fn(f"  ~ {key}: {checked_in.get(key)} -> {manifest[key]}")
            bad += 1
    if bad:
        print_fn(f"exec-manifest: {bad} difference(s) vs {_rel(MANIFEST_PATH)} — the "
                 "compile surface changed; review and re-emit")
        return 1
    print_fn(f"exec-manifest: clean ({summary})")
    return 0
