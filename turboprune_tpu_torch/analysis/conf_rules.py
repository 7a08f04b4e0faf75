"""Config static analysis: ``conf/**/*.yaml`` cross-checked against the
schema dataclasses — without importing either.

The port reads the same ``conf/`` tree as the JAX package through its
own copy of the schema (turboprune_tpu_torch/config/schema.py) and
validates at COMPOSE time, but compose-time validation only sees the configs a
run actually composes: a typo'd key in a group file nobody smoke-tested,
a ``defaults:`` entry pointing at a deleted option file, or a schema
field no code ever reads all survive until the one run that needed them.
These rules close that gap statically: every yaml under conf/ is checked
against the schema ON EVERY LINT, config composed or not.

Everything is AST/yaml-node based — the schema is parsed, not imported
(importing config.schema would drag in the package and, transitively,
torch; this package's contract is stdlib+pyyaml only). The cost of that
choice: only statically-decidable facts are checked (literal values
against literal choice sets, yaml node types against annotation names),
which is exactly the niche compose-time validation cannot cover anyway.

Rules (the JAX package's six, with the same findings on the same inputs;
tests/test_torch_analysis.py holds the two equal):

* ``conf-duplicate-key``     — a mapping key repeated (pyyaml keeps the
  LAST silently; the loser value vanishes with no trace)
* ``conf-unknown-key``       — key absent from the group's dataclass
* ``conf-bad-choice``        — literal value outside the field's
  ``_check_choice`` set (PRUNE_METHODS, OPTIMIZERS, ...)
* ``conf-type-mismatch``     — yaml value that the schema's coercion
  (``config/schema.py:_coerce``) would reject or silently mistype
* ``conf-missing-group-file``— ``defaults:`` entry naming a group option
  with no ``conf/<group>/<option>.yaml`` behind it
* ``conf-dead-schema-field`` — a schema field no code outside
  config/schema.py ever reads via attribute access (validated-but-unused
  config surface; waive at the field with the dynamic access path if one
  exists)

Waivers work in YAML too: ``# torchlint: disable=<rule> -- reason`` on
the offending line (or alone on the line above it), same syntax and the
same stale-waiver accounting as Python comments.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Optional

import yaml

from .core import Finding, Waiver, _WAIVER_RE

__all__ = ["CONF_RULES", "SchemaModel", "analyze_conf", "parse_yaml_waivers"]


@dataclasses.dataclass(frozen=True)
class ConfRule:
    id: str
    severity: str
    description: str
    # Why the hazard matters — the README catalog column `--rule-docs`
    # generates, same contract as Rule.doc_why.
    doc_why: str = ""


CONF_RULES = {
    r.id: r
    for r in [
        ConfRule(
            "conf-duplicate-key",
            "error",
            "duplicate mapping key in a config yaml — pyyaml silently "
            "keeps the last one and the earlier value vanishes",
            "the earlier value looks set in the file but never applies — "
            "an invisible override",
        ),
        ConfRule(
            "conf-unknown-key",
            "error",
            "config key not present in the group's schema dataclass — "
            "the knob silently does nothing",
            "the silent no-op config knob: accepted, validated and "
            "ignored, the fault class the port has hit before",
        ),
        ConfRule(
            "conf-bad-choice",
            "error",
            "literal config value outside the field's declared choice set "
            "(PRUNE_METHODS, OPTIMIZERS, ...)",
            "fails deep in the run (or never, with a fallback) instead "
            "of at compose time",
        ),
        ConfRule(
            "conf-type-mismatch",
            "error",
            "yaml value whose type the schema field cannot coerce "
            "(per config/schema.py:_coerce semantics)",
            "coercion surprises surface as shape/dtype errors far from "
            "the yaml line that caused them",
        ),
        ConfRule(
            "conf-missing-group-file",
            "error",
            "defaults: entry pointing at a conf/<group>/<option>.yaml "
            "that does not exist",
            "composition fails at runtime on a path typo that was "
            "knowable statically",
        ),
        ConfRule(
            "conf-dead-schema-field",
            "warning",
            "schema dataclass field never read via attribute access by "
            "any code outside config/schema.py — dead config surface",
            "a knob wired to nothing misleads every future reader into "
            "tuning it",
        ),
    ]
}


# ------------------------------------------------------------ yaml waivers


def parse_yaml_waivers(source: str, file: str) -> list:
    """``# torchlint: disable=...`` comments in a yaml file. Line-based
    (yaml comments can't be tokenized like Python's, and ``#`` inside
    quoted scalars is rare enough in config files to accept the risk):
    an inline comment waives its own line, a comment-only line waives the
    next non-blank, non-comment line."""
    lines = source.splitlines()
    waivers = []
    for i, line in enumerate(lines, start=1):
        hash_pos = line.find("#")
        if hash_pos < 0:
            continue
        m = _WAIVER_RE.search(line[hash_pos:])
        if not m:
            continue
        rules = frozenset(r.strip() for r in m.group(1).split(","))
        standalone = line.strip().startswith("#")
        applies_to = i
        if standalone:
            for j in range(i + 1, len(lines) + 1):
                nxt = lines[j - 1].strip()
                if nxt and not nxt.startswith("#"):
                    applies_to = j
                    break
        waivers.append(
            Waiver(
                file=file,
                line=i,
                rules=rules,
                reason=m.group(2),
                applies_to=applies_to,
            )
        )
    return waivers


# ----------------------------------------------------------- schema model


@dataclasses.dataclass
class FieldSpec:
    name: str
    annotation: str
    line: int
    choices: Optional[tuple] = None  # literal choice set when validated


@dataclasses.dataclass
class SchemaModel:
    """The schema file, statically parsed: choice sets, dataclasses with
    their field specs, and the MainConfig group -> dataclass mapping."""

    path: str
    choice_sets: dict = dataclasses.field(default_factory=dict)
    dataclasses_: dict = dataclasses.field(default_factory=dict)
    # MainConfig field name -> dataclass name ("dataset_params" -> ...)
    groups: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, tree: ast.Module) -> Optional["SchemaModel"]:
        model = cls(path=str(path))
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                values = _literal_tuple(node.value)
                if isinstance(t, ast.Name) and values is not None:
                    model.choice_sets[t.id] = values
            elif isinstance(node, ast.ClassDef) and _is_dataclass(node):
                model._parse_dataclass(node)
        if "MainConfig" not in model.dataclasses_:
            return None
        for spec in model.dataclasses_["MainConfig"].values():
            inner = _strip_optional(spec.annotation)
            if inner in model.dataclasses_:
                model.groups[spec.name] = inner
        return model

    def _parse_dataclass(self, node: ast.ClassDef) -> None:
        fields: dict = {}
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                fields[stmt.target.id] = FieldSpec(
                    name=stmt.target.id,
                    annotation=_ann_str(stmt.annotation),
                    line=stmt.lineno,
                )
            elif (
                isinstance(stmt, ast.FunctionDef) and stmt.name == "validate"
            ):
                self._parse_choices(stmt, fields)
        self.dataclasses_[node.name] = fields

    def _parse_choices(self, fn: ast.FunctionDef, fields: dict) -> None:
        for node in ast.walk(fn):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "_check_choice"
                and len(node.args) >= 3
            ):
                continue
            target = node.args[1]
            if not (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
                and target.attr in fields
            ):
                continue
            choices_node = node.args[2]
            if isinstance(choices_node, ast.Name):
                choices = self.choice_sets.get(choices_node.id)
            else:
                choices = _literal_tuple(choices_node)
            if choices:
                fields[target.attr] = dataclasses.replace(
                    fields[target.attr], choices=choices
                )


def _is_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        name = dec
        if isinstance(dec, ast.Call):
            name = dec.func
        if isinstance(name, ast.Name) and name.id == "dataclass":
            return True
        if isinstance(name, ast.Attribute) and name.attr == "dataclass":
            return True
    return False


def _ann_str(node: ast.AST) -> str:
    return ast.unparse(node)


def _strip_optional(ann: str) -> str:
    ann = ann.strip().strip("\"'")
    m = re.fullmatch(r"(?:typing\.)?Optional\[(.+)\]", ann)
    return m.group(1).strip() if m else ann


def _literal_tuple(node: ast.AST) -> Optional[tuple]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if not isinstance(elt, ast.Constant):
                return None
            out.append(elt.value)
        return tuple(out)
    return None


def find_schema(contexts: dict) -> Optional[SchemaModel]:
    """The schema module among the analyzed files: any module whose AST
    defines a dataclass named MainConfig (config/schema.py here, a
    look-alike in fixture suites)."""
    for path, ctx in contexts.items():
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == "MainConfig":
                model = SchemaModel.parse(path, ctx.tree)
                if model is not None:
                    return model
    return None


# -------------------------------------------------------- type compatibility


def _int_like(value) -> bool:
    if isinstance(value, bool):
        return True  # bool subclasses int; _coerce passes it through
    if isinstance(value, int):
        return True
    if isinstance(value, str):
        try:
            int(value)
            return True
        except ValueError:
            return False
    return False


def _float_like(value) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, (int, float)):
        return True
    if isinstance(value, str):
        # YAML 1.1 reads 5e-4 as a str; _coerce float()s it
        try:
            float(value)
            return True
        except ValueError:
            return False
    return False


def _bool_like(value) -> bool:
    return isinstance(value, bool) or (
        isinstance(value, str) and value.lower() in ("true", "false")
    )


def _type_problem(spec: FieldSpec, value, model: SchemaModel) -> Optional[str]:
    """Why ``value`` cannot inhabit the field, or None when it can
    (mirrors config/schema.py:_coerce leniency exactly — a finding here
    means compose WOULD fail or silently mistype)."""
    ann = spec.annotation.strip().strip("\"'")
    optional = ann != (base := _strip_optional(ann))
    if value is None:
        if optional:
            return None
        return f"null is not a valid {ann}"
    if base in model.dataclasses_:
        if not isinstance(value, dict):
            return f"expected a mapping ({base}), got {type(value).__name__}"
        return None
    if base == "int":
        if not _int_like(value):
            return f"{value!r} is not coercible to int"
    elif base == "float":
        if not _float_like(value):
            return f"{value!r} is not coercible to float"
    elif base == "bool":
        if not _bool_like(value):
            return f"{value!r} is not a bool"
    elif base == "str":
        if not isinstance(value, str):
            return (
                f"{value!r} ({type(value).__name__}) where the schema "
                "declares str — quote it if it is meant literally"
            )
    elif base == "list" or base.startswith("list["):
        if not isinstance(value, list):
            return f"expected a sequence, got {type(value).__name__}"
    return None


# ------------------------------------------------------------- yaml walking


def _conf_finding(file, line, rule_id: str, message: str) -> Finding:
    rule = CONF_RULES[rule_id]
    return Finding(
        file=str(file),
        line=line,
        col=0,
        rule=rule_id,
        severity=rule.severity,
        message=message,
    )


class _NodeLoader(yaml.SafeLoader):
    """SafeLoader used only to compose nodes / construct sub-values."""


def _compose(source: str):
    loader = _NodeLoader(source)
    try:
        return loader, loader.get_single_node()
    finally:
        loader.dispose()


def _mapping_items(node):
    """(key_str, key_line, value_node) for a yaml MappingNode."""
    if not isinstance(node, yaml.MappingNode):
        return []
    out = []
    for key_node, value_node in node.value:
        if isinstance(key_node, yaml.ScalarNode):
            out.append(
                (key_node.value, key_node.start_mark.line + 1, value_node)
            )
    return out


def _construct(loader, node):
    try:
        return loader.construct_object(node, deep=True)
    except yaml.YAMLError:
        return None


def _duplicate_key_findings(file, node) -> list:
    findings = []
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, yaml.MappingNode):
            seen: dict = {}
            for key_node, value_node in n.value:
                stack.append(value_node)
                if not isinstance(key_node, yaml.ScalarNode):
                    continue
                k = key_node.value
                line = key_node.start_mark.line + 1
                if k in seen:
                    findings.append(
                        _conf_finding(
                            file,
                            line,
                            "conf-duplicate-key",
                            f"key {k!r} already defined at line {seen[k]} — "
                            "pyyaml keeps only this occurrence and the "
                            "earlier value silently vanishes",
                        )
                    )
                else:
                    seen[k] = line
        elif isinstance(n, yaml.SequenceNode):
            stack.extend(n.value)
    return findings


def _check_group_mapping(
    file, loader, node, cls_name: str, model: SchemaModel, where: str
) -> list:
    """Keys/values of one mapping against one dataclass's fields."""
    findings = []
    fields = model.dataclasses_.get(cls_name, {})
    for key, line, value_node in _mapping_items(node):
        if key == "defaults":
            continue  # composition machinery, checked separately
        if key not in fields:
            known = ", ".join(sorted(fields)) or "<none>"
            findings.append(
                _conf_finding(
                    file,
                    line,
                    "conf-unknown-key",
                    f"{where}: {key!r} is not a field of {cls_name} — the "
                    f"knob silently does nothing (known: {known})",
                )
            )
            continue
        spec = fields[key]
        value = _construct(loader, value_node)
        vline = value_node.start_mark.line + 1
        if spec.choices is not None and isinstance(value, str):
            if value not in spec.choices:
                findings.append(
                    _conf_finding(
                        file,
                        vline,
                        "conf-bad-choice",
                        f"{where}.{key} = {value!r} not in "
                        f"{tuple(spec.choices)}",
                    )
                )
                continue
        problem = _type_problem(spec, value, model)
        if problem is not None:
            findings.append(
                _conf_finding(
                    file,
                    vline,
                    "conf-type-mismatch",
                    f"{where}.{key} (declared {spec.annotation}): {problem}",
                )
            )
        elif isinstance(value, dict):
            inner = _strip_optional(spec.annotation)
            if inner in model.dataclasses_:
                findings.extend(
                    _check_group_mapping(
                        file,
                        loader,
                        value_node,
                        inner,
                        model,
                        f"{where}.{key}",
                    )
                )
    return findings


def _check_defaults(file, loader, node, conf_root, model) -> list:
    """The ``defaults:`` list of a top-level config."""
    findings = []
    for key, line, value_node in _mapping_items(node):
        if key != "defaults":
            continue
        if not isinstance(value_node, yaml.SequenceNode):
            findings.append(
                _conf_finding(
                    file,
                    line,
                    "conf-type-mismatch",
                    "defaults must be a list of 'group: option' entries",
                )
            )
            continue
        for entry in value_node.value:
            eline = entry.start_mark.line + 1
            if isinstance(entry, yaml.ScalarNode):
                if entry.value != "_self_":
                    findings.append(
                        _conf_finding(
                            file,
                            eline,
                            "conf-type-mismatch",
                            f"defaults entry {entry.value!r} must be "
                            "'_self_' or 'group: option'",
                        )
                    )
                continue
            items = _mapping_items(entry)
            if len(items) != 1:
                findings.append(
                    _conf_finding(
                        file,
                        eline,
                        "conf-type-mismatch",
                        "defaults entry must be a single 'group: option'",
                    )
                )
                continue
            group, gline, option_node = items[0]
            if model is not None and group not in model.groups:
                findings.append(
                    _conf_finding(
                        file,
                        gline,
                        "conf-unknown-key",
                        f"defaults group {group!r} is not a MainConfig "
                        f"field (known groups: "
                        f"{', '.join(sorted(model.groups))})",
                    )
                )
                continue
            option = _construct(loader, option_node)
            if option is None:
                continue  # 'group: null' disables the group
            target = Path(conf_root) / group / f"{option}.yaml"
            if not target.exists():
                findings.append(
                    _conf_finding(
                        file,
                        gline,
                        "conf-missing-group-file",
                        f"defaults entry '{group}: {option}' points at "
                        f"missing {target}",
                    )
                )
    return findings


def _dead_field_findings(model: SchemaModel, contexts: dict) -> list:
    """Schema fields never read via attribute access outside the schema
    module itself. validate()-only reads deliberately do NOT count as
    uses — a field that is checked but never consumed is exactly the
    validated-but-dead surface this rule exists to expose."""
    read_attrs: set = set()
    for path, ctx in contexts.items():
        if path == model.path:
            continue
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute) and isinstance(
                getattr(node, "ctx", None), ast.Load
            ):
                read_attrs.add(node.attr)
    findings = []
    for cls_name, fields in model.dataclasses_.items():
        for spec in fields.values():
            if spec.name in read_attrs:
                continue
            findings.append(
                _conf_finding(
                    model.path,
                    spec.line,
                    "conf-dead-schema-field",
                    f"{cls_name}.{spec.name} is never read via attribute "
                    "access outside the schema module — dead config "
                    "surface (drop it, or waive with the dynamic access "
                    "path that consumes it)",
                )
            )
    return findings


# ---------------------------------------------------------------- driver


def analyze_conf(yaml_files, contexts: dict) -> tuple:
    """``(findings, waivers)`` for ``[(yaml_path, conf_root), ...]``.

    ``contexts`` (path -> parsed module) supplies the schema — any module
    defining a MainConfig dataclass — and the package trees for the
    dead-field scan. Without a schema only the schema-independent rules
    run (duplicate keys, defaults-entry shape)."""
    model = find_schema(contexts)
    findings: list = []
    waivers: list = []
    for path, conf_root in yaml_files:
        source = Path(path).read_text(encoding="utf-8")
        waivers.extend(parse_yaml_waivers(source, str(path)))
        try:
            loader, node = _compose(source)
        except yaml.YAMLError as e:
            mark = getattr(e, "problem_mark", None)
            findings.append(
                Finding(
                    file=str(path),
                    line=(mark.line + 1) if mark else 1,
                    col=0,
                    rule="parse-error",
                    severity="error",
                    message=f"yaml does not parse: {e}",
                )
            )
            continue
        if node is None:
            continue  # empty file
        findings.extend(_duplicate_key_findings(path, node))
        if not isinstance(node, yaml.MappingNode):
            findings.append(
                _conf_finding(
                    path, 1, "conf-type-mismatch",
                    "config file must contain a mapping",
                )
            )
            continue
        rel = _relparts(path, conf_root)
        if model is None:
            findings.extend(
                _check_defaults(path, loader, node, conf_root, None)
            )
            continue
        if len(rel) >= 2:
            group = rel[0]
            if group not in model.groups:
                findings.append(
                    _conf_finding(
                        path,
                        1,
                        "conf-unknown-key",
                        f"config group directory {group!r} does not match "
                        "any MainConfig field (known groups: "
                        f"{', '.join(sorted(model.groups))})",
                    )
                )
            else:
                findings.extend(
                    _check_group_mapping(
                        path, loader, node, model.groups[group], model, group
                    )
                )
        else:
            findings.extend(
                _check_defaults(path, loader, node, conf_root, model)
            )
            findings.extend(
                _check_group_mapping(
                    path, loader, node, "MainConfig", model, rel[-1]
                )
            )
    if model is not None and yaml_files:
        findings.extend(_dead_field_findings(model, contexts))
    return findings, waivers


def _relparts(path, conf_root) -> tuple:
    try:
        return Path(path).relative_to(conf_root).parts
    except ValueError:
        return (Path(path).name,)
