"""Hydra-style config composition without the hydra dependency (the
port's copy of ``turboprune_tpu/config/compose.py``, reading the same
``conf/`` tree).

The reference drives experiments with ``@hydra.main(config_path="conf")``
composing six config groups (/root/reference/run_experiment.py:21,
conf/cifar10_er_erk.yaml:1-8). This module reimplements the subset actually
used — a top-level yaml with a ``defaults`` list of ``group: option`` entries,
group files under ``conf/<group>/<option>.yaml``, and dotted CLI overrides
``group.key=value`` — as ~100 lines of stdlib+pyyaml, then validates the
result against the typed schema (which the reference never did).
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Optional, Sequence

import yaml

from .schema import ConfigError, MainConfig, config_from_dict

DEFAULT_CONFIG_PATH = Path(__file__).resolve().parents[2] / "conf"


class _StrictLoader(yaml.SafeLoader):
    """SafeLoader that REJECTS duplicate mapping keys.

    pyyaml's default quietly keeps the last occurrence — a config-drift
    trap: the overridden value vanishes with no trace, and once the loser
    key is gone not even static analysis can see it was ever there
    (graftlint's conf-duplicate-key catches the file at rest; this catches
    it at compose time, including configs loaded from outside conf/)."""

    def construct_mapping(self, node, deep=False):
        seen: dict = {}
        for key_node, _value_node in node.value:
            key = self.construct_object(key_node, deep=True)
            try:
                hash(key)
            except TypeError:
                continue  # unhashable: let the base constructor complain
            line = key_node.start_mark.line + 1
            if key in seen:
                raise ConfigError(
                    f"duplicate config key {key!r} (lines {seen[key]} and "
                    f"{line}) — yaml would silently keep only the last value"
                )
            seen[key] = line
        return super().construct_mapping(node, deep)


def _load_yaml(path: Path) -> dict:
    if not path.exists():
        raise ConfigError(f"config file not found: {path}")
    with open(path) as f:
        try:
            data = yaml.load(f, Loader=_StrictLoader) or {}
        except ConfigError as e:
            raise ConfigError(f"{path}: {e}") from e
    if not isinstance(data, dict):
        raise ConfigError(f"config file {path} must contain a mapping")
    return data


def _deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_override(item: str) -> tuple[list[str], object]:
    if "=" not in item:
        raise ConfigError(f"override {item!r} must look like group.key=value")
    key, _, raw = item.partition("=")
    value = yaml.safe_load(raw) if raw != "" else ""
    return key.strip().split("."), value


def _set_dotted(tree: dict, keys: list[str], value) -> None:
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ConfigError(f"cannot override through non-mapping key {k!r}")
    node[keys[-1]] = value


def compose_dict(
    config_name: str,
    overrides: Sequence[str] = (),
    config_path: Optional[Path] = None,
) -> dict:
    """Compose the raw config dict (pre-validation)."""
    root = Path(config_path) if config_path else DEFAULT_CONFIG_PATH
    name = config_name[:-5] if config_name.endswith(".yaml") else config_name
    top = _load_yaml(root / f"{name}.yaml")
    defaults = top.pop("defaults", [])

    # Hydra semantics: group selection happens before value overrides,
    # regardless of argv order — a dotted override must never be clobbered
    # by a group override that appears later on the command line.
    group_overrides: dict[str, str] = {}
    group_appends: dict[str, str] = {}
    dotted: list[tuple[list[str], object]] = []
    for item in overrides:
        appending = item.startswith("+")
        keys, value = _parse_override(item[1:] if appending else item)
        if len(keys) == 1 and isinstance(value, str) and (root / keys[0]).is_dir():
            (group_appends if appending else group_overrides)[keys[0]] = value
        elif appending:
            raise ConfigError(
                f"+{keys[0]} is not a config group under {root}"
            )
        else:
            dotted.append((keys, value))

    # A CLI group override substitutes WHICH option file the defaults list
    # names for that group; composition still runs in defaults-list order,
    # so values the primary config sets directly (its _self_ position) keep
    # their Hydra precedence instead of being wholesale-discarded.
    resolved: list = []
    seen_groups = set()
    for entry in defaults:
        if entry == "_self_":
            resolved.append(entry)
            continue
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ConfigError(f"defaults entry {entry!r} must be 'group: option'")
        (group, option), = entry.items()
        seen_groups.add(group)
        resolved.append({group: group_overrides.get(group, option)})
    missing = set(group_overrides) - seen_groups
    if missing:
        # Hydra semantics: overriding a group the defaults list doesn't
        # select is an error; '+group=option' appends explicitly.
        raise ConfigError(
            f"config group(s) {sorted(missing)} are not in {name}.yaml's "
            f"defaults list — use '+<group>=<option>' to add one"
        )
    for group, option in group_appends.items():
        if group in seen_groups:
            raise ConfigError(
                f"+{group}={option}: group already in the defaults list — "
                f"override it with '{group}={option}' (no plus)"
            )
        resolved.append({group: option})

    merged: dict = {}
    self_merged = False
    for entry in resolved:
        if entry == "_self_":
            merged = _deep_merge(merged, top)
            self_merged = True
            continue
        (group, option), = entry.items()
        if option is None:
            continue
        group_cfg = _load_yaml(root / group / f"{option}.yaml")
        merged = _deep_merge(merged, {group: group_cfg})
    if not self_merged:
        merged = _deep_merge(merged, top)

    for keys, value in dotted:
        _set_dotted(merged, keys, value)
    return merged


def compose(
    config_name: str,
    overrides: Sequence[str] = (),
    config_path: Optional[Path] = None,
) -> MainConfig:
    """Compose and validate a full MainConfig."""
    return config_from_dict(compose_dict(config_name, overrides, config_path))
