#!/usr/bin/env python
"""Replay the JAX package's committed runs through turboprune_tpu_torch and
hold every level against the run's own CSV.

Usage:
    python scripts/replay_committed_runs_torch.py              # every run, on cuda
    python scripts/replay_committed_runs_torch.py --run <dir name under experiments/>
    python scripts/replay_committed_runs_torch.py --device cpu --run ...
    python scripts/replay_committed_runs_torch.py --keep experiments_torch
    python scripts/replay_committed_runs_torch.py --check <port experiment dir> [...] [--keep DIR]
    python scripts/replay_committed_runs_torch.py --curves <port experiment dir> [...]

Each directory under ``experiments/`` that holds an ``expt_config.yaml`` is
a JAX run of the package. Its config goes through the port's schema
(``adapt_config``): the key both schemas refuse is dropped, the keys the
run predates take the schema's defaults, ``base_dir`` moves under
``build/`` (relative to the working directory), and every other key stays
as committed. Each key dropped,
defaulted or set is printed. The run then goes through the port's entry
point, ``run_experiment_torch.main`` (``run_cyclic_training_experiment_torch.main``
where ``cyclic_training.num_cycles > 1``), and one table per run sets the
port's levels beside the JAX CSV's: zero counts (the ``sparsity`` column
times the prunable weights, rounded to whole weights) and test accuracy.
The CSV's times were taken on a TPU and are not printed.

A level's zero count must be k + t: k = int((1 - d) * n) from the port's
density ladder and t the weights tied at that prune's threshold (scores
equal to the k-th smallest, which ``score > threshold`` prunes too), read
back from the saved weights and masks of the level before. Its last-epoch
test accuracy must lie within 0.5 points of the CSV's. The number of levels
must be the CSV's. Any other outcome exits 1; a run that raises ends the
script with its traceback.

``--check`` holds finished port runs to the same count rule and to finite
losses at every epoch (``scripts/accuracy_runs_r5_torch.sh`` calls it after
each run); ``--curves`` prints the per-level accuracy of such runs side by
side, with each training type's gap to imp.
"""

from __future__ import annotations

import argparse
import copy
import csv
import math
import shutil
import sys
import time
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

EXPERIMENTS = REPO / "experiments"
BUILD = REPO / "build" / "replay_committed_runs_torch"
# Keys the JAX package's runs carry that both schemas refuse.
DROP = (("experiment_params", "log_every_steps"),)
# Points a level's last-epoch test accuracy may lie below the CSV's.
ACC_SLACK = 0.5


def committed_runs() -> list[Path]:
    return sorted(p.parent for p in EXPERIMENTS.glob("*/expt_config.yaml"))


def adapt_config(committed: dict, base_dir: str) -> tuple[dict, list, list]:
    """(config dict for the port's schema, dropped keys, defaulted keys with
    their values). A dropped key is one of ``DROP``; a defaulted key is a
    field of the port's schema the committed dict lacks (a whole missing
    group is reported leaf by leaf, a missing optional group as itself).
    ``experiment_params.base_dir`` is set to ``base_dir``; every other key
    keeps its committed value."""
    from turboprune_tpu_torch.config.schema import MainConfig, config_to_dict

    out = copy.deepcopy(committed)
    dropped = []
    for group, key in DROP:
        if key in (out.get(group) or {}):
            del out[group][key]
            dropped.append(f"{group}.{key}")
    defaulted: list = []

    def fill(node: dict, defaults: dict, prefix: str) -> None:
        for key, value in defaults.items():
            if key not in node:
                node[key] = copy.deepcopy(value)
                if isinstance(value, dict):
                    defaulted.extend(_leaves(value, f"{prefix}{key}."))
                else:
                    defaulted.append((f"{prefix}{key}", value))
            elif isinstance(value, dict) and isinstance(node[key], dict):
                fill(node[key], value, f"{prefix}{key}.")

    fill(out, config_to_dict(MainConfig()), "")
    out["experiment_params"]["base_dir"] = base_dir
    return out, dropped, defaulted


def _leaves(tree: dict, prefix: str) -> list:
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out.extend(_leaves(value, f"{prefix}{key}."))
        else:
            out.append((f"{prefix}{key}", value))
    return out


def read_csv(path: Path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def summary_rows(expt_dir: Path) -> list[dict]:
    (path,) = sorted(Path(expt_dir, "metrics").glob("*_summary.csv"))
    return read_csv(path)


def zeros_of(row: dict, n: int) -> int:
    """Whole masked-out weights of a summary row: sparsity (percent) x n."""
    return round(float(row["sparsity"]) / 100.0 * n)


def level_counts(expt_dir: Path) -> tuple[int, list[dict]]:
    """(prunable weights n, one dict per level of a finished port run:
    level, density, k, t, and the zeros of its saved masks). Level L's k and
    t are those of magnitude pruning the saved level L - 1 to the ladder's
    density d_L; level 0 prunes nothing."""
    from turboprune_tpu_torch.ops import masking
    from turboprune_tpu_torch.pruning import generate_densities, mag_scores
    from turboprune_tpu_torch.utils import ExperimentCheckpoints, model_state_dict
    from turboprune_tpu_torch.utils.experiment import load_config

    cfg = load_config(expt_dir)
    pp = cfg.pruning_params
    if pp.prune_method != "mag" or pp.training_type == "at_init":
        raise ValueError(f"{expt_dir}: the count rule holds iterative magnitude runs, "
                         f"not {pp.prune_method} / {pp.training_type}")
    ladder = generate_densities(pp.prune_method, pp.target_sparsity, pp.prune_rate)
    ckpts = ExperimentCheckpoints(expt_dir)
    levels = ckpts.saved_levels()
    if levels != list(range(len(levels))):
        raise ValueError(f"{expt_dir}: saved levels {levels} are not 0..L")
    out = []
    before = None
    n = 0
    for level in levels:
        tree = ckpts.load_level(level)
        n = masking.num_prunable(tree["masks"])
        k, t = (0, 0) if before is None else masking.global_threshold_counts(
            mag_scores(model_state_dict(before), before["masks"]), ladder[level])
        zeros = n - sum(int(m.sum()) for m in tree["masks"].values())
        out.append({"level": level, "density": ladder[level], "k": k, "t": t, "zeros": zeros})
        before = tree
    return n, out


def check_run(expt_dir: Path) -> tuple[int, list[dict], list[str]]:
    """A finished port run against the count rule and finite losses:
    (prunable weights, per-level rows with the summary's accuracy,
    failures)."""
    expt_dir = Path(expt_dir)
    n, counts = level_counts(expt_dir)
    rows = summary_rows(expt_dir)
    failures = []
    if len(rows) != len(counts):
        failures.append(f"{len(rows)} summary rows, {len(counts)} saved levels")
    for c, row in zip(counts, rows):
        c["csv_zeros"] = zeros_of(row, n)
        c["test_acc"] = float(row["test_acc"])
        c["max_test_acc"] = float(row["max_test_acc"])
        if not c["zeros"] == c["csv_zeros"] == c["k"] + c["t"]:
            failures.append(f"level {c['level']}: {c['zeros']} zeros in the masks, "
                            f"{c['csv_zeros']} by the CSV, k + t = {c['k']} + {c['t']}")
    for level_csv in sorted((expt_dir / "metrics" / "level_wise_metrics").glob("level_*.csv")):
        for r in read_csv(level_csv):
            losses = (float(r["train_loss"]), float(r["test_loss"]))
            if not all(map(math.isfinite, losses)):
                failures.append(f"{level_csv.name} epoch {r['epoch']}: losses {losses}")
    return n, counts, failures


def _table(header: list[str], rows: list[list]) -> str:
    lines = ["| " + " | ".join(header) + " |", "|" + "---|" * len(header)]
    lines += ["| " + " | ".join(str(v) for v in r) + " |" for r in rows]
    return "\n".join(lines)


def compare(jax_dir: Path, port_dir: Path) -> list[str]:
    """Print the replay's table beside the JAX run's CSV; returns failures."""
    n, counts, failures = check_run(port_dir)
    jax_rows = summary_rows(jax_dir)
    if len(jax_rows) != len(counts):
        failures.append(f"{len(counts)} levels, the JAX CSV has {len(jax_rows)}")
    rows = []
    for c, jr in zip(counts, jax_rows):
        jz = zeros_of(jr, n)
        jacc = float(jr["test_acc"])
        rows.append([c["level"], f"{c['density']:.6f}", f"{jz:,}", f"{c['zeros']:,}",
                     f"{c['zeros'] - jz:+d}", f"{c['k']:,}", c["t"], jr["test_acc"],
                     c["test_acc"], c["max_test_acc"]])
        if c["test_acc"] < jacc - ACC_SLACK:
            failures.append(f"level {c['level']}: test_acc {c['test_acc']} more than "
                            f"{ACC_SLACK} points below the JAX CSV's {jacc}")
    print(f"{jax_dir.name}: {n:,} prunable weights; port run {port_dir}")
    print(_table(["level", "density", "JAX zeros", "port zeros", "difference", "k",
                  "t (port ties)", "JAX test_acc", "port test_acc", "port max_test_acc"],
                 rows), flush=True)
    return failures


def replay(jax_dir: Path, device: str) -> Path:
    """Run the committed config of ``jax_dir`` through the port's entry
    point; returns the port's experiment dir."""
    import run_cyclic_training_experiment_torch
    import run_experiment_torch

    work = BUILD / jax_dir.name
    if work.exists():
        shutil.rmtree(work)
    committed = yaml.safe_load((jax_dir / "expt_config.yaml").read_text())
    # Relative to the working directory where it lies below it, so the
    # config a run saves names no path of the machine it ran on.
    runs = work / "runs"
    if runs.resolve().is_relative_to(Path.cwd()):
        runs = runs.resolve().relative_to(Path.cwd())
    cfg, dropped, defaulted = adapt_config(committed, str(runs))
    print(f"[replay] {jax_dir.name}")
    print(f"[replay]   dropped: {', '.join(dropped) or 'none'}")
    print("[replay]   defaulted: " + (", ".join(f"{k}={v!r}" for k, v in defaulted) or "none"))
    print(f"[replay]   set: experiment_params.base_dir={cfg['experiment_params']['base_dir']!r}",
          flush=True)
    conf = work / "conf"
    conf.mkdir(parents=True)
    (conf / "replay.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    cyclic = cfg["cyclic_training"]["num_cycles"] > 1
    entry = run_cyclic_training_experiment_torch if cyclic else run_experiment_torch
    t0 = time.perf_counter()
    rc = entry.main(["--device", device, "--config-path", str(conf), "--config-name=replay"])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{entry.__name__}.main returned {rc}")
    (port_dir,) = [d for d in (work / "runs").iterdir() if d.is_dir()]
    print(f"[replay] {jax_dir.name}: {entry.__name__}.main took {seconds:.1f} s", flush=True)
    return port_dir


def keep(port_dir: Path, dest: Path) -> None:
    """Copy a run's config and its metric CSVs (no checkpoints) to ``dest``."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy2(port_dir / "expt_config.yaml", dest / "expt_config.yaml")
    for path in sorted((port_dir / "metrics").rglob("*.csv")):
        target = dest / path.relative_to(port_dir)
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(path, target)


def curves(dirs: list[Path]) -> str:
    """The per-level last-epoch / max test accuracy of finished runs of one
    ladder, one column pair per training type, and each type's last-epoch
    gap to imp (a cyclic run is "cyclic")."""
    from turboprune_tpu_torch.utils.experiment import load_config

    runs = {}
    for d in dirs:
        cfg = load_config(d)
        kind = ("cyclic" if cfg.cyclic_training.num_cycles > 1
                else cfg.pruning_params.training_type)
        runs[kind] = summary_rows(d)
    kinds = [k for k in ("imp", "wr", "lrr", "cyclic") if k in runs] + sorted(
        set(runs) - {"imp", "wr", "lrr", "cyclic"})
    levels = max(len(r) for r in runs.values())
    header = ["level", "density"] + [f"{k} last / max" for k in kinds]
    header += [f"{k} - imp" for k in kinds if k != "imp" and "imp" in runs]
    rows = []
    for level in range(levels):
        row = [level, ""]
        for k in kinds:
            r = runs[k][level] if level < len(runs[k]) else None
            if r is not None:
                row[1] = row[1] or f"{float(r['density']):.4f}"
            row.append(f"{float(r['test_acc']):.2f} / {float(r['max_test_acc']):.2f}"
                       if r else "")
        if "imp" in runs and level < len(runs["imp"]):
            base = float(runs["imp"][level]["test_acc"])
            for k in kinds:
                if k != "imp":
                    r = runs[k][level] if level < len(runs[k]) else None
                    row.append(f"{float(r['test_acc']) - base:+.2f}" if r else "")
        rows.append(row)
    return _table(header, rows)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--run", action="append", default=[],
                        help="a directory name under experiments/ (repeatable; default: all)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--keep", default="",
                        help="copy each run's config and CSVs to KEEP/<name>: a replay's "
                             "JAX dir name, a checked run's own")
    parser.add_argument("--check", nargs="+", default=None, metavar="EXPT_DIR",
                        help="hold finished port runs to k + t and finite losses")
    parser.add_argument("--curves", nargs="+", default=None, metavar="EXPT_DIR",
                        help="print finished runs' per-level accuracy side by side")
    args = parser.parse_args(argv)

    if args.curves:
        print(curves([Path(d) for d in args.curves]))
        return 0
    failures = []
    if args.check:
        for d in map(Path, args.check):
            _, counts, failed = check_run(d)
            print(f"{d}:")
            print(_table(["level", "density", "zeros", "k", "t", "test_acc", "max_test_acc"],
                         [[c["level"], f"{c['density']:.6f}", f"{c['zeros']:,}", f"{c['k']:,}",
                           c["t"], c["test_acc"], c["max_test_acc"]] for c in counts]))
            failures += [f"{d.name}: {f}" for f in failed]
            if args.keep:
                keep(d, Path(args.keep) / d.name)
    else:
        known = {d.name: d for d in committed_runs()}
        unknown = sorted(set(args.run) - set(known))
        if unknown:
            parser.error(f"no committed run {unknown}; known: {sorted(known)}")
        for name in args.run or sorted(known):
            port_dir = replay(known[name], args.device)
            failures += [f"{name}: {f}" for f in compare(known[name], port_dir)]
            if args.keep:
                keep(port_dir, Path(args.keep) / name)
    for f in failures:
        print(f"FAIL {f}")
    print("replay: " + ("every level holds" if not failures else f"{len(failures)} failure(s)"))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
