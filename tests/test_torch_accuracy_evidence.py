"""The evidence behind ``scripts/replay_committed_runs_torch.py``, on the CPU.

- The config adapter: each committed ``experiments/*/expt_config.yaml`` of
  the JAX package loads through the port's schema once the adapter has
  dropped the key both schemas refuse and filled the keys the run predates
  with the schema's defaults; every key it keeps equals the committed
  value, and it reports exactly what it dropped and defaulted.
- The ladder's counts: a full-width CIFAR ResNet-18 (11,164,352 prunable
  weights) from one seeded init, handed to both packages through
  ``bridge.py``, magnitude-pruned level after level with no training. At
  prune rate 0.44 both packages' ladders have 4 levels to sparsity 0.69
  and 5 to 0.9, their masks are equal at every level, and each level holds
  exactly k = int((1 - d) * n) zeros: 4,912,314 / 7,663,211 / 9,203,713 /
  10,066,394 (no weight of this init ties at a threshold).
- The committed CSVs: their ``sparsity`` columns decode to whole counts.
  The three runs to 0.69 read k at every level. The run to 0.9 reads k
  but at level 3, which reads k + 1 = 9,203,714: one trained weight equal
  to the k-th smallest score, which ``score > threshold`` prunes with it.
  So a trained level holds k + t zeros, t the weights tied at the
  threshold: the rule the replay script applies.
- The rule on a planted case: a width-8 ResNet-18 with one weight set
  equal to the k-th smallest magnitude holds t = 1 and k + 1 zeros after
  pruning, in both packages, with equal masks.
"""

import csv
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import run_once, seeded_variables
from turboprune_tpu.models import resnet as jresnet
from turboprune_tpu.ops import masking as jmasking
from turboprune_tpu.pruning import generate_densities as jax_generate_densities
from turboprune_tpu.pruning.criteria import prune_mag as jax_prune_mag
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.config.schema import MainConfig, config_from_dict, config_to_dict
from turboprune_tpu_torch.ops import masking
from turboprune_tpu_torch.pruning import generate_densities, mag_scores, prune_mag

REPO = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location(
    "replay_committed_runs_torch", REPO / "scripts" / "replay_committed_runs_torch.py")
replay = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(replay)
RUNS = sorted(p.parent for p in (REPO / "experiments").glob("*/expt_config.yaml"))
N_RESNET18 = 11_164_352
K = [0, 4_912_314, 7_663_211, 9_203_713, 10_066_394]
PRUNE_RATE = 0.44


def _leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_leaves(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def test_there_are_four_committed_runs():
    assert [p.name.split("__")[0] for p in RUNS] == [
        "cifar10_resnet18_mag_imp_sp0.69_seed0_cyc4",
        "cifar10_resnet18_mag_imp_sp0.9_seed0",
        "cifar10_resnet18_mag_lrr_sp0.69_seed0",
        "cifar10_resnet18_mag_wr_sp0.69_seed0",
    ]


@pytest.mark.parametrize("run", RUNS, ids=lambda p: p.name.split("__")[0])
def test_the_adapter_keeps_every_committed_key_and_reports_the_rest(run, tmp_path):
    committed = yaml.safe_load((run / "expt_config.yaml").read_text())
    adapted, dropped, defaulted = replay.adapt_config(committed, str(tmp_path))
    cfg = _leaves(config_to_dict(config_from_dict(adapted)))
    kept = _leaves(committed)
    assert dropped == ["experiment_params.log_every_steps"]
    for key, value in kept.items():
        if key == "experiment_params.base_dir":
            assert cfg[key] == str(tmp_path)
        elif key not in dropped:
            assert cfg[key] == value, key
    # Exactly the schema's fields the run lacks, each at its default (the
    # null resume group counts as present).
    defaults = _leaves(config_to_dict(MainConfig()))
    missing = {k for k in defaults if k not in kept
               and not k.startswith("experiment_params.resume_experiment_stuff.")}
    assert sorted(k for k, _ in defaulted) == sorted(missing)
    assert all(cfg[k] == v == defaults[k] for k, v in defaulted)
    older = {"model_params.pretrained_path", "model_params.attention_impl",
             "experiment_params.model_parallelism"}
    lacks = "_sp0.9_" in run.name or "_wr_" in run.name
    assert older & missing == (older if lacks else set())


def _ladder_counts(root):
    """The full-width ResNet-18, pruned level after level along the 0.9
    ladder by both packages with no training: per level, k and t from the
    port's scores, each package's zeros, and whether the masks agree."""
    jmodel = jresnet.resnet18(10, cifar_stem=True)
    variables = seeded_variables(jmodel, 32, 0)
    params = variables["params"]
    jmasks = jmasking.make_masks(params)
    state, masks = bridge.params_from_flax(params, jmasks, variables["batch_stats"])
    ladders = {target: (generate_densities("mag", target, PRUNE_RATE),
                        jax_generate_densities("mag", target, PRUNE_RATE))
               for target in (0.69, 0.9)}
    prune = jax.jit(jax_prune_mag, static_argnums=2)
    levels = []
    for d in ladders[0.9][0][1:]:
        k, t = masking.global_threshold_counts(mag_scores(state, masks), d)
        masks = prune_mag(state, masks, d)
        jmasks = jax.device_get(prune(params, jmasks, d))
        _, want = bridge.params_from_flax(params, jmasks)
        levels.append({
            "k": k, "t": t, "zeros": masking.num_prunable(masks) - sum(
                int(m.sum()) for m in masks.values()),
            "jax_zeros": sum(int(m.size - m.sum()) for m in jax.tree.leaves(jmasks)),
            "equal": masks.keys() == want.keys() and all(
                torch.equal(m, want[p]) for p, m in masks.items()),
        })
    return {"n": masking.num_prunable(masks), "ladders": ladders, "levels": levels}


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    return run_once(tmp_path_factory, "accuracy_evidence_ladder", _ladder_counts)


def test_both_ladders_have_the_committed_levels(ladder):
    assert ladder["n"] == N_RESNET18
    for target, levels in ((0.69, 4), (0.9, 5)):
        port, ref = ladder["ladders"][target]
        assert port == ref and len(port) == levels
        assert [int((1.0 - d) * N_RESNET18) for d in port] == K[:levels]


def test_magnitude_pruning_holds_exactly_k_zeros_in_both_packages(ladder):
    for level, got in enumerate(ladder["levels"], start=1):
        assert got["equal"], level
        assert got["t"] == 0, level
        assert got["zeros"] == got["jax_zeros"] == got["k"] == K[level], (level, got)


@pytest.mark.parametrize("run", RUNS, ids=lambda p: p.name.split("__")[0])
def test_committed_csvs_hold_k_zeros_but_one_tie(run):
    rows = replay.summary_rows(run)
    zeros = [replay.zeros_of(r, N_RESNET18) for r in rows]
    ties = [z - k for z, k in zip(zeros, K)]
    if "_sp0.9_" in run.name:
        assert ties == [0, 0, 0, 1, 0]  # level 3: one weight tied at the threshold
    else:
        assert ties == [0, 0, 0, 0]
    # The CSV's float is the count over n, as the port's overall_sparsity.
    assert all(float(r["sparsity"]) == z / N_RESNET18 * 100.0 for r, z in zip(rows, zeros))


def test_a_planted_tie_prunes_k_plus_one_in_both_packages():
    jmodel = jresnet.resnet18(10, cifar_stem=True, width=8)
    params = seeded_variables(jmodel, 16, 3)["params"]
    jmasks = jmasking.make_masks(params)
    state, masks = bridge.params_from_flax(params, jmasks)
    density = 0.3
    flat = torch.cat([s.reshape(-1) for s in mag_scores(state, masks).values()])
    k = int((1 - density) * flat.numel())
    assert masking.global_threshold_counts(mag_scores(state, masks), density) == (k, 0)
    # The (k+1)-th smallest magnitude set equal to the k-th: its sign kept.
    order = torch.argsort(flat)
    kth, nxt = int(order[k - 1]), int(order[k])
    for path in masks:
        n = masks[path].numel()
        if nxt < n:
            key = masking.state_key(path)
            w = state[key].reshape(-1)
            w[nxt] = torch.sign(w[nxt]) * flat[kth]
            break
        nxt -= n
    planted, _ = bridge.params_to_flax(state, masks, 0)
    assert masking.global_threshold_counts(mag_scores(state, masks), density) == (k, 1)
    got = prune_mag(state, masks, density)
    want = jax.device_get(jax_prune_mag(planted, jmasks, density))
    _, want = bridge.params_from_flax(params, want)
    n = masking.num_prunable(got)
    assert n - sum(int(m.sum()) for m in got.values()) == k + 1
    assert all(torch.equal(m, want[p]) for p, m in got.items())


def _rewrite(path: Path, row: int, column: str, value: str) -> None:
    rows = replay.read_csv(path)
    rows[row][column] = value
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def test_the_count_rule_reads_a_run_back(tmp_path):
    """``check_run`` on a saved two-level run: k + t at each level, finite
    losses, and a corrupted CSV fails it."""
    import run_experiment_torch

    rc = run_experiment_torch.main([
        "--device", "cpu", "--config-name=cifar10_imp",
        "dataset_params.dataloader_type=synthetic", "dataset_params.total_batch_size=8",
        "dataset_params.synthetic_num_train=16", "dataset_params.synthetic_num_test=8",
        "experiment_params.epochs_per_level=1", "experiment_params.max_steps_per_epoch=1",
        "pruning_params.target_sparsity=0.2", f"experiment_params.base_dir={tmp_path}"])
    assert rc == 0
    (expt,) = [d for d in tmp_path.iterdir() if d.is_dir()]
    n, counts, failures = replay.check_run(expt)
    assert failures == [] and n == N_RESNET18
    assert [c["k"] for c in counts] == [0, int((1.0 - 0.8) * N_RESNET18)]
    assert all(c["zeros"] == c["csv_zeros"] == c["k"] + c["t"] for c in counts)
    (summary,) = (expt / "metrics").glob("*_summary.csv")
    _rewrite(summary, 1, "sparsity", "19.0")
    _rewrite(expt / "metrics" / "level_wise_metrics" / "level_0_metrics.csv", 0,
             "train_loss", "nan")
    _, _, failures = replay.check_run(expt)
    assert len(failures) == 2, failures
    assert failures[0].startswith("level 1:") and "losses" in failures[1]
