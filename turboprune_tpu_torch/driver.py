"""The outer pruning-level loop (port of ``turboprune_tpu/driver.py``), on
one process.

The driver owns the LEVEL loop (density ladder, prune between levels,
rewind, level checkpoints); the harness owns the epoch loop. Multi-process
runs (the JAX package's broadcast and cross-host agreement checks) and the
cyclic harness are later slices (ROADMAP.md queue A, items 13 and 11).
"""

from __future__ import annotations

from typing import Optional, Type

import torch

from .config.schema import MainConfig
from .harness import PruningHarness
from .ops import masking
from .pruning import generate_densities, prune_the_model
from .utils import (
    gen_expt_dir,
    reset_weights,
    resolve_device,
    resume_experiment,
    save_config,
    set_seed,
)


def restore_level(harness: PruningHarness, level: int) -> None:
    """Load ``model_level_{level}``'s params and masks into the harness."""
    restored = harness.ckpts.load_level(level)
    harness.state.model.load_state_dict(restored["params"])
    harness.state.masks = {
        p: m.to(harness.device) for p, m in restored["masks"].items()
    }


def prune_level(harness: PruningHarness, density: float, level: int) -> None:
    """Prune the harness state to ``density``, then rewind the weights as
    ``training_type`` says (masks survive the rewind)."""
    cfg = harness.cfg
    method = cfg.pruning_params.prune_method
    state = harness.state
    before = masking.overall_sparsity(state.masks)
    with torch.no_grad():
        state.masks = prune_the_model(method, state.model.state_dict(), state.masks, density)
    after = masking.overall_sparsity(state.masks)
    print(
        f"[prune] level {level}: {method} to density {density:.4f} "
        f"(sparsity {before:.2f}% -> {after:.2f}%)",
        flush=True,
    )
    reset_weights(cfg.pruning_params.training_type, state, harness.ckpts)
    print(
        f"[prune] level {level}: achieved density "
        f"{masking.overall_density(state.masks):.6f} after "
        f"{cfg.pruning_params.training_type} rewind",
        flush=True,
    )


def run(
    cfg: MainConfig,
    device: str | torch.device = "cuda",
    harness_cls: Optional[Type[PruningHarness]] = None,
):
    """Run the full experiment; returns (expt_dir, per-level summaries)."""
    harness_cls = harness_cls or PruningHarness
    device = resolve_device(device)
    ep = cfg.experiment_params
    set_seed(ep.seed)
    if ep.resume_experiment:
        resume_experiment(cfg)
    prefix, expt_dir = gen_expt_dir(cfg)
    save_config(expt_dir, cfg)
    harness = harness_cls(cfg, (prefix, expt_dir), device=device)

    pp = cfg.pruning_params
    densities = generate_densities(pp.prune_method, pp.target_sparsity, pp.prune_rate)
    summaries = []
    for level, density in enumerate(densities):
        if level == 0:
            if pp.training_type == "at_init":
                # PaI: prune the untrained network before any training;
                # model_init is saved after, so it carries the pruned masks.
                prune_level(harness, density, level)
        else:
            restore_level(harness, level - 1)
            prune_level(harness, density, level)
        summary = harness.train_one_level(ep.epochs_per_level, level)
        harness.ckpts.save_level(level, harness.state.model_tree())
        summary["achieved_density"] = masking.overall_density(harness.state.masks)
        summaries.append(summary)
    return expt_dir, summaries
