"""The outer pruning-level loop (port of ``turboprune_tpu/driver.py``), on
one process.

The driver owns the LEVEL loop (density ladder, prune between levels,
rewind, level checkpoints, resume at a level); the harness owns the epoch
loop. ``run_cyclic`` is the same loop with the cyclic harness. Multi-process
runs (the JAX package's broadcast and cross-host agreement checks) are a
later slice (ROADMAP.md queue A, item 13).
"""

from __future__ import annotations

from typing import Optional, Type

import torch

from .config.schema import MainConfig
from .data.cifar import derived_generator
from .harness import CyclicPruningHarness, PruningHarness
from .ops import masking
from .pruning import DATA_DRIVEN_METHODS, generate_densities, prune_the_model
from .utils import (
    ExperimentCheckpoints,
    gen_expt_dir,
    model_state_dict,
    reset_weights,
    resolve_device,
    resume_experiment,
    save_config,
    set_seed,
)


def restore_level(harness: PruningHarness, level: int) -> None:
    """Load ``model_level_{level}``'s params, batch_stats and masks into
    the harness."""
    restored = harness.ckpts.load_level(level)
    harness.state.model.load_state_dict(model_state_dict(restored))
    harness.state.masks = {
        p: m.to(harness.device) for p, m in restored["masks"].items()
    }


def _first_train_batch(harness: PruningHarness) -> tuple:
    """The scoring batch of the data-driven criteria: the first batch of a
    pass over the train loader. As in the JAX package, taking it starts an
    epoch of the loader (its epoch counter moves on), so the epochs trained
    after the prune see the same augmentation and shuffle streams as the
    JAX package's."""
    for batch in harness.loaders.train_loader:
        return batch
    raise RuntimeError("empty train loader")


def prune_level(harness: PruningHarness, density: float, level: int) -> None:
    """Prune the harness state to ``density``, then rewind the weights as
    ``training_type`` says (masks survive the rewind). The random criteria
    draw from a generator derived from (seed, level), on the device."""
    cfg = harness.cfg
    method = cfg.pruning_params.prune_method
    state = harness.state
    generator = derived_generator(harness.device, cfg.experiment_params.seed, level, "prune")
    batch = _first_train_batch(harness) if method in DATA_DRIVEN_METHODS else None
    before = masking.overall_sparsity(state.masks)
    state.masks = prune_the_model(method, state.model, state.masks, density,
                                  generator=generator, batch=batch)
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
    start_level = 0
    if ep.resume_experiment:
        prefix, expt_dir, start_level = resume_experiment(cfg)
        # A resumed level starts, as every level > 0 does, from the level
        # below's checkpoint.
        if start_level and not ExperimentCheckpoints(expt_dir).has_level(start_level - 1):
            raise FileNotFoundError(
                f"resume_level={start_level} needs checkpoint model_level_{start_level - 1}"
            )
    else:
        prefix, expt_dir = gen_expt_dir(cfg)
    save_config(expt_dir, cfg)
    harness = harness_cls(cfg, (prefix, expt_dir), device=device)

    pp = cfg.pruning_params
    densities = generate_densities(pp.prune_method, pp.target_sparsity, pp.prune_rate)
    summaries = []
    try:
        for level in range(start_level, len(densities)):
            density = densities[level]
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
    finally:
        # The loaders' worker processes (the ImageFolder loader's) stop now,
        # also when a level raises, not whenever the harness is collected.
        close = getattr(harness.loaders, "close", None)
        if close is not None:
            close()
    if ep.checkpoint_every_epochs:
        # The run is complete: a slot left behind would be restored by a
        # later resume of this dir at its level.
        harness.ckpts.clear_mid_level()
    return expt_dir, summaries


def run_cyclic(cfg: MainConfig, device: str | torch.device = "cuda"):
    """``run`` with each level trained in ``cyclic_training.num_cycles``
    cycles (``harness.CyclicPruningHarness``)."""
    return run(cfg, device=device, harness_cls=CyclicPruningHarness)
