"""The outer pruning-level loop (port of ``turboprune_tpu/driver.py``).

The driver owns the LEVEL loop (density ladder, prune between levels,
rewind, level checkpoints, resume at a level); the harness owns the epoch
loop. ``run_cyclic`` is the same loop with the cyclic harness.

In a world of several processes (``parallel/``) pruning runs replicated:
every rank runs the same seeded criterion on the same state (the
data-driven ones on the same global batch, gathered from a host-scope
loader's shards) and the driver asserts once per level that params and
masks agree bit for bit (``check_state_equality``). The primary decides the
experiment directory and broadcasts it; it alone prints and writes.
"""

from __future__ import annotations

from typing import Optional, Type

import torch

from .config.schema import MainConfig, parse_nm
from .data.cifar import derived_generator
from .harness import CyclicPruningHarness, PruningHarness
from .ops import masking
from .parallel import (
    broadcast_object,
    check_state_equality,
    is_primary,
    local_batchnorm,
    process_count,
    say,
)
from .pruning import DATA_DRIVEN_METHODS, generate_densities, prune_the_model
from .sparse.nm import project_masks
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
    pass over the train loader, the GLOBAL batch on every rank. As in the
    JAX package, taking it starts an epoch of the loader (its epoch counter
    moves on), so the epochs trained after the prune see the same
    augmentation and shuffle streams as the JAX package's. A host-scope
    loader's rank holds only its data row's rows: they are all-gathered
    over the data group, data row 0's first (the ranks of a ring hold the
    same rows and gather the same), so every rank scores the same batch
    and derives the same masks."""
    loader = harness.loaders.train_loader
    mesh = harness.mesh
    for batch in loader:
        if getattr(loader, "batch_scope", "global") == "host" and mesh.data_size > 1:
            batch = tuple(_all_gather_rows(t, mesh) for t in batch)
        return batch
    raise RuntimeError("empty train loader")


def _all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.data_size)]
    torch.distributed.all_gather(parts, t.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def prune_level(harness: PruningHarness, density: float, level: int) -> None:
    """Prune the harness state to ``density``, then rewind the weights as
    ``training_type`` says (masks survive the rewind). The random criteria
    draw from a generator derived from (seed, level), on the device. With
    ``experiment_params.nm_sparsity`` the masks of every criterion but
    "nm" (which projects inside) and "just dont" are then projected onto
    the N:M pattern (monotone: the ladder never resurrects a weight)."""
    cfg = harness.cfg
    ep = cfg.experiment_params
    method = cfg.pruning_params.prune_method
    state = harness.state
    generator = derived_generator(harness.device, ep.seed, level, "prune")
    batch = _first_train_batch(harness) if method in DATA_DRIVEN_METHODS else None
    nm_spec = None
    if ep.nm_sparsity:
        nm_spec = (*parse_nm(ep.nm_sparsity), ep.nm_transposable)
    before = masking.overall_sparsity(state.masks)
    # Every rank scores the whole global batch: BatchNorm takes the
    # statistics of that batch on each rank, with no collective.
    with local_batchnorm(state.model):
        state.masks = prune_the_model(method, state.model, state.masks, density,
                                      generator=generator, batch=batch,
                                      nm=nm_spec if method == "nm" else None)
    nm_note = ""
    if nm_spec is not None and method not in ("nm", "just dont"):
        state.masks, nm_report = project_masks(state.model.state_dict(), state.masks, *nm_spec)
        nm_note = (f", {ep.nm_sparsity} projection kept "
                   f"{nm_report['preserved_magnitude_frac']:.3f} of magnitude")
    after = masking.overall_sparsity(state.masks)
    say(f"[prune] level {level}: {method} to density {density:.4f} "
        f"(sparsity {before:.2f}% -> {after:.2f}%){nm_note}")
    reset_weights(cfg.pruning_params.training_type, state, harness.ckpts)
    say(f"[prune] level {level}: achieved density "
        f"{masking.overall_density(state.masks):.6f} after "
        f"{cfg.pruning_params.training_type} rewind")
    if process_count() > 1:
        # Once per level: the exact digest is a full device-to-host copy.
        tree = state.model_tree()
        check_state_equality({"params": tree["params"], "masks": tree["masks"]}, exact=True)


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
    # The experiment dir is decided on the primary and broadcast.
    start_level = 0
    prefix = expt_dir = ""
    if ep.resume_experiment:
        if is_primary():
            prefix, expt_dir, start_level = resume_experiment(cfg)
    elif is_primary():
        prefix, expt_dir = gen_expt_dir(cfg)
    prefix, expt_dir, start_level = broadcast_object((prefix, expt_dir, start_level))
    # A resumed level starts, as every level > 0 does, from the level
    # below's checkpoint.
    if start_level and not ExperimentCheckpoints(expt_dir).has_level(start_level - 1):
        raise FileNotFoundError(
            f"resume_level={start_level} needs checkpoint model_level_{start_level - 1}"
        )
    if is_primary():
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
        harness.wandb.finish()
    if ep.checkpoint_every_epochs:
        # The run is complete: a slot left behind would be restored by a
        # later resume of this dir at its level.
        harness.ckpts.clear_mid_level()
    return expt_dir, summaries


def run_cyclic(cfg: MainConfig, device: str | torch.device = "cuda"):
    """``run`` with each level trained in ``cyclic_training.num_cycles``
    cycles (``harness.CyclicPruningHarness``)."""
    return run(cfg, device=device, harness_cls=CyclicPruningHarness)
