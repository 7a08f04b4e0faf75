"""Port of the mask machinery (turboprune_tpu_torch/ops/masking.py) against
turboprune_tpu/ops/masking.py: global magnitude masks and the sparsity
accounting are exact math, so they must be bit-identical on the same
seeded scores, the k < 1 no-op included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turboprune_tpu.ops import masking as jm
from turboprune_tpu_torch.ops import masking as tm

SHAPES = {
    "block0/attn/query/kernel": (32, 2, 16),
    "block0/mlp/fc1/kernel": (32, 128),
    "head/kernel": (32, 10),
    "patch_embed/kernel": (4, 4, 3, 32),
}


def jax_tree(leaves: dict):
    tree: dict = {}
    for path, value in leaves.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def flat(tree) -> dict:
    return {
        jm.path_name(p): np.asarray(m)
        for p, m in jm.mask_leaves_with_path(tree)
    }


def seeded_scores(seed=0, ties=False):
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in SHAPES.items():
        s = np.abs(rng.normal(size=shape)).astype(np.float32)
        if ties:  # many exact ties, zeros at already-pruned positions
            s = np.round(s, 1) * (rng.random(shape) > 0.3)
        out[path] = s.astype(np.float32)
    return out


@pytest.mark.parametrize("density", [0.8, 0.2, 0.05, 0.999999])
@pytest.mark.parametrize("ties", [False, True])
def test_global_threshold_mask_bit_identical(density, ties):
    scores = seeded_scores(seed=int(density * 100), ties=ties)
    ones = {p: np.ones(s.shape, bool) for p, s in scores.items()}
    ref = flat(
        jm.global_threshold_mask(
            jax_tree({p: jnp.asarray(s) for p, s in scores.items()}),
            jax_tree({p: jnp.asarray(m) for p, m in ones.items()}),
            density,
        )
    )
    got = tm.global_threshold_mask(
        {p: torch.from_numpy(s) for p, s in scores.items()},
        {p: torch.from_numpy(m) for p, m in ones.items()},
        density,
    )
    assert set(got) == set(ref)
    for p in ref:
        np.testing.assert_array_equal(got[p].numpy(), ref[p])
    assert tm.overall_sparsity(got) == jm.overall_sparsity(
        jax_tree({p: jnp.asarray(m) for p, m in ref.items()})
    )


def test_k_below_one_returns_masks_untouched():
    scores = {p: torch.from_numpy(s) for p, s in seeded_scores(5).items()}
    prior = {p: torch.rand(s.shape) > 0.5 for p, s in scores.items()}
    n = sum(s.numel() for s in scores.values())
    density = 1.0 - 0.5 / n  # k = int(0.5) = 0
    assert tm.global_threshold_mask(scores, prior, density) is prior
    jscores = jax_tree({p: jnp.asarray(s.numpy()) for p, s in scores.items()})
    jprior = jax_tree({p: jnp.asarray(m.numpy()) for p, m in prior.items()})
    assert jm.global_threshold_mask(jscores, jprior, density) is jprior


def test_sparsity_accounting_matches():
    rng = np.random.default_rng(7)
    masks = {p: rng.random(s) > 0.37 for p, s in SHAPES.items()}
    jtree = jax_tree({p: jnp.asarray(m) for p, m in masks.items()})
    tmasks = {p: torch.from_numpy(m) for p, m in masks.items()}
    assert tm.overall_sparsity(tmasks) == jm.overall_sparsity(jtree)
    assert tm.overall_density(tmasks) == jm.overall_density(jtree)
    assert tm.num_prunable(tmasks) == jm.num_prunable(jtree)


def test_apply_masks_zeroes_exactly_the_pruned_weights():
    w = torch.randn(6, 4)
    m = torch.rand(6, 4) > 0.5
    state = {"head.weight": w, "head.bias": torch.randn(6)}
    out = tm.apply_masks(state, {"head/kernel": m})
    assert torch.equal(out["head.weight"], w * m)
    assert out["head.bias"] is state["head.bias"]
    assert tm.state_key("block3/mlp/fc2/kernel") == "block3.mlp.fc2.weight"
