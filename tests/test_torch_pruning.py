"""The port's pruning (turboprune_tpu_torch/pruning/) against the JAX
package's: density ladders and global magnitude masks, which are exact
math and must match bit for bit."""

import jax
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, jax_masks, jax_params
from turboprune_tpu.pruning import generate_densities as jax_generate_densities
from turboprune_tpu.pruning import prune_mag as jax_prune_mag
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.models.vit import VisionTransformer
from turboprune_tpu_torch.ops import masking
from turboprune_tpu_torch.pruning import generate_densities, prune_mag, prune_the_model


@pytest.mark.parametrize(
    "method,target,rate",
    [
        ("mag", 0.2, 0.2),
        ("mag", 0.999, 0.2),
        ("mag", 0.64, 0.2),
        ("mag", 0.9, 0.5),
        ("random_erk", 0.95, 0.3),
        ("er_erk", 0.9, 0.2),
        ("er_balanced", 0.5, 0.2),
        ("snip", 0.98, 0.2),
        ("just dont", 0.9, 0.2),
    ],
)
def test_density_ladders_equal_jax(method, target, rate):
    assert generate_densities(method, target, rate) == jax_generate_densities(
        method, target, rate
    )


def _bridged_masks(tree):
    _, masks = bridge.params_from_flax(jax_params(seed=4), tree)
    return masks


def test_prune_mag_is_bit_identical_and_monotone():
    params = jax_params(seed=4)
    state, start = bridge.params_from_flax(params, jax_masks(params, seed=4, keep=0.9))
    jmasks = jax_masks(params, seed=4, keep=0.9)
    for density in (0.8, 0.64):
        jmasks = jax.device_get(jax_prune_mag(params, jmasks, density))
        got = prune_mag(state, start, density)
        want = _bridged_masks(jmasks)
        assert got.keys() == want.keys()
        for path in want:
            assert torch.equal(got[path], want[path]), (density, path)
        # The next level keeps a subset of this one's weights.
        assert all(bool((got[p] <= start[p]).all()) for p in got)
        n = masking.num_prunable(got)
        assert abs(masking.overall_density(got) - density) <= 1.0 / n
        start = got


def test_dispatch_keeps_or_refuses():
    params = jax_params(seed=5)
    state, masks = bridge.params_from_flax(params, jax_masks(params, seed=5))
    model = VisionTransformer(**TINY, image_size=32)
    model.load_state_dict(state)
    assert prune_the_model("just dont", model, masks, 0.5) is masks
    got = prune_the_model("mag", model, masks, 0.5)
    assert all(torch.equal(got[p], m) for p, m in prune_mag(state, masks, 0.5).items())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prune_the_model("nm", model, masks, 0.5)
    with pytest.raises(ValueError, match="Unknown"):
        prune_the_model("nope", model, masks, 0.5)
