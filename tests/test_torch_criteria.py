"""The port's pruning criteria and per-layer allocations
(turboprune_tpu_torch/pruning/) against the JAX package's, on ResNets.

- ``erk_densities``/``balanced_densities``: exactly equal (the same float
  operations in the same layer order) at the full published widths of
  ResNet-18 (CIFAR stem) and ResNet-50 (mask shapes only, no forward).
- ``random_erk``/``random_balanced``: the generators differ from
  ``jax.random``, so the port's random scores are handed to the JAX
  package's per-layer threshold: the masks, and so every layer's kept
  count, are equal bit for bit.
- ``er_erk``/``er_balanced`` (Bernoulli masks): every layer's kept count
  within 4 standard deviations of n * density.
- SNIP (ResNet-18, width 8, fp32): the same kept count, and the masks
  equal but for ties: where they differ, the port's score lies within
  1e-4 (relative) of its threshold.
- SynFlow (same model): its train-mode forward of one all-ones image
  normalises activations that vary only at the image's borders, so every
  BatchNorm variance is a small difference of large numbers and both
  packages' fp32 scores carry noise of ~1e-3 of a layer's largest score
  (measured against a float64 forward of the port: the port's 9.0e-4,
  the JAX package's 1.7e-3). So: the same kept count, the port's scores
  within 2e-3 of each layer's largest from the float64 scores, and the
  masks equal on all but 1e-3 of the weights (measured: 38 of 175,192
  differ).
- SNIP and SynFlow leave every BatchNorm buffer and every parameter bit
  for bit as it was. The JAX side of these
  two runs under ``jax.jit``: one compile takes ~3 s on the CPU, where
  differentiating the ResNet op by op compiles each primitive and takes
  ~18 s.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import seeded_variables
from turboprune_tpu.models import resnet as jresnet
from turboprune_tpu.ops import masking as jmasking
from turboprune_tpu.pruning import balanced_densities as jax_balanced_densities
from turboprune_tpu.pruning import erk_densities as jax_erk_densities
from turboprune_tpu.pruning import prune_the_model as jax_prune_the_model
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.models import create_model
from turboprune_tpu_torch.models import resnet as tresnet
from turboprune_tpu_torch.ops import masking
from turboprune_tpu_torch.pruning import (
    balanced_densities,
    erk_densities,
    prune_the_model,
)
from turboprune_tpu_torch.pruning import criteria
from turboprune_tpu_torch.pruning.criteria import snip_scores, synflow_scores


def _jax_ones_masks(jmodel, image):
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, image, image, 3)),
                            train=False))["params"]
    return jmasking.make_masks(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))


@pytest.fixture(scope="module")
def full_width():
    """name -> (JAX all-ones mask tree, the port's model, its all-ones
    masks) at the published widths."""
    out = {}
    for name, dataset in (("resnet18", "CIFAR10"), ("resnet50", "ImageNet")):
        cifar = dataset == "CIFAR10"
        model = create_model(name, 10, dataset)
        out[name] = (_jax_ones_masks(getattr(jresnet, name)(10, cifar_stem=cifar), 32),
                     model, masking.make_masks(model))
    return out


@pytest.mark.parametrize("density", [0.02, 0.1, 0.5, 0.9])
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_layer_densities_equal_jax_at_full_width(name, density, full_width):
    jmasks, _, masks = full_width[name]
    for port, ref in ((erk_densities, jax_erk_densities),
                      (balanced_densities, jax_balanced_densities)):
        got, want = port(masks, density), ref(jmasks, density)
        assert list(got) == list(want)  # the JAX tree's flatten order
        assert got == want, port.__name__


def _small_resnet(seed=0, keep=None):
    """A width-8 ResNet-18 (CIFAR stem) on both sides: flax model, numpy
    variables, numpy mask tree (``keep`` of each kernel, or all ones), and
    the port's model and masks on the same weights."""
    jmodel = jresnet.resnet18(10, cifar_stem=True, width=8)
    variables = seeded_variables(jmodel, 16, seed)
    ones = jmasking.make_masks(variables["params"])
    rng = np.random.default_rng(seed)
    jmasks = jax.tree.map(
        lambda m: None if m is None else (
            np.ones(m.shape, bool) if keep is None else rng.random(m.shape) < keep),
        ones, is_leaf=lambda x: x is None)
    state, masks = bridge.params_from_flax(variables["params"], jmasks, variables["batch_stats"])
    model = tresnet.resnet18(10, cifar_stem=True, width=8)
    model.load_state_dict(state)
    return jmodel, variables, jmasks, model, masks


def _counts(masks):
    return {p: int(m.sum()) for p, m in masks.items()}


@pytest.mark.parametrize("method", ["random_erk", "random_balanced"])
def test_random_criteria_threshold_as_jax_per_layer(method):
    jmodel, variables, jmasks, model, masks = _small_resnet(seed=1, keep=0.9)
    density = 0.3
    got = prune_the_model(method, model, masks, density,
                          generator=torch.Generator().manual_seed(3))
    scores = criteria._random_normal_scores(masks, torch.Generator().manual_seed(3))
    assert all(bool((scores[p][~masks[p]] == 0).all()) for p in masks)
    allocate = (jax_erk_densities, erk_densities)
    if method == "random_balanced":
        allocate = (jax_balanced_densities, balanced_densities)
    assert allocate[0](jmasks, density) == allocate[1](masks, density)
    _, jscores = bridge.params_to_flax(model.state_dict(), scores, 0)
    want = jax.device_get(jmasking.per_layer_threshold_mask(
        jscores, allocate[0](jmasks, density)))
    _, want = bridge.params_from_flax(variables["params"], want)
    assert got.keys() == want.keys()
    for path, m in got.items():
        assert torch.equal(m, want[path]), path
        assert bool((m <= masks[path]).all()), path  # monotone
    again = prune_the_model(method, model, masks, density,
                            generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(again[p], got[p]) for p in got)


@pytest.mark.parametrize("method", ["er_erk", "er_balanced"])
def test_er_criteria_within_binomial_bounds(method, full_width):
    """Full-width ResNet-18 at density 0.1, from all-ones masks."""
    model, masks = full_width["resnet18"][1:]
    per_layer = (erk_densities if method == "er_erk" else balanced_densities)(masks, 0.1)
    got = prune_the_model(method, model, masks, 0.1, generator=torch.Generator().manual_seed(0))
    assert list(got) == list(per_layer)
    for path, m in got.items():
        n, d = m.numel(), per_layer[path]
        kept = int(m.sum())
        assert abs(kept - n * d) <= 4 * math.sqrt(n * d * (1 - d)) + 1e-9, (path, kept, n * d)


def _ties_aside(got, want, scores, density):
    """Equal kept counts, and every position where the masks differ scores
    within 1e-4 (relative) of the port's threshold."""
    n = masking.num_prunable(got)
    assert sum(_counts(got).values()) == sum(_counts(want).values())
    flat = torch.cat([s.reshape(-1) for s in scores.values()])
    threshold = float(torch.kthvalue(flat, int((1 - density) * n)).values)
    differ = 0
    for path in got:
        diff = got[path] != want[path]
        differ += int(diff.sum())
        near = (scores[path][diff] - threshold).abs() <= 1e-4 * threshold
        assert bool(near.all()), path
    assert differ <= 1e-3 * n


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _unchanged(model, before):
    return all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_snip_masks_equal_jax_and_leave_the_model_alone():
    jmodel, variables, jmasks, model, masks = _small_resnet(seed=2, keep=0.8)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=8).astype(np.int32)
    density = 0.3
    want = jax.device_get(jax.jit(lambda v, m, b: jax_prune_the_model(
        "snip", jmodel, v, m, density, jax.random.PRNGKey(0), batch=b))(
        variables, jmasks, (jnp.asarray(x), jnp.asarray(y))))
    _, want = bridge.params_from_flax(variables["params"], want)
    model.eval()
    before = _snapshot(model)
    batch = (torch.from_numpy(x), torch.from_numpy(y).long())
    got = prune_the_model("snip", model, masks, density, batch=batch)
    assert _unchanged(model, before) and not model.training
    _ties_aside(got, want, snip_scores(model, masks, batch), density)
    assert _unchanged(model, before)


def test_synflow_masks_equal_jax_and_leave_the_model_alone():
    jmodel, variables, jmasks, model, masks = _small_resnet(seed=3, keep=0.8)
    x = np.random.default_rng(5).normal(size=(4, 16, 16, 3)).astype(np.float32)
    density = 0.3
    want = jax.device_get(jax.jit(lambda v, m, b: jax_prune_the_model(
        "synflow", jmodel, v, m, density, jax.random.PRNGKey(0), batch=(b, None)))(
        variables, jmasks, jnp.asarray(x)))
    _, want = bridge.params_from_flax(variables["params"], want)
    model.train()
    before = _snapshot(model)
    got = prune_the_model("synflow", model, masks, density, batch=(torch.from_numpy(x), None))
    assert _unchanged(model, before) and model.training
    n = masking.num_prunable(got)
    assert sum(_counts(got).values()) == sum(_counts(want).values())
    assert sum(int((got[p] != want[p]).sum()) for p in got) <= 1e-3 * n
    exact = copy.deepcopy(model).double()
    for module in exact.modules():
        if hasattr(module, "dtype"):
            module.dtype = torch.float64
    exact.fc.forward = lambda z, fc=exact.fc: torch.nn.functional.linear(
        z.double(), fc.weight, fc.bias)  # the head's fp32 cast, in float64
    scores = synflow_scores(model, masks, torch.from_numpy(x))
    ref = synflow_scores(exact, masks, torch.from_numpy(x).double())
    for path, sc in scores.items():
        err = float((sc.double() - ref[path]).abs().max() / ref[path].abs().max())
        assert err <= 2e-3, (path, err)


def test_dispatch_needs_its_inputs():
    _, _, _, model, masks = _small_resnet()
    for method in ("random_erk", "er_balanced"):
        with pytest.raises(ValueError, match="generator"):
            prune_the_model(method, model, masks, 0.5)
    for method in ("snip", "synflow"):
        with pytest.raises(ValueError, match="batch"):
            prune_the_model(method, model, masks, 0.5)
    with pytest.raises(NotImplementedError, match="item 15"):
        prune_the_model("nm", model, masks, 0.5)
