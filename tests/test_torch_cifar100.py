"""The four ``conf/cifar100_er_*.yaml`` as shipped, from the port's CLI on
the CPU: ResNet-18 with the CIFAR stem and a 100-wide head, pruned at init
to density 0.1 by ERK, balanced, SNIP or SynFlow, then one short level on
synthetic data (8 images, batch 8, 2 steps).

Each run: the density at init (SNIP and SynFlow by a global threshold,
within one weight; ERK and balanced Bernoulli per layer, each layer's kept
count and the whole's within 4 standard deviations of the allocation,
which for balanced keeps less than 0.1 of the weights), the head's width,
the synthetic labels in [0, 100), ``model_init``'s BatchNorm statistics as
initialised (the scoring forward must not move them) and level 0's masks
equal to ``model_init``'s.

Against the JAX package on the run's own ``model_init`` weights and the
scoring batch the driver took (the first batch of the train loader's epoch
0): the allocations of ERK and balanced equal exactly at these widths
(mask shapes only). SNIP's and SynFlow's masks from both packages'
``prune_the_model`` in fp32: the same kept count and at most 1e-3 of the
weights differing, the noise rule ``tests/test_torch_criteria.py`` states
for SynFlow. Its SNIP tie rule (masks equal but within 1e-4 of the
threshold) and its score rule (the port's fp32 scores within 2e-3 of each
layer's largest from float64) hold at width 8, not at this width, and not
for want of the port: the JAX package's own fp32 scores lie up to 1.7e-2
of a layer's largest from float64 for SNIP (the port's 5.6e-6; the masks
differ at 314 of 11,210,432 weights), and for SynFlow, whose one all-ones
image in train mode leaves the first BatchNorms a variance that is a small
difference of large numbers, 1.5 (conv1) and 0.24 (layer1_0/Conv_1), the
port's 1.2 and 4.3e-5. So the scores are held to float64 in both
packages: the port's float64 scores equal the JAX package's float64
scores (the same loss, under ``jax.enable_x64``) within 1e-6 of each
layer's largest (measured: SNIP 3.3e-7, SynFlow 1.7e-7), and the port's
fp32 scores lie no farther from them than the larger of 2e-3 and the JAX
package's fp32 scores do, layer by layer. The run itself scores in the
config's bf16: its masks are the port's criterion on that bf16 model, bit
for bit.
"""

import copy
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run_experiment_torch
from test_torch_criteria import _jax_ones_masks
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import run_once
from turboprune_tpu.models import resnet as jresnet
from turboprune_tpu.ops import masking as jmasking
from turboprune_tpu.pruning import balanced_densities as jax_balanced_densities
from turboprune_tpu.pruning import erk_densities as jax_erk_densities
from turboprune_tpu.pruning import prune_the_model as jax_prune_the_model
from turboprune_tpu.pruning import softmax_cross_entropy
from turboprune_tpu_torch import bridge, driver
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.models import create_model
from turboprune_tpu_torch.ops import masking
from turboprune_tpu_torch.pruning import balanced_densities, erk_densities, prune_the_model
from turboprune_tpu_torch.pruning.criteria import snip_scores, synflow_scores
from turboprune_tpu_torch.utils import ExperimentCheckpoints, model_state_dict

CONFIGS = ["cifar100_er_erk", "cifar100_er_balanced", "cifar100_er_snip", "cifar100_er_synflow"]
OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.total_batch_size=8",
    "dataset_params.synthetic_num_train=8",
    "dataset_params.synthetic_num_test=8",
    "experiment_params.epochs_per_level=1",
    "experiment_params.max_steps_per_epoch=2",
]
DENSITY = 0.1  # 1 - target_sparsity of every pai_* group


def _allocations(root):
    """Per-layer ERK and balanced densities at DENSITY of the full-width
    CIFAR-100 ResNet-18, from both packages' mask shapes."""
    jmasks = _jax_ones_masks(jresnet.resnet18(100, cifar_stem=True), 32)
    masks = masking.make_masks(create_model("resnet18", 100, "CIFAR100"))
    return {name: (port(masks, DENSITY), ref(jmasks, DENSITY))
            for name, port, ref in (("erk", erk_densities, jax_erk_densities),
                                    ("balanced", balanced_densities, jax_balanced_densities))}


@pytest.fixture(scope="module")
def allocations(tmp_path_factory):
    return run_once(tmp_path_factory, "cifar100_allocations", _allocations)


def _run(config: str, base) -> tuple:
    """``run_experiment_torch.main`` on ``config``; returns (the harness,
    the experiment's checkpoints)."""
    harnesses = []

    class Harness(PruningHarness):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            harnesses.append(self)

    with mock.patch.object(driver, "PruningHarness", Harness):
        rc = run_experiment_torch.main(["--device", "cpu", f"--config-name={config}",
                                        *OVERRIDES, f"experiment_params.base_dir={base}"])
    assert rc == 0
    (expt,) = [d for d in base.iterdir() if d.is_dir()]
    return harnesses[0], ExperimentCheckpoints(expt)


def _scoring_batch(harness) -> tuple:
    loader = copy.copy(harness.loaders.train_loader)
    loader.epoch = 0
    return next(iter(loader))


def _jax_masks(method: str, state: dict, batch: tuple) -> dict:
    """The JAX package's fp32 masks of ``method`` at DENSITY from all-ones
    masks on the port's ``state``, as the port's mask dict."""
    ones = masking.make_masks(create_model("resnet18", 100, "CIFAR100"))
    params, jmasks = bridge.params_to_flax(state, ones, 0)
    variables = {"params": params, "batch_stats": bridge.batch_stats_to_flax(state)}
    images = jnp.asarray(batch[0].numpy())
    jbatch = (images, jnp.asarray(batch[1].numpy().astype(np.int32))) if method == "snip" \
        else (images, None)
    want = jax.device_get(jax.jit(lambda v, m, b: jax_prune_the_model(
        method, jresnet.resnet18(100, cifar_stem=True), v, m, DENSITY,
        jax.random.PRNGKey(0), batch=b))(variables, jmasks, jbatch))
    return bridge.params_from_flax(params, want)[1]


def _jax_scores(method: str, state: dict, batch: tuple, dtype) -> dict:
    """The scores the JAX package's ``prune_the_model`` thresholds for
    ``method`` from all-ones masks (its SNIP loss, or its SynFlow sum over
    one all-ones image on the absolute variables), computed in ``dtype`` on
    the port's ``state`` and ``batch``: float64 tensors by the port's state
    keys. Call a float64 one under ``jax.enable_x64(True)``."""
    np_dtype = np.dtype(dtype)
    ones = masking.make_masks(create_model("resnet18", 100, "CIFAR100"))
    params, jmasks = bridge.params_to_flax(state, ones, 0)
    params = jax.tree.map(lambda a: np.asarray(a, np_dtype), params)
    stats = jax.tree.map(lambda a: np.asarray(a, np_dtype), bridge.batch_stats_to_flax(state))
    jmodel = jresnet.resnet18(100, cifar_stem=True, dtype=dtype)
    if method == "synflow":
        params, stats = jax.tree.map(np.abs, params), jax.tree.map(np.abs, stats)
        images = jnp.ones((1,) + tuple(batch[0].shape[1:]), dtype)
    else:
        images = jnp.asarray(batch[0].numpy().astype(np_dtype))
    labels = jnp.asarray(batch[1].numpy().astype(np.int32))

    def objective(p):
        logits, _ = jmodel.apply({"params": jmasking.apply_masks(p, jmasks),
                                  "batch_stats": stats}, images, train=True,
                                 mutable=["batch_stats"])
        return jnp.sum(logits) if method == "synflow" else softmax_cross_entropy(logits, labels)

    grads = jax.device_get(jax.jit(jax.grad(objective))(params))
    scores = jax.tree.map(lambda g, w: np.abs(np.asarray(g, np.float64) * w), grads, params)
    return {k: v.double() for k, v in bridge.params_from_flax(scores)[0].items()}


def _port_scores(method: str, model, masks, batch: tuple) -> dict:
    if method == "snip":
        return snip_scores(model, masks, batch)
    return synflow_scores(model, masks, batch[0])


@pytest.mark.parametrize("config", CONFIGS)
def test_cifar100_config_runs_from_the_cli(tmp_path, config, allocations):
    harness, ckpts = _run(config, tmp_path)
    cfg = harness.cfg
    assert (cfg.dataset_params.dataset_name, cfg.dataset_params.num_classes) == ("CIFAR100", 100)
    assert cfg.pruning_params.training_type == "at_init"
    init, level0 = ckpts.load_model("model_init"), ckpts.load_level(0)
    state = model_state_dict(init)
    assert tuple(state["fc.weight"].shape) == (100, 512)
    assert tuple(harness.state.model.fc.weight.shape) == (100, 512)
    for loader in (harness.loaders.train_loader, harness.loaders.test_loader):
        labels = loader.labels
        assert labels.dtype == torch.int64 and bool(((labels >= 0) & (labels < 100)).all())
    for key, v in init["batch_stats"].items():
        assert bool((v == (1.0 if key.endswith(".var") else 0.0)).all()), key
    assert all(torch.equal(level0["masks"][p], m) for p, m in init["masks"].items())

    masks = init["masks"]
    n = masking.num_prunable(masks)
    method = cfg.pruning_params.prune_method
    if method in ("er_erk", "er_balanced"):
        port, ref = allocations[method[3:]]
        assert port == ref  # exactly, in the JAX mask tree's order
        # The whole: within 4 sigma of the allocation's sum (balanced keeps
        # less than DENSITY * n, in both packages: ROADMAP, "not faults").
        kept = sum(int(m.sum()) for m in masks.values())
        mean = sum(m.numel() * port[p] for p, m in masks.items())
        var = sum(m.numel() * port[p] * (1 - port[p]) for p, m in masks.items())
        assert abs(kept - mean) <= 4 * math.sqrt(var)
        for path, m in masks.items():
            k, d = int(m.sum()), port[path]
            assert abs(k - m.numel() * d) <= 4 * math.sqrt(m.numel() * d * (1 - d)) + 1e-9, path
        return

    assert abs(masking.overall_density(masks) - DENSITY) <= 1.0 / n
    batch = _scoring_batch(harness)
    ones = masking.make_masks(create_model("resnet18", 100, "CIFAR100"))
    # The run's bf16 scoring, re-run on its model_init: the same masks.
    model16 = create_model("resnet18", 100, "CIFAR100", compute_dtype=torch.bfloat16)
    model16.load_state_dict(state)
    again = prune_the_model(method, model16, ones, DENSITY, batch=batch)
    assert all(torch.equal(again[p], m) for p, m in masks.items())
    # Both packages in fp32 on the same weights and batch, the port's scores
    # against its float64 scores.
    model = create_model("resnet18", 100, "CIFAR100")
    model.load_state_dict(state)
    got = prune_the_model(method, model, ones, DENSITY, batch=batch)
    want = _jax_masks(method, state, batch)
    assert got.keys() == want.keys()
    assert sum(int(m.sum()) for m in got.values()) == sum(int(m.sum()) for m in want.values())
    assert sum(int((got[p] != want[p]).sum()) for p in got) <= 1e-3 * n
    exact = copy.deepcopy(model).double()
    for module in exact.modules():
        if hasattr(module, "dtype"):
            module.dtype = torch.float64
    exact.fc.forward = lambda z, fc=exact.fc: torch.nn.functional.linear(
        z.double(), fc.weight, fc.bias)  # the head's fp32 cast, in float64
    scores = _port_scores(method, model, ones, batch)
    ref = _port_scores(method, exact, ones, (batch[0].double(), batch[1]))
    jax32 = _jax_scores(method, state, batch, jnp.float32)
    with jax.enable_x64(True):
        jax64 = _jax_scores(method, state, batch, jnp.float64)
    for path, sc in scores.items():
        key = masking.state_key(path)
        top = ref[path].abs().max()

        def dist(a, r=ref[path], top=top):
            return float((a.double() - r).abs().max() / top)

        assert dist(jax64[key]) <= 1e-6, path
        assert dist(sc) <= max(2e-3, dist(jax32[key])), (path, dist(sc), dist(jax32[key]))
