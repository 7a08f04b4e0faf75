"""The port's VGG and DenseNet (turboprune_tpu_torch/models/vgg.py,
densenet.py) against the JAX package's flax models, with the same weights
and batch statistics handed through the bridge, and dropout drawn from an
explicit generator (models/dropout.py, train.DropoutNoise). The JAX side
runs under ``jax.jit``. Small sizes: VGG-11-BN with ``fc_features=(32,
32)`` at 32 px (the adaptive pool broadcasts 1x1) and 64 px (uneven 2 ->
7 bins); DenseNet with blocks [2, 2, 2, 2], growth 8, 16 initial
features, CIFAR stem at 32 px and ImageNet stem at 64 px; 4 images.

Tolerances, fp32 (both sides compute the same fp32 convolutions and
BatchNorm in other summation orders): eval logits within rtol 1e-5 + atol
1e-5 (measured: 5.1e-7 at most). Train-mode logits within 5e-5: the last
stage normalises over 4 x 2 x 2 = 16 values a channel at 64 px, which
magnifies rounding; against a float64 forward of the same weights the
JAX package's fp32 logits (up to 2.6) lie up to 1.4e-5 away and the
port's 9.6e-6, and the two 1.3e-5 from each other. The running
statistics within rtol 1e-5 + atol 1e-6. Gradients: the whole within
1e-3 of its norm (measured: 2.3e-4 at most, VGG at 64 px), each kernel's
within 5e-3 (8.7e-4), each BatchNorm scale and bias and each dense bias
within 2e-2 (6.1e-3: small sums of large terms, as they are for the
ResNets against float64); a conv bias ahead of a train-mode BatchNorm has
gradient 0 in exact arithmetic, and both sides' stay below 1e-5 (8.5e-7). Full
size: the parameter trees of ``vgg16_bn`` and ``densenet121`` (names and
shapes) and their ERK and balanced per-layer densities equal the JAX
package's exactly. Dropout: exact at p = 0; at p = 0.5 the masks cannot
match JAX's threefry bits, so the test holds reproducibility from (seed,
step), the keep rate within 3 sigma of 0.5, the scale 2 of kept values,
and the compiled step (``aot_eager``) to the eager one on the same noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, seeded_params, seeded_variables
from turboprune_tpu.models import densenet as jdensenet
from turboprune_tpu.models import vgg as jvgg
from turboprune_tpu.models.vit import VisionTransformer as JaxViT
from turboprune_tpu.ops import masking as jmasking
from turboprune_tpu.pruning import balanced_densities as jax_balanced_densities
from turboprune_tpu.pruning import erk_densities as jax_erk_densities
from turboprune_tpu.pruning import prune_the_model as jax_prune_the_model
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.models import create_model
from turboprune_tpu_torch.models import densenet as tdensenet
from turboprune_tpu_torch.models import vgg as tvgg
from turboprune_tpu_torch.models.dropout import dropout
from turboprune_tpu_torch.models.vit import VisionTransformer
from turboprune_tpu_torch.ops import masking
from turboprune_tpu_torch.pruning import (
    balanced_densities,
    erk_densities,
    prune_the_model,
)
from turboprune_tpu_torch.train import DropoutNoise, compile_forward, train_forward

SMALL_VGG = dict(fc_features=(32, 32))
SMALL_DENSENET = dict(growth_rate=8, init_features=16)


def _vgg_pair(image, dropout_rate=0.0, seed=0):
    jmodel = jvgg.VGG(jvgg.VGG_CFGS["vgg11"], 10, dropout_rate=dropout_rate, **SMALL_VGG)
    variables = seeded_variables(jmodel, image, seed)
    tmodel = tvgg.vgg11_bn(10, dropout_rate=dropout_rate, **SMALL_VGG)
    return _load(jmodel, variables, tmodel)


def _densenet_pair(cifar_stem, image, seed=0):
    jmodel = jdensenet.DenseNet([2, 2, 2, 2], 10, cifar_stem=cifar_stem, **SMALL_DENSENET)
    variables = seeded_variables(jmodel, image, seed)
    tmodel = tdensenet.DenseNet([2, 2, 2, 2], 10, cifar_stem=cifar_stem, **SMALL_DENSENET)
    return _load(jmodel, variables, tmodel)


def _load(jmodel, variables, tmodel):
    state, _ = bridge.params_from_flax(variables["params"], None, variables["batch_stats"])
    tmodel.load_state_dict(state, strict=True)
    return jmodel, variables, tmodel


def _batch(n, image, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, image, image, 3)).astype(np.float32),
            rng.integers(0, 10, size=n).astype(np.int32))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def _check_against_jax(jmodel, variables, tmodel, image):
    """Eval logits; one train-mode step's logits, loss, running statistics
    and gradients."""
    x, y = _batch(4, image)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)

    def loss_fn(params, x, y):
        logits, updated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, y[:, None], axis=1).mean(), (logits, updated)

    (loss, (logits, updated)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], jnp.asarray(x), jnp.asarray(y))
    tmodel.train()
    noise = DropoutNoise(torch.device("cpu"), 0)(tmodel, 4, 0)
    assert noise is None  # no dropout at rate 0: nothing drawn
    out = train_forward(tmodel, masking.make_masks(tmodel), torch.from_numpy(x),
                        torch.from_numpy(y).long(), noise)
    out["loss"].backward()
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(logits), rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=1e-5)
    got_stats = _flat(bridge.batch_stats_to_flax(tmodel.state_dict()))
    want_stats = _flat(updated["batch_stats"])
    assert got_stats.keys() == want_stats.keys()
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    got_grads, _ = bridge.params_to_flax(
        {k: p.grad for k, p in tmodel.named_parameters()}, None, num_heads=1)
    got_grads, want_grads = _flat(got_grads), _flat(grads)
    assert got_grads.keys() == want_grads.keys()
    sq = sum(np.sum(w ** 2) for w in want_grads.values())
    diff = sum(np.sum((got_grads[k] - w) ** 2) for k, w in want_grads.items())
    assert np.sqrt(diff) <= 1e-3 * np.sqrt(sq)
    for k, w in want_grads.items():
        g = got_grads[k]
        if "conv" in k and "bias" in k:  # ahead of a train-mode BatchNorm: 0
            assert np.abs(g).max() < 1e-5 and np.abs(w).max() < 1e-5, k
            continue
        tol = 5e-3 if "kernel" in k else 2e-2
        assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w) + 1e-7, k


@pytest.mark.parametrize("image", [32, 64])
def test_vgg_matches_jax_eval_train_statistics_and_gradients(image):
    _check_against_jax(*_vgg_pair(image), image)


@pytest.mark.parametrize("cifar_stem,image", [(True, 32), (False, 64)], ids=["cifar", "imagenet"])
def test_densenet_matches_jax_eval_train_statistics_and_gradients(cifar_stem, image):
    _check_against_jax(*_densenet_pair(cifar_stem, image), image)


def test_bridge_round_trip_and_magnitude_masks():
    """Params, statistics and masks go both ways bit for bit; magnitude
    pruning keeps the JAX package's weights."""
    for jmodel, variables, tmodel in (_vgg_pair(64), _densenet_pair(False, 64)):
        params = jax.device_get(variables["params"])
        rng = np.random.default_rng(3)
        ones = jax.jit(jmasking.make_masks)(params)
        jmasks = jax.tree.map(lambda m: None if m is None else rng.random(m.shape) < 0.7,
                              ones, is_leaf=lambda m: m is None)
        state, masks = bridge.params_from_flax(params, jmasks, variables["batch_stats"])
        back, back_masks = bridge.params_to_flax(state, masks, num_heads=1)
        assert _flat(back).keys() == _flat(params).keys()
        for k, v in _flat(params).items():
            np.testing.assert_array_equal(_flat(back)[k], v)
        for k, v in _flat(jmasks).items():
            np.testing.assert_array_equal(_flat(back_masks)[k], v)
        for k, v in _flat(variables["batch_stats"]).items():
            np.testing.assert_array_equal(_flat(bridge.batch_stats_to_flax(state))[k], v)
        # Under jax.jit: op by op, the global threshold's sort and every
        # layer's compare compile one by one.
        want = jax.device_get(jax.jit(lambda v, m: jax_prune_the_model(
            "mag", jmodel, v, m, 0.3, jax.random.PRNGKey(0)))(variables, jmasks))
        _, want = bridge.params_from_flax(params, want)
        got = prune_the_model("mag", tmodel, masks, 0.3)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def _full_size():
    """name -> (JAX param shapes, JAX all-ones mask tree (no memory), the
    port's model on the meta device)."""
    out = {}
    for name, jctor in (("vgg16_bn", jvgg.vgg16_bn), ("densenet121", jdensenet.densenet121)):
        jmodel = jctor(1000)
        shapes = jax.eval_shape(lambda m=jmodel: m.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
        ones = jax.tree_util.tree_map_with_path(
            lambda p, s: np.broadcast_to(np.ones((), bool), s.shape)
            if jmasking.is_prunable_path(p) else None, shapes["params"])
        with torch.device("meta"):
            tmodel = create_model(name, 1000, "ImageNet")
        out[name] = (shapes, ones, tmodel)
    return out


def _flax_shapes(model):
    """{flax path: shape} of ``model``'s state_dict in the flax layout (the
    bridge's mapping, on shapes only: the model lives on the meta device)."""
    out = {}
    for key, t in model.state_dict().items():
        *module, leaf = key.split(".")
        group = "batch_stats" if leaf in ("mean", "var") else "params"
        shape = tuple(t.shape)
        if leaf == "weight":
            leaf = "kernel" if t.dim() > 1 else "scale"
            shape = {4: lambda s: (s[2], s[3], s[1], s[0]), 2: lambda s: s[::-1]}.get(
                t.dim(), lambda s: s)(shape)
        out["".join(f"['{p}']" for p in [group, *module, leaf])] = shape
    return out


def test_full_size_trees_and_layer_densities_equal_jax():
    for name, (shapes, jmasks, tmodel) in _full_size().items():
        want = {jax.tree_util.keystr(p): tuple(s.shape)
                for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        assert _flax_shapes(tmodel) == want, name
        masks = masking.make_masks(tmodel)
        for density in (0.05, 0.1, 0.5):
            for port, ref in ((erk_densities, jax_erk_densities),
                              (balanced_densities, jax_balanced_densities)):
                g, w = port(masks, density), ref(jmasks, density)
                assert list(g) == list(w), (name, port.__name__)  # the JAX leaf order
                assert g == w, (name, port.__name__, density)


def test_snip_on_vgg_applies_dropout_from_the_generator():
    """SNIP differentiates a train-mode forward, in which VGG's dropout
    draws from the criterion's generator: the same generator seed gives
    the same masks, and the density is exact."""
    _, _, model = _vgg_pair(32, dropout_rate=0.5)
    masks = masking.make_masks(model)
    x, y = _batch(4, 32)
    batch = (torch.from_numpy(x), torch.from_numpy(y).long())

    def snip(seed):
        return prune_the_model("snip", model, masks, 0.3, torch.Generator().manual_seed(seed),
                               batch)

    a, b = snip(0), snip(0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    n = sum(m.numel() for m in a.values())
    assert abs(sum(int(m.sum()) for m in a.values()) - round(0.3 * n)) <= 1
    with pytest.raises(ValueError, match="noise"):
        model.train()
        model(batch[0])


def test_dropout_at_half_is_reproducible_with_its_rate_and_scale():
    _, _, model = _vgg_pair(32, dropout_rate=0.5)
    model.train()
    draw = DropoutNoise(torch.device("cpu"), seed=7)
    n = 256
    noise = draw(model, n, step=3)
    assert [tuple(u.shape) for u in noise] == [(n, 32), (n, 32)]
    again = DropoutNoise(torch.device("cpu"), seed=7)(model, n, step=3)
    assert all(torch.equal(u, v) for u, v in zip(noise, again))
    assert not torch.equal(draw(model, n, step=4)[0], noise[0])
    assert not torch.equal(DropoutNoise(torch.device("cpu"), seed=8)(model, n, 3)[0], noise[0])
    x = torch.ones(n, 32) * 3.0
    out = dropout(x, 0.5, noise[0])
    kept = out != 0
    rate = kept.float().mean().item()
    assert abs(rate - 0.5) <= 3 * (0.25 / x.numel()) ** 0.5
    assert torch.equal(out[kept], torch.full_like(out[kept], 6.0))
    assert torch.equal(dropout(x, 0.0, noise[0]), x)
    x = torch.from_numpy(_batch(16, 32)[0])
    a = model(x, [u[:16] for u in noise])
    assert torch.equal(a, model(x, [u[:16] for u in again]))
    assert not torch.equal(a, model(x, draw(model, 16, step=4)))


def test_compiled_step_with_dropout_equals_the_eager_step():
    _, _, model = _vgg_pair(32, dropout_rate=0.5)
    model.train()
    masks = masking.make_masks(model)
    x, y = _batch(4, 32)
    x, y = torch.from_numpy(x), torch.from_numpy(y).long()
    noise = DropoutNoise(torch.device("cpu"), seed=0)(model, 4, step=0)
    compiled = compile_forward(train_forward, torch.device("cpu"))
    results = []
    for forward in (train_forward, compiled):
        model.zero_grad(set_to_none=True)
        state = {k: v.clone() for k, v in model.state_dict().items()}
        out = forward(model, masks, x, y, noise)
        out["loss"].backward()
        results.append((out["loss"].detach(), {k: p.grad.clone() for k, p in
                                               model.named_parameters()}))
        model.load_state_dict(state)
    (loss_e, grads_e), (loss_c, grads_c) = results
    torch.testing.assert_close(loss_c, loss_e, rtol=1e-6, atol=1e-6)
    for k in grads_e:
        torch.testing.assert_close(grads_c[k], grads_e[k], rtol=1e-5, atol=1e-6)


def test_vit_dropout_takes_the_step_noise():
    """A DeiT with a dropout rate trains on the step's noise (the refusal
    is gone); at rate 0 its train forward draws nothing and equals JAX's
    train mode."""
    jmodel = JaxViT(**TINY, attention_impl="dense")
    params = seeded_params(jmodel)
    model = VisionTransformer(**TINY, image_size=32, dropout_rate=0.0)
    state, _ = bridge.params_from_flax(params)
    model.load_state_dict(state)
    x, y = _batch(3, 32)
    model.train()
    assert DropoutNoise(torch.device("cpu"), 0)(model, 3, 0) is None
    got = train_forward(model, masking.make_masks(model), torch.from_numpy(x),
                        torch.from_numpy(y).long())["logits"]
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, train=True,
                                             rngs={"dropout": jax.random.PRNGKey(0)}))(
        params, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    model.dropout_rate = 0.5
    for block in model.blocks():
        block.mlp.dropout_rate = 0.5
    noise = DropoutNoise(torch.device("cpu"), 0)(model, 3, 0)
    assert [tuple(u.shape) for u in noise] == [(3, 5, 32)] + [(3, 5, 128), (3, 5, 32)] * 2
    a = train_forward(model, masking.make_masks(model), torch.from_numpy(x),
                      torch.from_numpy(y).long(), noise)
    assert torch.isfinite(a["loss"]) and not torch.allclose(a["logits"], got)
    with pytest.raises(ValueError, match="noise"):
        model(torch.from_numpy(x))
    assert F.softmax(a["logits"], -1).shape == (3, 10)
