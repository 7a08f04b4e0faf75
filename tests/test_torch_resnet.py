"""The port's ResNet family (turboprune_tpu_torch/models/resnet.py) against
the JAX package's flax ResNet, with the same weights and batch statistics
handed through the bridge. The JAX side is called without ``jax.jit``,
but for ResNet-50, whose 53 layers compile op by op in ~10 s on the CPU
and as one program under ``jax.jit`` in ~4 s.

Tolerances, fp32 (both sides compute the same fp32 convolutions and
BatchNorm in other summation orders):
- ResNet-18 (CIFAR stem, width 8): eval and train-mode logits within
  rtol 1e-5 + atol 1e-5; the running statistics after 1 and 3 train-mode
  forwards within rtol 1e-5 + atol 1e-6.
- ResNet-50 (ImageNet stem, width 4, 64x64, 8 images): eval logits within
  rtol 1e-5 + atol 1e-5. In train mode the deepest stage normalises over
  2 x 2 x 8 = 32 values a channel, which magnifies rounding: the JAX
  package's own fp32 forward lies 1.4e-3 from a float64 forward of the
  same weights (logits up to 2.5), the port's 1.0e-4. So the port is held
  within 5e-4 of the float64 forward and within 2e-3 of the JAX package,
  its running statistics within rtol 5e-4 + atol 1e-5.
- bf16 (ResNet-18, width 8): both round every convolution's output and
  every BatchNorm's to bf16 (8 bits of mantissa) in other places; logits
  within 0.05 of the JAX package's at logits of O(1), where a wrong layer
  moves them by O(1) (measured: 2.4e-7 in eval mode, 0.027 in train
  mode, whose batch statistics over 4 images amplify the roundings).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import seeded_variables
from turboprune_tpu.models import resnet as jresnet
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.models import NOT_YET_PORTED, create_model
from turboprune_tpu_torch.models import resnet as tresnet
from turboprune_tpu_torch.ops import masking

FACTORIES = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
             "wide_resnet50_2", "wide_resnet101_2")


def _pair(name, cifar_stem, width, image, seed=0, dtype=torch.float32):
    """(flax model, its numpy variables, the port's model on the same
    weights and statistics)."""
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jmodel = getattr(jresnet, name)(10, cifar_stem=cifar_stem, width=width, dtype=jdtype)
    variables = seeded_variables(jmodel, image, seed)
    state, _ = bridge.params_from_flax(variables["params"], None, variables["batch_stats"])
    tmodel = getattr(tresnet, name)(10, cifar_stem=cifar_stem, width=width, dtype=dtype)
    tmodel.load_state_dict(state, strict=True)
    return jmodel, variables, tmodel


def _images(n, size, seed=1):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _conv_variables(conv, x):
    shape = jax.eval_shape(lambda: conv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    kernel = shape["params"]["kernel"].shape
    return {"params": {"kernel": np.random.default_rng(7).normal(size=kernel).astype(np.float32)}}


def _check_stats(tmodel, want, rtol, atol, msg):
    got = bridge.batch_stats_to_flax(tmodel.state_dict())
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(want))[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        np.testing.assert_allclose(flat_got[path], w, rtol=rtol, atol=atol,
                                   err_msg=f"{msg} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("image", [16, 15], ids=["even", "odd"])
def test_resnet18_eval_and_train_mode_match_jax(image):
    """16 pads the stride-2 convs (0, 1), 15 pads them (1, 1)."""
    jmodel, variables, tmodel = _pair("resnet18", True, 8, image)
    x = _images(4, image)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)

    tmodel.train()
    stats = variables["batch_stats"]
    train_apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))
    for n in range(1, 4):
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x)).numpy()
        want, updated = train_apply(
            {"params": variables["params"], "batch_stats": stats}, jnp.asarray(x))
        stats = updated["batch_stats"]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=f"forward {n}")
        if n in (1, 3):
            _check_stats(tmodel, stats, 1e-5, 1e-6, f"forward {n}")


def test_resnet50_imagenet_stem_matches_jax():
    jmodel, variables, tmodel = _pair("resnet50", False, 4, 64)
    x = _images(8, 64)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)

    state = tmodel.state_dict()
    tmodel.train()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    want, updated = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    exact = tresnet.resnet50(10, cifar_stem=False, width=4, dtype=torch.float64).double()
    exact.load_state_dict(state)
    exact.train()
    with torch.no_grad():
        # The head casts its input to fp32; in float64 it runs on the pooled
        # float64 features instead.
        exact.fc.forward = lambda z, fc=exact.fc: torch.nn.functional.linear(
            z.double(), fc.weight, fc.bias)
        ref = exact(torch.from_numpy(x).double()).numpy()
    assert np.abs(got - ref).max() <= 5e-4
    assert np.abs(got - np.asarray(want)).max() <= 2e-3
    _check_stats(tmodel, updated["batch_stats"], 5e-4, 1e-5, "train")


def test_resnet18_bf16_logits_match_jax():
    jmodel, variables, tmodel = _pair("resnet18", True, 8, 16, dtype=torch.bfloat16)
    x = _images(4, 16)
    for train in (False, True):
        tmodel.train(train)
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x))
        out = jmodel.apply(variables, jnp.asarray(x), train=train,
                           mutable=["batch_stats"] if train else False)
        want = np.asarray(out[0] if train else out)
        assert got.dtype == torch.float32  # the head runs in fp32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.05,
                                   err_msg=f"train={train}")


@pytest.mark.parametrize("size", [15, 16])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 2), (7, 2)])
def test_same_padding_matches_flax_conv(size, kernel, stride):
    import flax.linen as fnn

    x = _images(2, size, seed=size)
    conv = fnn.Conv(5, (kernel, kernel), strides=(stride, stride), use_bias=False)
    variables = _conv_variables(conv, x)
    want = conv.apply(variables, jnp.asarray(x))
    port = tresnet.Conv(3, 5, kernel, stride)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    low, high = tresnet.same_padding(size, kernel, stride)
    out = math.ceil(size / stride)
    assert low + high == max((out - 1) * stride + kernel - size, 0) and low == (low + high) // 2


def test_names_buffers_and_init_at_full_width():
    """ResNet-18 with the CIFAR stem at its published width: 11.17M
    parameters named as flax's, BatchNorm buffers ``mean``/``var`` only,
    flax's initializers."""
    jmodel = jresnet.resnet18(10, cifar_stem=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want, _ = bridge.params_from_flax(zeros["params"], None, zeros["batch_stats"])
    model = create_model("resnet18", 10, "CIFAR10")
    model.init_weights(torch.Generator().manual_seed(0))
    state = model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert sum(p.numel() for p in model.parameters()) == 11_173_962
    assert not any("num_batches_tracked" in k for k in state)
    assert {k.rsplit(".", 1)[-1] for k, _ in model.named_buffers()} == {"mean", "var"}
    prunable = dict(masking.prunable_modules(model))
    assert len(prunable) == 21 and "fc" in prunable and "bn1" not in prunable
    for name, module in prunable.items():
        w = module.weight
        if name == "fc":
            std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
            assert w.abs().max() <= 2 * std and not module.bias.any()
        else:
            fan_out = w.shape[0] * w.shape[2] * w.shape[3]
            assert abs(float(w.detach().std()) / math.sqrt(2.0 / fan_out) - 1) < 0.1, name
    for k, v in state.items():
        leaf = k.rsplit(".", 1)[-1]
        if k.split(".")[-2].startswith(("bn", "BatchNorm", "downsample_bn")):
            expect = {"weight": 1.0, "var": 1.0, "bias": 0.0, "mean": 0.0}[leaf]
            assert bool((v == expect).all()), k


@pytest.mark.parametrize("name", FACTORIES)
def test_every_factory_has_the_jax_variable_tree(name):
    jmodel = getattr(jresnet, name)(10, cifar_stem=False, width=4)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want, _ = bridge.params_from_flax(zeros["params"], None, zeros["batch_stats"])
    model = getattr(tresnet, name)(10, cifar_stem=False, width=4)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in want.items()}


def test_create_model_stems_and_refusals():
    cifar = create_model("resnet18", 10, "CIFAR10", compute_dtype=torch.bfloat16)
    assert cifar.cifar_stem and cifar.conv1.kernel_size == (3, 3)
    assert cifar.dtype == torch.bfloat16
    imagenet = create_model("resnet50", 1000, "ImageNet")
    assert not imagenet.cifar_stem and imagenet.conv1.kernel_size == (7, 7)
    with pytest.raises(ValueError, match="requires a ViT"):
        create_model("resnet18", 10, "CIFAR10", attention_impl="flash")
    for name in ("vgg16", "densenet121"):  # ported: they build
        assert name not in NOT_YET_PORTED
        with torch.device("meta"):
            assert create_model(name, 10, "CIFAR10").num_classes == 10
    # The sparse execution's constructor knobs (sparse/): a compacted
    # block-internal width, a gathered head.
    small = create_model("resnet18", 10, "CIFAR10", width_overrides={"layer1_0/Conv_0": 3})
    assert small.layer1_0.Conv_0.out_channels == small.layer1_0.Conv_1.in_channels == 3
    gathered = create_model("resnet18", 10, "CIFAR10", nm_overrides={"fc": ((0,), (0,))})
    assert type(gathered.fc).__name__ == "NMDense" and gathered.fc.kept_in.tolist() == [0]
