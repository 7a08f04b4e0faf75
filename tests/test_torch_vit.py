"""The port's DeiT (turboprune_tpu_torch/models/vit.py) against the JAX
model on a tiny DeiT. JAX params go through the bridge; the JAX side runs
its flash attention as tests/test_flash.py does (Pallas interpret mode on
the CPU). fp32 logits agree within atol 1e-5: both sides compute in fp32
and differ only in summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, images, jax_deit, jax_params
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.models import NOT_YET_PORTED, create_model
from turboprune_tpu_torch.models import vit as tvit


@pytest.mark.parametrize("distilled", [False, True])
def test_logits_match_jax_flash(distilled):
    params = jax_params(distilled, seed=2)
    x = images(3, seed=2)
    # One compiled program: the Pallas kernel in interpret mode runs op by
    # op otherwise, ~4x slower on the CPU.
    ref = np.asarray(jax.jit(jax_deit("flash", distilled).apply)({"params": params}, x))
    state, _ = bridge.params_from_flax(params)
    for impl in ("dense", "flash"):
        model = tvit.VisionTransformer(
            **TINY, distilled=distilled, image_size=32, attention_impl=impl
        )
        model.load_state_dict(state)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=impl)


def test_bf16_forward_keeps_the_flax_dtype_flow():
    params = jax_params(seed=3)
    x = images(2, seed=3)
    ref = np.asarray(
        jax_deit("dense", dtype=jnp.bfloat16).apply({"params": params}, x)
    )
    state, _ = bridge.params_from_flax(params)
    model = tvit.VisionTransformer(**TINY, image_size=32, dtype=torch.bfloat16)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the head runs in fp32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # bf16 keeps ~3 significant digits through two blocks.
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-2, rtol=0)


def test_registry_and_constructor_contracts():
    model = create_model("deit_small_patch16_224", 1000, "ImageNet")
    assert (model.embed_dim, model.depth, len(model.blocks())) == (384, 12, 12)
    assert model.pos_embed.shape == (1, 197, 384)
    assert model.block0.attn.num_heads == 6
    # Ring attention needs the mesh it shards the tokens over, as in the
    # JAX package (tests/test_torch_ring.py runs it).
    with pytest.raises(ValueError, match="attention_impl='ring' needs a mesh"):
        create_model("deit_tiny_patch16_224", 10, attention_impl="ring", image_size=32)
    assert "resnet18" not in NOT_YET_PORTED  # the ResNets are ported
    for name in ("vgg11", "vgg16_bn", "densenet121"):  # ported since
        assert name not in NOT_YET_PORTED
        with torch.device("meta"):
            assert create_model(name, 10).num_classes == 10
    assert NOT_YET_PORTED == ()
    # The sparse execution's constructor knobs (sparse/): a compacted MLP,
    # gathered projections under dense attention only.
    small = tvit.VisionTransformer(**TINY, image_size=32, width_overrides={"block1/mlp/fc1": 8})
    assert small.block1.mlp.fc1.out_features == small.block1.mlp.fc2.in_features == 8
    assert small.block0.mlp.fc1.out_features == 4 * TINY["embed_dim"]
    hook = {"block0/attn/query": ((0, 1), None)}
    assert tvit.VisionTransformer(**TINY, image_size=32, nm_overrides=hook).block0.attn.query.kept_in.tolist() == [0, 1]
    with pytest.raises(ValueError, match="attention_impl='dense'"):
        tvit.VisionTransformer(**TINY, image_size=32, attention_impl="flash", nm_overrides=hook)
