"""flax <-> torch weight bridge (turboprune_tpu_torch/bridge.py): a round
trip of a tiny DeiT's params and masks, and of a small ResNet's params,
masks and batch_stats, is bit-exact, and the torch layout loads into the
port's model with the expected names and shapes."""

import jax
import numpy as np
import pytest

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, jax_masks, jax_params, seeded_variables
from turboprune_tpu.models import resnet as jresnet
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.models import resnet as tresnet
from turboprune_tpu_torch.models.vit import VisionTransformer
from turboprune_tpu_torch.ops import masking


def leaves(tree):
    return {
        jax.tree_util.keystr(p): v
        for p, v in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: x is None
        )[0]
    }


@pytest.mark.parametrize("distilled", [False, True])
def test_round_trip_is_bit_exact(distilled):
    params = jax_params(distilled)
    masks = jax_masks(params, seed=1)
    state, tmasks = bridge.params_from_flax(params, masks)
    back, back_masks = bridge.params_to_flax(state, tmasks, TINY["num_heads"])
    want, got = leaves(params), leaves(back)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    want_m, got_m = leaves(masks), leaves(back_masks)
    assert set(got_m) == set(want_m)
    for key in want_m:
        if want_m[key] is None:
            assert got_m[key] is None, key
        else:
            np.testing.assert_array_equal(got_m[key], want_m[key], err_msg=key)


@pytest.mark.parametrize("distilled", [False, True])
def test_torch_layout_loads_into_the_port_model(distilled):
    params = jax_params(distilled)
    state, tmasks = bridge.params_from_flax(params, jax_masks(params))
    model = VisionTransformer(**TINY, distilled=distilled, image_size=32)
    model.load_state_dict(state, strict=True)  # every name and shape lines up
    assert set(tmasks) == set(masking.make_masks(model))
    for path, m in tmasks.items():
        assert m.shape == state[masking.state_key(path)].shape, path
    # query kernel [D, H, hd] -> Linear weight [H*hd, D], out the other way
    q = params["block0"]["attn"]["query"]["kernel"]
    assert q.shape == (32, 2, 16)
    np.testing.assert_array_equal(
        state["block0.attn.query.weight"].numpy(), q.reshape(32, 32).T
    )
    np.testing.assert_array_equal(
        state["patch_embed.weight"].numpy(),
        params["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
    )


@pytest.mark.parametrize("name,cifar_stem", [("resnet18", True), ("resnet50", False)])
def test_resnet_round_trip_with_batch_stats_is_bit_exact(name, cifar_stem):
    """Conv kernels HWIO <-> OIHW, BatchNorm scale/bias <-> weight/bias,
    batch_stats {mean, var} <-> the BatchNorm buffers, fc [in, out] <->
    [out, in]; the masks keep their kernels' transforms."""
    jmodel = getattr(jresnet, name)(10, cifar_stem=cifar_stem, width=4)
    variables = seeded_variables(jmodel, 32, seed=2)
    masks = jax_masks(variables["params"], seed=3)
    state, tmasks = bridge.params_from_flax(variables["params"], masks, variables["batch_stats"])
    model = getattr(tresnet, name)(10, cifar_stem=cifar_stem, width=4)
    model.load_state_dict(state, strict=True)
    assert set(tmasks) == set(masking.make_masks(model))
    back, back_masks = bridge.params_to_flax(model.state_dict(), tmasks, 0)
    stats = bridge.batch_stats_to_flax(model.state_dict())
    for want, got in ((variables["params"], back), (variables["batch_stats"], stats),
                      (masks, back_masks)):
        want, got = leaves(want), leaves(got)
        assert set(got) == set(want)
        for key in want:
            if want[key] is None:
                assert got[key] is None, key
                continue
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    k = variables["params"]["conv1"]["kernel"]
    np.testing.assert_array_equal(state["conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["bn1.var"].numpy(), variables["batch_stats"]["bn1"]["var"])
