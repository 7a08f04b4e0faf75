"""flax <-> torch weight bridge (turboprune_tpu_torch/bridge.py): a round
trip of a tiny DeiT's params and masks is bit-exact, and the torch layout
loads into the port's model with the expected names and shapes."""

import jax
import numpy as np
import pytest

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, jax_masks, jax_params
from turboprune_tpu_torch import bridge
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
