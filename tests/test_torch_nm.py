"""N:M sparsity in the port (turboprune_tpu_torch/sparse/nm.py,
nm_execute.py, the models' ``nm_overrides``) against the JAX package's
(turboprune_tpu/sparse/nm.py, nm_execute.py).

Bit for bit against JAX, on seeded continuous scores: the per-block
solvers (in-axis and transposable, 2:4 and 1:4, with all-zero rows whose
ties go to the lower index), and ``project_masks`` on a depth-2 DeiT
(attention projections, MLP, the 10-class head that takes the input axis
only) and a ResNet-50 at width 16 (its 1x1 convolutions); the layer
reports; ``check_divisibility`` raising where JAX raises. fp32:
``nm_matmul``'s forward, dx, dw and db within rtol 1e-5 + atol 1e-5 of
the JAX custom VJP's, with ``ko`` None and set; its dw equal to the
masked-dense layer's (the full GEMM) and zero where the mask is; and the
gathered models (DeiT with dense and with flash attention, ResNet-50 with
gathered ``Conv_0`` and ``fc``) against their masked-dense selves in a
train-mode step: logits within 1e-5 and every parameter gradient within
1e-5 of its norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, jax_masks, jax_params, seeded_variables
from turboprune_tpu.models import resnet as jresnet
from turboprune_tpu.sparse import nm as jnm
from turboprune_tpu.sparse.nm_execute import nm_matmul as jnm_matmul
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.models import resnet, vit
from turboprune_tpu_torch.ops import masking
from turboprune_tpu_torch.sparse import nm
from turboprune_tpu_torch.sparse.nm_execute import NMDense, build_nm_plan, nm_matmul
from turboprune_tpu_torch.train import masked_forward

RESNET50 = dict(stage_sizes=[3, 4, 6, 3], num_classes=10, cifar_stem=True, width=16)


# The JAX solvers under jax.jit (n, m and iters static): op by op, their
# vmapped top-k and alternating maximisation compile every primitive at
# every new shape, ~25 s for the ResNet-50's layers.
_JIT_INAXIS = jax.jit(jnm.nm_pattern_inaxis, static_argnames=("n", "m"))
_JIT_TRANSPOSABLE = jax.jit(jnm.nm_pattern_transposable, static_argnames=("n", "m", "iters"))


@pytest.fixture
def jitted_solvers(monkeypatch):
    """``jnm.project_masks`` calls the jitted solvers."""
    monkeypatch.setattr(jnm, "nm_pattern_inaxis", _JIT_INAXIS)
    monkeypatch.setattr(jnm, "nm_pattern_transposable", _JIT_TRANSPOSABLE)


def _scores(i, o, seed):
    """Seeded continuous |N(0, 1)| scores with many all-zero rows and
    columns (pruned weights score 0), so blocks hold ties."""
    rng = np.random.default_rng(seed)
    s = np.abs(rng.normal(size=(i, o))).astype(np.float32)
    s[rng.random(i) < 0.5] = 0.0
    s[:, rng.random(o) < 0.3] = 0.0
    return s


def test_solvers_equal_jax():
    for seed, (n, m, i, o) in enumerate([(2, 4, 64, 48), (1, 4, 128, 8), (2, 4, 32, 256),
                                         (1, 4, 64, 48)]):
        s = _scores(i, o, seed)
        got = nm.nm_pattern_inaxis(torch.from_numpy(s), n, m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(_JIT_INAXIS(jnp.asarray(s), n=n, m=m)))
        gi, go = nm.nm_pattern_transposable(torch.from_numpy(s), n, m)
        wi, wo = _JIT_TRANSPOSABLE(jnp.asarray(s), n=n, m=m)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
        assert (gi.reshape(-1, m).sum(1) == n).all() and (go.reshape(-1, m).sum(1) == n).all()
    # A block of ties keeps its first n, as lax.top_k does.
    assert nm.nm_pattern_inaxis(torch.zeros(8, 3), 2, 4).tolist() == [True, True, False, False] * 2


def _model(name):
    """(jax params, jax masks, port state_dict, port masks) of the DeiT or
    the ResNet-50."""
    if name == "deit":
        params = jax_params(seed=3)
        masks = jax_masks(params, seed=3)
        return (params, masks, *bridge.params_from_flax(params, masks))
    jres = jresnet.ResNet(block_cls=jresnet.Bottleneck, **RESNET50)
    variables = seeded_variables(jres, 32, seed=4)
    params = jax.tree.map(np.array, variables["params"])
    masks = jax_masks(params, seed=4)
    return (params, masks, *bridge.params_from_flax(params, masks, variables["batch_stats"]))


@pytest.mark.parametrize("name", ["deit", "resnet50"])
def test_project_masks_equal_jax(name, jitted_solvers):
    params, masks, state, tmasks = _model(name)
    patterns = [(2, 4, True), (1, 4, True), (2, 4, False)] if name == "deit" else [(2, 4, True)]
    for n, m, transposable in patterns:
        want, wreport = jnm.project_masks(params, masks, n, m, transposable)
        got, report = nm.project_masks(state, tmasks, n, m, transposable)
        _, want_t = bridge.params_from_flax(params, jax.device_get(want))
        assert list(got) == list(tmasks)
        for path in want_t:
            assert torch.equal(got[path], want_t[path]), (n, m, transposable, path)
            assert not (got[path] & ~tmasks[path]).any()  # monotone
        assert report["layers"] == wreport["layers"]
        assert report["preserved_magnitude_frac"] == pytest.approx(
            wreport["preserved_magnitude_frac"], rel=1e-6)
        # A 10-class head takes the pattern on its input axis only.
        head = "head/kernel" if name == "deit" else "fc/kernel"
        assert report["layers"][head]["axes"] == "in"


def test_check_divisibility_raises_where_jax_raises():
    for name in ("deit", "resnet50"):
        params, masks, state, tmasks = _model(name)
        for m_block in (2, 3, 4, 5, 8, 16, 64, 128):
            try:
                jnm.check_divisibility(masks, m_block)
                want = None
            except jnm.NMError as e:
                want = str(e)
            if want is None:
                nm.check_divisibility(tmasks, m_block)
            else:
                with pytest.raises(nm.NMError, match="not divisible"):
                    nm.check_divisibility(tmasks, m_block)
        assert [e[0] for e in nm.eligible_layers(tmasks)] == [
            e[0] for e in jnm.eligible_layers(masks)], name


def _nm_case(transposable, seed=0, b=6, i=64, o=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, i)).astype(np.float32)
    w = rng.normal(size=(i, o)).astype(np.float32)
    bias = rng.normal(size=(o,)).astype(np.float32)
    dy = rng.normal(size=(b, o)).astype(np.float32)
    scores = np.abs(w)
    if transposable:
        ki, ko = jnm.nm_pattern_transposable(jnp.asarray(scores), 2, 4)
    else:
        ki, ko = jnm.nm_pattern_inaxis(jnp.asarray(scores), 2, 4), None
    ki = tuple(int(v) for v in np.flatnonzero(np.asarray(ki)))
    ko = None if ko is None else tuple(int(v) for v in np.flatnonzero(np.asarray(ko)))
    mask = np.zeros((i, o), bool)
    mask[np.ix_(ki, ko if ko is not None else range(o))] = True
    return x, w * mask, bias, dy, ki, ko, mask


@pytest.mark.parametrize("transposable", [False, True], ids=["ko-none", "ko-set"])
def test_nm_matmul_matches_jax_vjp(transposable):
    x, w, bias, dy, ki, ko, _ = _nm_case(transposable)
    y_j, vjp = jax.vjp(lambda a, b_, c: jnm_matmul(ki, ko, a, b_, c),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    dx_j, dw_j, db_j = vjp(jnp.asarray(dy))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    y = nm_matmul(ki, ko, xt, wt, bt)
    y.backward(torch.from_numpy(dy))
    for got, want in ((y.detach(), y_j), (xt.grad, dx_j), (wt.grad, dw_j), (bt.grad, db_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dw_equals_masked_dense():
    """NMDense against nn.Linear under the same mask: forward, dx, and the
    raw weight's gradient (masked-dense's, zero where the mask is)."""
    x, w, bias, dy, ki, ko, mask = _nm_case(True, seed=1)
    torch.manual_seed(0)
    raw = torch.randn(w.shape[1], w.shape[0])
    mask_t = torch.from_numpy(mask.T.copy())
    grads = []
    for layer in (torch.nn.Linear(*w.shape), NMDense(*w.shape, ki, ko)):
        layer.weight.data.copy_(raw)
        layer.bias.data.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x).requires_grad_()
        y = torch.func.functional_call(layer, {"weight": layer.weight * mask_t,
                                               "bias": layer.bias}, (xt,))
        y.backward(torch.from_numpy(dy))
        grads.append((y.detach(), xt.grad, layer.weight.grad, layer.bias.grad))
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(grads[1][2] == 0, ~mask_t | (grads[0][2] == 0))


def _grads(model, masks, x, y):
    model.zero_grad(set_to_none=True)
    logits = masked_forward(model, masks, x)
    F.cross_entropy(logits, y, reduction="sum").backward()
    return logits.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("family", ["deit-dense", "deit-flash", "resnet50"])
def test_gathered_models_match_masked_dense(family):
    if family.startswith("deit"):
        params = jax_params(seed=5)
        state, masks = bridge.params_from_flax(params, jax_masks(params, seed=5))
        impl = family.split("-")[1]
        build = lambda **kw: vit.VisionTransformer(**TINY, image_size=32, attention_impl=impl, **kw)
    else:
        jres = jresnet.ResNet(block_cls=jresnet.Bottleneck, **RESNET50)
        variables = seeded_variables(jres, 32, seed=6)
        state, masks = bridge.params_from_flax(
            variables["params"], jax_masks(variables["params"], seed=6), variables["batch_stats"])
        build = lambda **kw: resnet.ResNet(block_cls=resnet.Bottleneck, **RESNET50, **kw)
    masks, _ = nm.project_masks(state, masks, 2, 4)
    dense = build()
    dense.load_state_dict(state)
    plan = build_nm_plan(dense, masks)
    gathered = build(nm_overrides=plan.overrides)
    gathered.load_state_dict(state)
    routed = set(plan.overrides)
    if family == "deit-dense":
        assert {"block0/attn/query", "block1/mlp/fc2", "head"} <= routed
    elif family == "deit-flash":
        assert routed == {f"block{i}/mlp/fc{j}" for i in range(2) for j in (1, 2)} | {"head"}
    else:
        assert {"fc", "layer1_0/Conv_0", "layer4_2/Conv_0"} <= routed
        assert type(gathered.layer1_0.Conv_0).__name__ == "NMConv1x1"
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 4))
    dense.train()
    gathered.train()
    want_logits, want = _grads(dense, masks, x, y)
    got_logits, got = _grads(gathered, masks, x, y)
    torch.testing.assert_close(got_logits, want_logits, rtol=1e-5, atol=1e-5)
    assert masking.make_masks(gathered).keys() == masks.keys()
    for k in want:
        err = float((got[k] - want[k]).norm() / want[k].norm().clamp_min(1e-30))
        assert err <= 1e-5, (k, err)
