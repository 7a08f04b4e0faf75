"""Dead-channel compaction in the port (turboprune_tpu_torch/sparse/graph.py,
compact.py, the models' ``width_overrides``) against the JAX package's
(turboprune_tpu/sparse/), for the four families at small sizes: VGG-11-BN
with ``fc_features=(32, 32)``, ResNet-18 (BasicBlock) and ResNet-50
(Bottleneck) at width 16 with the CIFAR stem, DenseNet-121 with the CIFAR
stem, and a depth-2 DeiT (embed 32), all at 32 px.

Inputs come from numpy seeds: the JAX variables (``seeded_variables``:
BatchNorm biases and running means of +-0.1, so about half the dead
channels keep a nonzero relu(bn(0)) residue), handed to the port through
``bridge.py``, and channel-structured masks (a seeded 40% of every
prunable kernel's output channels killed, plus 10% scattered zeros; the
ViT's dead fc1 units get a zero bias in a seeded half, so GELU's residue
lets them go).

Bit for bit against JAX: the propagation graph (spaces, producers,
attached leaves, gates, consumers, repeats), the keep vectors, the report
(per-space kept / dead / blocked_residue counts, params before and after),
``CompactionPlan.savings()``, the width overrides, the sliced params,
masks and BatchNorm statistics, and their expansion with and without an
anchor. fp32: the compacted model's eval logits (``compact_params``,
rebuilt through ``create``-time ``width_overrides``) within rtol 1e-5 +
atol 1e-5 of the masked-dense forward.
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import seeded_variables
from turboprune_tpu import sparse as jsparse
from turboprune_tpu.models import densenet as jdensenet
from turboprune_tpu.models import resnet as jresnet
from turboprune_tpu.models import vgg as jvgg
from turboprune_tpu.models import vit as jvit
from turboprune_tpu.ops import masking as jmasking
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch import sparse
from turboprune_tpu_torch.models import densenet, resnet, vgg, vit
from turboprune_tpu_torch.sparse.graph import model_leaves, state_key
from turboprune_tpu_torch.train import masked_forward

IMAGE = 32
VIT = dict(num_classes=10, patch_size=16, embed_dim=32, depth=2, num_heads=2)
FAMILIES = {
    "vgg": (lambda: jvgg.VGG(jvgg.VGG_CFGS["vgg11"], 10, fc_features=(32, 32)),
            lambda **kw: vgg.VGG(vgg.VGG_CFGS["vgg11"], 10, fc_features=(32, 32), **kw)),
    "resnet18": (lambda: jresnet.ResNet([2, 2, 2, 2], jresnet.BasicBlock, 10, cifar_stem=True,
                                        width=16),
                 lambda **kw: resnet.ResNet([2, 2, 2, 2], resnet.BasicBlock, 10, cifar_stem=True,
                                            width=16, **kw)),
    "resnet50": (lambda: jresnet.ResNet([3, 4, 6, 3], jresnet.Bottleneck, 10, cifar_stem=True,
                                        width=16),
                 lambda **kw: resnet.ResNet([3, 4, 6, 3], resnet.Bottleneck, 10, cifar_stem=True,
                                            width=16, **kw)),
    "densenet121": (lambda: jdensenet.densenet121(10, cifar_stem=True),
                    lambda **kw: densenet.densenet121(10, cifar_stem=True, **kw)),
    "vit": (lambda: jvit.VisionTransformer(**VIT),
            lambda **kw: vit.VisionTransformer(**VIT, image_size=IMAGE, **kw)),
}


def _setup(family, seed=0):
    """(jax model, jax params, jax stats, jax masks, port model, port
    params, port stats, port masks) with channel-structured masks."""
    jctor, tctor = FAMILIES[family]
    jmodel = jctor()
    variables = seeded_variables(jmodel, IMAGE, seed)
    params = jax.tree.map(np.array, variables["params"])
    stats = jax.tree.map(np.array, variables.get("batch_stats", {}))
    rng = np.random.default_rng(seed + 1)

    def draw(m):
        if m is None:
            return None
        keep = rng.random(m.shape) >= 0.1
        keep[..., rng.random(m.shape[-1]) < 0.4] = False
        return keep

    masks = jax.tree.map(draw, jmasking.make_masks(params), is_leaf=lambda x: x is None)
    if family == "vit":
        for i in range(VIT["depth"]):
            dead = ~masks[f"block{i}"]["mlp"]["fc1"]["kernel"].any(axis=0)
            zero = dead & (rng.random(dead.shape) < 0.5)
            params[f"block{i}"]["mlp"]["fc1"]["bias"][zero] = 0.0
    state, tmasks = bridge.params_from_flax(params, masks, stats)
    tmodel = tctor()
    tmodel.load_state_dict(state, strict=True)
    tparams, tstats = model_leaves(tmodel)
    return jmodel, params, stats, masks, tmodel, tparams, tstats, tmasks


def _jpath(path):
    return "/".join(path)


def _jgate(gate):
    return tuple((op[0], _jpath(op[1]), op[2]) if op[0] == "bn" else op for op in gate)


def _to_port(params=None, masks=None, stats=None):
    """A JAX (params, masks, stats) subtree in the port's layout, keyed by
    state_dict name (params and stats) or flax path (masks)."""
    state, tmasks = bridge.params_from_flax(params or {}, masks, stats)
    return state, tmasks


def _by_key(tree):
    return {state_key(p): t for p, t in tree.items() if t is not None}


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_graph_plan_and_trees_equal_jax(family):
    jmodel, params, stats, masks, tmodel, tparams, tstats, tmasks = _setup(family)
    jgraph = jsparse.build_graph(jmodel, params)
    graph = sparse.build_graph(tmodel, tparams)
    assert graph.arch == jgraph.arch
    assert list(graph.spaces) == list(jgraph.spaces)
    for name, jsp in jgraph.spaces.items():
        sp = graph.spaces[name]
        assert (sp.channels, sp.override_key) == (jsp.channels, jsp.override_key)
        assert sp.producer.kernel == _jpath(jsp.producer.kernel)
        assert sp.producer.bias == (None if jsp.producer.bias is None
                                    else _jpath(jsp.producer.bias))
        assert sp.attached_params == [_jpath(p) for p in jsp.attached_params]
        assert sp.attached_stats == [_jpath(p) for p in jsp.attached_stats]
        assert sp.post == _jgate(jsp.post)
    assert len(graph.consumers) == len(jgraph.consumers)
    for c, jc in zip(graph.consumers, jgraph.consumers):
        assert (c.kernel, c.segments, c.repeat) == (_jpath(jc.kernel), jc.segments, jc.repeat)
        assert c.gate == _jgate(jc.gate)
        assert c.attached_params == tuple(_jpath(p) for p in jc.attached_params)
        assert c.attached_stats == tuple(_jpath(p) for p in jc.attached_stats)

    jplan = jsparse.build_plan(params, masks, jgraph, stats)
    plan = sparse.build_plan(tparams, tmasks, graph, tstats)
    assert plan.keeps.keys() == jplan.keeps.keys()
    for name in jplan.keeps:
        np.testing.assert_array_equal(plan.keeps[name], jplan.keeps[name])
    assert plan.report == jplan.report
    assert plan.savings() == jplan.savings() > 0.0
    assert plan.width_overrides == jplan.width_overrides
    assert sparse.width_signature(plan) == jsparse.width_signature(jplan)
    # The residue guard did its work: dead channels with a nonzero
    # relu(bn(0)) (or GELU) residue were kept, others removed.
    spaces = plan.report["spaces"].values()
    assert sum(s["blocked_residue"] for s in spaces) > 0
    assert sum(s["dead"] - s["blocked_residue"] for s in spaces) > 0

    # The sliced params, masks and statistics, then expanded back.
    jp, jm, js = (jsparse.compact_tree(params, jplan), jsparse.compact_tree(masks, jplan),
                  jsparse.compact_stats(stats, jplan))
    p, m, s = (sparse.compact_tree(tparams, plan), sparse.compact_tree(tmasks, plan),
               sparse.compact_stats(tstats, plan))
    want_state, want_masks = _to_port(jp, jm, js)
    _assert_equal(_by_key({**p, **s}), want_state)
    _assert_equal(m, want_masks)

    # Expanded: over the anchor, and with zeros (False for masks).
    for anchor in (True, False):
        je = jsparse.expand_tree(jp, jplan, anchor=params if anchor else None)
        jse = jsparse.expand_stats(js, jplan, anchor=stats if anchor else None)
        e = sparse.expand_tree(p, plan, anchor=tparams if anchor else None)
        se = sparse.expand_stats(s, plan, anchor=tstats if anchor else None)
        want_state, _ = _to_port(je, None, jse)
        _assert_equal(_by_key({**e, **se}), want_state)
    _, want_masks = _to_port(params, jsparse.expand_tree(jm, jplan))
    _assert_equal(sparse.expand_tree(m, plan), want_masks)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_compacted_eval_logits_match_masked_dense(family):
    jmodel, params, stats, masks, tmodel, tparams, tstats, tmasks = _setup(family)
    res = sparse.compact_params(tparams, tmasks, sparse.build_graph(tmodel, tparams), tstats)
    jres = jsparse.compact_params(params, masks, jsparse.build_graph(jmodel, params), stats)
    assert res.width_overrides == jres.width_overrides
    assert res.report["params_after"] < res.report["params_before"]
    small = FAMILIES[family][1](width_overrides=res.width_overrides)
    small.load_state_dict(_by_key({**res.params, **res.batch_stats}), strict=True)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(4, IMAGE, IMAGE, 3))
                         .astype(np.float32))
    tmodel.eval()
    small.eval()
    with torch.no_grad():
        want = masked_forward(tmodel, tmasks, x)
        got = small(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("optimizer", ["SGD", "AdamW"])
def test_train_state_slices_and_expands_the_optimizer(optimizer):
    """compact_train_state / expand_train_state on ResNet-18 after one
    optimizer step: the small optimizer holds the sliced momentum (or
    Adam's moments and step, copied, not shared); after the small state
    moves, the expansion gives kept coordinates the small values, removed
    params the anchor's and removed moments zeros."""
    from turboprune_tpu_torch.sparse.graph import flax_path
    from turboprune_tpu_torch.sparse.train_compact import param_paths
    from turboprune_tpu_torch.train import create_optimizer, create_train_state

    _, _, _, _, tmodel, tparams, tstats, tmasks = _setup("resnet18")
    make = create_optimizer(optimizer, momentum=0.9, weight_decay=0.0)
    state = create_train_state(tmodel, make, tmasks)
    for p in tmodel.parameters():
        p.grad = torch.randn_like(p)
    state.optimizer.param_groups[0]["lr"] = 0.1
    state.optimizer.step()
    plan = sparse.build_plan(tparams, tmasks, sparse.build_graph(tmodel, tparams), tstats)
    anchor = {k: v.clone() for k, v in tmodel.state_dict().items()}
    full_opt = {i: {n: v.clone() for n, v in s.items()} for i, s in
                state.optimizer.state_dict()["state"].items()}
    small = FAMILIES["resnet18"][1](width_overrides=plan.width_overrides)
    small_state = sparse.compact_train_state(state, plan, small, make)
    paths = param_paths(tmodel)
    moments = [n for n in full_opt[0] if n != "step"]
    for i, entry in small_state.optimizer.state_dict()["state"].items():
        ik, ok = plan.in_keep.get(paths[i]), plan.out_keep.get(paths[i])
        for n in moments:
            want = full_opt[i][n]
            if ik is not None:
                want = want[:, torch.from_numpy(ik)]
            if ok is not None:
                want = want[torch.from_numpy(ok)]
            assert torch.equal(entry[n], want), (paths[i], n)
    with torch.no_grad():
        for p in small.parameters():
            p.add_(1.0)
    for s in small_state.optimizer.state.values():
        for n in moments:
            s[n].add_(1.0)
        if "step" in s:
            s["step"].add_(5)
    # Nothing the small optimizer holds is shared with the full one.
    for i, entry in state.optimizer.state_dict()["state"].items():
        assert all(torch.equal(v, full_opt[i][n]) for n, v in entry.items())
    full = sparse.expand_train_state(small_state, plan, state)
    assert full.model is tmodel and full.masks is state.masks
    small_sd = dict(small.named_parameters())
    opt_state = full.optimizer.state_dict()["state"]
    for i, (name, p) in enumerate(tmodel.named_parameters()):
        path = flax_path(name, p.dim())
        ik, ok = plan.in_keep.get(path), plan.out_keep.get(path)
        kept = torch.ones_like(p, dtype=torch.bool)
        if ok is not None:
            kept[~torch.from_numpy(ok)] = False
        if ik is not None:
            kept[:, ~torch.from_numpy(ik)] = False
        assert torch.equal(p.detach()[~kept], anchor[name][~kept]), name
        assert torch.equal(p.detach()[kept], small_sd[name].detach().reshape(-1)), name
        for n in moments:
            assert torch.equal(opt_state[i][n][~kept], torch.zeros(int((~kept).sum()))), (name, n)
            assert torch.equal(opt_state[i][n][kept],
                               small_state.optimizer.state_dict()["state"][i][n].reshape(-1))
        if optimizer == "AdamW":  # the step came back with the moments, copied
            assert float(opt_state[i]["step"]) == float(full_opt[i]["step"]) + 5
    assert any(not torch.equal(k, v) for k, v in zip(anchor.values(), tmodel.state_dict().values()))
