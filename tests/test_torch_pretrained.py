"""Warm-starting a DeiT from a timm checkpoint in the port
(models/pretrained.py) against the JAX package's converter
(turboprune_tpu/models/pretrained.py), and the slice as a whole.

Inputs: a seeded timm-layout state_dict (numpy normals, so every value
differs from every other and a transposed or swapped block cannot pass)
for the tiny DeiT of ``torch_port_fixtures`` (embed 32, depth 2, 2 heads,
patch 16 at 32 px: 4 patches + the cls token), plain and distilled, and
one whose grid is DeiT/224's 14 x 14.

- The port's converted tensors equal the JAX converter's leaves, converted
  into a tree of zeros shaped by ``jax.eval_shape`` (no compile) and
  carried through ``bridge.py``, bit for bit; a resized ``pos_embed``
  within 1e-6 (the two resizes sum in other orders).
- The port's forward on the converted weights (flash attention, its CPU
  route) against the JAX module's (dense attention, under ``jax.jit``):
  fp32, rtol 1e-5 + atol 1e-5.
- ``_interpolate_pos_embed`` against ``jax.image.resize(..., "bicubic")``
  from a 14 x 14 grid to 2 x 2, 4 x 4 (down) and 24 x 24 (up): within 1e-6
  of the grid's largest value, and no further from the float64 resize
  than JAX's own fp32 result.
- The error paths, with the caller's model untouched.
- ``run_experiment_torch.main`` on ``cifar10_imp`` with DeiT-Tiny (12
  blocks at 192, 5 tokens at 32 px), ``pretrained_path``,
  ``ScheduleFreeSGD`` and ``use_wandb`` (a stub module), 2 levels of 2
  steps: the harness holds the checkpoint's values after construction and
  in its ``model_init`` role; the harness of a resume at level 1 does not
  read the checkpoint again.
"""

import sys
import types
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run_experiment_torch
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, IMAGE, images, jax_deit
from turboprune_tpu.models import pretrained as jpretrained
from turboprune_tpu_torch import bridge, driver
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.models import pretrained, vit
from turboprune_tpu_torch.utils import MODEL_INIT, ExperimentCheckpoints


def timm_state_dict(embed, depth, classes, grid, distilled=False, patch=16, seed=0):
    """A timm VisionTransformer/DeiT state_dict of seeded normals: weights
    scaled by 1 / sqrt(fan_in), LayerNorm weights around 1."""
    rng = np.random.default_rng(seed)
    d, hidden, prefix = embed, 4 * embed, 2 if distilled else 1
    shapes = {"cls_token": (1, 1, d), "pos_embed": (1, grid * grid + prefix, d),
              "patch_embed.proj.weight": (d, 3, patch, patch), "patch_embed.proj.bias": (d,)}
    if distilled:
        shapes["dist_token"] = (1, 1, d)
    for i in range(depth):
        t = f"blocks.{i}"
        shapes.update({
            f"{t}.norm1.weight": (d,), f"{t}.norm1.bias": (d,),
            f"{t}.attn.qkv.weight": (3 * d, d), f"{t}.attn.qkv.bias": (3 * d,),
            f"{t}.attn.proj.weight": (d, d), f"{t}.attn.proj.bias": (d,),
            f"{t}.norm2.weight": (d,), f"{t}.norm2.bias": (d,),
            f"{t}.mlp.fc1.weight": (hidden, d), f"{t}.mlp.fc1.bias": (hidden,),
            f"{t}.mlp.fc2.weight": (d, hidden), f"{t}.mlp.fc2.bias": (d,)})
    shapes.update({"norm.weight": (d,), "norm.bias": (d,)})
    for head in ("head", "head_dist") if distilled else ("head",):
        shapes.update({f"{head}.weight": (classes, d), f"{head}.bias": (classes,)})
    sd = {}
    for name, shape in shapes.items():
        x = rng.normal(size=shape)
        if name.endswith("norm1.weight") or name.endswith("norm2.weight") or name == "norm.weight":
            x = 1.0 + 0.1 * x
        elif name.endswith("weight"):
            x = x / np.sqrt(np.prod(shape[1:]))
        else:
            x = 0.1 * x
        sd[name] = torch.from_numpy(x.astype(np.float32))
    return sd


def _tiny(distilled=False):
    return vit.VisionTransformer(**TINY, image_size=IMAGE, distilled=distilled,
                                 attention_impl="flash")


def _jax_zeros(distilled=False):
    shapes = jax.eval_shape(lambda: jax_deit("dense", distilled).init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), train=False))["params"]
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("case", ["plain", "distilled", "grid_14"])
def test_converter_matches_the_jax_converter(case):
    distilled = case == "distilled"
    sd = timm_state_dict(TINY["embed_dim"], TINY["depth"], TINY["num_classes"],
                         14 if case == "grid_14" else 2, distilled=distilled, seed=1)
    model = _tiny(distilled)
    got, skipped = pretrained.convert_deit_state_dict(sd, dict(model.named_parameters()),
                                                      TINY["num_heads"])
    jtree, jskipped = jpretrained.convert_deit_state_dict(
        {k: v.numpy() for k, v in sd.items()}, _jax_zeros(distilled), TINY["num_heads"])
    want, _ = bridge.params_from_flax(jax.device_get(jtree))
    assert skipped == jskipped == []
    assert got.keys() == want.keys() == dict(model.named_parameters()).keys()
    for name in want:
        assert got[name].dtype == torch.float32
        if case == "grid_14" and name == "pos_embed":
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=1e-6)
        else:
            assert torch.equal(got[name], want[name]), name
    # The qkv split: query is row block 0 of the fused weight, as it is.
    assert torch.equal(got["block1.attn.key.weight"], sd["blocks.1.attn.qkv.weight"][32:64])


def test_forward_on_converted_weights_matches_jax(distilled=False):
    sd = timm_state_dict(TINY["embed_dim"], TINY["depth"], TINY["num_classes"], 2,
                         distilled=distilled, seed=2)
    model = _tiny(distilled)
    new, _ = pretrained.convert_deit_state_dict(sd, dict(model.named_parameters()),
                                                TINY["num_heads"])
    model.load_state_dict(new)
    jtree, _ = jpretrained.convert_deit_state_dict(
        {k: v.numpy() for k, v in sd.items()}, _jax_zeros(distilled), TINY["num_heads"])
    x = images(4, seed=3)
    want = jax.jit(lambda p, x: jax_deit("dense", distilled).apply(
        {"params": p}, x, train=False))(jtree, jnp.asarray(x))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("target", [2, 4, 24])
def test_pos_embed_resize_matches_jax_image_resize(target):
    pe = np.random.default_rng(target).normal(size=(1, 1 + 14 * 14, 48)).astype(np.float32)
    got = pretrained._interpolate_pos_embed(torch.from_numpy(pe), 1 + target * target, 1)
    grid = jax.image.resize(jnp.asarray(pe[:, 1:].reshape(1, 14, 14, 48)),
                            (1, target, target, 48), method="bicubic")
    want = np.concatenate([pe[:, :1], np.asarray(grid).reshape(1, -1, 48)], axis=1)
    assert got.shape == want.shape and got.dtype == torch.float32
    # Within 1e-6 of the grid's largest value. jax.image.resize sums in an
    # order of its own: at 14 -> 24 it lies 2.7e-6 from the same resize in
    # float64, the port's two products 4e-7.
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-6 * scale
    w = pretrained._resize_weights(14, target).double()
    exact = torch.einsum("hwc,hi,wj->ijc", torch.from_numpy(pe[0, 1:]).double().reshape(14, 14, 48),
                         w, w).reshape(1, -1, 48).numpy()
    assert np.abs(got.numpy()[:, 1:] - exact).max() <= np.abs(want[:, 1:] - exact).max() + 1e-7
    assert torch.equal(got[:, :1], torch.from_numpy(pe[:, :1]))
    # Not F.interpolate's bicubic (a = -0.75, clamped edges).
    other = torch.nn.functional.interpolate(
        torch.from_numpy(pe[:, 1:].reshape(1, 14, 14, 48)).permute(0, 3, 1, 2),
        size=(target, target), mode="bicubic", align_corners=False)
    assert not np.allclose(other.permute(0, 2, 3, 1).reshape(1, -1, 48).numpy(), want[:, 1:],
                           atol=1e-3)


def test_error_paths_leave_the_model_untouched(tmp_path, capsys):
    model = _tiny()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = timm_state_dict(TINY["embed_dim"], TINY["depth"], TINY["num_classes"], 2, seed=4)
    heads = TINY["num_heads"]

    def refused(bad, match):
        path = tmp_path / f"{match.split()[0]}.pth"
        torch.save({"model": bad}, path)
        with pytest.raises(pretrained.PretrainedFormatError, match=match):
            pretrained.load_pretrained(path, model)
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k

    # block0 converts before block1's tensors are found missing.
    refused({k: v for k, v in sd.items() if k != "blocks.1.mlp.fc2.bias"}, "missing tensor")
    refused({**sd, "blocks.2.norm1.weight": sd["blocks.1.norm1.weight"]}, "unconsumed")
    refused({**sd, "blocks.1.mlp.fc1.bias": torch.zeros(7)}, "checkpoint shape")
    refused({**sd, "pos_embed": torch.zeros(1, 1 + 6, 32)}, "not square")
    with pytest.raises(FileNotFoundError, match="no download path"):
        pretrained.load_pretrained(tmp_path / "absent.pth", model)
    # A 1000-class checkpoint: the heads stay at their init and are listed.
    imagenet = timm_state_dict(TINY["embed_dim"], TINY["depth"], 1000, 2, distilled=True, seed=5)
    path = tmp_path / "imagenet.pth"
    torch.save(imagenet, path)  # a raw state_dict, no {"model": ...} wrapper
    distilled = _tiny(distilled=True)
    head = distilled.head.weight.detach().clone()
    assert pretrained.load_pretrained(path, distilled) == ["head", "head_dist"]
    assert "kept randomly-initialized ['head', 'head_dist']" in capsys.readouterr().out
    assert torch.equal(distilled.head.weight, head)
    assert torch.equal(distilled.norm.weight, imagenet["norm.weight"])


class StubWandb(types.ModuleType):
    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append("init")
        stub = self

        class Run:
            def log(self, metrics):
                stub.calls.append("log")

            def finish(self):
                stub.calls.append("finish")

        return Run()


def test_slice_run_warm_starts_deit_tiny_with_schedule_free_sgd(tmp_path, monkeypatch, capsys):
    # DeiT-Tiny's timm checkpoint at 224: a 14 x 14 grid resized to 2 x 2.
    sd = timm_state_dict(192, 12, 1000, 14, seed=6)
    path = tmp_path / "deit_tiny_patch16_224.pth"
    torch.save({"model": sd}, path)
    stub = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    built = []

    class Harness(PruningHarness):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append({k: v.detach().clone() for k, v in self.model.named_parameters()})

    base = tmp_path / "runs"
    args = ["--device", "cpu", "--config-name=cifar10_imp",
            "model_params.model_name=deit_tiny_patch16_224",
            f"model_params.pretrained_path={path}",
            "optimizer_params.optimizer_name=ScheduleFreeSGD",
            "experiment_params.use_wandb=true",
            "dataset_params.dataloader_type=synthetic",
            "dataset_params.total_batch_size=8",
            "dataset_params.synthetic_num_train=16",
            "dataset_params.synthetic_num_test=8",
            "experiment_params.epochs_per_level=1",
            "experiment_params.max_steps_per_epoch=2",
            "pruning_params.target_sparsity=0.2",
            f"experiment_params.base_dir={base}"]
    with mock.patch.object(driver, "PruningHarness", Harness):
        assert run_experiment_torch.main(args) == 0
    out = capsys.readouterr().out
    assert "[pretrained] interpolated pos_embed to 5 tokens" in out
    assert "kept randomly-initialized ['head']" in out
    assert stub.calls == ["init", "log", "log", "finish"]
    want, skipped = pretrained.convert_deit_state_dict(
        sd, dict(vit.deit_tiny_patch16_224(10, image_size=32).named_parameters()), 3)
    assert skipped == ["head"] and len(want) == len(built[0]) - 2
    (expt,) = list(base.iterdir())
    init = ExperimentCheckpoints(expt).load_model(MODEL_INIT)["params"]
    for name, value in want.items():
        assert torch.equal(built[0][name], value), name
        assert torch.equal(init[name], value), name
    level1 = ExperimentCheckpoints(expt).load_level(1)
    assert all(torch.isfinite(v).all() for v in level1["params"].values())
    # A resume at level 1 takes every weight from model_level_0: its
    # harness does not read the checkpoint again (here it is gone).
    path.unlink()
    capsys.readouterr()
    from turboprune_tpu_torch.config.compose import compose

    cfg = compose("cifar10_imp", [a for a in args[3:] if not a.startswith("experiment_params.use")] + [
        "experiment_params.resume_experiment=true",
        f"experiment_params.resume_experiment_stuff.resume_expt_name={expt.name}",
        "experiment_params.resume_experiment_stuff.resume_level=1"])
    Harness(cfg, ("p", str(expt)), device="cpu")
    assert "[pretrained]" not in capsys.readouterr().out
    assert not torch.equal(built[1]["cls_token"], want["cls_token"])
