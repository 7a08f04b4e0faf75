"""Ring attention in the port (``turboprune_tpu_torch/parallel/ring.py``,
the mesh's model axis, ``attention_impl: ring``) against the JAX package's
``parallel/ring.py`` on the 8-device virtual CPU mesh.

The port's side runs in one gloo world of 4 processes
(``tests/torch_port_dp_worker.py``, suite "ring", spawned once per test run
with ``run_once``): rings of 1, 2 and 4 and the (data = 2, model = 2) grid.
The JAX side runs in this process under ``jax.jit`` while the world runs.
Every input is made with numpy from a seed and handed to both.

- ``ring_attention``'s output within 1e-5 (tests/test_ring.py) and its
  q/k/v gradients within atol 2e-4, rtol 1e-4 (tests/test_flash.py) of
  JAX's ``ring_attention`` and ``jax.vjp`` at ring sizes 1, 2 and 4, fp32,
  on [2, 16, 2, 8] inputs and on test_ring.py's padded case (5 valid of 8
  keys: on a ring of 4 one shard holds no valid key). In bf16 on a ring of
  one, at most 1% of the outputs differ from JAX's at all, each by at most
  a rounding flip (2^-7 of its magnitude): the scores, softmax and output
  accumulate in fp32 as JAX's do (the dense attention, whose softmax is
  bf16, differs in most elements).
- The tiny ViT of test_ring.py (patch 4, embed 16, depth 2, 2 heads, 8x8
  images; 5 tokens padded to 6 and 8) on weights carried by ``bridge.py``:
  its logits with ring attention against JAX's ring model, fp32 within
  1e-5 at every ring size, bf16 on a ring of one within 5e-2 (two blocks at
  bf16, as tests/test_torch_vit.py's bf16 forward).
- One train step of that ViT on (data = 2, model = 2), global batch 8,
  masks, SGD with momentum and weight decay, against JAX's
  ``make_sharded_train_step`` on a (2, 2) mesh: the parameters by
  ROADMAP.md's fp32 rule (each update within 1e-3 + 2 x the noise of a
  float64 step, the noise the largest distance of one process's fp32 step
  over 4 orders of the batch), the global loss within 1e-5 relative, and
  the averaged gradients equal bit for bit on all four ranks (an M-fold
  gradient would double the update and fail the rule).
- One driver level of ``cifar10_imp`` with ``deit_tiny_patch16_224`` at its
  published width, ``attention_impl=ring``, ``model_parallelism=2``:
  level-1 masks equal on every rank and, bit for bit, one process's
  pruning of the world's level-0 weights; one experiment directory.
- The host-scope loaders shard by the mesh's data row: on a ring of 2 the
  two ranks of a ring read the same rows of an ImageFolder, the rows of a
  world of 2, and the driver's scoring batch gathers over the data group;
  the .tpk loader's shard likewise; a model axis of one is today's shard.
- The refusals: a ring model without a mesh, a world that does not divide
  by ``model_parallelism``, and the compiled step in a (data = 1,
  model = 4) world (ROADMAP item 13c).
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_dp_worker as worker
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import jax_masks, run_once, seeded_params, spawn_world, write_image_folder
from turboprune_tpu.models.vit import VisionTransformer as JaxViT
from turboprune_tpu.parallel import create_mesh as jax_create_mesh
from turboprune_tpu.parallel import make_sharded_train_step
from turboprune_tpu.parallel import ring_attention as jax_ring_attention
from turboprune_tpu.train import create_optimizer as jax_create_optimizer
from turboprune_tpu.train import create_schedule as jax_create_schedule
from turboprune_tpu.train import create_train_state as jax_create_train_state
from turboprune_tpu.train import make_train_step as jax_make_train_step
from turboprune_tpu_torch import bridge, parallel
from turboprune_tpu_torch.data import imagenet, native
from turboprune_tpu_torch.models import create_model
from turboprune_tpu_torch.pruning import prune_the_model
from turboprune_tpu_torch.train import (
    create_optimizer,
    create_schedule,
    create_train_state,
    make_train_step,
)
from turboprune_tpu_torch.utils.checkpoint import model_state_dict, restore_model_tree

WORLD = 4
FWD_TOL = 1e-5                     # tests/test_ring.py
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-4  # tests/test_flash.py
BF16_FLIP = 2.0 ** -7              # a bf16 rounding flip, of the element's magnitude
BF16_SHARE = 0.01                  # of the elements that may flip
BF16_LOGITS = 5e-2                 # tests/test_torch_vit.py's bf16 forward
LIMIT = 1e-3                       # the fp32 rule
ORDERS = 4
TINY = {k: v for k, v in worker.TINY_RING.items() if k != "image_size"}
BATCH = 8


def _attn_cases() -> dict:
    """[2, 16, 2, 8] with every key valid; test_ring.py's [1, 8, 1, 4]
    with 5 valid keys. Inputs and the output's cotangent."""
    rng = np.random.default_rng(0)
    cases = {}
    for case, shape, n_valid in (("full", (2, 16, 2, 8), 16), ("padded", (1, 8, 1, 4), 5)):
        t = {x: rng.normal(size=shape).astype(np.float32) for x in ("q", "k", "v", "do")}
        t["valid"] = np.arange(shape[1]) < n_valid
        cases[case] = t
    return cases


def _jax_attention(cases: dict) -> dict:
    """JAX's ring attention and its vjp, jitted, at each ring size; bf16
    forward on a ring of one."""
    def jitted(mesh, bf16):
        def fwd_bwd(q, k, v, valid, do):
            o, vjp = jax.vjp(lambda a, b, c: jax_ring_attention(a, b, c, valid, mesh), q, k, v)
            return (o, *vjp(do))

        def run(cases):  # every case in one program: one compile a ring size
            out = {case: fwd_bwd(*(t[x] for x in ("q", "k", "v", "valid", "do")))
                   for case, t in cases.items()}
            if bf16:
                t = cases["full"]
                out["bf16"] = jax_ring_attention(
                    *(t[x].astype(jnp.bfloat16) for x in "qkv"), t["valid"], mesh)
            return out

        return jax.jit(run)

    out = {}
    for n in worker.RING_SIZES:
        got = jitted(jax_create_mesh(model_parallelism=n), n == 1)(cases)
        for case in cases:
            out[n, case] = {x: torch.from_numpy(np.array(a))
                            for x, a in zip(("out", "dq", "dk", "dv"), got[case])}
        if n == 1:
            out[n, "bf16"] = torch.from_numpy(np.array(got["bf16"].astype(jnp.float32)))
    return out


def _jax_logits(params, images) -> dict:
    """JAX's ring ViT's logits at each ring size in fp32, and on a ring of
    one in bf16, in one program."""
    models = {}
    for n in worker.RING_SIZES:
        mesh = jax_create_mesh(model_parallelism=n)
        for dtype in (jnp.float32, jnp.bfloat16) if n == 1 else (jnp.float32,):
            models[n, dtype.__name__] = JaxViT(**TINY, dtype=dtype, attention_impl="ring",
                                               mesh=mesh)
    logits = jax.jit(lambda p, x: [m.apply({"params": p}, x) for m in models.values()])(
        params, images)
    return {key: torch.from_numpy(np.array(a)) for key, a in zip(models, logits)}


def _schedule(create):
    return create("TriangularSchedule", 0.2, 1, 3)


def _jax_step(params, masks, x, y) -> dict:
    """One step of JAX's sharded ring step on a (data = 2, model = 2) mesh."""
    mesh = jax_create_mesh(num_devices=4, model_parallelism=2)
    jmodel = JaxViT(**TINY, attention_impl="ring", mesh=mesh)
    tx = jax_create_optimizer("SGD", _schedule(jax_create_schedule), momentum=0.9,
                              weight_decay=5e-4)
    state = jax_create_train_state(jmodel, tx, jax.random.PRNGKey(0), (1, 8, 8, 3),
                                   variables={"params": params}, masks=masks)
    step = make_sharded_train_step(jax_make_train_step(jmodel, tx, _schedule(jax_create_schedule)),
                                   mesh, donate_state=False)
    state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
    after, _ = bridge.params_from_flax(jax.device_get(state.params))
    return {"state": after, "loss_sum": float(metrics["loss_sum"])}


def _float64(model):
    """``model`` (a port ViT with dense attention) computing in float64:
    its params, every module's compute dtype and its LayerNorms (the
    pooled features still pass the head's fp32 cast, ~1e-7)."""
    model.double()
    for module in model.modules():
        if isinstance(getattr(module, "dtype", None), torch.dtype):
            module.dtype = torch.float64
        if isinstance(module, torch.nn.LayerNorm):
            module.forward = lambda z, m=module: F.layer_norm(
                z.double(), m.normalized_shape, m.weight, m.bias, m.eps)
    return model


def _port_step(state: dict, masks: dict, x, y, dtype=torch.float32) -> dict:
    """The port's step in one process: fp32 with ring attention on a ring
    of one, or the float64 reference (dense attention, the same math)."""
    mesh = parallel.create_mesh()
    if dtype == torch.float64:
        model = _float64(worker.tiny_ring_vit(None, attention_impl="dense"))
    else:
        model = worker.tiny_ring_vit(mesh)
    model.load_state_dict(state)
    ts = create_train_state(model, create_optimizer("SGD", momentum=0.9, weight_decay=5e-4), masks)
    make_train_step(_schedule(create_schedule))(ts, (x.to(dtype), y))
    return {k: v.detach().double() for k, v in model.state_dict().items()}


def _produce(root: Path) -> dict:
    cases = _attn_cases()
    params = seeded_params(JaxViT(**TINY), image=8, seed=1)
    masks = jax_masks(params, seed=1, keep=0.8)
    rng = np.random.default_rng(2)
    images = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    x = rng.normal(size=(BATCH, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=BATCH).astype(np.int32)
    state, tmasks = bridge.params_from_flax(params, masks)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    torch.save({"attn": {c: {k: torch.from_numpy(v) for k, v in t.items()} for c, t in cases.items()},
                "vit": state, "masks": tmasks, "images": torch.from_numpy(images),
                "x": tx, "y": ty}, root / "inputs.pt")
    write_image_folder(root / "folder" / "train", per_class=4)
    write_image_folder(root / "folder" / "val", per_class=2, seed=1)
    orders = [torch.arange(BATCH)] + [
        torch.randperm(BATCH, generator=torch.Generator().manual_seed(i)) for i in range(1, ORDERS)]

    def references():  # while the world runs; JAX's compiles in threads of their own
        with ThreadPoolExecutor(3) as pool:
            jax_refs = {"attn": pool.submit(_jax_attention, cases),
                        "logits": pool.submit(_jax_logits, params, images),
                        "step": pool.submit(_jax_step, params, masks, x, y)}
            port = {"start": {k: v.double() for k, v in state.items()},
                    "float64": _port_step(state, tmasks, tx, ty, torch.float64),
                    "orders": [_port_step(state, tmasks, tx[o], ty[o]) for o in orders]}
            return {**{k: f.result() for k, f in jax_refs.items()}, **port}

    world, made = spawn_world("ring", root, references, nproc=WORLD)
    expt = next((root / "ring_driver").iterdir()) / "checkpoints"
    made["levels"] = [restore_model_tree(expt / f"model_level_{i}") for i in (0, 1)]
    return {"world": world, **made}


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    return run_once(tmp_path_factory, "torch_ring", _produce)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ------------------------------------------------------------- ring_attention


@pytest.mark.parametrize("case", ["full", "padded"])
@pytest.mark.parametrize("n", worker.RING_SIZES)
def test_ring_attention_matches_jax(ring, n, case):
    want = ring["attn"][n, case]
    for r in ring["world"]:
        got = r["ring_kernel"][n, case]
        torch.testing.assert_close(got["out"], want["out"], atol=FWD_TOL, rtol=FWD_TOL)
        for g in ("dq", "dk", "dv"):
            torch.testing.assert_close(got[g], want[g], atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_ring_attention_bf16_accumulates_as_jax_does(ring):
    want = ring["attn"][1, "bf16"]
    for r in ring["world"]:
        got = r["ring_kernel"][1, "bf16"].float()
        diff = (got - want).abs()
        assert float((diff > 0).float().mean()) <= BF16_SHARE
        assert bool((diff <= BF16_FLIP * want.abs()).all())


# ------------------------------------------------------------------ the model


@pytest.mark.parametrize("n", worker.RING_SIZES)
def test_ring_vit_logits_match_jax_fp32(ring, n):
    want = ring["logits"][n, "float32"]
    for r in ring["world"]:
        torch.testing.assert_close(r["ring_vit"][n, "torch.float32"], want, atol=FWD_TOL,
                                   rtol=FWD_TOL)


def test_ring_vit_logits_match_jax_bf16_on_a_ring_of_one(ring):
    want = ring["logits"][1, "bfloat16"]
    for r in ring["world"]:
        got = r["ring_vit"][1, "torch.bfloat16"]
        assert got.dtype == torch.float32  # the head runs in fp32
        torch.testing.assert_close(got, want, atol=BF16_LOGITS, rtol=0)


def test_ring_model_without_a_mesh_raises():
    with pytest.raises(ValueError, match="attention_impl='ring' needs a mesh"):
        create_model("deit_small_patch16_224", 1000, "ImageNet", attention_impl="ring")
    with pytest.raises(ValueError, match="requires a ViT"):
        create_model("resnet18", 10, attention_impl="ring", mesh=parallel.create_mesh())


# ------------------------------------------------------------- the train step


def test_step_on_the_data_model_grid_by_the_fp32_rule(ring):
    start, ref = ring["start"], ring["float64"]

    def update(state, k):
        return state[k].double() - start[k]

    noise = {k: max(_rel(update(o, k), update(ref, k)) for o in ring["orders"]) for k in ref}
    routes = {"jax (2, 2) mesh": ring["step"]["state"],
              "port (2, 2) world": ring["world"][0]["ring_step"]["state"]}
    for name, state in routes.items():
        for k in ref:
            d = _rel(update(state, k), update(ref, k))
            assert d <= LIMIT + 2 * noise[k], (name, k, d, noise[k])
    steps = [r["ring_step"] for r in ring["world"]]
    assert [s["place"] for s in steps] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    want = ring["step"]["loss_sum"]
    for s in steps:
        assert float(s["count"]) == BATCH
        assert abs(float(s["loss_sum"]) - want) <= 1e-5 * abs(want)


def test_step_gradients_and_parameters_are_equal_on_every_rank(ring):
    steps = [r["ring_step"] for r in ring["world"]]
    for s in steps[1:]:
        assert s["grads"].keys() == steps[0]["grads"].keys()
        assert all(torch.equal(s["grads"][k], steps[0]["grads"][k]) for k in s["grads"])
        assert all(torch.equal(s["state"][k], steps[0]["state"][k]) for k in s["state"])


# ----------------------------------------------------------------- the driver


def test_driver_level_1_masks_are_one_process_pruning_of_the_worlds_weights(ring):
    runs = [r["ring_driver"] for r in ring["world"]]
    assert [r["rc"] for r in runs] == [0] * WORLD
    assert all(r["grid"] == [[0, 1], [2, 3]] for r in runs)
    assert all(len(r["dirs"]) == 1 and r["dirs"] == runs[0]["dirs"] for r in runs)
    for r in runs[1:]:
        assert all(torch.equal(r["masks"][k], runs[0]["masks"][k]) for k in runs[0]["masks"])
    level0, level1 = ring["levels"]
    model = create_model("deit_tiny_patch16_224", 10, "CIFAR10", image_size=32)
    model.load_state_dict(model_state_dict(level0))
    want = prune_the_model("mag", model, level0["masks"], 0.8)
    assert want.keys() == level1["masks"].keys()
    assert all(torch.equal(level1["masks"][k], want[k]) for k in want)
    assert all(torch.equal(runs[0]["masks"][k], want[k]) for k in want)


# ------------------------------------------------------------------ the loaders


def test_imagefolder_shards_by_data_row_and_scoring_gathers_over_the_data_group(ring):
    got = [r["ring_loader"] for r in ring["world"]]
    assert [g["shard"] for g in got] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert got[0]["span"] == got[1]["span"] != got[2]["span"] == got[3]["span"]
    assert [g["span"] for g in got[::2]] == [imagenet.shard_span(8, d, 2, drop_remainder=True)
                                             for d in (0, 1)]
    for a, b in ((0, 1), (2, 3)):  # the ranks of a ring read the same rows
        assert all(torch.equal(x, y) for x, y in zip(got[a]["own"], got[b]["own"]))
    assert not torch.equal(got[0]["own"][0], got[2]["own"][0])
    whole = [torch.cat([got[0]["own"][i], got[2]["own"][i]]) for i in range(2)]
    for g in got:
        assert all(torch.equal(x, y) for x, y in zip(g["batch"], whole))


class _FakeTpk:
    mode = 0

    def __init__(self, path):
        self.num_samples = 25

    def sample_shape(self, size=None):
        return (4, 4, 3)


def test_tpk_shards_by_the_given_data_row(monkeypatch):
    """In a world of 4 on a ring of 2, the ranks of a ring read the same
    strided shard, a world of 2's; without ``shard``, a model axis of one,
    the process's own."""
    monkeypatch.setattr(native, "TpkFile", _FakeTpk)
    monkeypatch.setattr(native, "process_count", lambda: 4)
    for rank in range(4):
        monkeypatch.setattr(native, "process_index", lambda r=rank: r)
        ring_shard = native.TpkImageLoader("x.tpk", 8, train=True, device="cpu",
                                           shard=(rank // 2, 2))
        np.testing.assert_array_equal(ring_shard._shard, native.make_shard(25, rank // 2, 2))
        assert ring_shard.batch_size == 4 and len(ring_shard) == (25 // 2) // 4
        own = native.TpkImageLoader("x.tpk", 8, train=True, device="cpu")
        np.testing.assert_array_equal(own._shard, native.make_shard(25, rank, 4))
        assert own.batch_size == 2


# ---------------------------------------------------------------- the refusals


def test_a_world_that_does_not_divide_by_the_ring_raises(ring):
    for r in ring["world"]:
        assert r["ring_refusals"]["indivisible"] == (
            "ValueError: 4 devices not divisible by model_parallelism=3")


def test_compiled_step_in_a_world_of_one_data_row_raises_naming_its_item(ring):
    for r in ring["world"]:
        assert r["ring_refusals"]["compile"].startswith("NotImplementedError")
        assert "item 13c" in r["ring_refusals"]["compile"]
