"""One rank of a gloo world for the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_dp.py: worlds of 2;
tests/test_torch_ring.py: a world of 4), the counterpart of
tests/mp_worker.py.

    RANK=r WORLD_SIZE=W LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_port_dp_worker.py <suite> <dir>

joins the world through ``parallel.initialize_distributed`` (torchrun's
variables, the production entry path), runs the suite's scenarios in order
on the CPU and writes ``<dir>/result_<rank>.pt``: a dict of each
scenario's outputs. Inputs the JAX package made come in ``<dir>/inputs.pt``
and ``<dir>/folder`` (written before the world starts). Every rank runs
every scenario: they are collectives.
"""

from __future__ import annotations

import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from turboprune_tpu_torch import driver  # noqa: E402
from turboprune_tpu_torch.config.compose import compose  # noqa: E402
from turboprune_tpu_torch.harness import PruningHarness  # noqa: E402
from turboprune_tpu_torch.parallel import (  # noqa: E402
    all_reduce_sums,
    assert_width_agreement,
    broadcast_object,
    check_state_equality,
    create_mesh,
    destroy_distributed,
    initialize_distributed,
    process_index,
    set_batchnorm_group,
    shard_batch,
)

# cifar10_imp as shipped but for the data: synthetic 16x16 images, a global
# batch of 16 (8 a rank), 2 steps a level, fp32 (the parameters are held by
# the fp32 rule); 24 test images, so the second eval batch is half padding.
DP_OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.image_size=16",
    "dataset_params.total_batch_size=16",
    "dataset_params.synthetic_num_train=64",
    "dataset_params.synthetic_num_test=24",
    "experiment_params.epochs_per_level=1",
    "experiment_params.max_steps_per_epoch=2",
    "experiment_params.training_precision=float32",
    "pruning_params.target_sparsity=0.2",
]


def _error(fn, *args, **kwargs):
    """The message ``fn`` raises, or None."""
    try:
        fn(*args, **kwargs)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _gather_rows(t: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, t.contiguous())
    return torch.cat(parts)


# ----------------------------------------------------------- suite "parallel"


def broadcast(root: Path, rank: int) -> dict:
    return {"got": broadcast_object({"rank": rank, "pair": (rank, "x")})}


def equality(root: Path, rank: int) -> dict:
    def tree(b_bump=0.0, flip=False):
        a = torch.arange(6.0).reshape(2, 3)
        b = torch.ones(4)
        b[2] += b_bump
        return {"params": {"a": a.flip(-1) if flip else a, "b": b},
                "masks": {"m": torch.tensor([True, False, True])}, "none": None}

    check_state_equality(tree(), exact=True)
    return {
        "planted": _error(check_state_equality, tree(b_bump=float(rank)), "planted"),
        "permuted_moments": _error(check_state_equality, tree(flip=rank == 1), "permuted"),
        "permuted_exact": _error(check_state_equality, tree(flip=rank == 1), "permuted",
                                 exact=True),
    }


def widths(root: Path, rank: int) -> dict:
    same = _error(assert_width_agreement, {"commit": True, "widths": [["Conv_0", 4]]})
    differ = _error(assert_width_agreement, {"commit": True, "widths": [["Conv_0", 4 + rank]]})
    return {"same": same, "differ": differ}


def checkpoints(root: Path, rank: int) -> dict:
    from turboprune_tpu_torch.utils import ExperimentCheckpoints

    ckpts = ExperimentCheckpoints(root / "ckpt")
    tree = {"params": {"w": torch.full((3,), float(rank))},
            "masks": {"Dense_0/kernel": torch.tensor([True, False, rank == 0])},
            "batch_stats": {"bn.mean": torch.full((2,), 10.0 + rank)}}
    ckpts.save_level(0, tree)
    ckpts.save_model("model_init", tree)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1 + rank)
    ckpts.save_optimizer("optimizer_init", opt)
    return {
        "level": ckpts.load_level(0),
        "init": ckpts.load_model("model_init"),
        "lr": ckpts.load_optimizer("optimizer_init")["param_groups"][0]["lr"],
        "files": sorted(p.name for p in ckpts.checkpoints_dir.iterdir()),
    }


def jax_step(root: Path, rank: int) -> dict:
    """The port's step in this world on the JAX weights (bridged): a
    width-8 ResNet-18 (CIFAR stem, fp32), SGD with momentum and weight
    decay, on the rank's rows of the global batch; the train forward's
    logits (gathered) and the magnitude masks at density 0.8."""
    from turboprune_tpu_torch.models import resnet as tresnet
    from turboprune_tpu_torch.pruning import prune_the_model
    from turboprune_tpu_torch.train import (
        create_optimizer,
        create_schedule,
        create_train_state,
        make_train_step,
        train_forward,
    )

    inp = torch.load(root / "inputs.pt", weights_only=False)
    mesh = create_mesh()

    def model():
        m = tresnet.resnet18(10, cifar_stem=True, width=8)
        m.load_state_dict(inp["state"])
        set_batchnorm_group(m, mesh)
        return m.train()

    batch = shard_batch((inp["x"], inp["y"]), mesh)
    logits = _gather_rows(train_forward(model(), inp["masks"], *batch)["logits"])
    state = create_train_state(model(), create_optimizer("SGD", momentum=0.9, weight_decay=5e-4),
                               inp["masks"])
    step = make_train_step(create_schedule("TriangularSchedule", 0.2, 1, 3), mesh=mesh)
    sums = all_reduce_sums(step(state, batch), mesh)
    mag = prune_the_model("mag", model(), inp["ones"], 0.8)
    return {"state": _state(state.model), "logits": logits, "loss_sum": sums["loss_sum"],
            "mag": mag}


# ----------------------------------------------------------------- suite "dp"


def run_driver(root: Path, rank: int) -> dict:
    """cifar10_imp through run_experiment_torch.main for 2 levels."""
    return drive(root / "driver")


def drive(base: Path) -> dict:
    """``run_experiment_torch.main`` on cifar10_imp under ``base``: the
    masks it ends with, and every epoch's and evaluation's metric sums as
    the harness read them (after ``all_reduce_sums``)."""
    import run_experiment_torch
    from turboprune_tpu_torch.harness import pruning_harness

    seen = {"sums": []}

    class Recorded(PruningHarness):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["harness"] = self

    def recorded_sums(sums, mesh):
        out = all_reduce_sums(sums, mesh)
        seen["sums"].append({k: float(v) for k, v in out.items()})
        return out

    with mock.patch.object(driver, "PruningHarness", Recorded), \
            mock.patch.object(pruning_harness, "all_reduce_sums", recorded_sums):
        rc = run_experiment_torch.main(["--device", "cpu", "--config-name=cifar10_imp",
                                        *DP_OVERRIDES, f"experiment_params.base_dir={base}"])
    h = seen["harness"]
    return {"rc": rc, "masks": dict(h.state.masks), "sums": seen["sums"],
            "dirs": sorted(p.name for p in base.iterdir())}


def dropout(root: Path, rank: int) -> dict:
    """VGG-11 (no BatchNorm, dropout 0.5, narrow classifier): the rank's
    dropout uniforms, and one step on the rank's rows."""
    from turboprune_tpu_torch.models import vgg
    from turboprune_tpu_torch.train import (
        DropoutNoise,
        create_optimizer,
        create_schedule,
        create_train_state,
        make_train_step,
    )

    mesh = create_mesh()
    model = vgg.vgg11(10, fc_features=(32, 32)).init_weights(torch.Generator().manual_seed(0))
    noise = DropoutNoise(torch.device("cpu"), seed=3)
    drawn = noise(model, 2, 5, mesh)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=4)).long()
    state = create_train_state(model, create_optimizer("SGD", momentum=0.9, weight_decay=0.0))
    step = make_train_step(create_schedule("TriangularSchedule", 0.2, 1, 3), dropout_noise=noise,
                           mesh=mesh)
    step(state, shard_batch((x, y), mesh))
    return {"noise": drawn, "state": _state(model)}


def optimizers(root: Path, rank: int) -> dict:
    """Three steps of a width-8 ResNet-18 with each optimizer: every rank's
    parameters and optimizer state (momentum, AdamW's moments,
    schedule-free SGD's z) equal bit for bit (None: the check passed)."""
    from turboprune_tpu_torch.models import resnet as tresnet
    from turboprune_tpu_torch.train import (
        create_optimizer,
        create_schedule,
        create_train_state,
        make_train_step,
    )

    mesh = create_mesh()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(8, 16, 16, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=8)).long()
    out = {}
    for name in ("SGD", "AdamW", "ScheduleFreeSGD"):
        model = tresnet.resnet18(10, cifar_stem=True, width=8).init_weights(
            torch.Generator().manual_seed(0))
        set_batchnorm_group(model, mesh)
        state = create_train_state(model, create_optimizer(name, momentum=0.9, weight_decay=5e-4))
        step = make_train_step(create_schedule("TriangularSchedule", 0.2, 1, 3), mesh=mesh)
        for _ in range(3):
            step(state, shard_batch((x, y), mesh))
        tree = {"params": state.model_tree()["params"],
                "optimizer": state.optimizer.state_dict()["state"]}
        out[name] = _error(check_state_equality, tree, name, exact=True)
        out[name + " leaves"] = len(state.optimizer.state_dict()["state"])
    return out


class HostLoader:
    """A host-scope loader: this rank's rows of a fixed global batch."""

    batch_scope = "host"

    def __init__(self, batch):
        self.batch = batch
        self.epoch = 0

    def __iter__(self):
        self.epoch += 1
        yield self.batch

    def __len__(self):
        return 1


def snip_batch():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(16, 16, 16, 3)).astype(np.float32))
    return x, torch.from_numpy(rng.integers(0, 10, size=16)).long()


def snip(root: Path, rank: int) -> dict:
    """SNIP at density 0.8 scored on a host-scope loader's rows, gathered."""
    cfg = compose("cifar10_er_snip", DP_OVERRIDES + [f"experiment_params.base_dir={root}"])
    h = PruningHarness(cfg, ("", str(root / "snip")), device="cpu")
    x, y = snip_batch()
    h.loaders.train_loader = HostLoader((x[rank * 8:(rank + 1) * 8], y[rank * 8:(rank + 1) * 8]))
    driver.prune_level(h, 0.8, 1)
    return {"masks": dict(h.state.masks)}


PLAN_OVERRIDES = DP_OVERRIDES + ["optimizer_params.weight_decay=0",
                                 "experiment_params.compact_train=true"]


def channel_masks(masks: dict, seed: int = 0) -> dict:
    """Half of every block's Conv_0 output channels dead, 20% scattered
    zeros everywhere (the masks of tests/test_torch_plan.py)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for path, m in masks.items():
        m = torch.rand(m.shape, generator=g) >= 0.2
        if path.endswith("Conv_0/kernel"):
            m[torch.rand(m.shape[0], generator=g) < 0.5] = False
        out[path] = m
    return out


class Reordered:
    """A loader whose every batch comes with its rows in ``order``."""

    def __init__(self, loader, order):
        self.loader, self.order = loader, order

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for x, y in self.loader:
            yield x[self.order], y[self.order]


def planned_level(base: Path, order=None) -> dict:
    """A compact_train level of ResNet-18 with dead channels, its batches'
    rows in ``order``: the start and end state."""
    cfg = compose("cifar10_imp", PLAN_OVERRIDES + [f"experiment_params.base_dir={base}"])
    h = PruningHarness(cfg, ("", str(base / "plan")), device="cpu")
    if order is not None:
        h.loaders.train_loader = Reordered(h.loaders.train_loader, order)
    h.state.masks = channel_masks(h.state.masks)
    start = _state(h.state.model)
    h.train_one_level(1, 1)
    check_state_equality(h.state.model_tree(), "planned level", exact=True)
    return {"start": start, "state": _state(h.state.model), "kind": h.last_plan_report["kind"]}


def plan(root: Path, rank: int) -> dict:
    return planned_level(root)


def folder_overrides(root: Path) -> list:
    return [f"dataset_params.data_root_dir={root / 'folder'}", "dataset_params.num_workers=0",
            "dataset_params.image_size=16", "dataset_params.total_batch_size=4",
            "model_params.model_name=resnet18", "experiment_params.checkpoint_every_epochs=1",
            f"experiment_params.base_dir={root}"]


def mid_level(root: Path, rank: int) -> dict:
    """The mid-level slot of an ImageFolder run: each rank's stream blob,
    and a fresh harness's restore of it."""
    cfg = compose("imagenet_imp", folder_overrides(root))
    h = PruningHarness(cfg, ("", str(root / "mid")), device="cpu")
    loader = h.loaders.train_loader
    for _ in loader:
        pass
    saved = loader.get_stream_state()
    h._save_mid_level(0, 0, 0.0)
    files = sorted(p.name for p in h.ckpts.checkpoints_dir.iterdir())
    h.loaders.close()
    fresh = PruningHarness(cfg, ("", str(root / "mid")), device="cpu")
    start, _ = fresh._enter_mid_level(0)
    restored = fresh.loaders.train_loader.get_stream_state()
    fresh.loaders.close()
    return {"saved": saved, "restored": restored, "start": start, "files": files,
            "span": loader.span, "train_len": len(loader),
            "eval_len": len(fresh.loaders.test_loader)}


def refusals(root: Path, rank: int) -> dict:
    def harness(extra):
        cfg = compose("cifar10_imp", DP_OVERRIDES + extra + [f"experiment_params.base_dir={root}"])
        PruningHarness(cfg, ("", str(root / "refused")), device="cpu")

    return {
        "num_devices": _error(harness, ["experiment_params.num_devices=4"]),
        "num_devices_2": _error(harness, ["experiment_params.num_devices=2"]),
        "compile": _error(harness, ["model_params.use_compile=true"]),
    }


# ------------------------------------------------------------- suite "ring"
# A world of 4: ring attention on rings of 1, 2 and 4, and the (data = 2,
# model = 2) grid.

RING_SIZES = (1, 2, 4)
# The tiny ViT of tests/test_ring.py: 8x8 images, patch 4, so 4 patches and
# the class token, 5 tokens (padded to 6 on a ring of 2, 8 on a ring of 4).
TINY_RING = dict(num_classes=10, patch_size=4, embed_dim=16, depth=2, num_heads=2,
                 image_size=8)
# cifar10_imp with DeiT-Tiny/16 at its published width, ring attention on
# a ring of 2: 32x32 images, 4 patches and the class token padded to 6; a
# global batch of 8 (4 a data row), 2 steps a level, fp32.
RING_DRIVER_OVERRIDES = [
    "model_params.model_name=deit_tiny_patch16_224",
    "model_params.attention_impl=ring",
    "experiment_params.model_parallelism=2",
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.total_batch_size=8",
    "dataset_params.synthetic_num_train=16",
    "dataset_params.synthetic_num_test=8",
    "experiment_params.epochs_per_level=1",
    "experiment_params.max_steps_per_epoch=2",
    "experiment_params.training_precision=float32",
    "pruning_params.target_sparsity=0.2",
]


def tiny_ring_vit(mesh, dtype=torch.float32, attention_impl="ring"):
    from turboprune_tpu_torch.models.vit import VisionTransformer

    return VisionTransformer(**TINY_RING, dtype=dtype, attention_impl=attention_impl, mesh=mesh)


def ring_kernel(root: Path, rank: int) -> dict:
    """``ring_attention``'s output and q/k/v gradients (under the same
    cotangent on every rank) at each ring size, on each case of inputs."""
    from turboprune_tpu_torch.parallel import ring_attention

    inp = torch.load(root / "inputs.pt", weights_only=False)["attn"]
    out = {}
    for n in RING_SIZES:
        mesh = create_mesh(model_parallelism=n)
        for case, t in inp.items():
            q, k, v = (t[x].clone().requires_grad_() for x in "qkv")
            o = ring_attention(q, k, v, t["valid"], mesh)
            (o * t["do"]).sum().backward()
            out[n, case] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
        if n == 1:
            t = inp["full"]
            with torch.no_grad():
                out[n, "bf16"] = ring_attention(*(t[x].bfloat16() for x in "qkv"), t["valid"],
                                                mesh)
    return out


def ring_vit(root: Path, rank: int) -> dict:
    """The tiny ViT's logits with ring attention at each ring size in fp32,
    and on a ring of one in bf16."""
    inp = torch.load(root / "inputs.pt", weights_only=False)
    out = {}
    for n in RING_SIZES:
        mesh = create_mesh(model_parallelism=n)
        for dtype in (torch.float32, torch.bfloat16) if n == 1 else (torch.float32,):
            model = tiny_ring_vit(mesh, dtype)
            model.load_state_dict(inp["vit"])
            with torch.no_grad():
                out[n, str(dtype)] = model(inp["images"])
    return out


def ring_step(root: Path, rank: int) -> dict:
    """One train step of the tiny ViT on the (data = 2, model = 2) grid:
    the parameters after it, the averaged gradients and the global loss."""
    from turboprune_tpu_torch.train import (
        create_optimizer,
        create_schedule,
        create_train_state,
        make_train_step,
    )

    inp = torch.load(root / "inputs.pt", weights_only=False)
    mesh = create_mesh(model_parallelism=2)
    model = tiny_ring_vit(mesh)
    model.load_state_dict(inp["vit"])
    state = create_train_state(model, create_optimizer("SGD", momentum=0.9, weight_decay=5e-4),
                               inp["masks"])
    step = make_train_step(create_schedule("TriangularSchedule", 0.2, 1, 3), mesh=mesh)
    sums = all_reduce_sums(step(state, shard_batch((inp["x"], inp["y"]), mesh)), mesh)
    return {"state": _state(model), "loss_sum": sums["loss_sum"], "count": sums["count"],
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "place": (mesh.data_rank, mesh.model_rank)}


def ring_driver(root: Path, rank: int) -> dict:
    """cifar10_imp with DeiT-Tiny and ring attention on a ring of 2, 2
    levels through run_experiment_torch.main."""
    import run_experiment_torch

    seen = {}

    class Recorded(PruningHarness):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["harness"] = self

    base = root / "ring_driver"
    with mock.patch.object(driver, "PruningHarness", Recorded):
        rc = run_experiment_torch.main(["--device", "cpu", "--config-name=cifar10_imp",
                                        *RING_DRIVER_OVERRIDES,
                                        f"experiment_params.base_dir={base}"])
    h = seen["harness"]
    return {"rc": rc, "masks": dict(h.state.masks), "dirs": sorted(p.name for p in base.iterdir()),
            "grid": h.mesh.grid.tolist()}


def ring_loader(root: Path, rank: int) -> dict:
    """An ImageFolder run's host-scope train loader on a ring of 2: its
    shard, and the scoring batch the driver gathers over the data group
    (this rank's rows, and the gathered batch)."""
    cfg = compose("imagenet_imp", folder_overrides(root) + [
        "model_params.model_name=deit_tiny_patch16_224", "model_params.attention_impl=ring",
        "experiment_params.model_parallelism=2"])
    h = PruningHarness(cfg, ("", str(root / "ring_loader")), device="cpu")
    own = []
    gather = driver._all_gather_rows

    def recorded(t, mesh):
        own.append(t)
        return gather(t, mesh)

    with mock.patch.object(driver, "_all_gather_rows", recorded):
        batch = driver._first_train_batch(h)
    loader = h.loaders.train_loader
    out = {"shard": loader.shard, "span": loader.span, "own": own, "batch": batch}
    h.loaders.close()
    return out


def ring_refusals(root: Path, rank: int) -> dict:
    def harness(extra):
        cfg = compose("cifar10_imp", RING_DRIVER_OVERRIDES + extra
                      + [f"experiment_params.base_dir={root}"])
        PruningHarness(cfg, ("", str(root / "refused")), device="cpu")

    return {
        "indivisible": _error(create_mesh, model_parallelism=3),
        # data = 1, model = 4: one data row, four processes.
        "compile": _error(harness, ["experiment_params.model_parallelism=4",
                                    "model_params.use_compile=true"]),
    }


SUITES = {
    "parallel": [broadcast, equality, widths, checkpoints, jax_step],
    "dp": [run_driver, dropout, optimizers, snip, plan, mid_level, refusals],
    "ring": [ring_kernel, ring_vit, ring_step, ring_driver, ring_loader, ring_refusals],
}


def main() -> int:
    suite, root = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    initialize_distributed(device="cpu")
    rank = process_index()
    try:
        out = {fn.__name__: fn(root, rank) for fn in SUITES[suite]}
    finally:
        destroy_distributed()
    torch.save(out, root / f"result_{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
