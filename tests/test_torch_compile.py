"""The compiled step of turboprune_tpu_torch (``model_params.use_compile``)
on the CPU, where ``train.compile_forward`` takes ``backend="aot_eager"``:
dynamo's and AOTAutograd's tracing with ``fullgraph=True``, without
inductor. The flash kernels K1-K3 as ``torch.library`` custom ops
(``opcheck``: schema, fake implementation, autograd registration); the
compiled train step against the eager one (ResNet-18 at CIFAR size and a
2-block DeiT with flash attention) and against the JAX package's
``make_scan_epoch`` under ``jax.jit``; the compiled eval sums; and
``cifar10_imp`` through the driver with no new graph at level 1.

Tolerances. Compiled against eager: aot_eager runs the aten ops of the
eager step, the backward as AOTAutograd traced it from the same formulas,
so the two agree to fp32 rounding of a reordered sum: rtol 1e-5, atol 1e-6
over 3 steps (bf16 activations included; measured: equal bit for bit).
Against JAX: the fp32 tolerances of tests/test_torch_train.py (params
rtol 1e-4, atol 1e-6; running statistics rtol 1e-5, atol 1e-6; loss rtol
1e-5): the same fp32 forward and backward in other summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._dynamo.utils import counters

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, IMAGE, jax_masks, seeded_variables
from turboprune_tpu.models import resnet as jax_resnet
from turboprune_tpu.train import create_optimizer as jax_create_optimizer
from turboprune_tpu.train import create_schedule as jax_create_schedule
from turboprune_tpu.train import create_train_state as jax_create_train_state
from turboprune_tpu.train import make_train_step as jax_make_train_step
from turboprune_tpu.train.steps import make_scan_epoch
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.driver import run
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.models import create_model
from turboprune_tpu_torch.models import resnet as tresnet
from turboprune_tpu_torch.models import vit as tvit
from turboprune_tpu_torch.ops import flash, masking
from turboprune_tpu_torch.train import (
    add_sums,
    compile_forward,
    create_optimizer,
    create_schedule,
    create_train_state,
    eval_forward,
    eval_step,
    make_train_step,
    mark_buffers_static,
    train_forward,
)
from turboprune_tpu_torch.utils import ExperimentCheckpoints

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
STEPS = 3
JAX_LR = 0.05
# cifar10_imp as shipped, cut to 2 levels of 2 steps at batch 8.
IMP_OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.total_batch_size=8",
    "dataset_params.synthetic_num_train=16",
    "dataset_params.synthetic_num_test=12",
    "experiment_params.epochs_per_level=1",
    "experiment_params.max_steps_per_epoch=2",
    "pruning_params.target_sparsity=0.2",
]


# ------------------------------------------------------------- custom ops
def _op_args(name):
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(4, 16, 8, generator=g) for _ in range(4))
    valid = (torch.arange(16) < 13).float()[None]
    if name == "flash_fwd":
        return (q.requires_grad_(), k.requires_grad_(), v.requires_grad_(), valid,
                0.35, 8, 8)
    o, lse = flash.flash_attention_plain(q, k, v, valid, 0.35, 8, 8)
    drow = flash.row_correction(o, do)
    return (q, k, v, valid, do, lse, drow, 0.35, 8)


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_flash_custom_op_passes_opcheck(name):
    """Schema (a new output, no input mutated), the fake implementation's
    shapes, dtypes and strides against the CPU route, the registered
    autograd (K1's backward = row_correction + K2 + K3) and AOT dispatch."""
    op = getattr(torch.ops.turboprune_tpu_torch, name)
    torch.library.opcheck(op, _op_args(name))


# --------------------------------------------------- compiled against eager
def _resnet18():
    return create_model("resnet18", num_classes=10, dataset_name="CIFAR10",
                        compute_dtype=torch.bfloat16)


def _deit_flash():
    return tvit.VisionTransformer(**TINY, image_size=IMAGE, attention_impl="flash")


MODELS = {"resnet18_cifar_bf16": (_resnet18, 32), "deit_2_blocks_flash": (_deit_flash, IMAGE)}


def _seeded(make, seed=0):
    model = make().init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    masks = {p: torch.from_numpy(rng.random(tuple(m.shape)) < 0.7)
             for p, m in masking.make_masks(model).items()}
    return model, masks


def _train(make, forward, batches, seed=0):
    model, masks = _seeded(make, seed)
    if forward is not train_forward:
        mark_buffers_static(model)
    state = create_train_state(
        model, create_optimizer("SGD", momentum=0.9, weight_decay=5e-4), masks)
    step = make_train_step(create_schedule("TriangularSchedule", 0.2, 1, STEPS), forward)
    sums = None
    for batch in batches:
        sums = add_sums(sums, step(state, batch))
    return state, sums


def _batches(image, n=STEPS, batch=8, seed=1):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.normal(size=(batch, image, image, 3)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 10, size=batch)).long()) for _ in range(n)]


@pytest.mark.parametrize("name", list(MODELS))
def test_compiled_train_step_equals_eager_over_3_steps(name):
    make, image = MODELS[name]
    batches = _batches(image)
    eager, eager_sums = _train(make, train_forward, batches)
    comp, comp_sums = _train(make, compile_forward(train_forward, CPU), batches)
    assert comp.step == eager.step == STEPS
    for k in ("loss_sum", "correct", "count"):
        torch.testing.assert_close(comp_sums[k], eager_sums[k], rtol=RTOL, atol=ATOL)
    assert float(comp_sums["count"]) == 8.0 * STEPS
    # Params and the BatchNorm running statistics (a ViT has none).
    want = eager.model.state_dict()
    got = comp.model.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=RTOL, atol=ATOL, msg=key)
    # SGD's momentum.
    for p_c, p_e in zip(comp.model.parameters(), eager.model.parameters()):
        torch.testing.assert_close(comp.optimizer.state[p_c]["momentum_buffer"],
                                   eager.optimizer.state[p_e]["momentum_buffer"],
                                   rtol=RTOL, atol=ATOL)


# -------------------------------------------------------- the level loop
# (Next to the step tests above and the eval test below: run in one
# process, as a test worker takes a file's tests in order, they reuse
# dynamo's ResNet-18 graphs at these shapes instead of tracing them again.)
def test_cifar10_imp_compiled_matches_eager_with_no_new_graph_at_level_1(tmp_path):
    """``cifar10_imp`` as shipped (ResNet-18, bf16) with
    ``model_params.use_compile=true``, 2 levels of 2 steps, through the
    driver: the compiled forwards run, level 1 (new masks, the rewind
    copied into the params and statistics in place) adds no graph, and the
    run ends where the eager run ends (the level checkpoints, rtol 1e-5,
    atol 1e-6)."""
    graphs = {}

    class Harness(PruningHarness):
        def train_one_level(self, epochs_per_level, level):
            compiled = self._train_forward is not train_forward
            assert (self._eval_forward is not eval_forward) == compiled
            out = super().train_one_level(epochs_per_level, level)
            graphs[compiled, level] = counters["stats"]["unique_graphs"]
            return out

    ends = {}
    for compiled in (False, True):
        base = tmp_path / str(compiled)
        cfg = compose("cifar10_imp", IMP_OVERRIDES + [
            f"model_params.use_compile={str(compiled).lower()}",
            f"experiment_params.base_dir={base}"])
        expt_dir, summaries = run(cfg, device="cpu", harness_cls=Harness)
        assert [s["achieved_density"] for s in summaries] == [1.0, pytest.approx(0.8, abs=1e-6)]
        ends[compiled] = ExperimentCheckpoints(expt_dir)
        # The knob chose the forwards: compiled ones exactly when it is on.
        assert {c for c, _ in graphs} == {False, compiled}
    assert graphs[True, 0] > 0
    assert graphs[True, 1] == graphs[True, 0]
    for level in (0, 1):
        want, got = ends[False].load_level(level), ends[True].load_level(level)
        for role in ("params", "batch_stats", "masks"):
            assert got[role].keys() == want[role].keys()
            for key in want[role]:
                torch.testing.assert_close(got[role][key], want[role][key], rtol=RTOL,
                                           atol=ATOL, msg=f"level {level} {key}")


def test_compiled_eval_sums_equal_eager_without_padded_rows():
    model, masks = _seeded(_resnet18, seed=2)
    mark_buffers_static(model)
    (x, y), = _batches(32, n=1, seed=3)
    y[6:] = -1  # the loaders pad the last batch with label -1
    compiled = compile_forward(eval_forward, CPU)
    before = {k: v.clone() for k, v in model.named_buffers()}
    padded = eval_step(model, masks, (x, y), compiled)
    eager = eval_step(model, masks, (x, y))
    real = eval_step(model, masks, (x[:6], y[:6]))
    assert float(padded["count"]) == 6.0
    for k in ("loss_sum", "correct", "count"):
        torch.testing.assert_close(padded[k], eager[k], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(padded[k], real[k], rtol=RTOL, atol=ATOL)
    assert all(torch.equal(v, before[k]) for k, v in model.named_buffers())


# ------------------------------------------------- against the JAX package
def test_compiled_resnet_steps_match_jax_scan_epoch():
    """Three compiled SGD steps of a width-8 ResNet-18 (CIFAR stem, fp32)
    with masks against ``make_scan_epoch`` over the same three batches,
    under ``jax.jit``, from bridged weights: the summed metrics, the params
    and the running statistics.

    The peak lr is 0.05. At 0.2 the JAX step's second update on the CPU
    lies 2.1e-3 of a weight's norm (layer1_0.Conv_0) from the float64
    update, the port's fp32 step (eager and compiled alike) 7.8e-7, and
    the third step amplifies the gap to 5%; at 0.05 the two packages agree
    to 1.1e-6 after every step."""
    jmodel = jax_resnet.resnet18(10, cifar_stem=True, width=8)
    variables = seeded_variables(jmodel, 16, seed=4)
    masks = jax_masks(variables["params"], seed=4, keep=0.7)
    schedule = jax_create_schedule("TriangularSchedule", JAX_LR, 1, STEPS)
    tx = jax_create_optimizer("SGD", schedule, momentum=0.9, weight_decay=5e-4)
    jstate = jax_create_train_state(jmodel, tx, jax.random.PRNGKey(0), (1, 16, 16, 3),
                                    variables=variables, masks=masks)
    epoch = jax.jit(make_scan_epoch(jax_make_train_step(jmodel, tx, schedule)))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(STEPS, 8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(STEPS, 8)).astype(np.int32)
    jstate, jsums = epoch(jstate, (jnp.asarray(x), jnp.asarray(y)))

    state_dict, tmasks = bridge.params_from_flax(variables["params"], masks,
                                                 variables["batch_stats"])
    tmodel = tresnet.resnet18(10, cifar_stem=True, width=8)
    tmodel.load_state_dict(state_dict)
    mark_buffers_static(tmodel)
    tstate = create_train_state(
        tmodel, create_optimizer("SGD", momentum=0.9, weight_decay=5e-4), tmasks)
    step = make_train_step(create_schedule("TriangularSchedule", JAX_LR, 1, STEPS),
                           compile_forward(train_forward, CPU))
    sums = None
    for i in range(STEPS):
        sums = add_sums(sums, step(tstate, (torch.from_numpy(x[i]),
                                            torch.from_numpy(y[i]).long())))
    np.testing.assert_allclose(float(sums["loss_sum"]), float(jsums["loss_sum"]), rtol=1e-5)
    assert float(sums["correct"]) == float(jsums["correct"])
    assert float(sums["count"]) == float(jsums["count"]) == 8.0 * STEPS
    ref, _ = bridge.params_from_flax(jax.device_get(jstate.params), None,
                                     jax.device_get(jstate.batch_stats))
    got = tstate.model.state_dict()
    assert got.keys() == ref.keys()
    for key, want in ref.items():
        tol = (1e-5, 1e-6) if key.endswith((".mean", ".var")) else (1e-4, 1e-6)
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=tol[0], atol=tol[1],
                                   err_msg=key)


# ---------------------------------------------------------- no fallback
def test_a_graph_break_raises_instead_of_running_eagerly():
    def forward(model, masks, images, labels):
        torch._dynamo.graph_break()
        return {"sum": images.sum()}

    compiled = compile_forward(forward, CPU)
    with pytest.raises(torch._dynamo.exc.Unsupported):
        compiled(None, {}, torch.ones(2), torch.ones(2))


def test_compile_forward_refuses_a_device_without_a_backend():
    with pytest.raises(ValueError, match="no compiled step"):
        compile_forward(train_forward, torch.device("meta"))
