"""The port's training layer (turboprune_tpu_torch/train/) against the JAX
package's: LR schedules, SGD and AdamW, the train step of a tiny DeiT
with flash attention (the JAX side runs Pallas in interpret mode on the
CPU, forward and backward), and the train step of a small ResNet-18 with
its BatchNorm statistics.

Tolerances: schedules rtol 1e-6, atol 1e-7 (the JAX package evaluates them
in float32, the port in Python floats: a few float32 ulps of base_lr 0.2,
which is what values near zero carry). Optimizers, after 5 steps: SGD rtol
and atol 1e-7 (the same float32 update in another association); AdamW rtol
and atol 1e-5, "up to rounding": torch and optax normalise the moments
(bias corrections, sqrt, eps) in other orders, a few float32 ulps of the
params per step. Train step, fp32: loss rtol 1e-5, params rtol 1e-4 and
atol 1e-6 after 1 and 3 steps, tighter than tests/test_scan_epoch.py's
rtol 5e-3 / 1e-3 / 1e-4: both sides compute the same fp32 forward and
backward, in other summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, images, jax_deit, jax_masks, jax_params, seeded_variables
from turboprune_tpu.models import resnet as jax_resnet
from turboprune_tpu.train import create_optimizer as jax_create_optimizer
from turboprune_tpu.train import create_schedule as jax_create_schedule
from turboprune_tpu.train import create_train_state as jax_create_train_state
from turboprune_tpu.train import make_train_step as jax_make_train_step
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.models import resnet as tresnet
from turboprune_tpu_torch.models import vit as tvit
from turboprune_tpu_torch.train import (
    create_optimizer,
    create_schedule,
    create_train_state,
    eval_step,
    make_train_step,
    set_lr,
)

SCHEDULES = (
    "TriangularSchedule",
    "TrapezoidalSchedule",
    "ImageNetLRDropsWarmup",
    "MultiStepLRWarmup",
    "OneCycleLR",
    "ScheduleFree",
)


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_match_jax_per_step(name):
    # 130 epochs of 2 steps pass every milestone (epochs 40, 60, 70, 120).
    kw = dict(base_lr=0.2, epochs=130, steps_per_epoch=2, warmup_fraction=0.2)
    ref = jax_create_schedule(name, **kw)
    got = create_schedule(name, **kw)
    steps = range(0, 130 * 2 + 3)
    np.testing.assert_allclose(
        [got(s) for s in steps],
        [float(ref(s)) for s in steps],
        rtol=1e-6, atol=1e-7, err_msg=name,
    )


def test_unknown_schedule_and_optimizer_raise():
    with pytest.raises(ValueError, match="Unknown scheduler_type"):
        create_schedule("Nope", 0.1, 1, 1)
    with pytest.raises(ValueError, match="Unknown optimizer_name"):
        create_optimizer("Nope")
    # Ported since: schedule-free SGD builds (tests/test_torch_schedule_free.py).
    params = [torch.nn.Parameter(torch.ones(2))]
    assert type(create_optimizer("ScheduleFreeSGD")(params)).__name__ == "ScheduleFreeSGD"


@pytest.mark.parametrize("name", ["SGD", "AdamW"])
def test_optimizer_matches_optax_on_identical_grads(name):
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        for _ in range(5)
    ]
    schedule = create_schedule("TriangularSchedule", 0.1, epochs=1, steps_per_epoch=5)
    tx = jax_create_optimizer(
        name, jax_create_schedule("TriangularSchedule", 0.1, 1, 5),
        momentum=0.9, weight_decay=5e-4,
    )
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = create_optimizer(name, momentum=0.9, weight_decay=5e-4)(tparams.values())
    for step, g in enumerate(grads):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        set_lr(opt, schedule(step))
        opt.step()
    tol = {"SGD": 1e-7, "AdamW": 1e-5}[name]
    for k in shapes:
        np.testing.assert_allclose(
            tparams[k].detach().numpy(), np.asarray(jparams[k]),
            rtol=tol, atol=tol, err_msg=f"{name} {k}",
        )


def _jax_and_port_states(seed=0):
    params = jax_params(seed=seed)
    masks = jax_masks(params, seed=seed, keep=0.7)
    model = jax_deit("flash")
    tx = jax_create_optimizer(
        "SGD", jax_create_schedule("TriangularSchedule", 0.2, 1, 3),
        momentum=0.9, weight_decay=5e-4,
    )
    jstate = jax_create_train_state(
        model, tx, jax.random.PRNGKey(0), (1, 32, 32, 3),
        variables={"params": params}, masks=masks,
    )
    jstep = jax.jit(jax_make_train_step(
        model, tx, jax_create_schedule("TriangularSchedule", 0.2, 1, 3)))
    state_dict, tmasks = bridge.params_from_flax(params, masks)
    tmodel = tvit.VisionTransformer(**TINY, image_size=32, attention_impl="flash")
    tmodel.load_state_dict(state_dict)
    tstate = create_train_state(
        tmodel, create_optimizer("SGD", momentum=0.9, weight_decay=5e-4), tmasks
    )
    tstep = make_train_step(create_schedule("TriangularSchedule", 0.2, 1, 3))
    return jstate, jstep, tstate, tstep


def test_train_step_matches_jax_after_1_and_3_steps():
    jstate, jstep, tstate, tstep = _jax_and_port_states()
    rng = np.random.default_rng(1)
    x = images(8, seed=1)
    y = rng.integers(0, 10, size=8).astype(np.int32)
    before = {k: v.detach().clone() for k, v in tstate.model.state_dict().items()}
    for n in range(1, 4):
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y).long()))
        np.testing.assert_allclose(
            float(tm["loss_sum"]) / float(tm["count"]),
            float(jm["loss_sum"]) / float(jm["count"]), rtol=1e-5,
        )
        assert float(tm["correct"]) == float(jm["correct"])
        assert float(tm["count"]) == float(jm["count"]) == 8.0
        if n == 1:
            # Masked weights: zero data-gradient, yet they move under weight
            # decay (first step: buf = g + wd*w = wd*w, w -= lr*buf).
            lr = 0.2 * 0.2
            for path, m in tstate.masks.items():
                key = path[: -len("/kernel")].replace("/", ".") + ".weight"
                p = dict(tstate.model.named_parameters())[key]
                assert not p.grad[~m].any(), key
                w0 = before[key][~m]
                torch.testing.assert_close(
                    p.detach()[~m], w0 - lr * 5e-4 * w0, rtol=1e-6, atol=1e-9
                )
                assert (p.detach()[~m] != w0).any(), key
        if n in (1, 3):
            ref, _ = bridge.params_from_flax(jax.device_get(jstate.params))
            got = tstate.model.state_dict()
            for key, want in ref.items():
                np.testing.assert_allclose(
                    got[key].numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                    err_msg=f"step {n} {key}",
                )
    assert tstate.step == 3


def test_eval_step_ignores_padded_rows():
    _, _, tstate, _ = _jax_and_port_states(seed=2)
    x = torch.from_numpy(images(6, seed=3))
    y = torch.tensor([1, 4, 7, 2, -1, -1])
    padded = eval_step(tstate.model, tstate.masks, (x, y))
    real = eval_step(tstate.model, tstate.masks, (x[:4], y[:4]))
    assert float(padded["count"]) == 4.0
    for k in ("loss_sum", "correct", "count"):
        torch.testing.assert_close(padded[k], real[k], rtol=1e-6, atol=1e-6)


def test_resnet_train_step_matches_jax_params_and_batch_stats():
    """One SGD step of a width-8 ResNet-18 (CIFAR stem, fp32) with masks:
    the loss, the updated params (rtol 1e-4, atol 1e-6, as the DeiT step)
    and the running statistics the step's train-mode forward moved (rtol
    1e-5, atol 1e-6, as the forward alone in tests/test_torch_resnet.py).
    The eval step then runs on those statistics."""
    jmodel = jax_resnet.resnet18(10, cifar_stem=True, width=8)
    variables = seeded_variables(jmodel, 16, seed=4)
    masks = jax_masks(variables["params"], seed=4, keep=0.7)
    tx = jax_create_optimizer(
        "SGD", jax_create_schedule("TriangularSchedule", 0.2, 1, 3),
        momentum=0.9, weight_decay=5e-4,
    )
    jstate = jax_create_train_state(jmodel, tx, jax.random.PRNGKey(0), (1, 16, 16, 3),
                                    variables=variables, masks=masks)
    jstep = jax.jit(jax_make_train_step(
        jmodel, tx, jax_create_schedule("TriangularSchedule", 0.2, 1, 3)))
    state, tmasks = bridge.params_from_flax(variables["params"], masks, variables["batch_stats"])
    tmodel = tresnet.resnet18(10, cifar_stem=True, width=8)
    tmodel.load_state_dict(state)
    tstate = create_train_state(
        tmodel, create_optimizer("SGD", momentum=0.9, weight_decay=5e-4), tmasks)
    tstep = make_train_step(create_schedule("TriangularSchedule", 0.2, 1, 3))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=8).astype(np.int32)
    jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
    tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y).long()))
    np.testing.assert_allclose(float(tm["loss_sum"]), float(jm["loss_sum"]), rtol=1e-5)
    ref, _ = bridge.params_from_flax(jax.device_get(jstate.params), None,
                                     jax.device_get(jstate.batch_stats))
    got = tstate.model.state_dict()
    assert got.keys() == ref.keys()
    for key, want in ref.items():
        tol = (1e-5, 1e-6) if key.endswith((".mean", ".var")) else (1e-4, 1e-6)
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=tol[0], atol=tol[1],
                                   err_msg=key)
    tree = tstate.model_tree()
    assert set(tree["batch_stats"]) == {k for k in got if k.endswith((".mean", ".var"))}
    assert not set(tree["params"]) & set(tree["batch_stats"])
    before = {k: v.clone() for k, v in tree["batch_stats"].items()}
    sums = eval_step(tstate.model, tstate.masks, (torch.from_numpy(x), torch.from_numpy(y).long()))
    assert all(torch.equal(v, before[k]) for k, v in tstate.model_tree()["batch_stats"].items())
    jlogits = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))({"params": jax.tree.map(
        lambda p, m: p if m is None else p * m, jax.device_get(jstate.params), masks,
        is_leaf=lambda z: z is None), "batch_stats": jstate.batch_stats}, jnp.asarray(x))
    np.testing.assert_allclose(
        float(sums["correct"]), float((np.asarray(jlogits).argmax(-1) == y).sum()))
