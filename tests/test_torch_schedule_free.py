"""``ScheduleFreeSGD`` in the port (train/optim.py) against the JAX
package's ``optax.contrib.schedule_free`` over plain SGD
(turboprune_tpu/train/optim.py), and its state on the port's paths.

- 6 steps over the same seeded gradients on a small tree under the repo's
  cosine (``OneCycleLR``) and linear (``TriangularSchedule``,
  ``TrapezoidalSchedule``, whose lr is 0 at step 0) schedules, with warmup
  and weight decay: ``y`` (the params), ``z`` and the eval params within
  rtol 1e-6 (+ atol 1e-7 for entries near 0) in fp32, the counts exactly.
  optax computes ``ck`` and the weight sum in fp32, the port in Python
  floats.
- The state through the mid-level slot (bit for bit, and the next step
  equal), through ``train_compact``'s slice and expand against the JAX
  package's (``z`` sliced with the params, zeros at removed coordinates
  after the expansion), and through weight rewinding's optimizer restore
  (only the inner SGD's count restarts).
- The harness's ``evaluate`` reads the averaged weights and leaves ``y``
  as it was, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import TINY, IMAGE, seeded_variables
from turboprune_tpu import sparse as jsparse
from turboprune_tpu.models import vit as jvit
from turboprune_tpu.ops import masking as jmasking
from turboprune_tpu.train import create_optimizer as jax_create_optimizer
from turboprune_tpu.train import create_schedule as jax_create_schedule
from turboprune_tpu_torch import bridge, sparse
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.models import vit
from turboprune_tpu_torch.ops import masking
from turboprune_tpu_torch.sparse.graph import model_leaves
from turboprune_tpu_torch.sparse.train_compact import param_paths
from turboprune_tpu_torch.train import (
    ScheduleFreeSGD,
    TrainState,
    create_optimizer,
    create_schedule,
    eval_weights,
    restart_schedule,
    set_lr,
)
from turboprune_tpu_torch.utils import ExperimentCheckpoints

LR, MOMENTUM, WD, STEPS = 0.2, 0.9, 5e-4, 6
SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}


def _close(got: torch.Tensor, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7,
                               err_msg=msg)


def _port(params: dict) -> tuple[list, ScheduleFreeSGD]:
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in sorted(params)]
    return tparams, create_optimizer("ScheduleFreeSGD", momentum=MOMENTUM, weight_decay=WD)(tparams)


def _steps(opt, tparams, schedule, grads, first=0):
    for i, g in enumerate(grads):
        for p, k in zip(tparams, sorted(g)):
            p.grad = torch.from_numpy(g[k])
        set_lr(opt, schedule(first + i), schedule)
        opt.step()


@pytest.mark.parametrize("name", ["OneCycleLR", "TriangularSchedule", "TrapezoidalSchedule"])
def test_matches_optax_schedule_free_over_6_steps(name):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    kw = dict(base_lr=LR, epochs=1, steps_per_epoch=STEPS, warmup_fraction=0.5)
    tx = jax_create_optimizer("ScheduleFreeSGD", jax_create_schedule(name, **kw),
                              momentum=MOMENTUM, weight_decay=WD)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for g in grads:
        updates, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, updates)
    jeval = optax.contrib.schedule_free_eval_params(js, jp)

    tparams, opt = _port(params)
    _steps(opt, tparams, create_schedule(name, **kw), grads)
    group = opt.param_groups[0]
    assert group["step_count"] == int(js.step_count) == STEPS + 1
    assert group["base_count"] == int(js.base_optimizer_state[-1].count) == STEPS
    np.testing.assert_allclose(group["max_lr"], float(js.max_lr), rtol=1e-6)
    np.testing.assert_allclose(group["weight_sum"], float(js.weight_sum), rtol=1e-6)
    evals = opt.eval_params()
    for i, k in enumerate(sorted(params)):
        _close(tparams[i], jp[k], f"y {k}")
        _close(opt.state[tparams[i]]["z"], js.z[k], f"z {k}")
        _close(evals[i], jeval[k], f"eval {k}")
    assert not np.allclose(jeval["a"], jp["a"])  # the averaged weights are not y


def _tiny_state(seed=0):
    model = vit.VisionTransformer(**TINY, image_size=IMAGE).init_weights(
        torch.Generator().manual_seed(seed))
    make = create_optimizer("ScheduleFreeSGD", momentum=MOMENTUM, weight_decay=WD)
    return TrainState(model, masking.make_masks(model), make(model.parameters())), make


def _seeded_steps(state, schedule, n, seed, first=0):
    g = torch.Generator().manual_seed(seed)
    for i in range(n):
        for p in state.model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        set_lr(state.optimizer, schedule(first + i), schedule)
        state.optimizer.step()
        state.step += 1


def test_state_round_trips_through_the_mid_level_slot(tmp_path):
    schedule = create_schedule("TriangularSchedule", LR, 1, 4, warmup_fraction=0.5)
    state, make = _tiny_state()
    _seeded_steps(state, schedule, 2, seed=1)
    ckpts = ExperimentCheckpoints(str(tmp_path))
    ckpts.save_mid_level(1, 0, state, {"config_hash": "x"})
    restored = ckpts.load_mid_level(1, 0)
    other, _ = _tiny_state(seed=5)
    other.model.load_state_dict({**restored["params"], **restored["batch_stats"]})
    other.optimizer.load_state_dict(restored["optimizer"])
    other.step = restored["step"]
    assert other.optimizer.param_groups[0]["step_count"] == 3
    assert other.optimizer.param_groups[0]["base_count"] == 2
    for key in ("weight_sum", "max_lr"):
        assert other.optimizer.param_groups[0][key] == state.optimizer.param_groups[0][key]
    for p, q in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(state.optimizer.state[p]["z"], other.optimizer.state[q]["z"])
    # The next step from the restore equals the next step of the original.
    _seeded_steps(state, schedule, 1, seed=2, first=2)
    _seeded_steps(other, schedule, 1, seed=2, first=2)
    for (name, p), q in zip(state.model.named_parameters(), other.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(state.optimizer.state[p]["z"], other.optimizer.state[q]["z"]), name


def test_rewind_restore_restarts_only_the_inner_count():
    schedule = create_schedule("OneCycleLR", LR, 1, 4)
    state, make = _tiny_state()
    _seeded_steps(state, schedule, 3, seed=1)
    fresh = make(state.model.parameters())
    fresh.load_state_dict(state.optimizer.state_dict())
    restart_schedule(fresh)
    group = fresh.param_groups[0]
    assert (group["step_count"], group["base_count"]) == (4, 0)
    assert group["weight_sum"] == state.optimizer.param_groups[0]["weight_sum"]
    restart_schedule(torch.optim.SGD(state.model.parameters(), lr=0.1))  # a no-op


def test_state_slices_and_expands_as_the_jax_package_does():
    """One step on a depth-2 DeiT (embed 32) in both packages from bridged
    weights and gradients, channel-structured masks (fc1 units killed), then
    ``slice_opt_state`` / ``expand_opt_state`` with each package's plan."""
    jmodel = jvit.VisionTransformer(**TINY)
    variables = seeded_variables(jmodel, IMAGE, seed=3)
    params = jax.tree.map(np.array, variables["params"])
    rng = np.random.default_rng(4)
    masks = jax.tree.map(lambda m: None if m is None else np.ones(m.shape, bool),
                         jax.jit(jmasking.make_masks)(params), is_leaf=lambda x: x is None)
    for i in range(TINY["depth"]):
        fc1 = masks[f"block{i}"]["mlp"]["fc1"]["kernel"]
        fc1[:, rng.random(fc1.shape[1]) < 0.5] = False
        params[f"block{i}"]["mlp"]["fc1"]["bias"][~fc1.any(axis=0)] = 0.0
    grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
    schedule = jax_create_schedule("OneCycleLR", LR, 1, 4)
    tx = jax_create_optimizer("ScheduleFreeSGD", schedule, momentum=MOMENTUM, weight_decay=WD)
    jstate = tx.init(params)
    _, jstate = jax.jit(lambda g, s, p: tx.update(g, s, p))(grads, jstate, params)
    jplan = jsparse.build_plan(params, masks, jsparse.build_graph(jmodel, params))
    jsliced = jsparse.slice_opt_state(jstate, jplan)
    jexpanded = jsparse.expand_opt_state(jsliced, jplan)

    sd, tmasks = bridge.params_from_flax(params, masks)
    model = vit.VisionTransformer(**TINY, image_size=IMAGE)
    model.load_state_dict(sd)
    tparams, tstats = model_leaves(model)
    plan = sparse.build_plan(tparams, tmasks, sparse.build_graph(model, tparams), tstats)
    tgrads, _ = bridge.params_from_flax(grads)
    opt = create_optimizer("ScheduleFreeSGD", momentum=MOMENTUM, weight_decay=WD)(
        model.parameters())
    for name, p in model.named_parameters():
        p.grad = tgrads[name]
    tschedule = create_schedule("OneCycleLR", LR, 1, 4)
    set_lr(opt, tschedule(0), tschedule)
    opt.step()
    assert plan.width_overrides == jplan.width_overrides and plan.width_overrides
    paths = param_paths(model)
    sliced = sparse.slice_opt_state(opt.state_dict(), plan, paths)
    expanded = sparse.expand_opt_state(sliced, plan, paths)
    names = [n for n, _ in model.named_parameters()]
    for tree, port in ((jsliced, sliced), (jexpanded, expanded)):
        want, _ = bridge.params_from_flax(jax.device_get(tree.z))
        for i, name in enumerate(names):
            _close(port["state"][i]["z"], want[name].numpy(), name)
    assert sliced["param_groups"] == opt.state_dict()["param_groups"]
    # The removed fc1 units: z is zero after the expansion, as in JAX.
    fc1 = names.index("block0.mlp.fc1.weight")
    dead = ~torch.from_numpy(plan.out_keep["block0/mlp/fc1/kernel"])
    assert dead.any() and not expanded["state"][fc1]["z"][dead].any()


def test_evaluate_reads_the_averaged_weights_and_restores_y(tmp_path):
    cfg = compose("cifar10_imp", [
        "dataset_params.dataloader_type=synthetic",
        "model_params.model_name=deit_tiny_patch16_224",
        "dataset_params.total_batch_size=8",
        "dataset_params.synthetic_num_train=16",
        "dataset_params.synthetic_num_test=8",
        "experiment_params.max_steps_per_epoch=2",
        "optimizer_params.optimizer_name=ScheduleFreeSGD",
        f"experiment_params.base_dir={tmp_path}"])
    h = PruningHarness(cfg, ("p", str(tmp_path / "expt")), device="cpu")
    h.setup_level(1)
    h.train_epoch()
    y = [p.detach().clone() for p in h.state.model.parameters()]
    averaged = h.state.optimizer.eval_params()
    assert any(not torch.equal(a, b) for a, b in zip(averaged, y))
    seen = []
    evaluate_on = h._evaluate_on

    def recording(model, masks, forward):
        seen.append([p.detach().clone() for p in model.parameters()])
        return evaluate_on(model, masks, forward)

    h._evaluate_on = recording
    got = h.evaluate()
    assert all(torch.equal(a, b) for a, b in zip(seen[0], averaged))
    assert all(torch.equal(p, b) for p, b in zip(h.state.model.parameters(), y))
    # The same pass on a copy of the model holding the averaged weights.
    with eval_weights(h.state.optimizer):
        want = evaluate_on(h.state.model, h.state.masks, h._eval_forward)
    assert got == want
    assert all(torch.equal(p, b) for p, b in zip(h.state.model.parameters(), y))
