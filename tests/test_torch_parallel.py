"""The port's multi-process layer (turboprune_tpu_torch/parallel/) in a real
gloo world of 2 processes on localhost, against the JAX package's mesh.

The world (``tests/torch_port_dp_worker.py``, suite "parallel") is spawned
once per test run (``run_once``); every case reads its results. In it:
``broadcast_object`` returns rank 0's object; ``check_state_equality``
raises on a divergence planted in one leaf, naming it, and on an element
permutation only with ``exact=True``; ``assert_width_agreement`` raises on
differing signatures; primary-only checkpoint saves round-trip and every
rank reads rank 0's; and one train step of a width-8 ResNet-18 (CIFAR
stem, fp32, 16x16 images, SGD with momentum and weight decay, masks) on a
global batch of 8, 4 rows a rank, on the weights passed through
``bridge.py``, against one step of the JAX package's
``make_sharded_train_step`` on ``create_mesh(num_devices=2)``:

- the BatchNorm running statistics after the step and the train
  forward's logits within 1e-5 of each tensor's largest magnitude (fp32;
  the statistics are the global batch's on both sides);
- the parameters by ROADMAP.md's fp32 rule: each step's update (params
  after less before) per tensor within 1e-3 + 2 x the noise of the
  update of a float64 step, the noise being the largest distance of the
  port's one-process fp32 step in 4 orders of the batch;
- magnitude masks at density 0.8 on the bridged weights bit for bit.

Without a world: the loaders' shards against the JAX package's (the .tpk
loader's strided ``make_shard``, the ImageFolder loader's spans and
stream against grain's ``IndexSampler`` with ``ShardOptions``) at worlds
of 2 and 3, with the eval length the same on every rank; a world of one,
where every function is a no-op and the step is today's bit for bit; the
(data, model) grid of ``model_parallelism`` and its groups; and the
refusals of ``initialize_distributed`` and ``create_mesh``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import jax_masks, run_once, seeded_variables, spawn_world, write_image_folder
from turboprune_tpu.data.native import make_shard as jax_make_shard
from turboprune_tpu.models import resnet as jax_resnet
from turboprune_tpu.parallel import create_mesh as jax_create_mesh
from turboprune_tpu.parallel import make_sharded_train_step
from turboprune_tpu.pruning import prune_the_model as jax_prune_the_model
from turboprune_tpu.train import create_optimizer as jax_create_optimizer
from turboprune_tpu.train import create_schedule as jax_create_schedule
from turboprune_tpu.train import create_train_state as jax_create_train_state
from turboprune_tpu.train import make_train_step as jax_make_train_step
from turboprune_tpu_torch import bridge, parallel
from turboprune_tpu_torch.data import imagenet, native
from turboprune_tpu_torch.models import resnet as tresnet
from turboprune_tpu_torch.train import (
    create_optimizer,
    create_schedule,
    create_train_state,
    make_train_step,
)

BATCH = 8
ORDERS = 4
LIMIT = 1e-3        # the fp32 rule's limit on an update's distance from float64
STATS_TOL = 1e-5    # of each tensor's largest magnitude


def _schedule(create):
    return create("TriangularSchedule", 0.2, 1, 3)


def _jax_case():
    jmodel = jax_resnet.resnet18(10, cifar_stem=True, width=8)
    variables = seeded_variables(jmodel, 16, seed=4)
    masks = jax_masks(variables["params"], seed=4, keep=0.7)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(BATCH, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=BATCH).astype(np.int32)
    return jmodel, variables, masks, x, y


def _jax_reference(jmodel, variables, masks, x, y) -> dict:
    """One step of the JAX package's sharded step on a 2-device mesh, its
    train forward's logits, and its magnitude masks at density 0.8."""
    mesh = jax_create_mesh(num_devices=2)
    tx = jax_create_optimizer("SGD", _schedule(jax_create_schedule), momentum=0.9,
                              weight_decay=5e-4)
    state = jax_create_train_state(jmodel, tx, jax.random.PRNGKey(0), (1, 16, 16, 3),
                                   variables=variables, masks=masks)
    step = make_sharded_train_step(jax_make_train_step(jmodel, tx, _schedule(jax_create_schedule)),
                                   mesh)
    state, _ = step(state, (jnp.asarray(x), jnp.asarray(y)))
    after, _ = bridge.params_from_flax(jax.device_get(state.params), None,
                                       jax.device_get(state.batch_stats))
    masked = jax.tree.map(lambda p, m: p if m is None else p * m, variables["params"], masks,
                          is_leaf=lambda z: z is None)
    logits, _ = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
        {"params": masked, "batch_stats": variables["batch_stats"]}, jnp.asarray(x))
    ones = jax.tree.map(lambda m: None if m is None else np.ones(m.shape, bool), masks,
                        is_leaf=lambda z: z is None)
    mag = jax_prune_the_model("mag", jmodel, variables, ones, 0.8, jax.random.PRNGKey(0))
    _, mag = bridge.params_from_flax(variables["params"], jax.device_get(mag))
    return {"state": after, "logits": torch.from_numpy(np.array(logits)), "mag": mag}


def _port_step(state: dict, masks: dict, x, y, dtype=torch.float32) -> dict:
    """The port's step in one process, fp32 or float64 (the head's fp32
    cast patched out, as card_cpu_noise.py does)."""
    model = tresnet.resnet18(10, cifar_stem=True, width=8)
    model.load_state_dict(state)
    if dtype == torch.float64:
        model = model.double()
        for module in model.modules():
            if hasattr(module, "dtype"):
                module.dtype = torch.float64
        model.fc.forward = lambda z, fc=model.fc: torch.nn.functional.linear(
            z.double(), fc.weight, fc.bias)
    ts = create_train_state(model, create_optimizer("SGD", momentum=0.9, weight_decay=5e-4), masks)
    make_train_step(_schedule(create_schedule))(ts, (x.to(dtype), y))
    return {k: v.detach().double() for k, v in model.state_dict().items()}


def _produce(root):
    jmodel, variables, masks, x, y = _jax_case()
    state, tmasks = bridge.params_from_flax(variables["params"], masks, variables["batch_stats"])
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    torch.save({"state": state, "masks": tmasks, "x": tx, "y": ty,
                "ones": {k: torch.ones_like(m) for k, m in tmasks.items()}}, root / "inputs.pt")
    orders = [torch.arange(BATCH)] + [
        torch.randperm(BATCH, generator=torch.Generator().manual_seed(i)) for i in range(1, ORDERS)]

    def references():  # while the world runs
        return {
            "jax": _jax_reference(jmodel, variables, masks, x, y),
            "start": {k: v.double() for k, v in state.items()},
            "float64": _port_step(state, tmasks, tx, ty, torch.float64),
            "orders": [_port_step(state, tmasks, tx[o], ty[o]) for o in orders],
        }

    world, made = spawn_world("parallel", root, references)
    return {"world": world, **made}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_once(tmp_path_factory, "torch_parallel", _produce)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ------------------------------------------------------------ the world of 2


def test_broadcast_object_returns_rank_0s(world):
    assert [r["broadcast"]["got"] for r in world["world"]] == [{"rank": 0, "pair": [0, "x"]}] * 2


def test_check_state_equality_names_a_planted_divergence(world):
    for r in world["world"]:
        assert r["equality"]["planted"] == (
            "RuntimeError: planted diverged across hosts: host 0 != host 1 (first differing "
            "leaf index 2). Replicated pruning requires identical PRNG keys on every host.")


def test_check_state_equality_catches_a_permutation_only_exactly(world):
    for r in world["world"]:
        assert r["equality"]["permuted_moments"] is None
        assert "element-permuting divergence" in r["equality"]["permuted_exact"]


def test_assert_width_agreement_raises_on_differing_signatures(world):
    for rank, r in enumerate(world["world"]):
        assert r["widths"]["same"] is None
        assert "width signature diverged across hosts: host 0 != host 1" in r["widths"]["differ"]
        assert f"'Conv_0', {4 + rank}" in r["widths"]["differ"]


def test_primary_only_saves_round_trip_on_every_rank(world):
    for r in world["world"]:
        ck = r["checkpoints"]
        for tree in (ck["level"], ck["init"]):
            assert torch.equal(tree["params"]["w"], torch.zeros(3))
            assert torch.equal(tree["masks"]["Dense_0/kernel"], torch.tensor([True, False, True]))
            assert torch.equal(tree["batch_stats"]["bn.mean"], torch.full((2,), 10.0))
        assert ck["lr"] == 0.1
        assert ck["files"] == ["model_init", "model_level_0"]


def test_step_batchnorm_statistics_and_logits_match_the_jax_mesh(world):
    want = world["jax"]
    for r in world["world"]:
        got = r["jax_step"]
        stats = [k for k in want["state"] if k.endswith((".mean", ".var"))]
        assert len(stats) == 2 * 20
        for k in stats:
            w = want["state"][k]
            assert float((got["state"][k] - w).abs().max()) <= STATS_TOL * float(w.abs().max()), k
        w = want["logits"]
        assert float((got["logits"] - w).abs().max()) <= STATS_TOL * float(w.abs().max())


def test_step_parameters_by_the_fp32_rule(world):
    """Each route's update within LIMIT + 2 x the noise of the float64
    update, per tensor: the JAX mesh's and the port's world of 2."""
    start, ref = world["start"], world["float64"]
    params = [k for k in ref if not k.endswith((".mean", ".var"))]

    def update(state, k):
        return state[k].double() - start[k]

    noise = {k: max(_rel(update(o, k), update(ref, k)) for o in world["orders"]) for k in params}
    routes = {"jax mesh": world["jax"]["state"], "port world of 2": world["world"][0]["jax_step"]["state"]}
    for name, state in routes.items():
        for k in params:
            d = _rel(update(state, k), update(ref, k))
            assert d <= LIMIT + 2 * noise[k], (name, k, d, noise[k])
    # Both ranks of the world end with the same parameters, bit for bit.
    a, b = (r["jax_step"]["state"] for r in world["world"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_magnitude_masks_equal_the_jax_package_bit_for_bit(world):
    want = world["jax"]["mag"]
    for r in world["world"]:
        got = r["jax_step"]["mag"]
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


# ------------------------------------------------------ shards against JAX


class _FakeTpk:
    mode = 0

    def __init__(self, path):
        self.num_samples = 25

    def sample_shape(self, size=None):
        return (4, 4, 3)


@pytest.mark.parametrize("world_size", [2, 3])
def test_tpk_shards_equal_jax_make_shard(monkeypatch, world_size):
    monkeypatch.setattr(native, "TpkFile", _FakeTpk)
    monkeypatch.setattr(native, "process_count", lambda: world_size)
    lengths = set()
    for rank in range(world_size):
        monkeypatch.setattr(native, "process_index", lambda r=rank: r)
        for train in (True, False):
            loader = native.TpkImageLoader("x.tpk", 6, train=train, device="cpu")
            np.testing.assert_array_equal(loader._shard, jax_make_shard(25, rank, world_size))
            assert loader.batch_size == 6 // world_size
            # The JAX loader's lengths: train floor(n / W) // b, eval the
            # largest shard's batches.
            b = 6 // world_size
            want = (25 // world_size) // b if train else -(-(-(-25 // world_size)) // b)
            assert len(loader) == want
            lengths.add((train, len(loader)))
    assert len(lengths) == 2  # one train and one eval length on every rank


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    # 25 records: a remainder at worlds of 2 and 3.
    return write_image_folder(tmp_path_factory.mktemp("shard_folder"),
                              classes=("a", "b", "c", "d", "e"), per_class=5)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("world_size", [2, 3])
def test_imagefolder_shards_equal_grain(folder, monkeypatch, world_size, train):
    """Each rank's stream (grain's sampler index, record) over two passes
    of its shard, and its length, against grain's ``IndexSampler`` with
    ``ShardOptions(rank, W, drop_remainder=train)`` as the JAX loader
    builds it; the eval length is the same on every rank."""
    import grain.python as grain

    monkeypatch.setattr(imagenet, "process_count", lambda: world_size)
    n, seed, total = 25, 7, 6
    b = total // world_size
    lengths = set()
    for rank in range(world_size):
        monkeypatch.setattr(imagenet, "process_index", lambda r=rank: r)
        loader = imagenet.ImageFolderLoader(str(folder), total, train=train, num_workers=0,
                                            seed=seed, image_size=8, device="cpu")
        options = grain.ShardOptions(shard_index=rank, shard_count=world_size,
                                     drop_remainder=train)
        sampler = grain.IndexSampler(num_records=n, shard_options=options, shuffle=train,
                                     num_epochs=None, seed=seed)
        start, end = grain_span = loader.span
        local = end - start
        if train:
            stream = imagenet._train_stream(loader.span, loader.shard, b, len(loader), seed, 0)
            pairs = [p for _ in range(-(-2 * local // b)) for p in next(stream)][:2 * local]
        else:
            loader.raw_batches()
            pairs = [p for batch in loader._sampler.batches for p in batch]
            pairs = [(k * world_size + rank, rec) for k, (_, rec) in enumerate(pairs)]
        want = []
        for k in range(len(pairs)):
            meta = sampler[k * world_size + rank]
            want.append((meta.index, meta.record_key))
        assert pairs == want, (rank, grain_span)
        assert local == (n // world_size if train else len(range(rank, n, world_size)))
        shard_samples = n // world_size if train else -(-n // world_size)
        assert len(loader) == (shard_samples // b if train else -(-shard_samples // b))
        lengths.add(len(loader))
        loader.close()
    assert len(lengths) == 1


def test_imagefolder_eval_pads_a_short_shard_with_whole_batches(folder, monkeypatch):
    """At a world of 3 over 25 records the last rank's shard holds 8 of
    the largest shard's 9: its last batch is padding only."""
    monkeypatch.setattr(imagenet, "process_count", lambda: 3)
    monkeypatch.setattr(imagenet, "process_index", lambda: 2)
    loader = imagenet.ImageFolderLoader(str(folder), 12, train=False, num_workers=0,
                                        image_size=8, device="cpu")
    tasks, count = loader.raw_batches()
    batches = [task() for task in tasks]
    assert count == len(loader) == 3 and loader.span == (17, 25)
    assert [int((labels >= 0).sum()) for _, labels in batches] == [4, 4, 0]
    assert all(images.shape == (4, 8, 8, 3) for images, _ in batches)
    loader.close()


# --------------------------------------------------------- a world of one


def test_a_world_of_one_makes_every_function_a_no_op():
    mesh = parallel.create_mesh()
    assert mesh.data_size == 1 and mesh.data_group is None and parallel.process_count() == 1
    assert parallel.is_primary() and parallel.process_index() == 0
    obj = ("dir", 3)
    assert parallel.broadcast_object(obj) is obj
    parallel.check_state_equality({"a": torch.ones(2)}, exact=True)
    parallel.assert_width_agreement({"widths": [1]})
    parallel.sync_hosts("x")
    batch = (torch.ones(3, 2), torch.zeros(3))
    assert parallel.shard_batch(batch, mesh) is batch
    sums = {"count": torch.tensor(3.0)}
    assert parallel.all_reduce_sums(sums, mesh) is sums
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    parallel.average_gradients([p], mesh)
    assert torch.equal(p.grad, torch.full((2,), 3.0))
    model = tresnet.resnet18(10, cifar_stem=True, width=8)
    parallel.set_batchnorm_group(model, mesh)
    assert all(getattr(m, "sync_mesh", None) is None for m in model.modules())


def test_a_world_of_one_step_is_unchanged_bit_for_bit():
    torch.manual_seed(0)
    base = tresnet.resnet18(10, cifar_stem=True, width=8).init_weights(
        torch.Generator().manual_seed(0))
    x = torch.randn(4, 16, 16, 3)
    y = torch.tensor([1, 2, 3, 4])
    ends = []
    for mesh in (None, parallel.create_mesh()):
        model = copy.deepcopy(base)
        parallel.set_batchnorm_group(model, mesh)
        state = create_train_state(model, create_optimizer("SGD", momentum=0.9, weight_decay=5e-4))
        step = make_train_step(_schedule(create_schedule), mesh=mesh)
        for _ in range(2):
            step(state, (x, y))
        ends.append(model.state_dict())
    assert all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0])


def test_without_a_launcher_the_process_joins_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_distributed(device="cpu") == torch.device("cpu")
    assert not parallel.is_distributed()


def test_a_local_rank_beyond_the_cards_raises(monkeypatch):
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1 but 1 CUDA device"):
        parallel.initialize_distributed(device="cuda")
    assert not parallel.is_distributed()


def test_num_devices_unequal_to_the_world_raises():
    with pytest.raises(ValueError, match="refusing to silently under-provision"):
        parallel.create_mesh(num_devices=4)
    assert parallel.create_mesh(num_devices=1).data_size == 1


def test_model_parallelism_lays_the_world_out_as_jax_does(monkeypatch):
    """A world of 8 with model_parallelism 2 is JAX's ``arange(8).reshape(4,
    2)``: rank 5 sits at data row 2, model column 1; its data group is its
    column, its ring its row. Every rank creates every group in the same
    order (torch's rule: the columns, then the rows). A world that does not
    divide raises, as JAX's ``create_mesh``."""
    from turboprune_tpu_torch.parallel import mesh as mesh_module

    made = []
    monkeypatch.setattr(mesh_module, "process_count", lambda: 8)
    monkeypatch.setattr(mesh_module, "process_index", lambda: 5)
    monkeypatch.setattr(mesh_module.dist, "new_group", lambda ranks: made.append(ranks) or ranks)
    mesh = parallel.create_mesh(model_parallelism=2)
    assert mesh.grid.tolist() == np.arange(8).reshape(4, 2).tolist()
    assert (mesh.data_size, mesh.model_size, mesh.data_rank, mesh.model_rank) == (4, 2, 2, 1)
    assert made == [[0, 2, 4, 6], [1, 3, 5, 7], [0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.data_group == [1, 3, 5, 7] and mesh.model_group == [4, 5]
    made.clear()
    ring = parallel.create_mesh(model_parallelism=8)  # one data row: no data group
    assert made == [list(range(8))]
    assert (ring.data_size, ring.model_size, ring.data_group, ring.model_group) == (
        1, 8, None, list(range(8)))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallelism=2"):
        parallel.create_mesh(model_parallelism=2)
    one = parallel.create_mesh()
    assert (one.model_size, one.model_rank, one.model_group) == (1, 0, None)
