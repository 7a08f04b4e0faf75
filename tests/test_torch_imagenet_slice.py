"""The ImageFolder slice as a whole on the CPU: ``run_experiment_torch.main``
on conf/imagenet_imp.yaml and conf/imagenet_er_balanced.yaml as shipped
(``dataloader_type: grain``, 2 DataLoader workers here) over a tiny JPEG
ImageFolder the test writes, cut to ResNet-18 (to keep seconds), images of
32 x 32, batch 8, one step an epoch, two epochs a level, the mid-level
slot saved every epoch. Run a is preempted right after its level-1,
epoch-0 slot save (copies of its dir at that point) and one copy resumed:
the stream position in the slot (tier 1) gives it the batches of the
uninterrupted run, and its level-1 checkpoint equals run a's bit for bit.
A stream blob tagged for another save gives a fresh pass (tier 3). The
harness's restore no longer hands a stream loader its epoch counter as if
that were its state."""

import csv
import hashlib
import math
import shutil
from pathlib import Path
from unittest import mock

import pytest
import torch

import run_experiment_torch
from torch_port_fixtures import one_torch_thread, run_once, write_image_folder  # noqa: F401
from turboprune_tpu_torch.config import compose
from turboprune_tpu_torch.data import create_loaders
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.utils import ExperimentCheckpoints
from turboprune_tpu_torch.utils.checkpoint import ExperimentCheckpoints as Ckpts

OVERRIDES = [
    "model_params.model_name=resnet18",
    "dataset_params.image_size=32",
    "dataset_params.total_batch_size=8",
    "dataset_params.num_workers=2",
    "experiment_params.epochs_per_level=2",
    "experiment_params.max_steps_per_epoch=1",
    "experiment_params.checkpoint_every_epochs=1",
]


def _main(config: str, base: Path, data: Path, extra: list) -> Path:
    before = set(base.iterdir()) if base.exists() else set()
    rc = run_experiment_torch.main([
        "--device", "cpu", f"--config-name={config}", *OVERRIDES,
        f"dataset_params.data_root_dir={data}", f"experiment_params.base_dir={base}", *extra])
    assert rc == 0
    (expt,) = {p for p in set(base.iterdir()) - before if "_preempted" not in p.name}
    return expt


def _resume(base: Path, data: Path, name: str) -> None:
    run_experiment_torch.main([
        "--device", "cpu", "--config-name=imagenet_imp", *OVERRIDES,
        "pruning_params.target_sparsity=0.2",
        f"dataset_params.data_root_dir={data}", f"experiment_params.base_dir={base}",
        "experiment_params.resume_experiment=true",
        f"experiment_params.resume_experiment_stuff.resume_expt_name={name}",
        "experiment_params.resume_experiment_stuff.resume_level=1"])


def _write_data(root: Path) -> Path:
    root = root / "imagenet"
    # 18 training images (2 batches of 8 and a remainder of 2) and 10 for
    # evaluation (two batches, the second padded), 64 x 48 and 48 x 64.
    sizes = ((64, 48), (48, 64))
    write_image_folder(root / "train", ("n01", "n02"), 9, sizes, seed=0)
    write_image_folder(root / "val", ("n01", "n02"), 5, sizes, seed=1)
    return root


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_data(tmp_path_factory.mktemp("imagenet_slice"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run a (recording each step's batch), its preempted copies, and one
    copy resumed (recording too), on data of their own; once per session
    (``run_once``)."""
    return run_once(tmp_path_factory, "imagenet_slice", _runs)


def _runs(root: Path) -> dict:
    data = _write_data(root)
    base = data.parent / "experiments"
    out = {"batches": {}, "data": data}
    save = Ckpts.save_mid_level
    train_batches = PruningHarness.train_batches

    def save_then_copy(self, level, epoch, state, meta):
        save(self, level, epoch, state, meta)
        if (level, epoch) == (1, 0) and "preempted" not in out:
            for key in ("preempted", "preempted_stale"):
                out[key] = Path(str(self.expt_dir) + "_" + key)
                shutil.copytree(self.expt_dir, out[key])

    def recorded(self):
        name = Path(self.expt_dir).name.replace("_preempted", "#")
        for images, labels in train_batches(self):
            digest = hashlib.sha256(images.numpy().tobytes() + labels.numpy().tobytes())
            out["batches"].setdefault(name, []).append(digest.hexdigest())
            yield images, labels

    with mock.patch.object(Ckpts, "save_mid_level", save_then_copy), \
            mock.patch.object(PruningHarness, "train_batches", recorded):
        out["a"] = _main("imagenet_imp", base, data, ["pruning_params.target_sparsity=0.2"])
        _resume(base, data, out["preempted"].name)
    return out


def _rows(expt: Path, level: int) -> list[dict]:
    path = expt / "metrics" / "level_wise_metrics" / f"level_{level}_metrics.csv"
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _same_level_1(got: Path, want: Path) -> None:
    g, w = ExperimentCheckpoints(got).load_level(1), ExperimentCheckpoints(want).load_level(1)
    for group in ("params", "batch_stats", "masks"):
        assert g[group].keys() == w[group].keys()
        for k, v in w[group].items():
            assert torch.equal(g[group][k], v), (group, k)
    keys = ("epoch", "train_loss", "test_loss", "test_acc")
    assert [{k: r[k] for k in keys} for r in _rows(got, 1)] == [
        {k: r[k] for k in keys} for r in _rows(want, 1)]


def test_imagenet_imp_trains_two_levels_from_an_image_folder(runs):
    rows = _rows(runs["a"], 0) + _rows(runs["a"], 1)
    assert [(int(r["level"]), int(r["epoch"])) for r in rows] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in rows:
        assert math.isfinite(float(r["train_loss"])) and math.isfinite(float(r["test_loss"]))
        assert float(r["decode_wait_s"]) >= 0.0 and float(r["consumer_wait_s"]) >= 0.0
    ckpts = ExperimentCheckpoints(runs["a"])
    masks0, masks1 = ckpts.load_level(0)["masks"], ckpts.load_level(1)["masks"]
    n = sum(m.numel() for m in masks1.values())
    assert sum(int(m.sum()) for m in masks0.values()) == n
    assert abs(sum(int(m.sum()) for m in masks1.values()) / n - 0.8) <= 1.0 / n
    # One batch a step off one stream: four different batches.
    assert len(set(runs["batches"][runs["a"].name])) == 4


def test_imagenet_er_balanced_prunes_at_init_to_its_density(data, tmp_path):
    expt = _main("imagenet_er_balanced", tmp_path, data,
                 ["experiment_params.checkpoint_every_epochs=0"])
    masks = ExperimentCheckpoints(expt).load_level(0)["masks"]
    n = sum(m.numel() for m in masks.values())
    # Bernoulli masks at the balanced allocation of density 0.1.
    assert abs(sum(int(m.sum()) for m in masks.values()) / n - 0.1) < 0.01
    for r in _rows(expt, 0):
        assert math.isfinite(float(r["train_loss"]))


def test_preempted_run_resumes_the_stream_to_the_uninterrupted_end(runs, capsys):
    assert not (runs["preempted"] / "checkpoints" / "mid_level").exists()  # cleared at the end
    _same_level_1(runs["preempted"], runs["a"])
    # Level 1, epoch 1: the resumed run's batch is the uninterrupted run's.
    resumed = runs["batches"][runs["a"].name + "#"]
    assert resumed == runs["batches"][runs["a"].name][-1:]


def test_a_stream_blob_of_another_save_gives_a_fresh_pass(runs, capsys):
    stream = runs["preempted_stale"] / "checkpoints" / "mid_level_stream_0"
    blob = stream.read_bytes()
    assert int.from_bytes(blob[:8], "big") == 1_000_000  # level 1, epoch 0
    stream.write_bytes((1_000_005).to_bytes(8, "big") + blob[8:])
    capsys.readouterr()
    data = runs["data"]
    _resume(data.parent / "experiments", data, runs["preempted_stale"].name)
    out = capsys.readouterr().out
    assert "stream-state blob missing or from another save" in out
    assert "fresh shuffle pass" in out
    assert "re-entering level 1 at epoch 1" in out


def test_restore_gives_no_epoch_counter_to_a_stream_loader(tmp_path, capsys):
    """A loader whose epoch counter is not its state (``resumable_epochs =
    False``) and that cannot take a stream blob gets a fresh pass with the
    warning, not the slot's counter as if that restored it."""
    cfg = compose("cifar10_imp", [
        "dataset_params.dataloader_type=synthetic", "dataset_params.total_batch_size=8",
        "dataset_params.synthetic_num_train=16", "dataset_params.synthetic_num_test=8",
        "experiment_params.checkpoint_every_epochs=1", f"experiment_params.base_dir={tmp_path}"])
    harness = PruningHarness(cfg, ("", str(tmp_path / "x")), device="cpu")
    harness.ckpts.save_mid_level(0, 0, harness.state, meta={
        "config_hash": harness.config_hash, "run_id": harness.run_id,
        "train_loader_epoch": 5, "max_test_acc": 0.0, "level_rows": []})

    class StreamLoader:
        resumable_epochs = False
        epoch = 0

    harness.loaders.train_loader = StreamLoader()
    assert harness._enter_mid_level(0)[0] == 1
    assert harness.loaders.train_loader.epoch == 0
    assert "fresh shuffle pass" in capsys.readouterr().out


def test_grain_in_a_world_of_two_processes_raises(data, monkeypatch):
    """Sharded since: a world of two splits the global batch, and a batch
    that does not divide over the world raises."""
    from turboprune_tpu_torch.data import imagenet

    cfg = compose("imagenet_imp", [f"dataset_params.data_root_dir={data}",
                                   "dataset_params.num_workers=0",
                                   "dataset_params.total_batch_size=5"])
    monkeypatch.setattr(imagenet, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="not divisible by the 2 processes"):
        create_loaders(cfg, "cpu")
