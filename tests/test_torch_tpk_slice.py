"""The .tpk slice as a whole on the CPU: ``run_experiment_torch.main`` on
conf/imagenet_imp_tpk.yaml (ResNet-50, SGD, IMP) over a tiny JPEG dataset
the test writes as ImageFolder splits, cut to images of 32 x 32, batch 8,
one step an epoch, two epochs a level, two levels, the mid-level slot
saved every epoch. Run a packs the .tpk files itself (``tpk_auto_pack``,
as shipped); run b reads the same files through explicit paths; run a is
preempted right after its level-1, epoch-0 slot save (a copy of its dir at
that point) and the copy resumed. On the CPU every run is deterministic,
so all three must end with the same level-1 checkpoint bit for bit."""

import csv
import math
import shutil
from pathlib import Path
from unittest import mock

import pytest
import torch

import run_experiment_torch
from torch_port_fixtures import one_torch_thread, run_once, write_image_folder  # noqa: F401
from turboprune_tpu_torch.utils import ExperimentCheckpoints
from turboprune_tpu_torch.utils.checkpoint import ExperimentCheckpoints as Ckpts

OVERRIDES = [
    "dataset_params.image_size=32",
    "dataset_params.total_batch_size=8",
    "dataset_params.tpk_nthreads=2",
    "experiment_params.epochs_per_level=2",
    "experiment_params.max_steps_per_epoch=1",
    "experiment_params.checkpoint_every_epochs=1",
    "pruning_params.target_sparsity=0.2",
]


def _main(base: Path, data: Path, extra: list) -> Path:
    before = set(base.iterdir()) if base.exists() else set()
    rc = run_experiment_torch.main([
        "--device", "cpu", "--config-name=imagenet_imp_tpk", *OVERRIDES,
        f"dataset_params.data_root_dir={data}", f"experiment_params.base_dir={base}", *extra])
    assert rc == 0
    (expt,) = {p for p in set(base.iterdir()) - before if not p.name.endswith("_preempted")}
    return expt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_once(tmp_path_factory, "tpk_slice", _runs)


def _runs(root: Path) -> dict:
    data = root / "imagenet"
    # 18 training images (2 steps of 8, drop-last) and 10 for evaluation
    # (two batches, the second padded), 64 x 48 and 48 x 64.
    sizes = ((64, 48), (48, 64))
    write_image_folder(data / "train", ("n01", "n02"), 9, sizes, seed=0)
    write_image_folder(data / "val", ("n01", "n02"), 5, sizes, seed=1)
    base = root / "experiments"
    out = {}
    save = Ckpts.save_mid_level

    def save_then_copy(self, level, epoch, state, meta):
        save(self, level, epoch, state, meta)
        if (level, epoch) == (1, 0) and "preempted" not in out:
            out["preempted"] = Path(str(self.expt_dir) + "_preempted")
            shutil.copytree(self.expt_dir, out["preempted"])

    with mock.patch.object(Ckpts, "save_mid_level", save_then_copy):
        out["a"] = _main(base, data, [])
    out["packed"] = sorted(p.name for p in data.iterdir())
    out["b"] = _main(base, data, ["dataset_params.tpk_auto_pack=false",
                                  f"dataset_params.tpk_train_path={data / 'train.tpk'}",
                                  f"dataset_params.tpk_val_path={data / 'val.tpk'}"])
    before = set(base.iterdir())
    run_experiment_torch.main([
        "--device", "cpu", "--config-name=imagenet_imp_tpk", *OVERRIDES,
        f"dataset_params.data_root_dir={data}", f"experiment_params.base_dir={base}",
        "experiment_params.resume_experiment=true",
        f"experiment_params.resume_experiment_stuff.resume_expt_name={out['preempted'].name}",
        "experiment_params.resume_experiment_stuff.resume_level=1"])
    assert set(base.iterdir()) == before  # resumed in place
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


def test_auto_pack_and_explicit_paths_train_the_same(runs):
    assert runs["packed"] == ["train", "train.tpk", "val", "val.tpk"]
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
    _same_level_1(runs["b"], runs["a"])


def test_preempted_run_resumes_to_the_uninterrupted_end(runs):
    assert not (runs["preempted"] / "checkpoints" / "mid_level").exists()  # cleared at the end
    _same_level_1(runs["preempted"], runs["a"])
