"""Resume in the port: level resume and the mid-level slot. A ResNet-18
run preempted inside level 1 and resumed is held against the port's own
uninterrupted run, bit for bit; the slot's refusals and clearing are
checked on a tiny DeiT. (The packed masks, the config fingerprint and
``resume_experiment`` against the JAX package:
tests/test_torch_resume_parity.py.)"""

import csv
import json
import shutil
from pathlib import Path

import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import run_once
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.driver import run
from turboprune_tpu_torch.harness import PruningHarness
from turboprune_tpu_torch.utils import config_fingerprint, gen_expt_dir

TINY_OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "model_params.model_name=deit_tiny_patch16_224",
    "dataset_params.synthetic_num_train=8",
    "dataset_params.synthetic_num_test=8",
    "dataset_params.total_batch_size=8",
    "experiment_params.epochs_per_level=1",
    "experiment_params.max_steps_per_epoch=1",
    "pruning_params.target_sparsity=0.2",
]


def test_level_resume_without_its_checkpoint_raises(tmp_path):
    cfg = compose("cifar10_imp", TINY_OVERRIDES + [f"experiment_params.base_dir={tmp_path}"])
    _, expt_dir = gen_expt_dir(cfg)
    cfg = compose("cifar10_imp", TINY_OVERRIDES + [
        f"experiment_params.base_dir={tmp_path}", "experiment_params.resume_experiment=true",
        f"experiment_params.resume_experiment_stuff.resume_expt_name={Path(expt_dir).name}",
        "experiment_params.resume_experiment_stuff.resume_level=1"])
    with pytest.raises(FileNotFoundError, match="model_level_0"):
        run(cfg, device="cpu")


# ------------------------------------------------------- the mid-level slot


def _tiny_harness(tmp_path, ckpt_every=1):
    cfg = compose("cifar10_imp", TINY_OVERRIDES + [
        f"experiment_params.base_dir={tmp_path}",
        f"experiment_params.checkpoint_every_epochs={ckpt_every}"])
    return PruningHarness(cfg, ("p", str(tmp_path / "expt")), device="cpu")


@pytest.mark.parametrize("case", ["restored", "config_changed", "other_level", "torn"])
def test_slot_is_restored_only_when_it_matches(tmp_path, case):
    """A slot of this level and config is restored (re-entry at the next
    epoch); one stamped with another config, one of another level and a
    torn one (header and tree from different saves) are cleared and the
    level trains from epoch 0."""
    h = _tiny_harness(tmp_path)
    h.setup_level(3)
    h.state.step = 7
    saved = {k: v.clone() for k, v in h.state.model.state_dict().items()}
    meta = {"max_test_acc": 12.5, "config_hash": h.config_hash, "run_id": h.run_id,
            "train_loader_epoch": 5, "level_rows": [{"level": 1, "epoch": 0, "test_acc": 12.5}]}
    if case == "config_changed":
        meta["config_hash"] = config_fingerprint(
            compose("cifar10_imp", TINY_OVERRIDES + ["optimizer_params.lr=0.1"]))
    h.ckpts.save_mid_level(0 if case == "other_level" else 1, 0, h.state, meta)
    if case == "torn":  # the tree of a later save under the header of this one
        header = h.ckpts._mid_level_meta_path().read_text()
        h.ckpts.save_mid_level(1, 1, h.state, meta)
        h.ckpts._mid_level_meta_path().write_text(header)
    with torch.no_grad():
        for p in h.state.model.parameters():
            p.add_(1.0)
    h.state.step = 0
    h.setup_level(3)

    start, best = h._enter_mid_level(1)
    if case == "restored":
        assert (start, best) == (1, 12.5)
        assert h.state.step == 7 and h.loaders.train_loader.epoch == 5
        assert h.metrics.level_rows == meta["level_rows"]
        for k, v in h.state.model.state_dict().items():
            assert torch.equal(v, saved[k]), k
        assert h.ckpts.peek_mid_level()["epoch"] == 0  # kept until the run ends
    else:
        assert (start, best) == (0, 0.0)
        assert h.state.step == 0 and h.loaders.train_loader.epoch == 0
        assert h.metrics.level_rows == []
        assert h.ckpts.peek_mid_level() is None
        assert not h.ckpts.mid_level_path().exists()


def test_no_slot_when_checkpoint_every_epochs_is_0(tmp_path):
    h = _tiny_harness(tmp_path, ckpt_every=0)
    h.train_one_level(2, 0)
    assert not h.ckpts.mid_level_path().exists()
    assert not h.ckpts._mid_level_meta_path().exists()


# ---------------------------------- preempted and resumed against uninterrupted

RESNET_OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "dataset_params.total_batch_size=8",
    "dataset_params.synthetic_num_train=16",
    "dataset_params.synthetic_num_test=8",
    "experiment_params.epochs_per_level=3",
    "experiment_params.max_steps_per_epoch=2",
    "experiment_params.checkpoint_every_epochs=1",
    "pruning_params.target_sparsity=0.2",
]


def _snapshot(h) -> dict:
    s = h.state
    opt = s.optimizer.state_dict()["state"]
    return {
        "state": {k: v.detach().clone() for k, v in s.model.state_dict().items()},
        "masks": {p: m.clone() for p, m in s.masks.items()},
        "momentum": {i: st["momentum_buffer"].clone() for i, st in opt.items()},
        "step": s.step,
        "loader_epoch": h.loaders.train_loader.epoch,
    }


def _assert_same(got: dict, want: dict) -> None:
    assert got["step"] == want["step"] and got["loader_epoch"] == want["loader_epoch"]
    assert got["state"].keys() == want["state"].keys()
    for k, v in want["state"].items():  # params and BatchNorm statistics
        assert torch.equal(got["state"][k], v), k
    for p, m in want["masks"].items():
        assert torch.equal(got["masks"][p], m), p
    assert got["momentum"].keys() == want["momentum"].keys()
    for i, buf in want["momentum"].items():
        assert torch.equal(got["momentum"][i], buf), i


@pytest.fixture(scope="module")
def preempted_and_resumed(tmp_path_factory):
    """Run (a): two levels of ResNet-18 (cifar10_imp as shipped, cut to 16
    images, 3 epochs of 2 steps a level), with the slot saved every epoch.
    Right after its level-1, epoch-0 slot save, the experiment dir is
    copied as it stands, beside it: the dir a preemption at that point
    leaves. The copy is resumed at level 1 through ``resume_experiment``
    (the same ``base_dir``, which is part of the slot's config hash).
    Run once per session (``run_once``)."""
    return run_once(tmp_path_factory, "resume", _preempted_and_resumed)


def _preempted_and_resumed(base: Path) -> dict:
    out = {}

    class Uninterrupted(PruningHarness):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            save = self.ckpts.save_mid_level

            def save_then_copy(level, epoch, state, meta):
                save(level, epoch, state, meta)
                if (level, epoch) == (1, 0):
                    out["at_save"] = _snapshot(self)
                    out["meta"] = self.ckpts.peek_mid_level()
                    shutil.copytree(self.expt_dir, self.expt_dir + "_preempted")

            self.ckpts.save_mid_level = save_then_copy
            out["a"] = self

    over = RESNET_OVERRIDES + [f"experiment_params.base_dir={base}"]
    expt_a, _ = run(compose("cifar10_imp", over), device="cpu", harness_cls=Uninterrupted)
    out["end_a"] = _snapshot(out["a"])
    out["expt_a"] = Path(expt_a)

    class Resumed(PruningHarness):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            out["r"] = self

        def _enter_mid_level(self, level):
            entered = out["entered"] = super()._enter_mid_level(level)
            out["after_restore"] = _snapshot(self)
            return entered

    expt_b = out["expt_b"] = Path(expt_a + "_preempted")
    out["expt_r"], out["summaries"] = run(compose("cifar10_imp", over + [
        "experiment_params.resume_experiment=true",
        f"experiment_params.resume_experiment_stuff.resume_expt_name={expt_b.name}",
        "experiment_params.resume_experiment_stuff.resume_level=1"]),
        device="cpu", harness_cls=Resumed)
    out["end_r"] = _snapshot(out.pop("r"))
    out["cfg"] = out.pop("a").cfg  # the harnesses themselves stay here
    return out


def test_slot_header_at_the_preemption(preempted_and_resumed):
    meta = preempted_and_resumed["meta"]
    assert (meta["level"], meta["epoch"]) == (1, 0)
    assert meta["config_hash"] == config_fingerprint(preempted_and_resumed["cfg"])
    assert meta["train_loader_epoch"] == 4  # three epochs of level 0, one of level 1
    assert [r["epoch"] for r in meta["level_rows"]] == [0]
    json.dumps(meta)


def test_restore_is_the_saved_state_bit_for_bit(preempted_and_resumed):
    assert preempted_and_resumed["entered"][0] == 1  # re-entered at epoch 1
    _assert_same(preempted_and_resumed["after_restore"], preempted_and_resumed["at_save"])


def test_resumed_run_ends_as_the_uninterrupted_run(preempted_and_resumed):
    out = preempted_and_resumed
    assert Path(out["expt_r"]) == out["expt_b"]
    assert [s["level"] for s in out["summaries"]] == [1]
    _assert_same(out["end_r"], out["end_a"])
    assert out["end_r"]["step"] == 6


def _level_1_rows(expt: Path) -> list[dict]:
    with open(expt / "metrics" / "level_wise_metrics" / "level_1_metrics.csv", newline="") as f:
        return list(csv.DictReader(f))


def test_level_csv_lists_every_epoch_and_no_slot_is_left(preempted_and_resumed):
    out = preempted_and_resumed
    for expt in (out["expt_a"], out["expt_b"]):
        assert [int(r["epoch"]) for r in _level_1_rows(expt)] == [0, 1, 2], expt
        assert not (expt / "checkpoints" / "mid_level").exists(), expt
        assert not (expt / "checkpoints" / "mid_level_meta.json").exists(), expt
    keys = ("epoch", "train_loss", "test_loss", "test_acc", "max_test_acc")
    want = [{k: r[k] for k in keys} for r in _level_1_rows(out["expt_a"])]
    assert [{k: r[k] for k in keys} for r in _level_1_rows(out["expt_b"])] == want
    assert out["summaries"][0]["max_test_acc"] == max(float(r["test_acc"]) for r in want)
