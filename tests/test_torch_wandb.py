"""``experiment_params.use_wandb`` in the port (utils/wandb_logging.py): a
stub ``wandb`` module in ``sys.modules`` records ``init``, ``log`` and
``finish`` while the IMP driver and the cyclic driver run a DeiT-Tiny (12
blocks at 192, 5 tokens at 32 px) on synthetic data; with no ``wandb``
to import the run says so once and completes. Neither machine this
repo's tests run on has wandb."""

import csv
import sys
import types
from pathlib import Path

import pytest

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.config.schema import config_to_dict
from turboprune_tpu_torch.driver import run, run_cyclic

OVERRIDES = [
    "dataset_params.dataloader_type=synthetic",
    "model_params.model_name=deit_tiny_patch16_224",
    "dataset_params.total_batch_size=8",
    "dataset_params.synthetic_num_train=8",
    "dataset_params.synthetic_num_test=8",
    "experiment_params.epochs_per_level=2",
    "experiment_params.max_steps_per_epoch=1",
    "pruning_params.target_sparsity=0.2",
    "experiment_params.use_wandb=true",
    "experiment_params.wandb_project_name=sparse_deit",
]


class StubWandb(types.ModuleType):
    """Records every call; ``init`` returns a run that records ``log`` and
    ``finish``."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))
        stub = self

        class Run:
            def log(self, metrics):
                stub.calls.append(("log", dict(metrics)))

            def finish(self):
                stub.calls.append(("finish",))

        return Run()


def _csv_rows(expt_dir: str) -> list[dict]:
    rows = []
    for path in sorted((Path(expt_dir) / "metrics" / "level_wise_metrics").glob("level_*_metrics.csv")):
        with open(path, newline="") as f:
            rows += list(csv.DictReader(f))
    return rows


@pytest.mark.parametrize("driver", ["imp", "cyclic"])
def test_use_wandb_logs_every_epoch_row_and_finishes(tmp_path, monkeypatch, driver):
    stub = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    extra = ["cyclic_training.num_cycles=2"] if driver == "cyclic" else []
    cfg = compose("cifar10_imp", OVERRIDES + extra + [f"experiment_params.base_dir={tmp_path}"])
    expt_dir, summaries = (run_cyclic if driver == "cyclic" else run)(cfg, device="cpu")
    assert len(summaries) == 2
    kinds = [c[0] for c in stub.calls]
    assert kinds[0] == "init" and kinds[-1] == "finish"
    assert kinds.count("init") == 1 and kinds.count("finish") == 1
    init = stub.calls[0][1]
    assert init["project"] == "sparse_deit"
    assert init["dir"] == expt_dir
    assert init["name"] == Path(expt_dir).name.split("__")[0]
    assert init["config"] == config_to_dict(cfg)
    logged = [c[1] for c in stub.calls if c[0] == "log"]
    rows = _csv_rows(expt_dir)
    # One row an epoch: 2 levels x 2 epochs (cyclic: 2 cycles of 1 epoch).
    assert len(logged) == len(rows) == 4
    assert [(r["level"], r.get("cycle"), r["epoch"]) for r in logged] == [
        (int(r["level"]), int(r["cycle"]) if "cycle" in r else None, int(r["epoch"])) for r in rows]
    for got, want in zip(logged, rows):
        assert got["test_acc"] == pytest.approx(float(want["test_acc"]), rel=1e-12)
        assert got["train_loss"] == pytest.approx(float(want["train_loss"]), rel=1e-12)


def test_without_wandb_the_run_says_so_and_completes(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    cfg = compose("cifar10_imp", OVERRIDES + ["experiment_params.epochs_per_level=1",
                                              f"experiment_params.base_dir={tmp_path}"])
    expt_dir, summaries = run(cfg, device="cpu")
    assert len(summaries) == 2 and len(_csv_rows(expt_dir)) == 2
    out = capsys.readouterr().out
    assert out.count("[wandb] disabled (") == 1
