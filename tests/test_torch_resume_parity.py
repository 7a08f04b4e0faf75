"""The pieces of resume that have an exact JAX counterpart, held against
the JAX package: the bit-packed mask bytes of every model checkpoint (and
the read of the raw-bool layout written before packing), the config
fingerprint that stamps the mid-level slot, and ``resume_experiment``'s
results and errors."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from turboprune_tpu.config.compose import compose as jax_compose
from turboprune_tpu.utils import checkpoint as jax_checkpoint
from turboprune_tpu.utils import experiment as jax_experiment
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.utils import (
    ExperimentCheckpoints,
    config_fingerprint,
    gen_expt_dir,
    pack_mask_tree,
    restore_model_tree,
    resume_experiment,
    unpack_mask_tree,
)

# ------------------------------------------------------------ packed masks


def seeded_masks(seed=0):
    """bool masks whose sizes are not multiples of 8, one of them 1-D."""
    rng = np.random.default_rng(seed)
    shapes = {"a/kernel": (3, 3, 5, 7), "b/kernel": (13,), "c/kernel": (9, 11)}
    return {p: rng.random(s) < 0.6 for p, s in shapes.items()}


def test_packed_bytes_equal_the_jax_package():
    masks = seeded_masks()
    got = pack_mask_tree({p: torch.from_numpy(m) for p, m in masks.items()})
    want = jax_checkpoint.pack_mask_tree(masks)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path]["bits"].dtype == torch.uint8
        assert got[path]["bits"].numpy().tobytes() == np.asarray(leaf["bits"]).tobytes(), path
        np.testing.assert_array_equal(got[path]["shape"].numpy(), leaf["shape"])
        assert got[path]["shape"].dtype == torch.int64
    back = unpack_mask_tree(got)
    for path, m in masks.items():
        assert back[path].dtype == torch.bool
        np.testing.assert_array_equal(back[path].numpy(), m)


def test_model_checkpoint_packs_masks_and_reads_the_raw_bool_layout(tmp_path):
    masks = {p: torch.from_numpy(m) for p, m in seeded_masks(1).items()}
    tree = {"params": {"w": torch.arange(6.0)}, "masks": masks,
            "batch_stats": {"mean": torch.ones(2)}}
    ckpts = ExperimentCheckpoints(tmp_path)
    ckpts.save_level(0, tree)
    on_disk = torch.load(ckpts.level_path(0) / "model.pt", weights_only=True)
    assert "masks" not in on_disk and on_disk["masks_packed"].keys() == masks.keys()
    # The layout the port wrote before packing: raw bool masks.
    legacy = tmp_path / "checkpoints" / "model_level_1"
    legacy.mkdir()
    torch.save(tree, legacy / "model.pt")
    for restored in (ckpts.load_level(0), restore_model_tree(legacy)):
        assert torch.equal(restored["params"]["w"], tree["params"]["w"])
        assert torch.equal(restored["batch_stats"]["mean"], tree["batch_stats"]["mean"])
        for path, m in masks.items():
            assert torch.equal(restored["masks"][path], m), path


# ------------------------------------------------------- config and resume

DEIT_OVERRIDES = ["model_params=mp_deit_small", "model_params.attention_impl=flash"]
RESUME_KNOBS = ["experiment_params.resume_experiment=true",
                "experiment_params.resume_experiment_stuff.resume_expt_name=some_dir",
                "experiment_params.resume_experiment_stuff.resume_level=3"]


@pytest.mark.parametrize(
    "name,overrides",
    [("cifar10_imp", []), ("imagenet_imp", DEIT_OVERRIDES), ("cifar10_imp", RESUME_KNOBS)],
    ids=["cifar10_imp", "imagenet_imp_deit", "cifar10_imp_resume_knobs"],
)
def test_config_fingerprint_equals_the_jax_package(name, overrides):
    got = config_fingerprint(compose(name, overrides))
    assert got == jax_experiment.config_fingerprint(jax_compose(name, overrides))
    assert len(got) == 16
    if overrides is RESUME_KNOBS:  # the resume knobs do not enter the hash
        assert got == config_fingerprint(compose(name, []))


def test_config_fingerprint_moves_with_a_training_knob():
    assert config_fingerprint(compose("cifar10_imp", [])) == "ff511ac0137ebffc"
    lr = ["optimizer_params.lr=0.1"]
    assert config_fingerprint(compose("cifar10_imp", lr)) != "ff511ac0137ebffc"
    assert (config_fingerprint(compose("cifar10_imp", lr))
            == jax_experiment.config_fingerprint(jax_compose("cifar10_imp", lr)))


def _resume_cfgs(base, name, level=2):
    over = [f"experiment_params.base_dir={base}", "experiment_params.resume_experiment=true",
            f"experiment_params.resume_experiment_stuff.resume_level={level}"]
    if name is not None:
        over.append(f"experiment_params.resume_experiment_stuff.resume_expt_name={name}")
    return compose("cifar10_imp", over), jax_compose("cifar10_imp", over)


def test_resume_experiment_finds_the_dir_as_the_jax_package(tmp_path):
    cfg = compose("cifar10_imp", [f"experiment_params.base_dir={tmp_path}"])
    prefix, expt_dir = gen_expt_dir(cfg)
    shutil.rmtree(Path(expt_dir) / "metrics")  # re-created by the resume
    port_cfg, jax_cfg = _resume_cfgs(tmp_path, Path(expt_dir).name)
    got = resume_experiment(port_cfg)
    assert got == (prefix, expt_dir, 2)
    assert got == jax_experiment.resume_experiment(jax_cfg)
    assert (Path(expt_dir) / "metrics" / "level_wise_metrics").is_dir()


@pytest.mark.parametrize("name,error", [("nope", FileNotFoundError), (None, ValueError)])
def test_resume_experiment_errors_as_the_jax_package(tmp_path, name, error):
    port_cfg, jax_cfg = _resume_cfgs(tmp_path, name)
    with pytest.raises(error):
        jax_experiment.resume_experiment(jax_cfg)
    with pytest.raises(error):
        resume_experiment(port_cfg)
