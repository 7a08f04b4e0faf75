"""The port's copy of the config schema and composer
(turboprune_tpu_torch/config) against turboprune_tpu/config: every
top-level config under conf/ composes to the same dict, and the same bad
overrides fail."""

from pathlib import Path

import pytest

from turboprune_tpu.config import schema as jax_schema
from turboprune_tpu.config.compose import compose as jax_compose
from turboprune_tpu_torch.config import schema as torch_schema
from turboprune_tpu_torch.config.compose import compose as torch_compose

CONF = Path(__file__).resolve().parents[1] / "conf"
TOP = sorted(p.stem for p in CONF.glob("*.yaml"))


@pytest.mark.parametrize("name", TOP)
def test_every_conf_composes_identically(name):
    want = jax_schema.config_to_dict(jax_compose(name))
    got = torch_schema.config_to_dict(torch_compose(name))
    assert got == want


@pytest.mark.parametrize(
    "name,overrides",
    [
        ("imagenet_er_balanced",
         ["model_params=mp_deit_small", "model_params.attention_impl=flash"]),
        ("cifar10_imp", ["pruning_params=iterative_wr", "+serve=default"]),
        ("serve", ["serve=fleet"]),
        ("serve", ["serve.port=0", "serve.batch_buckets=[1,4,8]"]),
    ],
)
def test_overrides_compose_identically(name, overrides):
    want = jax_schema.config_to_dict(jax_compose(name, overrides))
    got = torch_schema.config_to_dict(torch_compose(name, overrides))
    assert got == want


@pytest.mark.parametrize(
    "overrides,match",
    [
        (["model_params.attention_impl=bogus"], "attention_impl"),
        (["model_params.attention_impl=flash"], "deit"),
        (["experiment_params.training_precision=fp8"], "training_precision"),
        (["dataset_params.no_such_knob=1"], "unknown config keys"),
        (["pruning_params=iterative_wr", "pruning_params.rewind_epoch=500"],
         "rewind_epoch"),
    ],
)
def test_same_validation_errors(overrides, match):
    with pytest.raises(jax_schema.ConfigError, match=match):
        jax_compose("cifar10_imp", overrides)
    with pytest.raises(torch_schema.ConfigError, match=match):
        torch_compose("cifar10_imp", overrides)
