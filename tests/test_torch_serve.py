"""The port's serving slice end to end on the CPU (turboprune_tpu_torch:
config -> experiment dir -> InferenceEngine -> HTTP server), precision
float32, against the JAX package's masked flash forward.

One module-scope experiment dir holds a DeiT-Tiny/16 at CIFAR's 32x32
(12 blocks, head_dim 64 as at full size) with seeded params in the JAX
param tree, carried over by the bridge: level 0 with all-ones masks,
level 1 with seeded random masks at density ~0.5 (tests/
test_torch_masking.py holds the magnitude masks to the JAX ones bit for
bit). Served logits must equal the JAX
``apply(apply_masks(params, masks))`` flash forward within atol 2e-5:
both sides compute in fp32 and differ only in summation order, over 12
blocks.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from turboprune_tpu.models.vit import deit_tiny_patch16_224 as jax_deit_tiny
from turboprune_tpu.ops import masking as jax_masking
from torch_port_fixtures import one_torch_thread, seeded_params  # noqa: F401 (autouse fixture)
from turboprune_tpu_torch import bridge
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.config.schema import ConfigError
from turboprune_tpu_torch.ops.flash import flash_fwd_cuda
from turboprune_tpu_torch.serve import InferenceEngine, ServeMetrics, build_server
from turboprune_tpu_torch.utils import ExperimentCheckpoints, save_config

BUCKETS = (1, 4, 8)
ATOL = 2e-5


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def expt(tmp_path_factory):
    expt_dir = tmp_path_factory.mktemp("torch_serve_expt")
    cfg = compose(
        "cifar10_imp",
        [
            "model_params=mp_deit_small",
            "model_params.model_name=deit_tiny_patch16_224",
            "model_params.attention_impl=flash",
            "experiment_params.training_precision=float32",
        ],
    )
    save_config(expt_dir, cfg)
    params = seeded_params(jax_deit_tiny(10, attention_impl="dense"))
    ones = jax_masking.make_masks(params)
    rng = np.random.default_rng(0)
    pruned = jax.tree.map(lambda m: rng.random(m.shape) < 0.5, ones)
    ckpts = ExperimentCheckpoints(expt_dir)
    for level, masks in ((0, ones), (1, pruned)):
        state, tmasks = bridge.params_from_flax(params, masks)
        ckpts.save_level(level, {"params": state, "masks": tmasks, "batch_stats": {}})
    ref_apply = jax.jit(jax_deit_tiny(10, attention_impl="flash").apply)
    folded = jax_masking.apply_masks(params, pruned)

    def reference(images):
        return np.asarray(ref_apply({"params": folded}, images))

    return {"dir": expt_dir, "reference": reference}


@pytest.fixture(scope="module")
def engine(expt):
    eng = InferenceEngine.from_experiment(
        expt["dir"], buckets=BUCKETS, metrics=ServeMetrics(), device="cpu"
    )
    eng.warmup()
    return eng


def test_served_logits_equal_the_jax_masked_flash_forward(expt, engine):
    assert engine.level == 1
    assert engine.density == pytest.approx(0.5, abs=0.01)
    x = _images(4, seed=1)
    np.testing.assert_allclose(
        engine.predict(x), expt["reference"](x), atol=ATOL, rtol=0
    )


def test_bucket_padding_never_changes_valid_rows(engine):
    x = _images(11, seed=2)  # 8 + 3 -> buckets 8 and 4 (one padded row)
    before = engine.metrics.counter("padded_rows_total")
    got = engine.predict(x)
    assert got.shape == (11, 10)
    assert engine.metrics.counter("padded_rows_total") == before + 1
    with torch.inference_mode():  # the same model on the unpadded batch
        unpadded = engine.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, unpadded, atol=1e-5, rtol=0)


def test_warmup_ran_every_bucket_once(engine):
    assert engine.warmed_buckets == BUCKETS
    assert engine.metrics.counter("bucket_first_runs_total") == len(BUCKETS)
    engine.predict(_images(2, seed=3))
    assert engine.metrics.counter("bucket_first_runs_total") == len(BUCKETS)
    assert engine.metrics.counter("bucket_warm_runs_total") >= 1


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip_returns_what_the_engine_returns(expt, engine):
    cfg = compose("serve", ["serve.port=0", "serve.batch_buckets=[1,4,8]"])
    server = build_server(cfg, expt_dir=str(expt["dir"]), device="cpu")
    try:
        server.start_background()
        base = f"http://127.0.0.1:{server.port}"
        x = _images(3, seed=4)
        code, body = _post(f"{base}/predict", {"instances": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(
            np.asarray(body["logits"], np.float32), engine.predict(x),
            atol=1e-6, rtol=0,
        )
        assert body["classes"] == np.argmax(body["logits"], -1).tolist()
        assert body["model_level"] == 1
        assert _post(f"{base}/predict", {"wrong": 1})[0] == 400
        assert _post(f"{base}/predict", {"instances": [[1.0, 2.0]]})[0] == 400
        assert _post(f"{base}/predict", {"instances": "abc"})[0] == 400
        assert _post(
            f"{base}/predict", {"instances": x[:1].tolist(), "model": "level_0"}
        )[0] == 404
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["device"] == "cpu" and health["warmed_buckets"] == [1, 4, 8]
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
            text = resp.read().decode()
        assert "turboprune_serve_requests_total" in text
    finally:
        report = server.graceful_shutdown(drain_timeout_s=5)
    assert report == {"drained": True, "unanswered": 0}


def test_role_checkpoint_is_served_by_role(expt):
    params = seeded_params(jax_deit_tiny(10, attention_impl="dense"), seed=5)
    state, masks = bridge.params_from_flax(params, jax_masking.make_masks(params))
    ExperimentCheckpoints(expt["dir"]).save_model(
        "model_init", {"params": state, "masks": masks, "batch_stats": {}}
    )
    eng = InferenceEngine.from_experiment(
        expt["dir"], role="model_init", buckets=(2,), device="cpu"
    )
    assert eng.level is None and eng.density == 1.0
    assert eng.source.endswith("model_init")
    assert eng.predict(_images(1, seed=6)).shape == (1, 10)


def test_unported_paths_raise(expt):
    fleet = compose("serve", ["serve=fleet"])
    with pytest.raises(ConfigError, match="fleet"):
        build_server(fleet, expt_dir=str(expt["dir"]), device="cpu")
    for kw in ({"backend": "compact"}, {"compact": True}, {"backend": "nm"}):
        with pytest.raises(NotImplementedError, match="sparse-execution slice"):
            InferenceEngine.from_experiment(expt["dir"], device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown serving backend"):
        InferenceEngine.from_experiment(expt["dir"], device="cpu", backend="x")


def test_cuda_without_a_card_raises_instead_of_running_on_the_cpu(expt):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without")
    before = flash_fwd_cuda.launches
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.from_experiment(expt["dir"])  # device defaults to cuda
    cfg = compose("serve", ["serve.port=0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_server(cfg, expt_dir=str(expt["dir"]))
    assert flash_fwd_cuda.launches == before
