"""The port's sparse serving backends, compiled buckets and fleet serving
(turboprune_tpu_torch/serve: engine backends, one compiled forward per
bucket, DynamicBatcher replicas, MetricsHub, ModelRegistry,
AOTExecutableCache, FleetEngine, the fleet's HTTP routing) on the CPU.

One module-scope experiment dir holds a depth-2 DeiT (embed 32, 2 heads,
CIFAR's 32x32, flash attention, float32; ``deit_tiny_patch16_224`` mapped
to that size in both registries for the module) with seeded params in the
JAX param tree, carried over by the bridge, at three levels whose masks
make the planner pick each backend under ``backend="auto"``: level 0 dense
(masked), level 1 with half of each block's MLP hidden units dead and
their fc1 biases zero (compact), level 2 N:M 2:4-projected (nm). Each
level's served logits, through a fleet of replicas 2 on the CPU's
``aot_eager`` compile (bucket 4; buckets (1, 4) elsewhere), must equal the
JAX model's ``apply`` under ``jax.jit`` on the mask-folded params within
1e-5 x max |logit| (fp32 on both sides; compaction and the N:M gather
change the summation order only), and the plan kind and every decision
must equal the JAX planner's for the same masks.

The rest is the port alone: the pinned backends, the compile-once buckets,
padding, two replica threads sharing one engine, LRU paging with metrics
that survive it, dynamo's per-code-object recompile limit over a fleet's
page cycles, the persistent cache's contract, the Prometheus text of the
MetricsHub and the registry's ids against the JAX package's, and HTTP
routing. Every wait is bounded.
"""

import gc
import json
import urllib.error
import urllib.request
import weakref
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_port_fixtures import IMAGE, TINY, jax_deit, jax_masks, seeded_params
from turboprune_tpu import sparse as jsparse
from turboprune_tpu.ops import masking as jmasking
from turboprune_tpu.serve import metrics as jmetrics
from turboprune_tpu.serve.fleet import registry as jregistry
from turboprune_tpu_torch import bridge, models, sparse
from turboprune_tpu_torch.config.compose import compose
from turboprune_tpu_torch.models import vit
from turboprune_tpu_torch.serve import (
    DynamicBatcher,
    FleetEngine,
    InferenceEngine,
    InferenceServer,
    MetricsHub,
    ModelRegistry,
    ServeMetrics,
    UnknownModelError,
    build_server,
    open_cache,
)
from turboprune_tpu_torch.serve.fleet import aot_cache
from turboprune_tpu_torch.sparse import CompactionError
from turboprune_tpu_torch.utils import ExperimentCheckpoints, save_config

BUCKETS = (1, 4)
REL = 1e-5  # of the largest |logit|: fp32 on both sides
KINDS = {"level_0": "masked", "level_1": "compact", "level_2": "nm"}
WAIT_S = 60.0


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, IMAGE, IMAGE, 3)).astype(np.float32)


def _assert_logits_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)


@pytest.fixture(scope="module", autouse=True)
def tiny_deit():
    """``deit_tiny_patch16_224`` built at the tiny size for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(models.MODEL_REGISTRY, "deit_tiny_patch16_224",
                   vit._deit(TINY["embed_dim"], TINY["depth"], TINY["num_heads"]))
        yield


def _level_masks(params):
    """(params, masks) of the three levels: dense; half of each block's MLP
    hidden units dead, with their fc1 biases zeroed in a copy of the params;
    2:4-projected from seeded random masks."""
    ones = jax.tree.map(lambda m: None if m is None else np.ones(m.shape, bool),
                        jmasking.make_masks(params), is_leaf=lambda x: x is None)
    dead = jax.tree.map(lambda m: None if m is None else m.copy(), ones,
                        is_leaf=lambda x: x is None)
    dead_params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(4)
    for i in range(TINY["depth"]):
        kernel = dead[f"block{i}"]["mlp"]["fc1"]["kernel"]
        units = rng.permutation(kernel.shape[1])[: kernel.shape[1] // 2]
        kernel[:, units] = False
        dead_params[f"block{i}"]["mlp"]["fc1"]["bias"][units] = 0.0
    # The port's projection (held to the JAX one in test_torch_nm.py), which
    # runs in a fraction of the JAX one's time on the CPU.
    state, scattered = bridge.params_from_flax(params, jax_masks(params, seed=9))
    projected = sparse.project_masks(state, scattered, 2, 4)[0]
    nm = bridge.params_to_flax(state, projected, TINY["num_heads"])[1]
    return [(params, ones), (dead_params, dead), (params, nm)]


@pytest.fixture(scope="module")
def expt(tmp_path_factory):
    expt_dir = tmp_path_factory.mktemp("torch_fleet_expt")
    cfg = compose("cifar10_imp", [
        "model_params=mp_deit_small",
        "model_params.model_name=deit_tiny_patch16_224",
        "model_params.attention_impl=flash",
        "experiment_params.training_precision=float32",
    ])
    save_config(expt_dir, cfg)
    params = seeded_params(jax_deit("dense"))
    levels = _level_masks(params)
    ckpts = ExperimentCheckpoints(expt_dir)
    for level, (p, masks) in enumerate(levels):
        state, tmasks = bridge.params_from_flax(p, masks)
        ckpts.save_level(level, {"params": state, "masks": tmasks, "batch_stats": {}})
    jmodel = jax_deit("flash")
    apply = jax.jit(jmodel.apply)
    x = _images(4, seed=1)
    reference = {
        f"level_{lvl}": np.asarray(apply({"params": jmasking.apply_masks(p, m)}, x))
        for lvl, (p, m) in enumerate(levels)
    }
    plans = {
        f"level_{lvl}": jsparse.plan_execution(
            jmodel, p, m, {}, compact="auto", nm="auto", compact_min_savings=0.0,
            nm_min_axis_savings=cfg.planner.nm_min_axis_savings, autotune="off")
        for lvl, (p, m) in enumerate(levels)
    }
    return {"dir": expt_dir, "images": x, "reference": reference, "plans": plans}


@pytest.fixture(scope="module")
def fleet(expt, tmp_path_factory):
    eng = FleetEngine(
        ModelRegistry([expt["dir"]]),
        buckets=(4,),
        max_resident_models=3,
        replicas=2,
        aot_cache=open_cache(tmp_path_factory.mktemp("torch_fleet_aot")),
        max_batch=4,
        max_wait_ms=2.0,
        device="cpu",
    )
    yield eng
    eng.close()


# ------------------------------------------------------ parity with JAX


@pytest.mark.parametrize("model_id", sorted(KINDS))
def test_fleet_serves_each_level_as_the_jax_forward_and_plan(expt, fleet, model_id):
    got = fleet.predict(expt["images"], model=model_id, timeout=WAIT_S)
    _assert_logits_close(got, expt["reference"][model_id])
    want = expt["plans"][model_id]
    info = fleet.info()["models"][model_id]
    assert info["backend"] == info["plan"]["kind"] == want.kind == KINDS[model_id]
    assert info["plan"]["decisions"] == want.decisions
    assert info["replicas"] == 1  # one CPU: two lanes share one engine
    if model_id == "level_1":
        assert info["compaction"]["params_after"] < info["compaction"]["params_before"]
    if model_id == "level_2":
        assert info["nm"]["routed_layers"] == len(want.nm.overrides) > 0


@pytest.mark.parametrize("backend,level,kind", [
    ("masked", 1, "masked"), ("compact", 1, "compact"), ("mixed", 1, "compact"),
    ("nm", 2, "nm"), ("auto", 2, "nm"),
])
def test_pinned_backends_match_the_jax_forward(expt, backend, level, kind):
    """Each backend's planned model, called eagerly (the compiled buckets
    are held to the same reference through the fleet above)."""
    eng = InferenceEngine.from_experiment(expt["dir"], level=level, buckets=(4,),
                                          backend=backend, device="cpu")
    try:
        assert eng.backend == kind
        with torch.no_grad():
            got = eng.model(torch.from_numpy(expt["images"])).numpy()
        _assert_logits_close(got, expt["reference"][f"level_{level}"])
    finally:
        eng.close()


def test_nm_degrades_to_masked_where_nothing_routes(expt):
    eng = InferenceEngine.from_experiment(expt["dir"], level=1, buckets=(4,),
                                          backend="nm", device="cpu")
    assert eng.backend == "masked" and eng.nm_plan_report is None
    assert all(d["backend"] == "dense" for d in eng.info()["plan"]["decisions"]["layers"].values())
    eng.close()


class _NoGraph(torch.nn.Module):
    """A model the compaction graph does not know."""

    num_classes = 10

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(IMAGE * IMAGE * 3, 10)

    def forward(self, x):
        return self.fc(x.flatten(1))


def test_compact_raises_where_there_is_no_compaction_graph():
    model = _NoGraph()
    masks = {"fc/kernel": torch.ones_like(model.fc.weight, dtype=torch.bool)}
    with pytest.raises(CompactionError, match="no propagation graph"):
        InferenceEngine(model, model.state_dict(), masks, input_shape=(IMAGE, IMAGE, 3),
                        backend="compact", device="cpu")
    with pytest.raises(ValueError, match="unknown serving backend"):
        InferenceEngine(model, model.state_dict(), masks, input_shape=(IMAGE, IMAGE, 3),
                        backend="x", device="cpu")


# ------------------------------------------------------ compiled buckets


@pytest.fixture(scope="module")
def engine(expt, tmp_path_factory):
    """Level 1 under ``auto`` (compact), both buckets warmed, with a
    persistent cache."""
    cache = aot_cache.AOTExecutableCache(tmp_path_factory.mktemp("torch_engine_aot"))
    eng = InferenceEngine.from_experiment(expt["dir"], level=1, buckets=BUCKETS,
                                          metrics=ServeMetrics(), aot_cache=cache,
                                          backend="auto", device="cpu")
    eng.warmup()
    yield eng
    eng.close()


def test_buckets_compile_once_then_only_hit(engine):
    m = engine.metrics
    assert engine.compiled_buckets == BUCKETS
    assert m.counter("compile_cache_misses_total") == m.counter("compiles_total") == 2
    hits = m.counter("compile_cache_hits_total")
    for n in (1, 3, 4, 6):
        engine.predict(_images(n, seed=n))
    engine.warmup()
    assert m.counter("compile_cache_misses_total") == m.counter("compiles_total") == 2
    assert m.counter("compile_cache_hits_total") == hits + 7  # 1 + 1 + 1 + 2 chunks, warmup 2


def test_engine_counts_its_cache_lookups(engine):
    """One lookup per bucket's graph, keyed with the plan; on the CPU the
    aot_eager compile leaves no inductor artifact to store."""
    assert engine.metrics.counter("aot_cache_miss_total") == 2
    meta = engine.aot_cache.key_meta()
    assert sorted(v["bucket"] for v in meta.values()) == list(BUCKETS)
    assert {v["plan_kind"] for v in meta.values()} == {"compact"}


def test_closed_engine_raises(expt):
    eng = InferenceEngine.from_experiment(expt["dir"], level=0, buckets=(4,), device="cpu")
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.predict(_images(1, seed=0))


def test_padding_never_changes_a_valid_row(engine):
    x = _images(7, seed=3)  # 4 + 3: one padded row
    got = engine.predict(x)
    alone = np.concatenate([engine.predict(row) for row in x])
    with torch.no_grad():
        eager = engine.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, alone, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-5)


def test_two_replica_threads_share_one_engine(engine):
    batcher = DynamicBatcher(engine, replicas=2, max_batch=4, max_wait_ms=1.0).start()
    try:
        xs = [_images(1 + i % 3, seed=10 + i) for i in range(24)]
        want = [engine.predict(x) for x in xs]
        with ThreadPoolExecutor(max_workers=6) as pool:
            futures = list(pool.map(batcher.submit, xs))
        for f, w in zip(futures, want):
            np.testing.assert_allclose(f.result(timeout=WAIT_S), w, rtol=0, atol=1e-5)
        assert batcher.bucket_sizes() == list(BUCKETS)
    finally:
        batcher.close()
    assert batcher.outstanding == 0


# ------------------------------------------------------ fleet paging


def test_lru_paging_past_dynamos_recompile_limit(expt):
    """3 models x 2 buckets paged in and out twice under an LRU budget of
    one: 12 compiles of the same block forward (more than dynamo's 8
    guard sets per code object, had they shared one) raise nothing; every
    eviction frees its model; a model paged in again serves its logits;
    its metrics survive the cycles."""
    assert 3 * len(BUCKETS) * 2 > torch._dynamo.config.recompile_limit
    fleet = FleetEngine(ModelRegistry([expt["dir"]]), buckets=BUCKETS, max_resident_models=1,
                        device="cpu")
    try:
        for _ in range(2):
            for model_id in sorted(KINDS):
                got = fleet.predict(expt["images"], model=model_id, timeout=WAIT_S)
                fleet.predict(_images(1, seed=0), model=model_id, timeout=WAIT_S)
                assert fleet.resident_ids == [model_id]
                if model_id == "level_0":
                    weights = weakref.ref(fleet._residents[model_id].engine.model)
                if model_id == "level_1":  # level_0 was evicted
                    gc.collect()
                    assert weights() is None, "an evicted model's weights are still referenced"
            _assert_logits_close(got, expt["reference"]["level_2"])
        assert fleet.metrics.counter("model_pageins_total") == 6
        assert fleet.metrics.counter("model_evictions_total") == 5
        assert sum(fleet.hub.counter("compile_cache_misses_total", m) for m in KINDS) == 12
        assert fleet.hub.counter("requests_total", "level_0") == 4
        assert 'model="level_0"' in fleet.hub.render_prometheus()
    finally:
        fleet.close()


# ------------------------------------------------------ persistent cache


def test_cache_miss_store_hit(tmp_path):
    cache = aot_cache.AOTExecutableCache(tmp_path)
    cpu = torch.device("cpu")
    key = cache.make_key(graph_fingerprint="g", plan_signature=("masked",), bucket=4)
    assert cache.load(key, cpu) == (None, "miss")
    cache.store(key, b"\x00artifact bytes\xff", cpu)
    assert cache.load(key, cpu) == (b"\x00artifact bytes\xff", "hit")
    stats = cache.stats()
    assert (stats["miss"], stats["hit"], stats["stores"], stats["entries"]) == (1, 1, 1, 1)
    assert cache.key_meta()[key] == {"plan_kind": "masked", "bucket": 4}


def test_cache_changed_environment_bypasses_then_overwrites(tmp_path, monkeypatch):
    cache = aot_cache.AOTExecutableCache(tmp_path)
    cpu = torch.device("cpu")
    key = cache.make_key(graph_fingerprint="g", bucket=1)
    real = aot_cache._env_meta
    monkeypatch.setattr(aot_cache, "_env_meta", lambda d: {**real(d), "torch": "0.0"})
    cache.store(key, b"old", cpu)
    monkeypatch.setattr(aot_cache, "_env_meta", real)
    assert cache.load(key, cpu) == (None, "bypass")
    cache.store(key, b"new", cpu)
    assert cache.load(key, cpu) == (b"new", "hit")


@pytest.mark.parametrize("damage", ["truncate", "garbage"])
def test_cache_corrupt_entry_is_quarantined(tmp_path, damage):
    cache = aot_cache.AOTExecutableCache(tmp_path)
    cpu = torch.device("cpu")
    key = cache.make_key(graph_fingerprint="g", bucket=1)
    cache.store(key, b"payload" * 10, cpu)
    path = cache._path(key)
    blob = path.read_bytes()
    path.write_bytes(blob[:-5] if damage == "truncate" else b"not an entry")
    assert cache.load(key, cpu) == (None, "corrupt")
    stats = cache.stats()
    assert (stats["entries"], stats["quarantined"], stats["corrupt"]) == (0, 1, 1)
    assert cache.load(key, cpu) == (None, "miss")


def test_cache_key_covers_graph_plan_and_bucket(tmp_path):
    cache = aot_cache.AOTExecutableCache(tmp_path)
    keys = {
        cache.make_key(graph_fingerprint=g, plan_signature=p, bucket=b)
        for g in ("g1", "g2") for p in (("masked",), ("compact", (("a", 3),))) for b in (1, 8)
    }
    assert len(keys) == 8
    assert open_cache("") is None and open_cache(None) is None
    assert isinstance(open_cache(tmp_path / "c"), aot_cache.AOTExecutableCache)


# ------------------------------------------------------ metrics and registry


def _metrics_calls(hub_cls):
    hub = hub_cls()
    fleet_level = hub.get("")
    fleet_level.inc("routed_requests_total", 3)
    fleet_level.set_gauge("resident_models", 2)
    for i, model in enumerate(("level_0", 'lev"el\\1\n')):
        m = hub.get(model)
        m.compile_miss()
        m.compile_hit()
        m.inc("padded_rows_total", 3 + i)
        m.set_gauge("model_level", i)
        m.record_plan({"backend_counts": {"nm_layers": i, "dense_layers": 2, "compact_spaces": 1},
                       "coverage_frac": 0.25 * i,
                       "compaction": {"params_before": 100, "params_after": 60 + i,
                                      "channels_before": 8, "channels_after": 5}})
        for ms in (0.5, 3.0, 7.25, 120.0 + i, 4000.0):
            m.observe_latency_ms(ms)
        m.observe_batch(4 + i)
    return hub


def test_metrics_hub_renders_the_jax_text_byte_for_byte():
    got, want = _metrics_calls(MetricsHub), _metrics_calls(jmetrics.MetricsHub)
    assert got.render_prometheus() == want.render_prometheus()
    assert got.get("level_0").render_prometheus() == want.get("level_0").render_prometheus()
    assert got.snapshot() == want.snapshot()


def _expt_dir(root, levels):
    """An experiment dir's layout as the registry scans it."""
    (root / "checkpoints").mkdir(parents=True)
    (root / "expt_config.yaml").write_text("{}\n")
    for lvl in levels:
        (root / "checkpoints" / f"model_level_{lvl}").mkdir()
    return root


@pytest.mark.parametrize("names", [("expt_a",), ("expt_a", "expt_b")])
def test_registry_ids_and_routes_equal_the_jax_registry(tmp_path, names):
    dirs = [_expt_dir(tmp_path / name, levels) for name, levels in zip(names, ((0, 1, 3), (0, 2)))]
    got, want = ModelRegistry(dirs), jregistry.ModelRegistry(dirs)
    assert got.ids() == want.ids()
    for route in ("latest", "dense"):
        assert got.default_id(route) == want.default_id(route)
    pinned = want.ids()[1]
    assert got.resolve(None, default_route="pinned", pinned_model=pinned).model_id == pinned
    with pytest.raises(UnknownModelError) as err:
        got.get("level_9")
    with pytest.raises(jregistry.UnknownModelError) as jerr:
        want.get("level_9")
    assert str(err.value) == str(jerr.value)
    twin = _expt_dir(tmp_path / "elsewhere" / names[0], (0,))
    with pytest.raises(ValueError, match="duplicate model id"):
        ModelRegistry([dirs[0], twin])


# ------------------------------------------------------------------- HTTP


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as resp:
        return resp.read().decode()


def test_fleet_server_routes_on_the_model_field(expt):
    cfg = compose("serve", ["serve=fleet", "serve.port=0", "serve.batch_buckets=[4]",
                            "serve.warmup=false", f"serve.fleet.expt_dirs=[{expt['dir']}]"])
    server = build_server(cfg, device="cpu")
    try:
        server.start_background()
        base = f"http://127.0.0.1:{server.port}"
        x = expt["images"][:2]
        for model_id in ("level_1", "level_2"):
            code, body = _post(f"{base}/predict", {"instances": x.tolist(), "model": model_id})
            assert code == 200 and body["model"] == model_id and body["backend"] == KINDS[model_id]
            _assert_logits_close(np.asarray(body["logits"], np.float32),
                                 expt["reference"][model_id][:2])
        code, body = _post(f"{base}/predict", {"instances": x.tolist()})
        assert code == 200 and body["model"] == "level_2"  # default route: latest
        code, body = _post(f"{base}/predict", {"instances": x.tolist(), "model": "level_7"})
        assert code == 404 and "level_0" in body["error"] and "level_2" in body["error"]
        health = json.loads(_get(f"{base}/healthz"))
        assert health["status"] == "ok" and sorted(health["models"]) == sorted(KINDS)
        assert not health["models"]["level_0"]["resident"]
        assert health["models"]["level_1"]["backend"] == "compact"
        text = _get(f"{base}/metrics")
        assert 'turboprune_serve_requests_total{model="level_2"} 2' in text
        assert 'turboprune_serve_requests_total{model="level_1"} 1' in text
        assert text.count("# TYPE turboprune_serve_requests_total counter") == 1
    finally:
        report = server.graceful_shutdown(drain_timeout_s=5)
    assert all(r == {"drained": True, "unanswered": 0} for r in report.values())


class _StubEngine:
    input_shape = (IMAGE, IMAGE, 3)
    buckets = (1,)
    level = 3
    density = 0.5
    metrics = None

    def predict(self, x):
        return np.zeros((x.shape[0], 10), np.float32)


def test_single_server_rejects_model_routing():
    server = InferenceServer(_StubEngine(), port=0)
    try:
        server.start_background()
        base = f"http://127.0.0.1:{server.port}"
        one = _images(1, seed=0).tolist()
        code, body = _post(f"{base}/predict", {"instances": one, "model": "level_0"})
        assert code == 404 and "single model" in body["error"]
        assert _post(f"{base}/predict", {"instances": one})[0] == 200
    finally:
        server.graceful_shutdown(drain_timeout_s=5)
    with pytest.raises(ValueError, match="exactly one"):
        InferenceServer(port=0)


def test_fleet_page_in_from_many_threads_builds_each_model_once(expt):
    fleet = FleetEngine(ModelRegistry([expt["dir"]]), buckets=(1,), max_resident_models=3,
                        device="cpu")
    try:
        with ThreadPoolExecutor(max_workers=6) as pool:
            futures = [pool.submit(fleet.predict, _images(1, seed=i), "level_0", WAIT_S)
                       for i in range(6)]
            for f in futures:
                assert f.result(timeout=WAIT_S).shape == (1, 10)
        assert fleet.metrics.counter("model_pageins_total") == 1
        assert fleet.hub.counter("compile_cache_misses_total", "level_0") == 1
    finally:
        fleet.close()
