"""torchlint (turboprune_tpu_torch.analysis), its static half, on the CPU.

1. Every torch rule catches its bad snippet and stays silent on its good
   twin, and its JAX twin — the same failure mode written for JAX — is
   caught by the JAX package's rule of that failure mode.
2. The framework-free rules give the JAX package's findings (rule, line,
   message) on the same inputs: ``broad-except``, the five thread rules,
   the six ``conf-*`` rules; waivers parse alike (each tool reads only its
   own tag); the JSON and SARIF reports have one shape.
3. The CLI's exit codes, the README catalog, the checked-in executable
   manifest, and the self-gate: the port, ``conf/``, the port's tests and
   scripts at zero unwaived findings and no stale waiver.

Every planted bad snippet lives in a string, so neither tool's gate sees
it as code.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from turboprune_tpu import analysis as jax_analysis
from turboprune_tpu.analysis import reporters as jax_reporters
from turboprune_tpu.analysis.core import parse_waivers as jax_parse_waivers
from turboprune_tpu_torch import analysis as torch_analysis
from turboprune_tpu_torch.analysis import CONF_RULES, RULES, analyze_project, analyze_source
from turboprune_tpu_torch.analysis import reporters
from turboprune_tpu_torch.analysis.cli import main as cli_main
from turboprune_tpu_torch.analysis.core import parse_waivers

REPO = Path(__file__).resolve().parents[1]


def run(src: str, path="lib/snippet.py", tool=torch_analysis, select=None) -> list:
    """Unwaived findings for a dedented snippet."""
    findings, _ = tool.analyze_source(textwrap.dedent(src), path, select=select)
    return [f for f in findings if not f.waived]


def write_tree(root: Path, files: dict) -> Path:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def triples(findings) -> list:
    return sorted((Path(f.file).name, f.line, f.rule, f.message) for f in findings)


# --------------------------------------------------------------- fixtures
# torch rule -> (bad snippet it must catch, good twin it must not)
FIXTURES = {
    "compiled-host-sync": (
        """
        import torch

        @torch.compile(fullgraph=True)
        def step(x, w):
            loss = (x @ w).sum()
            return loss.item()
        """,
        """
        import torch

        @torch.compile(fullgraph=True)
        def step(x, w):
            return (x @ w).sum()

        def epoch(x, w):
            return step(x, w).item()
        """,
    ),
    "recompile-hazard": (
        """
        import torch

        def run(fns, x):
            outs = []
            for f in fns:
                outs.append(torch.compile(f)(x))
            return outs
        """,
        """
        import torch

        _CACHE = {}

        def run(fns, x):
            outs = []
            for f in fns:
                if f not in _CACHE:
                    _CACHE[f] = torch.compile(f)
                outs.append(_CACHE[f](x))
            return outs
        """,
    ),
    "custom-op-fake-mismatch": (
        """
        import torch

        @torch.library.custom_op("demo::scale", mutates_args=())
        def scale(x: torch.Tensor, alpha: float) -> torch.Tensor:
            return x * alpha

        @scale.register_fake
        def _(x, factor):
            return torch.empty_like(x)
        """,
        """
        import torch

        @torch.library.custom_op("demo::scale", mutates_args=())
        def scale(x: torch.Tensor, alpha: float) -> torch.Tensor:
            return x * alpha

        @scale.register_fake
        def _(x, alpha):
            return torch.empty_like(x)
        """,
    ),
    "implicit-global-rng": (
        """
        import torch

        def noise(shape):
            return torch.randn(shape)
        """,
        """
        import torch

        def noise(shape, generator):
            return torch.randn(shape, generator=generator)
        """,
    ),
    "collective-order": (
        """
        import torch.distributed as dist
        from .parallel import is_primary

        def save(t):
            if is_primary():
                dist.all_reduce(t)
        """,
        """
        import torch.distributed as dist
        from .parallel import is_primary

        def save(t, write):
            dist.all_reduce(t)
            if is_primary():
                write(t)
        """,
    ),
    "cudagraph-output-reuse": (
        """
        import torch

        def run(fn, xs):
            step = torch.compile(fn, mode="reduce-overhead")
            first = step(xs[0])
            second = step(xs[1])
            return first + second
        """,
        """
        import torch

        def run(fn, xs):
            step = torch.compile(fn, mode="reduce-overhead")
            first = step(xs[0]).clone()
            second = step(xs[1])
            return first + second
        """,
    ),
    "broad-except": (
        """
        def load(path):
            try:
                return open(path).read()
            except Exception:
                return None
        """,
        """
        import logging

        def load(path):
            try:
                return open(path).read()
            except Exception:
                logging.exception("load failed: %s", path)
                return None
        """,
    ),
    "debug-in-compiled-region": (
        """
        import torch

        @torch.compile
        def step(x):
            print(x.shape)
            return x * 2
        """,
        """
        import torch

        @torch.compile
        def step(x):
            return x * 2

        def run(x):
            print(x.shape)
            return step(x)
        """,
    ),
    "unhashable-width-overrides": (
        """
        def small_model(cache, plan, build):
            if plan.width_overrides not in cache:
                cache[plan.width_overrides] = build(plan.width_overrides)
            return cache[plan.width_overrides]
        """,
        """
        def small_model(cache, plan, build):
            key = plan.as_override_tuple()
            if key not in cache:
                cache[key] = build(plan.width_overrides)
            return cache[key]
        """,
    ),
}

# torch rule -> (JAX rule of the same failure mode, its bad JAX snippet)
JAX_TWINS = {
    "compiled-host-sync": ("jit-host-sync", """
        import jax

        @jax.jit
        def step(x, w):
            loss = (x @ w).sum()
            return loss.item()
        """),
    "recompile-hazard": ("retrace-hazard", """
        import jax

        def run(fns, x):
            outs = []
            for f in fns:
                outs.append(jax.jit(f)(x))
            return outs
        """),
    "custom-op-fake-mismatch": ("static-argnames-mismatch", """
        from functools import partial
        import jax

        @partial(jax.jit, static_argnames=("factor",))
        def scale(x, alpha):
            return x * alpha
        """),
    "implicit-global-rng": ("rng-key-reuse", """
        import jax

        def noise(shape):
            return jax.random.normal(jax.random.PRNGKey(0), shape)
        """),
    "collective-order": ("collective-order", """
        import jax
        from jax.experimental import multihost_utils

        def save(t):
            if jax.process_index() == 0:
                multihost_utils.sync_global_devices("save")
        """),
    "cudagraph-output-reuse": ("donated-arg-reuse", """
        import jax

        def run(fn, state, batch):
            step = jax.jit(fn, donate_argnums=(0,))
            new = step(state, batch)
            return new, state.sum()
        """),
    "broad-except": ("broad-except", FIXTURES["broad-except"][0]),
    "debug-in-compiled-region": ("debug-in-hot-path", """
        import jax

        @jax.jit
        def step(x):
            print(x.shape)
            return x * 2
        """),
    "unhashable-width-overrides": ("unhashable-width-overrides", """
        def small_model(Model):
            return Model(width_overrides={"conv0": 8})
        """),
}


class TestRuleFixtures:
    def test_every_torch_rule_has_fixtures_and_a_jax_twin(self):
        per_file = {rid for rid, r in RULES.items() if not r.project_only}
        assert set(FIXTURES) == per_file - {"cv-wait-no-predicate-loop"}
        assert set(JAX_TWINS) == set(FIXTURES)

    @pytest.mark.parametrize("rule_id", sorted(FIXTURES))
    def test_bad_snippet_caught(self, rule_id):
        hits = [f for f in run(FIXTURES[rule_id][0]) if f.rule == rule_id]
        assert hits, f"{rule_id} missed its bad snippet"
        for f in hits:
            assert f.line >= 1 and f.message and f.severity in ("error", "warning")

    @pytest.mark.parametrize("rule_id", sorted(FIXTURES))
    def test_good_twin_silent(self, rule_id):
        hits = [f for f in run(FIXTURES[rule_id][1]) if f.rule == rule_id]
        assert not hits, [f.message for f in hits]

    @pytest.mark.parametrize("rule_id", sorted(JAX_TWINS))
    def test_jax_twin_caught_by_the_jax_rule(self, rule_id):
        jax_rule, bad = JAX_TWINS[rule_id]
        assert jax_rule in jax_analysis.RULES
        assert [f for f in run(bad, tool=jax_analysis) if f.rule == jax_rule]


class TestRuleEdges:
    @pytest.mark.parametrize("src", [
        "@torch.compile\ndef f(x):\n    return float(x) * 2\n",
        "@torch.compile\ndef f(x):\n    if x.sum() > 0:\n        return x\n    return -x\n",
        "@torch.compile\ndef f(x):\n    torch.cuda.synchronize()\n    return x\n",
        "def f(g, fn, x):\n    with torch.cuda.graph(g):\n        y = fn(x).cpu()\n    return y\n",
        "@op.register_fake\ndef _(x):\n    return x.new_empty(int(x.sum()))\n",
        "def loop(step, loader):\n    for batch in loader:  # torchlint: hot-loop\n"
        "        out = step(batch)\n        print(out['loss'].item())\n",
    ], ids=["float", "truth", "synchronize", "capture", "fake", "hot-loop"])
    def test_host_sync_in_every_region_kind(self, src):
        assert "compiled-host-sync" in {f.rule for f in run("import torch\n" + src)}

    @pytest.mark.parametrize("src", [
        "@torch.compile\ndef f(x, n: int):\n    return x * float(n)\n",
        "@torch.compile\ndef f(x):\n    if x.shape[0] > 2:\n        return x\n    return -x\n",
        "@torch.compile\ndef f(x, mask=None):\n    if mask is None:\n        return x\n    return x * mask\n",
        "def loop(step, loader):\n    for batch in loader:\n        print(step(batch)['loss'].item())\n",
    ], ids=["static-param", "shape", "is-none", "undeclared-loop"])
    def test_host_sync_silent_on_host_values(self, src):
        assert "compiled-host-sync" not in {f.rule for f in run("import torch\n" + src)}

    def test_custom_op_without_fake(self):
        src = """
        import torch

        @torch.library.custom_op("demo::twice", mutates_args=())
        def twice(x: torch.Tensor) -> torch.Tensor:
            return x * 2
        """
        (f,) = [f for f in run(src) if f.rule == "custom-op-fake-mismatch"]
        assert "no register_fake" in f.message

    def test_constant_reseed_in_a_loop(self):
        bad = "def f(g, n, draw):\n    for i in range(n):\n        g.manual_seed(0)\n        draw(g)\n"
        good = "def f(g, n, draw):\n    for i in range(n):\n        g.manual_seed(i)\n        draw(g)\n"
        assert "implicit-global-rng" in {f.rule for f in run(bad)}
        assert "implicit-global-rng" not in {f.rule for f in run(good)}

    def test_dynamo_reset_in_package_code(self):
        src = "import torch\n\ndef fresh():\n    torch._dynamo.reset()\n"
        assert "recompile-hazard" in {f.rule for f in run(src)}
        assert not run(src, path="tests/test_x.py")

    def test_graph_replay_output_held_across_replays(self):
        src = """
        import torch

        def serve(fn, x, n):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = fn(x)
            g.replay()
            held = y
            g.replay()
            return held.sum()
        """
        assert "cudagraph-output-reuse" in {f.rule for f in run(src)}

    def test_rank_variable_branch(self):
        src = "import torch.distributed as dist\n\ndef f(t, rank):\n    if rank == 0:\n        dist.barrier()\n"
        assert "collective-order" in {f.rule for f in run(src)}


# ------------------------------------------------- the JAX package's findings


BROAD_EXCEPT_INPUTS = [
    FIXTURES["broad-except"][0],
    FIXTURES["broad-except"][1],
    """
    def f(x):
        try:
            return x()
        except:
            pass
        try:
            return x()
        except (ValueError, BaseException):
            return 0
        try:
            return x()
        except Exception:
            raise
    """,
]


@pytest.mark.parametrize("src", BROAD_EXCEPT_INPUTS, ids=["bad", "good", "mixed"])
def test_broad_except_matches_jax(src):
    ours = run(src, select=["broad-except"])
    theirs = run(src, tool=jax_analysis, select=["broad-except"])
    assert triples(ours) == triples(theirs)
    assert ours or src is FIXTURES["broad-except"][1]


THREAD_FIXTURES = {
    "unsynchronized-shared-mutation": """
        import threading

        class Worker:
            def __init__(self):
                self.count = 0
                self._t = threading.Thread(target=self._run, daemon=True)
                self._t.start()

            def _run(self):
                self.count += 1

            def reset(self):
                self.count = 0
        """,
    "lock-order-inversion": """
        import threading

        class Pair:
            def __init__(self):
                self.a = threading.Lock()
                self.b = threading.Lock()

            def one(self):
                with self.a:
                    with self.b:
                        pass

            def two(self):
                with self.b:
                    with self.a:
                        pass
        """,
    "blocking-call-under-lock": """
        import threading
        import time

        class Slow:
            def __init__(self):
                self._lock = threading.Lock()

            def tick(self):
                with self._lock:
                    time.sleep(1.0)
        """,
    "check-then-act-race": """
        import threading

        class Cache:
            def __init__(self):
                self.d = {}
                threading.Thread(target=self.fill, daemon=True).start()

            def fill(self):
                self.get("k")

            def get(self, k):
                if k not in self.d:
                    self.d[k] = object()
                return self.d[k]
        """,
    "cv-wait-no-predicate-loop": """
        import threading

        class Box:
            def __init__(self):
                self.cv = threading.Condition()
                self.ready = False

            def take(self):
                with self.cv:
                    if not self.ready:
                        self.cv.wait()
        """,
}


@pytest.mark.parametrize("rule_id", sorted(THREAD_FIXTURES))
def test_thread_rules_match_jax(tmp_path, rule_id):
    root = write_tree(tmp_path / "proj", {"pkg/__init__.py": "",
                                          "pkg/mod.py": THREAD_FIXTURES[rule_id]})
    ours = [f for f in analyze_project([root], jobs=1).findings if f.rule in THREAD_FIXTURES]
    theirs = [f for f in jax_analysis.analyze_project([root], jobs=1).findings
              if f.rule in THREAD_FIXTURES]
    assert rule_id in {f.rule for f in ours}
    assert triples(ours) == triples(theirs)
    assert [f.trace for f in ours] == [f.trace for f in theirs]


SCHEMA = """
    from dataclasses import dataclass, field

    METHODS = ("mag", "snip")


    class ConfigError(ValueError):
        pass


    def _check_choice(name, value, choices):
        if value not in choices:
            raise ConfigError(name)


    @dataclass
    class TrainConfig:
        lr: float = 0.1
        steps: int = 10
        method: str = "mag"
        resume: bool = False
        tag: str = ""

        def validate(self):
            _check_choice("train.method", self.method, METHODS)


    @dataclass
    class MainConfig:
        train: TrainConfig = field(default_factory=TrainConfig)
"""
# Reads every field but ``tag``: conf-dead-schema-field fires once.
CONSUMER = """
    def use(cfg):
        t = cfg.train
        return (t.lr, t.steps, t.method, t.resume)
"""
CONF_TREES = {
    "bad": {
        "conf/top.yaml": "defaults:\n  - _self_\n  - train: nope\n  - evals: x\n",
        "conf/train/a.yaml": "lrr: 0.5\nmethod: bogus\nsteps: plenty\nresume: maybe\n"
                             "lr: [1]\nlr: 0.2\n",
    },
    "good": {
        "conf/top.yaml": "defaults:\n  - _self_\n  - train: a\n",
        "conf/train/a.yaml": 'lr: 5e-4\nsteps: "5"\nresume: "true"\nmethod: snip\ntag: x\n',
    },
}


@pytest.mark.parametrize("tree", sorted(CONF_TREES))
def test_conf_rules_match_jax(tmp_path, tree):
    files = {"pkg/__init__.py": "", "pkg/schema.py": SCHEMA, "pkg/consumer.py": CONSUMER,
             **CONF_TREES[tree]}
    root = write_tree(tmp_path / "proj", files)
    ours = [f for f in analyze_project([root], jobs=1).findings if f.rule in CONF_RULES]
    theirs = [f for f in jax_analysis.analyze_project([root], jobs=1).findings
              if f.rule in jax_analysis.CONF_RULES]
    assert set(CONF_RULES) == set(jax_analysis.CONF_RULES)
    assert triples(ours) == triples(theirs)
    fired = {f.rule for f in ours}
    if tree == "bad":
        assert fired == set(CONF_RULES)
    else:
        assert fired == {"conf-dead-schema-field"}


WAIVED = """
def load(path):
    try:
        return open(path).read()
    # TAG: disable=broad-except,conf-unknown-key -- the caller reports it
    except Exception:
        return None
x = 1  # TAG: disable=broad-except
"""


def test_waivers_parse_alike_and_only_their_own_tag():
    ours = parse_waivers(WAIVED.replace("TAG", "torchlint"), "f.py")
    theirs = jax_parse_waivers(WAIVED.replace("TAG", "graftlint"), "f.py")
    assert [w.as_dict() for w in ours] == [w.as_dict() for w in theirs]
    assert [w.applies_to for w in ours] == [6, 8]
    # neither tool reads the other's waivers, nor calls them stale
    assert parse_waivers(WAIVED.replace("TAG", "graftlint"), "f.py") == []
    assert jax_parse_waivers(WAIVED.replace("TAG", "torchlint"), "f.py") == []
    findings, waivers = analyze_source(WAIVED.replace("TAG", "graftlint"), "lib/f.py")
    assert [f.waived for f in findings] == [False] and waivers == []
    findings, waivers = analyze_source(WAIVED.replace("TAG", "torchlint"), "lib/f.py")
    assert [f.waiver_reason for f in findings] == ["the caller reports it"]
    assert [w.used for w in waivers] == [True, False]


def test_reports_have_the_jax_shape(tmp_path):
    bad = write_tree(tmp_path, {"bad.py": FIXTURES["broad-except"][0]}) / "bad.py"
    ours = torch_analysis.analyze_paths([bad])
    theirs = jax_analysis.analyze_paths([bad])
    a, b = json.loads(reporters.render_json(ours)), json.loads(jax_reporters.render_json(theirs))
    assert a == b
    sa = json.loads(reporters.render_sarif(ours))
    sb = json.loads(jax_reporters.render_sarif(theirs))
    assert sa["runs"][0]["tool"]["driver"].pop("name") == "torchlint"
    assert sb["runs"][0]["tool"]["driver"].pop("name") == "graftlint"
    assert sa == sb
    assert reporters.render_text(ours).replace("torchlint", "graftlint") == \
        jax_reporters.render_text(theirs)


# ----------------------------------------------------- CLI, docs, manifest


def test_cli_exit_codes(tmp_path, capsys):
    root = write_tree(tmp_path, {"bad.py": FIXTURES["broad-except"][0],
                                 "good.py": FIXTURES["broad-except"][1]})
    assert cli_main([str(root / "bad.py")]) == 1
    assert "broad-except" in capsys.readouterr().out
    assert cli_main([str(root / "good.py")]) == 0
    assert cli_main(["--list-rules"]) == 0
    assert "compiled-host-sync" in capsys.readouterr().out
    assert cli_main(["--select", "no-such-rule", str(root / "good.py")]) == 2
    assert cli_main([str(root / "missing.py")]) == 2
    assert cli_main(["--project", "--exec-manifest"]) == 2
    capsys.readouterr()


def test_runtime_modes_default_to_cuda_and_refuse_without_it(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device would run")
    assert cli_main(["--compile-audit"]) == 2
    assert cli_main(["--sanitize", "fleet"]) == 2
    assert cli_main(["--compile-audit", "nosuch", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.count("CUDA is not available") == 2 and "unknown --compile-audit target" in err


def test_package_imports_without_torch():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'torch' or name.startswith('torch.'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import turboprune_tpu_torch.analysis as a\n"
        "from turboprune_tpu_torch.analysis import cli, compile_audit, sanitizer, exec_manifest\n"
        "assert 'torch' not in sys.modules\n"
        "print(len(a.RULES))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    assert int(out.stdout) == len(RULES)


README_BEGIN = "<!-- torchlint-catalog:begin"
README_END = "<!-- torchlint-catalog:end -->"


def test_readme_torch_rule_catalog_is_generated():
    text = (REPO / "README.md").read_text(encoding="utf-8")
    begin = text.index("\n", text.index(README_BEGIN)) + 1
    end = text.index(README_END)
    assert text[begin:end] == reporters.render_rule_docs()
    for rid in list(RULES) + list(CONF_RULES):
        assert RULES.get(rid, CONF_RULES.get(rid)).doc_why, rid
    # the JAX package's catalog is still the first rule-docs block
    assert text.index("rule-docs:begin") < text.index(README_BEGIN)


def test_exec_manifest_diff_is_clean(capsys):
    assert cli_main(["--exec-manifest"]) == 0, capsys.readouterr().out
    manifest = json.loads((REPO / "turboprune_tpu_torch/analysis/exec_manifest.json").read_text())
    sites = {(s["file"], s["target"]) for s in manifest["compile_sites"]}
    assert ("turboprune_tpu_torch/train/steps.py", "fn") in sites
    assert ("turboprune_tpu_torch/serve/engine.py", "region") in sites
    assert {e["name"] for e in manifest["entries"]} >= {"train_forward", "eval_forward", "region"}
    assert [c["file"] for c in manifest["captures"]] == ["turboprune_tpu_torch/serve/engine.py"]
    assert sorted(o["op"] for o in manifest["custom_ops"] if o["fake"]) == [
        f"turboprune_tpu_torch::{n}" for n in ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd")]
    assert set(manifest["plan_kinds"]) == {"masked", "compact", "nm", "mixed"}


# ------------------------------------------------------------- self-gate

GATE_PATHS = (
    [REPO / "turboprune_tpu_torch", REPO / "conf", REPO / "chip_smoke.py"]
    + sorted((REPO / "tests").glob("test_torch_*.py"))
    + sorted((REPO / "tests").glob("torch_port_*.py"))
    + sorted(REPO.glob("run_*_torch.py"))
    + sorted((REPO / "scripts").glob("*_torch.py"))
)


class TestSelfGate:
    """The port, its conf, its tests and scripts, in project mode."""

    @pytest.fixture(scope="class")
    def result(self):
        return analyze_project(GATE_PATHS, jobs=1)

    def test_zero_unwaived_findings(self, result):
        msg = "\n".join(
            f"  {f.file}:{f.line}: [{f.rule}] {f.message}"
            + (f"\n    call path: {' -> '.join(f.trace)}" if f.trace else "")
            for f in result.unwaived)
        assert not result.unwaived, "torchlint --project found unwaived findings:\n" + msg

    def test_no_stale_waivers(self, result):
        stale = [f"{w.file}:{w.line}: {sorted(w.rules)}" for w in result.unused_waivers]
        assert not stale, "waivers matching no finding:\n" + "\n".join(stale)

    def test_every_waiver_names_a_known_rule_and_a_reason(self, result):
        known = set(RULES) | set(CONF_RULES)
        for w in result.waivers:
            assert w.rules <= known and w.reason, (w.file, w.line)
