"""torchlint's runtime modes on the CPU: graftsan over the port's
PrefetchEngine and FleetEngine, and the compile audit over dynamo.

graftsan drives ``pipeline`` and ``fleet`` with no lock-order cycle and no
race, and a planted cycle fails the CLI. The compile audit exits 0 on its
clean drive (the serving warm-up and the train step, ``aot_eager`` on the
CPU) and 1 on a planted graph break (a ``print`` in a compiled function),
a planted recompile (a compiled step called at a second batch size) and a
bucket outside the manifest's set. The planted code lives in files
written at test time."""

from __future__ import annotations

import textwrap

import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from turboprune_tpu_torch.analysis import sanitizer
from turboprune_tpu_torch.analysis.cli import main as cli_main
from turboprune_tpu_torch.analysis.compile_audit import run_compile_audit
from turboprune_tpu_torch.analysis.pytest_plugin import graftsan  # noqa: F401 (the port's fixture)

CPU = torch.device("cpu")


# ------------------------------------------------------------------ graftsan


@pytest.mark.parametrize("drive", ["pipeline", "fleet"])
def test_graftsan_drives_the_port_without_cycles(graftsan, drive):  # noqa: F811
    {"pipeline": sanitizer._drive_pipeline, "fleet": sanitizer._drive_fleet}[drive](graftsan, CPU)
    assert graftsan.lock_count > 0
    assert graftsan.order_edges() or drive == "pipeline"
    assert not graftsan.races()


CYCLE = """
    import threading

    def build():
        a, b = threading.Lock(), threading.Lock()

        def run():
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass

        return run
"""


def test_planted_lock_order_cycle_fails(tmp_path, monkeypatch, capsys):
    path = tmp_path / "cycle.py"
    path.write_text(textwrap.dedent(CYCLE))
    monkeypatch.setattr(sanitizer, "_PKG_ROOT", str(tmp_path))
    monkeypatch.setattr(sanitizer, "_static_keys", lambda: set())
    assert cli_main(["--sanitize", f"{path}:build", "--device", "cpu"]) == 1
    assert "LOCK-ORDER CYCLE" in capsys.readouterr().out


# ------------------------------------------------------------- compile audit


def test_compile_audit_clean_on_the_cpu(capsys):
    assert run_compile_audit("all", device="cpu") == 0
    out = capsys.readouterr().out
    assert "0 graph break(s), 0 recompile(s), 0 problem(s) — clean" in out
    assert "[entry train_forward]" in out and out.count("[entry region]") == 2


PLANTED = """
    import torch

    from turboprune_tpu_torch.models.vit import VisionTransformer
    from turboprune_tpu_torch.ops.masking import make_masks
    from turboprune_tpu_torch.serve.engine import InferenceEngine
    from turboprune_tpu_torch.train.steps import compile_forward, eval_forward


    def _tiny():
        model = VisionTransformer(num_classes=10, patch_size=16, embed_dim=32, depth=1,
                                  num_heads=2, image_size=32)
        return model.init_weights(torch.Generator().manual_seed(0))


    def graph_break(device):
        def f(x):
            print("a graph break")
            return x * 2

        compiled = torch.compile(f, backend="aot_eager")
        return lambda: compiled(torch.ones(3))


    def recompile(device):
        model = _tiny().to(device)
        masks = make_masks(model)
        forward = compile_forward(eval_forward, device)
        gen = torch.Generator().manual_seed(1)
        batches = [(torch.randn(n, 32, 32, 3, generator=gen), torch.zeros(n, dtype=torch.long))
                   for n in (2, 3)]

        def run():
            for images, labels in batches:
                forward(model, masks, images, labels)

        return run


    def bucket(device):
        model = _tiny()
        engine = InferenceEngine(model, model.state_dict(), make_masks(model),
                                 input_shape=(32, 32, 3), buckets=(3,), device=device)

        def run():
            engine.warmup()
            return {"plan": engine._plan_signature[0], "buckets": engine.compiled_buckets}

        return run
"""


@pytest.mark.parametrize("builder, says, not_says", [
    ("graph_break", "graph break x1", None),
    ("recompile", "recompiled 1x (manifest allows 0)", "in no manifest entry"),
    ("bucket", "bucket=3) is outside", "in no manifest entry"),
])
def test_compile_audit_fails_on_planted_faults(tmp_path, capsys, builder, says, not_says):
    path = tmp_path / "planted.py"
    path.write_text(textwrap.dedent(PLANTED))
    assert cli_main(["--compile-audit", f"{path}:{builder}", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert says in out and "NOT clean" in out
    if not_says:
        assert not_says not in out


# ------------------------------------------- one ledger per compiled model


def _tiny_vit_step(depth: int):
    """A masked train step of a tiny ViT of ``depth`` blocks: ``step(forward,
    n)`` runs one forward and backward at batch ``n`` through ``forward``
    (``compile_forward(train_forward, cpu)``)."""
    from turboprune_tpu_torch.models.vit import VisionTransformer
    from turboprune_tpu_torch.ops.masking import make_masks

    model = VisionTransformer(num_classes=10, patch_size=16, embed_dim=32, depth=depth,
                              num_heads=2, image_size=32)
    model.init_weights(torch.Generator().manual_seed(depth))
    masks = make_masks(model)
    gen = torch.Generator().manual_seed(10 + depth)

    def step(forward, n: int) -> None:
        images = torch.randn(n, 32, 32, 3, generator=gen)
        labels = torch.randint(0, 10, (n,), generator=gen)
        forward(model, masks, images, labels)["loss"].backward()

    return step


def test_a_ledger_per_model_after_a_reset_is_clean_and_a_recompile_fails():
    """``chip_smoke.py``'s compile phase: two models through the shared
    compiled train step, each in a ledger of its own, begun after a dynamo
    reset. Each holds one compile and no problem: the second model's first
    compile is not a guard failure on the first's entry for the same code
    object. A step at another batch inside a model's ledger is a
    steady-state recompile, and ``problems()`` names it."""
    from turboprune_tpu_torch.analysis.compile_audit import CompileLedger
    from turboprune_tpu_torch.analysis.exec_manifest import load_manifest
    from turboprune_tpu_torch.train.steps import compile_forward, train_forward

    manifest = load_manifest()
    ledgers, runs = [], []
    for depth in (1, 2):
        torch._dynamo.reset()
        step, forward = _tiny_vit_step(depth), compile_forward(train_forward, CPU)
        with CompileLedger() as ledger:
            step(forward, 2)
            step(forward, 2)
        ledgers.append(ledger)
        runs.append((step, forward))
    assert [len(ledger.records) for ledger in ledgers] == [1, 1]
    assert [ledger.recompiles() for ledger in ledgers] == [[], []]
    assert [ledger.problems(manifest) for ledger in ledgers] == [[], []]

    step, forward = runs[1]
    with ledgers[1]:
        step(forward, 3)
    (problem,) = ledgers[1].problems(manifest)
    assert problem.startswith("train_forward (turboprune_tpu_torch/train/steps.py:")
    assert "recompiled 1x (manifest allows 0)" in problem and "size mismatch" in problem
