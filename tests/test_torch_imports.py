"""The port stands alone: no module of turboprune_tpu_torch, nor
chip_smoke.py, ablate_flash_fwd.py, card_cpu_noise.py, run_server_torch.py,
run_experiment_torch.py, run_cyclic_training_experiment_torch.py,
scripts/replay_committed_runs_torch.py or the data-parallel
tests' worker (tests/torch_port_dp_worker.py) imports JAX, flax, optax, orbax, grain or the JAX package
(not even its jax-free modules). Checked on the AST, so a lazy import
inside a function counts too."""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grain", "turboprune_tpu")
FILES = sorted((REPO / "turboprune_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py",
    REPO / "ablate_flash_fwd.py",
    REPO / "card_cpu_noise.py",
    REPO / "run_server_torch.py",
    REPO / "run_experiment_torch.py",
    REPO / "run_cyclic_training_experiment_torch.py",
    REPO / "tests" / "torch_port_dp_worker.py",
    REPO / "scripts" / "replay_committed_runs_torch.py",
]


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_the_check_sees_imports():
    probe = REPO / "tests" / "test_torch_imports.py"
    assert {"ast", "pathlib", "pytest"} <= imported_roots(probe)


def test_the_hard_task_script_calls_only_the_port():
    """scripts/accuracy_runs_r5_torch.sh runs the port's entry points and
    the replay script's check, never the JAX package's drivers."""
    text = (REPO / "scripts" / "accuracy_runs_r5_torch.sh").read_text()
    called = set(re.findall(r"[\w/]+\.py\b", text))
    assert called == {"run_experiment_torch.py", "run_cyclic_training_experiment_torch.py",
                      "scripts/replay_committed_runs_torch.py"}, called
