"""torchlint — static analysis of the PyTorch/CUDA port, and its runtime
mirrors (the counterpart of the JAX package's ``turboprune_tpu.analysis``).

``python -m turboprune_tpu_torch.analysis [paths]`` runs nine per-file
rules tuned to the failure modes of a torch training and serving stack:
host syncs in compiled regions and declared hot loops, ``torch.compile``
built where its cache cannot help, custom ops without a matching fake,
draws from the global generator, rank-conditional collectives, CUDA-graph
outputs read after the next replay, silent broad excepts, debug output in
compiled code, and raw override dicts used as cache keys.

``--project`` adds the symbol table and call graph (project.py,
callgraph.py, interproc.py: the rules fire through call chains, each
finding carrying its call path), the five thread rules (locks.py,
threads.py, concurrency_rules.py) and the six ``conf-*`` rules over
``conf/**/*.yaml`` against the port's schema (conf_rules.py). The runtime
modes mirror the static layer: ``--sanitize`` (graftsan, sanitizer.py),
``--exec-manifest`` and ``--compile-audit`` (exec_manifest.py,
compile_audit.py).

Findings are waived inline with ``# torchlint: disable=<rule> -- reason``
(YAML comments included); the JAX package's ``graftlint:`` waivers are not
read here. The port is kept at zero unwaived findings by
tests/test_torch_analysis.py's self-gate.

Deliberately torch-free at import: the package imports on any machine;
only the runtime modes import torch. It imports nothing of
``turboprune_tpu``: the framework-free modules are copies. Importing
``rules`` registers the rule set as a side effect.
"""

from .core import (  # noqa: F401
    AnalysisResult,
    Finding,
    ModuleContext,
    RULES,
    Rule,
    Waiver,
    analyze_files,
    analyze_paths,
    analyze_project,
    analyze_source,
    is_test_file,
    register,
)
from . import rules  # noqa: F401  (registers the rule set)
from . import concurrency_rules  # noqa: F401  (registers the thread rules)
from .conf_rules import CONF_RULES  # noqa: F401
from .reporters import render_json, render_sarif, render_text  # noqa: F401

__all__ = [
    "AnalysisResult",
    "CONF_RULES",
    "Finding",
    "ModuleContext",
    "RULES",
    "Rule",
    "Waiver",
    "analyze_files",
    "analyze_paths",
    "analyze_project",
    "analyze_source",
    "is_test_file",
    "register",
    "render_json",
    "render_sarif",
    "render_text",
]
