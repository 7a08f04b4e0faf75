"""Training harness (port of ``turboprune_tpu/harness``). The cyclic
harness is a later slice (ROADMAP.md queue A, item 11)."""

from .pruning_harness import PruningHarness

__all__ = ["PruningHarness"]
