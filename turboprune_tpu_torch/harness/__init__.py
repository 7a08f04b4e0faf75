"""Training harnesses (port of ``turboprune_tpu/harness``): the standard
level loop and the cyclic one."""

from .cyclic_harness import CyclicPruningHarness
from .pruning_harness import PruningHarness

__all__ = ["CyclicPruningHarness", "PruningHarness"]
