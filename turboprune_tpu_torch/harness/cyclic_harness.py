"""CyclicPruningHarness — the learning rate warms up again in every cycle
of a sparsity level (port of ``turboprune_tpu/harness/cyclic_harness.py``).

The same harness as ``PruningHarness`` except that ``train_one_level``
splits the level's epoch budget into ``cyclic_training.num_cycles`` cycles
(``pruning.generate_cyclical_schedule``, by ``cyclic_training.strategy``)
and gives each cycle a fresh optimizer and schedule (and, with sparse
execution, its own entry into and exit from the level's plan); its rows
carry a ``cycle`` column. It takes no ``profile_dir`` trace, as the JAX
package's cyclic harness takes none, and says so once when one is set.
"""

from __future__ import annotations

from ..config.schema import ConfigError
from ..ops import masking
from ..parallel import say
from ..pruning import generate_cyclical_schedule
from ..utils import MODEL_INIT, OPTIMIZER_INIT, display_training_info
from .pruning_harness import PruningHarness


class CyclicPruningHarness(PruningHarness):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.cfg.experiment_params.checkpoint_every_epochs:
            # The cyclic level loop has no mid-level re-entry: accepting the
            # knob would give no protection against preemption.
            raise ConfigError(
                "experiment_params.checkpoint_every_epochs > 0 is not "
                "supported with cyclic training — the cyclic loop cannot "
                "resume mid-level, so the setting would be a silent no-op. "
                "Set checkpoint_every_epochs=0 (level-granular resume still "
                "works)."
            )
        if self.cfg.experiment_params.profile_dir:
            say("[profile] experiment_params.profile_dir is set, but the cyclic "
                "harness takes no trace (as in the JAX package)")

    def train_one_level(self, epochs_per_level: int, level: int) -> dict:
        ct = self.cfg.cyclic_training
        cycle_epochs = generate_cyclical_schedule(epochs_per_level, ct.num_cycles, ct.strategy)
        density = masking.overall_density(self.state.masks)
        display_training_info(self.cfg, level, density)
        if level == 0:
            # Saved before any training, with a fresh optimizer, so they
            # hold the true starting state.
            self.setup_level(cycle_epochs[0])
            self.ckpts.save_model(MODEL_INIT, self.state.model_tree())
            self.ckpts.save_optimizer(OPTIMIZER_INIT, self.state.optimizer)

        max_test_acc = 0.0
        for cycle, epochs in enumerate(cycle_epochs):
            # Fresh optimizer and schedule: the lr warms up from the
            # schedule's start.
            self.setup_level(epochs)
            if cycle == 0:
                self.maybe_rewind_optimizer(level)
            # The fresh optimizer is over the full params, so the plan
            # enters and exits per cycle; cycles with equal budgets reuse
            # one cached plan bundle.
            self._enter_plan()
            try:
                for epoch in range(epochs):
                    row = {"level": level, "cycle": cycle, "epoch": epoch}
                    max_test_acc = self._run_epoch(row, max_test_acc,
                                                   snapshot_ok=level == 0 and cycle == 0)
            finally:
                self._exit_plan()

        return self.metrics.finish_level(
            level,
            {
                "density": density,
                "final_sparsity": masking.overall_sparsity(self.state.masks),
                "num_cycles": ct.num_cycles,
            },
        )
