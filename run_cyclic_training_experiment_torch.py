#!/usr/bin/env python
"""Cyclic-training pruning experiment CLI for the PyTorch/CUDA port
(turboprune_tpu_torch).

Usage:
    python run_cyclic_training_experiment_torch.py --config-name=cifar10_imp \
        cyclic_training=ct_constant_4
    python run_cyclic_training_experiment_torch.py --device cpu ...

The same arguments as run_experiment_torch.py; each sparsity level trains
in cyclic_training.num_cycles cycles, the learning-rate schedule warming
up again in every cycle (cyclic_training.strategy splits the epoch
budget). The run goes on CUDA unless --device cpu is given; without CUDA,
--device cuda fails instead of falling back to the CPU.
"""

from __future__ import annotations

import sys

from run_experiment_torch import parse_args


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])

    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.driver import run_cyclic

    cfg = compose(args.config_name, args.overrides, args.config_path)
    expt_dir, summaries = run_cyclic(cfg, device=args.device)
    print(f"\nCyclic experiment complete: {expt_dir}")
    for s in summaries:
        print(
            f"  level {s['level']}: density {s['density']:.4f} "
            f"cycles {s['num_cycles']} max_test_acc {s.get('max_test_acc', float('nan')):.2f}%"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
