#!/usr/bin/env python
"""Pruning experiment CLI for the PyTorch/CUDA port (turboprune_tpu_torch).

Usage:
    python run_experiment_torch.py --config-name=imagenet_imp \
        model_params=mp_deit_small model_params.attention_impl=flash \
        dataset_params.dataloader_type=synthetic
    python run_experiment_torch.py --config-name=cifar10_imp      # ResNet-18, as shipped
    python run_experiment_torch.py --config-name=cifar10_er_snip \
        dataset_params.dataloader_type=synthetic
    python run_experiment_torch.py --device cpu --config-name=cifar10_imp ...

Same config groups and dotted overrides as run_experiment.py (composed from
conf/). The run goes on CUDA unless --device cpu is given; without CUDA,
--device cuda fails instead of falling back to the CPU. Attention with
model_params.attention_impl=flash runs the hand-written CUDA kernels
forward (K1) and backward (K2/K3).
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--config-name",
        required=True,
        help="top-level config under conf/ (e.g. imagenet_imp)",
    )
    parser.add_argument(
        "--config-path", default=None, help="alternate config root directory"
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="torch device to train on: cuda (default) or cpu",
    )
    parser.add_argument(
        "overrides",
        nargs="*",
        help="dotted overrides like optimizer_params.lr=0.05",
    )
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])

    from turboprune_tpu_torch.config.compose import compose
    from turboprune_tpu_torch.driver import run

    cfg = compose(args.config_name, args.overrides, args.config_path)
    expt_dir, summaries = run(cfg, device=args.device)
    print(f"\nExperiment complete: {expt_dir}")
    for s in summaries:
        print(
            f"  level {s['level']}: density {s['density']:.4f} "
            f"max_test_acc {s.get('max_test_acc', float('nan')):.2f}%"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
