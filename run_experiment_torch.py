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
    torchrun --nproc_per_node=8 run_experiment_torch.py --config-name=imagenet_imp

Under torchrun (or any launcher that sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT) the processes join one world, each on
cuda:LOCAL_RANK, and train one model data-parallel at the config's global
batch (turboprune_tpu_torch/parallel/); --dist-backend picks the
torch.distributed backend (default nccl on CUDA, gloo on the CPU; gloo
also lets several ranks share one card). Only rank 0 prints and writes.

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
        "--dist-backend",
        default=None,
        help="torch.distributed backend of a launched world (default: nccl on "
        "cuda, gloo on cpu)",
    )
    parser.add_argument(
        "overrides",
        nargs="*",
        help="dotted overrides like optimizer_params.lr=0.05",
    )
    return parser.parse_args(argv)


def in_world(args, body):
    """``body(device)`` inside the world the launcher made (joined before
    anything touches CUDA, left in a ``finally`` if this call joined it);
    a world of one without a launcher."""
    import torch.distributed as dist

    from turboprune_tpu_torch.parallel import (
        destroy_distributed,
        initialize_distributed,
        is_distributed,
        is_primary,
        process_count,
    )

    joined = not is_distributed()
    device = initialize_distributed(args.dist_backend, args.device)
    if is_distributed() and is_primary():
        print(f"[world] {process_count()} process(es) over {dist.get_backend()}, "
              f"rank 0 on {device}", flush=True)
    try:
        return body(device)
    finally:
        if joined:
            destroy_distributed()


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])

    def body(device):
        from turboprune_tpu_torch.config.compose import compose
        from turboprune_tpu_torch.driver import run
        from turboprune_tpu_torch.parallel import is_primary

        cfg = compose(args.config_name, args.overrides, args.config_path)
        expt_dir, summaries = run(cfg, device=device)
        if is_primary():
            print(f"\nExperiment complete: {expt_dir}")
            for s in summaries:
                print(
                    f"  level {s['level']}: density {s['density']:.4f} "
                    f"max_test_acc {s.get('max_test_acc', float('nan')):.2f}%"
                )
        return 0

    return in_world(args, body)


if __name__ == "__main__":
    sys.exit(main())
