#!/bin/bash
# The hard-task accuracy curves of scripts/accuracy_runs_r5.sh, through
# turboprune_tpu_torch on the GPU: the same overrides (grating mixture at
# SNR 1.5, 8192 / 2048 synthetic images, batch 256, target sparsity 0.95,
# ResNet-18) for imp, wr (rewind to epoch 2), lrr and cyclic imp (4 cycles
# a level), each through the port's entry points. After each run,
# scripts/replay_committed_runs_torch.py --check holds it to finite losses
# and to k + t zeros at every level (k from the ladder, t the weights tied
# at the prune's threshold).
#
# Usage: bash scripts/accuracy_runs_r5_torch.sh [epochs_per_level] [imp|wr|lrr|cyclic|all] [override ...]
# Overrides after the run type are added to every run (a small CPU rehearsal:
# DEVICE=cpu ... 1 imp dataset_params.synthetic_num_train=16 ...). Runs go
# under $ACCURACY_BASE_DIR/<type>/ (default build/accuracy_r5_torch); with
# ACCURACY_KEEP_DIR set, each checked run's config and metric CSVs are copied
# to $ACCURACY_KEEP_DIR/<run dir name>/. DEVICE=cpu runs them on the CPU.
set -euo pipefail
cd "$(dirname "$0")/.."
EPL="${1:-15}"
WHICH="${2:-all}"
shift $(( $# < 2 ? $# : 2 ))
EXTRA=("$@")
BASE="${ACCURACY_BASE_DIR:-build/accuracy_r5_torch}"
DEVICE="${DEVICE:-cuda}"

COMMON=(
  dataset_params.dataloader_type=synthetic
  dataset_params.synthetic_task=hard
  dataset_params.synthetic_snr=1.5
  dataset_params.synthetic_num_train=8192
  dataset_params.synthetic_num_test=2048
  dataset_params.total_batch_size=256
  "experiment_params.epochs_per_level=$EPL"
  pruning_params.target_sparsity=0.95
  model_params.model_name=resnet18
)

run() {  # run <type> <entry point> <overrides...>
  local kind="$1" entry="$2"
  shift 2
  local dir="$BASE/$kind"
  mkdir -p "$dir"
  echo "=== $kind ==="
  local t0
  t0=$(date +%s.%N)
  python3 "$entry" --device "$DEVICE" --config-name=cifar10_imp "${COMMON[@]}" \
      "experiment_params.base_dir=$dir" "$@" ${EXTRA[@]+"${EXTRA[@]}"}
  awk -v k="$kind" -v e="$entry" -v a="$t0" -v b="$(date +%s.%N)" \
      'BEGIN { printf "=== %s: %s took %.1f s ===\n", k, e, b - a }'
  python3 scripts/replay_committed_runs_torch.py --check "$(ls -td "$dir"/*/ | head -n 1)" \
      ${ACCURACY_KEEP_DIR:+--keep "$ACCURACY_KEEP_DIR"}
}

case "$WHICH" in
  all) KINDS=(imp wr lrr cyclic) ;;
  imp|wr|lrr|cyclic) KINDS=("$WHICH") ;;
  *) echo "unknown run type '$WHICH' (imp, wr, lrr, cyclic or all)" >&2; exit 2 ;;
esac

for kind in "${KINDS[@]}"; do
  case "$kind" in
    imp) run imp run_experiment_torch.py pruning_params.training_type=imp ;;
    wr) run wr run_experiment_torch.py pruning_params.training_type=wr \
        pruning_params.rewind_epoch=2 ;;
    lrr) run lrr run_experiment_torch.py pruning_params.training_type=lrr ;;
    cyclic) run cyclic run_cyclic_training_experiment_torch.py \
        pruning_params.training_type=imp cyclic_training.num_cycles=4 \
        cyclic_training.strategy=constant ;;
  esac
done
