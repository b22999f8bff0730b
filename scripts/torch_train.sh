#!/usr/bin/env bash
# Data-parallel training with the PyTorch/CUDA port: one process per GPU,
# launched by torchrun, as the reference's scripts/train.sh launches its
# training.
#
# Usage:
#   bash scripts/torch_train.sh [--gpus N] [--master_port P] \
#        -f configs/base/resnet18/fixmatch.yaml \
#        [-o configs/bench/ludb/1over16.yaml] [--exp_name NAME] \
#        [--output_dir DIR]
#
# N ranks (default: NGPUS, else every card nvidia-smi lists), each taking
# the config's dataloader.batch_size rows a step: the global batch is
# N x batch_size, and the lr scales with it when train.lr is unset.
# Rank 0 prints and writes the run's files. The rendezvous port is P
# (default: MASTER_PORT, else 29500). A config with device: cpu trains on
# the CPU over gloo.
set -euo pipefail

NGPUS="${NGPUS:-}"
MASTER_PORT="${MASTER_PORT:-29500}"
ARGS=()
while [[ $# -gt 0 ]]; do
  case "$1" in
    --gpus) NGPUS="$2"; shift 2 ;;
    --master_port) MASTER_PORT="$2"; shift 2 ;;
    *) ARGS+=("$1"); shift ;;
  esac
done
if [[ -z "${NGPUS}" ]]; then
  NGPUS="$(nvidia-smi -L | wc -l)"
fi

SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
cd "${SCRIPT_DIR}/.."
exec python -m torch.distributed.run --nproc_per_node "${NGPUS}" \
  --master_addr 127.0.0.1 --master_port "${MASTER_PORT}" \
  -m semi_seg_ecg_tpu_torch.cli train "${ARGS[@]}"
