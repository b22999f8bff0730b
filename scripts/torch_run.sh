#!/usr/bin/env bash
# One PyTorch/CUDA port entry on N GPUs, one process per GPU, launched by
# torchrun: the launcher behind scripts/torch_{train,test,inference}.sh.
#
# Usage:
#   bash scripts/torch_run.sh {train|test|inference} [--gpus N] \
#        [--master_port P] -f CONFIG [the entry's own flags]
#
# N ranks (default: NGPUS, else every card nvidia-smi lists); the
# rendezvous port is P (default: MASTER_PORT, else 29500). Every other
# argument goes to `python -m semi_seg_ecg_tpu_torch.cli ENTRY`. A config
# with device: cpu runs on the CPU over gloo.
set -euo pipefail

ENTRY="$1"
shift
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
  -m semi_seg_ecg_tpu_torch.cli "${ENTRY}" "${ARGS[@]}"
