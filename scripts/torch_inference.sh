#!/usr/bin/env bash
# Inference with the PyTorch/CUDA port on N GPUs (the test split's
# softmax, test_outputs.npy): one process per GPU, launched by torchrun as
# scripts/torch_train.sh launches training.
#
# Usage:
#   bash scripts/torch_inference.sh [--gpus N] [--master_port P] \
#        -f configs/base/resnet18/fixmatch.yaml \
#        [-o configs/bench/ludb/1over16.yaml] [--model_path CKPT] \
#        [--exp_name NAME] [--output_dir DIR]
#
# N ranks (default: NGPUS, else every card nvidia-smi lists) each serve
# their shards of the split with the checkpoint (--model_path, else
# best-{target_metric}.ckpt of the experiment); rank 0 gathers the rows
# and writes the file.
# The rendezvous port is P (default: MASTER_PORT, else 29500). A config
# with device: cpu runs on the CPU over gloo.
exec bash "$(dirname "${BASH_SOURCE[0]}")/torch_run.sh" inference "$@"
