#!/usr/bin/env bash
# Evaluation with the PyTorch/CUDA port on N GPUs (the test split's
# test_metrics.csv, test_outputs.npy and test_labels.npy): one process per
# GPU, launched by torchrun as scripts/torch_train.sh launches training.
#
# Usage:
#   bash scripts/torch_test.sh [--gpus N] [--master_port P] \
#        -f configs/base/resnet18/fixmatch.yaml \
#        [-o configs/bench/ludb/1over16.yaml] [--model_path CKPT] \
#        [--exp_name NAME] [--output_dir DIR]
#
# N ranks (default: NGPUS, else every card nvidia-smi lists) each evaluate
# their shards of the split with the checkpoint (--model_path, else
# best-{target_metric}.ckpt of the experiment); rank 0 gathers the rows
# and writes the files.
# The rendezvous port is P (default: MASTER_PORT, else 29500). A config
# with device: cpu runs on the CPU over gloo.
exec bash "$(dirname "${BASH_SOURCE[0]}")/torch_run.sh" test "$@"
