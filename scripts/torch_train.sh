#!/usr/bin/env bash
# Data-parallel training with the PyTorch/CUDA port: one process per GPU,
# launched by torchrun (scripts/torch_run.sh), as the reference's
# scripts/train.sh launches its training.
#
# Usage:
#   bash scripts/torch_train.sh [--gpus N] [--master_port P] \
#        -f configs/base/resnet18/fixmatch.yaml \
#        [-o configs/bench/ludb/1over16.yaml] [--exp_name NAME] \
#        [--output_dir DIR] [--resume CKPT] [--start_epoch N]
#
# N ranks (default: NGPUS, else every card nvidia-smi lists), each taking
# the config's dataloader.batch_size rows a step: the global batch is
# N x batch_size, and the lr scales with it when train.lr is unset.
# Rank 0 prints and writes the run's files. The rendezvous port is P
# (default: MASTER_PORT, else 29500). A config with device: cpu trains on
# the CPU over gloo. --resume restarts from a checkpoint: the port's own
# .ckpt (model, teacher or peer, optimizers, step), a JAX package .ckpt
# (its trees and optax state) or a reference .pth (the model; the
# optimizer restarts), at the epoch after the file's.
exec bash "$(dirname "${BASH_SOURCE[0]}")/torch_run.sh" train "$@"
