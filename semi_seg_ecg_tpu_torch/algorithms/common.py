"""Test-split inference (counterpart of ``load_eval_model`` and
``run_inference`` in ``semi_seg_ecg_tpu/algorithms/common.py``).

Single process, one device: the config's ``device`` (``resolve_device``),
the CUDA card unless it says ``cpu``. Training, ``run_test`` and the
multi-device paths are not ported yet.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Dict

import numpy as np
import torch

from ..config import experiment_dir, resolve_device, test_cfg
from ..data.dataset import build_seg_dataset
from ..data.loader import get_dataloader
from ..models import build_model_from_config, compute_dtype
from ..utils import checkpoint as ckpt


def log(*args) -> None:
    now = datetime.datetime.now().strftime("[%Y-%m-%d %H:%M:%S]")
    print(now, *args, flush=True)


def loader_workers(dataloader_cfg: Dict[str, Any]) -> int:
    """num_workers with an unset default of 4; an explicit 0 means
    synchronous loading."""
    n = dataloader_cfg.get("num_workers", 4)
    return 4 if n is None else int(n)


def loader_worker_type(dataloader_cfg: Dict[str, Any]) -> str:
    return dataloader_cfg.get("worker_type", None) or "thread"


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuBLAS matmuls and cuDNN convolutions while inside, so
    fp32 work is full fp32 as in the JAX package (PyTorch's default lets
    cuDNN use TF32); the process's settings come back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def load_eval_model(config: Dict[str, Any],
                    device: torch.device) -> torch.nn.Module:
    """Build the eval-mode model and restore the requested checkpoint
    (``test.model_path``, else ``best-{target_metric}.ckpt`` in the
    experiment directory): a JAX ``.ckpt`` or a torch ``.pth``."""
    model = build_model_from_config(config)
    if test_cfg(config).get("model_path", None):
        checkpoint_path = config["test"]["model_path"]
    else:
        target_metric = test_cfg(config).get("target_metric", "loss")
        checkpoint_path = os.path.join(experiment_dir(config),
                                       f"best-{target_metric}.ckpt")
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(f"Checkpoint not found: {checkpoint_path}")
    payload = ckpt.load_checkpoint(checkpoint_path)
    model.load_state_dict(ckpt.model_state_dict(payload["model"]))
    log(f"Loaded checkpoint {checkpoint_path}")
    return model.to(device).eval()


def run_inference(config: Dict[str, Any]) -> np.ndarray:
    """Softmax of ``seg_logits`` over the test split, in dataset order →
    ``test_outputs.npy`` (no labels, no metrics). Full fp32 (no TF32)
    unless ``test.use_amp``, which runs the model under bf16 autocast."""
    device = resolve_device(config)
    out_dir = experiment_dir(config)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    ds_test = build_seg_dataset(config["dataset"], split="test")
    loader = get_dataloader(
        ds_test, mode="test", batch_size=config["dataloader"]["batch_size"],
        seed=config["seed"],
        num_workers=loader_workers(config["dataloader"]),
        worker_type=loader_worker_type(config["dataloader"]),
    )
    use_amp = bool(test_cfg(config).get("use_amp", False))
    amp_dtype = compute_dtype(config) if use_amp else torch.float32
    model = load_eval_model(config, device)

    outputs = None
    mat = loader.step_indices()
    try:
        with torch.inference_mode(), full_fp32(), torch.autocast(
                device.type, dtype=amp_dtype, enabled=use_amp):
            for step, batch in enumerate(loader):
                x = torch.from_numpy(batch["ecg"]).to(device)
                logits = model(x)["seg_logits"]
                probs = torch.softmax(logits.float(), dim=1).cpu().numpy()
                if outputs is None:
                    outputs = np.zeros((len(ds_test),) + probs.shape[1:],
                                       np.float32)
                outputs[mat[step].reshape(-1)] = probs
    finally:
        loader.close()
    if out_dir:
        np.save(os.path.join(out_dir, "test_outputs.npy"), outputs)
    log("Done!")
    return outputs
