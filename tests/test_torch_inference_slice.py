"""The ported slice as a whole: test-split serving of ViT-1D + FCNHead.

The JAX package's ``run_inference`` (8-device CPU mesh, flash attention in
Pallas interpret mode) and the port's (CPU, the kernel's plain version)
serve the same synthetic split from the same ``.ckpt``, written by the JAX
package's ``save_checkpoint``; their ``test_outputs.npy`` must agree within
atol 1e-5 (softmax probabilities of fp32 logits). The reverse direction
holds too: a ``.pth`` written by the port is served by the JAX package's
``.pth`` loader to the same outputs.
"""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from semi_seg_ecg_tpu.algorithms.common import (
    init_model_state,
    run_inference as jax_run_inference,
)
from semi_seg_ecg_tpu.config import normalize_config as jax_normalize
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.utils.checkpoint import save_checkpoint
from semi_seg_ecg_tpu.utils.train_state import ModelState
from semi_seg_ecg_tpu_torch.algorithms.common import (
    load_eval_model,
    run_inference,
)
from semi_seg_ecg_tpu_torch.config import normalize_config
from semi_seg_ecg_tpu_torch.utils import checkpoint as torch_ckpt
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

WIDTH = 64


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """Config of ``tests/test_entries.py``'s shape with the ViT recipe cut
    to depth 2, and a ``.ckpt`` of perturbed JAX weights."""
    root = tmp_path_factory.mktemp("torch_slice")
    from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset

    data = make_synthetic_dataset(str(root / "data"), num_train_labeled=1,
                                  num_train_unlabeled=1, num_valid=1,
                                  num_test=8, length=500, seed=4)
    config = {
        "seed": 0, "output_dir": str(root / "exps"), "exp_name": "jax",
        "device": "cpu", "use_amp": False, "algorithm": "base",
        "backbone": {"vit_tiny": {
            "num_leads": 1, "seq_len": 500, "patch_size": 25,
            "width": WIDTH, "depth": 2, "heads": 2, "dim_head": 32,
            "mlp_dim": 128, "out_indices": [1], "qk_norm": True,
            "attention_impl": "flash"}},
        "decode_head": {"FCNHead": {
            "in_channels": WIDTH, "in_index": 0, "channels": 16,
            "num_convs": 1, "concat_input": False, "dropout_ratio": 0.1,
            "num_classes": 4, "align_corners": False}},
        "dataset": dict(data, transforms=[
            {"standardize": {"axis": [-1, -2]}},
            {"to_tensor": {"dtype": "float"}}]),
        "dataloader": {"batch_size": 1, "num_workers": 2},
        "test": {"target_metric": "MeanIoU"},
        "ddp": {"world_size": 1, "rank": -1, "distributed": False},
    }
    model = jax_build(jax_normalize(dict(config, precision="fp32")),
                      train=False, serving=True)
    state = init_model_state(model, config, 0)
    rng = np.random.default_rng(9)
    perturb = lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        np.shape(a)).astype(np.float32)
    stats = jax.tree.map(lambda a: np.abs(perturb(a)) + 0.5,
                         state.batch_stats)
    state = ModelState(params=jax.tree.map(perturb, state.params),
                       batch_stats=stats)
    ckpt_path = str(root / "model.ckpt")
    save_checkpoint(ckpt_path, 0, state, config=config)
    return config, ckpt_path, root


def _serve(run, normalize, config, model_path, exp_name):
    cfg = normalize(dict(config, exp_name=exp_name,
                         test={"model_path": model_path}))
    outputs = run(cfg)
    saved = np.load(os.path.join(config["output_dir"], exp_name,
                                 "test_outputs.npy"))
    np.testing.assert_array_equal(saved, outputs)
    return outputs


def test_run_inference_matches_jax_both_ways(slice_setup):
    config, ckpt_path, root = slice_setup
    theirs = _serve(jax_run_inference, jax_normalize, config, ckpt_path,
                    "jax")
    ours = _serve(run_inference, normalize_config, config, ckpt_path,
                  "torch")
    assert ours.shape == theirs.shape == (8, 4, 500)
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(ours, theirs, atol=1e-5)

    # reverse: the port's .pth, served by the JAX package
    pth = str(root / "model.pth")
    model = load_eval_model(
        normalize_config(dict(config, test={"model_path": ckpt_path})),
        device=torch.device("cpu"))
    torch_ckpt.save_torch_checkpoint(pth, model, epoch=0, config=config)
    theirs_from_pth = _serve(jax_run_inference, jax_normalize, config, pth,
                             "jax_pth")
    np.testing.assert_allclose(theirs_from_pth, ours, atol=1e-5)


def test_run_inference_serves_fp32_without_tf32(slice_setup, monkeypatch):
    """PyTorch lets cuDNN use TF32 by default; the fp32 entry turns TF32
    off for its forward passes and puts the process's flags back after."""
    from semi_seg_ecg_tpu_torch.algorithms import common

    config, ckpt_path, _ = slice_setup
    seen = []

    def load_and_watch(cfg, device):
        model = load_eval_model(cfg, device)
        model.register_forward_pre_hook(lambda *_: seen.append((
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)))
        return model

    monkeypatch.setattr(common, "load_eval_model", load_and_watch)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    _serve(run_inference, normalize_config, config, ckpt_path, "tf32")
    assert seen == [(False, False)] * 8  # batch size 1, 8 windows
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def test_ckpt_naming_a_jax_class_is_refused(slice_setup, tmp_path):
    """A ``.ckpt`` is a pickle: one that names a JAX class cannot be opened
    without JAX. The port reads NumPy leaves only and says so, instead of
    importing whatever the file names."""
    _, ckpt_path, _ = slice_setup
    with open(ckpt_path, "rb") as f:
        payload = pickle.load(f)
    assert torch_ckpt.load_checkpoint(ckpt_path)["model"].keys() == \
        payload["model"].keys()
    payload["metrics"] = {"loss": jnp.zeros(())}  # a jax.Array leaf
    bad = str(tmp_path / "jax_leaf.ckpt")
    with open(bad, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(pickle.UnpicklingError, match="jax"):
        torch_ckpt.load_checkpoint(bad)
