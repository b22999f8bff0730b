"""What the torch port may import, and where it runs unasked.

The port and ``chip_smoke.py`` import nothing of JAX (jax, flax, optax),
nothing of the JAX package and nothing of the repo's ``tools/``,
``bench.py`` or ``__graft_entry__.py`` (the port keeps its own copies
under ``semi_seg_ecg_tpu_torch/tools/``). The scan is static, over every file's AST: a
``sys.modules`` check would be fooled by an interpreter that pre-imports
jax at start-up. An entry point whose config does not say ``device: cpu``
asks for the CUDA device, and raises where there is none.
"""

import ast
import glob
import os

import pytest
import torch
import yaml

from semi_seg_ecg_tpu_torch.cli import infer_longrec_main, inference_main
from semi_seg_ecg_tpu_torch.config import normalize_config, resolve_device
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "semi_seg_ecg_tpu",
             "tools", "__graft_entry__", "bench")
PORT_FILES = sorted(
    glob.glob(os.path.join(REPO, "semi_seg_ecg_tpu_torch", "**", "*.py"),
              recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_files_are_found():
    assert len(PORT_FILES) > 15
    assert all(os.path.exists(p) for p in PORT_FILES)
    names = {os.path.relpath(p, REPO) for p in PORT_FILES}
    tools = ("device_profile", "flops_audit", "bench", "bench_scale",
             "bench_matrix", "profile_step", "bench_e2e", "bench_inference",
             "bench_holter", "bench_streams", "bench_longrec")
    for module in ("utils/lr_decay.py", "models/remat.py",
                   "tools/validate_ssl.py", "tools/vit_row.py",
                   *(f"tools/{t}.py" for t in tools)):
        assert f"semi_seg_ecg_tpu_torch/{module}" in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[os.path.relpath(p, REPO) for p in PORT_FILES])
def test_no_jax_import(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_entry_without_device_key_asks_for_cuda(tmp_path):
    config = normalize_config({})
    assert config["device"] == "cuda"
    if torch.cuda.is_available():
        assert resolve_device(config).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device: cpu"):
        resolve_device(config)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.dump({"dataset": {}, "dataloader": {}}))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        inference_main(["-f", str(path)])


def test_infer_longrec_without_device_key_asks_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card is there: the entry would run on it")
    path = tmp_path / "config.yaml"
    path.write_text(yaml.dump({"dataset": {"signal_length": 250},
                               "backbone": {"resnet18": {}}}))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        infer_longrec_main(["-f", str(path), "--record",
                            str(tmp_path / "missing.npy")])


def test_explicit_cpu_is_honoured():
    assert resolve_device(normalize_config({"device": "cpu"})).type == "cpu"
