"""The port's convergence check
(``semi_seg_ecg_tpu_torch/tools/validate_ssl.py``) against the JAX
package's ``tools/validate_ssl.py``, on the CPU.

The recipe: ``cfg()`` of every algorithm equals the JAX tool's key for key
after each package's ``normalize_config``, but for ``device`` (a torch
device here); the copied ``flagship_data_recipe`` equals
``tools/gen_configs.py``'s. The split: the files ``make_split`` writes
(8 / 96 / 16 / 32 records of 2,500 samples, dataset seed 11) equal, byte
for byte, those the JAX package's ``make_synthetic_dataset`` writes for
the JAX tool. The tool: one CPU run of one epoch on a tiny split through
``main(argv)`` prints a JSON line per run and a summary, and exits 1 for
a row outside its tolerance; ``summarize`` holds a mean to
``max(0.02, 2 sigma_JAX)`` (0.02 for a single-seed JAX row).
"""

import json
import os

import pytest

from semi_seg_ecg_tpu.data.synthetic import make_synthetic_dataset
from semi_seg_ecg_tpu_torch.tools import validate_ssl
from tools import gen_configs
from tools import validate_ssl as jax_validate_ssl


@pytest.mark.parametrize("algo", validate_ssl.ALGORITHMS)
def test_cfg_is_the_jax_tools(algo):
    data = {"ecg_dir": "/d/ecg", "label_dir": "/d/label",
            "index_dir": "/d/index", "train_labeled_csv": "l.csv"}
    ours = validate_ssl.cfg(algo, "exp", "/r", data, 25, seed=2,
                            device="cpu")
    theirs = jax_validate_ssl.cfg(algo, "exp", "/r", data, 25, seed=2)
    assert ours.pop("device") == "cpu"
    theirs.pop("device")
    assert ours == theirs


def test_flagship_recipe_is_the_jax_tools():
    for length in (2500, 512):
        assert validate_ssl.flagship_data_recipe(length) == \
            gen_configs.flagship_data_recipe(length)


def read_tree(root):
    files = {}
    for sub in ("ecg", "label", "index"):
        for name in sorted(os.listdir(os.path.join(root, sub))):
            with open(os.path.join(root, sub, name), "rb") as f:
                files[f"{sub}/{name}"] = f.read()
    return files


def test_split_files_are_the_jax_tools(tmp_path):
    ours = validate_ssl.make_split(str(tmp_path / "port"))
    labeled, unlabeled, valid, test = validate_ssl.SPLIT
    theirs = make_synthetic_dataset(
        str(tmp_path / "jax"), num_train_labeled=labeled,
        num_train_unlabeled=unlabeled, num_valid=valid, num_test=test,
        length=validate_ssl.LENGTH, seed=validate_ssl.DATA_SEED)
    assert ours.keys() == theirs.keys()
    got, want = read_tree(tmp_path / "port"), read_tree(tmp_path / "jax")
    assert len(got) == 2 * (labeled + valid + test) + unlabeled + 4
    assert got == want


def test_tolerance_and_summary():
    assert validate_ssl.tolerance("base") == pytest.approx(0.0356)
    assert validate_ssl.tolerance("fixmatch") == 0.02
    assert validate_ssl.tolerance("cps") == 0.02
    rows = validate_ssl.summarize({"fixmatch": [0.74, 0.75, 0.76],
                                   "reco": [0.7097 - 1e-6]})
    assert rows["fixmatch"]["within"] and not rows["reco"]["within"]
    assert rows["fixmatch"]["jax_mean"] == 0.7556


def test_main_runs_and_fails_a_row_outside_its_tolerance(tmp_path, capsys):
    """One epoch of ``base`` on a tiny split on the CPU: far from the JAX
    row, so the tool exits 1 after its lines."""
    code = validate_ssl.main(["--device", "cpu", "--algorithms", "base",
                              "--epochs", "1", "--split", "4", "4", "4", "4",
                              "--root", str(tmp_path)])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    run, summary = lines
    assert run["algorithm"] == "base" and run["seed"] == 0
    assert run["batch_size"] == 4 and 0 <= run["MeanIoU"] <= 1
    row = summary["rows"]["base"]
    assert summary["device"] == "cpu" and row["seeds"] == [run["MeanIoU"]]
    assert row["within"] is False and code == 1
