"""ECG semi-supervised segmentation dataset (host-side).

Capability parity with ``ECGSemiSegDataset`` / ``build_seg_dataset``
(reference src/utils/semi_dataset.py:30-323) with two redesigns:

- **Deterministic per-sample RNG.** ``__getitem__`` style access takes an
  explicit ``numpy.random.Generator`` (derived by the loader from
  ``(seed, epoch, index)``), so augmentation draws are reproducible and
  independent of worker scheduling — required for multi-host input pipelines.
- **Deterministic-prefix caching.** Resample + bandpass filtering do not
  depend on RNG, so their result per *file* is computed once and cached
  in memory (``cache=True``), removing the per-epoch scipy ``sosfiltfilt`` /
  FFT cost that dominates the reference's input pipeline
  (semi_dataset.py:176-199 recomputes them every epoch).

Samples are dicts of NumPy arrays: ``ecg`` (1, T) float32, ``target`` (T,)
int64 for labeled modes, and ``ecg_aug`` (1, T) float32 when strong
augmentations are configured (unlabeled branch).
"""

from __future__ import annotations

import math
import os
import pickle as pkl
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import pandas as pd

from . import transforms as T
from .transforms import get_transforms_from_config


def _build(cfg) -> Optional[Callable]:
    if cfg is None:
        return None
    built = get_transforms_from_config(cfg)
    if built is None:
        return None
    return built[0] if len(built) == 1 else T.Compose(built)


class ECGSemiSegDataset:
    """Map-style dataset of single-lead ECG pickles + segmentation labels.

    Each ``.pkl`` holds one ``np.ndarray`` of shape ``(T,)`` (waveform or
    integer label) — same on-disk contract as semi_dataset.py:50-57.
    Modes: ``train_labeled`` / ``train_unlabeled`` / ``valid`` / ``test``;
    ``train_labeled`` with ``num_unlabeled`` oversamples the labeled list to
    the unlabeled length (semi_dataset.py:86-95).
    """

    def __init__(
        self,
        ecg_dir: str,
        label_dir: Optional[str],
        filenames: List[str],
        label_filenames: Optional[List[str]] = None,
        fs_list: Optional[List[int]] = None,
        target_fs: Optional[int] = None,
        target_length: Optional[int] = None,
        filter_fn: Optional[Callable] = None,
        crop_fn: Optional[Callable] = None,
        aug_fn: Optional[Callable] = None,
        strong_aug_fn: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        label_transform: Optional[Callable] = None,
        mode: str = "train_labeled",
        num_unlabeled: Optional[int] = None,
        cache: bool = True,
    ):
        self.ecg_dir = ecg_dir
        self.label_dir = label_dir
        self.filenames = list(filenames)
        self.label_filenames = (
            list(label_filenames) if label_filenames is not None else None
        )
        self.fs_list = list(fs_list) if fs_list is not None else None
        self.mode = mode
        if mode == "train_labeled" and num_unlabeled is not None:
            reps = math.ceil(num_unlabeled / len(self.filenames))
            self.filenames = (self.filenames * reps)[:num_unlabeled]
            if self.label_filenames is not None:
                self.label_filenames = (self.label_filenames * reps)[:num_unlabeled]
            if self.fs_list is not None:
                self.fs_list = (self.fs_list * reps)[:num_unlabeled]
        self.check_dataset()

        # Resampling setup (semi_dataset.py:98-117): signals via Fourier,
        # labels via zero-order hold.
        if self.fs_list is not None:
            self.resample = T.Resample(target_fs=target_fs)
            self.label_resample = T.Resample(
                target_fs=target_fs, method="interp", kind="zero"
            )
        elif target_length is not None:
            self.resample = T.Resample(target_length=target_length)
            self.label_resample = T.Resample(
                target_length=target_length, method="interp", kind="zero"
            )
        else:
            self.resample = None
            self.label_resample = None

        self.filter_fn = filter_fn
        self.crop_fn = crop_fn
        self.aug_fn = aug_fn
        self.strong_aug_fn = strong_aug_fn
        self.transform = transform if transform is not None else T.ToTensor("float")
        self.label_transform = label_transform
        self._cache: Optional[Dict[int, Any]] = {} if cache else None

    # -- invariants (semi_dataset.py:154-174 parity) ------------------------

    def check_dataset(self) -> None:
        not_pkl = [f for f in self.filenames if not f.endswith(".pkl")]
        assert not not_pkl, f"Some files are not pkl. (e.g. {not_pkl[0]}...)"
        missing = [
            f for f in self.filenames
            if not os.path.exists(os.path.join(self.ecg_dir, f))
        ]
        assert not missing, f"Some files do not exist. (e.g. {missing[0]}...)"
        if self.labeled:
            missing = [
                f for f in self.label_filenames
                if not os.path.exists(os.path.join(self.label_dir, f))
            ]
            assert not missing, f"Some files do not exist. (e.g. {missing[0]}...)"
            assert len(self.filenames) == len(self.label_filenames), \
                "The number of filenames and label_filenames are different."
        if self.fs_list is not None:
            assert len(self.filenames) == len(self.fs_list), \
                "The number of filenames and fs_list are different."

    @property
    def labeled(self) -> bool:
        return (
            self.mode in ("train_labeled", "valid", "test")
            and self.label_filenames is not None
        )

    @property
    def with_strong_augmentation(self) -> bool:
        return self.strong_aug_fn is not None

    def __len__(self) -> int:
        return len(self.filenames)

    # -- deterministic prefix (load → resample → filter), cacheable ---------

    def _load_processed(self, idx: int):
        # key by record, not index: the oversampled labeled list repeats
        # files, and per-index keying would recompute (and hold) the
        # resample+filter prefix once per duplicate
        fs = self.fs_list[idx] if self.fs_list is not None else None
        key = (
            self.filenames[idx],
            self.label_filenames[idx] if self.labeled else None,
            fs,
        )
        if self._cache is not None and key in self._cache:
            return self._cache[key]
        with open(os.path.join(self.ecg_dir, self.filenames[idx]), "rb") as f:
            x = pkl.load(f)
        x = np.asarray(x, dtype=np.float64)[None, :]
        y = None
        if self.labeled:
            with open(
                os.path.join(self.label_dir, self.label_filenames[idx]), "rb"
            ) as f:
                y = pkl.load(f)
            y = np.asarray(y)[None, :]
        if self.resample is not None:
            x = self.resample(x, fs)
            if y is not None:
                y = self.label_resample(y, fs)
        if self.filter_fn is not None:
            x = self.filter_fn(x)
        if self._cache is not None:
            self._cache[key] = (x, y)
        return x, y

    # -- random path ---------------------------------------------------------

    def get(self, idx: int, rng: Optional[np.random.Generator] = None
            ) -> Dict[str, np.ndarray]:
        """Fetch one processed sample using ``rng`` for all random draws.

        Pipeline order matches semi_dataset.py:176-243: resample → filter →
        joint crop → weak aug → transform; the strong view is strong aug
        applied *on top of* the weak view (semi_dataset.py:240-243)."""
        rng = rng if rng is not None else np.random.default_rng()
        x, y = self._load_processed(idx)
        if self.crop_fn is not None:
            if y is not None:
                x, y = self.crop_fn(x, y, rng=rng)
            else:
                x = self.crop_fn(x, rng=rng)
        if self.aug_fn is not None:
            if y is not None:
                x, y = self.aug_fn(x, y, rng=rng)
            else:
                x = self.aug_fn(x, rng=rng)
        out = {"ecg": self.transform(x)}
        if self.labeled:
            out["target"] = np.squeeze(self.label_transform(y))
        if self.with_strong_augmentation:
            x_aug = self.strong_aug_fn(x, rng=rng)
            out["ecg_aug"] = self.transform(x_aug)
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get(idx)


def build_seg_dataset(
    cfg: dict,
    split: str,
    mode: Optional[str] = None,
    num_unlabeled: Optional[int] = None,
    cache: Optional[bool] = None,
) -> ECGSemiSegDataset:
    """Build a dataset from its config (semi_dataset.py:247-323 parity).

    ``{split}_csv`` (``.csv`` or ``.pkl`` DataFrame) in ``index_dir`` lists
    filenames via ``filename_col`` / ``label_filename_col`` (+ optional
    ``fs_col``). Train mode gets ``train_crop`` + ``augmentations`` +
    ``strong_augmentations``; eval mode gets ``eval_crop`` only.
    """
    fname_col = cfg.get("filename_col", "waveform")
    fs_col = cfg.get("fs_col", None)
    target_fs = cfg.get("fs", None)
    target_length = cfg.get("signal_length", None)

    index_dir = os.path.realpath(cfg["index_dir"])
    ecg_dir = os.path.realpath(cfg["ecg_dir"])

    if split != "train_unlabeled":
        label_fname_col = cfg["label_filename_col"]
        label_dir = os.path.realpath(cfg["label_dir"])
    else:
        label_fname_col = None
        label_dir = None

    df_name = cfg.get(f"{split}_csv", None)
    assert df_name is not None, f"{split}_csv is not defined in the config."
    ext = os.path.splitext(df_name)[1]
    if ext == ".csv":
        df = pd.read_csv(os.path.join(index_dir, df_name))
    elif ext == ".pkl":
        df = pd.read_pickle(os.path.join(index_dir, df_name))
    else:
        raise ValueError(f"Invalid extension: {df_name}")
    filenames = df[fname_col].tolist()
    label_filenames = (
        df[label_fname_col].tolist() if split != "train_unlabeled" else None
    )
    fs_list = df[fs_col].astype(int).tolist() if fs_col is not None else None

    if mode is None:
        mode = split
    if mode.startswith("train"):
        crop_cfg = cfg.get("train_crop", None)
        augmentations = _build(cfg.get("augmentations", None))
        strong_augmentations = _build(cfg.get("strong_augmentations", None))
    else:
        crop_cfg = cfg.get("eval_crop", None)
        augmentations = None
        strong_augmentations = None
    filter_fn = _build(cfg.get("filter", None))
    crop_fn = _build(crop_cfg)
    transforms_cfg = cfg.get("transforms", None)
    transform = (
        T.ToTensor("float") if transforms_cfg is None else _build(transforms_cfg)
    )
    label_transform = T.ToTensor("long") if label_fname_col is not None else None

    return ECGSemiSegDataset(
        ecg_dir,
        label_dir,
        filenames=filenames,
        label_filenames=label_filenames,
        fs_list=fs_list,
        target_fs=target_fs,
        target_length=target_length,
        filter_fn=filter_fn,
        crop_fn=crop_fn,
        aug_fn=augmentations,
        strong_aug_fn=strong_augmentations,
        transform=transform,
        label_transform=label_transform,
        mode=split,
        num_unlabeled=num_unlabeled,
        cache=cache if cache is not None else bool(cfg.get("cache", True)),
    )


class Subset:
    """Index-remapped view of a dataset (torch.utils.data.Subset parity,
    used by ST++ stage 2 — reference stpp.py:504-508)."""

    def __init__(self, dataset: ECGSemiSegDataset, indices: Iterable[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def get(self, idx: int, rng=None):
        return self.dataset.get(self.indices[idx], rng=rng)

    def __getitem__(self, idx: int):
        return self.dataset[self.indices[idx]]

    @property
    def with_strong_augmentation(self) -> bool:
        return self.dataset.with_strong_augmentation

    @property
    def labeled(self) -> bool:
        return self.dataset.labeled
