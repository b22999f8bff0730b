"""The training split on the device (counterpart of
``semi_seg_ecg_tpu/data/device_cache.py``).

With ``dataset.device_augment`` the host ships, every step, the
deterministic prefix of each record (load, resample, filter: the same
every epoch) and the device builds the augmented views. ECG segmentation
corpora are small beside a card's memory (LUDB about 2 MB, PTB-XL about
200 MB at 250 Hz in fp32), so ``dataset.device_cache: true`` uploads each
unique record's prefix once and the loaders ship only int32 row indices
per step; the step gathers the rows on the device, before the
augmentation stage. The reference has no such cache; its loader re-reads
and re-filters every epoch (src/utils/semi_dataset.py:176-243).

The cache needs a plan that runs every augmentation of the train branches
on the device (:func:`plan_allows_device_cache`): host augmentation draws
per sample on the host, where nothing can be cached. Under a process group
every rank holds the whole cache (the JAX package replicates it on its
mesh), and the index loaders keep the stream loaders' sharding, seed and
epoch, so a rank's rows are the same with and without it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .dataset import Subset
from .loader import DataLoader


class _IndexDataset:
    """A dataset that yields cache row numbers instead of arrays, so the
    loader's sampler, shards and prefetch serve the cache unchanged."""

    def __init__(self, rowmap: np.ndarray, key: str):
        self.rowmap = rowmap.astype(np.int32)
        self.key = key

    def __len__(self) -> int:
        return len(self.rowmap)

    def get(self, idx: int, rng=None) -> Dict[str, np.ndarray]:
        return {self.key: self.rowmap[idx]}


def _base_and_rowmap(dataset):
    """Resolve a ``Subset`` view and deduplicate repeated (oversampled)
    records. Returns the base dataset, ``rowmap`` (dataset index -> unique
    record row), and the base index of each unique record, so that the
    cache holds each file once even when the labeled list is oversampled
    to the unlabeled length (semi_dataset.py:86-95)."""
    indices = None
    if isinstance(dataset, Subset):
        indices, dataset = np.asarray(dataset.indices), dataset.dataset
    keys = {}
    rowmap = np.empty(len(dataset.filenames), np.int64)
    uniques: List[int] = []
    for i, fname in enumerate(dataset.filenames):
        label = (dataset.label_filenames[i]
                 if dataset.label_filenames is not None else None)
        fs = dataset.fs_list[i] if dataset.fs_list is not None else None
        k = (fname, label, fs)
        if k not in keys:
            keys[k] = len(uniques)
            uniques.append(i)
        rowmap[i] = keys[k]
    if indices is not None:
        rowmap = rowmap[indices]
    return dataset, rowmap, uniques


class DeviceCache:
    """The train datasets' (signals, labels) on the device, the index
    loaders that replace the stream loaders, and the gather that turns an
    index batch back into the batch the augmentation stage takes."""

    def __init__(self, arrays: Dict[str, torch.Tensor],
                 loaders: Dict[str, Any], bytes_uploaded: int):
        self.arrays = arrays          # device tensors, whole on every rank
        self.index_loaders = loaders  # replacements for labeled/unlabeled
        self.bytes_uploaded = bytes_uploaded

    @staticmethod
    def build(loaders: Dict[str, Any], device: torch.device
              ) -> "DeviceCache":
        """Upload each unique record's processed prefix of the labeled and
        unlabeled loaders' datasets once: fp32 signals ``(R, C, T)`` and
        int32 labels ``(R, T)``."""
        arrays: Dict[str, torch.Tensor] = {}
        new_loaders: Dict[str, Any] = {}
        total = 0
        for name, key in (("labeled", "idx"), ("unlabeled", "idx_u")):
            if name not in loaders:
                continue
            src: DataLoader = loaders[name]
            base, rowmap, uniques = _base_and_rowmap(src.dataset)
            xs, ys = [], []
            for i in uniques:
                x, y = base._load_processed(i)
                xs.append(np.asarray(x, np.float32))
                if y is not None:
                    ys.append(np.squeeze(np.asarray(y)).astype(np.int32))
            x_cache = np.stack(xs)
            total += x_cache.nbytes
            arrays[f"x_{key}"] = torch.from_numpy(x_cache).to(device)
            if ys:
                y_cache = np.stack(ys)
                total += y_cache.nbytes
                arrays[f"y_{key}"] = torch.from_numpy(y_cache).to(device)
            new_loaders[name] = DataLoader(
                _IndexDataset(rowmap, key),
                batch_size=src.batch_size, shuffle=src.shuffle,
                seed=src.seed, num_shards=src.num_shards,
                drop_last=src.drop_last, num_workers=1, prefetch=1,
                shard_offset=src.shard_offset,
                local_shards=src.local_shards, rng_salt=src.rng_salt,
            )
            new_loaders[name].set_epoch(src.epoch)
        return DeviceCache(arrays, new_loaders, total)

    def materialize(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """An index batch (``idx``, ``idx_u`` on the device) -> the raw
        views the augmentation stage takes: ``ecg`` and ``target`` (int64,
        as the stream loader ships labels) and ``ecg_u_w``."""
        out: Dict[str, torch.Tensor] = {}
        if "idx" in batch:
            rows = batch["idx"].long()
            out["ecg"] = self.arrays["x_idx"][rows]
            if "y_idx" in self.arrays:
                out["target"] = self.arrays["y_idx"][rows].long()
        if "idx_u" in batch:
            out["ecg_u_w"] = self.arrays["x_idx_u"][batch["idx_u"].long()]
        return out


def plan_allows_device_cache(config: Dict[str, Any], spec) -> Optional[str]:
    """None when ``device_cache`` can run, else the reason it cannot (the
    trainer logs it and streams)."""
    ds_cfg = config["dataset"]
    if not ds_cfg.get("device_augment", False):
        return "requires dataset.device_augment"
    if ds_cfg.get("train_crop"):
        return "train_crop runs on the host (shape-changing)"
    from ..ops.preprocess import plan_device_augment

    plan = plan_device_augment(ds_cfg)
    if plan.augment is None:
        return "augmentation pipeline is host-only"
    if ds_cfg.get("augmentations") \
            and plan.labeled_overrides.get("augmentations", ()) is not None:
        return "weak augmentations fall back to the host"
    if spec.uses_unlabeled and ds_cfg.get("strong_augmentations") \
            and plan.unlabeled_overrides.get("augmentations", ()) is not None:
        return "unlabeled branch falls back to the host"
    return None
