"""Segmentation metrics (counterpart of ``semi_seg_ecg_tpu/ops/metrics.py``).

:func:`segmentation_stats` turns integer class maps into per-sample,
per-class intersection / prediction-sum / target-sum counts on the tensors'
device. The metric objects are host-side NumPy and copied from the JAX
package as they are: per update (one eval batch) the batch mean of the
per-sample scores, and ``compute()`` the mean over updates, which is
torchmetrics' ``MeanIoU`` accumulation. Division by an empty union or sum
gives 0. :func:`per_sample_miou` is the one definition of a sample's mean
IoU that ``MeanIoU`` and ST++'s reliability ranking share.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch


def segmentation_stats(preds: torch.Tensor, labels: torch.Tensor,
                       num_classes: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(intersection, pred_sum, target_sum)``, each ``(B, C)`` int32, from
    integer ``(B, T)`` prediction and label maps."""
    classes = torch.arange(num_classes, device=preds.device)
    p1 = preds.unsqueeze(-1) == classes  # (B, T, C)
    t1 = labels.unsqueeze(-1) == classes
    inter = (p1 & t1).sum(dim=1, dtype=torch.int32)
    psum = p1.sum(dim=1, dtype=torch.int32)
    tsum = t1.sum(dim=1, dtype=torch.int32)
    return inter, psum, tsum


def _safe_divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    return np.divide(
        num, den, out=np.zeros(np.broadcast(num, den).shape), where=den != 0
    )


def per_sample_miou(inter: np.ndarray, psum: np.ndarray, tsum: np.ndarray,
                    include_background: bool = True) -> np.ndarray:
    """(B,) per-sample mean IoU with the 0-where-union-0 convention — the
    single definition shared by the MeanIoU metric and ST++'s reliability
    ranking (reference stpp.py:32-42)."""
    if not include_background:
        inter, psum, tsum = inter[:, 1:], psum[:, 1:], tsum[:, 1:]
    union = psum + tsum - inter
    return _safe_divide(inter, union).mean(axis=1)


class SegmentationMetric:
    """Stateful metric: feed :func:`segmentation_stats` outputs per batch."""

    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        include_background: bool = True,
        per_class: bool = False,
        input_format: str = "one-hot",
        **_ignored,
    ):
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.reset()

    def reset(self) -> None:
        shape = (self.num_classes,) if self.per_class else ()
        self.score = np.zeros(shape)
        self.num_batches = 0

    def _slice(self, arr: np.ndarray) -> np.ndarray:
        return arr if self.include_background else arr[:, 1:]

    def _per_sample(self, inter, psum, tsum) -> np.ndarray:
        """Per-sample score; (B,) when mean-over-class, (B, C) per_class."""
        raise NotImplementedError

    def update(self, inter: np.ndarray, psum: np.ndarray, tsum: np.ndarray) -> None:
        score = self._per_sample(
            np.asarray(inter, dtype=np.float64),
            np.asarray(psum, dtype=np.float64),
            np.asarray(tsum, dtype=np.float64),
        )
        self.score = self.score + score.mean(axis=0)
        self.num_batches += 1

    def compute(self) -> Union[float, np.ndarray]:
        value = self.score / max(self.num_batches, 1)
        return value if self.per_class else float(value)


class MeanIoU(SegmentationMetric):
    """torchmetrics.segmentation.MeanIoU parity: per-sample IoU with
    0-where-union-0, classes averaged (or kept with ``per_class``)."""

    def _per_sample(self, inter, psum, tsum):
        if not self.per_class:
            return per_sample_miou(inter, psum, tsum,
                                   self.include_background)
        union = psum + tsum - inter
        return _safe_divide(self._slice(inter), self._slice(union))


class DiceScore(SegmentationMetric):
    """Per-sample Dice/F1: ``2I / (P + T)`` with 0-where-empty, class-mean
    (the per-wave F1 used in the SemiSegECG paper's tables)."""

    def _per_sample(self, inter, psum, tsum):
        dice = _safe_divide(
            2.0 * self._slice(inter), self._slice(psum) + self._slice(tsum)
        )
        return dice if self.per_class else dice.mean(axis=1)


class F1Score(DiceScore):
    """Alias — for segmentation maps micro-F1 per class == Dice."""


class GeneralizedDiceScore(SegmentationMetric):
    """Generalized Dice with inverse-square-frequency class weights
    (torchmetrics.segmentation.GeneralizedDiceScore, weight_type='square').
    Classes absent from the target get zero weight."""

    def _per_sample(self, inter, psum, tsum):
        tsum_s = self._slice(tsum)
        weights = _safe_divide(np.ones_like(tsum_s), tsum_s**2)
        numer = 2.0 * (weights * self._slice(inter))
        denom = weights * (self._slice(psum) + tsum_s)
        if self.per_class:
            return _safe_divide(numer, denom)
        return _safe_divide(numer.sum(axis=1), denom.sum(axis=1))


_METRICS = {
    "MeanIoU": MeanIoU,
    "DiceScore": DiceScore,
    "F1Score": F1Score,
    "GeneralizedDiceScore": GeneralizedDiceScore,
}


class MetricCollection(dict):
    """Named metric bundle (torchmetrics.MetricCollection parity surface)."""

    def update(self, inter, psum, tsum) -> None:  # type: ignore[override]
        for metric in self.values():
            metric.update(inter, psum, tsum)

    def compute(self) -> Dict[str, Union[float, np.ndarray]]:
        return {name: metric.compute() for name, metric in self.items()}

    def reset(self) -> None:
        for metric in self.values():
            metric.reset()


def build_metric_fn(config: dict) -> Tuple[MetricCollection, Dict[str, float]]:
    """Config → metric collection (perf_metrics.py:9-47 parity).

    Supports ``target_metrics`` entries as names or ``{name: kwargs}`` dicts;
    common kwargs (num_classes / include_background / per_class /
    input_format) come from the metric config section. ``compute_on_cpu`` and
    ``sync_on_compute`` are accepted and ignored — metrics are always
    host-side here, and cross-device sync happens in the evaluator's gather.
    """
    if config["task"] != "segmentation":
        raise ValueError(f"Invalid task: {config['task']}")
    common = {
        "num_classes": config["num_classes"],
        "include_background": config.get("include_background", True),
        "per_class": config.get("per_class", False),
        "input_format": config.get("input_format", "one-hot"),
    }
    collection = MetricCollection()
    for entry in config["target_metrics"]:
        if isinstance(entry, dict):
            if len(entry) != 1:
                raise ValueError(f"Invalid metric name: {entry}")
            name, kwargs = list(entry.items())[0]
            kwargs = {**common, **(kwargs or {})}
        else:
            name, kwargs = entry, common
        if name not in _METRICS:
            raise ValueError(f"Invalid metric name: {name}")
        collection[name] = _METRICS[name](**kwargs)
    best_metrics = {
        k: -float("inf") if v.higher_is_better else float("inf")
        for k, v in collection.items()
    }
    return collection, best_metrics


def is_best_metric(metric, prev_metric: float, curr_metric: float) -> bool:
    if metric.higher_is_better:
        return curr_metric > prev_metric
    return curr_metric < prev_metric


def flatten_metric_dict(metrics: Dict[str, Union[float, np.ndarray]]
                        ) -> Dict[str, float]:
    """Per-class arrays → ``{name}_{i}`` floats (base.py:230-237 parity)."""
    out: Dict[str, float] = {}
    for k, v in metrics.items():
        arr = np.asarray(v).tolist()
        if isinstance(arr, list):
            for i, vi in enumerate(arr):
                out[f"{k}_{i}"] = float(vi)
        else:
            out[k] = float(arr)
    return out
