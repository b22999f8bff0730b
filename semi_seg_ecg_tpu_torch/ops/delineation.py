"""Delineation post-processing: label fields → wave intervals → clinical
boundary metrics.

The reference evaluates segmentation only as per-sample overlap
(torchmetrics MeanIoU, ``src/test.py``); the clinical literature for the
datasets it targets (LUDB/QTDB) scores *delineation*: P/QRS/T onset and
offset errors against annotation, with a boundary counted as detected if
a predicted boundary lies within a tolerance window (150 ms in the LUDB
paper) — sensitivity, PPV, and the mean ± std of the matched errors in
milliseconds. This module closes that gap as pure host-side
post-processing over the argmax label field any of this framework's
inference surfaces produce (``test.py`` rows,
``serving.long_record_inference`` full records, or the streaming
segmenter) — it is not a training-path op, so numpy is the right tool.

Class convention follows the shipped configs: 0 = background, wave
classes are everything else (LUDB: 1 = P, 2 = QRS, 3 = T).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = ["labels_to_intervals", "intervals_to_labels",
           "match_boundaries", "delineation_metrics"]


def labels_to_intervals(labels, classes: Optional[Sequence[int]] = None,
                        min_duration: int = 1) -> Dict[int, np.ndarray]:
    """Run-length extraction: ``{class: (N, 2) [onset, offset)}``.

    ``labels``: 1-D integer label field. ``classes`` defaults to every
    non-zero label present. Runs shorter than ``min_duration`` samples
    are dropped (a 1-sample blip is never a physiological wave; pass 1
    to keep everything).
    """
    labels = np.asarray(labels).ravel()
    if classes is None:
        classes = sorted(int(c) for c in np.unique(labels) if c != 0)
    out: Dict[int, np.ndarray] = {}
    for c in classes:
        mask = np.concatenate([[False], labels == c, [False]])
        edges = np.flatnonzero(np.diff(mask.astype(np.int8)))
        onsets, offsets = edges[0::2], edges[1::2]
        keep = (offsets - onsets) >= min_duration
        out[int(c)] = np.stack([onsets[keep], offsets[keep]],
                               axis=1).astype(np.int64)
    return out


def intervals_to_labels(intervals: Dict[int, np.ndarray],
                        total: int) -> np.ndarray:
    """Inverse of :func:`labels_to_intervals` (later classes overwrite
    earlier on overlap, which valid delineations don't have)."""
    labels = np.zeros(total, np.int64)
    for c, iv in intervals.items():
        for onset, offset in np.asarray(iv):
            labels[int(onset):int(offset)] = c
    return labels


def match_boundaries(pred: np.ndarray, true: np.ndarray,
                     tolerance: int) -> Tuple[np.ndarray, int, int]:
    """Greedy nearest matching of two sorted boundary-position arrays.

    Each true boundary matches the nearest unused predicted boundary
    within ``tolerance`` samples (ties to the earlier candidate, matched
    in order of increasing |error| so a prediction between two true
    boundaries pairs with the closer one). Returns ``(errors, n_fn,
    n_fp)`` where ``errors`` is the signed error (pred - true) of every
    match, in samples.
    """
    pred = np.sort(np.asarray(pred, np.int64).ravel())
    true = np.sort(np.asarray(true, np.int64).ravel())
    if pred.size == 0 or true.size == 0:
        return np.zeros(0, np.int64), int(true.size), int(pred.size)
    # candidate pairs within tolerance, found by sorted range lookup —
    # output-sensitive (boundaries are typically ≫ tolerance apart, so a
    # handful of candidates each), never a dense (n_true, n_pred) matrix
    lo = np.searchsorted(pred, true - tolerance, side="left")
    hi = np.searchsorted(pred, true + tolerance, side="right")
    ti_all = np.repeat(np.arange(true.size), hi - lo)
    pi_all = np.concatenate(
        [np.arange(a, b) for a, b in zip(lo, hi)]) if ti_all.size else \
        np.zeros(0, np.int64)
    diffs = pred[pi_all] - true[ti_all]
    order = np.argsort(np.abs(diffs), kind="stable")
    used_t = np.zeros(true.size, bool)
    used_p = np.zeros(pred.size, bool)
    errors = []
    for idx in order:
        ti, pi = ti_all[idx], pi_all[idx]
        if used_t[ti] or used_p[pi]:
            continue
        used_t[ti] = used_p[pi] = True
        errors.append(diffs[idx])
    return (np.asarray(errors, np.int64), int((~used_t).sum()),
            int((~used_p).sum()))


def delineation_metrics(pred_labels, true_labels, *, fs: float,
                        tolerance_ms: float = 150.0,
                        classes: Optional[Sequence[int]] = None,
                        min_duration: int = 1) -> Dict[str, Dict[str, float]]:
    """Boundary-level delineation scores of a predicted label field.

    For every wave class and for each of (onset, offset): sensitivity
    ``TP/(TP+FN)``, PPV ``TP/(TP+FP)``, and mean/std of the matched
    signed errors in ms, at ``tolerance_ms`` (LUDB-paper convention).
    ``min_duration`` filters blips from the PREDICTION only — the truth
    is always scored in full. ``classes`` defaults to every non-zero
    class in either field (a hallucinated class counts as FPs).
    Returns ``{"<class>_<boundary>": {"sensitivity", "ppv", "mean_ms",
    "std_ms", "n_true", "n_pred"}}`` plus an ``"overall"`` entry
    aggregating TP/FN/FP over everything.
    """
    tol = int(round(tolerance_ms * fs / 1000.0))
    if classes is None:
        # union of both fields: a class predicted but absent from the
        # truth must still count its boundaries as false positives
        classes = sorted(
            {int(c) for c in np.unique(np.asarray(true_labels)) if c != 0} |
            {int(c) for c in np.unique(np.asarray(pred_labels)) if c != 0})
    # the blip filter is prediction post-processing; the truth is scored
    # in full (LUDB convention: every annotated boundary counts)
    true_iv = labels_to_intervals(true_labels, classes, min_duration=1)
    pred_iv = labels_to_intervals(pred_labels, classes, min_duration)
    out: Dict[str, Dict[str, float]] = {}
    tp_all = fn_all = fp_all = 0
    for c in sorted(true_iv):
        for j, boundary in enumerate(("onset", "offset")):
            t = true_iv[c][:, j]
            p = pred_iv.get(c, np.zeros((0, 2), np.int64))[:, j]
            errors, n_fn, n_fp = match_boundaries(p, t, tol)
            tp = errors.size
            tp_all, fn_all, fp_all = tp_all + tp, fn_all + n_fn, fp_all + n_fp
            ms = errors * 1000.0 / fs
            out[f"{c}_{boundary}"] = {
                "sensitivity": tp / max(1, tp + n_fn),
                "ppv": tp / max(1, tp + n_fp),
                "mean_ms": float(ms.mean()) if tp else float("nan"),
                "std_ms": float(ms.std()) if tp else float("nan"),
                "n_true": int(t.size), "n_pred": int(p.size),
            }
    out["overall"] = {
        "sensitivity": tp_all / max(1, tp_all + fn_all),
        "ppv": tp_all / max(1, tp_all + fp_all),
        "n_matched": float(tp_all),
    }
    return out
