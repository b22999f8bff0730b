"""ctypes binding for the native data-pipeline kernels (native/ecgdata.cpp).

Loads ``native/libecgdata.so`` if present (``make -C native``), otherwise
every accessor returns None and callers fall back to the scipy path — the
library is an accelerator, not a dependency. ctypes calls release the GIL,
so the loader's thread pool gets true parallelism through these kernels.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATHS = [
    os.path.join(_REPO_ROOT, "native", "libecgdata.so"),
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "libecgdata.so"),
]

_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("ECG_DISABLE_NATIVE"):
        return None
    for path in _LIB_PATHS:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.ecg_native_abi_version.restype = ctypes.c_int
                if lib.ecg_native_abi_version() != 1:
                    continue
                lib.ecg_resample_fourier.argtypes = [
                    _f64p, ctypes.c_int64, _f64p, ctypes.c_int64]
                lib.ecg_sosfiltfilt.argtypes = [
                    _f64p, ctypes.c_int, _f64p, ctypes.c_int64, _f64p]
                lib.ecg_resample_nearest.argtypes = [
                    _f64p, ctypes.c_int64, _f64p, ctypes.c_int64]
                lib.ecg_resample_zero.argtypes = [
                    _f64p, ctypes.c_int64, _f64p, ctypes.c_int64]
                lib.ecg_standardize.argtypes = [
                    _f64p, ctypes.c_int64, _f64p]
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def available() -> bool:
    return _load() is not None


def resample_fourier(x: np.ndarray, m: int) -> Optional[np.ndarray]:
    """scipy.signal.resample parity along the last axis of a (C, T) array."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    out = np.empty(x.shape[:-1] + (m,), dtype=np.float64)
    for row_in, row_out in zip(x.reshape(-1, x.shape[-1]),
                               out.reshape(-1, m)):
        lib.ecg_resample_fourier(row_in, row_in.shape[0], row_out, m)
    return out


def sosfiltfilt(sos: np.ndarray, x: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    sos = np.ascontiguousarray(sos, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    # scipy's default padlen; shorter signals go to scipy (which raises the
    # proper "padlen too large" error instead of reading out of bounds)
    if x.shape[-1] <= 3 * (2 * sos.shape[0] + 1):
        return None
    out = np.empty_like(x)
    for row_in, row_out in zip(x.reshape(-1, x.shape[-1]),
                               out.reshape(-1, x.shape[-1])):
        lib.ecg_sosfiltfilt(sos, sos.shape[0], row_in, row_in.shape[0],
                            row_out)
    return out


def resample_labels(y: np.ndarray, m: int, kind: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    fn = lib.ecg_resample_nearest if kind == "nearest" else lib.ecg_resample_zero
    y = np.ascontiguousarray(y, dtype=np.float64)
    out = np.empty(y.shape[:-1] + (m,), dtype=np.float64)
    for row_in, row_out in zip(y.reshape(-1, y.shape[-1]),
                               out.reshape(-1, m)):
        fn(row_in, row_in.shape[0], row_out, m)
    return out


def standardize(x: np.ndarray) -> Optional[np.ndarray]:
    """Joint z-norm over all elements (axis=(-1,-2) case)."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(x, dtype=np.float64).reshape(-1)
    out = np.empty(flat.shape, dtype=np.float64)
    lib.ecg_standardize(flat, flat.shape[0], out)
    return out.reshape(x.shape)
