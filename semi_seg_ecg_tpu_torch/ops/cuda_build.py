"""Build the port's CUDA kernels into plain C-ABI shared libraries.

Each ``csrc/<stem>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) at
first use, into ``build/torch_kernels/<stem>-<hash>.so`` at the root of the
checkout, and loaded with ``ctypes``. The hash covers the source and the
flags, so an edited kernel is rebuilt and an unchanged one is reused. The
compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<stem>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)),
                         "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from source at first use")


def library_path(stem: str) -> str:
    """Where ``csrc/<stem>.cu`` builds to, keyed by source and flags."""
    with open(os.path.join(CSRC_DIR, f"{stem}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build_library(stem: str) -> str:
    """Compile ``csrc/<stem>.cu`` unless its library exists; return the
    library's path. The build writes a temporary file and renames it, so
    concurrent builds never load a half-written library."""
    path = library_path(stem)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{stem}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(path[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library(stem: str) -> ctypes.CDLL:
    return ctypes.CDLL(build_library(stem))
