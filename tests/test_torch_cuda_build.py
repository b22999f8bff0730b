"""Where the port's CUDA libraries build to: keyed by what they compile.

``ops/cuda_build.library_path`` names a library by a hash of its ``.cu``,
the ``csrc/`` headers that source includes (through the headers' own
includes) and the nvcc flags, so an edited header rebuilds every kernel
that includes it and nothing else. No nvcc is needed: the path is computed,
not built.
"""

import os

import pytest

from semi_seg_ecg_tpu_torch.ops import cuda_build
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    files = {
        "a.cu": '#include <math.h>\n#include "common.cuh"\nint a;\n',
        "b.cu": "int b;\n",
        "common.cuh": '#pragma once\n  #  include "inner.cuh"\n',
        "inner.cuh": "#pragma once\nint inner;\n",
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return tmp_path


def test_editing_an_included_header_changes_the_library_path(csrc):
    a, b = cuda_build.library_path("a"), cuda_build.library_path("b")
    assert os.path.basename(a).startswith("a-") and a.endswith(".so")
    assert cuda_build.library_path("a") == a  # stable while nothing changes
    for header in ("common.cuh", "inner.cuh"):
        path = csrc / header
        path.write_text(path.read_text() + "// edited\n")
        edited = cuda_build.library_path("a")
        assert edited != a, header
        a = edited
    assert cuda_build.library_path("b") == b  # b includes neither


def test_the_flash_kernels_hash_their_shared_header():
    included = cuda_build._INCLUDE.findall
    for stem in ("flash_attention_fwd", "flash_attention_bwd"):
        with open(os.path.join(cuda_build.CSRC_DIR, f"{stem}.cu"),
                  "rb") as f:
            assert included(f.read()) == [b"flash_common.cuh"], stem
