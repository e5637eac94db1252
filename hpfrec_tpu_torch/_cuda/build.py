"""Build the CUDA kernels of ``csrc/`` into one shared library.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
over every ``csrc/*.cu``, at first use, cached under a hash of the sources,
the headers and the command in the port's build directory (listed in
.gitignore).  The sources have a plain C interface and include no PyTorch
header, so a build takes seconds.  A missing ``nvcc`` or a failed build
raises: there is no fallback for CUDA tensors.
"""

from __future__ import annotations

import glob
import os
import shutil

from .._native.build import cached_build

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels of hpfrec_tpu_torch cannot be built")
    return path


def build_kernels() -> str:
    """Compile (or find in the cache) the kernel library; returns its path."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return cached_build([nvcc_path(), *NVCC_FLAGS], sources, "hpf_kernels",
                        deps=headers)
