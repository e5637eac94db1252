"""Build the CUDA kernels of ``csrc/`` into one shared library.

Each ``csrc/*.cu`` is compiled to an object by its own ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -c -Xcompiler -fPIC``, all started
together, and the objects are linked with ``nvcc -shared``.  Objects and
library go through ``_native.build.cached_build``: cached under hashes of
the sources, the headers and the commands in the port's build directory
(listed in .gitignore).  The sources have a plain C interface and include
no PyTorch header, so a build takes seconds.  A missing ``nvcc`` or a
failed build raises: there is no fallback for CUDA tensors.
"""

from __future__ import annotations

import glob
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

from .._native.build import cached_build

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels of hpfrec_tpu_torch cannot be built")
    return path


def sources_and_headers():
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources, sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def build_kernels() -> str:
    """Compile (or find in the cache) the kernel library; returns its path."""
    sources, headers = sources_and_headers()
    compile_cmd = [nvcc_path(), *NVCC_FLAGS, "-c"]

    def compile_one(src):
        stem = os.path.splitext(os.path.basename(src))[0]
        return cached_build(compile_cmd, [src], stem, deps=headers, suffix=".o")

    with ThreadPoolExecutor(len(sources)) as pool:
        objs = list(pool.map(compile_one, sources))
    return cached_build([compile_cmd[0], "-shared"], objs, "hpf_kernels")
