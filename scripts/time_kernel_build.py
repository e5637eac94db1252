"""Time the build of the CUDA kernels two ways on the card's host.

Run from the root of a checkout:  python3 scripts/time_kernel_build.py

- one call: a single ``nvcc ... -shared`` over every ``csrc/*.cu``;
- per source: ``_cuda.build.build_kernels``, one ``nvcc -c`` for each
  source, all started together, then one link.

Each build starts from an empty build directory (under the port's
gitignored ``_build/``), in the order one call, per source, per source,
one call, and prints its wall time on the host clock.  Needs ``nvcc``.
"""

import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hpfrec_tpu_torch._cuda import build as cuda_build  # noqa: E402
from hpfrec_tpu_torch._native import build as native_build  # noqa: E402


def one_call():
    sources, headers = cuda_build.sources_and_headers()
    return native_build.cached_build(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared"], sources,
        "hpf_kernels_one_call", deps=headers)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print("card (nvidia-smi name, power.limit):", smi.stdout.strip() or "none")
    print("host cores:", os.cpu_count(), " sources:", len(cuda_build.sources_and_headers()[0]))
    root = os.path.join(native_build.build_dir(), "build_timing")
    base = native_build.BUILD_DIR
    try:
        for i, (name, fn) in enumerate((("one call", one_call),
                                        ("per source", cuda_build.build_kernels),
                                        ("per source", cuda_build.build_kernels),
                                        ("one call", one_call))):
            native_build.BUILD_DIR = os.path.join(root, str(i))
            t0 = time.perf_counter()
            fn()
            print("%-10s build: %.3f s" % (name, time.perf_counter() - t0))
    finally:
        native_build.BUILD_DIR = base
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
