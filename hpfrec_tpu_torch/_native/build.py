"""On-demand build of the host C++ helpers.

The C++ source is the port's own ``csr_ops.cpp`` beside this file: a
framework-free copy of the JAX package's host kernels (CSR build, ELL
fill, in-row column sort, integer factorize), so that the port builds from
nothing outside its own package.  Flags are probed as in the JAX package's
builder (``-march=native``, OpenMP spellings), and the library is cached
under a hash of the source and the flags in the port's build directory.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Build outputs of the port (host helpers and CUDA kernels); listed in
# .gitignore.
BUILD_DIR = os.path.join(_PKG, "_build")

SRC = os.path.join(_PKG, "_native", "csr_ops.cpp")


def _probe_flag(cxx: str, flag: str) -> bool:
    """Can the compiler build a trivial translation unit with this flag?"""
    with tempfile.TemporaryDirectory(dir=build_dir()) as td:
        src = os.path.join(td, "t.cpp")
        with open(src, "w") as f:
            f.write("int main(){return 0;}\n")
        r = subprocess.run([cxx, flag, "-o", os.path.join(td, "t.out"), src],
                           capture_output=True)
        return r.returncode == 0


def build_dir() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def cached_build(cmd_prefix, sources, out_stem: str, deps=(), key: str = "",
                 suffix: str = ".so") -> str:
    """Run ``cmd_prefix + ['-o', out] + sources`` unless an output (a
    library, or an object for ``suffix='.o'``) built from the same bytes of
    ``sources`` and ``deps`` (headers) and the same command (and ``key``)
    already exists.  The output is written under a per-process temporary
    name and renamed, so concurrent builders never see a partial file; the
    compiler's output is kept beside it as ``<stem>.log``.
    Raises on failure."""
    h = hashlib.sha256()
    for s in (*sources, *deps):
        with open(s, "rb") as f:
            h.update(f.read())
    h.update("\0".join([*cmd_prefix, key]).encode())
    stem = os.path.join(build_dir(), f"{out_stem}_{h.hexdigest()[:16]}")
    out = stem + suffix
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [*cmd_prefix, "-o", tmp, *sources]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("build failed: %s\n%s"
                           % (" ".join(cmd), (r.stdout + r.stderr)[-4000:]))
    with open(stem + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, out)
    return out


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` code is only valid on
    the CPU it was built for, so the cache key includes it."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform

    return platform.processor() or platform.machine()


def build_native() -> str:
    """Compile ``csr_ops.cpp`` into a shared library; returns its path."""
    if not os.path.exists(SRC):
        raise FileNotFoundError(f"host helper source not found: {SRC}")
    cxx = os.environ.get("CXX", "g++")
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    if _probe_flag(cxx, "-march=native"):
        flags.append("-march=native")
    for f in ("-fno-math-errno", "-fno-trapping-math"):
        if _probe_flag(cxx, f):
            flags.append(f)
    if _probe_flag(cxx, "-fopenmp"):
        flags.append("-fopenmp")
    return cached_build([cxx, *flags], [SRC], "csr_ops", key=_cpu_model())
