"""On-demand build of the host C++ helpers.

The C++ source is the port's own ``csr_ops.cpp`` beside this file: a
framework-free copy of the JAX package's host kernels (CSR build, ELL
fill, in-row column sort, integer factorize), so that the port builds from
nothing outside its own package.  Flags are probed as in the JAX package's
build script (``-march=native``), and the library is cached under a hash of the
source, the flags and the thread runtime in the port's build directory.

Threads, in order of preference: ``-fopenmp`` linked against the OpenMP
runtime that PyTorch has already loaded into the process (one runtime in
the process, found even where the compiler's own ``libgomp.so`` is
missing); else the same loops on ``std::thread`` (``-DHPF_STD_THREADS``);
else serial.  ``build_native`` says which it took and why it passed over
the others.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import NamedTuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Build outputs of the port (host helpers and CUDA kernels); listed in
# .gitignore.
BUILD_DIR = os.path.join(_PKG, "_build")

SRC = os.path.join(_PKG, "_native", "csr_ops.cpp")


def _probe(cxx: str, flag: str) -> str:
    """Build a trivial program with this flag: "" if it builds, else the
    compiler's own error."""
    with tempfile.TemporaryDirectory(dir=build_dir()) as td:
        src = os.path.join(td, "t.cpp")
        with open(src, "w") as f:
            f.write("int main(){return 0;}\n")
        r = subprocess.run([cxx, flag, "-o", os.path.join(td, "t.out"), src],
                           capture_output=True, text=True)
        return "" if r.returncode == 0 else (r.stdout + r.stderr).strip()[-2000:] or "failed"


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


class NativeBuild(NamedTuple):
    """What ``build_native`` built: the library, its thread runtime
    (``"openmp"``, ``"threads"`` or ``"serial"``), the compiler flags, the
    OpenMP library linked (or None), and why each route preferred to the
    one taken failed (route -> the compiler's error)."""

    path: str
    runtime: str
    flags: tuple
    omp_lib: str | None
    passed_over: dict


def torch_openmp() -> str | None:
    """The path of the GNU OpenMP runtime loaded in this process (PyTorch's
    Linux wheels load their own with ``libtorch_cpu``), or None."""
    import torch  # noqa: F401  (loads the runtime PyTorch links)

    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.split()[-1]
                if os.path.basename(path).startswith("libgomp") and ".so" in path:
                    return os.path.realpath(path)
    except OSError:
        pass
    return None


def _flags(cxx: str) -> list:
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    for f in ("-march=native", "-fno-math-errno", "-fno-trapping-math"):
        if not _probe(cxx, f):
            flags.append(f)
    return flags


def build_route(runtime: str) -> NativeBuild:
    """Compile ``csr_ops.cpp`` with one thread runtime (``"openmp"``,
    ``"threads"`` or ``"serial"``); raises RuntimeError, with the
    compiler's error, where it does not build."""
    if not os.path.exists(SRC):
        raise FileNotFoundError(f"host helper source not found: {SRC}")
    cxx = os.environ.get("CXX", "g++")
    flags, key = _flags(cxx), _cpu_model()
    if runtime == "openmp":
        omp_lib = torch_openmp()
        if omp_lib is None:
            raise RuntimeError("no GNU OpenMP runtime (libgomp) is loaded in the process")
        # compiled with -fopenmp, linked without it against omp_lib by path:
        # the link needs neither the compiler's libgomp.so nor its
        # libgomp.spec, and -z defs fails it on any symbol omp_lib lacks
        compile_flags = [f for f in flags if f != "-shared"] + ["-fopenmp", "-c"]
        link_flags = ["-shared", "-pthread", "-Wl,-z,defs",
                      "-Wl,-rpath," + os.path.dirname(omp_lib)]
        obj = cached_build([cxx, *compile_flags], [SRC], "csr_ops_omp", key=key, suffix=".o")
        path = cached_build([cxx, *link_flags], [obj, omp_lib], "csr_ops_omp", key=key)
        return NativeBuild(path, runtime, (*compile_flags, *link_flags), omp_lib, {})
    extra = {"threads": ["-pthread", "-DHPF_STD_THREADS"], "serial": []}[runtime]
    path = cached_build([cxx, *flags, *extra], [SRC], f"csr_ops_{runtime}", key=key)
    return NativeBuild(path, runtime, (*flags, *extra), None, {})


def build_native() -> NativeBuild:
    """The host helpers with the first thread runtime that builds (see the
    module's docstring); ``passed_over`` holds the others' errors."""
    passed_over = {}
    for runtime in ("openmp", "threads"):
        try:
            return build_route(runtime)._replace(passed_over=passed_over)
        except RuntimeError as e:
            passed_over[runtime] = str(e)[-2000:]
    return build_route("serial")._replace(passed_over=passed_over)
