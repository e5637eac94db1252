"""ctypes bindings of the host C++ helpers (CSR build, batch row gather,
ELL fill, in-row column sort, integer factorize, first touch and byte
copy of fresh host memory).

The library is built on first use from ``csr_ops.cpp`` beside this file
(see ``build.py``), threaded by OpenMP (PyTorch's own runtime) or by
``std::thread``; ``build_info()`` says which, and ``num_threads()`` how
many a loop runs.  If no toolchain is present, ``available()`` is False and
each function raises; the data layer then takes its numpy path, which
gives the same arrays, only slower.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np

_lib = None
_load_error: Exception | None = None
_build = None  # build.NativeBuild of the loaded library

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _declare(lib):
    lib.threads_runtime.argtypes = []
    lib.threads_runtime.restype = ctypes.c_int
    lib.num_threads.argtypes = []
    lib.num_threads.restype = ctypes.c_int
    lib.set_num_threads.argtypes = [ctypes.c_int]
    lib.set_num_threads.restype = None
    lib.gather_starts.argtypes = [_P, _P, _I64, _P]
    lib.gather_starts.restype = None
    for t in ("f32", "f64"):
        getattr(lib, f"gather_rows_{t}").argtypes = [_P, _P, _P, _P, _I64, _P, _P, _P, _P]
        getattr(lib, f"gather_rows_{t}").restype = None
        getattr(lib, f"coo_to_csr_{t}").argtypes = [_P, _P, _P, _I64, _I64, _P, _P, _P]
        getattr(lib, f"coo_to_csr_{t}").restype = None
        getattr(lib, f"ell_fill_{t}").argtypes = [_P, _P, _P, _P, _I64, _I64, _P, _P]
        getattr(lib, f"ell_fill_{t}").restype = None
        getattr(lib, f"sort_csr_cols_{t}").argtypes = [_P, _I64, _P, _P]
        getattr(lib, f"sort_csr_cols_{t}").restype = None
    lib.factorize_i64.argtypes = [_P, _I64, _P, _P]
    lib.factorize_i64.restype = ctypes.c_int64
    lib.copy_bytes.argtypes = [_P, _P, _I64, _I64]
    lib.copy_bytes.restype = None
    lib.touch_pages.argtypes = [_P, _I64, _I64]
    lib.touch_pages.restype = None


def _load():
    global _lib, _load_error, _build
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        from .build import build_native

        built = build_native()
        lib = ctypes.CDLL(built.path)
        _declare(lib)
        _lib, _build = lib, built
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _load_error = e
    return _lib


def available() -> bool:
    return _load() is not None


def load_error():
    """Why the library could not be built or loaded (None when it was)."""
    _load()
    return _load_error


def get() -> int:
    """1 if the library runs its loops on threads (OpenMP or
    ``std::thread``), 0 if it was built serial or did not load."""
    lib = _load()
    return int(lib.threads_runtime() != 0) if lib is not None else 0


def build_info():
    """The loaded library's ``build.NativeBuild`` (path, thread runtime,
    flags, the OpenMP library linked, and why a preferred route failed), or
    None when it did not load."""
    _load()
    return _build


def num_threads() -> int:
    """Threads a parallel loop of the library runs (0 if it did not load)."""
    lib = _load()
    return int(lib.num_threads()) if lib is not None else 0


def set_num_threads(n: int) -> None:
    """Threads of every later parallel loop; n <= 0 restores the runtime's
    default.  Kept by the library, so PyTorch's own OpenMP threads are
    untouched."""
    lib = _load()
    if lib is not None:
        lib.set_num_threads(int(n))


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native helpers unavailable: {_load_error}")
    return lib


def _vt(dtype):
    return "f64" if dtype == np.float64 else "f32"


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, nrows: int):
    """COO -> CSR (indptr int64, indices int32, data) via counting sort."""
    lib = _need()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vdt = np.float64 if vals.dtype == np.float64 else np.float32
    vals = np.ascontiguousarray(vals, dtype=vdt)
    nnz = rows.shape[0]
    indptr = np.empty(nrows + 1, dtype=np.int64)
    out_cols = np.empty(nnz, dtype=np.int32)
    out_vals = np.empty(nnz, dtype=vdt)
    getattr(lib, f"coo_to_csr_{_vt(vdt)}")(
        rows.ctypes.data, cols.ctypes.data, vals.ctypes.data, nnz, nrows,
        indptr.ctypes.data, out_cols.ctypes.data, out_vals.ctypes.data)
    return indptr, out_cols, out_vals


def gather_rows(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                rows: np.ndarray):
    """Concatenate CSR slices of ``rows``: returns (vals, row_ids, col_ids)."""
    lib = _need()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    vdt = np.float64 if data.dtype == np.float64 else np.float32
    data = np.ascontiguousarray(data, dtype=vdt)
    nbatch = rows.shape[0]
    out_starts = np.empty(nbatch + 1, dtype=np.int64)
    lib.gather_starts(indptr.ctypes.data, rows.ctypes.data, nbatch, out_starts.ctypes.data)
    total = int(out_starts[-1])
    out_rows = np.empty(total, dtype=np.int32)
    out_cols = np.empty(total, dtype=np.int32)
    out_vals = np.empty(total, dtype=vdt)
    getattr(lib, f"gather_rows_{_vt(vdt)}")(
        indptr.ctypes.data, indices.ctypes.data, data.ctypes.data, rows.ctypes.data, nbatch,
        out_starts.ctypes.data, out_rows.ctypes.data, out_cols.ctypes.data,
        out_vals.ctypes.data)
    return out_vals, out_rows, out_cols


def ell_fill(seg_start: np.ndarray, seg_len: np.ndarray, indices: np.ndarray,
             data: np.ndarray, out_cols: np.ndarray, out_vals: np.ndarray):
    """Fill one pre-zeroed (m, w) ELL bucket from CSR segments in parallel."""
    lib = _need()
    seg_start = np.ascontiguousarray(seg_start, dtype=np.int64)
    seg_len = np.ascontiguousarray(seg_len, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    nseg, w = out_cols.shape
    if not (out_cols.flags.c_contiguous and out_vals.flags.c_contiguous):
        raise TypeError("ell_fill: output buffers must be C-contiguous")
    if out_cols.dtype != np.int32 or out_vals.dtype != data.dtype:
        raise TypeError("ell_fill: out_cols must be int32 and out_vals "
                        "must have the data's dtype")
    data = np.ascontiguousarray(data)
    getattr(lib, f"ell_fill_{_vt(data.dtype)}")(
        seg_start.ctypes.data, seg_len.ctypes.data, indices.ctypes.data,
        data.ctypes.data, nseg, w, out_cols.ctypes.data, out_vals.ctypes.data)


def sort_csr_cols(indptr: np.ndarray, indices: np.ndarray,
                  data: np.ndarray) -> None:
    """In-place stable per-row sort of CSR (indices, data) by column id;
    ``indices`` contiguous int32, ``data`` contiguous f32/f64."""
    lib = _need()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    if indices.dtype != np.int32 or not indices.flags.c_contiguous:
        raise TypeError("sort_csr_cols: 'indices' must be contiguous int32")
    if not data.flags.c_contiguous or indices.shape != data.shape:
        raise TypeError("sort_csr_cols: 'data' must be contiguous and match "
                        "'indices' in shape")
    if data.dtype not in (np.float32, np.float64):
        raise TypeError("sort_csr_cols: 'data' must be float32 or float64")
    getattr(lib, f"sort_csr_cols_{_vt(data.dtype)}")(
        indptr.ctypes.data, indptr.shape[0] - 1, indices.ctypes.data,
        data.ctypes.data)


def factorize_i64(ids: np.ndarray):
    """First-occurrence-order integer factorize (pd.factorize semantics)."""
    lib = _need()
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    n = ids.shape[0]
    codes = np.empty(n, dtype=np.int32)
    uniques = np.empty(n, dtype=np.int64)
    nuniq = int(lib.factorize_i64(ids.ctypes.data, n, codes.ctypes.data,
                                  uniques.ctypes.data))
    return codes, uniques[:nuniq].copy()


def copy_bytes(dst: np.ndarray, src: np.ndarray, block: int = 1 << 21) -> None:
    """``dst[:] = src`` for contiguous uint8 arrays of one size, in blocks
    of ``block`` bytes spread over the library's threads."""
    lib = _need()
    for a in (dst, src):
        if a.dtype != np.uint8 or a.ndim != 1 or not a.flags.c_contiguous:
            raise TypeError("copy_bytes: contiguous 1-d uint8 arrays")
    if not dst.flags.writeable:
        raise ValueError("copy_bytes: 'dst' is read-only")
    if dst.shape != src.shape:
        raise ValueError("copy_bytes: %d bytes into %d" % (src.shape[0], dst.shape[0]))
    if block < 1:
        raise ValueError("copy_bytes: 'block' must be positive")
    lib.copy_bytes(dst.ctypes.data, src.ctypes.data, dst.shape[0], int(block))


def touch_pages(dst: np.ndarray, block: int = 1 << 21) -> None:
    """Write a zero every 4 KB of a contiguous uint8 array, over the
    library's threads: its pages faulted in."""
    lib = _need()
    if dst.dtype != np.uint8 or dst.ndim != 1 or not dst.flags.c_contiguous:
        raise TypeError("touch_pages: a contiguous 1-d uint8 array")
    if not dst.flags.writeable:
        raise ValueError("touch_pages: 'dst' is read-only")
    if block < 1:
        raise ValueError("touch_pages: 'block' must be positive")
    lib.touch_pages(dst.ctypes.data, dst.shape[0], int(block))
