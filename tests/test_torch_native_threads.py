"""The port's host helpers give the same bits at every thread count: on a
power-law set of ~1M nonzeros with repeated (user, item) pairs, the CSR of
both sides, the in-row column sort, the ELL layouts of both sides (the
fill), the batch row gather and ``factorize`` under
``_native.set_num_threads(1)`` and under 4 threads, for the library the
port loaded (OpenMP on PyTorch's runtime where it builds) and for the
``std::thread`` build of the same source; the serial build gives the same
bits.  Skips visibly where the helpers have no threads."""

import ctypes

import numpy as np
import pytest

from hpfrec_tpu_torch import _native
from hpfrec_tpu_torch._native import build


def _powerlaw(nU=40_000, nI=12_000, nnz=1_000_000, seed=3):
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, nU, nnz).astype(np.int32)
    ranks = np.arange(1, nI + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    ii = rng.choice(nI, size=nnz, p=p).astype(np.int32)
    y = (rng.poisson(2.0, nnz) + 1).astype(np.float32)
    return iu, ii, y, nU, nI


def _outputs(iu, ii, y, nU, nI):
    """Every helper's output on the data, as a flat list of arrays."""
    from hpfrec_tpu_torch.ops.ell import build_ell

    out = []
    for rows, cols, n_rows in ((iu, ii, nU), (ii, iu, nI)):
        indptr, ind, dat = _native.coo_to_csr(rows, cols, y, n_rows)
        out += [indptr, ind.copy(), dat.copy()]
        _native.sort_csr_cols(indptr, ind, dat)
        out += [ind, dat]
        lay = build_ell(indptr, ind, dat, n_rows)
        out += [a for b in lay.buckets for a in (b.rows, b.cols, b.vals)]
        out += list(_native.gather_rows(indptr, ind, dat, np.arange(0, n_rows, 3)))
    out += list(_native.factorize_i64(iu.astype(np.int64) * 7 + 11))
    return out


@pytest.fixture(params=["loaded", "std::thread"])
def library(request, monkeypatch):
    """The library the port loaded, or the ``std::thread`` build of the
    same source put in its place."""
    if not _native.available():
        pytest.skip("native helpers unavailable: %s" % _native.load_error())
    if request.param == "std::thread":
        path = build.build_route("threads").path
        lib = ctypes.CDLL(path)
        _native._declare(lib)
        monkeypatch.setattr(_native, "_lib", lib)
        assert lib.threads_runtime() == 2
    if not _native.get():
        pytest.skip("the native helpers were built without threads: %s"
                    % _native.build_info().passed_over)
    yield request.param
    _native.set_num_threads(0)


def test_helpers_bit_equal_at_1_and_4_threads(library):
    data = _powerlaw()
    runs = {}
    for n in (1, 4):
        _native.set_num_threads(n)
        assert _native.num_threads() == n
        runs[n] = _outputs(*data)
    assert len(runs[1]) == len(runs[4]) > 10
    for a, b in zip(runs[1], runs[4]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_serial_build_bit_equal(monkeypatch):
    """The build without threads (the last route) gives the bits of the
    loaded library, whatever thread count is asked of it."""
    if not _native.available():
        pytest.skip("native helpers unavailable: %s" % _native.load_error())
    data = _powerlaw(nnz=300_000)
    _native.set_num_threads(4)
    try:
        ref = _outputs(*data)
    finally:
        _native.set_num_threads(0)
    lib = ctypes.CDLL(build.build_route("serial").path)
    _native._declare(lib)
    monkeypatch.setattr(_native, "_lib", lib)
    _native.set_num_threads(8)
    assert lib.threads_runtime() == 0 and _native.num_threads() == 1
    got = _outputs(*data)
    assert [a.tobytes() for a in got] == [b.tobytes() for b in ref]


def test_set_num_threads_restores_the_default(library):
    _native.set_num_threads(3)
    assert _native.num_threads() == 3
    _native.set_num_threads(0)
    assert _native.num_threads() >= 1


def test_ncores_warning_names_why_threads_failed(monkeypatch):
    """Where the helpers really lack threads, ``HPF(ncores > 1)`` warns
    with the compiler's reason for each route that failed; ncores=1 is
    silent."""
    import warnings

    from hpfrec_tpu_torch import HPF

    monkeypatch.setattr(_native, "get", lambda: 0)
    monkeypatch.setattr(_native, "build_info", lambda: build.NativeBuild(
        "x.so", "serial", (), None,
        {"openmp": "cannot read spec file 'libgomp.spec'", "threads": "no -pthread"}))
    with pytest.warns(UserWarning, match="openmp: cannot read spec file 'libgomp.spec'; "
                                         "threads: no -pthread"):
        HPF(k=2, ncores=2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        HPF(k=2, ncores=1, device="cpu")
