"""Each CUDA kernel of hpfrec_tpu_torch against its plain PyTorch version
on the card, in float32 and float64, on small layouts that cover split
rows, tiled (column-offset) buckets and zero-degree rows.

The ``gpu`` tests skip without a CUDA device; the card runs them with
``python -m pytest tests/test_torch_kernels.py -q --noconftest``
(``--noconftest``: the suite's conftest imports jax, which the port does
not need).  Tolerances: f32 rtol 2e-5 / atol 1e-6 (kernel and plain
version sum the k products and the w slots in another order; float32
digamma differs by a few ulps), f64 rtol 1e-11 / atol 1e-13.
"""

import numpy as np
import pytest
import torch

TOL = {torch.float32: dict(rtol=2e-5, atol=1e-6),
       torch.float64: dict(rtol=1e-11, atol=1e-13)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts(nU, nI, nnz, seed):
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, nU, nnz)
    # skewed items so that some rows split at a small max_width
    ii = np.minimum(rng.zipf(1.3, nnz) - 1, nI - 1)
    key = np.unique(iu * nI + ii)
    y = rng.poisson(2.0, len(key)) + 1.0
    return y, (key // nI).astype(np.int32), (key % nI).astype(np.int32)


def _layout(y, rows, cols, n_rows, n_cols, dtype, device, chunk=None, max_width=16):
    from scipy.sparse import coo_array

    from hpfrec_tpu_torch.ops.ell import build_ell, to_device

    X = coo_array((y, (rows, cols)), shape=(n_rows, n_cols)).tocsr()
    lay = build_ell(X.indptr.astype(np.int64), X.indices.astype(np.int32),
                    X.data.astype(dtype), n_rows, max_width=max_width,
                    dtype=dtype, col_chunk_rows=chunk, n_cols=n_cols)
    return to_device(lay, device)


def _tables(n, k, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((n, k)) + 0.05).to(device, dtype)


CASES = [(torch.float32, None, 50), (torch.float64, None, 50),
         (torch.float32, 23, 50), (torch.float64, 23, 7),
         (torch.float32, None, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,chunk,k", CASES)
def test_ell_phi_sums_kernel_vs_plain(cuda, dtype, chunk, k):
    from hpfrec_tpu_torch.ops import ell as E

    nU, nI = 300, 120
    y, iu, ii = _counts(nU, nI, 4000, seed=1)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    lay = _layout(y, iu, ii, nU + 3, nI, npdt, cuda, chunk)  # 3 empty rows
    t = _tables(nU + 3, k, dtype, cuda, 2)
    b = _tables(nI, k, dtype, cuda, 3)
    seg = E.all_bucket_sums(t, b, lay)
    ref = torch.cat([E._bucket_phi_sums_plain(t, b, bk.rows, bk.cols, bk.vals,
                                              bk.col_off)
                     for bk in lay.buckets])
    torch.cuda.synchronize()
    torch.testing.assert_close(seg, ref, **TOL[dtype])
    out = E.segment_table_sums(seg, lay)
    torch.testing.assert_close(out, E._segment_table_sums_plain(seg, lay),
                               **TOL[dtype])
    # deterministic: a second run gives the same bits
    assert torch.equal(E.segment_table_sums(E.all_bucket_sums(t, b, lay), lay), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_phi_sums_wide_segments(cuda, dtype):
    """Item side of a skewed matrix at the default max_width: buckets from
    8 to 3072 slots wide, so K1 runs with 1, 2, 4 and 8 warps per segment."""
    from hpfrec_tpu_torch.ops import ell as E

    nU, k = 4000, 50
    rng = np.random.default_rng(11)
    degrees = np.repeat([300, 700, 1500, 3000], 40)  # one warp class each
    nI = len(degrees)
    ii = np.repeat(np.arange(nI), degrees).astype(np.int32)
    iu = np.concatenate([rng.choice(nU, d, replace=False) for d in degrees]).astype(np.int32)
    y = rng.poisson(2.0, len(ii)) + 1.0
    npdt = np.float32 if dtype == torch.float32 else np.float64
    lay = _layout(y, ii, iu, nI, nU, npdt, cuda, max_width=8192)
    widths = {b.cols.shape[1] for b in lay.buckets}
    assert {E._warps_per_segment(w) for w in widths} == {1, 2, 4, 8}
    t = _tables(nI, k, dtype, cuda, 2)
    b = _tables(nU, k, dtype, cuda, 3)
    seg = E.all_bucket_sums(t, b, lay)
    ref = torch.cat([E._bucket_phi_sums_plain(t, b, bk.rows, bk.cols, bk.vals,
                                              bk.col_off)
                     for bk in lay.buckets])
    torch.testing.assert_close(seg, ref, **TOL[dtype])
    assert torch.equal(E.all_bucket_sums(t, b, lay), seg)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 50, 256])
def test_table_update_kernel_vs_plain(cuda, dtype, k):
    from hpfrec_tpu_torch.ops import cavi as C

    n = 5000
    sums = _tables(n, k, dtype, cuda, 4) * 30
    scaler = _tables(n, 1, dtype, cuda, 5) + 1
    colsum = _tables(1, k, dtype, cuda, 6) * 100
    got = C.side_update(sums, scaler, colsum, 0.3, 0.3 + k * 0.3, 0.3)
    ref = C._side_update_plain(sums, scaler, colsum, 0.3, 0.3 + k * 0.3, 0.3)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **TOL[dtype])
    shp, rte = got[0], got[1]
    rte[7] = float("inf")  # all -inf elog row: the non-finite rowmax guard
    tab, cs = C.side_derive(shp, rte)
    tab_r, cs_r = C._side_derive_plain(shp, rte)
    torch.testing.assert_close(tab, tab_r, **TOL[dtype])
    torch.testing.assert_close(cs, cs_r, **TOL[dtype])
    assert torch.equal(tab[7], torch.zeros_like(tab[7]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_update_carry_equals_derive(cuda, dtype):
    """The update form's exp table and colsum equal, bit for bit, what the
    derive form gives from the shp and rte it wrote: a fit passes the
    carry from block to block instead of deriving it again."""
    from hpfrec_tpu_torch.ops import cavi as C

    n, k = 5000, 50
    sums = _tables(n, k, dtype, cuda, 4) * 30
    scaler = _tables(n, 1, dtype, cuda, 5) + 1
    colsum = _tables(1, k, dtype, cuda, 6) * 100
    shp, rte, tab, _, cs = C.side_update(sums, scaler, colsum, 0.3, 0.3 + k * 0.3, 0.3)
    tab_d, cs_d = C.side_derive(shp, rte)
    assert torch.equal(tab, tab_d) and torch.equal(cs, cs_d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,chunk,k", CASES)
@pytest.mark.parametrize("full_llk", [False, True])
def test_ell_llk_kernel_vs_plain(cuda, dtype, chunk, k, full_llk):
    from hpfrec_tpu_torch.ops import metrics as M

    nU, nI = 300, 120
    y, iu, ii = _counts(nU, nI, 4000, seed=7)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    lay = _layout(y, iu, ii, nU, nI, npdt, cuda, chunk)
    th = _tables(nU, k, dtype, cuda, 8) / k
    be = _tables(nI, k, dtype, cuda, 9)
    got = M.ell_llk_rmse_sums(th, be, lay, full_llk).sum(0)
    ref = torch.cat([M._bucket_llk_plain(th, be, bk.rows, bk.cols, bk.vals,
                                         bk.col_off, full_llk)
                     for bk in lay.buckets]).sum(0)
    torch.testing.assert_close(got, ref, rtol=TOL[dtype]["rtol"], atol=1e-9)


@pytest.mark.gpu
def test_kernel_errors_raise(cuda):
    from hpfrec_tpu_torch.ops import cavi as C

    x = torch.ones((4, 300), device=cuda)  # k above the kernels' 256
    with pytest.raises(ValueError, match="k=300"):
        C.side_derive(x, x)
    with pytest.raises(TypeError):
        C.side_derive(x.half(), x.half())


def test_launch_counters_stay_zero_on_cpu():
    """On CPU tensors every wrapper takes its plain version: no launch."""
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M

    wrappers = [E.bucket_phi_sums, E.segment_table_sums, C.side_update,
                C.side_derive, M.bucket_llk_parts]
    before = [w.launches for w in wrappers]
    y, iu, ii = _counts(40, 30, 300, seed=3)
    lay = _layout(y, iu, ii, 40, 30, np.float32, "cpu")
    t = _tables(40, 5, torch.float32, "cpu", 1)
    b = _tables(30, 5, torch.float32, "cpu", 2)
    su = E.ell_phi_sums(t, b, lay)
    C.side_update(su, t[:, :1], b[:1], 0.3, 1.8, 0.3)
    C.side_derive(t, t + 1)
    M.ell_llk_rmse_sums(t, b, lay)
    assert [w.launches for w in wrappers] == before
