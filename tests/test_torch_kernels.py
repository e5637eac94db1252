"""Each CUDA kernel of hpfrec_tpu_torch against its plain PyTorch version
on the card, in float32 and float64, on small layouts that cover split
rows, tiled (column-offset) buckets and zero-degree rows, SVI batches
whose rows span many of K7's 256-slot chunks on both sides, the whole-stream
phi sums of the blocked-COO engine (K7c), the bfloat16-table forms of K1
and K3, K3's pad-row form (the table-sharded engine's), top-n ranking
(K6) with ties, fully masked rows and every size class of n, the fold-in
loop (K10) and the pair reductions (K11).

The ``gpu`` tests skip without a CUDA device; the card runs them with
``python -m pytest tests/test_torch_kernels.py -q --noconftest``
(``--noconftest``: the suite's conftest imports jax, which the port does
not need).  Tolerances: f32 rtol 2e-5 / atol 1e-6 (kernel and plain
version sum the k products and the w slots in another order; float32
digamma differs by a few ulps), f64 rtol 1e-11 / atol 1e-13.  K6 is held
to exact equality of indices and values on integer-valued tables (every
score exact in either dtype, with many ties) and on float64 tables.
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


def _blocked(y, iu, ii, dtype, device, block_size=None):
    from hpfrec_tpu_torch.ops.cavi import device_blocked_coo

    return device_blocked_coo(y.astype(dtype), iu, ii, device, block_size)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("full_llk", [False, True])
@pytest.mark.parametrize("k", [7, 50, 200])
def test_coo_llk_kernel_vs_plain(cuda, dtype, full_llk, k):
    """K5 over blocked COO with padding (block 1000 over 5003 triplets)."""
    from hpfrec_tpu_torch.ops import metrics as M

    y, iu, ii = _counts(300, 120, 6000, seed=17)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    data = _blocked(y[:5003], iu[:5003], ii[:5003], npdt, cuda, block_size=1000)
    th = _tables(300, k, dtype, cuda, 8) / k
    be = _tables(120, k, dtype, cuda, 9)
    got = M.llk_rmse_sums(th, be, data, full_llk)
    ref = torch.cat([M._coo_llk_plain(th, be, data.y[b], data.ix_u[b], data.ix_i[b], full_llk)
                     for b in range(data.y.shape[0])])
    torch.testing.assert_close(got.sum(0), ref.sum(0), rtol=TOL[dtype]["rtol"], atol=1e-9)
    assert torch.equal(M.llk_rmse_sums(th, be, data, full_llk), got)


def _csr_side(n_rows, n_cols, degrees, hot, seed):
    """CSR arrays with the given row degrees; a share of each row's slots
    goes to the other-side id ``hot`` (duplicates within a row)."""
    rng = np.random.default_rng(seed)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    nnz = int(indptr[-1])
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    cols[rng.random(nnz) < 0.4] = hot
    y = (rng.poisson(2.0, nnz) + 1).astype(np.float64)
    return indptr, cols, y


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_epoch_gather_kernel_vs_plain(cuda, dtype):
    """K9 is a gather: the kernel's stream equals the plain one bit for bit,
    zero-degree rows included."""
    from hpfrec_tpu_torch.ops import svi as S

    degrees = np.random.default_rng(2).integers(0, 40, 500)
    degrees[[3, 17]] = 0
    degrees[9] = 3000
    indptr, cols, y = _csr_side(500, 70, degrees, 5, seed=3)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    side = S.epoch_side(indptr, cols, y, npdt, cuda)
    perm = np.random.default_rng(4).permutation(500)
    offsets = torch.from_numpy(S.epoch_offsets(side.deg, perm).astype(np.int32)).to(cuda)
    perm_d = torch.from_numpy(perm.astype(np.int32)).to(cuda)
    got = S.build_epoch_buffers(side.y, side.cols, side.indptr, perm_d, offsets)
    ref = S._build_epoch_buffers_plain(side.y, side.cols, side.indptr, perm_d, offsets)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _batch(n_loc, n_oth, dtype, device, seed, long_row=1500):
    """One batch of an epoch: 35 of n_loc local rows, one of them with
    ``long_row`` slots, 40% of all slots on other-side id 3."""
    from hpfrec_tpu_torch.ops import svi as S

    rng = np.random.default_rng(seed)
    degrees = rng.integers(0, 25, n_loc)
    degrees[4] = long_row
    degrees[6] = 0
    indptr, cols, y = _csr_side(n_loc, n_oth, degrees, 3, seed + 1)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    side = S.epoch_side(indptr, cols, y, npdt, device)
    rest = rng.permutation(n_loc)
    rest = rest[(rest != 4) & (rest != 6)]
    perm = np.concatenate([rest[:17], [4, 6], rest[17:]])
    off_h = S.epoch_offsets(side.deg, perm)
    perm_d = torch.from_numpy(perm.astype(np.int32)).to(device)
    off_d = torch.from_numpy(off_h.astype(np.int32)).to(device)
    e_y, e_row, e_col = S.build_epoch_buffers(side.y, side.cols, side.indptr, perm_d, off_d)
    r0, r1 = 5, 40
    s, e = int(off_h[r0]), int(off_h[r1])
    return (e_y[s:e], e_row[s:e], e_col[s:e], off_d[r0:r1 + 1], s, perm_d[r0:r1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("long_row", [1500, 256, 0])
@pytest.mark.parametrize("k", [8, 50, 200])
def test_batch_phi_sums_kernel_vs_plain(cuda, dtype, long_row, k):
    """K7 on a batch with a local row over many chunks (or exactly one, or
    none), an other-side id that takes 40% of the slots, duplicates, and a
    zero-degree batch row; deterministic."""
    from hpfrec_tpu_torch.ops import svi as S

    n_loc, n_oth = 60, 45
    y, rows, cols, bounds, base, seg_rows = _batch(n_loc, n_oth, dtype, cuda, 5, long_row)
    t_loc = _tables(n_loc, k, dtype, cuda, 6)
    t_oth = _tables(n_oth, k, dtype, cuda, 7)
    got = S.batch_phi_sums(t_loc, t_oth, y, rows, cols, bounds, base, seg_rows)
    ref = S._batch_phi_sums_plain(t_loc, t_oth, y, rows, cols)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], **TOL[dtype])
    torch.testing.assert_close(got[1], ref[1], **TOL[dtype])
    assert torch.equal(got[2], ref[2])
    again = S.batch_phi_sums(t_loc, t_oth, y, rows, cols, bounds, base, seg_rows)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.gpu
def test_batch_phi_sums_empty_batch(cuda):
    from hpfrec_tpu_torch.ops import svi as S

    t_loc = _tables(10, 8, torch.float32, cuda, 1)
    t_oth = _tables(12, 8, torch.float32, cuda, 2)
    e_i = torch.zeros(0, dtype=torch.int32, device=cuda)
    bounds = torch.full((3,), 7, dtype=torch.int32, device=cuda)
    seg = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    s_loc, s_oth, omask = S.batch_phi_sums(t_loc, t_oth, torch.zeros(0, device=cuda), e_i,
                                           e_i, bounds, 7, seg)
    assert not bool(omask.any()) and not bool(s_loc.any()) and not bool(s_oth.any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("user_side", [True, False])
@pytest.mark.parametrize("blend_all", [False, True])
@pytest.mark.parametrize("k", [8, 50, 256])
def test_svi_update_kernel_vs_plain(cuda, dtype, user_side, blend_all, k):
    from hpfrec_tpu_torch.models.state import Hyperparams, VariationalState
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import svi as S

    nU, nI = 700, 300
    hp = Hyperparams(k=k)
    st = VariationalState(_tables(nU, k, dtype, cuda, 1) + 0.3, _tables(nU, k, dtype, cuda, 2) * 40,
                          _tables(nI, k, dtype, cuda, 3) + 0.3, _tables(nI, k, dtype, cuda, 4) * 40,
                          _tables(nU, 1, dtype, cuda, 5) + 1, _tables(nI, 1, dtype, cuda, 6) + 1)
    rng = np.random.default_rng(8)
    umask = torch.from_numpy(rng.random((nU, 1)) < 0.3).to(cuda)
    imask = torch.from_numpy(rng.random((nI, 1)) < 0.5).to(cuda)
    su = _tables(nU, k, dtype, cuda, 9) * umask * 5
    si = _tables(nI, k, dtype, cuda, 10) * imask * 5
    args = (su, si, umask, imask, 0.41, 7.5, hp, user_side, blend_all)
    colsum_global = C.side_derive(*((st.L_shp, st.L_rte) if user_side
                                    else (st.G_shp, st.G_rte)))[1]
    got = S.svi_update(st, *args, colsum_global)
    ref = S._svi_update_math(st, *args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **TOL[dtype])
    assert all(torch.equal(a, b) for a, b in zip(S.svi_update(st, *args, colsum_global), got))


@pytest.mark.gpu
def test_row_mask_kernel(cuda):
    from hpfrec_tpu_torch.ops import svi as S

    rows = torch.tensor([5, 0, 9, 5, 2], dtype=torch.int32)
    assert torch.equal(S.build_row_mask(11, rows.to(cuda)).cpu(), S.build_row_mask(11, rows))


# ---- K7c and the bfloat16 forms of K1 and K3 ----------------------------

def _coo(nU, nI, nnz, dtype, device, seed, block_size=None):
    """A fit's COO stream: user-sorted triplets (user 0's run first), items
    Zipf-skewed so item 0's run spans many 256-slot chunks, blocked with a
    padded tail when ``block_size`` does not divide nnz."""
    from hpfrec_tpu_torch.ops.cavi import coo_stream
    from hpfrec_tpu_torch.utils.data import process_data

    y, iu, ii = _counts(nU, nI, nnz, seed)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    pdata = process_data(np.column_stack([iu, ii, y]), "maxiter", False, npdt)
    return pdata, coo_stream(pdata, device, block_size)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 50, 200])
def test_coo_phi_sums_kernel_vs_plain(cuda, dtype, k):
    """K7c over a whole stream with a padded tail, users without triplets
    and an item whose run crosses many chunks; deterministic."""
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops.svi import phi_sums_tables

    pdata, coo = _coo(5000, 150, 40000, dtype, cuda, seed=21, block_size=1000)
    assert coo.data.y.numel() > coo.nnz and int(pdata.ix_u[0]) == 0
    assert np.bincount(pdata.ix_i).max() > 10 * 256
    t = _tables(pdata.nusers + 2, k, dtype, cuda, 1)  # two users with no triplets
    b = _tables(pdata.nitems, k, dtype, cuda, 2)
    coo = coo._replace(user_bounds=torch.cat([coo.user_bounds, coo.user_bounds[-1:].repeat(2)]))
    su, si = C.coo_phi_sums(t, b, coo)
    ref_u, ref_i = phi_sums_tables(t, b, *coo.flat())
    torch.cuda.synchronize()
    torch.testing.assert_close(su, ref_u, **TOL[dtype])
    torch.testing.assert_close(si, ref_i, **TOL[dtype])
    assert not bool(su[-2:].any())
    again = C.coo_phi_sums(t, b, coo)
    assert torch.equal(again[0], su) and torch.equal(again[1], si)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,chunk,k", CASES)
def test_ell_phi_sums_bf16_kernel_vs_plain(cuda, dtype, chunk, k):
    """K1 on bfloat16 tables (vals in the state dtype): float32 sums; K2
    reassembles them in float32 and writes the state dtype."""
    from hpfrec_tpu_torch.ops import ell as E

    nU, nI = 300, 120
    y, iu, ii = _counts(nU, nI, 4000, seed=1)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    lay = _layout(y, iu, ii, nU + 3, nI, npdt, cuda, chunk)
    t = _tables(nU + 3, k, dtype, cuda, 2).to(torch.bfloat16)
    b = _tables(nI, k, dtype, cuda, 3).to(torch.bfloat16)
    seg = E.all_bucket_sums(t, b, lay)
    assert seg.dtype == torch.float32
    ref = torch.cat([E._bucket_phi_sums_plain(t, b, bk.rows, bk.cols, bk.vals, bk.col_off)
                     for bk in lay.buckets])
    torch.testing.assert_close(seg, ref, **TOL[torch.float32])
    out = E.segment_table_sums(seg, lay, dtype)
    assert out.dtype == dtype
    torch.testing.assert_close(out, E._segment_table_sums_plain(seg, lay).to(dtype),
                               **TOL[torch.float32])
    assert torch.equal(E.segment_table_sums(E.all_bucket_sums(t, b, lay), lay, dtype), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 50, 256])
def test_table_update_bf16_kernel_vs_plain(cuda, dtype, k):
    """K3 with a bfloat16 tab: shp, rte, scaler and colsum as in the state
    dtype form, and tab bit-equal to the state-dtype kernel's tab rounded
    to bfloat16 (float64 through float32, as PyTorch rounds it); against
    the plain version within one bfloat16 step (2^-7 relative at most:
    the two exps differ by a few ulps, which can straddle a rounding
    boundary)."""
    from hpfrec_tpu_torch.ops import cavi as C

    n = 5000
    sums = _tables(n, k, dtype, cuda, 4) * 30
    scaler = _tables(n, 1, dtype, cuda, 5) + 1
    colsum = _tables(1, k, dtype, cuda, 6) * 100
    args = (sums, scaler, colsum, 0.3, 0.3 + k * 0.3, 0.3)
    got = C.side_update(*args, torch.bfloat16)
    full = C.side_update(*args)
    ref = C._side_update_plain(*args, torch.bfloat16)
    assert got[2].dtype == torch.bfloat16 == ref[2].dtype
    assert torch.equal(got[2], full[2].to(torch.bfloat16))
    torch.testing.assert_close(got[2].float(), ref[2].float(), rtol=2.0 ** -7, atol=0)
    for i in (0, 1, 3, 4):
        assert torch.equal(got[i], full[i])
        torch.testing.assert_close(got[i], ref[i], **TOL[dtype])
    tab, cs = C.side_derive(got[0], got[1], torch.bfloat16)
    assert torch.equal(tab, got[2]) and torch.equal(cs, got[4])


@pytest.mark.gpu
@pytest.mark.parametrize("tab_dtype", [None, torch.bfloat16], ids=["state", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 50, 256])
def test_table_update_pad_rows_kernel_vs_plain(cuda, dtype, tab_dtype, k):
    """K3's pad-row form (``n_real``) against its plain twin.  The real
    rows equal the update form's on those rows bit for bit; the padding
    rows (entering with sums 0 and scaler 0, as the table-sharded engine
    keeps them) write rate +inf, scaler 0, and a tab and mean of exactly
    +0.0 (``k_shp / 0``, ``logf(inf)`` and the non-finite rowmax guard)."""
    from hpfrec_tpu_torch.ops import cavi as C

    n, n_real = 5000, 4993
    sums = _tables(n, k, dtype, cuda, 4) * 30
    scaler = _tables(n, 1, dtype, cuda, 5) + 1
    colsum = _tables(1, k, dtype, cuda, 6) * 100
    sums[n_real:], scaler[n_real:] = 0, 0
    args = (0.3, 0.3 + k * 0.3, 0.3, tab_dtype)
    got = C.side_update(sums, scaler, colsum, *args, n_real=n_real)
    ref = C._side_update_plain(sums, scaler, colsum, *args, n_real)
    real = C.side_update(sums[:n_real], scaler[:n_real], colsum, *args)
    for i in (0, 1, 2, 3):
        assert torch.equal(got[i][:n_real], real[i])
    torch.testing.assert_close(got[4], real[4], **TOL[dtype])
    for i in (0, 1, 3, 4):
        torch.testing.assert_close(got[i], ref[i], **TOL[dtype])
    if tab_dtype is None:
        torch.testing.assert_close(got[2], ref[2], **TOL[dtype])
    else:
        torch.testing.assert_close(got[2].float(), ref[2].float(), rtol=2.0 ** -7, atol=0)
    shp, rte, tab, scaler_new, _ = got
    assert torch.isinf(rte[n_real:]).all() and not scaler_new[n_real:].any()
    for zero in (shp[n_real:] / rte[n_real:], tab[n_real:]):
        assert not zero.any() and not torch.signbit(zero).any()


@pytest.mark.gpu
def test_table_bf16_store_rounds_float64_through_float32(cuda):
    """An exp-table entry just above a bfloat16 midpoint: one direct
    float64 rounding would give 0.5 + 2^-8, the store gives 0.5."""
    from hpfrec_tpu_torch.ops import cavi as C

    above = 0.5 + 2.0 ** -9 + 2.0 ** -31
    shp = torch.full((1, 2), 3.0, dtype=torch.float64, device=cuda)
    rte = torch.tensor([[2.0, 2.0 / above]], dtype=torch.float64, device=cuda)
    tab = C.side_derive(shp, rte, torch.bfloat16)[0]
    assert tab.float().cpu().tolist() == [[1.0, 0.5]]
    assert torch.equal(tab.cpu(), C._side_derive_plain(shp.cpu(), rte.cpu(), torch.bfloat16)[0])


def test_launch_counters_stay_zero_on_cpu():
    """On CPU tensors every wrapper takes its plain version: no launch."""
    from hpfrec_tpu_torch.models.state import Hyperparams, VariationalState
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M
    from hpfrec_tpu_torch.ops import svi as S
    from hpfrec_tpu_torch.ops import topk as T

    wrappers = [E.bucket_phi_sums, E.segment_table_sums, C.side_update,
                C.side_derive, M.bucket_llk_parts, M.llk_rmse_sums,
                S.build_epoch_buffers, S.batch_phi_sums, S.build_row_mask, S.svi_update,
                T.topn_rows, S.user_factors_loop, M.predict_pairs, M.theta_diff_norm,
                M.rowsum_dot_rows, C.coo_phi_sums, C.colsum_finish]
    counts = lambda: [(w.launches, getattr(w, "launches_bf16", 0),  # noqa: E731
                       getattr(w, "launches_pad", 0), getattr(w, "launches_pad_bf16", 0))
                      for w in wrappers]
    before = counts()
    y, iu, ii = _counts(40, 30, 300, seed=3)
    lay = _layout(y, iu, ii, 40, 30, np.float32, "cpu")
    t = _tables(40, 5, torch.float32, "cpu", 1)
    b = _tables(30, 5, torch.float32, "cpu", 2)
    su = E.ell_phi_sums(t, b, lay)
    C.side_update(su, t[:, :1], b[:1], 0.3, 1.8, 0.3)
    C.side_derive(t, t + 1)
    C.side_derive(t, t + 1, torch.bfloat16)
    C.side_update(su, t[:, :1], b[:1], 0.3, 1.8, 0.3, torch.bfloat16)
    C.side_update(su, t[:, :1], b[:1], 0.3, 1.8, 0.3, None, 30)
    C.side_update(su, t[:, :1], b[:1], 0.3, 1.8, 0.3, torch.bfloat16, 30)
    C.colsum_finish(t[:3])
    E.ell_phi_sums(t.bfloat16(), b.bfloat16(), lay, torch.float64)
    C.coo_phi_sums(t[:, :5], b, _coo(40, 30, 300, torch.float32, "cpu", seed=3)[1])
    M.ell_llk_rmse_sums(t, b, lay)
    M.llk_rmse_sums(t, b, _blocked(y, iu, ii, np.float32, "cpu"))
    batch = _batch(40, 30, torch.float32, "cpu", 5, long_row=300)
    s_loc, s_oth, omask = S.batch_phi_sums(t, b, *batch)
    lmask = S.build_row_mask(40, batch[-1])
    st = VariationalState(t, t + 1, b, b + 1, t[:, :1], b[:, :1])
    S.svi_update(st, s_loc, s_oth, lmask, omask, 0.5, 2.0, Hyperparams(k=5), True, False,
                 C.side_derive(b, b + 1)[1])
    T.topn_batch(t.numpy(), b, np.arange(10), 3)
    S.user_factors_loop(b[:4, 0], b[:4], b[0], t[0], t[0] + 1, t[1] + 2, 1.3,
                        Hyperparams(k=5), 5, 1e-3)
    pairs = torch.arange(20, dtype=torch.int32)
    M.predict_pairs(t, b, pairs, pairs)
    M.sum_pairs_prediction(t, b, pairs, pairs)
    M.theta_diff_norm(t, t + 1)
    M.rowsum_dot_rows(t, b, pairs, pairs)
    assert counts() == before


# ---- K6: top-n ----------------------------------------------------------

def _int_tables(b, nI, k, dtype, device, seed):
    """Integer-valued tables: every score is exact in float32 and float64,
    and many are equal (ties)."""
    rng = np.random.default_rng(seed)
    th = torch.from_numpy(rng.integers(0, 4, (b, k)).astype(np.float64)).to(device, dtype)
    be = torch.from_numpy(rng.integers(0, 4, (nI, k)).astype(np.float64)).to(device, dtype)
    return th, be


def _seen_pairs(b, nI, per_row, device, seed, full_row=None):
    rng = np.random.default_rng(seed)
    rows, items = [], []
    for r in range(b):
        its = np.arange(nI) if r == full_row else rng.choice(nI, per_row, replace=False)
        rows.append(np.full(len(its), r))
        items.append(its)
    return (torch.from_numpy(np.concatenate(rows).astype(np.int32)).to(device),
            torch.from_numpy(np.concatenate(items).astype(np.int32)).to(device))


TOPN_CASES = [  # dtype, b, nI, k, n, masked
    (torch.float32, 70, 3000, 50, 10, True),
    (torch.float64, 70, 3000, 50, 10, True),
    (torch.float32, 5, 3000, 50, 1, False),
    (torch.float32, 4, 3000, 8, 2000, True),   # n > 1024: shared-memory sort
    (torch.float32, 3, 6000, 20, 5000, True),  # n > 4096: global-memory sort
    (torch.float64, 3, 777, 50, 777, True),    # n = nI
    (torch.float32, 130, 1000, 256, 16, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,nI,k,n,masked", TOPN_CASES)
def test_topn_kernel_vs_plain(cuda, dtype, b, nI, k, n, masked):
    """K6 against its plain version (matrix product, scatter, stable sort):
    the same indices and values, ties in lax.top_k's order, and row 0 fully
    masked (all -inf: indices 0..n-1); bit-identical across two runs."""
    from hpfrec_tpu_torch.ops import topk as T

    th, be = _int_tables(b, nI, k, dtype, cuda, 3)
    rows = items = None
    if masked:
        rows, items = _seen_pairs(b, nI, min(40, nI // 3), cuda, 4, full_row=0)
    got = T.topn_rows(th, be, rows, items, n)
    ref = T._topn_rows_plain(th, be, rows, items, n)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])
    if masked:
        assert torch.equal(got[1][0].cpu(), torch.arange(n, dtype=torch.int32))
    again = T.topn_rows(th, be, rows, items, n)
    assert all(torch.equal(a, c) for a, c in zip(again, got))


@pytest.mark.gpu
def test_topn_mask_kernel_drops_pairs_outside_the_scores(cuda):
    """Pairs outside the (b, nI) scores (negative, or past the chunk's rows
    or the catalog) mask nothing on the card, as in the plain version."""
    from hpfrec_tpu_torch.ops import topk as T

    th, be = _int_tables(3, 300, 8, torch.float32, cuda, 8)
    rows = torch.tensor([-1, 3, 0, 1, 1, 2, 0], dtype=torch.int32, device=cuda)
    items = torch.tensor([0, 0, -1, 300, 7, 2**31 - 1, -2**31], dtype=torch.int32,
                         device=cuda)
    got = T.topn_rows(th, be, rows, items, 300)
    ref = T._topn_rows_plain(th, be, rows, items, 300)
    only = T.topn_rows(th, be, rows[4:5], items[4:5], 300)
    assert all(torch.equal(g, r) and torch.equal(g, o) for g, r, o in zip(got, ref, only))


@pytest.mark.gpu
def test_topn_kernel_float64_random(cuda):
    """Random float64 tables: the kernel's float64 sums round to the same
    float32 scores as the plain product's, so the rankings are equal."""
    from hpfrec_tpu_torch.ops import topk as T

    rng = np.random.default_rng(5)
    th = torch.from_numpy(rng.random((64, 50))).to(cuda)
    be = torch.from_numpy(rng.random((5000, 50))).to(cuda)
    rows, items = _seen_pairs(64, 5000, 100, cuda, 6)
    got = T.topn_rows(th, be, rows, items, 300)
    ref = T._topn_rows_plain(th, be, rows, items, 300)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_topn_batch_card_equals_cpu(cuda, dtype):
    """topn_batch on the card (K6, chunks, host backfill) equals its CPU
    run, a user whose unseen set is smaller than n included."""
    from hpfrec_tpu_torch.ops import topk as T

    nU, nI, k, n = 300, 500, 16, 12
    rng = np.random.default_rng(7)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    Theta = rng.integers(0, 5, (nU, k)).astype(npdt)
    Beta = rng.integers(0, 5, (nI, k)).astype(npdt)
    counts = rng.integers(0, 30, nU)
    counts[5] = nI - 4
    indptr = np.concatenate([[0], np.cumsum(counts)])
    seen = np.concatenate([rng.choice(nI, c, replace=False) for c in counts]).astype(np.int32)
    users = rng.integers(0, nU, 257)
    users[[0, 100]] = 5
    kw = dict(seen_indptr=indptr[:-1], seen_indices=seen, n_seen=counts)
    got = T.topn_batch(Theta, torch.from_numpy(Beta).to(cuda), users, n, **kw)
    ref = T.topn_batch(Theta, torch.from_numpy(Beta), users, n, **kw)
    np.testing.assert_array_equal(got, ref)


# ---- K10: fold-in ---------------------------------------------------------

def _fold_in_inputs(P, k, dtype, device, seed):
    from scipy.special import digamma

    rng = np.random.default_rng(seed)
    L_shp = 0.3 + rng.random((P, k))
    L_rte = 0.3 + rng.random((P, k))
    y = (rng.poisson(2, P) + 1).astype(np.float64)
    theta0 = rng.gamma(0.3, 1.0, k)
    g_rte0 = rng.gamma(0.3, 1 / 0.3, 1) + 3.0 + rng.random(k)
    g_shp0 = g_rte0 * theta0 * rng.uniform(0.85, 1.15, k)
    arrays = (y, digamma(L_shp) - np.log(L_rte), 3.0 + rng.random(k), theta0, g_shp0, g_rte0)
    return [torch.from_numpy(a).to(device, dtype) for a in arrays], 1.0 + theta0.sum()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,k,maxiter,stop_thr", [
    (1, 50, 10, 1e-3), (3000, 50, 25, 1e-3), (12, 50, 10, 1e9),
    (40, 7, 6, 1e-30), (40, 256, 8, 1e-4)])
def test_fold_in_kernel_vs_plain(cuda, dtype, P, k, maxiter, stop_thr):
    """K10 against its plain loop on the same inputs: P = 1, a heavy user
    (3000 items), the stop at iteration 1 (stop_thr 1e9) and at maxiter
    (stop_thr 1e-30); the same iteration count, bit-identical reruns."""
    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import svi as S

    args, k_rte0 = _fold_in_inputs(P, k, dtype, cuda, P + k)
    hp = Hyperparams(k=k)
    got = S.user_factors_loop(*args, k_rte0, hp, maxiter, stop_thr)
    ref = S._user_factors_loop_plain(*args, k_rte0, hp, maxiter, stop_thr)
    assert got[4] == ref[4]
    if stop_thr == 1e9:
        assert got[4] == 1
    if stop_thr == 1e-30:
        assert got[4] == maxiter
    tol = dict(rtol=2e-5, atol=1e-6) if dtype == torch.float32 else TOL[dtype]
    for g, r in zip(got[:4], ref[:4]):
        torch.testing.assert_close(g, r, **tol)
    again = S.user_factors_loop(*args, k_rte0, hp, maxiter, stop_thr)
    assert all(torch.equal(a, c) for a, c in zip(again[:4], got[:4]))


# ---- K11: pair and table reductions ------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [7, 50, 256])
@pytest.mark.parametrize("n", [1, 5003, 300_000])
def test_pair_ops_kernels_vs_plain(cuda, dtype, k, n):
    from hpfrec_tpu_torch.ops import metrics as M

    rng = np.random.default_rng(n + k)
    th = _tables(400, k, dtype, cuda, 1) / k
    be = _tables(300, k, dtype, cuda, 2)
    iu = torch.from_numpy(rng.integers(0, 400, n).astype(np.int32)).to(cuda)
    ii = torch.from_numpy(rng.integers(0, 300, n).astype(np.int32)).to(cuda)
    got = M.predict_pairs(th, be, iu, ii)
    torch.testing.assert_close(got, M._pairs_plain(th, be, iu, ii), **TOL[dtype])
    assert torch.equal(M.predict_pairs(th, be, iu, ii), got)
    rt = TOL[dtype]["rtol"] * 10
    s = M.sum_pairs_prediction(th, be, iu, ii)
    np.testing.assert_allclose(s, float(M._pairs_plain(th, be, iu, ii).double().sum()), rtol=rt)
    assert M.sum_pairs_prediction(th, be, iu, ii) == s
    r = M.rowsum_dot_rows(th, be, iu, ii)
    ref = float(np.float32(torch.dot(th[iu.long()].double().sum(0),
                                     be[ii.long()].double().sum(0)).item()))
    np.testing.assert_allclose(r, ref, rtol=1e-6)
    assert M.rowsum_dot_rows(th, be, iu, ii) == r
    th2 = th + _tables(400, k, dtype, cuda, 3) * 1e-3
    d = M.theta_diff_norm(th2, th)
    np.testing.assert_allclose(d, float(torch.linalg.norm((th2 - th).double())), rtol=rt)
    assert M.theta_diff_norm(th2, th) == d
