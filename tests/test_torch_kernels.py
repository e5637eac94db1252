"""Each CUDA kernel of hpfrec_tpu_torch against its plain PyTorch version
on the card, in float32 and float64, on small layouts that cover split
rows, tiled (column-offset) buckets and zero-degree rows, SVI batches
whose rows span many of K7's 256-slot chunks on both sides (runs past two
groups of 64 chunks, an other-side id holding most slots, other-side rows
with none), the whole-stream phi sums of the blocked-COO engine (K7c, with
user runs that start and end everywhere in its 32-slot groups), K1's
padding from the middle of a 32-slot group, padding-only segments and
non-positive dots (its one launch a side bit-equal to a launch a bucket),
its launch a ring offset on the table-sharded layouts (bit-equal to a
launch a bucket),
the bfloat16-table forms of K1 and K3, K3's pad-row form (the table-sharded
engine's), top-n ranking (K6) with ties (across the fused path's item
ranges too), fully masked rows, rows with fewer unseen items than n and
every size class of n on both paths, the fused path bit-equal to the
three-kernel path, the large-n select on crowded, tied and -inf rows
against a stable sort, the fold-in loop (K10, also from and to host
arrays as HPF calls it), the pair reductions (K11; rowsum_dot_rows'
device finish also over blocks past the last pair) and the seeded MT19937
start drawn on the card (K14): the six tensors of ``initialize_state`` on
the card equal to the CPU's numpy draw bit for bit, in float32 and
float64, for seed 123 and a pinned None / 0, at k = 1 and 7, tables under
one twist, ending in mid-step and mid-twist, odd value counts in float64,
and at the TasteProfile shape (1,019,318 x 376,768 x 50, float32); and a
CUDA fit that takes the card's start, with factors equal to the same fit
from the host's draw.

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


# ---- K3's tiled pass and K4's walk ---------------------------------------

def _k3_inputs(n, k, dtype, device, seed):
    """Phi sums, row scalers and the other side's colsum of an (n, k) side,
    with shapes from ~1e-4 (zero sums) to ~1e7 (large sums) so that the
    digamma sees both ends, and rows near its root."""
    rng = np.random.default_rng(seed)
    sums = rng.random((n, k)) * 30
    sums[::5] *= 1e-3
    sums[1::7] = 0.0
    sums[2::11] = rng.random((len(sums[2::11]), k)) * 1e7
    sums[3::13] = 1.1616 + rng.random((len(sums[3::13]), k)) * 0.6  # shp 1.46 +- 0.3
    scaler = rng.random((n, 1)) + 1.0
    colsum = rng.random((1, k)) * 100
    return [torch.from_numpy(a).to(device, dtype) for a in (sums, scaler, colsum)]


def _k3_tab_close(got, ref, tab_dtype, dtype):
    if tab_dtype is None:
        torch.testing.assert_close(got, ref, **TOL[dtype])
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2.0 ** -7, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("tab_dtype", [None, torch.bfloat16], ids=["state", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 50, 64, 155, 201, 255, 256])
def test_table_tiles_every_form_vs_plain(cuda, dtype, tab_dtype, k):
    """K3's update, derive and pad-row forms against their plain versions on
    n rows that are no multiple of the tile (a partial last tile and a
    partial last block; at odd k above 128 in float64 the tiles take more
    than 48 KB of shared memory), shapes from 1e-4 to 1e7 (the digamma's ends), rows
    near the digamma's root and an all -inf row (rte = +inf: the
    non-finite rowmax guard); every output twice with the same bits, the
    bfloat16 tab bit-equal to the state-dtype tab rounded."""
    from hpfrec_tpu_torch.ops import cavi as C

    rows, _ = C._k3_grid(1, k, torch.tensor([], dtype=dtype).element_size())
    n = rows * C._K3_TILES_PER_BLOCK * 3 + rows + 3
    sums, scaler, colsum = _k3_inputs(n, k, dtype, cuda, 21)
    args = (sums, scaler, colsum, 0.3, 0.3 + k * 0.3, 0.3, tab_dtype)
    got = C.side_update(*args)
    ref = C._side_update_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, C.side_update(*args)))
    for i in (0, 1, 3, 4):
        torch.testing.assert_close(got[i], ref[i], **TOL[dtype])
    _k3_tab_close(got[2], ref[2], tab_dtype, dtype)
    if tab_dtype is not None:
        assert torch.equal(got[2], C.side_update(*args[:-1])[2].to(tab_dtype))
    shp, rte = got[0].clone(), got[1].clone()
    shp[5::17, ::3] = 1e-4  # shapes below 1e-3 beside ordinary ones in a row
    rte[7] = float("inf")  # all -inf elog row
    tab, cs = C.side_derive(shp, rte, tab_dtype)
    tab_r, cs_r = C._side_derive_plain(shp, rte, tab_dtype)
    _k3_tab_close(tab, tab_r, tab_dtype, dtype)
    torch.testing.assert_close(cs, cs_r, **TOL[dtype])
    assert not tab[7].any() and not torch.signbit(tab[7].float()).any()
    again = C.side_derive(shp, rte, tab_dtype)
    assert torch.equal(again[0], tab) and torch.equal(again[1], cs)
    n_real = n - rows - 1  # padding from inside a tile to the end
    pad_sums, pad_scaler = sums.clone(), scaler.clone()
    pad_sums[n_real:], pad_scaler[n_real:] = 0, 0
    pargs = (pad_sums, pad_scaler, colsum, 0.3, 0.3 + k * 0.3, 0.3, tab_dtype)
    pad = C.side_update(*pargs, n_real=n_real)
    pad_r = C._side_update_plain(*pargs, n_real)
    for i in (0, 1, 3, 4):
        torch.testing.assert_close(pad[i], pad_r[i], **TOL[dtype])
    _k3_tab_close(pad[2], pad_r[2], tab_dtype, dtype)
    assert torch.isinf(pad[1][n_real:]).all() and not pad[3][n_real:].any()
    assert not pad[2][n_real:].any()


@pytest.mark.parametrize("itemsize", [4, 8])
def test_k3_grid_tiles_are_aligned_and_fixed_by_shapes(itemsize):
    """K3's tiling is a function of (n, k, dtype) alone: rows a tile a
    multiple of 4 with rows * k a multiple of 8 (every tile 16-byte aligned
    in each table, the bfloat16 tab and the row scalers included), at most
    ~8 KB a table a tile, and the blocks that cover n rows in 8-tile
    runs, one block at least."""
    from hpfrec_tpu_torch.ops import cavi as C

    for k in (1, 2, 3, 7, 8, 25, 50, 64, 100, 200, 255, 256):
        rows, blocks = C._k3_grid(1, k, itemsize)
        assert rows % 4 == 0 and rows * k % 8 == 0 and rows <= C._K3_MAX_ROWS
        least = np.lcm(4, 8 // np.gcd(k, 8))  # the fewest rows that keep the alignment
        assert rows * k * itemsize <= C._K3_TILE_BYTES or rows == least
        tile_rows = rows * C._K3_TILES_PER_BLOCK
        for n in (0, 1, rows - 1, rows, tile_rows, tile_rows + 1, 1_019_318):
            assert C._k3_grid(n, k, itemsize) == (rows, max(1, -(-n // tile_rows)))
    assert C._k3_grid(1_019_318, 50, 4) == (40, 3186)


def test_kernel_digamma_on_cpu_is_torch():
    from hpfrec_tpu_torch.ops import cavi as C

    x = torch.logspace(-4, 7, 101, dtype=torch.float64)
    assert torch.equal(C.kernel_digamma(x), torch.special.digamma(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_table_tiles_every_k(cuda, dtype):
    """K3 launches and agrees with its plain version at every k from 1 to
    256 (``MAX_K``), both forms and both tab dtypes, on two full tiles and
    a partial one: every tiling ``_k3_grid`` picks fits the block's shared
    memory."""
    from hpfrec_tpu_torch.ops import cavi as C

    for k in range(1, 257):
        rows, _ = C._k3_grid(1, k, torch.tensor([], dtype=dtype).element_size())
        sums, scaler, colsum = _k3_inputs(2 * rows + 3, k, dtype, cuda, k)
        for tab_dtype in (None, torch.bfloat16):
            args = (sums, scaler, colsum, 0.3, 0.3 + k * 0.3, 0.3, tab_dtype)
            got, ref = C.side_update(*args), C._side_update_plain(*args)
            for i in (0, 1, 3, 4):
                torch.testing.assert_close(got[i], ref[i], **TOL[dtype])
            _k3_tab_close(got[2], ref[2], tab_dtype, dtype)
            tab, cs = C.side_derive(got[0], got[1], tab_dtype)
            tab_r, cs_r = C._side_derive_plain(got[0], got[1], tab_dtype)
            _k3_tab_close(tab, tab_r, tab_dtype, dtype)
            torch.testing.assert_close(cs, cs_r, **TOL[dtype])


def _shifted(t):
    """``t``'s values in a contiguous view that starts one element into a
    fresh buffer: not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("tab_dtype", [None, torch.bfloat16], ids=["state", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [7, 50])
def test_table_tiles_unaligned_views(cuda, dtype, tab_dtype, k):
    """K3 on inputs that are not 16-byte aligned (a row slice starting at an
    odd row, and views one element into a buffer): the kernel's
    one-element copies and stores give the bits of the same values handed
    in as fresh (aligned) tensors."""
    from hpfrec_tpu_torch.ops import cavi as C

    sums, scaler, colsum = _k3_inputs(1201, k, dtype, cuda, 22)
    args = (0.3, 0.3 + k * 0.3, 0.3, tab_dtype)
    for view, sview in ((sums[1:], scaler[1:]), (_shifted(sums), _shifted(scaler))):
        assert view.is_contiguous() and (view.data_ptr() % 16 or sview.data_ptr() % 16
                                         or k * view.element_size() % 16)
        got = C.side_update(view, sview, colsum, *args)
        fresh = C.side_update(view.clone(), sview.clone(), colsum, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, fresh))
        ref = C._side_update_plain(view, sview, colsum, *args)
        for i in (0, 1, 3, 4):
            torch.testing.assert_close(got[i], ref[i], **TOL[dtype])
        _k3_tab_close(got[2], ref[2], tab_dtype, dtype)
    shp, rte = _shifted(fresh[0]), _shifted(fresh[1])
    assert shp.data_ptr() % 16 and rte.data_ptr() % 16
    tab, cs = C.side_derive(shp, rte, tab_dtype)
    assert torch.equal(tab, fresh[2]) and torch.equal(cs, fresh[4])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_digamma_against_scipy(cuda, dtype):
    """The kernels' digamma on a log sweep of [1e-4, 1e7] and around its
    root, against scipy in float64: within 64 ulp of the dtype in float32
    and 256 in float64 (the measured maxima are a few tens; the stepwise
    form it replaced reached ~1e5 ulp at the root), and no worse in its
    maximum and mean than the stepwise form."""
    from scipy import special

    from hpfrec_tpu_torch.ops import cavi as C

    x = np.concatenate([np.logspace(-4, 7, 200_001),
                        1.4616321449683622 + np.linspace(-0.4, 0.4, 20_001)])
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = x.astype(npdt)
    ref = special.digamma(x.astype(np.float64))
    ulp = np.spacing(np.abs(ref).astype(npdt)).astype(np.float64)
    xt = torch.from_numpy(x).to(cuda)
    err = {}
    for stepwise in (False, True):
        got = C.kernel_digamma(xt, stepwise=stepwise).cpu().numpy().astype(np.float64)
        err[stepwise] = np.abs(got - ref) / ulp
    assert err[False].max() <= (64 if dtype == torch.float32 else 256)
    assert err[False].max() <= err[True].max() and err[False].mean() <= err[True].mean()


def _llk_layout(dtype, device):
    """A layout whose buckets run 1, 2, 4 and 8 warps a segment (rows of up
    to 3,000 slots), plus narrow rows and empty rows."""
    rng = np.random.default_rng(12)
    n_cols = 4000
    degrees = np.concatenate([np.repeat([300, 700, 1500, 3000], 6),
                              rng.integers(1, 40, 200), np.zeros(5, np.int64)])
    rows = np.repeat(np.arange(len(degrees)), degrees).astype(np.int32)
    cols = np.concatenate([rng.choice(n_cols, d, replace=False) for d in degrees]).astype(np.int32)
    y = rng.poisson(2.0, len(rows)) + 1.0
    npdt = np.float32 if dtype == torch.float32 else np.float64
    return _layout(y, rows, cols, len(degrees), n_cols, npdt, device, max_width=8192), \
        len(degrees), n_cols


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 50, 200])
@pytest.mark.parametrize("full_llk", [False, True])
def test_ell_llk_walk_vs_plain(cuda, dtype, k, full_llk):
    """K4 bucket by bucket against the plain version, on a layout with 1, 2,
    4 and 8 warps a segment, padding (y = 0) and slots whose yhat is 0 or
    negative (zero and negative Theta rows): a bucket's partials one a
    block, and two runs give the same bits."""
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M

    lay, n_rows, n_cols = _llk_layout(dtype, cuda)
    assert {E._warps_per_segment(b.cols.shape[1]) for b in lay.buckets} == {1, 2, 4, 8}
    assert any(bool((b.vals == 0).any()) for b in lay.buckets)
    th = _tables(n_rows, k, dtype, cuda, 13) / k
    th[::9] = 0.0  # yhat = 0: log(1)
    th[4::9] *= -1.0  # yhat < 0
    be = _tables(n_cols, k, dtype, cuda, 14)
    parts = M.ell_llk_rmse_sums(th, be, lay, full_llk)
    for b in lay.buckets:
        m = b.cols.shape[0]
        got = M.bucket_llk_parts(th, be, b.rows, b.cols, b.vals, b.col_off, full_llk)
        assert got.shape == (-(-m // (8 // E._warps_per_segment(b.cols.shape[1]))), 3)
        ref = M._bucket_llk_plain(th, be, b.rows, b.cols, b.vals, b.col_off, full_llk)
        torch.testing.assert_close(got.sum(0), ref.sum(0), rtol=TOL[dtype]["rtol"], atol=1e-9)
    assert torch.equal(M.ell_llk_rmse_sums(th, be, lay, full_llk), parts)
    ref = torch.cat([M._bucket_llk_plain(th, be, b.rows, b.cols, b.vals, b.col_off, full_llk)
                     for b in lay.buckets]).sum(0)
    torch.testing.assert_close(parts.sum(0), ref, rtol=TOL[dtype]["rtol"], atol=1e-9)


@pytest.mark.gpu
def test_ell_llk_empty_bucket(cuda):
    """K4's one-bucket form on a bucket with no segments, or with segments
    of no slots, gives no partial rows (none left unwritten)."""
    from hpfrec_tpu_torch.ops import metrics as M

    th = _tables(10, 8, torch.float32, cuda, 1)
    be = _tables(12, 8, torch.float32, cuda, 2)
    for m, w in ((0, 4), (3, 0)):
        rows = torch.zeros(m, dtype=torch.int32, device=cuda)
        cols = torch.zeros((m, w), dtype=torch.int32, device=cuda)
        vals = torch.zeros((m, w), dtype=torch.float32, device=cuda)
        assert M.bucket_llk_parts(th, be, rows, cols, vals, 0, False).shape == (0, 3)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("full_llk", [False, True])
@pytest.mark.parametrize("k", [1, 7, 50, 64, 200, 256])
@pytest.mark.parametrize("n", [1, 33, 5003, 300_000])
def test_coo_llk_walk_vs_plain(cuda, dtype, full_llk, k, n):
    """K5 on the pair walk: every lane split (k from 1 to 256, both
    dtypes), streams from one triplet to many blocks' shares (300,000 is
    ~585 blocks of 512), a tenth of the triplets padding (y == 0) anywhere
    in the stream.  One partial row a block of ``_pairs_grid(n)``, their
    sum within TOL of the plain version, the same bits on a second call."""
    from hpfrec_tpu_torch.ops import metrics as M

    rng = np.random.default_rng(n + 3 * k)
    y = (rng.poisson(2.0, n) + 1.0) * (rng.random(n) >= 0.1)
    iu = rng.integers(0, 400, n).astype(np.int32)
    ii = rng.integers(0, 300, n).astype(np.int32)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    data = _blocked(y, iu, ii, npdt, cuda)
    th = _tables(400, k, dtype, cuda, 1) / k
    be = _tables(300, k, dtype, cuda, 2)
    got = M.llk_rmse_sums(th, be, data, full_llk)
    ref = M._coo_llk_plain(th, be, *(a.reshape(-1) for a in data), full_llk)
    torch.cuda.synchronize()
    assert got.shape == (M._pairs_grid(data.y.numel())[1], 3)
    torch.testing.assert_close(got.sum(0), ref.sum(0), rtol=TOL[dtype]["rtol"], atol=1e-9)
    assert torch.equal(M.llk_rmse_sums(th, be, data, full_llk), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coo_llk_all_padding_counts_nothing(cuda, dtype):
    """A stream of padding only (y == 0 everywhere) gives zero partials."""
    from hpfrec_tpu_torch.ops import metrics as M

    n = 20_000
    idx = np.random.default_rng(1).integers(0, 50, n).astype(np.int32)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    data = _blocked(np.zeros(n), idx, idx, npdt, cuda)
    th = _tables(50, 50, dtype, cuda, 1)
    parts = M.llk_rmse_sums(th, th, data, True)
    assert not bool(parts.any())


EPOCH_CASES = ("zero_run", "zero_ends", "one_row", "single_row", "ragged")


def epoch_case(case, seed=0, n_cols=70):
    """CSR arrays ``(indptr, cols, y)`` and a row permutation whose
    permuted row degrees make one of K9's tile edge cases (a tile holds
    2,048 positions and stages 1,024 rows at a time): a run of 5,000
    zero-degree rows inside the stream; zero-degree rows first and last;
    one row holding almost every nonzero; a single row; nnz three tiles
    plus 5.  Every case crosses several tiles."""
    rng = np.random.default_rng(seed)
    if case == "zero_run":
        deg = np.concatenate([rng.integers(1, 9, 600), np.zeros(5000, np.int64),
                              rng.integers(1, 9, 900)])
    elif case == "zero_ends":
        deg = np.concatenate([np.zeros(3000, np.int64), rng.integers(0, 12, 1500),
                              np.zeros(2500, np.int64)])
    elif case == "one_row":
        deg = rng.integers(0, 3, 400)
        deg[137] = 9000
    elif case == "single_row":
        deg = np.array([6001])
    else:
        deg = rng.integers(1, 16, 600)
        deg[-1] += 3 * 2048 + 5 - deg.sum()
    perm = rng.permutation(deg.shape[0])
    row_deg = np.empty_like(deg)
    row_deg[perm] = deg
    indptr = np.zeros(deg.shape[0] + 1, dtype=np.int64)
    np.cumsum(row_deg, out=indptr[1:])
    nnz = int(indptr[-1])
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    y = (rng.poisson(2.0, nnz) + 1).astype(np.float64)
    return indptr, cols, y, perm


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", EPOCH_CASES)
def test_epoch_gather_tile_cases_vs_plain(cuda, dtype, case):
    """K9's tiles at their edges: the kernel's stream equals the plain one
    bit for bit."""
    from hpfrec_tpu_torch.ops import svi as S

    indptr, cols, y, perm = epoch_case(case)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    side = S.epoch_side(indptr, cols, y, npdt, cuda)
    offsets = torch.from_numpy(S.epoch_offsets(side.deg, perm).astype(np.int32)).to(cuda)
    perm_d = torch.from_numpy(perm.astype(np.int32)).to(cuda)
    got = S.build_epoch_buffers(side.y, side.cols, side.indptr, perm_d, offsets)
    ref = S._build_epoch_buffers_plain(side.y, side.cols, side.indptr, perm_d, offsets)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == (len(y),) and torch.equal(g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_epoch_gather_zipf_side_vs_plain(cuda, dtype):
    """K9 over a Zipf side of 30,000 rows and ~1M positions (the head row
    spans dozens of tiles, the tail rows many a tile, some rows empty), from
    input views at an odd offset: equal to the plain stream bit for bit."""
    from hpfrec_tpu_torch.ops import svi as S

    rng = np.random.default_rng(5)
    n = 30_000
    deg = np.floor(150_000 / np.arange(1, n + 1) * rng.random(n) * 2).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    nnz = int(indptr[-1])
    npdt = np.float32 if dtype == torch.float32 else np.float64
    side = S.epoch_side(indptr, rng.integers(0, 900, nnz).astype(np.int32),
                        (rng.poisson(2.0, nnz) + 1.0), npdt, cuda)
    y_off = torch.empty(nnz + 1, dtype=dtype, device=cuda)[1:]
    y_off.copy_(side.y)
    c_off = torch.empty(nnz + 1, dtype=torch.int32, device=cuda)[1:]
    c_off.copy_(side.cols)
    perm = rng.permutation(n)
    offsets = torch.from_numpy(S.epoch_offsets(side.deg, perm).astype(np.int32)).to(cuda)
    perm_d = torch.from_numpy(perm.astype(np.int32)).to(cuda)
    got = S.build_epoch_buffers(y_off, c_off, side.indptr, perm_d, offsets)
    ref = S._build_epoch_buffers_plain(side.y, side.cols, side.indptr, perm_d, offsets)
    torch.cuda.synchronize()
    assert (deg == 0).any() and deg.max() > 20_000
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _csr_side(n_rows, n_cols, degrees, hot, seed, hot_share=0.4):
    """CSR arrays with the given row degrees; a share of each row's slots
    goes to the other-side id ``hot`` (duplicates within a row)."""
    rng = np.random.default_rng(seed)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    nnz = int(indptr[-1])
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    cols[rng.random(nnz) < hot_share] = hot
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


def _batch(n_loc, n_oth, dtype, device, seed, long_row=1500, hot_share=0.4):
    """One batch of an epoch: 35 of n_loc local rows, one of them with
    ``long_row`` slots, ``hot_share`` of all slots on other-side id 3."""
    from hpfrec_tpu_torch.ops import svi as S

    rng = np.random.default_rng(seed)
    degrees = rng.integers(0, 25, n_loc)
    degrees[4] = long_row
    degrees[6] = 0
    indptr, cols, y = _csr_side(n_loc, n_oth, degrees, 3, seed + 1, hot_share)
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
@pytest.mark.parametrize("long_row", [1500, 256, 0, 40_000])
@pytest.mark.parametrize("k", [8, 50, 200])
def test_batch_phi_sums_kernel_vs_plain(cuda, dtype, long_row, k):
    """K7 on a batch with a local row over many chunks (or exactly one, or
    none, or more than two groups of 64 chunks, whose sum goes through the
    second-level partials), an other-side id that takes 40% of the slots,
    duplicates, and a zero-degree batch row; deterministic."""
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 50])
def test_batch_phi_sums_long_runs_and_absent_rows(cuda, dtype, k):
    """K7 where one other-side id holds 90% of the slots (~160 chunks: its
    run's sum goes through second-level partials, as does the 40,000-slot
    local row's) and most other-side rows have no slot (zero sums, mask
    0); repeats bit-identical."""
    from hpfrec_tpu_torch.ops import svi as S

    n_loc, n_oth = 60, 30_000
    y, rows, cols, bounds, base, seg_rows = _batch(n_loc, n_oth, dtype, cuda, 9, 40_000,
                                                   hot_share=0.9)
    hot = int((cols == 3).sum())
    assert hot > 2 * 64 * 256 and int(torch.unique(cols).numel()) < n_oth // 2
    t_loc = _tables(n_loc, k, dtype, cuda, 6)
    t_oth = _tables(n_oth, k, dtype, cuda, 7)
    got = S.batch_phi_sums(t_loc, t_oth, y, rows, cols, bounds, base, seg_rows)
    ref = S._batch_phi_sums_plain(t_loc, t_oth, y, rows, cols)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], **TOL[dtype])
    torch.testing.assert_close(got[1], ref[1], **TOL[dtype])
    assert torch.equal(got[2], ref[2])
    assert not bool(got[1][~got[2][:, 0]].any())
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
    y, iu, ii = _counts(nU, nI, nnz, seed)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    return _coo_of(np.column_stack([iu, ii, y]), npdt, device, block_size)


def _coo_of(triplets, npdt, device, block_size=None):
    """``process_data``'s triplets, and the blocked-COO stream a fit builds
    from them on ``device``."""
    from chip_smoke import user_side
    from hpfrec_tpu_torch.ops.cavi import coo_stream
    from hpfrec_tpu_torch.utils.data import process_data

    pdata = process_data(triplets, "maxiter", False, npdt)
    return pdata, coo_stream(user_side(pdata, device), pdata.nitems, block_size)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 50, 200])
@pytest.mark.parametrize("nU,nnz,longest", [(5000, 40_000, 10 * 256),
                                            (60_000, 400_000, 2 * 64 * 256)])
def test_coo_phi_sums_kernel_vs_plain(cuda, dtype, k, nU, nnz, longest):
    """K7c over a whole stream with a padded tail, users without triplets
    and an item whose run crosses many chunks (in the larger stream more
    than two groups of 64, whose sum goes through the second-level
    partials); deterministic."""
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops.svi import phi_sums_tables

    pdata, coo = _coo(nU, 150, nnz, dtype, cuda, seed=21, block_size=1000)
    assert coo.data.y.numel() > coo.nnz and int(pdata.ix_u[0]) == 0
    assert np.bincount(pdata.ix_i).max() > longest
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


# user degrees that start and end runs everywhere in K7c's 32-slot groups,
# its groups of eight gathers and its 256-slot chunks: single slots, runs
# one short of, at and one past a group or a chunk, and long runs
_RUN_DEGREES = [1, 2, 7, 8, 9, 31, 32, 33, 1, 63, 64, 65, 3, 100, 255, 256, 257, 5, 600, 1,
                1, 1, 30, 34, 2000]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 50, 200])
def test_coo_phi_sums_user_runs_across_groups(cuda, dtype, k):
    """K7c where user runs start and end at every place of the user pass's
    32-slot groups (runs of 1 to 2,000 slots, many crossing a group or a
    chunk) and an item holds 30% of the slots; the scales reach the item
    pass through ``item_pos``; repeats bit-identical."""
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops.svi import phi_sums_tables

    rng = np.random.default_rng(31)
    degrees = np.array(_RUN_DEGREES * 12)
    nU, nI = len(degrees), 700
    iu = np.repeat(np.arange(nU), degrees)
    ii = rng.integers(0, nI, len(iu))
    ii[rng.random(len(iu)) < 0.3] = 5
    y = rng.poisson(2.0, len(iu)) + 1.0
    npdt = np.float32 if dtype == torch.float32 else np.float64
    _, coo = _coo_of(np.column_stack([iu, ii, y]), npdt, cuda)
    assert np.array_equal(np.diff(coo.user_bounds.cpu().numpy()), degrees)
    t = _tables(nU, k, dtype, cuda, 3)
    b = _tables(nI, k, dtype, cuda, 4)
    su, si = C.coo_phi_sums(t, b, coo)
    ref_u, ref_i = phi_sums_tables(t, b, *coo.flat())
    torch.cuda.synchronize()
    torch.testing.assert_close(su, ref_u, **TOL[dtype])
    torch.testing.assert_close(si, ref_i, **TOL[dtype])
    for _ in range(2):
        again = C.coo_phi_sums(t, b, coo)
        assert torch.equal(again[0], su) and torch.equal(again[1], si)


def _edge_bucket(w, n_self, n_other, rng, device, vals_dtype):
    """One (m, w) bucket whose segments are full, padded from the middle of
    a 32-slot group, padded from slot 0 (padding only), one short of full,
    zero-valued between nonzero slots, and of random fill."""
    fills = [w, 13, min(45, w), 0, w - 1, w // 2 + 1] + list(rng.integers(0, w + 1, 10))
    m = len(fills)
    cols = rng.integers(0, n_other, (m, w)).astype(np.int32)
    vals = (rng.poisson(2.0, (m, w)) + 1.0)
    for r, f in enumerate(fills):
        vals[r, f:] = 0
    vals[5, 1:w // 2:3] = 0  # zero-valued slots with nonzero slots after them
    cols[vals == 0] = 0
    rows = rng.integers(0, n_self, m).astype(np.int32)
    to = lambda a, dt: torch.from_numpy(a).to(device, dt)  # noqa: E731
    return to(rows, torch.int32), to(cols, torch.int32), to(vals, vals_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,table", [(torch.float32, None), (torch.float64, None),
                                         (torch.float32, torch.bfloat16),
                                         (torch.float64, torch.bfloat16)],
                         ids=["float32", "float64", "bf16-float32", "bf16-float64"])
@pytest.mark.parametrize("k", [8, 50, 256])
def test_ell_phi_sums_padding_and_nonpositive_dots(cuda, dtype, table, k):
    """K1 on buckets of every warps-per-segment class (w from 8 to 3000)
    whose segments hold padding that starts in the middle of a 32-slot
    group, only padding, or zero-valued slots between nonzero ones, and
    whose slots include other-side rows with a negative or a zero dot; all
    buckets in one launch and each on its own (the same bits), against the
    plain version; repeats bit-identical."""
    from hpfrec_tpu_torch.ops import ell as E

    rng = np.random.default_rng(41)
    n_self, n_other, off = 50, 400, 7
    widths = [8, 20, 100, 600, 1500, 3000]
    assert {E._warps_per_segment(w) for w in widths} == {1, 2, 4, 8}
    t = _tables(n_self, k, dtype, cuda, 5)
    o = _tables(n_other + off, k, dtype, cuda, 6)
    o[off + 1:off + 60:2] *= -1  # a negative dot
    o[off + 2:off + 60:2] = 0  # a zero dot
    if table is not None:
        t, o = t.to(table), o.to(table)
    buckets, start = [], 0
    for j, w in enumerate(widths):
        rows, cols, vals = _edge_bucket(w, n_self, n_other if j % 2 else 60, rng, cuda, dtype)
        buckets.append(E.DeviceBucket(rows, cols, vals, off, start))
        start += rows.shape[0]
    idx = torch.zeros(1, dtype=torch.int32, device=cuda)
    lay = E.DeviceEll(buckets=buckets, inv_perm=idx, split_seg_pos=idx[:0].reshape(0, 1),
                      split_indptr=idx, n_rows=1, n_segs=start)
    seg = E.all_bucket_sums(t, o, lay)
    ref = torch.cat([E._bucket_phi_sums_plain(t, o, b.rows, b.cols, b.vals, b.col_off)
                     for b in buckets])
    torch.cuda.synchronize()
    assert seg.dtype == E._acc_dtype(t.dtype)
    torch.testing.assert_close(seg, ref, **TOL[seg.dtype])
    for b in buckets:  # padding-only segments sum to exactly 0
        assert not bool(seg[b.start + 3].any())
        one = torch.empty_like(seg[b.start:b.start + b.rows.shape[0]])
        E.bucket_phi_sums(t, o, b.rows, b.cols, b.vals, b.col_off, one)
        assert torch.equal(one, seg[b.start:b.start + b.rows.shape[0]])
    assert torch.equal(E.all_bucket_sums(t, o, lay), seg)


@pytest.mark.gpu
@pytest.mark.parametrize("ndev", [2, 3])
@pytest.mark.parametrize("window", ["jax", "card", "4 rows"])
@pytest.mark.parametrize("dtype,table", [(torch.float32, None), (torch.float64, None),
                                         (torch.float32, torch.bfloat16)],
                         ids=["float32", "float64", "bf16-float32"])
def test_k1_a_ring_offset_a_launch_equals_a_bucket_a_launch(cuda, dtype, table, window, ndev):
    """K1 as the table-sharded ring runs it (``all_bucket_sums`` over a
    ring offset's view, into the rank's segment sums: one launch an
    offset) against one launch a bucket (``bucket_phi_sums``) on every
    rank's share of both sides' sharded layouts, with JAX's window, the
    card's and a 4-row window (several sub-tiles a shard): the same bits,
    within TOL of the plain version, the same bits on a rerun, and one
    launch counted an offset that has buckets."""
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.parallel import table_sharded as T
    from hpfrec_tpu_torch.utils.data import build_csr

    nU, nI, k = 300, 120, 50
    y, iu, ii = _counts(nU, nI, 4000, seed=9)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    itemsize = 2 if table is not None else np.dtype(npdt).itemsize
    window_bytes = {"jax": None, "card": T.CARD_WINDOW_BYTES, "4 rows": 4 * k * itemsize}[window]
    plan = T.prepare_table_sharded(*build_csr(iu, ii, y.astype(npdt), nU, nI),
                                   *build_csr(ii, iu, y.astype(npdt), nI, nU), nU, nI, k, ndev,
                                   itemsize, dtype=npdt, max_width=16, window_bytes=window_bytes)
    assert (plan.plan_u[2] > 1) == (window == "4 rows")
    counter = "launches_offset" + ("_bf16" if table is not None else "")
    for side, se in enumerate((plan.se_u, plan.se_i)):
        own = _tables(se.rows_per_dev, k, dtype, cuda, 1 + side)
        shard = _tables(se.per_opp, k, dtype, cuda, 3 + side)
        if table is not None:
            own, shard = own.to(table), shard.to(table)
        acc = E._acc_dtype(own.dtype)
        for d in range(ndev):
            share = T.rank_share(se, d, cuda)

            def per_offset():
                out = torch.full((share.ell.n_segs, k), float("nan"), dtype=acc, device=cuda)
                for view in share.offsets:
                    E.all_bucket_sums(own, shard, view, out=out)
                return out

            before = getattr(E.all_bucket_sums, counter)
            got = per_offset()
            assert getattr(E.all_bucket_sums, counter) - before == sum(
                any(b.rows.shape[0] for b in v.buckets) for v in share.offsets)
            one = torch.full_like(got, float("nan"))
            for js in share.by_offset:
                for j in js:
                    b = share.ell.buckets[j]
                    E.bucket_phi_sums(own, shard, b.rows, b.cols, b.vals, b.col_off,
                                      one[b.start:b.start + b.rows.shape[0]])
            plain = torch.cat([E._bucket_phi_sums_plain(own, shard, b.rows, b.cols, b.vals,
                                                        b.col_off) for b in share.ell.buckets])
            torch.cuda.synchronize()
            assert torch.equal(got, one)  # every segment written, the same bits
            torch.testing.assert_close(got, plain, **TOL[acc])
            assert torch.equal(per_offset(), got)


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

    wrappers = [E.all_bucket_sums, E.bucket_phi_sums, E.segment_table_sums, C.side_update,
                C.side_derive, M.bucket_llk_parts, M.llk_rmse_sums,
                S.build_epoch_buffers, S.batch_phi_sums, S.build_row_mask, S.svi_update,
                T.topn_rows, S.user_factors_loop, M.predict_pairs, M.theta_diff_norm,
                M.rowsum_dot_rows, C.coo_phi_sums, C.colsum_finish]
    counts = lambda: [(w.launches, getattr(w, "launches_bf16", 0),  # noqa: E731
                       getattr(w, "launches_pad", 0), getattr(w, "launches_pad_bf16", 0),
                       getattr(w, "launches_large", 0), getattr(w, "launches_offset", 0),
                       getattr(w, "launches_offset_bf16", 0))
                      for w in wrappers]
    before = counts()
    y, iu, ii = _counts(40, 30, 300, seed=3)
    lay = _layout(y, iu, ii, 40, 30, np.float32, "cpu")
    t = _tables(40, 5, torch.float32, "cpu", 1)
    b = _tables(30, 5, torch.float32, "cpu", 2)
    su = E.ell_phi_sums(t, b, lay)
    E.all_bucket_sums(t, b, lay, out=torch.empty((lay.n_segs, 5)))
    E.all_bucket_sums(t.bfloat16(), b.bfloat16(), lay, out=torch.empty((lay.n_segs, 5)))
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
    T.topn_rows(t[:4], b, None, None, 30)
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
    (torch.float32, 70, 3001, 50, 128, True),  # the fused path's largest n
    (torch.float32, 70, 3001, 50, 129, True),  # the three-kernel path's smallest
    (torch.float64, 65, 3001, 50, 128, True),
    (torch.float32, 1, 130, 3, 1, True),
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


def _topn_edge_case(dtype, device, b=70, nI=3001, k=20):
    """Integer tables where Beta's rows 0, 700, 1500 and 2999 (in different
    item ranges of the fused path) are equal and score highest, unseen by
    every row but row 0, which has no unseen item; row 1 has six (0-4 and
    nI - 1), fewer than most n tested."""
    th, be = _int_tables(b, nI, k, dtype, device, 12)
    top = [0, 700, 1500, 2999]
    be[top] = 9
    rows, items = _seen_pairs(b, nI, 30, device, 13, full_row=0)
    keep = (rows == 0) | ((rows != 1) & ~torch.isin(items, torch.tensor(top, device=device)))
    few = torch.arange(5, nI - 1, dtype=torch.int32, device=device)
    rows = torch.cat([rows[keep], torch.ones_like(few)])
    items = torch.cat([items[keep], few])
    return th, be, rows, items


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 10, 128, 129])
def test_topn_fused_edges(cuda, dtype, n):
    """K6 at n = 1, 10, the fused path's cap and the cap + 1 (the
    three-kernel path), b and nI off the tiles: ties across item ranges in
    lax.top_k's order (the lowest index first), a row with fewer than n
    unseen items (its -inf slots hold the lowest seen indices), a fully
    masked row; equal to the plain version and to itself on a rerun."""
    from hpfrec_tpu_torch.ops import topk as T

    th, be, rows, items = _topn_edge_case(dtype, cuda)
    got = T.topn_rows(th, be, rows, items, n)
    ref = T._topn_rows_plain(th, be, rows, items, n)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])
    top = got[1][2:, :min(n, 4)].cpu()
    assert bool((top == torch.tensor([0, 700, 1500, 2999][:min(n, 4)],
                                     dtype=torch.int32)).all())
    assert int(torch.isfinite(got[0][1]).sum()) == min(n, 6)
    again = T.topn_rows(th, be, rows, items, n)
    assert all(torch.equal(a, c) for a, c in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 10, 128])
@pytest.mark.parametrize("b,nI", [(200, 5000), (1, 700), (129, 64)])
def test_topn_fused_bit_equal_to_three_kernel_path(cuda, dtype, n, b, nI):
    """On random tables (float32 sums that round differently in another
    order) the fused path's indices and values are the three-kernel
    path's bit for bit: the same score sums, the same words."""
    from hpfrec_tpu_torch.ops import topk as T

    n = min(n, nI)
    rng = np.random.default_rng(n + b)
    th = torch.from_numpy(rng.random((b, 50))).to(cuda, dtype)
    be = torch.from_numpy(rng.random((nI, 50))).to(cuda, dtype)
    rows, items = _seen_pairs(b, nI, min(100, nI // 3), cuda, 6)
    for mr, mi in ((rows, items), (None, None)):
        fused = T.topn_rows(th, be, mr, mi, n)
        three = T._topn_scored(th, be, mr, mi, n)
        assert torch.equal(fused[0], three[0]) and torch.equal(fused[1], three[1])


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


def _select_rows(nI, seed):
    """float32 score rows for K6's select, one of each kind: uniform (the
    first histogram pass leaves few candidates), within 1e-3 of 1 (one
    12-bit bin: the second pass resolves it), within 1e-7 of 1 (one bin
    down to the last bits, many exact ties: the ordered pass), small
    integers (ties straddling every threshold), normal (negative and
    positive), -inf but for 100 items, and -inf throughout."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.random(nI), 1 + 1e-3 * rng.random(nI), 1 + 1e-7 * rng.random(nI),
                     rng.integers(0, 10, nI).astype(np.float64), rng.standard_normal(nI),
                     np.full(nI, -np.inf), np.full(nI, -np.inf)]).astype(np.float32)
    rows[5, rng.choice(nI, 100, replace=False)] = rng.random(100)
    rows[rows == 0] = 0.5  # no -0 / +0 pairs: the keys order them, a sort does not
    return torch.from_numpy(rows)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [129, 2000, 4096, 4097, 20_000])
def test_topn_select_vs_stable_sort(cuda, n):
    """K6's select on score rows of every kind (``_select_rows``; 20,000
    items, more than the 8,192 candidates a row keeps in shared memory) at
    n past the fused path's cap, at and past the shared-memory sort's 4,096
    and at n = nI: the values and indices of a stable descending sort, bit
    for bit, and the same bits on a rerun."""
    from hpfrec_tpu_torch.ops import topk as T

    scores = _select_rows(20_000, 21).to(cuda)
    got = T._topn_select(scores, n)
    ref = torch.sort(scores, dim=1, descending=True, stable=True)
    assert torch.equal(got[0], ref.values[:, :n])
    assert torch.equal(got[1], ref.indices[:, :n].to(torch.int32))
    again = T._topn_select(scores, n)
    assert all(torch.equal(a, c) for a, c in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [129, 2000, 4096, 4097])
def test_topn_select_long_rows_vs_stable_sort(cuda, n):
    """K6's select on rows long enough for its first pass's guess (262,144
    items or more; ``_select_rows``' kinds at 300,000 items, plus a row
    whose sampled keys, 4 at every nI / 4,096 * 4-th place as csrc/topn.cu
    takes them, are its largest and span several 12-bit bins, so at n =
    2,000 the guessed bin lies above the n-th key's and a second pass
    runs): a stable descending sort's values and indices, bit for bit."""
    from hpfrec_tpu_torch.ops import topk as T

    nI = 300_000
    rows = _select_rows(nI, 24)
    step = nI // 4096 * 4
    sampled = (np.arange(1024)[:, None] * step + np.arange(4)).ravel()
    rng = np.random.default_rng(25)
    miss = rng.random(nI)
    miss[sampled] = 10 + 10 * rng.random(sampled.size)  # over several 12-bit bins
    miss = torch.from_numpy(miss.astype(np.float32))
    scores = torch.cat([rows, miss[None]]).to(cuda)
    got = T._topn_select(scores, n)
    ref = torch.sort(scores, dim=1, descending=True, stable=True)
    assert torch.equal(got[0], ref.values[:, :n])
    assert torch.equal(got[1], ref.indices[:, :n].to(torch.int32))


_GUESS_NI = 262_144  # the shortest row whose first pass takes a guess


def _guess_overflow_row(n, seed):
    """A float32 row of ``_GUESS_NI`` items whose first pass guesses too
    low and overflows: every key csrc/topn.cu samples (4 at every nI /
    4,096 * 4-th place) lies just below the 12-bit bin edge at 1.125, in a
    bin of 10,000 keys, more than the 8,192 words a row collects; the n-th
    largest key lies in the bin above, among n + 1,000 keys with ties (4
    values), placed where nothing is sampled; the rest lie far below.  The
    collecting pass then holds too many words while the n-th key's bin
    would fit, so a second pass collects it.  Returns (row, sampled
    places)."""
    rng = np.random.default_rng(seed)
    row = 0.01 * rng.random(_GUESS_NI)
    step = _GUESS_NI // 4096 * 4
    sampled = (np.arange(1024)[:, None] * step + np.arange(4)).ravel()
    rest = np.setdiff1d(np.arange(_GUESS_NI), sampled)
    low = np.concatenate([sampled, rng.choice(rest, 10_000 - sampled.size, replace=False)])
    row[low] = 1.124 - 1e-3 * rng.random(low.size)
    high = rng.choice(np.setdiff1d(rest, low), n + 1000, replace=False)
    row[high] = 1.125 + 1e-3 * rng.integers(0, 4, high.size)
    return row.astype(np.float32), sampled


@pytest.mark.parametrize("n", [129, 2000])
def test_guess_overflow_row_takes_the_second_pass(n):
    """``_guess_overflow_row`` does what the card test needs, by the
    kernel's arithmetic: the guessed bin (the 12-bit bin of the sampled
    keys' rank-th largest, rank past the n-th's expected place by three
    standard deviations and 8) lies below the n-th key's bin; the keys at
    or above the guess number more than the 8,192-word buffer; those at
    or above the n-th key's bin fit it."""
    row, sampled = _guess_overflow_row(n, 31)
    u = row.view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    expect = n * 4096 / _GUESS_NI
    rank = int(np.ceil(expect + 3 * np.sqrt(expect) + 8))
    assert rank * _GUESS_NI / 4096 <= 0.5 * 8192  # the kernel guesses
    guess_bin = np.sort(key[sampled] >> 20)[::-1][rank - 1]
    nth_bin = np.sort(key)[::-1][n - 1] >> 20
    assert guess_bin < nth_bin
    assert (key >> 20 >= guess_bin).sum() > 8192
    assert n < (key >> 20 >= nth_bin).sum() <= 8192


@pytest.mark.gpu
@pytest.mark.parametrize("n", [129, 2000])
def test_topn_select_guess_overflow_vs_stable_sort(cuda, n):
    """K6's select where its first pass guesses a bin below the n-th key's
    and collects more words than its buffer holds (``_guess_overflow_row``,
    twice, and its keys shuffled once): a second pass collects the n-th
    key's bin and above.  The values and indices of a stable descending
    sort, bit for bit, and the same bits on reruns."""
    from hpfrec_tpu_torch.ops import topk as T

    row, _ = _guess_overflow_row(n, 31)
    shuffled = np.random.default_rng(32).permutation(row)
    scores = torch.from_numpy(np.stack([row, shuffled, row])).to(cuda)
    got = T._topn_select(scores, n)
    ref = torch.sort(scores, dim=1, descending=True, stable=True)
    assert torch.equal(got[0], ref.values[:, :n])
    assert torch.equal(got[1], ref.indices[:, :n].to(torch.int32))
    for _ in range(3):
        again = T._topn_select(scores, n)
        assert all(torch.equal(a, c) for a, c in zip(again, got))


@pytest.mark.gpu
def test_topn_select_counts_its_launches(cuda):
    """A launch of K6's select counts one in ``topn_rows.launches_large``,
    whether it comes through ``topn_rows`` or straight from
    ``_topn_select``; the score and mask launches count none."""
    from hpfrec_tpu_torch.ops import topk as T

    th, be = _int_tables(4, 600, 8, torch.float32, cuda, 33)
    before = T.topn_rows.launches_large
    scores = T._topn_scores(th, be, None, None, 200)
    assert T.topn_rows.launches_large == before
    T._topn_select(scores, 200)
    assert T.topn_rows.launches_large == before + 1
    T.topn_rows(th, be, None, None, 200)
    assert T.topn_rows.launches_large == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [129, 2000, 4096, 4097, 6000])
def test_topn_scored_vs_stable_sort_of_its_scores(cuda, dtype, n):
    """K6's three-kernel path against a stable descending sort of its own
    score buffer (``_topn_scores``), bit for bit: integer tables (ties
    across the threshold), seen items masked, row 0 fully masked, row 1
    with 50 unseen items (fewer than n), n up to nI; the scores themselves
    equal the plain product's (exact on integer tables)."""
    from hpfrec_tpu_torch.ops import topk as T

    b, nI, k = 6, 6000, 20
    th, be = _int_tables(b, nI, k, dtype, cuda, 22)
    rows, items = _seen_pairs(b, nI, 300, cuda, 23, full_row=0)
    few = torch.arange(50, nI, dtype=torch.int32, device=cuda)
    rows = torch.cat([rows, torch.ones_like(few)])
    items = torch.cat([items, few])
    scores = T._topn_scores(th, be, rows, items, n)
    ref = T._topn_rows_plain(th, be, rows, items, nI)
    assert torch.equal(torch.sort(scores, dim=1, descending=True, stable=True).values, ref[0])
    got = T._topn_scored(th, be, rows, items, n)
    want = torch.sort(scores, dim=1, descending=True, stable=True)
    assert torch.equal(got[0], want.values[:, :n])
    assert torch.equal(got[1], want.indices[:, :n].to(torch.int32))


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [1, 70, 3000])
@pytest.mark.parametrize("k", [7, 50, 256])
@pytest.mark.parametrize("return_phi", [False, True])
def test_fold_in_host_route_vs_plain(cuda, dtype, P, k, return_phi):
    """K10 as HPF calls it (``fold_in``: host arrays in, one copy up, one
    back) against the plain loop on the same arrays: the same iteration
    count, the existing tolerances, phi_norm only when asked for, and
    bit-identical reruns."""
    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import svi as S

    args, k_rte0 = _fold_in_inputs(P, k, dtype, "cpu", 7 * P + k)
    arrays = [a.numpy() for a in args]
    hp = Hyperparams(k=k)
    got = S.fold_in(*arrays, k_rte0, hp, 12, 1e-4, cuda, return_phi)
    ref = S._user_factors_loop_plain(*args, k_rte0, hp, 12, 1e-4)
    assert got[4] == ref[4]
    assert (got[3] is None) != return_phi
    tol = dict(rtol=2e-5, atol=1e-6) if dtype == torch.float32 else TOL[dtype]
    for g, r in zip(got[:4], ref[:4]):
        if g is not None:
            torch.testing.assert_close(torch.from_numpy(g), r, **tol)
    again = S.fold_in(*arrays, k_rte0, hp, 12, 1e-4, cuda, return_phi)
    assert again[4] == got[4]
    assert all(np.array_equal(a, c) for a, c in zip(again[:4], got[:4]) if a is not None)


# ---- K2: segment sums to table order -----------------------------------

def _split_layout(n_rows, n_segs, device, seed, P=4):
    """A reassembly layout by hand: each row's first segment a random
    segment; rows with no split chunk, with one, with many (up to 100, also
    side by side in one warp), chunks padded with -1 (one of them all -1)."""
    from hpfrec_tpu_torch.ops.ell import DeviceEll

    rng = np.random.default_rng(seed)
    chunks = np.where(rng.random(n_rows) < 0.05, rng.integers(1, 4, n_rows), 0)
    chunks[[0, 1, 2, 40, n_rows // 2, n_rows - 1]] = [100, 37, 1, 12, 60, 9]
    pos = rng.integers(0, n_segs, (int(chunks.sum()), P))
    pos[rng.random(pos.shape) < 0.2] = -1
    pos[:, P - 1][rng.random(len(pos)) < 0.3] = -1
    pos[5] = -1
    indptr = np.concatenate([[0], np.cumsum(chunks)])
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)  # noqa: E731
    return DeviceEll(buckets=[], inv_perm=up(rng.integers(0, n_segs, n_rows)),
                     split_seg_pos=up(pos), split_indptr=up(indptr), n_rows=n_rows,
                     n_segs=n_segs)


K2_FORMS = {"float32": (torch.float32, None), "float64": (torch.float64, None),
            "float32_float64": (torch.float32, torch.float64)}


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(K2_FORMS))
@pytest.mark.parametrize("k", [1, 7, 50, 64, 256])
@pytest.mark.parametrize("offset", [0, 1])
def test_segment_table_sums_bits_vs_plain(cuda, form, k, offset):
    """K2 equals its plain version bit for bit (both add in one order), over
    1,037 rows (not a multiple of a warp's 32 or a block's 256), in every
    vector form: ``offset`` 1 starts the sums one element past an aligned
    address, which leaves only the one-element form."""
    from hpfrec_tpu_torch.ops import ell as E

    dtype, out_dtype = K2_FORMS[form]
    n_rows, n_segs = 1037, 3000
    lay = _split_layout(n_rows, n_segs, cuda, seed=k)
    rng = np.random.default_rng(k + 1)
    buf = torch.from_numpy(rng.standard_normal(n_segs * k + 1)).to(cuda, dtype)
    seg = buf[offset:offset + n_segs * k].view(n_segs, k)
    got = E.segment_table_sums(seg, lay, out_dtype)
    ref = E._segment_table_sums_plain(seg, lay)
    torch.cuda.synchronize()
    assert got.dtype == (out_dtype or dtype) and got.shape == (n_rows, k)
    assert torch.equal(got, ref.to(got.dtype))
    assert torch.equal(E.segment_table_sums(seg, lay, out_dtype), got)


@pytest.mark.gpu
def test_segment_table_sums_bf16_fit_form(cuda):
    """The bfloat16 fit's form: K1's float32 sums over bfloat16 tables,
    reassembled by K2 into float64, bit-equal to the plain version."""
    from hpfrec_tpu_torch.ops import ell as E

    nU, nI = 300, 120
    y, iu, ii = _counts(nU, nI, 4000, seed=1)
    lay = _layout(y, ii, iu, nI, nU, np.float64, cuda, max_width=8)  # item rows split
    assert lay.split_seg_pos.shape[0] > 0
    t = _tables(nI, 50, torch.float64, cuda, 2).bfloat16()
    b = _tables(nU, 50, torch.float64, cuda, 3).bfloat16()
    seg = E.all_bucket_sums(t, b, lay)
    assert seg.dtype == torch.float32
    got = E.segment_table_sums(seg, lay, torch.float64)
    torch.cuda.synchronize()
    assert torch.equal(got, E._segment_table_sums_plain(seg, lay).double())


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 7, 50, 64, 128, 256])
@pytest.mark.parametrize("n", [1, 7, 257, 5003, 387_525])
def test_rowsum_dot_rows_vs_plain(cuda, dtype, k, n):
    """rowsum_dot_rows' kernel and device finish at every lane split and
    at grids from one block to the held-out set's 387,525 pairs: the
    float64 dot within 1e-6 (float32 tables) / 1e-12 (float64) of the plain
    float64 dot, the value returned its float32 rounding, the same bits on a
    rerun; with a grid of more blocks than the pairs need, the finish adds
    the empty blocks' zero rows (the same bits where the pairs fill one
    block)."""
    from hpfrec_tpu_torch.ops import metrics as M

    rng = np.random.default_rng(n * 11 + k)
    th = _tables(3000, k, dtype, cuda, 6) / k
    be = _tables(2000, k, dtype, cuda, 7)
    iu = torch.from_numpy(rng.integers(0, 3000, n).astype(np.int32)).to(cuda)
    ii = torch.from_numpy(rng.integers(0, 2000, n).astype(np.int32)).to(cuda)
    rtol = 1e-6 if dtype == torch.float32 else 1e-12
    dot = M._rowsum_dot_launch(th, be, iu, ii)
    assert dot.shape == (1,) and dot.dtype == torch.float64
    ref = float(torch.dot(th[iu.long()].double().sum(0), be[ii.long()].double().sum(0)))
    np.testing.assert_allclose(dot.item(), ref, rtol=rtol)
    r = M.rowsum_dot_rows(th, be, iu, ii)
    assert r == float(np.float32(dot.item()))
    np.testing.assert_allclose(r, ref, rtol=1e-6)
    assert M.rowsum_dot_rows(th, be, iu, ii) == r
    assert torch.equal(M._rowsum_dot_launch(th, be, iu, ii), dot)
    _, grid = M._pairs_grid(n)
    spare = M._rowsum_dot_launch(th, be, iu, ii, nblocks=grid + 63)
    if grid == 1:
        assert torch.equal(spare, dot)
    np.testing.assert_allclose(spare.item(), ref, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 7, 33, 50, 64, 66, 99, 130, 255, 256])
@pytest.mark.parametrize("n", [1, 31, 33, 65_536, 100_000, 300_000])
def test_predict_pairs_every_grid(cuda, dtype, k, n):
    """predict_pairs at every lane split (a group of 1 to 32 lanes a pair,
    four or eight vectors a lane; 16-, 8-byte and one-element loads, the
    last at odd k) and at grids from one block to a run of 64 pairs a
    warp: within TOL of the plain version,
    the same bits on a rerun, and the float64 partials of
    ``sum_pairs_prediction`` within 10 x rtol of the plain sum.  Offset
    views of the tables give the bits of aligned copies."""
    from hpfrec_tpu_torch.ops import metrics as M

    rng = np.random.default_rng(n * 7 + k)
    th = _tables(500, k, dtype, cuda, 4) / k
    be = _tables(700, k, dtype, cuda, 5)
    iu = torch.from_numpy(rng.integers(0, 500, n).astype(np.int32)).to(cuda)
    ii = torch.from_numpy(rng.integers(0, 700, n).astype(np.int32)).to(cuda)
    got = M.predict_pairs(th, be, iu, ii)
    plain = M._pairs_plain(th, be, iu, ii)
    torch.cuda.synchronize()
    assert got.shape == (n,) and got.dtype == dtype
    torch.testing.assert_close(got, plain, **TOL[dtype])
    assert torch.equal(M.predict_pairs(th, be, iu, ii), got)
    s = M.sum_pairs_prediction(th, be, iu, ii)
    np.testing.assert_allclose(s, float(plain.double().sum()), rtol=TOL[dtype]["rtol"] * 10)
    assert M.sum_pairs_prediction(th, be, iu, ii) == s
    if n == 100_000:
        off = torch.empty(500 * k + 1, dtype=dtype, device=cuda)[1:].view(500, k)
        off.copy_(th)
        assert torch.equal(M.predict_pairs(off, be, iu, ii), got)


# (nU, nI, k): k = 1 and 7; nU k under one 624-word twist; tables that end
# in mid-step (227 words) and mid-twist; odd nU k, so odd float64 value
# counts; several twists
MT_SHAPES = [(5, 3, 1), (100, 37, 1), (31, 17, 7), (113, 61, 7), (89, 227, 7), (1000, 613, 7)]


def _pin_unseeded(monkeypatch, seed):
    """Seeds None and 0 draw fresh OS entropy; pin the generator so that
    the card's and the host's starts can be compared."""
    if seed is None or seed <= 0:
        orig = np.random.MT19937
        monkeypatch.setattr(np.random, "MT19937",
                            lambda seed=None: orig(seed=99 if seed is None else seed))


def _assert_state_bits(got, ref):
    for g, r in zip(got, ref):
        assert g.is_cuda and not r.is_cuda and g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g.cpu(), r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [None, 0, 123])
@pytest.mark.parametrize("nU,nI,k", MT_SHAPES)
def test_seeded_start_on_the_card_equals_numpy(cuda, monkeypatch, dtype, seed, nU, nI, k):
    from hpfrec_tpu_torch.models import state as ST
    from hpfrec_tpu_torch.ops import mt19937 as MT

    _pin_unseeded(monkeypatch, seed)
    hp = ST.Hyperparams(a=0.4, a_prime=0.2, b_prime=1.5, c=0.35, c_prime=0.25, d_prime=0.9,
                        k=k)
    n0 = MT.mt19937_tables.launches
    got = ST.initialize_state(nU, nI, hp, seed, dtype, device="cuda")
    assert MT.mt19937_tables.launches == n0 + 1
    _assert_state_bits(got, ST.initialize_state(nU, nI, hp, seed, dtype, device="cpu"))
    # and the plain version, from the same key
    g = np.random.Generator(np.random.MT19937(seed=seed if seed else None))
    mt = g.bit_generator.state["state"]
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    plain = MT.mt19937_tables(mt["key"], mt["pos"], nU * k, nI * k, 0.2, 0.25, tdt, "cpu")
    for a, b in zip((got.G_rte, got.L_rte, got.G_shp, got.L_shp), plain):
        assert torch.equal(a.reshape(-1).cpu(), b)


@pytest.mark.gpu
def test_seeded_start_on_the_card_at_the_tasteprofile_shape(cuda):
    from hpfrec_tpu_torch.models import state as ST

    hp = ST.Hyperparams(k=50)
    got = ST.initialize_state(1_019_318, 376_768, hp, 123, np.float32, device="cuda")
    _assert_state_bits(got, ST.initialize_state(1_019_318, 376_768, hp, 123, np.float32,
                                                device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("use_float", [True, False])
def test_a_cuda_fit_starts_on_the_card(cuda, monkeypatch, use_float):
    """A CUDA fit draws its start with one K14 launch, counts its words in
    ``device_draws`` and does not upload it; its factors equal those of
    the same fit started from the host's draw."""
    from scipy.sparse import coo_array

    from hpfrec_tpu_torch import HPF
    from hpfrec_tpu_torch.models import hpf as H
    from hpfrec_tpu_torch.ops import mt19937 as MT

    y, iu, ii = _counts(300, 120, 4000, seed=1)
    X = coo_array((y, (iu, ii)), shape=(300, 120))
    kw = dict(k=7, maxiter=20, check_every=10, stop_crit="train-llk", random_seed=5,
              use_float=use_float, verbose=False, device="cuda")
    n0 = MT.mt19937_tables.launches
    card = HPF(**kw).fit(X)
    assert MT.mt19937_tables.launches == n0 + 1
    nU, nI = card.nusers, card.nitems
    assert card.fit_stats_.device_draws == 2 * (nU + nI) * 7 * (1 if use_float else 2)

    orig = H.initialize_state
    monkeypatch.setattr(H, "initialize_state",
                        lambda nU, nI, hp, seed, dtype, device: orig(nU, nI, hp, seed, dtype))
    host = HPF(**kw).fit(X)
    assert MT.mt19937_tables.launches == n0 + 1
    assert host.fit_stats_.device_draws == 0
    state_bytes = (2 * (nU + nI) * 7 + nU + nI) * (4 if use_float else 8)
    assert host.fit_stats_.bytes_to_device - card.fit_stats_.bytes_to_device == state_bytes
    assert np.array_equal(card.Theta, host.Theta) and np.array_equal(card.Beta, host.Beta)


# ---- K15: a fit's ingest on the card ------------------------------------

def _unsorted_counts(nU, nI, nnz, seed):
    """``_counts`` in a shuffled order, with the heavy items that split at
    a small width."""
    y, iu, ii = _counts(nU, nI, nnz, seed)
    order = np.random.default_rng(seed + 1).permutation(len(y))
    return y[order], iu[order], ii[order]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("max_width", [8, 64, 8192])
def test_ell_fill_vs_plain(cuda, dtype, max_width):
    """K15 against its plain version, bit for bit, at widths that split
    item rows and merge thin buckets; K15a and K15b beside it."""
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import ingest as G
    from hpfrec_tpu_torch.utils.data import build_csr

    y, iu, ii = _unsorted_counts(3000, 700, 60_000, seed=4)
    for rows, cols, n_rows, n_cols in ((iu, ii, 3000, 700), (ii, iu, 700, 3000)):
        indptr, ind, dat = build_csr(rows, cols, y.astype(np.float64), n_rows, n_cols)
        c = torch.from_numpy(ind).to(cuda)
        v = torch.from_numpy(dat).to(cuda, dtype)
        n0 = E.ell_fill.launches
        got = E.pack_ell(indptr, c, v, max_width)
        assert E.ell_fill.launches == n0 + 1
        ref = E.pack_ell(indptr, c.cpu(), v.cpu(), max_width)
        assert torch.equal(got.cols.cpu(), ref.cols) and torch.equal(got.vals.cpu(), ref.vals)
        host = E.to_device(E.build_ell(indptr, ind, dat, n_rows, max_width,
                                       dtype=np.dtype(str(dtype).split(".")[1])), cuda)
        dev = E.device_ell(got)
        for a, b in zip(host.buckets, dev.buckets):
            assert all(torch.equal(x, z) for x, z in zip(a[:3], b[:3])) and a[3:] == b[3:]
        for name in ("inv_perm", "split_seg_pos", "split_indptr"):
            assert torch.equal(getattr(host, name), getattr(dev, name))
        if max_width == 8 and n_rows == 700:
            assert host.split_seg_pos.shape[0] > 0
        keys = torch.from_numpy(np.sort(rows).astype(np.int32)).to(cuda)
        assert torch.equal(G.csr_indptr(keys, n_rows).cpu(),
                           torch.from_numpy(indptr.astype(np.int32)))
    for ids in (torch.from_numpy(iu).to(cuda), torch.from_numpy(
            np.random.default_rng(2).integers(-(2 ** 40), 2 ** 40, 100_003)).to(cuda)):
        out, mm = G.narrow_ids(ids)
        ref_out, ref_mm = G.narrow_ids(ids.cpu())
        assert torch.equal(out.cpu(), ref_out) and torch.equal(mm.cpu(), ref_mm)


def _spy(monkeypatch, module, name, seen):
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        seen.append((a, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


# a CUDA fit against the same fit on CPU tensors: chip_smoke's phase-4 limits
# (max relative difference of every element of Theta and Beta)
_AGREE_FACTORS = {True: 6e-3, False: 1e-9}
_AGREE_SVI_FACTORS = {True: 5e-5, False: 1e-11}


def _card_and_cpu_fits(monkeypatch, module, name, X, kw):
    """The fit of ``X`` on the card and on the CPU, each with the calls of
    ``module.name`` made during it, ``(args, result)``."""
    from hpfrec_tpu_torch import HPF

    fits, calls = [], []
    for device in ("cuda", "cpu"):
        seen = []
        _spy(monkeypatch, module, name, seen)
        fits.append(HPF(**dict(kw, device=device)).fit(X))
        monkeypatch.undo()
        calls.append(seen)
    return fits, calls


def _assert_same_seen(card, cpu):
    for name in ("seen", "_st_ix_user", "_n_seen_by_user"):
        a, b = getattr(card, name), getattr(cpu, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _assert_factors_agree(card, cpu, limit):
    for name in ("Theta", "Beta"):
        a, b = getattr(card, name), getattr(cpu, name)
        assert a.dtype == b.dtype and np.abs(a / b - 1).max() <= limit


@pytest.mark.gpu
@pytest.mark.parametrize("use_float", [True, False])
def test_a_cuda_fit_ingests_on_the_card(cuda, monkeypatch, use_float):
    """A CUDA fit sorts and packs on the card what the same fit on CPU
    tensors packs, element for element (K15 against its plain version
    inside a fit), its seen-items CSR is the CPU fit's and its factors
    agree; a COO fit's stream is the CPU fit's, element for element."""
    from scipy.sparse import coo_array

    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E

    y, iu, ii = _unsorted_counts(900, 300, 20_000, seed=6)
    X = coo_array((y, (iu, ii)), shape=(900, 300))
    kw = dict(k=7, maxiter=20, check_every=10, stop_crit="train-llk", random_seed=5,
              use_float=use_float, verbose=False)
    (card, cpu), (got, want) = _card_and_cpu_fits(monkeypatch, E, "device_ell", X, kw)
    assert len(got) == len(want) == 2
    for (_, a), (_, b) in zip(got, want):
        assert a.inv_perm.is_cuda and len(a.buckets) == len(b.buckets)
        for x, z in zip(a.buckets, b.buckets):
            assert all(torch.equal(p.cpu(), q) for p, q in zip(x[:3], z[:3])) and x[3:] == z[3:]
        for name in ("inv_perm", "split_seg_pos", "split_indptr"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name))
    _assert_same_seen(card, cpu)
    _assert_factors_agree(card, cpu, _AGREE_FACTORS[use_float])
    (card, cpu), (got, want) = _card_and_cpu_fits(monkeypatch, C, "coo_stream", X,
                                                  dict(kw, engine="coo"))
    (_, a), (_, b) = got[0], want[0]
    assert a.nnz == b.nnz == X.nnz
    for x, z in zip((*a.data, *a[2:]), (*b.data, *b[2:])):
        assert x.is_cuda and torch.equal(x.cpu(), z)
    _assert_same_seen(card, cpu)
    _assert_factors_agree(card, cpu, _AGREE_FACTORS[use_float])


@pytest.mark.gpu
@pytest.mark.parametrize("batches", [dict(users_per_batch=200, items_per_batch=90),
                                     dict(users_per_batch=250)])
def test_a_cuda_svi_fit_ingests_on_the_card(cuda, monkeypatch, batches):
    """An SVI fit on the card takes its epoch sides from the card's sort:
    each epoch's side equal to the same fit's on CPU tensors; the
    seen-items CSR is the CPU fit's and the factors agree."""
    from scipy.sparse import coo_array

    from hpfrec_tpu_torch.ops import svi as S

    y, iu, ii = _unsorted_counts(900, 300, 20_000, seed=8)
    X = coo_array((y, (iu, ii)), shape=(900, 300))
    kw = dict(k=7, maxiter=4, check_every=2, stop_crit="train-llk", random_seed=5,
              verbose=False, **batches)
    (card, cpu), (got, want) = _card_and_cpu_fits(monkeypatch, S, "svi_run_epoch", X, kw)
    assert len(got) == len(want) == 4
    for (a, _), (b, _) in zip(got, want):
        side, ref = a[1], b[1]
        assert a[6] == b[6] and side.y.is_cuda
        assert all(torch.equal(getattr(side, f).cpu(), getattr(ref, f))
                   for f in ("y", "cols", "indptr"))
        assert np.array_equal(side.deg, ref.deg) and side.deg.dtype == ref.deg.dtype
    _assert_same_seen(card, cpu)
    _assert_factors_agree(card, cpu, _AGREE_SVI_FACTORS[True])
    rows = torch.tensor([5, 0, 9, 5, 2], dtype=torch.int32)
    assert torch.equal(S.build_row_mask(11, rows.to(cuda)).cpu(), S.build_row_mask(11, rows))


# ---- a fit's results back through the pinned ring (ops/staging.py) -------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32, torch.int64])
@pytest.mark.parametrize("nbytes", [0, 1, 4096, 64 * 1024, 37 * 4096 + 24])
def test_staged_copy_equals_cpu_numpy(cuda, dtype, nbytes):
    """Through the ring in 4 KB chunks (more chunks than buffers): sizes 0
    and 1, under one chunk, many chunks, many and a rest."""
    from hpfrec_tpu_torch.ops import staging

    item = torch.empty((), dtype=dtype).element_size()
    n = nbytes if nbytes <= 1 else nbytes // item
    t = torch.arange(n, dtype=torch.int64, device=cuda).mul_(2654435761).to(dtype)
    before = staging.to_host.staged_bytes
    (a,) = staging.to_host([t], _chunk_bytes=4096)
    ref = t.cpu().numpy()
    assert a.dtype == ref.dtype and a.shape == ref.shape and a.tobytes() == ref.tobytes()
    assert a.flags.owndata and staging.to_host.staged_bytes - before == t.nbytes


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [4096, None])
def test_staged_copy_waits_for_the_kernel_that_wrote_it(cuda, chunk):
    """A tensor written on the current stream right before the copy, behind
    a long kernel: every chunk holds what the kernel wrote; a second call
    leaves the first call's arrays as they were."""
    from hpfrec_tpu_torch.ops import staging

    kw = {} if chunk is None else dict(_chunk_bytes=chunk)
    n = (3 << 20) + 5
    x = torch.zeros(n, dtype=torch.float32, device=cuda)
    y = torch.zeros((1000, 7), dtype=torch.float64, device=cuda)
    torch.cuda._sleep(200_000_000)
    x.add_(torch.arange(n, dtype=torch.float32, device=cuda))
    y.add_(3.25)
    a, b = staging.to_host([x, y], **kw)
    assert np.array_equal(a, np.arange(n, dtype=np.float32)) and np.all(b == 3.25)
    x.neg_()
    c, = staging.to_host([x], **kw)
    assert np.array_equal(c, -np.arange(n, dtype=np.float32))
    assert np.array_equal(a, np.arange(n, dtype=np.float32)) and not np.shares_memory(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("use_float", [True, False])
@pytest.mark.parametrize("batches", [{}, dict(users_per_batch=200, items_per_batch=90)],
                         ids=["full_batch", "svi"])
def test_a_cuda_fits_results_come_back_exact(cuda, monkeypatch, use_float, batches):
    """A card fit's Theta and Beta are the bits of the host's quotient of
    its own state; its six state arrays and seen-items CSR are the
    ``.cpu().numpy()`` of the device tensors they came from, each filled
    into an array made ready during the loop; every byte it copied back
    crossed the pinned ring (``staged_bytes``)."""
    from scipy.sparse import coo_array

    from hpfrec_tpu_torch import HPF

    y, iu, ii = _unsorted_counts(900, 300, 20_000, seed=6)
    X = coo_array((y, (iu, ii)), shape=(900, 300))
    held = {}
    orig_state, orig_meta = HPF._state_to_host, HPF._store_metadata

    def state_to_host(self, state):
        held["state"] = [t.cpu().numpy() for t in state]
        return orig_state(self, state)

    def store_metadata(self, user):
        held["seen"] = user.cols.cpu().numpy()
        return orig_meta(self, user)

    from hpfrec_tpu_torch.ops.staging import HostArrays

    taken = []
    orig_take = HostArrays.take

    def take(self, shape, dtype):
        a = orig_take(self, shape, dtype)
        taken.append(a is not None)
        return a

    monkeypatch.setattr(HPF, "_state_to_host", state_to_host)
    monkeypatch.setattr(HPF, "_store_metadata", store_metadata)
    monkeypatch.setattr(HostArrays, "take", take)
    m = HPF(k=7, maxiter=4, check_every=2, stop_crit="train-llk", random_seed=5,
            use_float=use_float, verbose=False, device="cuda", **batches).fit(X)
    # every array came back into one made ready during the loop
    assert taken == [True] * 9 and m._ready is None
    G_shp, G_rte, L_shp, L_rte, _, _ = held["state"]
    assert m.Theta.tobytes() == (G_shp / G_rte).tobytes()
    assert m.Beta.tobytes() == (L_shp / L_rte).tobytes()
    for name, ref in zip(HPF._STATE_ATTRS, held["state"]):
        a = getattr(m, name)
        assert a.dtype == ref.dtype and a.tobytes() == ref.tobytes() and a.flags.owndata
    assert m.seen.dtype == held["seen"].dtype and m.seen.tobytes() == held["seen"].tobytes()
    st = m.fit_stats_
    back = sum(a.nbytes for a in (m.Theta, m.Beta, *held["state"], m.seen))
    assert st.staged_bytes == st.bytes_to_host == back > 0
