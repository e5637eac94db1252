"""hpfrec_tpu_torch.ops.ell against hpfrec_tpu.ops.ell: bit-identical host
layouts, the plain versions of K1 (phi sums) and K2 (segment reassembly),
and the CAVI block loop, on the same inputs.

Tolerances: float64 rtol 1e-12 for one E-step pass and 1e-10 for the
block loop (summation order differs between XLA and PyTorch); float32
rtol 1e-5 for one pass and for one or five iterations.  Ten float32
iterations are held to 5e-5: one iteration leaves the two packages
1.5e-6 apart (each float32 digamma is ~1.3e-6 off in absolute terms, and
sums run in another order), and the CAVI iterations of this small problem
grow the gap about 1.45x per iteration, largest in G_shp: 6.3e-6 after
five iterations and 4.39e-5 after ten (untiled; 4.03e-5 tiled).  float64
shows the same growth, 4e-15 after one iteration, 5e-14 after ten."""

import numpy as np
import pytest
import torch

from oracle import synth_counts


@pytest.fixture(autouse=True)
def _restore_x64():
    """Leave jax_enable_x64 as the test found it: the flag is process-wide
    and would leak into the next test file on this worker."""
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


def _csr(y, rows, cols, n_rows, n_cols):
    from scipy.sparse import coo_array

    X = coo_array((y, (rows, cols)), shape=(n_rows, n_cols)).tocsr()
    return X.indptr.astype(np.int64), X.indices.astype(np.int32), X.data


def _x64(dtype):
    if dtype == np.float64:
        import jax

        jax.config.update("jax_enable_x64", True)


def _skewed(nU, nI, nnz, seed, dtype):
    """Counts with a heavy item head (so item rows split) and a few
    zero-degree users at the end."""
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, nU - 3, nnz)
    ii = np.minimum(rng.zipf(1.4, nnz) - 1, nI - 1)
    key = np.unique(iu * nI + ii)
    y = (rng.poisson(2.0, len(key)) + 1).astype(dtype)
    return y, (key // nI).astype(np.int32), (key % nI).astype(np.int32)


LAYOUT_CASES = {
    "untiled": dict(),
    "tiled": dict(col_chunk_rows=17),
    "split_rows": dict(max_width=8),
    "tiled_split": dict(max_width=8, col_chunk_rows=11),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
@pytest.mark.parametrize("side", ["user", "item"])
def test_build_ell_identical_to_jax(case, side):
    from hpfrec_tpu.ops import ell as J
    from hpfrec_tpu_torch.ops import ell as T

    nU, nI = 150, 90
    y, iu, ii = _skewed(nU, nI, 3000, seed=5, dtype=np.float32)
    if side == "item":
        iu, ii, nU, nI = ii, iu, nI, nU
    indptr, ind, dat = _csr(y, iu, ii, nU, nI)
    kw = dict(LAYOUT_CASES[case], n_cols=nI)
    lj = J.build_ell(indptr, ind, dat, nU, **kw)
    lt = T.build_ell(indptr, ind, dat, nU, **kw)
    assert len(lj.buckets) == len(lt.buckets)
    for bj, bt in zip(lj.buckets, lt.buckets):
        for a, b in zip(bj, bt):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for name in ("inv_perm", "split_rows", "split_seg_pos"):
        a, b = getattr(lj, name), getattr(lt, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (lj.n_rows, lj.col_spans) == (lt.n_rows, lt.col_spans)
    assert J.layout_slots(lj) == T.layout_slots(lt)
    if case in ("split_rows", "tiled_split") and side == "item":
        assert lt.split_rows.shape[0] > 0  # the case does exercise split rows


@pytest.mark.parametrize("n,k,itemsize", [(1000, 50, 4), (1_019_318, 50, 4),
                                          (376_768, 50, 2), (300_000, 64, 8)])
def test_plan_col_tiling_matches_jax(n, k, itemsize):
    from hpfrec_tpu.ops.ell import plan_col_tiling as pj
    from hpfrec_tpu_torch.ops.ell import plan_col_tiling as pt

    assert pj(n, k, itemsize) == pt(n, k, itemsize)


def test_to_device_split_csr():
    """The per-row CSR over split chunks covers each split row's chunks."""
    from hpfrec_tpu_torch.ops.ell import build_ell, to_device

    y, iu, ii = _skewed(150, 90, 3000, seed=5, dtype=np.float32)
    indptr, ind, dat = _csr(y, ii, iu, 90, 150)
    lay = build_ell(indptr, ind, dat, 90, max_width=8)
    dev = to_device(lay, "cpu")
    ip = dev.split_indptr.numpy()
    counts = np.bincount(lay.split_rows, minlength=90)
    np.testing.assert_array_equal(np.diff(ip), counts)
    assert dev.inv_perm.dtype == torch.int32 and dev.split_seg_pos.dtype == torch.int32
    assert dev.n_segs == sum(b.rows.shape[0] for b in lay.buckets)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-5)])
@pytest.mark.parametrize("chunk", [None, 17])
def test_ell_phi_sums_matches_jax(dtype, rtol, chunk):
    import jax.numpy as jnp

    from hpfrec_tpu.ops import ell as J
    from hpfrec_tpu_torch.ops import ell as T

    _x64(dtype)
    nU, nI, k = 150, 90, 9
    y, iu, ii = _skewed(nU, nI, 3000, seed=2, dtype=dtype)
    rng = np.random.default_rng(3)
    t_tab = (rng.random((nU, k)) + 0.01).astype(dtype)
    b_tab = (rng.random((nI, k)) + 0.01).astype(dtype)
    for rows, cols, n_r, n_c, ts, to in ((iu, ii, nU, nI, t_tab, b_tab),
                                         (ii, iu, nI, nU, b_tab, t_tab)):
        indptr, ind, dat = _csr(y, rows, cols, n_r, n_c)
        kw = dict(max_width=8, dtype=dtype, col_chunk_rows=chunk, n_cols=n_c)
        ref = np.asarray(J.ell_phi_sums(jnp.asarray(ts), jnp.asarray(to),
                                        J.device_ell(J.build_ell(indptr, ind, dat, n_r, **kw))))
        lay = T.to_device(T.build_ell(indptr, ind, dat, n_r, **kw), "cpu")
        out = T.ell_phi_sums(torch.from_numpy(ts), torch.from_numpy(to), lay)
        assert out.dtype == torch.from_numpy(ts).dtype
        np.testing.assert_allclose(out.numpy(), ref, rtol=rtol, atol=0)


K2_FORMS = {"float32": (np.float32, None, 1e-5), "float64": (np.float64, None, 1e-12),
            "float32_float64": (np.float32, torch.float64, 1e-5)}


@pytest.mark.parametrize("form", sorted(K2_FORMS))
@pytest.mark.parametrize("k", [1, 9])
def test_segment_table_sums_plain_matches_jax(form, k):
    """K2's plain version (and the wrapper on CPU tensors) against JAX's
    ``segment_table_sums`` on an item layout at max_width 2: split rows of
    up to 19 chunks (76 extra segments, many more than 2P), chunks padded
    with -1, and empty rows; float32 sums written as float64 are JAX's
    sums cast after the reassembly (``ell.py:726-727``).  The two add a
    chunk's positions in other orders: float64 rtol 1e-12, float32 1e-5,
    each with an atol of rtol x max |sum| for sums that cancel to near 0."""
    import jax.numpy as jnp

    from hpfrec_tpu.ops import ell as J
    from hpfrec_tpu_torch.ops import ell as T

    dtype, out_dtype, rtol = K2_FORMS[form]
    _x64(dtype)
    y, iu, ii = _skewed(150, 90, 3000, seed=2, dtype=dtype)
    indptr, ind, dat = _csr(y, ii, iu, 90, 150)
    host = T.build_ell(indptr, ind, dat, 90, max_width=2, dtype=dtype, n_cols=150)
    chunks = np.bincount(host.split_rows, minlength=90)
    # a row of three chunks or more has over 2P extra segments
    assert chunks.max() > 2 and (np.diff(indptr) == 0).any() and (host.split_seg_pos < 0).any()
    lay = T.to_device(host, "cpu")
    seg = np.random.default_rng(k).standard_normal((lay.n_segs, k)).astype(dtype)
    ref = np.asarray(J.segment_table_sums(jnp.asarray(seg), J.device_ell(
        J.build_ell(indptr, ind, dat, 90, max_width=2, dtype=dtype, n_cols=150))))
    plain = T._segment_table_sums_plain(torch.from_numpy(seg), lay)
    got = T.segment_table_sums(torch.from_numpy(seg), lay, out_dtype)
    assert got.dtype == (out_dtype or plain.dtype) and got.shape == (90, k)
    assert torch.equal(got, plain.to(got.dtype))
    np.testing.assert_allclose(got.numpy(), ref.astype(got.numpy().dtype), rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("dtype,niter,rtol", [(np.float64, 1, 1e-10),
                                               (np.float64, 10, 1e-10),
                                               (np.float32, 1, 1e-5),
                                               (np.float32, 5, 1e-5),
                                               (np.float32, 10, 5e-5)])
@pytest.mark.parametrize("chunk", [None, 13])
def test_run_cavi_block_ell_matches_jax(dtype, niter, rtol, chunk):
    import jax.numpy as jnp

    from hpfrec_tpu.models import state as SJ
    from hpfrec_tpu.ops import ell as J
    from hpfrec_tpu_torch.models import state as ST
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as T

    _x64(dtype)
    nU, nI, k = 90, 70, 6
    y, iu, ii = synth_counts(nU, nI, nnz=1200, seed=9, dtype=dtype)
    hp_j = SJ.Hyperparams(k=k)
    hp_t = ST.Hyperparams(k=k)
    lay_j, lay_t = [], []
    for rows, cols, n_r, n_c in ((iu, ii, nU, nI), (ii, iu, nI, nU)):
        indptr, ind, dat = _csr(y, rows, cols, n_r, n_c)
        kw = dict(max_width=16, dtype=dtype, col_chunk_rows=chunk, n_cols=n_c)
        lay_j.append(J.device_ell(J.build_ell(indptr, ind, dat, n_r, **kw)))
        lay_t.append(T.to_device(T.build_ell(indptr, ind, dat, n_r, **kw), "cpu"))
    ref = J.run_cavi_block_ell(SJ.initialize_state(nU, nI, hp_j, 5, dtype),
                               *lay_j, jnp.asarray(niter, jnp.int32), hp_j)
    carry = T.run_cavi_block_ell(
        C._carry_init(ST.initialize_state(nU, nI, hp_t, 5, dtype)), *lay_t,
        niter, hp_t)
    for ours, theirs in zip(carry.state, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=rtol, atol=0)
    # the carried colsums belong to the returned state
    st = carry.state
    np.testing.assert_allclose(carry.theta_colsum.numpy(),
                               (st.G_shp / st.G_rte).sum(0, keepdim=True).numpy(),
                               rtol=1e-5 if dtype == np.float32 else 1e-12)
    np.testing.assert_allclose(carry.beta_colsum.numpy(),
                               (st.L_shp / st.L_rte).sum(0, keepdim=True).numpy(),
                               rtol=1e-5 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_carry_equals_rederived(dtype):
    """A block's final carry holds the exp tables and colsums that deriving
    them afresh from its state gives, bit for bit, so a fit passes the carry
    from block to block instead of deriving it again."""
    from hpfrec_tpu_torch.models import state as ST
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as T

    nU, nI, k = 90, 70, 6
    y, iu, ii = synth_counts(nU, nI, nnz=1200, seed=9, dtype=dtype)
    lays = [T.to_device(T.build_ell(*_csr(y, r, c, n_r, n_c), n_r, max_width=16,
                                    dtype=dtype), "cpu")
            for r, c, n_r, n_c in ((iu, ii, nU, nI), (ii, iu, nI, nU))]
    hp = ST.Hyperparams(k=k)
    carry = T.run_cavi_block_ell(
        C._carry_init(ST.initialize_state(nU, nI, hp, 5, dtype)), *lays, 3, hp)
    fresh = C._carry_init(carry.state)
    for name in ("t_tab", "b_tab", "theta_colsum", "beta_colsum"):
        np.testing.assert_array_equal(getattr(carry, name).numpy(),
                                      getattr(fresh, name).numpy())
