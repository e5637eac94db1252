"""K4's plain version (hpfrec_tpu_torch.ops.metrics) against
hpfrec_tpu.ops.metrics.ell_train_llk_rmse, with and without full_llk, on
untiled and tiled layouts; and theta_diff_norm.

Tolerances: float64 rtol 1e-10 on llk and rmse (both packages round the
colsum correction to float32 the same way); float32 rtol 1e-5."""

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


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-5)])
@pytest.mark.parametrize("full_llk", [False, True])
@pytest.mark.parametrize("chunk", [None, 19])
def test_ell_train_llk_rmse_matches_jax(dtype, rtol, full_llk, chunk):
    import jax
    import jax.numpy as jnp

    from hpfrec_tpu.ops import ell as EJ
    from hpfrec_tpu.ops import metrics as MJ
    from hpfrec_tpu_torch.ops import ell as ET
    from hpfrec_tpu_torch.ops import metrics as MT

    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    nU, nI, k = 120, 80, 8
    y, iu, ii = synth_counts(nU, nI, nnz=2000, seed=4, dtype=dtype)
    rng = np.random.default_rng(5)
    Theta = (rng.random((nU, k)) * 0.5).astype(dtype)
    Beta = (rng.random((nI, k)) * 0.5).astype(dtype)
    indptr, ind, dat = _csr(y, iu, ii, nU, nI)
    kw = dict(max_width=16, dtype=dtype, col_chunk_rows=chunk, n_cols=nI)
    lay_j = EJ.device_ell(EJ.build_ell(indptr, ind, dat, nU, **kw))
    lay_t = ET.to_device(ET.build_ell(indptr, ind, dat, nU, **kw), "cpu")
    ref = MJ.ell_train_llk_rmse(jnp.asarray(Theta), jnp.asarray(Beta), lay_j,
                                len(y), full_llk)
    th, be = torch.from_numpy(Theta), torch.from_numpy(Beta)
    got = MT.ell_train_llk_rmse(th, be, lay_t, len(y), th.sum(0, keepdim=True),
                                be.sum(0, keepdim=True), full_llk)
    np.testing.assert_allclose(got, ref, rtol=rtol)


def test_llk_partials_are_float64_per_bucket():
    from hpfrec_tpu_torch.ops import ell as ET
    from hpfrec_tpu_torch.ops import metrics as MT

    y, iu, ii = synth_counts(60, 45, nnz=800, seed=1)
    indptr, ind, dat = _csr(y, iu, ii, 60, 45)
    lay = ET.to_device(ET.build_ell(indptr, ind, dat, 60), "cpu")
    parts = MT.ell_llk_rmse_sums(torch.ones(60, 3), torch.ones(45, 3), lay)
    assert parts.dtype == torch.float64 and parts.shape == (len(lay.buckets), 3)
    # yhat = 3 everywhere: sp = 3 * nnz, ll = sum(y) * log(3)
    np.testing.assert_allclose(parts[:, 2].sum().item(), 3.0 * len(y))
    np.testing.assert_allclose(parts[:, 0].sum().item(), y.sum() * np.log(3.0), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_theta_diff_norm_matches_jax(dtype):
    import jax
    import jax.numpy as jnp

    from hpfrec_tpu.ops.metrics import theta_diff_norm as nj
    from hpfrec_tpu_torch.ops.metrics import theta_diff_norm as nt

    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(0)
    a, b = rng.random((30, 6)).astype(dtype), rng.random((30, 6)).astype(dtype)
    np.testing.assert_allclose(nt(torch.from_numpy(a), torch.from_numpy(b)),
                               float(nj(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6 if dtype == np.float32 else 1e-13)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 2e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("k", [7, 50, 256])
def test_predict_pairs_matches_jax(dtype, rtol, k):
    """K11's ``predict_pairs`` (its plain version and the wrapper on CPU
    tensors) and ``sum_pairs_prediction`` against JAX's, on 3,001 pairs
    (repeated rows included) made with numpy.  The sums over k run in
    another order: float64 rtol 1e-12; float32 the kernel tests' 2e-5 (the
    pair sum 1e-5 over 3,001 positive terms)."""
    import jax
    import jax.numpy as jnp

    from hpfrec_tpu.ops import metrics as MJ
    from hpfrec_tpu_torch.ops import metrics as MT

    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(k)
    Theta = (rng.random((70, k)) / k).astype(dtype)
    Beta = rng.random((40, k)).astype(dtype)
    iu = rng.integers(0, 70, 3001).astype(np.int32)
    ii = rng.integers(0, 40, 3001).astype(np.int32)
    ref = np.asarray(MJ.predict_pairs(jnp.asarray(Theta), jnp.asarray(Beta), jnp.asarray(iu),
                                      jnp.asarray(ii)))
    ref_sum = float(MJ.sum_pairs_prediction(jnp.asarray(Theta), jnp.asarray(Beta),
                                            jnp.asarray(iu), jnp.asarray(ii)))
    args = [torch.from_numpy(a) for a in (Theta, Beta, iu, ii)]
    got = MT.predict_pairs(*args)
    assert got.dtype == args[0].dtype and got.shape == (3001,)
    assert torch.equal(got, MT._pairs_plain(*args))
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol)
    np.testing.assert_allclose(MT.sum_pairs_prediction(*args), ref_sum,
                               rtol=1e-5 if dtype == np.float32 else rtol)


@pytest.mark.parametrize("n", [1, 31, 33, 65_536, 100_000, 387_000, 1 << 22, 10 ** 9])
def test_pairs_grid_covers_n_and_fills_the_card(n):
    """predict_pairs' grid: a warp's run a multiple of 32 pairs, the blocks
    (8 warps) cover n exactly once, a launch of 100,000 pairs or more has at
    least 2.9 blocks for each of an H100's 132 SMs, and none more blocks
    than 132 x 8 (the run grows instead)."""
    from hpfrec_tpu_torch.ops.metrics import _pairs_grid

    per_warp, blocks = _pairs_grid(n)
    assert per_warp % 32 == 0 and per_warp >= 32
    assert (blocks - 1) * 8 * per_warp < n <= blocks * 8 * per_warp
    assert blocks <= 132 * 8
    if n >= 100_000:
        assert blocks >= 2.9 * 132
    assert _pairs_grid(n) == (per_warp, blocks)
