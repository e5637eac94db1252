"""Mini-batch SVI of hpfrec_tpu_torch (ops/svi.py and HPF's SVI fit)
against hpfrec_tpu on the same inputs, on the CPU: the epoch stream (K9),
the batch phi sums and masks (K7), the SVI blend (K8), one epoch of the
runner against ``svi_run_batches`` with the same permutation, and whole
SVI fits through ``HPF`` (users only, items only, alternating).

Tolerances: float64 rtol 1e-10 per op and per epoch (measured <= 4.5e-16
per op, 4.3e-15 per epoch), whole fits: factors 1e-9, llk trace 1e-10.
float32: per op rtol 2e-6 (measured <= 1.14e-6: the port's plain phi sums
add in float64, the JAX ones in float32), one epoch 1e-5 (measured
1.3e-6), whole fits of six epochs: factors 5e-5 (measured 1.6e-5), llk
trace 3e-6 (measured 6.0e-7).  The integer outputs (epoch stream, masks)
are exact."""

import numpy as np
import pandas as pd
import pytest
import torch

from oracle import synth_counts
from test_torch_kernels import EPOCH_CASES, epoch_case


@pytest.fixture(autouse=True)
def _restore_x64():
    """Leave jax_enable_x64 as the test found it: the flag is process-wide
    and would leak into the next test file on this worker."""
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


def _x64(dtype):
    import jax

    jax.config.update("jax_enable_x64", dtype == np.float64)


OP_RTOL = {np.float64: 1e-10, np.float32: 2e-6}
EPOCH_RTOL = {np.float64: 1e-10, np.float32: 1e-5}


def _csr(nU, nI, nnz, seed, dtype, long_row=None):
    """CSR (row-sorted COO) over synthetic counts; ``long_row`` gives row 0
    that many extra slots, a third of them on column 1 (duplicate
    other-side ids stay separate entries, as in a fit's CSR)."""
    y, iu, ii = synth_counts(nU, nI, nnz=nnz, seed=seed, dtype=np.float64)
    if long_row:
        rng = np.random.default_rng(seed + 1)
        extra = rng.integers(0, nI, long_row)
        extra[::3] = 1
        y = np.concatenate([y, rng.poisson(2.0, long_row) + 1.0])
        iu = np.concatenate([iu, np.zeros(long_row, dtype=iu.dtype)])
        ii = np.concatenate([ii, extra.astype(ii.dtype)])
    order = np.argsort(iu, kind="stable")
    indptr = np.zeros(nU + 1, dtype=np.int64)
    np.cumsum(np.bincount(iu, minlength=nU), out=indptr[1:])
    return indptr, ii[order].astype(np.int32), y[order].astype(dtype)


def _tables(n, k, dtype, seed, lo=0.05):
    return (np.random.default_rng(seed).random((n, k)) + lo).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_build_epoch_buffers_matches_jax(dtype):
    """K9's plain version against the JAX function: the real prefix of the
    stream (JAX pads it by p_cap) and the row offsets."""
    import jax.numpy as jnp

    from hpfrec_tpu.ops.svi import build_epoch_buffers as bj
    from hpfrec_tpu_torch.ops import svi as S

    _x64(dtype)
    indptr, cols, y = _csr(50, 30, 700, seed=1, dtype=dtype, long_row=300)
    perm = np.random.default_rng(2).permutation(50)
    side = S.epoch_side(indptr, cols, y, dtype, "cpu")
    offsets = S.epoch_offsets(side.deg, perm)
    got = S.build_epoch_buffers(side.y, side.cols, side.indptr,
                                torch.from_numpy(perm.astype(np.int32)),
                                torch.from_numpy(offsets.astype(np.int32)))
    ref = bj(jnp.asarray(y), jnp.asarray(cols), jnp.asarray(indptr.astype(np.int32)),
             jnp.asarray(perm.astype(np.int32)), 1024)
    nnz = len(y)
    np.testing.assert_array_equal(offsets, np.asarray(ref[3]))
    for g, r in zip(got, ref[:3]):
        assert g.shape == (nnz,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r)[:nnz])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", EPOCH_CASES)
def test_build_epoch_buffers_tile_cases_match_jax(dtype, case):
    """K9's plain version against the JAX function on the edge cases of the
    kernel's 2,048-position tiles (``test_torch_kernels.epoch_case``): a run
    of zero-degree rows longer than a tile, zero-degree rows first and
    last, one row holding almost every nonzero, a single row, nnz not a
    multiple of the tile.  Exact, with the offsets."""
    import jax.numpy as jnp

    from hpfrec_tpu.ops.svi import build_epoch_buffers as bj
    from hpfrec_tpu_torch.ops import svi as S

    _x64(dtype)
    indptr, cols, y, perm = epoch_case(case)
    y = y.astype(dtype)
    side = S.epoch_side(indptr, cols, y, dtype, "cpu")
    offsets = S.epoch_offsets(side.deg, perm)
    got = S.build_epoch_buffers(side.y, side.cols, side.indptr,
                                torch.from_numpy(perm.astype(np.int32)),
                                torch.from_numpy(offsets.astype(np.int32)))
    ref = bj(jnp.asarray(y), jnp.asarray(cols), jnp.asarray(indptr.astype(np.int32)),
             jnp.asarray(perm.astype(np.int32)), 16)
    nnz = len(y)
    np.testing.assert_array_equal(offsets, np.asarray(ref[3]))
    for g, r in zip(got, ref[:3]):
        assert g.shape == (nnz,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r)[:nnz])


def test_epoch_offsets_with_empty_rows():
    from hpfrec_tpu_torch.ops.svi import batch_multipliers, epoch_offsets

    deg = np.array([3, 0, 5, 0, 2])
    np.testing.assert_array_equal(epoch_offsets(deg, np.array([4, 1, 0, 3, 2])),
                                  [0, 2, 2, 5, 5, 10])
    np.testing.assert_array_equal(batch_multipliers(5, 2, np.float32),
                                  np.array([2.5, 2.5, 5.0], dtype=np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("user_side", [True, False])
def test_batch_phi_sums_match_jax(dtype, user_side):
    """K7's plain version on a batch with a row much longer than the rest
    and duplicate other-side ids, against the JAX chunk body
    (phi_sums_tables plus the set-True scatter of the other-side mask)."""
    import jax.numpy as jnp

    from hpfrec_tpu.ops.svi import build_row_mask as mj
    from hpfrec_tpu.ops.svi import phi_sums_tables as pj
    from hpfrec_tpu_torch.ops import svi as S

    _x64(dtype)
    n_loc, n_oth, k = 50, 30, 6
    indptr, cols, y = _csr(n_loc, n_oth, 700, seed=3, dtype=dtype, long_row=400)
    side = S.epoch_side(indptr, cols, y, dtype, "cpu")
    perm = np.random.default_rng(4).permutation(n_loc)
    off = S.epoch_offsets(side.deg, perm)
    perm_t = torch.from_numpy(perm.astype(np.int32))
    off_t = torch.from_numpy(off.astype(np.int32))
    e_y, e_row, e_col = S.build_epoch_buffers(side.y, side.cols, side.indptr, perm_t, off_t)
    r0, r1 = 10, 40
    s, e = int(off[r0]), int(off[r1])
    t_loc, t_oth = _tables(n_loc, k, dtype, 5), _tables(n_oth, k, dtype, 6)
    s_loc, s_oth, omask = S.batch_phi_sums(
        torch.from_numpy(t_loc), torch.from_numpy(t_oth), e_y[s:e], e_row[s:e], e_col[s:e],
        off_t[r0:r1 + 1], s, perm_t[r0:r1])
    yb, rb, cb = (jnp.asarray(a[s:e].numpy()) for a in (e_y, e_row, e_col))
    t_tab, b_tab = (t_loc, t_oth) if user_side else (t_oth, t_loc)
    iu, ii = (rb, cb) if user_side else (cb, rb)
    su, si = pj(jnp.asarray(t_tab), jnp.asarray(b_tab), yb, iu, ii)
    ref_loc, ref_oth = (su, si) if user_side else (si, su)
    np.testing.assert_allclose(s_loc.numpy(), np.asarray(ref_loc), rtol=OP_RTOL[dtype])
    np.testing.assert_allclose(s_oth.numpy(), np.asarray(ref_oth), rtol=OP_RTOL[dtype])
    np.testing.assert_array_equal(omask.numpy(), np.asarray(mj(n_oth, cb)))
    assert bool(omask[1]) and int(perm[r0:r1].tolist().count(0)) == int(s_loc[0].any())


def test_build_row_mask_matches_jax():
    import jax.numpy as jnp

    from hpfrec_tpu.ops.svi import build_row_mask as mj
    from hpfrec_tpu_torch.ops.svi import build_row_mask as mt

    rows = np.array([5, 0, 9, 5, 2], dtype=np.int32)
    np.testing.assert_array_equal(mt(11, torch.from_numpy(rows)).numpy(),
                                  np.asarray(mj(11, jnp.asarray(rows))))


def _state_arrays(nU, nI, k, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s, lo=0.3, hi=3.0: (lo + (hi - lo) * rng.random(s)).astype(dtype)  # noqa: E731
    return [t(nU, k), t(nU, k, lo=20, hi=60), t(nI, k), t(nI, k, lo=20, hi=60),
            t(nU, 1), t(nI, 1)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("user_side", [True, False])
@pytest.mark.parametrize("blend_all", [False, True])
def test_svi_update_math_matches_jax(dtype, user_side, blend_all):
    import jax.numpy as jnp

    from hpfrec_tpu.models.state import Hyperparams as HJ
    from hpfrec_tpu.models.state import VariationalState as VJ
    from hpfrec_tpu.ops.svi import _svi_update_math as uj
    from hpfrec_tpu_torch.models.state import Hyperparams, state_from_numpy
    from hpfrec_tpu_torch.ops.svi import svi_update

    _x64(dtype)
    nU, nI, k = 40, 25, 6
    arrays = _state_arrays(nU, nI, k, dtype, 1)
    rng = np.random.default_rng(2)
    umask = rng.random((nU, 1)) < 0.4
    imask = rng.random((nI, 1)) < 0.5
    su = (_tables(nU, k, dtype, 3) * umask * 5).astype(dtype)
    si = (_tables(nI, k, dtype, 4) * imask * 5).astype(dtype)
    step, mult = 0.41, 7.5
    shp, rte = (arrays[2], arrays[3]) if user_side else (arrays[0], arrays[1])
    colsum_global = torch.from_numpy((shp / rte).sum(0, keepdims=True))
    got = svi_update(state_from_numpy(arrays, "cpu"), torch.from_numpy(su),
                     torch.from_numpy(si), torch.from_numpy(umask), torch.from_numpy(imask),
                     step, mult, Hyperparams(k=k), user_side, blend_all, colsum_global)
    ref = uj(VJ(*[jnp.asarray(a) for a in arrays]), jnp.asarray(su), jnp.asarray(si),
             jnp.asarray(umask), jnp.asarray(imask), jnp.asarray(step, dtype),
             jnp.asarray(mult, dtype), HJ(k=k), user_side, blend_all)
    for g, r in zip(got, ref):
        assert g.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=OP_RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("user_side", [True, False])
def test_one_epoch_matches_svi_run_batches(dtype, user_side):
    """The port's epoch runner against the JAX device-resident epoch
    (build_epoch_buffers + svi_run_batches) with the same permutation,
    batch size, step and multipliers; one batch holds a row with 1500 extra
    slots, so that batch spans two JAX chunks of 1024."""
    import jax.numpy as jnp

    from hpfrec_tpu.models.state import Hyperparams as HJ
    from hpfrec_tpu.models.state import VariationalState as VJ
    from hpfrec_tpu.ops.svi import build_epoch_buffers as bj
    from hpfrec_tpu.ops.svi import svi_run_batches
    from hpfrec_tpu.utils.data import _next_pow2
    from hpfrec_tpu_torch.models.state import Hyperparams, state_from_numpy
    from hpfrec_tpu_torch.ops import svi as S

    _x64(dtype)
    nU, nI, k, B = 50, 30, 5, 12
    n_loc, n_oth = (nU, nI) if user_side else (nI, nU)
    indptr, cols, y = _csr(n_loc, n_oth, 800, seed=7, dtype=dtype, long_row=1500)
    arrays = _state_arrays(nU, nI, k, dtype, 8)
    perm = np.random.default_rng(9).permutation(n_loc)
    step = 0.37
    got = S.svi_run_epoch(state_from_numpy(arrays, "cpu"),
                          S.epoch_side(indptr, cols, y, dtype, "cpu"), perm, B, step,
                          Hyperparams(k=k), user_side)

    nb = -(-n_loc // B)
    perm_p = np.full(nb * B, perm[-1], dtype=np.int32)
    perm_p[:n_loc] = perm
    p_cap = _next_pow2(max(len(y) // nb // 2, 1024))
    assert p_cap == 1024 and int(np.diff(indptr).max()) > p_cap
    bufs = bj(jnp.asarray(y), jnp.asarray(cols), jnp.asarray(indptr.astype(np.int32)),
              jnp.asarray(perm_p), p_cap)
    ref = svi_run_batches(VJ(*[jnp.asarray(a) for a in arrays]), *bufs, jnp.asarray(perm_p),
                          jnp.asarray(S.batch_multipliers(n_loc, B, dtype)),
                          jnp.asarray(step, dtype), jnp.asarray(0, jnp.int32),
                          jnp.asarray(nb, jnp.int32), HJ(k=k), user_side, B, nb, p_cap)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=EPOCH_RTOL[dtype])


# ---- whole fits ------------------------------------------------------------

FIT_TOL = {np.float64: dict(factors=1e-9, llk=1e-10),
           np.float32: dict(factors=5e-5, llk=3e-6)}


def _df(nU=60, nI=40, nnz=900, seed=4):
    y, iu, ii = synth_counts(nU, nI, nnz=nnz, seed=seed, dtype=np.float64)
    return pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})


def _fit_both(kw, df, val=None, monkeypatch=None):
    """The same fit in hpfrec_tpu (one device) and the port (CPU), each with
    its llk at every check."""
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    out = []
    for cls, extra in ((HJ, dict(mesh=make_mesh(jax.devices()[:1]))), (HT, dict(device="cpu"))):
        trace = []
        orig = cls._evaluate_criterion

        def rec(self, *a, _orig=orig, _trace=trace, **k):
            res = _orig(self, *a, **k)
            _trace.append(self._last_llk)
            return res

        monkeypatch.setattr(cls, "_evaluate_criterion", rec)
        fit_kw = {} if val is None else dict(val_set=val.copy())
        m = cls(**kw, **extra).fit(df.copy(), **fit_kw)
        out.append((m, np.array(trace)))
    return out


def assert_fits_match(pair, dtype, llk_atol=0.0):
    (mj, tj), (mt, tt) = pair
    tol = FIT_TOL[dtype]
    assert mt.niter == mj.niter
    assert mt.Theta.dtype == dtype
    np.testing.assert_allclose(mt.Theta, mj.Theta, rtol=tol["factors"])
    np.testing.assert_allclose(mt.Beta, mj.Beta, rtol=tol["factors"])
    assert len(tt) == len(tj)
    np.testing.assert_allclose(tt, tj, rtol=tol["llk"], atol=llk_atol)
    if mj.train_llk is not None:
        np.testing.assert_allclose(mt.train_llk, mj.train_llk, rtol=tol["llk"],
                                   atol=llk_atol)


SVI_MODES = {"users": (13, None), "items": (None, 11), "alternating": (13, 11)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", list(SVI_MODES))
def test_svi_fit_matches_jax(mode, dtype, monkeypatch):
    """Whole SVI fits with train-llk checks every 2 epochs over 6 epochs:
    the same niter, factors and llk at every check."""
    _x64(dtype)
    upb, ipb = SVI_MODES[mode]
    kw = dict(k=5, maxiter=6, check_every=2, stop_crit="train-llk", stop_thr=1e-12,
              users_per_batch=upb, items_per_batch=ipb, use_float=dtype == np.float32,
              verbose=False, random_seed=77)
    pair = _fit_both(kw, _df(), monkeypatch=monkeypatch)
    assert len(pair[1][1]) == 3
    assert_fits_match(pair, dtype)


def test_svi_fit_stops_early_like_jax(monkeypatch):
    """A train-llk SVI fit that meets its threshold stops at the same epoch
    in both packages, with a reindexed DataFrame and serving metadata."""
    _x64(np.float64)
    kw = dict(k=4, maxiter=30, check_every=3, stop_crit="train-llk", stop_thr=2e-2,
              users_per_batch=20, items_per_batch=15, use_float=False, verbose=False,
              random_seed=3)
    pair = _fit_both(kw, _df(seed=9), monkeypatch=monkeypatch)
    (mj, _), (mt, _) = pair
    assert mt.niter < 29
    assert_fits_match(pair, np.float64)
    np.testing.assert_array_equal(mt.seen, mj.seen)
    np.testing.assert_array_equal(mt._st_ix_user, mj._st_ix_user)
    np.testing.assert_array_equal(mt._n_seen_by_user, mj._n_seen_by_user)
    users = mj.user_mapping_[:5]
    for u in users:
        np.testing.assert_array_equal(mt.topN(u, n=5), mj.topN(u, n=5))
    assert set(mt.fit_stats_.phases) >= {"user_epochs", "item_epochs", "metric_checks"}


def test_users_per_batch_above_nusers_warns_and_resets():
    from hpfrec_tpu_torch import HPF

    m = HPF(k=3, maxiter=2, check_every=1, users_per_batch=1000, verbose=False, random_seed=2,
            device="cpu")
    with pytest.warns(UserWarning, match="larger than number of users"):
        m.fit(_df(nU=30, nI=20, nnz=300))
    assert m.users_per_batch == 3 and m.is_fitted


@pytest.mark.parametrize("crit", ["maxiter", "diff-norm"])
def test_svi_stop_criteria_match_jax(crit, capsys):
    """The other two criteria in SVI mode, verbose: the same progress lines,
    stopping epoch and final llk (a train-llk pass over the metric layout
    after the last epoch, as the reference's eval_after_term)."""
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    _x64(np.float64)
    kw = dict(k=4, maxiter=12, check_every=3, stop_crit=crit, stop_thr=0.05,
              users_per_batch=20, items_per_batch=15, use_float=False, verbose=True,
              random_seed=6)
    df = _df(seed=12)
    mj = HJ(mesh=make_mesh(jax.devices()[:1]), **kw).fit(df.copy())
    out_j = capsys.readouterr().out
    mt = HT(device="cpu", **kw).fit(df.copy())
    out_t = capsys.readouterr().out
    assert mt.niter == mj.niter
    np.testing.assert_allclose(mt.train_llk, mj.train_llk, rtol=1e-10)
    np.testing.assert_allclose(mt.Theta, mj.Theta, rtol=1e-9)
    keep = ("Iteration", "Final", "Number of", "Latent", "Creating")
    lines = lambda s: [ln for ln in s.splitlines() if ln.startswith(keep)]  # noqa: E731
    assert lines(out_t) == lines(out_j) and any(ln.startswith("Iteration") for ln in lines(out_t))
