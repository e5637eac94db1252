"""The validation path of hpfrec_tpu_torch against hpfrec_tpu on the CPU:
the validation-set pipeline and blocked COO layout, K5 (``llk_rmse_sums``
/ ``val_llk_rmse``), ``rowsum_dot_rows``, the val-llk criterion on the
full-batch and the SVI fit, the switch of an empty validation set to
train-llk, the final eval of a maxiter fit with a validation set, and
``eval_llk``.

Tolerances: float64 rtol 1e-10 (fits: factors 1e-9), float32 K5 sums rtol
1e-5 (the port's plain version adds each block's terms in float64, the JAX
one in float32; measured 2.0e-7), float32 fits as in test_torch_svi
(factors 5e-5, llk 3e-6, plus an absolute 1e-4 on the val llk, which
cancels to small values; measured here: factors 3.4e-6 full batch and up
to 1.67e-5 SVI, val llk 3.6e-5 absolute), float32 eval_llk after the two
packages' own fits rtol 1e-5 (measured 3.7e-7)."""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from oracle import synth_counts
from test_torch_svi import _fit_both, assert_fits_match


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


def _split(nU=60, nI=40, nnz=900, seed=4, frac=0.15):
    y, iu, ii = synth_counts(nU, nI, nnz=nnz, seed=seed, dtype=np.float64)
    df = pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})
    hold = np.random.default_rng(seed + 100).random(len(df)) < frac
    return df[~hold].reset_index(drop=True), df[hold].reset_index(drop=True)


def _mappings():
    rng = np.random.default_rng(0)
    return rng.permutation(np.arange(100, 160)), rng.permutation(np.arange(500, 540))


@pytest.mark.parametrize("form", ["DataFrame", "ndarray", "coo"])
def test_process_valset_matches_jax(form):
    """The same triplets in each input form; reindexed (DataFrame, ndarray:
    unknown ids and zero counts dropped) and raw (coo)."""
    from scipy.sparse import coo_array

    from hpfrec_tpu.utils.data import process_valset as pj
    from hpfrec_tpu_torch.utils.data import process_valset as pt

    um, im = _mappings()
    rng = np.random.default_rng(1)
    u = rng.integers(95, 165, 300)
    i = rng.integers(495, 545, 300)
    y = rng.poisson(1.0, 300).astype(np.float64)
    if form == "DataFrame":
        data, reindex = pd.DataFrame({"UserId": u, "ItemId": i, "Count": y}), True
    elif form == "ndarray":
        data, reindex = np.column_stack([u, i, y]), True
    else:
        data, reindex = coo_array((y + 1, (u - 95, i - 495)), shape=(70, 50)), False
    kw = dict(stop_crit="val-llk", reindex=reindex, user_mapping=um, item_mapping=im,
              nusers=70, nitems=50, dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, ref = pt(data, **kw), pj(data, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_process_valset_empty():
    """No pair in common: a validation set warns and gives None; an eval
    set raises."""
    from hpfrec_tpu_torch.utils.data import process_valset

    um, im = _mappings()
    df = pd.DataFrame({"UserId": [1, 2], "ItemId": [3, 4], "Count": [1.0, 2.0]})
    kw = dict(stop_crit="val-llk", reindex=True, user_mapping=um, item_mapping=im,
              nusers=60, nitems=40)
    with pytest.warns(UserWarning, match="switched to 'train-llk'"):
        assert process_valset(df, **kw) is None
    with pytest.raises(ValueError, match="no combinations"):
        process_valset(df, is_valset=False, **kw)


@pytest.mark.parametrize("block_size", [None, 7])
def test_block_coo_matches_jax(block_size):
    from hpfrec_tpu.utils.data import block_coo as bj
    from hpfrec_tpu_torch.utils.data import block_coo as bt

    y, iu, ii = synth_counts(30, 20, nnz=101, seed=2)
    got, ref = bt(y, iu, ii, block_size=block_size), bj(y, iu, ii, block_size=block_size)
    assert got.nnz == ref.nnz
    for name in ("y", "ix_u", "ix_i"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


def _blocked_pair(y, iu, ii, block_size):
    import jax.numpy as jnp

    from hpfrec_tpu.ops.cavi import BlockedCOO as BJ
    from hpfrec_tpu_torch.ops.cavi import BlockedCOO as BT
    from hpfrec_tpu_torch.utils.data import block_coo

    blk = block_coo(y, iu, ii, block_size=block_size)
    arrays = (blk.y, blk.ix_u, blk.ix_i)
    return (BT(*(torch.from_numpy(a) for a in arrays)),
            BJ(*(jnp.asarray(a) for a in arrays)), blk.nnz)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-5)])
@pytest.mark.parametrize("full_llk", [False, True])
def test_llk_rmse_sums_match_jax(dtype, rtol, full_llk):
    """K5's plain version (per-block partials and the val criterion) over
    a padded blocked stream, zero-prediction slots included."""
    import jax.numpy as jnp

    from hpfrec_tpu.ops import metrics as MJ
    from hpfrec_tpu_torch.ops import metrics as MT

    _x64(dtype)
    nU, nI, k = 60, 40, 6
    y, iu, ii = synth_counts(nU, nI, nnz=900, seed=5, dtype=dtype)
    rng = np.random.default_rng(6)
    Theta = (rng.random((nU, k)) * 0.5).astype(dtype)
    Beta = (rng.random((nI, k)) * 0.5).astype(dtype)
    Theta[3] = 0  # yhat = 0: the safe log
    dt, dj, nnz = _blocked_pair(y, iu, ii, 128)
    th, be = torch.from_numpy(Theta), torch.from_numpy(Beta)
    parts = MT.llk_rmse_sums(th, be, dt, full_llk)
    assert parts.dtype == torch.float64 and parts.shape == (dt.y.shape[0], 3)
    ll, se, sp = MJ.llk_rmse_sums(jnp.asarray(Theta), jnp.asarray(Beta), dj, full_llk)
    np.testing.assert_allclose(parts.numpy(), np.stack([ll, se, sp], 1), rtol=rtol,
                               atol=1e-9)
    np.testing.assert_allclose(
        MT.val_llk_rmse(th, be, dt, nnz, full_llk),
        MJ.val_llk_rmse(jnp.asarray(Theta), jnp.asarray(Beta), dj, nnz, full_llk), rtol=rtol)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-5)])
@pytest.mark.parametrize("full_llk", [False, True])
@pytest.mark.parametrize("case", ["mostly_padding", "single_triplet"])
def test_llk_rmse_sums_edge_cases_match_jax(case, dtype, rtol, full_llk):
    """K5's plain version against the JAX function where the kernel's walk
    has its edges: blocks that are mostly padding (1,003 triplets in blocks
    of 1,000: the last holds 997 padding slots), and a single triplet
    (``block_coo`` pads it to 8)."""
    import jax.numpy as jnp

    from hpfrec_tpu.ops import metrics as MJ
    from hpfrec_tpu_torch.ops import metrics as MT

    _x64(dtype)
    nU, nI, k = 80, 50, 9
    y, iu, ii = synth_counts(nU, nI, nnz=1500, seed=8, dtype=dtype)
    n, block = (1003, 1000) if case == "mostly_padding" else (1, None)
    y, iu, ii = y[:n], iu[:n], ii[:n]
    rng = np.random.default_rng(9)
    Theta = (rng.random((nU, k)) * 0.5).astype(dtype)
    Beta = (rng.random((nI, k)) * 0.5).astype(dtype)
    dt, dj, nnz = _blocked_pair(y, iu, ii, block)
    th, be = torch.from_numpy(Theta), torch.from_numpy(Beta)
    parts = MT.llk_rmse_sums(th, be, dt, full_llk)
    ll, se, sp = MJ.llk_rmse_sums(jnp.asarray(Theta), jnp.asarray(Beta), dj, full_llk)
    assert nnz == n and float(dt.y.reshape(-1)[n:].abs().sum()) == 0.0
    np.testing.assert_allclose(parts.numpy(), np.stack([ll, se, sp], 1), rtol=rtol,
                               atol=1e-9)
    np.testing.assert_allclose(
        MT.val_llk_rmse(th, be, dt, nnz, full_llk),
        MJ.val_llk_rmse(jnp.asarray(Theta), jnp.asarray(Beta), dj, nnz, full_llk), rtol=rtol)


@pytest.mark.parametrize("n", [1, 8, 2049, 387_528, 148 * (1 << 18)])
def test_llk_grid_covers_every_triplet_once(n):
    """K5's grid (the pair walk's, ``_pairs_grid``) takes the triplet count
    alone, so the partials' count and order are fixed by (n, k, dtype) and
    equal n gives an equal block count; the warps' runs cover every
    triplet exactly once; the validation set (~387k triplets) fills the
    card with several blocks an SM, and the COO engine's 38.8M-triplet
    train stream makes no more than 132 x 8 blocks."""
    import inspect

    from hpfrec_tpu_torch.ops.metrics import _pairs_grid

    assert list(inspect.signature(_pairs_grid).parameters) == ["n"]
    per_warp, blocks = _pairs_grid(n)
    starts = np.arange(blocks * 8, dtype=np.int64) * per_warp
    ends = np.minimum(starts + per_warp, n)
    live = starts < n
    assert starts[0] == 0 and ends[live][-1] == n
    assert np.array_equal(starts[live][1:], ends[live][:-1])
    assert live[-8:].any() and int(np.maximum(ends - starts, 0).sum()) == n
    assert _pairs_grid(n) == (per_warp, blocks)
    if n >= 387_528:
        assert 2.9 * 132 <= blocks <= 132 * 8


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rowsum_dot_rows_matches_jax(dtype):
    import jax.numpy as jnp

    from hpfrec_tpu.ops.metrics import rowsum_dot_rows as rj
    from hpfrec_tpu_torch.ops.metrics import rowsum_dot_rows as rt

    _x64(dtype)
    rng = np.random.default_rng(3)
    Theta, Beta = rng.random((30, 5)).astype(dtype), rng.random((20, 5)).astype(dtype)
    iu = rng.integers(0, 30, 77).astype(np.int32)
    ii = rng.integers(0, 20, 77).astype(np.int32)
    got = rt(torch.from_numpy(Theta), torch.from_numpy(Beta), torch.from_numpy(iu),
             torch.from_numpy(ii))
    ref = float(rj(jnp.asarray(Theta), jnp.asarray(Beta), jnp.asarray(iu), jnp.asarray(ii)))
    assert got == ref


# ---- fits with a validation set --------------------------------------------

VAL_FITS = {"full_batch": dict(),
            "svi": dict(users_per_batch=13, items_per_batch=11),
            "svi_users": dict(users_per_batch=13),
            "svi_items": dict(items_per_batch=11)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", list(VAL_FITS))
def test_val_llk_fit_matches_jax(mode, dtype, monkeypatch):
    """stop_crit='val-llk' with checks every 2 iterations / epochs: the val
    llk at every check, where the fit stops, and the factors."""
    _x64(dtype)
    train, val = _split()
    kw = dict(k=5, maxiter=10, check_every=2, stop_crit="val-llk", stop_thr=1e-3,
              use_float=dtype == np.float32, verbose=False, random_seed=5, **VAL_FITS[mode])
    pair = _fit_both(kw, train, val=val, monkeypatch=monkeypatch)
    assert len(pair[1][1]) >= 2
    # the val llk, sum(ll) - sum(sp) over ~130 held-out pairs, cancels to
    # |llk| ~ 5-50: float32 also gets an absolute 1e-4 (measured 3.6e-5)
    assert_fits_match(pair, dtype, llk_atol=1e-4 if dtype == np.float32 else 0.0)
    (mj, _), (mt, _) = pair
    assert mt.stop_crit == "val-llk" and "valset" in mt.fit_stats_.phases


def test_empty_val_set_switches_to_train_llk(monkeypatch):
    """A validation set with no pair in common: the warning, the switch to
    train-llk, and the same train-llk fit as hpfrec_tpu."""
    _x64(np.float64)
    train, _ = _split()
    val = pd.DataFrame({"UserId": [10_000, 10_001], "ItemId": [7, 8], "Count": [2.0, 1.0]})
    kw = dict(k=4, maxiter=6, check_every=2, stop_crit="val-llk", use_float=False,
              verbose=False, random_seed=2, users_per_batch=13)
    with pytest.warns(UserWarning, match="switched to 'train-llk'"):
        pair = _fit_both(kw, train, val=val, monkeypatch=monkeypatch)
    assert pair[1][0].stop_crit == "train-llk"
    assert_fits_match(pair, np.float64)


@pytest.mark.parametrize("mode", ["full_batch", "svi"])
def test_maxiter_verbose_with_val_set_matches_jax(mode, capsys):
    """maxiter + verbose with a validation set: checks print the val llk,
    and the final llk subtracts rowsum_dot_rows (the reference's quirk)."""
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    _x64(np.float64)
    train, val = _split(seed=8)
    kw = dict(k=4, maxiter=7, check_every=3, stop_crit="maxiter", use_float=False,
              verbose=True, random_seed=3, **VAL_FITS[mode])
    mj = HJ(mesh=make_mesh(jax.devices()[:1]), **kw).fit(train.copy(), val_set=val.copy())
    out_j = capsys.readouterr().out
    mt = HT(device="cpu", **kw).fit(train.copy(), val_set=val.copy())
    out_t = capsys.readouterr().out
    assert mt.niter == mj.niter == 6
    np.testing.assert_allclose(mt.train_llk, mj.train_llk, rtol=1e-10)
    np.testing.assert_allclose(mt.Theta, mj.Theta, rtol=1e-9)
    keep = ("Iteration", "Final", "Number of", "Latent")
    lines = lambda s: [ln for ln in s.splitlines() if ln.startswith(keep)]  # noqa: E731
    assert lines(out_t) == lines(out_j)
    assert any("val llk" in ln for ln in lines(out_t))


def test_val_set_unused_by_train_llk():
    """With stop_crit='train-llk' the validation set is not even processed,
    as in the reference: the fit equals the one without it."""
    from hpfrec_tpu_torch import HPF

    train, val = _split()
    kw = dict(k=4, maxiter=4, check_every=2, stop_crit="train-llk", use_float=False,
              verbose=False, random_seed=2, device="cpu")
    a = HPF(**kw).fit(train.copy(), val_set=val.copy())
    b = HPF(**kw).fit(train.copy())
    np.testing.assert_array_equal(a.Theta, b.Theta)
    assert a.train_llk == b.train_llk and "valset" not in a.fit_stats_.phases


def test_val_llk_needs_a_val_set():
    from hpfrec_tpu_torch import HPF

    with pytest.raises(ValueError, match="must provide a validation set"):
        HPF(k=3, stop_crit="val-llk", device="cpu", verbose=False).fit(_split()[0])


def test_block_size_warns_only_without_val_set():
    from hpfrec_tpu_torch import HPF

    train, val = _split()
    kw = dict(k=3, maxiter=2, check_every=2, stop_crit="val-llk", block_size=64,
              verbose=False, random_seed=1, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        HPF(**kw).fit(train.copy(), val_set=val.copy())
    with pytest.warns(UserWarning, match="block_size has no effect"):
        HPF(**dict(kw, stop_crit="train-llk")).fit(train.copy())


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-5)])
@pytest.mark.parametrize("full_llk", [False, True])
def test_eval_llk_matches_jax(full_llk, dtype, rtol):
    """eval_llk after the same SVI fit in both packages, with unknown ids
    and a zero count in the input (dropped the same way).  float32: the
    two fits' factors differ by ~1e-5 (test_torch_svi)."""
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    _x64(dtype)
    train, val = _split(seed=11)
    extra = pd.DataFrame({"UserId": [99_999, int(val.UserId[0])],
                          "ItemId": [int(val.ItemId[0]), int(val.ItemId[1])],
                          "Count": [3.0, 0.0]})
    test = pd.concat([val, extra], ignore_index=True)
    kw = dict(k=4, maxiter=5, check_every=5, stop_crit="train-llk",
              use_float=dtype == np.float32, verbose=False, random_seed=4, users_per_batch=13)
    mj = HJ(mesh=make_mesh(jax.devices()[:1]), **kw).fit(train.copy())
    mt = HT(device="cpu", **kw).fit(train.copy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ej, et = mj.eval_llk(test.copy(), full_llk), mt.eval_llk(test.copy(), full_llk)
    assert et["nobs"] == ej["nobs"] <= len(val)
    np.testing.assert_allclose(et["llk"], ej["llk"], rtol=rtol)
