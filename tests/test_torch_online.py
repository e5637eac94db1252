"""Online updates of hpfrec_tpu_torch against hpfrec_tpu on the same inputs:
``partial_fit`` (user and item batches, growth, declared row lists),
``user_factors_loop`` (K10's plain version) and ``fold_in`` (its route
from and to host arrays), ``predict_factors``,
``add_user`` (fold-in and ``update_all_params``, new and existing users)
and the device-state cache (tests/test_growth_paths.py,
tests/test_svi_oracle.py:78-200, tests/test_hpf_api.py:121-160).

Tolerances.  float64: the six state arrays, Theta, G and phi to 1e-10
relative, the same iteration counts.  float32, each model starting from
the same arrays (the JAX fit's): ``partial_fit`` agrees to 3e-6 (measured
1.5e-6: the port's plain K7 adds phi in float64 where the JAX scatter adds
in float32, 1.14e-6 per op); the fold-in to 1e-5 (measured 6.2e-6: each
package's float32 digamma is ~1.3e-6 off, and the iterations carry it),
and ``update_all_params`` (three ``partial_fit`` calls) to 2e-6 (measured
8.3e-7).
"""

import warnings

import numpy as np
import pandas as pd
import pytest

from oracle import OracleHPF, synth_counts

STATE = ("Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte", "k_rte", "t_rte")
F64 = 1e-10


@pytest.fixture(autouse=True)
def _restore_x64():
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="When using 'partial_fit'")
        yield


def _make_df(nU, nI, nnz, seed, dtype=np.float32):
    y, iu, ii = synth_counts(nU, nI, nnz=nnz, seed=seed, dtype=dtype)
    return pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})


def _models(use_float, nU=50, nI=35, nnz=700, seed=2, fit=True, **kw):
    """A JAX model and a port model with the same fitted arrays (the
    port's own fit, then the JAX fit's arrays adopted)."""
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    jax.config.update("jax_enable_x64", not use_float)
    opts = dict(k=6, use_float=use_float, reindex=False, verbose=False, random_seed=11,
                maxiter=4, check_every=2, stop_crit="maxiter")
    opts.update(kw)
    mj = HJ(mesh=make_mesh(jax.devices()[:1]), **opts)
    mt = HT(device="cpu", **opts)
    df = _make_df(nU, nI, nnz, seed, np.float32 if use_float else np.float64)
    if fit:
        mj.fit(df.copy())
        mt.fit(df.copy())
        for name in ("Theta", "Beta", *STATE):
            mt._own(name, np.array(getattr(mj, name)))
        mt._dev_state_cache = None
    return mj, mt, df


def _assert_state(mt, mj, rtol):
    for name in (*STATE, "Theta", "Beta"):
        a, b = getattr(mt, name), getattr(mj, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("use_float", [True, False])
@pytest.mark.parametrize("batch_type", ["users", "items"])
def test_partial_fit_equals_jax(use_float, batch_type):
    """Two partial_fit calls of each batch type on a fitted model: the
    step-size chain from niter, niter += 1, the six arrays."""
    mj, mt, df = _models(use_float)
    col = "UserId" if batch_type == "users" else "ItemId"
    for sel in (df[col] < 12, (df[col] >= 12) & (df[col] < 20)):
        batch = df.loc[sel]
        mj.partial_fit(batch.copy(), batch_type=batch_type)
        mt.partial_fit(batch.to_numpy(), batch_type=batch_type)
        assert mt.niter == mj.niter
        _assert_state(mt, mj, 3e-6 if use_float else F64)


def test_partial_fit_matches_oracle_user_batch():
    """From scratch (no fit): the seeded init, then the oracle's user
    batch with blend-all-scalers (test_svi_oracle.py:78-107)."""
    from hpfrec_tpu_torch import HPF

    nU, nI, k, seed = 50, 35, 6, 11
    y, iu, ii = synth_counts(nU, nI, nnz=700, seed=2, dtype=np.float64)
    oracle = OracleHPF(0.3, 0.3, 1.0, 0.3, 0.3, 1.0, k).init(nU, nI, seed, np.float64)
    model = HPF(k=k, use_float=False, reindex=False, verbose=False, random_seed=seed,
                keep_data=False, device="cpu")
    rows = np.unique(iu)[:10]
    sel = np.isin(iu, rows)
    model.partial_fit(np.column_stack([iu, ii, y])[sel], batch_type="users", step_size=0.5,
                      nusers=nU, nitems=nI)
    oracle.svi_user_batch(y[sel], iu[sel], ii[sel], rows, np.unique(ii[sel]), 0.5,
                          nU / len(rows), blend_all_scalers=True)
    for ours, ref in ((model.Gamma_shp, oracle.G_shp), (model.Lambda_shp, oracle.L_shp),
                      (model.k_rte, oracle.k_rte), (model.t_rte, oracle.t_rte),
                      (model.Theta, oracle.Theta)):
        np.testing.assert_allclose(ours, ref, rtol=F64)
    assert model.niter == 1 and model.is_fitted


@pytest.mark.parametrize("use_float", [True, False])
def test_partial_fit_from_scratch_equals_jax(use_float):
    mj, mt, df = _models(use_float, fit=False, keep_data=False)
    batch = df.loc[df.UserId < 15]
    mj.partial_fit(batch.copy(), nusers=50, nitems=35, step_size=0.7)
    mt.partial_fit(batch.to_numpy(), nusers=50, nitems=35, step_size=0.7)
    _assert_state(mt, mj, 3e-6 if use_float else F64)


@pytest.mark.parametrize("batch_type", ["users", "items"])
def test_partial_fit_declared_lists_differ_from_touched_rows(batch_type):
    """Masks come from the declared lists, not from the rows the triplets
    touch: a touched row that is not declared keeps its added mass, a
    declared row with no triplet is blended, and an empty items_in_batch
    blends no item row (test_svi_oracle.py:171-202)."""
    mj, mt, df = _models(False)
    batch = df.loc[df.UserId < 10] if batch_type == "users" else df.loc[df.ItemId < 8]
    lists = dict(users_in_batch=np.array([0, 3, 7, 40, 41]),
                 items_in_batch=np.array([1, 2, 30]))
    for kw in (lists, dict(items_in_batch=np.array([], dtype=np.int64))):
        mj.partial_fit(batch.copy(), batch_type=batch_type, step_size=0.5, **kw)
        mt.partial_fit(batch.to_numpy(), batch_type=batch_type, step_size=0.5, **kw)
        _assert_state(mt, mj, F64)


def test_partial_fit_empty_items_matches_oracle():
    from hpfrec_tpu_torch import HPF

    nU, nI, k, seed = 40, 30, 5, 7
    y, iu, ii = synth_counts(nU, nI, nnz=500, seed=4, dtype=np.float64)
    oracle = OracleHPF(0.3, 0.3, 1.0, 0.3, 0.3, 1.0, k).init(nU, nI, seed, np.float64)
    model = HPF(k=k, use_float=False, reindex=False, verbose=False, random_seed=seed,
                keep_data=False, device="cpu")
    rows = np.unique(iu)[:8]
    sel = np.isin(iu, rows)
    model.partial_fit(np.column_stack([iu, ii, y])[sel], step_size=0.5, nusers=nU, nitems=nI,
                      items_in_batch=np.array([], dtype=np.int64))
    oracle.svi_user_batch(y[sel], iu[sel], ii[sel], rows, np.array([], dtype=np.int64), 0.5,
                          nU / len(rows), blend_all_scalers=True)
    for ours, ref in ((model.Lambda_shp, oracle.L_shp), (model.Lambda_rte, oracle.L_rte),
                      (model.Gamma_shp, oracle.G_shp)):
        np.testing.assert_allclose(ours, ref, rtol=F64)


def test_partial_fit_empty_users_and_bad_ids_raise():
    _, mt, df = _models(False)
    with pytest.raises(ValueError, match="users_in_batch"):
        mt.partial_fit(df.to_numpy(), users_in_batch=np.array([], dtype=np.int64))
    with pytest.raises(ValueError, match="outside"):
        mt.partial_fit(df.to_numpy(), items_in_batch=np.array([35]))
    from hpfrec_tpu_torch import HPF

    with pytest.raises(ValueError, match="reindex=False"):
        HPF(k=3, device="cpu").partial_fit(df.to_numpy())


@pytest.mark.parametrize("use_float", [True, False])
def test_partial_fit_new_users_growth_equals_jax(use_float):
    """nusers_add = nusers - (max batch id + 1) (test_growth_paths.py:33-68):
    3 appended rows drawn by default_rng(7), rows outside the batch keep
    their draws bit for bit."""
    mj, mt, df = _models(use_float, nU=50, nI=20, nnz=600, seed=1)
    batch = df[df.UserId <= 46]
    mj.partial_fit(batch.copy(), new_users=True, random_seed=7)
    mt.partial_fit(batch.to_numpy(), new_users=True, random_seed=7)
    assert mt.nusers == mj.nusers == 53 and mt.Theta.shape == (53, 6)
    np.testing.assert_array_equal(mt.Gamma_shp[50:], mj.Gamma_shp[50:])
    _assert_state(mt, mj, 3e-6 if use_float else F64)
    with pytest.raises(ValueError, match="no new users"):
        mt.partial_fit(np.array([[52, 0, 1.0]]), new_users=True)


@pytest.mark.parametrize("use_float", [True, False])
def test_partial_fit_new_items_growth_equals_jax(use_float):
    mj, mt, df = _models(use_float, nU=30, nI=40, nnz=500, seed=2)
    batch = df[df.ItemId <= 37]
    mj.partial_fit(batch.copy(), new_items=True, random_seed=9)
    mt.partial_fit(batch.to_numpy(), new_items=True, random_seed=9)
    assert mt.nitems == 42 and mt.Beta.shape == (42, 6)
    np.testing.assert_array_equal(mt.Lambda_shp[40:], mj.Lambda_shp[40:])
    _assert_state(mt, mj, 3e-6 if use_float else F64)


def test_initialize_extra_rows_equals_jax():
    from hpfrec_tpu.models.state import initialize_extra_rows as ej
    from hpfrec_tpu_torch.models.state import initialize_extra_rows as et

    for dt in (np.float32, np.float64):
        for seed in (None, 0, 5):
            got, ref = et(4, 0.3, 1.0, 7, seed, dt), ej(4, 0.3, 1.0, 7, seed, dt)
            if seed:
                for a, b in zip(got, ref):
                    np.testing.assert_array_equal(a, b)
            assert all(a.dtype == dt and a.shape == b.shape for a, b in zip(got, ref))


@pytest.mark.parametrize("use_float", [True, False])
@pytest.mark.parametrize("P,maxiter,stop_thr", [(1, 10, 1e-3), (12, 30, 1e-6),
                                                 (12, 10, 1e9), (200, 6, 1e-30)])
def test_user_factors_loop_equals_jax(use_float, P, maxiter, stop_thr):
    """K10's plain loop against the JAX while_loop on the same inputs
    (test_svi_oracle.py:110-168), including the stop at iteration 1 and at
    maxiter; the JAX call gets its padding to a multiple of 8."""
    import jax
    import jax.numpy as jnp
    import torch
    from scipy.special import digamma

    from hpfrec_tpu.models.state import Hyperparams as HJ
    from hpfrec_tpu.ops.svi import user_factors_loop as lj
    from hpfrec_tpu_torch.models.state import Hyperparams as HT
    from hpfrec_tpu_torch.ops.svi import user_factors_loop as lt

    jax.config.update("jax_enable_x64", not use_float)
    dt = np.float32 if use_float else np.float64
    k = 6
    rng = np.random.default_rng(P)
    L_shp, L_rte = 0.3 + rng.random((P, k)), 0.3 + rng.random((P, k))
    y = (rng.poisson(2, P) + 1).astype(dt)
    theta0 = rng.gamma(0.3, 1.0, k).astype(dt)
    g_rte0 = (rng.gamma(0.3, 1 / 0.3, 1) + 5 * rng.random(k)).astype(dt)
    g_shp0 = (g_rte0 * theta0 * rng.uniform(0.85, 1.15, k)).astype(dt)
    k_rte0 = dt(1.0 + theta0.sum())
    elogb = (digamma(L_shp) - np.log(L_rte)).astype(dt)
    bcs = (5 * rng.random(k)).astype(dt)
    Pp = -(-P // 8) * 8
    y_p = np.zeros(Pp, dt)
    y_p[:P] = y
    e_p = np.zeros((Pp, k), dt)
    e_p[:P] = elogb
    ref = lj(jnp.asarray(y_p), jnp.asarray(e_p), jnp.asarray(bcs), jnp.asarray(theta0),
             jnp.asarray(g_shp0), jnp.asarray(g_rte0), jnp.asarray(k_rte0), HJ(k=k), maxiter,
             jnp.asarray(stop_thr, dtype=dt))
    got = lt(*[torch.from_numpy(a) for a in (y, elogb, bcs, theta0, g_shp0, g_rte0)],
             float(k_rte0), HT(k=k), maxiter, stop_thr)
    assert got[4] == int(ref[4])
    rtol = 1e-5 if use_float else F64
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3])[:P], rtol=rtol, atol=1e-30)


@pytest.mark.parametrize("use_float", [True, False])
@pytest.mark.parametrize("P", [1, 12, 200])
@pytest.mark.parametrize("return_phi", [False, True])
def test_fold_in_host_route_equals_jax(use_float, P, return_phi):
    """``fold_in``, K10 from and to host arrays as HPF calls it, on the CPU
    against the JAX while_loop on the same inputs: Theta, G, the count, and
    phi_norm only when asked for."""
    import jax
    import jax.numpy as jnp
    from scipy.special import digamma

    from hpfrec_tpu.models.state import Hyperparams as HJ
    from hpfrec_tpu.ops.svi import user_factors_loop as lj
    from hpfrec_tpu_torch.models.state import Hyperparams as HT
    from hpfrec_tpu_torch.ops.svi import fold_in

    jax.config.update("jax_enable_x64", not use_float)
    dt = np.float32 if use_float else np.float64
    k = 5
    rng = np.random.default_rng(3 * P + 1)
    y = (rng.poisson(2, P) + 1).astype(dt)
    elogb = (digamma(0.3 + rng.random((P, k))) - np.log(0.3 + rng.random((P, k)))).astype(dt)
    bcs = (5 * rng.random(k)).astype(dt)
    theta0 = rng.gamma(0.3, 1.0, k).astype(dt)
    g_rte0 = (rng.gamma(0.3, 1 / 0.3, 1) + bcs).astype(dt)
    g_shp0 = (g_rte0 * theta0 * rng.uniform(0.85, 1.15, k)).astype(dt)
    k_rte0 = dt(1.0 + theta0.sum())
    Pp = -(-P // 8) * 8
    y_p, e_p = np.zeros(Pp, dt), np.zeros((Pp, k), dt)
    y_p[:P], e_p[:P] = y, elogb
    ref = lj(jnp.asarray(y_p), jnp.asarray(e_p), jnp.asarray(bcs), jnp.asarray(theta0),
             jnp.asarray(g_shp0), jnp.asarray(g_rte0), jnp.asarray(k_rte0), HJ(k=k), 20,
             jnp.asarray(1e-4, dtype=dt))
    got = fold_in(y, elogb, bcs, theta0, g_shp0, g_rte0, float(k_rte0), HT(k=k), 20, 1e-4,
                  "cpu", return_phi)
    assert got[4] == int(ref[4])
    rtol = 1e-5 if use_float else F64
    for g, r in zip(got[:3], ref[:3]):
        assert g.dtype == dt and g.shape == (k,)
        np.testing.assert_allclose(g, np.asarray(r), rtol=rtol)
    if return_phi:
        np.testing.assert_allclose(got[3], np.asarray(ref[3])[:P], rtol=rtol, atol=1e-30)
    else:
        assert got[3] is None


@pytest.mark.parametrize("use_float", [True, False])
def test_predict_factors_equals_jax(use_float):
    mj, mt, df = _models(use_float)
    hist = df.loc[df.UserId == df.UserId.iloc[0], ["ItemId", "Count"]]
    for kw in (dict(), dict(maxiter=40, stop_thr=1e-6, random_seed=3)):
        ref = mj.predict_factors(hist.copy(), return_all=True, **kw)
        got = mt.predict_factors(hist.to_numpy(), return_all=True, **kw)
        assert len(got) == 4
        for g, r in zip(got, ref):
            assert g.shape == r.shape and g.dtype == r.dtype
            np.testing.assert_allclose(g, r, rtol=1e-5 if use_float else F64)
        np.testing.assert_array_equal(mt.predict_factors(hist.copy(), **kw), got[0])


def test_predict_factors_reindexed_ids():
    """With reindex, item ids map through item_dict_; unknown items raise."""
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    jax.config.update("jax_enable_x64", True)
    df = _make_df(40, 30, 500, 5, np.float64)
    df = df.assign(UserId=df.UserId * 3 + 100, ItemId=df.ItemId * 7 + 9)
    kw = dict(k=5, use_float=False, verbose=False, random_seed=2, maxiter=5,
              check_every=5, stop_crit="maxiter")
    mj = HJ(mesh=make_mesh(jax.devices()[:1]), **kw).fit(df.copy())
    mt = HT(device="cpu", **kw).fit(df.copy())
    hist = df.loc[df.UserId == df.UserId.iloc[3], ["ItemId", "Count"]]
    np.testing.assert_allclose(mt.predict_factors(hist.copy()), mj.predict_factors(hist.copy()),
                               rtol=1e-9)
    with pytest.raises(ValueError, match="training set"):
        mt.predict_factors(np.array([[123456, 1.0]]))
    mt.add_user(df.UserId.iloc[3], hist.copy(), update_existing=True)
    mj.add_user(df.UserId.iloc[3], hist.copy(), update_existing=True)
    np.testing.assert_allclose(mt.Theta, mj.Theta, rtol=1e-9)
    mt.add_user(987654, hist.to_numpy())
    mj.add_user(987654, hist.copy())
    np.testing.assert_allclose(mt.Theta, mj.Theta, rtol=1e-9)
    assert mt.user_dict_[987654] == mj.user_dict_[987654] == 40
    np.testing.assert_array_equal(mt.topN(987654, n=5), mj.topN(987654, n=5))


@pytest.mark.parametrize("use_float", [True, False])
def test_add_user_fold_in_equals_jax(use_float):
    """A new user and an existing one by fold-in: Theta, the G rows, k_rte
    and the seen-items metadata (test_hpf_api.py:132-159)."""
    mj, mt, df = _models(use_float, keep_data=True)
    hist = pd.DataFrame({"ItemId": np.arange(8), "Count": np.arange(1.0, 9.0)})
    rtol = 1e-5 if use_float else F64
    for uid, kw in ((3, dict(update_existing=True)), (50, dict()), (50, dict(update_existing=True))):
        assert mj.add_user(uid, hist.copy(), **kw) is True
        assert mt.add_user(uid, hist.to_numpy(), **kw) is True
        assert mt.nusers == mj.nusers
        for name in ("Theta", "Gamma_shp", "Gamma_rte", "k_rte"):
            np.testing.assert_allclose(getattr(mt, name), getattr(mj, name), rtol=rtol,
                                       err_msg=name)
        for name in ("seen", "_st_ix_user", "_n_seen_by_user"):
            np.testing.assert_array_equal(getattr(mt, name), getattr(mj, name), err_msg=name)
    assert mt.Theta.shape == (51, 6)
    assert mt.topN_batch(np.array([50, 3]), n=4).shape == (2, 4)


def test_add_user_appends_into_spare_rows():
    """Repeated fold-in add_user writes into spare rows of the model's own
    buffers: the attributes equal the reference's np.r_ growth, a view
    taken before keeps its rows, and a reassigned attribute is copied into
    a new buffer, never written past."""
    _, mt, _ = _models(False, keep_data=True)
    hist = np.column_stack([np.arange(4), np.arange(1.0, 5.0)])
    row = mt.predict_factors(hist)
    before = {n: getattr(mt, n).copy()
              for n in ("Theta", "k_rte", "seen", "_st_ix_user", "_n_seen_by_user")}
    old = mt.Theta
    n0, adds = mt.nusers, 70
    for _ in range(adds):
        mt.add_user(mt.nusers, hist)
    assert mt.nusers == n0 + adds and old.shape == before["Theta"].shape
    np.testing.assert_array_equal(old, before["Theta"])
    np.testing.assert_array_equal(mt.Theta, np.r_[before["Theta"], np.tile(row, (adds, 1))])
    assert mt.k_rte.shape == (n0 + adds, 1)
    np.testing.assert_array_equal(mt.k_rte[:n0], before["k_rte"])
    np.testing.assert_array_equal(mt.seen, np.r_[before["seen"], np.tile(np.arange(4), adds)])
    np.testing.assert_array_equal(mt._st_ix_user, np.r_[before["_st_ix_user"],
                                                        before["seen"].size + 4 * np.arange(adds)])
    np.testing.assert_array_equal(mt._n_seen_by_user, np.r_[before["_n_seen_by_user"],
                                                            np.full(adds, 4)])
    mine = mt.Theta.copy()
    mt.Theta = mine
    mt.add_user(mt.nusers, hist)
    assert mine.shape == (n0 + adds, mt.k) and mt.Theta.base is not mine
    np.testing.assert_array_equal(mt.Theta[-1], row)


def test_add_user_update_existing_keeps_earlier_views():
    """An in-place update_existing edit after appends into spare rows leaves
    a view a caller took before the last append as it was (as after the
    reference's np.r_), and the model still equals the JAX package's."""
    mj, mt, _ = _models(False, keep_data=True)
    hist = np.column_stack([np.arange(4), np.arange(1.0, 5.0)])
    other = np.column_stack([np.arange(3, 9), np.arange(2.0, 8.0)])
    for m in (mt, mj):
        for _ in range(2):
            m.add_user(m.nusers, pd.DataFrame(hist, columns=["ItemId", "Count"]))
    names = ("Theta", "Gamma_shp", "Gamma_rte", "k_rte", "_st_ix_user", "_n_seen_by_user")
    views = {n: getattr(mt, n) for n in names}
    copies = {n: v.copy() for n, v in views.items()}
    for m in (mt, mj):
        m.add_user(m.nusers, pd.DataFrame(hist, columns=["ItemId", "Count"]))
        m.add_user(3, pd.DataFrame(other, columns=["ItemId", "Count"]), update_existing=True)
    for n in names:
        np.testing.assert_array_equal(views[n], copies[n], err_msg=n)
        np.testing.assert_allclose(getattr(mt, n), getattr(mj, n), rtol=F64, err_msg=n)
    assert not np.array_equal(mt.Theta[3], copies["Theta"][3])
    np.testing.assert_array_equal(mt.seen, mj.seen)


@pytest.mark.parametrize("past_end", [False, True])
@pytest.mark.parametrize("call", ["predict_factors", "add_user"])
def test_fold_in_rejects_item_ids_outside_catalog(past_end, call):
    """With reindex=False an item id outside 0..nitems-1 raises before it
    reaches the tables or the seen lists (K6 would mask with it)."""
    _, mt, _ = _models(False, keep_data=True)
    hist = np.array([[0, 1.0], [mt.nitems if past_end else -1, 2.0]])
    seen, nusers = mt.seen.copy(), mt.nusers
    args = (mt.nusers, hist) if call == "add_user" else (hist,)
    with pytest.raises(ValueError, match="Item ids"):
        getattr(mt, call)(*args)
    assert mt.nusers == nusers
    np.testing.assert_array_equal(mt.seen, seen)


@pytest.mark.parametrize("use_float", [True, False])
def test_add_user_update_all_params_equals_jax(use_float):
    """update_all_params loops partial_fit on the user's batch
    (test_growth_paths.py:96-130); a brand-new id raises (the reference's
    quirk)."""
    mj, mt, df = _models(use_float, nU=40, nI=25, nnz=500, seed=3)
    hist = pd.DataFrame({"ItemId": np.arange(8), "Count": np.arange(1.0, 9.0)})
    niter = mt.niter
    mj.add_user(3, hist.copy(), update_existing=True, update_all_params=True, maxiter=3)
    mt.add_user(3, hist.to_numpy(), update_existing=True, update_all_params=True, maxiter=3)
    assert mt.niter == mj.niter > niter
    _assert_state(mt, mj, 2e-6 if use_float else F64)
    with pytest.raises(ValueError, match="no new users"):
        mt.add_user(40, hist.to_numpy(), update_all_params=True)


def test_device_state_cache():
    """Repeated partial_fit reuses the cached device state; reassignment
    invalidates; add_user's in-place row edit thaws the rows and drops the
    cache; a caller's array is never made read-only and never cached
    (test_growth_paths.py:180-212)."""
    from hpfrec_tpu_torch import HPF

    df = _make_df(40, 30, 500, 2)
    kw = dict(k=5, verbose=False, random_seed=11, reindex=False, maxiter=4, check_every=2,
              stop_crit="maxiter", device="cpu")
    m = HPF(**kw).fit(df.copy())
    assert m._dev_state_cache is not None
    assert all(not getattr(m, n).flags.writeable for n in STATE)
    batch = _make_df(40, 30, 120, 5).to_numpy()
    m.partial_fit(batch)
    cached = m._dev_state_cache
    assert m._state_from_host() is cached[1]

    m2 = HPF(**kw).fit(df.copy())
    m2._dev_state_cache = None
    m2.partial_fit(batch)
    for n in STATE:
        np.testing.assert_array_equal(getattr(m, n), getattr(m2, n))

    m.Gamma_shp = m.Gamma_shp.copy()
    assert m.Gamma_shp.flags.writeable
    assert m._state_from_host() is not cached[1]
    assert m._dev_state_cache is None and m.Gamma_shp.flags.writeable
    m.partial_fit(batch)  # the model's own arrays again: cached
    assert m._dev_state_cache is not None and not m.Gamma_shp.flags.writeable

    hist = np.column_stack([np.arange(5), np.ones(5)])
    m.add_user(user_id=3, counts_df=hist, update_existing=True)
    assert m._dev_state_cache is None
    state = m._state_from_host()
    np.testing.assert_array_equal(state.G_shp[3].numpy(), m.Gamma_shp[3])


def test_partial_fit_dataframe_equals_ndarray():
    _, a, df = _models(False)
    _, b, _ = _models(False)
    a.partial_fit(df.loc[df.UserId < 9].copy())
    b.partial_fit(df.loc[df.UserId < 9].to_numpy())
    for n in STATE:
        np.testing.assert_array_equal(getattr(a, n), getattr(b, n))


def test_fold_in_beta_colsum_cache():
    """The fold-in's host column sum of Beta is cached with the model's own
    table (made read-only) and made anew for a caller's table, whose
    in-place edits are then seen."""
    _, mt, df = _models(False)
    hist = df.loc[df.UserId == 4, ["ItemId", "Count"]].to_numpy()
    a = mt.predict_factors(hist)
    cached = mt._beta_colsum_cache
    np.testing.assert_array_equal(mt.predict_factors(hist), a)
    assert mt._beta_colsum_cache is cached and not mt.Beta.flags.writeable
    mine = mt.Beta * 2
    mt.Beta = mine
    b = mt.predict_factors(hist)
    assert mt._beta_colsum_cache is None and not np.allclose(a, b)
    mine *= 0.5
    np.testing.assert_array_equal(mt.predict_factors(hist), a)
