"""The blocked-COO engine of hpfrec_tpu_torch (``engine='coo'``) against
hpfrec_tpu on the same inputs, on the CPU: the phi sums (K7c's plain
version against ``phi_segment_sums``), whole full-batch fits with each
stopping criterion, SVI fits with the COO train metric, a fit with
``block_size``, the COO engine against the port's ELL engine, and the
engine's warnings.

Tolerances: float64 1e-10 for the phi sums, the factors and the llk at
every check (measured <= 3.5e-12).  float32: phi sums rtol 2e-6 (the
port's plain sums add in float64, JAX's scatter adds in float32); whole
fits of 20 iterations: llk at the checks 5e-6 (measured 2.4e-6 with
``block_size``, 2.7e-7 without), factors 1e-3 (measured 4.8e-4, in the
smallest entries: the ~1e-6 float32 difference of one step grows over
the iterations, to 2.1e-3 at 40, as in the ELL engine's tests); SVI
fits of six epochs: llk 1e-6 (measured 2.7e-7), factors 5e-5 (measured
1.7e-5).  COO against ELL in float64: 1e-10.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from chip_smoke import user_side
from oracle import synth_counts


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


def _df(nU=70, nI=50, nnz=900, seed=8):
    y, iu, ii = synth_counts(nU, nI, nnz=nnz, seed=seed)
    return pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})


FIT_TOL = {np.float64: dict(llk=1e-10, factors=1e-10),
           np.float32: dict(llk=5e-6, factors=1e-3)}
SVI_TOL = {np.float64: dict(llk=1e-10, factors=1e-10),
           np.float32: dict(llk=1e-6, factors=5e-5)}


def _recording(cls):
    """A subclass of ``cls`` that records the llk of every check."""

    class Recording(cls):
        def _evaluate_criterion(self, *a, **k):
            out = super()._evaluate_criterion(*a, **k)
            self.llk_trace.append(self._last_llk)
            return out

    return Recording


def _fit_pair(dtype, kw, df, val=None):
    """The same fit in both packages (JAX on one device); returns both."""
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    _x64(dtype)
    kw = dict(kw, use_float=dtype == np.float32, verbose=False)
    fit_kw = {} if val is None else dict(val_set=val.copy())
    mj = _recording(HJ)(mesh=make_mesh(jax.devices()[:1]), **kw)
    mt = _recording(HT)(device="cpu", **kw)
    mj.llk_trace, mt.llk_trace = [], []
    mj.fit(df.copy(), **fit_kw)
    mt.fit(df.copy(), **fit_kw)
    return mj, mt


def _assert_fits_match(mj, mt, tol):
    assert mt.niter == mj.niter
    np.testing.assert_allclose(mt.llk_trace, mj.llk_trace, rtol=tol["llk"])
    if mj.train_llk is not None:
        np.testing.assert_allclose(mt.train_llk, mj.train_llk, rtol=tol["llk"])
    for name in ("Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte",
                 "k_rte", "t_rte"):
        np.testing.assert_allclose(getattr(mt, name), getattr(mj, name),
                                   rtol=tol["factors"], err_msg=name)


# ---- K7c's plain version ------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coo_phi_sums_match_jax(dtype):
    """K7c's plain version over a user-sorted stream whose first run is user
    0, blocked with a padded tail (index 0, y = 0), against JAX's
    phi_segment_sums on the same blocked stream."""
    import jax.numpy as jnp

    from hpfrec_tpu.ops.cavi import BlockedCOO as BJ
    from hpfrec_tpu.ops.cavi import phi_segment_sums
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.utils.data import process_data

    _x64(dtype)
    y, iu, ii = synth_counts(40, 25, nnz=500, seed=3)
    pdata = process_data(np.column_stack([iu, ii, y]), "maxiter", False, dtype)
    assert pdata.ix_u[0] == 0 and pdata.ix_i.min() == 0
    user = user_side(pdata, "cpu")
    coo = C.coo_stream(user, pdata.nitems, block_size=64)
    nnz = pdata.y.shape[0]
    assert coo.data.y.numel() > nnz  # a padded tail
    rng = np.random.default_rng(4)
    t_tab = (rng.random((pdata.nusers, 6)) + 0.05).astype(dtype)
    b_tab = (rng.random((pdata.nitems, 6)) + 0.05).astype(dtype)
    su, si = C.coo_phi_sums(torch.from_numpy(t_tab), torch.from_numpy(b_tab), coo)
    data_j = BJ(*(jnp.asarray(a.numpy()) for a in coo.data))
    ref_u, ref_i = phi_segment_sums(jnp.asarray(t_tab), jnp.asarray(b_tab), data_j)
    rtol = 1e-10 if dtype == np.float64 else 2e-6
    np.testing.assert_allclose(su.numpy(), np.asarray(ref_u), rtol=rtol)
    np.testing.assert_allclose(si.numpy(), np.asarray(ref_i), rtol=rtol)
    # the item-ordered stream (the stable sort of the item ids), whole and
    # in each share of a 3-way shard
    _check_item_order(coo, pdata.ix_u, pdata.ix_i, pdata.nusers, pdata.nitems)
    for rank in range(3):
        part = C.coo_stream(user, pdata.nitems, block_size=64, shard=(rank, 3))
        _, iu, ii = (a.numpy() for a in part.flat())
        assert 0 < part.nnz < nnz
        _check_item_order(part, iu, ii, pdata.nusers, pdata.nitems)


def _check_item_order(coo, ix_u, ix_i, nusers, nitems):
    """``coo``'s user bounds and item-ordered arrays against numpy, for the
    user-sorted triplets ``ix_u``, ``ix_i`` it holds."""
    order = np.argsort(ix_i, kind="stable")
    pos = np.empty(len(order), dtype=np.int64)
    pos[order] = np.arange(len(order))
    np.testing.assert_array_equal(coo.item_keys.numpy(), ix_i[order])
    np.testing.assert_array_equal(coo.item_users.numpy(), ix_u[order])
    np.testing.assert_array_equal(coo.item_pos.numpy(), pos)
    ends = np.cumsum(np.bincount(ix_i, minlength=nitems))
    np.testing.assert_array_equal(coo.item_runs.numpy(),
                                  np.column_stack([ends - np.bincount(ix_i, minlength=nitems),
                                                   ends]))
    np.testing.assert_array_equal(np.diff(coo.user_bounds.numpy()),
                                  np.bincount(ix_u, minlength=nusers))
    assert {a.dtype for a in (coo.item_keys, coo.item_users, coo.item_pos)} == {torch.int32}


@pytest.mark.parametrize("shard", [(0, 1), (0, 3), (1, 3), (2, 3)])
def test_item_pos_maps_each_triplet_to_its_place_in_item_order(shard):
    """K7c's user pass writes triplet j's scale at ``item_pos[j]``, where
    the item pass reads it beside ``item_users`` and ``item_keys``: the
    place holds triplet j's own user and item, for every j, and every place
    is some triplet's (a stream with repeated pairs, users without
    triplets, whole and in shares)."""
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.utils.data import process_data

    y, iu, ii = synth_counts(60, 30, nnz=800, seed=12)
    iu = np.concatenate([iu, iu[:50]])  # a repeated (user, item) pair is two triplets
    ii = np.concatenate([ii, ii[:50]])
    y = np.concatenate([y, y[:50]])
    keep = iu != 7  # user 7 has no triplet
    pdata = process_data(np.column_stack([iu, ii, y])[keep], "maxiter", False, np.float64)
    assert pdata.nusers == 60 and 7 not in pdata.ix_u
    user = user_side(pdata, "cpu")
    coo = C.coo_stream(user, pdata.nitems, shard=shard)
    _, ix_u, ix_i = (a.numpy() for a in coo.flat())
    pos = coo.item_pos.numpy()
    np.testing.assert_array_equal(coo.item_users.numpy()[pos], ix_u)
    np.testing.assert_array_equal(coo.item_keys.numpy()[pos], ix_i)
    np.testing.assert_array_equal(np.sort(pos), np.arange(coo.nnz))


# ---- whole fits -------------------------------------------------------------

CRITERIA = ["maxiter", "train-llk", "diff-norm", "val-llk"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("crit", CRITERIA)
def test_full_batch_coo_fit_matches_jax(dtype, crit):
    df = _df()
    val = None
    if crit == "val-llk":
        hold = np.random.default_rng(9).random(len(df)) < 0.15
        df, val = df[~hold], df[hold]
    kw = dict(k=5, maxiter=20, check_every=5, stop_crit=crit, stop_thr=1e-4,
              random_seed=3, engine="coo")
    mj, mt = _fit_pair(dtype, kw, df, val)
    if crit == "maxiter":  # verbose off: no checks
        assert mt.llk_trace == [] and mt.train_llk is None
    elif crit != "diff-norm":
        assert len(mt.llk_trace) >= 2
    _assert_fits_match(mj, mt, FIT_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("batches", [dict(users_per_batch=15), dict(items_per_batch=11),
                                     dict(users_per_batch=15, items_per_batch=11)],
                         ids=["users", "items", "alternating"])
def test_svi_coo_fit_matches_jax(dtype, batches):
    """SVI under engine='coo': the epochs are the same, the train metric
    runs over the blocked-COO training stream (no ELL metric layout)."""
    kw = dict(k=5, maxiter=6, check_every=2, stop_crit="train-llk", stop_thr=1e-10,
              random_seed=4, engine="coo", **batches)
    mj, mt = _fit_pair(dtype, kw, _df())
    assert len(mt.llk_trace) == 3
    _assert_fits_match(mj, mt, SVI_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coo_fit_with_block_size_matches_jax(dtype):
    kw = dict(k=5, maxiter=20, check_every=5, stop_crit="train-llk", stop_thr=1e-10,
              random_seed=5, engine="coo", block_size=128)
    mj, mt = _fit_pair(dtype, kw, _df())
    _assert_fits_match(mj, mt, FIT_TOL[dtype])


def test_svi_coo_builds_no_ell_metric_layout(monkeypatch):
    from hpfrec_tpu_torch import HPF
    from hpfrec_tpu_torch.ops import ell

    def refuse(*a, **k):
        raise AssertionError("an ELL layout was built")

    monkeypatch.setattr(ell, "build_ell", refuse)
    m = HPF(k=4, maxiter=4, check_every=2, stop_crit="train-llk", users_per_batch=15,
            engine="coo", device="cpu", verbose=False, random_seed=1)
    m.fit(_df())
    assert np.isfinite(m.train_llk)


@pytest.mark.parametrize("crit", ["train-llk", "diff-norm"])
def test_coo_engine_equals_ell_engine(crit):
    """The port's two full-batch engines give the same fit in float64."""
    from hpfrec_tpu_torch import HPF

    kw = dict(k=5, maxiter=30, check_every=5, stop_crit=crit, stop_thr=1e-4,
              random_seed=6, use_float=False, verbose=False, device="cpu")
    mc = _recording(HPF)(engine="coo", **kw)
    me = _recording(HPF)(engine="ell", **kw)
    mc.llk_trace, me.llk_trace = [], []
    mc.fit(_df(seed=2))
    me.fit(_df(seed=2))
    assert mc.niter == me.niter
    np.testing.assert_allclose(mc.llk_trace, me.llk_trace, rtol=1e-10)
    np.testing.assert_allclose(mc.Theta, me.Theta, rtol=1e-10)
    np.testing.assert_allclose(mc.Beta, me.Beta, rtol=1e-10)


# ---- warnings ---------------------------------------------------------------

def test_coo_fit_with_block_size_does_not_warn():
    from hpfrec_tpu_torch import HPF

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        HPF(k=3, maxiter=2, check_every=2, engine="coo", block_size=64, device="cpu",
            verbose=False).fit(_df(nU=20, nI=15, nnz=150))
    assert not [w for w in caught if "block_size" in str(w.message)]
    with pytest.warns(UserWarning, match="block_size has no effect"):
        HPF(k=3, maxiter=2, check_every=2, engine="ell", block_size=64, device="cpu",
            verbose=False).fit(_df(nU=20, nI=15, nnz=150))


@pytest.mark.parametrize("gather_dtype", ["bfloat16", "float32"])
def test_coo_gather_dtype_warns_as_jax(gather_dtype):
    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu_torch import HPF as HT

    with pytest.warns(UserWarning) as wj:
        HJ(engine="coo", gather_dtype=gather_dtype)
    with pytest.warns(UserWarning) as wt:
        HT(engine="coo", gather_dtype=gather_dtype)
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    assert "has no effect with engine='coo'" in str(wt[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        HT(engine="coo")
