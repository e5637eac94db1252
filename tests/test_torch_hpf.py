"""hpfrec_tpu_torch.HPF against hpfrec_tpu.HPF on the same data: the golden
train-llk trajectory, a float64 fit against the single-device JAX fit,
serving, constructor validation, and the options that are not ported."""

import numpy as np
import pandas as pd
import pytest
import torch

from oracle import synth_counts
from test_golden_trajectory import GOLDEN_LLK, GOLDEN_RMSE


@pytest.fixture(autouse=True)
def _restore_x64():
    """Leave jax_enable_x64 as the test found it: the flag is process-wide
    and would leak into the next test file on this worker."""
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


def _df(nU=120, nI=80, nnz=2000, seed=42):
    y, iu, ii = synth_counts(nU, nI, nnz=nnz, seed=seed)
    return pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})


def test_golden_llk_trajectory(monkeypatch):
    """The port reproduces the JAX package's recorded trajectory (k=8,
    seed 123, checks every 10 iterations up to 60) in float32 on the CPU.
    rtol 5e-6, looser than the JAX test's own 2e-6: the golden values come
    from the JAX package's 8-device engine, whose float32 sums run in
    another order, and float32 CAVI iterations amplify such differences
    (test_torch_ell); the largest measured deviation is 2.5e-6 (llk at
    iteration 40)."""
    from hpfrec_tpu_torch import HPF

    records = []
    orig = HPF._evaluate_criterion

    def rec(self, *a, **k):
        out = orig(self, *a, **k)
        records.append((self._last_llk, self._last_rmse))
        return out

    monkeypatch.setattr(HPF, "_evaluate_criterion", rec)
    m = HPF(k=8, maxiter=60, check_every=10, stop_crit='train-llk',
            stop_thr=1e-10, random_seed=123, verbose=False, device="cpu")
    m.fit(_df())
    llk = np.array([r[0] for r in records])
    rmse = np.array([r[1] for r in records])
    np.testing.assert_allclose(llk, GOLDEN_LLK, rtol=5e-6)
    np.testing.assert_allclose(rmse, GOLDEN_RMSE, rtol=5e-6)
    assert m.train_llk == llk[-1] and m.niter == 59


@pytest.fixture(scope="module")
def fitted_pair():
    """The same float64 fit in both packages (JAX on one device)."""
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    df = _df(seed=7)
    kw = dict(k=6, maxiter=30, check_every=10, stop_crit="train-llk",
              stop_thr=1e-10, random_seed=11, use_float=False, verbose=False)
    mj = HJ(mesh=make_mesh(jax.devices()[:1]), **kw).fit(df.copy())
    mt = HT(device="cpu", **kw).fit(df.copy())
    yield mj, mt, df
    jax.config.update("jax_enable_x64", prev)


def test_float64_fit_matches_single_device_jax(fitted_pair):
    mj, mt, _ = fitted_pair
    assert mt.Theta.dtype == np.float64
    np.testing.assert_allclose(mt.Theta, mj.Theta, rtol=1e-9)
    np.testing.assert_allclose(mt.Beta, mj.Beta, rtol=1e-9)
    np.testing.assert_allclose(mt.train_llk, mj.train_llk, rtol=1e-9)
    assert (mt.niter, mt.nusers, mt.nitems) == (mj.niter, mj.nusers, mj.nitems)
    np.testing.assert_array_equal(mt.user_mapping_, mj.user_mapping_)
    assert mt.user_dict_ == mj.user_dict_
    for name in ("Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte", "k_rte", "t_rte"):
        np.testing.assert_allclose(getattr(mt, name), getattr(mj, name), rtol=1e-9)


def test_predict_and_topn_match(fitted_pair):
    mj, mt, df = fitted_pair
    users = df["UserId"].to_numpy()[:40]
    items = df["ItemId"].to_numpy()[:40]
    np.testing.assert_allclose(mt.predict(users, items), mj.predict(users, items), rtol=1e-9)
    np.testing.assert_allclose(mt.predict(users[0], items[0]),
                               mj.predict(users[0], items[0]), rtol=1e-9)
    both = mt.predict(np.array([users[0], -12345]), np.array([items[0], items[1]]))
    assert np.isnan(both[1]) and np.isnan(mt.predict(-12345, items[0]))
    for u in np.unique(users)[:5]:
        for kw in (dict(), dict(exclude_seen=False),
                   dict(items_pool=np.unique(items)[:15])):
            np.testing.assert_array_equal(mt.topN(u, n=7, **kw), mj.topN(u, n=7, **kw))
    with pytest.raises(ValueError):
        mt.topN(-12345)


def test_weights_across_one_step_matches(fitted_pair):
    """The JAX package's fitted parameters, as host numpy, become the port's
    state (state_from_numpy); one iteration from it matches."""
    import jax.numpy as jnp

    from hpfrec_tpu.models.state import VariationalState as VJ
    from hpfrec_tpu.ops import ell as EJ
    from hpfrec_tpu_torch.models.state import state_from_numpy
    from hpfrec_tpu_torch.ops import cavi as CT
    from hpfrec_tpu_torch.ops import ell as ET
    from hpfrec_tpu_torch.utils import data as DT

    mj, mt, df = fitted_pair
    arrays = [mj.Gamma_shp, mj.Gamma_rte, mj.Lambda_shp, mj.Lambda_rte,
              mj.k_rte, mj.t_rte]
    pdata = DT.process_data(df.copy(), "train-llk", True, np.float64)
    lay_t = [ET.build_ell(*DT.build_csr(r, c, pdata.y, n, m), n, dtype=np.float64)
             for r, c, n, m in ((pdata.ix_u, pdata.ix_i, pdata.nusers, pdata.nitems),
                                (pdata.ix_i, pdata.ix_u, pdata.nitems, pdata.nusers))]
    lay_j = [EJ.device_ell(lay) for lay in lay_t]
    hp = mt._hp()
    ref = EJ.run_cavi_block_ell(VJ(*[jnp.asarray(a) for a in arrays]), *lay_j,
                                jnp.asarray(1, jnp.int32), mj._hp())
    got = ET.run_cavi_block_ell(CT._carry_init(state_from_numpy(arrays, "cpu")),
                                *[ET.to_device(lay, "cpu") for lay in lay_t], 1, hp)
    for a, b in zip(got.state, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_seeded_runs_bit_identical():
    from hpfrec_tpu_torch import HPF

    df = _df(nU=50, nI=40, nnz=600, seed=3)
    kw = dict(k=5, maxiter=10, stop_crit="maxiter", random_seed=9, verbose=False,
              device="cpu")
    a, b = HPF(**kw).fit(df.copy()), HPF(**kw).fit(df.copy())
    np.testing.assert_array_equal(a.Theta, b.Theta)
    np.testing.assert_array_equal(a.Beta, b.Beta)


@pytest.mark.parametrize("crit", ["maxiter", "diff-norm", "train-llk"])
def test_stop_criteria_match_jax(crit, capsys):
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    jax.config.update("jax_enable_x64", True)
    df = _df(nU=70, nI=50, nnz=900, seed=8)
    kw = dict(k=4, maxiter=40, check_every=5, stop_crit=crit, stop_thr=1e-2,
              random_seed=3, use_float=False, verbose=True)
    mj = HJ(mesh=make_mesh(jax.devices()[:1]), **kw).fit(df.copy())
    out_j = capsys.readouterr().out
    mt = HT(device="cpu", **kw).fit(df.copy())
    out_t = capsys.readouterr().out
    assert mt.niter == mj.niter
    np.testing.assert_allclose(mt.train_llk, mj.train_llk, rtol=1e-9)
    # same reference-format progress lines (timing lines aside)
    keep = ("Iteration", "Final", "Number of", "Latent")
    lines = lambda s: [ln for ln in s.splitlines() if ln.startswith(keep)]
    assert lines(out_t) == lines(out_j)
    assert "Wall-time breakdown" in out_t
    assert set(mt.fit_stats_.phases) >= {"reindex", "host_pack", "kernel_build",
                                         "transfer", "iterations", "metric_checks"}


BAD_ARGS = [dict(k=0), dict(k=2.5), dict(a=-1.0), dict(c="x"), dict(ncores=1.5),
            dict(stop_crit="foo"), dict(maxiter=None), dict(maxiter=0),
            dict(check_every=200, maxiter=100), dict(check_every=None, stop_crit="train-llk"),
            dict(stop_thr=-1.0), dict(step_size=3), dict(step_size=lambda: 0.5),
            dict(step_size=lambda x: 2.0), dict(users_per_batch=-3),
            dict(random_seed=1.5), dict(engine="bad"),
            dict(engine="coo", shard_tables=True), dict(gather_dtype="half"),
            dict(checkpoint_every=0)]


@pytest.mark.parametrize("kwargs", BAD_ARGS, ids=lambda d: ",".join(sorted(d)))
def test_constructor_validation_matches(kwargs):
    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu_torch import HPF as HT

    with pytest.raises(Exception) as ej:
        HJ(**kwargs)
    with pytest.raises(type(ej.value)):
        HT(**kwargs)


def test_constructor_defaults_match():
    import inspect

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu_torch import HPF as HT

    pj = inspect.signature(HJ.__init__).parameters
    pt = inspect.signature(HT.__init__).parameters
    assert list(pt)[:len(pj)] == list(pj) and list(pt)[len(pj):] == ["device"]
    for name, p in pj.items():
        if name != "step_size":
            assert pt[name].default == p.default, name
    assert pt["device"].default == "cuda"


OFF_SLICE = ["shard_tables", "mesh"]


@pytest.mark.parametrize("option", OFF_SLICE)
def test_off_slice_options_raise(option, monkeypatch):
    """A ``mesh`` that is not a ``parallel.Mesh`` is a TypeError; a
    full-batch ELL fit with ``shard_tables=True`` over more than one rank
    takes the table-sharded engine (JAX ``hpf.py:925``) with the sharded
    layouts of every rank, and no collective before it: a stub two-rank
    mesh with no process group reaches it (a stand-in engine raises
    there)."""
    from hpfrec_tpu_torch import HPF
    from hpfrec_tpu_torch.parallel import Mesh, table_sharded

    if option == "mesh":
        with pytest.raises(TypeError, match="parallel.Mesh"):
            HPF(mesh=object())
        return

    class Reached(Exception):
        pass

    def engine(mesh, plan, n_users, n_items, device):
        assert (mesh.world_size, n_users, n_items, device) == (2, 20, 15, torch.device("cpu"))
        assert plan.se_u.inv_perm.shape[0] == plan.se_i.inv_perm.shape[0] == 2
        raise Reached

    monkeypatch.setattr(table_sharded, "TableSharded", engine)
    stub = Mesh(group=None, world_size=2, rank=0, device=torch.device("cpu"))
    m = HPF(k=3, maxiter=2, check_every=2, verbose=False, shard_tables=True, mesh=stub,
            random_seed=1, reindex=False)
    with pytest.raises(Reached):
        m.fit(_df(nU=20, nI=15, nnz=100))


def test_cuda_device_without_cuda_raises(monkeypatch):
    from hpfrec_tpu_torch import HPF

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = HPF(k=3, maxiter=2, check_every=2, verbose=False)  # device="cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.fit(_df(nU=20, nI=15, nnz=100))


def test_ndarray_and_coo_inputs():
    """ndarray and scipy coo_array inputs, as the JAX package takes them
    (coo input forces reindex=False)."""
    from scipy.sparse import coo_array

    from hpfrec_tpu_torch import HPF

    y, iu, ii = synth_counts(40, 30, nnz=400, seed=2)
    kw = dict(k=3, maxiter=5, check_every=5, stop_crit="maxiter", random_seed=1,
              verbose=False,
              device="cpu")
    a = HPF(**kw).fit(np.column_stack([iu, ii, y]))
    b = HPF(**kw).fit(coo_array((y, (iu, ii)), shape=(40, 30)))
    assert b.reindex is False and b.Theta.shape == (40, 3)
    assert a.Theta.shape[1] == 3 and np.all(np.isfinite(b.Beta))
    assert b.topN(0, n=3).shape == (3,)
