"""Persistence of hpfrec_tpu_torch on the CPU: checkpoints and resume
(full batch on both engines, SVI), checkpoint and model files read across
the two packages, ``save`` / ``load`` (also after ``add_user`` growth),
the ``save_folder`` export (byte-identical ``users.csv``, ``items.csv``
and ``hyperparameters.txt``, with and without pandas) and ``profile_dir``.

Tolerances: a resumed port fit equals the uninterrupted one bit for bit
(the carry derived from a loaded state holds the values the loop made);
across the packages (a checkpoint of one resumed by the other) float64
1e-10; a loaded model serves exactly what the saved one did, and
``predict_factors`` of the other package's loaded model agrees to 1e-10
in float64.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from oracle import synth_counts


@pytest.fixture(autouse=True)
def _restore_x64():
    """Leave jax_enable_x64 as the test found it: the flag is process-wide
    and would leak into the next test file on this worker."""
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


def _df(seed=2, nU=60, nI=40, nnz=900):
    y, iu, ii = synth_counts(nU, nI, nnz=nnz, seed=seed)
    return pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})


FULL = dict(k=6, check_every=5, stop_crit="train-llk", stop_thr=1e-10, random_seed=44,
            use_float=False, verbose=False)
SVI = dict(k=6, check_every=3, stop_crit="train-llk", stop_thr=1e-10, users_per_batch=16,
           items_per_batch=11, random_seed=44, use_float=False, verbose=False)
STATE = ("Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte", "k_rte",
         "t_rte")


def _jax_hpf(**kw):
    import jax

    from hpfrec_tpu import HPF
    from hpfrec_tpu.parallel import make_mesh

    return HPF(mesh=make_mesh(jax.devices()[:1]), **kw)


def _torch_hpf(**kw):
    from hpfrec_tpu_torch import HPF

    return HPF(device="cpu", **kw)


def _split_run(make, kw, total, every, ck, df):
    """A fit to ``total // 2`` with checkpoints every ``every``, then one
    resumed from them to ``total``."""
    make(**kw, maxiter=total // 2, checkpoint_folder=ck, checkpoint_every=every).fit(df.copy())
    return make(**kw, maxiter=total, checkpoint_folder=ck,
                checkpoint_every=every).fit(df.copy(), resume=True)


@pytest.mark.parametrize("mode,engine", [("full", "ell"), ("full", "coo"), ("svi", "ell")])
def test_resume_equals_uninterrupted_fit(tmp_path, mode, engine):
    kw, total, every = (dict(FULL, engine=engine), 20, 5) if mode == "full" else (SVI, 6, 3)
    df = _df()
    full = _torch_hpf(**kw, maxiter=total).fit(df.copy())
    resumed = _split_run(_torch_hpf, kw, total, every, str(tmp_path / "ck"), df)
    assert resumed.niter == full.niter and resumed.train_llk == full.train_llk
    for name in STATE:
        np.testing.assert_array_equal(getattr(resumed, name), getattr(full, name), name)


def test_checkpoint_files_and_cadence(tmp_path):
    """Full batch: a checkpoint at each block end where the iteration count
    is a multiple of checkpoint_every, with last_crit; SVI: the rng state
    and both numeration arrays."""
    from hpfrec_tpu_torch.utils import io as IO

    ck = str(tmp_path / "ck")
    _torch_hpf(**FULL, maxiter=15, checkpoint_folder=ck, checkpoint_every=10).fit(_df())
    state, meta, rng = IO.load_checkpoint(ck)
    assert meta["niter"] == 10 and rng is None and "last_crit" in meta
    assert sorted(os.listdir(ck)) == ["checkpoint.json", "checkpoint.npz"]
    assert state.G_shp.dtype == np.float64 and isinstance(state.G_shp, np.ndarray)
    ck2 = str(tmp_path / "ck2")
    m = _torch_hpf(**SVI, maxiter=4, checkpoint_folder=ck2, checkpoint_every=2).fit(_df())
    _, meta, rng = IO.load_checkpoint(ck2)
    assert meta["niter"] == 4 and isinstance(rng, np.random.Generator)
    xa = meta["extra_arrays"]
    assert sorted(xa) == ["items_numeration", "users_numeration"]
    assert sorted(xa["users_numeration"]) == list(range(m.nusers))


@pytest.mark.parametrize("mode", ["full", "svi"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages(tmp_path, mode, writer):
    """A checkpoint written by one package resumes in the other, and the
    resumed fit equals both packages' uninterrupted fits to 1e-10."""
    kw, total, every = (FULL, 20, 5) if mode == "full" else (SVI, 6, 3)
    df = _df()
    ck = str(tmp_path / "ck")
    first, second = (_jax_hpf, _torch_hpf) if writer == "jax" else (_torch_hpf, _jax_hpf)
    first(**kw, maxiter=total // 2, checkpoint_folder=ck, checkpoint_every=every).fit(df.copy())
    resumed = second(**kw, maxiter=total, checkpoint_folder=ck,
                     checkpoint_every=every).fit(df.copy(), resume=True)
    for make in (_jax_hpf, _torch_hpf):
        full = make(**kw, maxiter=total).fit(df.copy())
        assert resumed.niter == full.niter
        np.testing.assert_allclose(resumed.train_llk, full.train_llk, rtol=1e-10)
        for name in STATE:
            np.testing.assert_allclose(getattr(resumed, name), getattr(full, name),
                                       rtol=1e-10, err_msg=name)


def test_resume_errors_match_jax(tmp_path):
    df = _df()
    for make in (_jax_hpf, _torch_hpf):
        with pytest.raises(ValueError, match="resume=True but no checkpoint found"):
            make(k=4, maxiter=4, check_every=4, verbose=False,
                 checkpoint_folder=str(tmp_path / "none")).fit(df.copy(), resume=True)
    ck = str(tmp_path / "ck")
    _torch_hpf(**FULL, maxiter=5, checkpoint_folder=ck, checkpoint_every=5).fit(df.copy())
    msgs = []
    for make in (_jax_hpf, _torch_hpf):
        with pytest.raises(ValueError, match="does not match data") as e:
            make(**dict(FULL, k=5), maxiter=10, checkpoint_folder=ck).fit(df.copy(), resume=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---- save / load ----------------------------------------------------------

def _served(m, df):
    u = df["UserId"].to_numpy()
    i = df["ItemId"].to_numpy()
    hist = df.loc[df["UserId"] == u[0], ["ItemId", "Count"]]
    return (m.topN(user=u[0], n=5), m.topN(user=u[3], n=7, exclude_seen=False),
            m.predict(user=u[:30], item=i[:30]), m.predict_factors(hist.copy()))


def _assert_same_serving(a, b, exact=True):
    for x, y in zip(a, b):
        if exact:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-10)


@pytest.mark.parametrize("saver", ["torch", "jax"])
@pytest.mark.parametrize("loader", ["torch", "jax"])
def test_save_load_across_packages(tmp_path, saver, loader):
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu_torch import HPF as HT

    jax.config.update("jax_enable_x64", True)  # a loaded float64 model serves in float64
    df = _df()
    make = _torch_hpf if saver == "torch" else _jax_hpf
    m = make(**FULL, maxiter=10).fit(df.copy())
    path = str(tmp_path / "model")
    m.save(path)
    assert sorted(os.listdir(path)) == ["model.json", "model.npz"]
    m2 = HT.load(path, device="cpu") if loader == "torch" else HJ.load(path)
    assert m2.is_fitted and (m2.nusers, m2.nitems, m2.niter) == (m.nusers, m.nitems, m.niter)
    assert m2.train_llk == m.train_llk and m2.user_dict_ == m.user_dict_
    for name in STATE:
        np.testing.assert_array_equal(getattr(m2, name), getattr(m, name))
    _assert_same_serving(_served(m2, df), _served(m, df), exact=saver == loader)


def test_save_writes_no_spare_rows_after_growth(tmp_path):
    """add_user grows the model's arrays inside buffers with spare rows;
    save writes each attribute's own rows, and the loaded model serves the
    new user as the grown one does."""
    from hpfrec_tpu_torch import HPF

    df = _df()
    m = _torch_hpf(**FULL, maxiter=10).fit(df.copy())
    hist = np.column_stack([np.arange(0, 30, 3), np.ones(10)])
    for uid in (1000, 1001, 1002):
        m.add_user(uid, pd.DataFrame(hist, columns=["ItemId", "Count"]))
    assert m.Theta.base is not None and m.Theta.base.shape[0] > m.Theta.shape[0]
    path = str(tmp_path / "model")
    m.save(path)
    with np.load(os.path.join(path, "model.npz"), allow_pickle=True) as z:
        assert z["Theta"].shape == (m.nusers, 6) == z["Gamma_shp"].shape
        assert z["k_rte"].shape == (m.nusers, 1)
        assert z["_n_seen_by_user"].shape == (m.nusers,)
        assert z["seen"].shape == m.seen.shape
    m2 = HPF.load(path, device="cpu")
    np.testing.assert_array_equal(m2.topN(1002, n=5), m.topN(1002, n=5))
    np.testing.assert_array_equal(m2.Theta, m.Theta)


def test_load_reads_the_saved_options(tmp_path):
    from hpfrec_tpu_torch import HPF

    m = _torch_hpf(**SVI, maxiter=4).fit(_df())
    m.save(str(tmp_path / "m"))
    with open(tmp_path / "m" / "model.json") as f:
        meta = json.load(f)
    assert meta["users_per_batch"] == 16 and meta["use_float"] is False
    step = lambda x: 0.5  # noqa: E731
    m2 = HPF.load(str(tmp_path / "m"), step_size=step, device="cpu")
    assert m2.step_size is step and m2.device == "cpu" and m2.items_per_batch == 11


# ---- save_folder -----------------------------------------------------------

def _id_frame(kind):
    df = _df(seed=5, nU=30, nI=20, nnz=300)
    if kind == "str":
        df["UserId"] = ["u,%d" % u if u % 3 else 'u"%d' % u for u in df["UserId"]]
        df["ItemId"] = ["i %d" % i if i % 2 else 'i,"%d"' % i for i in df["ItemId"]]
    return df


@pytest.mark.parametrize("kind", ["int", "str"])
def test_save_folder_matches_jax(tmp_path, kind):
    df = _id_frame(kind)
    kw = dict(k=4, maxiter=5, check_every=5, random_seed=7, verbose=False)
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    dj.mkdir(), dt.mkdir()
    _jax_hpf(**kw, save_folder=str(dj)).fit(df.copy())
    m = _torch_hpf(**kw, save_folder=str(dt)).fit(df.copy())
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    for name in ("users.csv", "items.csv", "hyperparameters.txt"):
        assert (dt / name).read_bytes() == (dj / name).read_bytes(), name
    if kind == "str":
        assert b'"u,1"' in (dt / "users.csv").read_bytes()
    arrays = dict(Theta=m.Theta, Beta=m.Beta, Gamma_shp=m.Gamma_shp, Gamma_rte=m.Gamma_rte,
                  Lambda_shp=m.Lambda_shp, Lambda_rte=m.Lambda_rte, kappa_rte=m.k_rte,
                  tau_rte=m.t_rte)
    for name, arr in arrays.items():
        got = np.loadtxt(dt / name, delimiter=",", ndmin=2)
        np.testing.assert_allclose(got, arr.reshape(got.shape), rtol=0, atol=5.1e-11,
                                   err_msg=name)


def test_save_folder_without_pandas(tmp_path, monkeypatch):
    """Integer ids from an ndarray with pandas hidden from the port: the
    same bytes as the JAX package writes with pandas."""
    from hpfrec_tpu_torch.utils import data as DT

    df = _id_frame("int")
    arr = df[["UserId", "ItemId", "Count"]].to_numpy().astype(np.int64)
    kw = dict(k=4, maxiter=5, check_every=5, random_seed=None, verbose=False)
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    dj.mkdir(), dt.mkdir()
    _jax_hpf(**kw, save_folder=str(dj)).fit(arr.copy())
    monkeypatch.setattr(DT, "_pandas", lambda: None)
    _torch_hpf(**kw, save_folder=str(dt)).fit(arr.copy())
    for name in ("users.csv", "items.csv", "hyperparameters.txt"):
        assert (dt / name).read_bytes() == (dj / name).read_bytes(), name
    assert (dt / "hyperparameters.txt").read_text().endswith("random seed: None\n")


def test_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    _torch_hpf(k=3, maxiter=4, check_every=2, verbose=False, engine="coo",
               profile_dir=str(prof)).fit(_df(nU=20, nI=15, nnz=150))
    trace = prof / "trace.json"
    assert trace.stat().st_size > 0
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
