"""The port's user entry points against the JAX repo's, on the CPU:
``example/northstar_e2e_torch.py``, ``example/millionsong_scale_torch.py``,
``example/quickstart_torch.py`` and ``scripts/quality_oracle_parity_torch.py``
against ``example/northstar_e2e.py``, ``example/millionsong_scale.py``,
``example/quickstart.py`` and ``scripts/quality_oracle_parity.py`` (loaded
from their paths, unedited).

Tolerances: the generators and splits bit-equal; the north-star fit
(~400 x 300, 20,000 rows with repeated pairs, k=8, val-llk every 2) against
``hpfrec_tpu.HPF`` with the same arguments: the same stopping iteration,
float64 val-llk at each check rel 1e-9 and factors 1e-9, float32 val-llk
rel 1e-4 (the factors drift ~1.45x an iteration in float32 and are not
compared); the quality parity at a small Zipf scale (2,000 x 800, 40,000
nonzeros, k=8, 10 iterations): the port's column within the script's own
limits of the oracle's, and both columns within 1e-6 of the JAX script's
(rel; abs for corr(Count, Predicted), which is near 0 on these iid counts,
and for recall@10 and NDCG@10).
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib

import numpy as np
import pandas as pd
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
# the JAX example sets this at import; the tests leave the environment as
# they found it
_TRANSFERS_ENV = "HPFREC_TPU_PROFILE_TRANSFERS"


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    mod = importlib.util.module_from_spec(spec)
    old = os.environ.get(_TRANSFERS_ENV)
    try:
        spec.loader.exec_module(mod)
    finally:
        if old is None:
            os.environ.pop(_TRANSFERS_ENV, None)
        else:
            os.environ[_TRANSFERS_ENV] = old
    return mod


@pytest.fixture(scope="module")
def scripts():
    """name -> (the JAX repo's script, the port's twin)."""
    return {name: (_load(jax_path, f"_jax_{name}"), _load(port_path, f"_port_{name}"))
            for name, jax_path, port_path in (
                ("northstar", "example/northstar_e2e.py", "example/northstar_e2e_torch.py"),
                ("millionsong", "example/millionsong_scale.py",
                 "example/millionsong_scale_torch.py"),
                ("quickstart", "example/quickstart.py", "example/quickstart_torch.py"),
                ("parity", "scripts/quality_oracle_parity.py",
                 "scripts/quality_oracle_parity_torch.py"))}


@pytest.fixture(autouse=True)
def _restore_x64():
    """Leave jax_enable_x64 as the test found it (process-wide flag)."""
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("seed", [0, 3])
def test_generators_bit_equal(scripts, seed):
    """Each twin's generator and split give the JAX script's arrays bit for
    bit at small sizes."""
    ns_j, ns_t = scripts["northstar"]
    got, ref = ns_t.synth_tasteprofile(500, 300, 6_000, seed), ns_j.synth_tasteprofile(
        500, 300, 6_000, seed)
    assert all(np.array_equal(g, r) and g.dtype == r.dtype for g, r in zip(got, ref))
    # the JAX script's DataFrames, from its own calls
    iu, ii, y = ref
    is_train = np.random.default_rng(7).random(len(iu)) < 0.8
    for arr, mask in zip(ns_t.split_80_20(*got), (is_train, ~is_train)):
        frame = pd.DataFrame({"UserId": iu[mask], "ItemId": ii[mask], "Count": y[mask]})
        assert np.array_equal(arr, frame.to_numpy())

    ms_j, ms_t = scripts["millionsong"]
    assert np.array_equal(ms_t.synth_tasteprofile(500, 300, 6_000, seed),
                          ms_j.synth_tasteprofile(500, 300, 6_000, seed))

    pa_j, pa_t = scripts["parity"]
    assert all(np.array_equal(g, r) for g, r in zip(pa_t.synth_zipf(500, 300, 6_000, seed),
                                                    pa_j.synth_zipf(500, 300, 6_000, seed)))
    assert pa_t.SCALES == pa_j.SCALES


@pytest.mark.parametrize("seed", [1, 5])
def test_quickstart_data_and_split_match_pandas(scripts, seed):
    """``drop_duplicates`` and ``sample(frac=0.15, random_state=7)`` /
    ``drop`` done without pandas: the same rows in the same order."""
    qs_j, qs_t = scripts["quickstart"]
    df = qs_j.make_synthetic(300, 200, 6_000, seed=seed)
    arr = qs_t.make_synthetic(300, 200, 6_000, seed=seed)
    assert np.array_equal(arr, df.to_numpy())
    val = df.sample(frac=0.15, random_state=7)
    train, va = qs_t.sample_split(arr)
    assert np.array_equal(va, val.to_numpy())
    assert np.array_equal(train, df.drop(val.index).to_numpy())


def _jax_northstar(ns_j, n_users, n_items, n_rows, dtype):
    """``hpfrec_tpu.HPF`` fitted as the JAX script fits it (its DataFrames,
    its arguments; one device, check every 2), with the llk of each check."""
    import jax

    from hpfrec_tpu import HPF
    from hpfrec_tpu.parallel import make_mesh

    jax.config.update("jax_enable_x64", dtype == "float64")
    iu, ii, y = ns_j.synth_tasteprofile(n_users, n_items, n_rows)
    is_train = np.random.default_rng(7).random(n_rows) < 0.8
    train, val = (pd.DataFrame({"UserId": iu[m], "ItemId": ii[m], "Count": y[m]})
                  for m in (is_train, ~is_train))

    class Recording(HPF):
        def _evaluate_criterion(self, *args, **kwargs):
            out = super()._evaluate_criterion(*args, **kwargs)
            self.checks.append(self._last_llk)
            return out

    model = Recording(k=8, stop_crit="val-llk", check_every=2, stop_thr=1e-3, maxiter=150,
                      random_seed=123, verbose=False, use_float=dtype == "float32",
                      mesh=make_mesh(jax.devices()[:1]))
    model.checks = []
    model.fit(train, val_set=val)
    return model


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_northstar_matches_jax(scripts, dtype):
    """``run_northstar`` at ~400 x 300 users and items, 20,000 rows with
    repeated (user, item) pairs, k=8, val-llk every 2, on the CPU, against
    the JAX package's fit of the same data with the same arguments."""
    ns_j, ns_t = scripts["northstar"]
    sizes = dict(n_users=400, n_items=300, n_rows=20_000)
    iu, ii, _ = ns_t.synth_tasteprofile(400, 300, 20_000)
    assert len(np.unique(iu * 300 + ii)) < len(iu)  # pairs repeat

    model, checks, stats, wall, val = ns_t.run_northstar(
        **sizes, k=8, maxiter=150, device="cpu", dtype=dtype, check_every=2, verbose=False)
    ref = _jax_northstar(ns_j, **sizes, dtype=dtype)

    assert model.niter == ref.niter < 149  # stopped by the val-llk criterion
    assert [it for it, _ in checks] == list(range(2, 2 * len(checks) + 1, 2))
    assert len(checks) == len(ref.checks) >= 2
    got = np.array([llk for _, llk in checks])
    if dtype == "float64":
        np.testing.assert_allclose(got, ref.checks, rtol=1e-9)
        np.testing.assert_allclose(model.Theta, ref.Theta, rtol=1e-9)
        np.testing.assert_allclose(model.Beta, ref.Beta, rtol=1e-9)
    else:
        np.testing.assert_allclose(got, ref.checks, rtol=1e-4)
    assert stats.iterations == model.niter + 1 and wall > 0
    assert val.shape == (20_000 - model.fit_stats_.nnz, 3)


PARITY_SMALL = dict(nU=2_000, nI=800, nnz=40_000, k=8, iters=10, rank_users=None)


def test_quality_parity_small_scale(scripts, monkeypatch):
    """The parity function at a small Zipf scale on the CPU: the port's
    column within the script's limits of the oracle's, and within 1e-6 of
    the JAX script's own column on the same data."""
    pa_j, pa_t = scripts["parity"]
    res = pa_t.run_parity(**PARITY_SMALL, device="cpu")
    assert pa_t.failed_limits(res["rows"]) == {}

    # the JAX script, unedited, at the same scale
    monkeypatch.setitem(pa_j.SCALES, "small", PARITY_SMALL)
    monkeypatch.setenv("QUALITY_SCALE", "small")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        pa_j.main()
    ref = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["n_eval_users"] == ref["n_eval_users"]
    for name, port, oracle in res["rows"]:
        # the oracle's fit is the same numpy; its column is scored by each
        # package's evaluate
        for col, got in (("framework", port), ("oracle", oracle)):
            if name in ("corr(Count, Predicted)", "recall@10", "NDCG@10"):
                assert abs(got - ref[col][name]) <= 1e-6, (col, name)
            else:
                np.testing.assert_allclose(got, ref[col][name], rtol=1e-6,
                                           err_msg=f"{col} {name}")


def test_parity_limits_fail_visibly(scripts):
    """A column beyond a limit is reported (and the script exits non-zero
    on it); corr is printed only."""
    _, pa_t = scripts["parity"]
    rows = [("train llk (no constant)", -100.0, -100.0), ("ROC-AUC", 0.70, 0.71),
            ("recall@10", 0.20, 0.2049), ("corr(Count, Predicted)", 0.5, -0.5)]
    assert set(pa_t.failed_limits(rows)) == {"ROC-AUC"}
