"""K3's plain version (hpfrec_tpu_torch.ops.cavi side_update / side_derive)
against hpfrec_tpu's exp_elog_tables and the table math of
cavi_step_ell_carried / _carry_init, including a row with rte = +inf (the
non-finite rowmax guard, hpfrec_tpu/ops/cavi.py:67).

Tolerances: float64 rtol 1e-12; float32 rtol 1e-5 (the two packages'
float32 digamma are each ~1.3e-6 off in absolute terms)."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _restore_x64():
    """Leave jax_enable_x64 as the test found it: the flag is process-wide
    and would leak into the next test file on this worker."""
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


TOLS = [(np.float64, 1e-12), (np.float32, 1e-5)]


def _x64(dtype):
    if dtype == np.float64:
        import jax

        jax.config.update("jax_enable_x64", True)


def _inputs(dtype, n=40, k=7, seed=0):
    rng = np.random.default_rng(seed)
    sums = (rng.random((n, k)) * 20).astype(dtype)
    scaler = (rng.random((n, 1)) + 0.5).astype(dtype)
    colsum = (rng.random((1, k)) * 30).astype(dtype)
    return sums, scaler, colsum


@pytest.mark.parametrize("dtype,rtol", TOLS)
def test_exp_elog_tables_matches_jax_with_inf_row(dtype, rtol):
    import jax.numpy as jnp

    from hpfrec_tpu.ops import cavi as CJ
    from hpfrec_tpu_torch.ops import cavi as CT

    _x64(dtype)
    sums, _, _ = _inputs(dtype)
    shp = sums + dtype(0.3)
    rte = (np.random.default_rng(1).random(shp.shape) + 0.2).astype(dtype)
    rte[3] = np.inf
    ref = np.asarray(CJ.exp_elog_tables(jnp.asarray(shp), jnp.asarray(rte)))
    out = CT.exp_elog_tables(torch.from_numpy(shp), torch.from_numpy(rte)).numpy()
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=0)
    assert np.all(out[3] == 0.0) and np.all(np.isfinite(out))
    np.testing.assert_allclose(
        CT.elog_tables(torch.from_numpy(shp), torch.from_numpy(rte)).numpy()[:3],
        np.asarray(CJ.elog_tables(jnp.asarray(shp), jnp.asarray(rte)))[:3],
        rtol=rtol, atol=1e-6 if dtype == np.float32 else 1e-14)


@pytest.mark.parametrize("dtype,rtol", TOLS)
@pytest.mark.parametrize("side", ["user", "item"])
def test_side_update_matches_carried_step_math(dtype, rtol, side):
    """side_update(...) == the per-side table math of
    hpfrec_tpu.ops.ell.cavi_step_ell_carried (ell.py:795-812)."""
    import jax.numpy as jnp

    from hpfrec_tpu.models.state import Hyperparams
    from hpfrec_tpu.ops.cavi import exp_elog_tables
    from hpfrec_tpu_torch.ops.cavi import side_update

    _x64(dtype)
    hp = Hyperparams(a=0.35, a_prime=0.2, b_prime=1.3, c=0.25, c_prime=0.4,
                     d_prime=0.8, k=7)
    prior, shape, add = ((hp.a, hp.k_shp, hp.add_k_rte) if side == "user"
                         else (hp.c, hp.t_shp, hp.add_t_rte))
    sums, scaler, colsum = _inputs(dtype, seed=2)
    s, sc, cs = jnp.asarray(sums), jnp.asarray(scaler), jnp.asarray(colsum)
    rte_j = shape / sc + cs
    shp_j = prior + s
    mean_j = shp_j / rte_j
    ref = (shp_j, rte_j, exp_elog_tables(shp_j, rte_j),
           add + jnp.sum(mean_j, axis=1, keepdims=True),
           jnp.sum(mean_j, axis=0, keepdims=True))
    got = side_update(torch.from_numpy(sums), torch.from_numpy(scaler),
                      torch.from_numpy(colsum), prior, shape, add)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.from_numpy(np.asarray(r)).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype,rtol", TOLS)
def test_side_derive_matches_carry_init(dtype, rtol):
    import jax.numpy as jnp

    from hpfrec_tpu.models import state as SJ
    from hpfrec_tpu.ops.ell import _carry_init
    from hpfrec_tpu_torch.models import state as ST
    from hpfrec_tpu_torch.ops.cavi import side_derive

    _x64(dtype)
    hp = SJ.Hyperparams(k=5)
    sj = SJ.initialize_state(23, 19, hp, 7, dtype)
    st = ST.initialize_state(23, 19, ST.Hyperparams(k=5), 7, dtype)
    _, t_tab, b_tab, beta_colsum = _carry_init(sj, None)
    t_got, theta_colsum = side_derive(st.G_shp, st.G_rte)
    b_got, beta_got = side_derive(st.L_shp, st.L_rte)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_tab), rtol=rtol, atol=0)
    np.testing.assert_allclose(b_got.numpy(), np.asarray(b_tab), rtol=rtol, atol=0)
    np.testing.assert_allclose(beta_got.numpy(), np.asarray(beta_colsum), rtol=rtol, atol=0)
    np.testing.assert_allclose(
        theta_colsum.numpy(),
        np.asarray(jnp.sum(sj.G_shp / sj.G_rte, axis=0, keepdims=True)), rtol=rtol, atol=0)
