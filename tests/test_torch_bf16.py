"""bfloat16 gather tables (``gather_dtype='bfloat16'``) of the port's ELL
engine against hpfrec_tpu on the CPU: whole forced-bfloat16 full-batch
fits with a float32 and a float64 state, K1's plain version on bfloat16
tables, K2's float32-to-state-dtype reassembly, and K3's bfloat16 store,
including a value that a direct float64 -> bfloat16 rounding would round
the other way.

Tolerances.  Ten iterations: llk at the checks 1e-6, factors 1e-5
(measured float32 9.0e-8 / 7.2e-7, float64 3.1e-9 / 1.7e-7).  The gap is
step-like: the float32 sums of the two packages add in other orders, and
where such a difference straddles a bfloat16 rounding boundary a table
entry moves by 2^-8 (measured: a float64-state fit of 20 iterations
drifts to 3.3e-3 in its smallest factors).  K1 per bucket: rtol 1e-5 on
the same bfloat16 tables (float32 sums in another order).
"""

import numpy as np
import pandas as pd
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


def _x64(dtype):
    import jax

    jax.config.update("jax_enable_x64", dtype == np.float64)


def _df(nU=70, nI=50, nnz=900, seed=8):
    y, iu, ii = synth_counts(nU, nI, nnz=nnz, seed=seed)
    return pd.DataFrame({"UserId": iu, "ItemId": ii, "Count": y})


class _Recorder:
    def _evaluate_criterion(self, *a, **k):
        out = super()._evaluate_criterion(*a, **k)
        self.llk_trace.append(self._last_llk)
        return out


def _fit(cls, dtype, **kw):
    m = type("Recording", (_Recorder, cls), {})(
        k=5, maxiter=10, check_every=5, stop_crit="train-llk", stop_thr=1e-10,
        random_seed=3, use_float=dtype == np.float32, verbose=False, **kw)
    m.llk_trace = []
    return m.fit(_df())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_fit_matches_jax(dtype):
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    _x64(dtype)
    mj = _fit(HJ, dtype, gather_dtype="bfloat16", mesh=make_mesh(jax.devices()[:1]))
    mt = _fit(HT, dtype, gather_dtype="bfloat16", device="cpu")
    assert mt.niter == mj.niter and len(mt.llk_trace) == 2
    np.testing.assert_allclose(mt.llk_trace, mj.llk_trace, rtol=1e-6)
    for name in ("Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte",
                 "k_rte", "t_rte"):
        assert getattr(mt, name).dtype == dtype
        np.testing.assert_allclose(getattr(mt, name), getattr(mj, name), rtol=1e-5,
                                   err_msg=name)
    # the tables really were bfloat16: the fit differs from the state-dtype one
    plain = _fit(HT, dtype, device="cpu")
    assert np.abs(plain.Theta / mt.Theta - 1).max() > 1e-3


@pytest.mark.parametrize("mode,expected", [("auto", None), ("float32", None),
                                           ("bfloat16", torch.bfloat16)])
def test_gather_table_dtype(mode, expected):
    """The port's 'auto' keeps the state dtype at every size (JAX's 64 MiB
    rule is a TPU threshold)."""
    from hpfrec_tpu_torch.ops.ell import gather_table_dtype

    assert gather_table_dtype(mode) is expected


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_bucket_phi_sums_match_jax(dtype):
    """K1's plain version on bfloat16 tables with vals of the state dtype
    against JAX's _bucket_phi_sums on the same tables: float32 out."""
    import jax.numpy as jnp
    from scipy.sparse import coo_array

    from hpfrec_tpu.ops.ell import _bucket_phi_sums
    from hpfrec_tpu_torch.ops import ell as E

    _x64(dtype)
    y, iu, ii = synth_counts(60, 40, nnz=700, seed=2)
    X = coo_array((y.astype(dtype), (iu, ii)), shape=(60, 40)).tocsr()
    lay = E.to_device(E.build_ell(X.indptr.astype(np.int64), X.indices.astype(np.int32),
                                  X.data, 60, max_width=16, dtype=dtype), "cpu")
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.random((60, 6)) + 0.05).to(torch.bfloat16)
    b = torch.from_numpy(rng.random((40, 6)) + 0.05).to(torch.bfloat16)
    seg = E.all_bucket_sums(t, b, lay)
    assert seg.dtype == torch.float32
    tj, bj = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (t, b))
    ref = np.concatenate([np.asarray(_bucket_phi_sums(
        tj, bj, jnp.asarray(bk.rows.numpy()), jnp.asarray(bk.cols.numpy()),
        jnp.asarray(bk.vals.numpy()))[0]) for bk in lay.buckets])
    assert ref.dtype == np.float32
    np.testing.assert_allclose(seg.numpy(), ref, rtol=1e-5)
    out = E.segment_table_sums(seg, lay, torch.float64)
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy(), E.segment_table_sums(seg, lay).double().numpy())


# 0.5 + 2^-9 is the midpoint of the bfloat16 neighbours 0.5 and 0.5 + 2^-8;
# a float64 just above it rounds to the midpoint in float32 and then to
# even (0.5), where one direct rounding gives 0.5 + 2^-8
_ABOVE_MIDPOINT = 0.5 + 2.0 ** -9 + 2.0 ** -31


def test_float64_to_bf16_rounds_through_float32():
    import jax.numpy as jnp

    x = np.array([_ABOVE_MIDPOINT, 1 + 2.0 ** -8 + 2.0 ** -30])
    got = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, [0.5, 1.0])
    ref = np.asarray(jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("form", ["derive", "update"])
def test_k3_bf16_store_of_a_value_above_a_midpoint(form):
    """A float64 row whose second exp-table entry lies just above a bfloat16
    midpoint, through K3's plain version: stored as 0.5 (rounded through
    float32), as JAX's _carry_init stores it."""
    import jax
    import jax.numpy as jnp

    from hpfrec_tpu.models.state import VariationalState as VJ
    from hpfrec_tpu.ops.ell import _carry_init
    from hpfrec_tpu_torch.ops import cavi as C

    jax.config.update("jax_enable_x64", True)
    shp = np.full((1, 2), 3.0)
    rte = np.array([[2.0, 2.0 / _ABOVE_MIDPOINT]])
    tab64 = C.exp_elog_tables(torch.from_numpy(shp), torch.from_numpy(rte))
    assert 0.5 + 2.0 ** -9 < float(tab64[0, 1]) < 0.5 + 2.0 ** -9 + 2.0 ** -25
    if form == "derive":
        tab = C.side_derive(torch.from_numpy(shp), torch.from_numpy(rte), torch.bfloat16)[0]
    else:  # the update form with the rate of rte and the shape of shp
        tab = C.side_update(torch.from_numpy(shp - 0.3), torch.ones((1, 1), dtype=torch.float64),
                            torch.from_numpy(rte - 1.0), 0.3, 1.0, 0.0, torch.bfloat16)[2]
    assert tab.dtype == torch.bfloat16
    np.testing.assert_array_equal(tab.float().numpy(), [[1.0, 0.5]])
    z = np.ones((1, 2))
    ref = _carry_init(VJ(*(jnp.asarray(a) for a in (shp, rte, shp, rte, z[:, :1], z[:, :1]))),
                      jnp.bfloat16)[1]
    np.testing.assert_array_equal(tab.float().numpy(), np.asarray(ref.astype(jnp.float32)))
