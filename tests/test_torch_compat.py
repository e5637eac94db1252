"""The port's module-level helpers (``hpfrec_tpu_torch.compat``, over its own
``utils.data.gather_batch_nonzeros``) against ``hpfrec_tpu.compat`` on the
same inputs.  Every helper is integer bookkeeping or a float32 cast of the
input, so the results must be equal, not close."""

import numpy as np
import pytest

from oracle import synth_counts


def _triplets(seed):
    y, iu, ii = synth_counts(50, 35, nnz=600, seed=seed)
    return y, iu, ii


@pytest.mark.parametrize("fn,arg", [("cast_real_t", 1.5), ("cast_real_t", 3),
                                    ("cast_int", 7.0), ("cast_ind_type", 2 ** 20)])
def test_casts_match(fn, arg):
    from hpfrec_tpu import compat as CJ
    from hpfrec_tpu_torch import compat as CT

    got, ref = getattr(CT, fn)(arg), getattr(CJ, fn)(arg)
    assert type(got) is type(ref) and got == ref
    assert CT.c_real_t is CJ.c_real_t and CT.obj_ind_type is CJ.obj_ind_type


@pytest.mark.parametrize("seed", [1, 2])
def test_get_csc_data_matches(seed):
    from hpfrec_tpu import compat as CJ
    from hpfrec_tpu_torch import compat as CT

    y, iu, ii = _triplets(seed)
    for got, ref in zip(CT.get_csc_data(iu, ii, y, 50, 35), CJ.get_csc_data(iu, ii, y, 50, 35)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("return_ix", [False, True])
@pytest.mark.parametrize("users", [[3, 0, 17, 49], [5], list(range(50))],
                         ids=["some", "one", "all"])
def test_get_unique_items_batch_matches(users, return_ix):
    from hpfrec_tpu import compat as CJ
    from hpfrec_tpu_torch import compat as CT
    from hpfrec_tpu_torch.utils.data import build_csr

    y, iu, ii = _triplets(3)
    indptr, indices, _ = build_csr(iu, ii, y, 50, 35)
    got = CT.get_unique_items_batch(np.array(users), indptr, indices, 1, return_ix)
    ref = CJ.get_unique_items_batch(np.array(users), indptr, indices, 1, return_ix)
    for g, r in zip(got if return_ix else [got], ref if return_ix else [ref]):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_batch_nonzeros_matches(monkeypatch, native, dtype):
    """Both routes of the port's gather (the native helper and the numpy
    fallback) against the JAX package's, rows in shuffled order with a
    repeat and an empty row."""
    from hpfrec_tpu.utils.data import gather_batch_nonzeros as GJ
    from hpfrec_tpu_torch import _native
    from hpfrec_tpu_torch.utils.data import build_csr, gather_batch_nonzeros

    y, iu, ii = _triplets(4)
    indptr, indices, data = build_csr(iu, ii, y.astype(dtype), 51, 35)  # row 50 is empty
    if native and not _native.available():
        pytest.skip("the native helpers did not build")
    if not native:
        monkeypatch.setattr(_native, "available", lambda: False)
    rows = np.array([7, 50, 2, 7, 33, 0], dtype=np.int32)
    got = gather_batch_nonzeros(indptr, indices, data, rows)
    ref = GJ(indptr, indices, data, rows)
    assert [g.dtype for g in got] == [r.dtype for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
