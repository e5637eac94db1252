"""hpfrec_tpu_torch.utils.data against hpfrec_tpu.utils.data: the same
triplets, mappings and CSR for DataFrame, ndarray and coo_array input; and
the pandas-free paths (numpy id mapping, native factorize)."""

import numpy as np
import pandas as pd
import pytest

from oracle import synth_counts


def _inputs():
    from scipy.sparse import coo_array

    y, iu, ii = synth_counts(50, 40, nnz=600, seed=6)
    rng = np.random.default_rng(0)
    perm_u = rng.permutation(1000)[:50] + 7  # non-contiguous raw ids
    perm_i = rng.permutation(500)[:40]
    y = y.copy()
    y[::37] = 0.5  # dropped by the likelihood criteria's filter
    df = pd.DataFrame({"UserId": perm_u[iu], "ItemId": perm_i[ii], "Count": y})
    return {
        "frame": df,
        "frame_str": df.assign(UserId=["u%d" % v for v in df.UserId]),
        "ndarray": np.column_stack([perm_u[iu], perm_i[ii], y]),
        "coo": coo_array((y, (iu, ii)), shape=(55, 40)),
    }


# string ids need reindexing, so ("frame_str", False) is not a case
@pytest.mark.parametrize("kind,reindex", [("frame", True), ("frame", False),
                                          ("frame_str", True), ("ndarray", True),
                                          ("ndarray", False), ("coo", True)])
@pytest.mark.parametrize("stop_crit", ["maxiter", "train-llk"])
def test_process_data_matches_jax(kind, reindex, stop_crit):
    from hpfrec_tpu.utils import data as DJ
    from hpfrec_tpu_torch.utils import data as DT

    inp = _inputs()[kind]
    pj = DJ.process_data(inp, stop_crit, reindex, np.float32)
    if stop_crit == "train-llk":
        with pytest.warns(UserWarning, match="less than 1"):
            pt = DT.process_data(inp, stop_crit, reindex, np.float32)
    else:
        pt = DT.process_data(inp, stop_crit, reindex, np.float32)
    for name in ("y", "ix_u", "ix_i", "user_mapping", "item_mapping"):
        a, b = getattr(pj, name), getattr(pt, name)
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (pj.nusers, pj.nitems, pj.sorted_by_user) == \
        (pt.nusers, pt.nitems, pt.sorted_by_user)
    cj = DJ.build_csr(pj.ix_u, pj.ix_i, pj.y, pj.nusers, pj.nitems)
    ct = DT.build_csr(pt.ix_u, pt.ix_i, pt.y, pt.nusers, pt.nitems)
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(a, b)


def test_bad_input_raises():
    from hpfrec_tpu_torch.utils.data import process_data

    with pytest.raises(ValueError, match="must be a pandas data frame"):
        process_data([[1, 2, 3]], "maxiter", True)
    with pytest.raises(ValueError, match="no valid observations"):
        process_data(np.array([[1, 2, 0.0]]), "maxiter", True)


@pytest.mark.parametrize("mapping", [np.array([5, 3, 9, 1]),
                                     np.array(["b", "a", "d"], dtype=object)])
def test_numpy_id_mapping_matches_pandas(mapping):
    from hpfrec_tpu_torch.utils.data import _map_numpy, map_to_training_ids

    values = np.concatenate([mapping[::-1], mapping[:1],
                             np.array([7 if mapping.dtype != object else "zz"],
                                      dtype=mapping.dtype)])
    np.testing.assert_array_equal(_map_numpy(values, mapping),
                                  map_to_training_ids(values, mapping))


def test_native_factorize_matches_pandas():
    from hpfrec_tpu_torch import _native
    from hpfrec_tpu_torch.utils.data import _factorize_native

    if not _native.available():
        pytest.skip("native helpers not built: %s" % _native.load_error())
    vals = np.random.default_rng(1).integers(0, 50, 400) * 3 + 11
    codes, uniq = _factorize_native(vals)
    pc, pu = pd.factorize(vals)
    np.testing.assert_array_equal(codes, pc)
    np.testing.assert_array_equal(uniq, pu)
    with pytest.raises(TypeError):
        _factorize_native(np.array(["a", "b"]))
