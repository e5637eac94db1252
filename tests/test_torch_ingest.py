"""The ingest a one-card fit runs on the device (``ops/ingest.py``, K15 in
``ops/ell.py``), run here on CPU tensors through its plain versions,
against the host path it replaces, element for element: the filter,
checks, warnings and errors of ``process_data``; both sides' CSR against
``build_csr``; the full-batch layouts against ``build_layouts`` (or
``build_ell``) then ``to_device``; the SVI sides' degrees against
``epoch_side``'s.  ``build_ell``, now ``plan_ell`` and a fill, against the
JAX package's.  And whole fits whose ingest takes this path (steered with
a monkeypatch of ``HPF._ingest_on_card``, which only a CUDA device
passes): factors, seen-items CSR and counters against the host path's."""

import warnings

import numpy as np
import pytest
import torch

from hpfrec_tpu_torch.ops import ell as E
from hpfrec_tpu_torch.ops import ingest as G
from hpfrec_tpu_torch.ops.svi import epoch_side
from hpfrec_tpu_torch.utils import data as D


def _triplets(nU, nI, n, seed, zero_users=0, zero_items=0, low=0.0, dup=False):
    """Unsorted triplets: heavy items (rows that split at a small width),
    the last ``zero_users`` users and ``zero_items`` items with no entries,
    a share ``low`` of counts at 0 or 0.5, and repeated pairs when
    ``dup``."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, nU - zero_users, n)
    i = np.minimum(rng.zipf(1.3, n) - 1, nI - 1 - zero_items)
    y = (rng.poisson(2.0, n) + 1).astype(np.float64)
    if low:
        pick = rng.random(n) < low
        y[pick] = rng.choice([0.0, 0.5], int(pick.sum()))
    if dup:
        u[1::7], i[1::7] = u[0:-1:7][:len(u[1::7])], i[0:-1:7][:len(i[1::7])]
    return u, i, y


def _coo(u, i, y, nU, nI):
    from scipy.sparse import coo_array

    return coo_array((y, (u, i)), shape=(nU, nI))


CASES = {
    "unsorted_duplicates": dict(kind="coo", dup=True),
    "low_counts_train_llk": dict(kind="coo", low=0.2, stop_crit="train-llk"),
    "low_counts_maxiter": dict(kind="coo", low=0.2, stop_crit="maxiter"),
    "low_counts_diff_norm": dict(kind="coo", low=0.2, stop_crit="diff-norm"),
    "empty_rows": dict(kind="coo", zero_users=7, zero_items=5),
    "split_and_merged_buckets": dict(kind="coo", max_width=16),
    "reindex_codes": dict(kind="frame", reindex=True, low=0.1),
    "reindex_ndarray": dict(kind="ndarray", reindex=True),
    "ndarray_sizes_from_maxima": dict(kind="ndarray", zero_users=4, zero_items=3),
    "int64_ids": dict(kind="ndarray_int64"),
    "int_counts": dict(kind="int_counts", low=0.1),
}


def _input(case, seed=3):
    c = CASES[case]
    nU, nI = 200, 90
    u, i, y = _triplets(nU, nI, 4000, seed, c.get("zero_users", 0), c.get("zero_items", 0),
                        c.get("low", 0.0), c.get("dup", False))
    kind = c["kind"]
    if kind == "coo":
        return _coo(u, i, y, nU, nI)
    if kind == "frame":
        pd = pytest.importorskip("pandas")
        return pd.DataFrame({"UserId": u * 3 + 11, "ItemId": i * 5 + 2, "Count": y})
    if kind == "int_counts":
        return np.column_stack([u, i, y]).astype(np.int64)
    if kind == "ndarray_int64":
        return np.column_stack([u, i, y]).astype(np.float64)
    return np.column_stack([u, i, y])


def _host_and_card(inp, stop_crit, reindex, dtype):
    with warnings.catch_warnings(record=True) as wh:
        warnings.simplefilter("always")
        host = D.process_data(inp, stop_crit, reindex, dtype)
    with warnings.catch_warnings(record=True) as wc:
        warnings.simplefilter("always")
        card = G.upload_triplets(inp, stop_crit, reindex, dtype, "cpu")
    assert [str(w.message) for w in wh] == [str(w.message) for w in wc]
    return host, card, [str(w.message) for w in wh]


def _equal_tensor(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def _equal_device_ell(ref, got):
    assert len(ref.buckets) == len(got.buckets)
    for a, b in zip(ref.buckets, got.buckets):
        for x, z in zip(a[:3], b[:3]):
            _equal_tensor(x, z)
        assert (a.col_off, a.start) == (b.col_off, b.start)
    for name in ("inv_perm", "split_seg_pos", "split_indptr"):
        _equal_tensor(getattr(ref, name), getattr(got, name))
    assert (ref.n_rows, ref.n_segs, ref.n_shards) == (got.n_rows, got.n_segs, got.n_shards)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_ingest_equals_the_host_path(case, dtype):
    c = CASES[case]
    stop_crit = c.get("stop_crit", "train-llk")
    reindex = c.get("reindex", False)
    host, card, warned = _host_and_card(_input(case), stop_crit, reindex, dtype)
    if c.get("low"):
        assert warned  # the case drops counts under its criterion's threshold
    assert card.nnz == host.nnz
    assert (card.nusers, card.nitems) == (host.nusers, host.nitems)
    for name in ("user_mapping", "item_mapping"):
        a, b = getattr(host, name), getattr(card, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    nU, nI = host.nusers, host.nitems
    user, item = G.sort_sides(card)
    assert card.y is None and card.ix_u is None  # the sort took the tensors
    for side, ref in ((user, D.build_csr(host.ix_u, host.ix_i, host.y, nU, nI)),
                      (item, D.build_csr(host.ix_i, host.ix_u, host.y, nI, nU))):
        assert side.indptr.dtype == np.int64
        np.testing.assert_array_equal(side.indptr, ref[0])
        _equal_tensor(side.indptr_dev, torch.from_numpy(ref[0].astype(np.int32)))
        _equal_tensor(side.cols, torch.from_numpy(ref[1]))
        _equal_tensor(side.vals, torch.from_numpy(ref[2]))
        # the SVI side's degrees, as epoch_side takes them
        ref_side = epoch_side(*ref, dtype, "cpu")
        np.testing.assert_array_equal(np.diff(side.indptr).astype(np.int32), ref_side.deg)
        _equal_tensor(side.indptr_dev, ref_side.indptr)
    max_width = c.get("max_width")
    if max_width is None:
        refs = [E.to_device(lay, "cpu") for lay in E.build_layouts(host, dtype)]
    else:
        refs = [E.to_device(E.build_ell(*D.build_csr(r, o, host.y, n, m), n, max_width,
                                        dtype=dtype), "cpu")
                for r, o, n, m in ((host.ix_u, host.ix_i, nU, nI),
                                   (host.ix_i, host.ix_u, nI, nU))]
        assert refs[1].split_seg_pos.shape[0] > 0  # the case splits item rows
    for side, ref in zip((user, item), refs):
        got = E.device_ell(E.pack_ell(side.indptr, side.cols, side.vals, max_width or 8192))
        _equal_device_ell(ref, got)


def test_only_the_user_side_when_items_are_not_asked():
    host, card, _ = _host_and_card(_input("unsorted_duplicates"), "train-llk", False,
                                   np.float32)
    user, item = G.sort_sides(card, items=False)
    assert item is None
    np.testing.assert_array_equal(
        user.cols.numpy(), D.build_csr(host.ix_u, host.ix_i, host.y, host.nusers,
                                       host.nitems)[1])


@pytest.mark.parametrize("kind", ["coo_int", "ndarray"])
def test_negative_ids_raise_as_on_the_host(kind):
    u, i, y = _triplets(50, 30, 500, 1)
    u = u.copy()
    u[17] = -1
    inp = np.column_stack([u, i, y]) if kind == "ndarray" else np.column_stack(
        [i, u, y]).astype(np.int64)
    with pytest.raises(ValueError) as host:
        D.process_data(inp, "train-llk", False)
    with pytest.raises(ValueError) as card:
        G.upload_triplets(inp, "train-llk", False, np.float32, "cpu")
    assert str(host.value) == str(card.value)


@pytest.mark.parametrize("stop_crit", ["train-llk", "maxiter"])
def test_no_valid_observations_raise_as_on_the_host(stop_crit):
    u, i, _ = _triplets(50, 30, 200, 2)
    inp = np.column_stack([u, i, np.zeros(200)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError) as host:
            D.process_data(inp, stop_crit, False)
        with pytest.raises(ValueError) as card:
            G.upload_triplets(inp, stop_crit, False, np.float32, "cpu")
    assert str(host.value) == str(card.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_kernels_by_hand(seed):
    """K15a's and K15b's plain versions: int64 ids that wrap, row pointers
    of keys with empty rows at both ends and in between."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(-5, 2 ** 33, 1000))
    out, mm = G.narrow_ids(ids)
    np.testing.assert_array_equal(out.numpy(), ids.numpy().astype(np.int32))
    assert mm.tolist() == [int(ids.min()), int(ids.max())]
    keys = np.sort(rng.integers(3, 40, 500)).astype(np.int32)
    ptr = G.csr_indptr(torch.from_numpy(keys), 45)
    ref = np.zeros(46, dtype=np.int64)
    np.cumsum(np.bincount(keys, minlength=45), out=ref[1:])
    np.testing.assert_array_equal(ptr.numpy(), ref)


@pytest.mark.parametrize("pad_shards", [1, 2, 3])
@pytest.mark.parametrize("max_width", [8, 16, 8192])
@pytest.mark.parametrize("side", ["user", "item"])
def test_build_ell_from_its_plan_equals_jax(side, max_width, pad_shards):
    """``build_ell`` as ``plan_ell`` and a fill packs the JAX package's
    layouts: split rows, buckets small enough to merge (on cascades of
    rungs), padded shards."""
    from hpfrec_tpu.ops import ell as J

    nU, nI = 400, 150
    u, i, y = _triplets(nU, nI, 9000, 5, zero_users=3, zero_items=2)
    if side == "item":
        u, i, nU, nI = i, u, nI, nU
    from scipy.sparse import coo_array

    X = coo_array((y.astype(np.float32), (u, i)), shape=(nU, nI)).tocsr()
    args = (X.indptr.astype(np.int64), X.indices.astype(np.int32), X.data, nU)
    kw = dict(max_width=max_width, pad_shards=pad_shards)
    lj, lt = J.build_ell(*args, **kw), E.build_ell(*args, **kw)
    assert len(lj.buckets) == len(lt.buckets)
    for bj, bt in zip(lj.buckets, lt.buckets):
        for a, b in zip(bj, bt):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for name in ("inv_perm", "split_rows", "split_seg_pos"):
        a, b = getattr(lj, name), getattr(lt, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_plan_merges_cascade():
    """Three thin rungs merge into the fourth, one hop at a time: a rung's
    count includes what merged into it."""
    deg = np.array([8] * 10 + [10] * 10 + [12] * 10 + [14] * 20000, dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    plan = E.plan_ell(*E.untiled_runs(indptr), len(deg))
    assert plan.widths.tolist() == [14]
    assert plan.first.tolist() == [0, len(deg)]


def test_a_cpu_fit_ingests_on_the_host():
    from hpfrec_tpu_torch import HPF

    m = HPF(k=4, maxiter=3, check_every=3, verbose=False, device="cpu").fit(
        _input("unsorted_duplicates"))
    assert m.fit_stats_.device_ingest == 0 and m.fit_stats_.nnz > 0


@pytest.mark.parametrize("engine,world_size,shard_tables,expect", [
    ("ell", None, False, True), ("ell", 1, False, True), ("coo", None, False, False),
    ("ell", 2, False, False), ("ell", 2, True, False), ("coo", 1, False, False)])
def test_which_fits_ingest_on_the_card(engine, world_size, shard_tables, expect):
    """One CUDA device (a mesh of one rank included) with the ELL engine
    ingests on the card; the COO engine, data-parallel meshes, the
    table-sharded engine and the CPU ingest on the host."""
    import types

    from hpfrec_tpu_torch import HPF

    m = HPF(k=3, engine=engine, shard_tables=shard_tables, device="cpu")
    if world_size is not None:
        m.mesh = types.SimpleNamespace(world_size=world_size, rank=0)
    assert m._ingest_on_card(torch.device("cuda")) is expect
    assert m._ingest_on_card(torch.device("cpu")) is False


FIT_MODES = {
    "full_batch": dict(stop_crit="train-llk", check_every=5, maxiter=10),
    "full_batch_no_keep_data": dict(stop_crit="maxiter", maxiter=6, check_every=3,
                                    keep_data=False),
    "svi_alternating": dict(stop_crit="train-llk", check_every=2, maxiter=6,
                            users_per_batch=40, items_per_batch=25),
    "svi_users": dict(stop_crit="maxiter", maxiter=4, check_every=2, users_per_batch=50),
    "svi_items": dict(stop_crit="maxiter", maxiter=4, check_every=2, items_per_batch=30),
}


@pytest.mark.parametrize("use_float", [True, False])
@pytest.mark.parametrize("mode", sorted(FIT_MODES))
def test_a_fit_through_the_device_ingest_equals_the_host_path(monkeypatch, mode, use_float):
    from hpfrec_tpu_torch import HPF

    X = _input("unsorted_duplicates")
    kw = dict(k=5, random_seed=7, verbose=False, device="cpu", use_float=use_float,
              **FIT_MODES[mode])
    host = HPF(**kw).fit(X)
    monkeypatch.setattr(HPF, "_ingest_on_card", lambda self, dev: True)
    card = HPF(**kw).fit(X)
    assert host.fit_stats_.device_ingest == 0
    assert card.fit_stats_.device_ingest == card.fit_stats_.nnz == host.fit_stats_.nnz
    for name in ("Theta", "Beta"):
        a, b = getattr(host, name), getattr(card, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert host.niter == card.niter
    for name in ("seen", "_st_ix_user", "_n_seen_by_user"):
        assert hasattr(host, name) == hasattr(card, name)
        if hasattr(host, name):
            a, b = getattr(host, name), getattr(card, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert set(card.fit_stats_.phases) >= {"reindex", "host_pack"}
