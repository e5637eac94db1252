"""The ingest every fit runs on its device (``ops/ingest.py``, K15 in
``ops/ell.py``), run here on CPU tensors through its plain versions,
against the host builders, element for element: the filter, checks,
warnings and errors of ``process_data``; both sides' CSR against
``build_csr``; the full-batch layouts, and a rank's slice of them,
against ``build_ell`` then ``to_device``; the SVI sides' degrees against
``epoch_side``'s; the blocked-COO stream against its construction from
``process_data``; the table-sharded plan against one fed from
``build_csr``.  ``build_ell``, now ``plan_ell`` and a fill, against the
JAX package's.  And whole fits of every mode and engine: their phases,
one sort of their sides, and the seen-items CSR against ``build_csr``."""

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


def _host_layouts(host, dtype, max_width=8192, pad_shards=1):
    """Both sides' layouts of ``process_data``'s triplets on the host:
    ``build_ell`` over ``build_csr``."""
    return [E.build_ell(*D.build_csr(r, o, host.y, n, m), n, max_width, dtype=dtype,
                        pad_shards=pad_shards)
            for r, o, n, m in ((host.ix_u, host.ix_i, host.nusers, host.nitems),
                               (host.ix_i, host.ix_u, host.nitems, host.nusers))]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_ingest_equals_the_host_builders(case, dtype):
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
    max_width = c.get("max_width", 8192)
    refs = [E.to_device(lay, "cpu") for lay in _host_layouts(host, dtype, max_width)]
    if max_width == 16:
        assert refs[1].split_seg_pos.shape[0] > 0  # the case splits item rows
    for side, ref in zip((user, item), refs):
        got = E.device_ell(E.pack_ell(side.indptr, side.cols, side.vals, max_width))
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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_shards,rank", [(2, 0), (2, 1), (3, 0), (3, 1), (3, 2)])
def test_a_rank_packs_its_slice_of_every_bucket(n_shards, rank, dtype):
    """``pack_ell(..., shard=(rank, n_shards))`` then ``device_ell``: the
    rank's slice of the layout padded for ``n_shards`` ranks, equal to
    ``to_device(build_ell(..., pad_shards=n_shards), shard=...)``, on
    cases with split rows, merged buckets and empty rows."""
    for case in ("split_and_merged_buckets", "empty_rows"):
        max_width = CASES[case].get("max_width", 8192)
        host, card, _ = _host_and_card(_input(case), "train-llk", False, dtype)
        refs = _host_layouts(host, dtype, max_width, n_shards)
        if case == "split_and_merged_buckets":
            assert refs[1].split_seg_pos.shape[0] > 0
        segs = lambda lays: sum(b.rows.shape[0] for lay in lays for b in lay.buckets)  # noqa
        assert segs(refs) > segs(_host_layouts(host, dtype, max_width))  # padding segments
        for side, ref in zip(G.sort_sides(card), refs):
            pack = E.pack_ell(side.indptr, side.cols, side.vals, max_width,
                              shard=(rank, n_shards))
            _equal_device_ell(E.to_device(ref, "cpu", (rank, n_shards)), E.device_ell(pack))


def _coo_stream_from_host(pdata, block_size, shard):
    """The blocked-COO stream as the engine built it from ``process_data``'s
    user-sorted triplets: a counting sort of the share's positions by item
    on the host (``build_csr``), uploaded."""
    from hpfrec_tpu_torch.ops.cavi import BlockedCOO, CooStream

    bounds = np.zeros(pdata.nusers + 1, dtype=np.int64)
    np.cumsum(np.bincount(pdata.ix_u, minlength=pdata.nusers), out=bounds[1:])
    u0, u1 = D.share(bounds, shard[1], shard[0])
    lo, hi = int(bounds[u0]), int(bounds[u1])
    y, ix_u, ix_i = pdata.y[lo:hi], pdata.ix_u[lo:hi], pdata.ix_i[lo:hi]
    nnz = hi - lo
    data = BlockedCOO(*map(torch.from_numpy, D.block_coo(y, ix_u, ix_i, block_size)[:3]))
    indptr_i, order, _ = D.build_csr(ix_i, np.arange(nnz, dtype=np.int32), y, pdata.nitems, nnz)
    pos = np.empty(nnz, dtype=np.int32)
    pos[order] = np.arange(nnz, dtype=np.int32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    return CooStream(data=data, nnz=nnz, user_bounds=up(np.clip(bounds - lo, 0, nnz)),
                     item_keys=up(np.repeat(np.arange(pdata.nitems), np.diff(indptr_i))),
                     item_users=up(ix_u[order]), item_pos=up(pos),
                     item_runs=up(np.column_stack([indptr_i[:-1], indptr_i[1:]])))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_coo_stream_from_the_user_side_equals_the_host_construction(shard, dtype):
    from hpfrec_tpu_torch.ops.cavi import coo_stream

    host, card, _ = _host_and_card(_input("empty_rows"), "train-llk", False, dtype)
    user, _ = G.sort_sides(card, items=False)
    got = coo_stream(user, host.nitems, 512, shard)
    ref = _coo_stream_from_host(host, 512, shard)
    assert got.nnz == ref.nnz and 0 < got.nnz <= host.nnz
    for a, b in zip(got.data, ref.data):
        _equal_tensor(a, b)
    for name in ("user_bounds", "item_keys", "item_users", "item_pos", "item_runs"):
        _equal_tensor(getattr(got, name), getattr(ref, name))


def _equal_nested(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, z in zip(a, b):
            _equal_nested(x, z)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_table_sharded_plan_from_the_sides_equals_one_from_build_csr(n_ranks):
    """The table-sharded engine's host packer fed from the sides copied
    back (``Csr.to_host``) plans what it plans from ``build_csr``."""
    from hpfrec_tpu_torch.parallel.table_sharded import prepare_table_sharded

    host, card, _ = _host_and_card(_input("empty_rows"), "train-llk", False, np.float32)
    nU, nI = host.nusers, host.nitems
    user, item = (side.to_host() for side in G.sort_sides(card))
    kw = dict(dtype=np.float32, window_bytes=4096)
    got = prepare_table_sharded(user.indptr, user.cols.numpy(), user.vals.numpy(), item.indptr,
                                item.cols.numpy(), item.vals.numpy(), nU, nI, 4, n_ranks, 4,
                                **kw)
    ref = prepare_table_sharded(*D.build_csr(host.ix_u, host.ix_i, host.y, nU, nI),
                                *D.build_csr(host.ix_i, host.ix_u, host.y, nI, nU), nU, nI, 4,
                                n_ranks, 4, **kw)
    _equal_nested(tuple(got), tuple(ref))


FIT_MODES = {
    "full_batch": dict(stop_crit="train-llk", check_every=5, maxiter=10),
    "full_batch_no_keep_data": dict(stop_crit="maxiter", maxiter=6, check_every=3,
                                    keep_data=False),
    "svi_alternating": dict(stop_crit="train-llk", check_every=2, maxiter=6,
                            users_per_batch=40, items_per_batch=25),
    "svi_users": dict(stop_crit="maxiter", maxiter=4, check_every=2, users_per_batch=50),
    "svi_items": dict(stop_crit="maxiter", maxiter=4, check_every=2, items_per_batch=30),
}


@pytest.mark.parametrize("engine", ["ell", "coo"])
@pytest.mark.parametrize("mode", sorted(FIT_MODES))
def test_a_cpu_fit_sorts_its_sides_once(monkeypatch, mode, engine):
    """A CPU fit of each mode and engine ingests through ``upload_triplets``
    and one ``sort_sides`` (the metadata phase sorts nothing), in the
    phases the benchmark reads; its seen-items CSR is ``build_csr``'s."""
    from hpfrec_tpu_torch import HPF
    from hpfrec_tpu_torch.models import hpf as H

    sorts = []
    orig = H.sort_sides
    monkeypatch.setattr(H, "sort_sides", lambda *a, **kw: sorts.append(a) or orig(*a, **kw))
    X = _input("unsorted_duplicates")
    m = HPF(k=5, random_seed=7, verbose=False, device="cpu", engine=engine,
            **FIT_MODES[mode]).fit(X)
    assert len(sorts) == 1
    assert set(m.fit_stats_.phases) >= {"reindex", "host_pack", "transfer", "metadata"}
    assert m.fit_stats_.nnz == X.nnz
    if mode == "full_batch_no_keep_data":
        assert not hasattr(m, "seen")
        return
    host = D.process_data(X, "train-llk", False)
    indptr, ind, _ = D.build_csr(host.ix_u, host.ix_i, host.y, host.nusers, host.nitems)
    assert m.seen.dtype == ind.dtype and np.array_equal(m.seen, ind)
    assert np.array_equal(m._st_ix_user, indptr[:-1])
    assert np.array_equal(m._n_seen_by_user, np.diff(indptr))
