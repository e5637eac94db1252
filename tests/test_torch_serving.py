"""Batch serving of hpfrec_tpu_torch against hpfrec_tpu on the same inputs:
``topN_batch`` and ``ops.topk.topn_batch`` (K6's plain version, the host
pair list and backfill), ``predict`` above 65,536 pairs (K11), the
serving cache of ``Beta``, and ``utils.evaluation``; and, in numpy, the
selection K6's fused path makes (each item range's n best (key, ~index)
words, then their merge) against ``lax.top_k``, its item ranges and its
chunk sizes.

Top-n indices must be equal.  Where the two packages rank float32 tables,
both get the JAX fit's arrays: the scores then differ only in the order in
which each product adds (a few ulps), which does not reorder these
rankings; float64 tables round the same float64 sums to float32 scores.
"""

import numpy as np
import pandas as pd
import pytest
import torch


@pytest.fixture(autouse=True)
def _restore_x64():
    import jax

    prev = jax.config.read("jax_enable_x64")
    yield
    jax.config.update("jax_enable_x64", prev)


def _df(nU=80, nI=60, nnz=4000, seed=8):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"UserId": rng.integers(nU, size=nnz) + 1000,
                         "ItemId": rng.integers(nI, size=nnz) + 50,
                         "Count": rng.poisson(2, nnz) + 1.0}
                        ).drop_duplicates(["UserId", "ItemId"])


def _adopt(mt, mj):
    """Give the port model the JAX model's fitted arrays (as arrays it
    allocated itself)."""
    for name in ("Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte",
                 "k_rte", "t_rte"):
        mt._own(name, np.array(getattr(mj, name)))
    mt._dev_state_cache = mt._beta_dev_cache = None


def _pair(use_float, reindex=True, **kw):
    import jax

    from hpfrec_tpu import HPF as HJ
    from hpfrec_tpu.parallel import make_mesh
    from hpfrec_tpu_torch import HPF as HT

    jax.config.update("jax_enable_x64", not use_float)
    df = _df()
    if not reindex:
        df = df.assign(UserId=df.UserId - 1000, ItemId=df.ItemId - 50)
    opts = dict(k=8, maxiter=20, check_every=10, stop_crit="maxiter", random_seed=1,
                verbose=False, use_float=use_float, reindex=reindex, **kw)
    mj = HJ(mesh=make_mesh(jax.devices()[:1]), **opts).fit(df.copy())
    mt = HT(device="cpu", **opts).fit(df.copy())
    _adopt(mt, mj)
    return mj, mt, df


@pytest.mark.parametrize("use_float", [True, False])
@pytest.mark.parametrize("exclude_seen", [True, False])
@pytest.mark.parametrize("n", [7, 60, 100])
def test_topn_batch_equals_jax(use_float, exclude_seen, n):
    """Equal item ids, with and without exclusion; n = 60 is the whole
    catalog (every user then backfills with seen items), n = 100 more."""
    mj, mt, df = _pair(use_float)
    users = np.unique(df["UserId"].to_numpy())[:25]
    got = mt.topN_batch(users, n=n, exclude_seen=exclude_seen)
    ref = mj.topN_batch(users, n=n, exclude_seen=exclude_seen)
    assert got.shape == ref.shape == (25, min(n, 60))
    np.testing.assert_array_equal(got, ref)


def test_topn_batch_matches_single():
    _, mt, df = _pair(True)
    users = np.unique(df["UserId"].to_numpy())[:12]
    batch = mt.topN_batch(users, n=7, exclude_seen=True)
    for j, u in enumerate(users):
        assert set(batch[j].tolist()) == set(mt.topN(user=u, n=7, exclude_seen=True).tolist())
    batch = mt.topN_batch(users[:5], n=9, exclude_seen=False)
    for j, u in enumerate(users[:5]):
        np.testing.assert_array_equal(np.sort(batch[j]),
                                      np.sort(mt.topN(user=u, n=9, exclude_seen=False)))


def test_topn_batch_unknown_user_and_no_data():
    from hpfrec_tpu_torch import HPF

    _, mt, _ = _pair(True)
    with pytest.raises(ValueError):
        mt.topN_batch(np.array([999999]), n=5)
    m = HPF(k=3, maxiter=3, check_every=3, verbose=False, keep_data=False, device="cpu")
    m.fit(_df(nU=20, nI=15, nnz=200))
    with pytest.raises(Exception, match="keep_data"):
        m.topN_batch(m.user_mapping_[:2], n=3)
    assert m.topN_batch(m.user_mapping_[:2], n=3, exclude_seen=False).shape == (2, 3)


def test_beta_device_cache():
    """Beta is staged once and reused; the model's own table is made
    read-only; reassigning Beta invalidates, and a caller's table is
    uploaded on every call (never cached, never made read-only)."""
    _, mt, df = _pair(True)
    users = np.unique(df["UserId"].to_numpy())[:8]
    a = mt.topN_batch(users, n=5)
    staged = mt._beta_dev_cache[1]
    b = mt.topN_batch(users, n=5)
    assert mt._beta_dev_cache[1] is staged
    np.testing.assert_array_equal(a, b)
    assert not mt.Beta.flags.writeable
    with pytest.raises(ValueError):
        mt.Beta[0, 0] = 1.0
    mine = mt.Beta.copy()
    mt.Beta = mine
    c = mt.topN_batch(users, n=5)
    assert mt._beta_dev_cache is None and mine.flags.writeable
    np.testing.assert_array_equal(a, c)
    mine[:, :] = mine[::-1]  # an in-place edit of a caller's table is seen
    assert not np.array_equal(mt.topN_batch(users, n=5), a)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_topn_backfill_small_catalog_equals_jax(dtype):
    """Users with fewer than n unseen items (test_topk.py:66-89)."""
    import jax

    from hpfrec_tpu.ops.topk import topn_batch as tj
    from hpfrec_tpu_torch.ops.topk import topn_batch as tt

    jax.config.update("jax_enable_x64", dtype == np.float64)
    rng = np.random.default_rng(0)
    Theta = rng.random((3, 2)).astype(dtype)
    Beta = rng.random((6, 2)).astype(dtype)
    seen = (np.array([0, 5, 5], dtype=np.int64), np.array([0, 1, 2, 3, 4], dtype=np.int32),
            np.array([5, 0, 0], dtype=np.int64))
    got = tt(Theta, torch.from_numpy(Beta), np.array([0, 1]), 4, *seen)
    np.testing.assert_array_equal(got, tj(Theta, Beta, np.array([0, 1]), 4, *seen))
    assert got[0, 0] == 5 and len(set(got[0].tolist())) == 4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_topn_backfill_large_batch_equals_jax(dtype, monkeypatch):
    """One nearly-all-seen user sprinkled through a 2048-user batch
    (test_topk.py:92-124); the port scores it in chunks of 64 here."""
    import jax

    from hpfrec_tpu.ops.topk import topn_batch as tj
    from hpfrec_tpu_torch.ops import topk as T

    jax.config.update("jax_enable_x64", dtype == np.float64)
    nU, nI, k, b, n = 50, 40, 4, 2048, 8
    rng = np.random.default_rng(1)
    Theta = rng.random((nU, k)).astype(dtype)
    Beta = rng.random((nI, k)).astype(dtype)
    seen0 = np.arange(nI - 2, dtype=np.int32)
    indptr = np.zeros(nU + 1, dtype=np.int64)
    indptr[1:] = len(seen0)
    n_seen = np.zeros(nU, dtype=np.int64)
    n_seen[0] = len(seen0)
    users = rng.integers(0, nU, b)
    users[::97] = 0
    monkeypatch.setattr(T, "_CHUNK_BYTES", 64 * 4 * nI)
    got = T.topn_batch(Theta, torch.from_numpy(Beta), users, n, indptr, seen0, n_seen)
    np.testing.assert_array_equal(got, tj(Theta, Beta, users, n, indptr, seen0, n_seen))
    s = Theta[0] @ Beta.T
    fill = seen0[np.argsort(-s[seen0], kind="stable")][:n - 2]
    for j in np.flatnonzero(users == 0):
        assert set(got[j, :2].tolist()) == {nI - 2, nI - 1}
        np.testing.assert_array_equal(got[j, 2:], fill)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_topn_ties_in_lax_top_k_order(dtype):
    """Integer-valued tables give many equal scores: the lower item index
    ranks first among equal scores, as lax.top_k orders them; a fully
    masked row gives indices 0..n-1 before the backfill."""
    import jax

    from hpfrec_tpu.ops.topk import topn_batch as tj
    from hpfrec_tpu_torch.ops import topk as T

    jax.config.update("jax_enable_x64", dtype == np.float64)
    rng = np.random.default_rng(2)
    Theta = rng.integers(0, 3, (30, 6)).astype(dtype)
    Beta = rng.integers(0, 3, (200, 6)).astype(dtype)
    users = np.arange(30)
    np.testing.assert_array_equal(T.topn_batch(Theta, torch.from_numpy(Beta), users, 25),
                                  tj(Theta, Beta, users, 25))
    seen = np.concatenate([rng.choice(200, 30, replace=False) for _ in users]).astype(np.int32)
    args = (np.arange(30) * 30, seen, np.full(30, 30))
    np.testing.assert_array_equal(T.topn_batch(Theta, torch.from_numpy(Beta), users, 25, *args),
                                  tj(Theta, Beta, users, 25, *args))
    vals, idx = T.topn_rows(torch.from_numpy(Theta[:2]), torch.from_numpy(Beta),
                            torch.zeros(200, dtype=torch.int32),
                            torch.arange(200, dtype=torch.int32), 7)
    assert torch.equal(idx[0], torch.arange(7, dtype=torch.int32))
    assert bool(torch.isinf(vals[0]).all())


def test_topn_mask_drops_pairs_outside_the_scores():
    """A (row, item) pair outside the chunk's (b, nI) scores masks nothing,
    as the JAX scatter's mode='drop' drops its padding pairs."""
    from hpfrec_tpu_torch.ops import topk as T

    rng = np.random.default_rng(6)
    th, be = torch.from_numpy(rng.random((3, 4))), torch.from_numpy(rng.random((20, 4)))
    rows = torch.tensor([-1, 3, 0, 1, 1, 2], dtype=torch.int32)
    items = torch.tensor([0, 0, -1, 20, 7, 2**31 - 1], dtype=torch.int32)
    got = T.topn_rows(th, be, rows, items, 20)
    ref = T.topn_rows(th, be, rows[4:5], items[4:5], 20)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert bool(torch.isinf(got[0][1, -1])) and int(got[1][1, -1]) == 7


@pytest.mark.parametrize("n,chunk", [(10, 16_384), (2000, 1024), (20_000, 1024),
                                     (376_768, 256)])
def test_chunk_rows_counts_candidate_scratch(n, chunk):
    """Users per K6 chunk at the MillionSong catalog: on the fused path
    (n <= 128) the rows' seen-item bitmask words and at most 4,096
    candidate words each, so the whole 16,384-user batch is one chunk; on
    the three-kernel path the (rows, nI) float32 scores and, for n above
    the shared-memory sort, the select's global candidate rows; either
    within the chunk budget."""
    from hpfrec_tpu_torch.ops import topk as T

    nI = 376_768
    rows = T._chunk_rows(16_384, nI, n)
    P = T._next_pow2(n)
    assert rows == chunk
    if n <= T._FUSED_MAX_N:
        row_bytes = 4 * -(-nI // 32) + 8 * T._SMEM_CAND
    else:
        row_bytes = 4 * nI + (8 * P if P > T._SMEM_CAND else 0)
    assert rows * row_bytes <= T._CHUNK_BYTES


def _words(scores):
    """K6's (key, ~index) words of float32 scores: the key maps a float to
    uint32 in its order (-inf lowest), so the words' descending order is
    lax.top_k's (score descending, then index ascending)."""
    u = scores.astype(np.float32).view(np.uint32).astype(np.uint64)
    key = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    idx = np.arange(scores.shape[1], dtype=np.uint64)
    return (key << np.uint64(32)) | (~idx & np.uint64(0xFFFFFFFF))


def _range_top_n(scores, n, edges):
    """The fused K6 path's selection in numpy: each item range's n best
    words (0 words where a range holds fewer than n items), then the n
    best of their union, decoded to (values, indices)."""
    w = _words(scores)
    cand = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        part = np.sort(w[:, lo:hi], axis=1)[:, ::-1][:, :n]
        cand.append(np.pad(part, ((0, 0), (0, n - part.shape[1]))))
    top = np.sort(np.concatenate(cand, axis=1), axis=1)[:, ::-1][:, :n]
    key = (top >> np.uint64(32)).astype(np.uint32)
    u = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key).astype(np.uint32)
    idx = (np.uint64(0xFFFFFFFF) - (top & np.uint64(0xFFFFFFFF))).astype(np.int32)
    return u.view(np.float32), idx


@pytest.mark.parametrize("kind", ["random", "tied", "masked"])
@pytest.mark.parametrize("n,edges", [(5, "uneven"), (64, "uneven"), (300, "uneven"),
                                     (10, "kernel"), (128, "kernel")])
def test_range_top_n_merge_equals_lax_top_k(kind, n, edges):
    """Per-range top n followed by a merge of (key, ~index) words gives
    lax.top_k's indices and values: the words are distinct and totally
    ordered, so the global n best lie in the union of each range's n best,
    ties and -inf included.  Ranges of uneven width (one of a single item),
    n below, at and above a range's width (up to n = nI), and the fused
    kernel's own partition (``_item_ranges``)."""
    import jax

    from hpfrec_tpu_torch.ops import topk as T

    b, nI = 12, 300
    rng = np.random.default_rng(n)
    if kind == "tied":
        scores = rng.integers(0, 4, (b, nI)).astype(np.float32)
    else:
        scores = rng.random((b, nI)).astype(np.float32)
    if kind == "masked":
        scores[rng.random((b, nI)) < 0.3] = -np.inf
        scores[0] = -np.inf
        scores[1, 4:] = -np.inf  # fewer finite scores than most n
    if edges == "uneven":
        edges = [0, 7, 64, 65, 200, nI]
    else:
        range_w, R = T._item_ranges(b, nI, n, 132)
        edges = [min(r * range_w, nI) for r in range(R + 1)]
    vals, idx = jax.lax.top_k(scores, n)
    got_v, got_i = _range_top_n(scores, n, edges)
    np.testing.assert_array_equal(got_i, np.asarray(idx))
    np.testing.assert_array_equal(got_v, np.asarray(vals))


def _level_select(scores, n, cap):
    """K6's large-n select (``csrc/topn.cu`` ``topn_select_kernel``) in
    numpy, row by row: histogram passes over the keys' top 12 bits, then
    the next 12 and the last 8 of the keys that share the bits resolved so
    far, until the keys at or above the n-th key's bin number at most
    ``cap``; those are collected and sorted, or, once all 32 bits are
    resolved, the keys above the n-th and the lowest-index keys equal to
    it are.  Returns ((values, indices) decoded as ``_range_top_n`` does,
    the number of histogram passes each row took, whether it took the
    ordered pass)."""
    words = _words(scores)
    tops, passes, ordered = [], [], []
    for w in words:
        key = w >> np.uint64(32)
        prefix, mask, remaining, above = 0, 0, n, 0
        for level, (shift, bits) in enumerate(((20, 12), (8, 12), (0, 8))):
            nb = 1 << bits
            sel = (key & np.uint64(mask)) == np.uint64(prefix)
            hist = np.bincount(((key[sel] >> np.uint64(shift)) & np.uint64(nb - 1))
                               .astype(np.int64), minlength=nb)
            from_top = np.cumsum(hist[::-1])
            t = nb - 1 - int(np.searchsorted(from_top, remaining))
            above_t = int(from_top[nb - 1 - t] - hist[t])
            prefix |= t << shift
            mask |= (nb - 1) << shift
            above += above_t
            remaining -= above_t
            if shift == 0 or above + int(hist[t]) <= cap:
                break
        exact = shift == 0
        if exact:
            eq = w[key == np.uint64(prefix)]
            cand = np.concatenate([w[key > np.uint64(prefix)], eq[np.argsort(~eq)][:remaining]])
            assert cand.shape[0] == n
        else:
            cand = w[key >= np.uint64(prefix)]
            assert cand.shape[0] == above + int(hist[t]) <= cap
        tops.append(np.sort(cand)[::-1][:n])
        passes.append(level + 1)
        ordered.append(exact)
    top = np.stack(tops)
    key = (top >> np.uint64(32)).astype(np.uint32)
    u = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key).astype(np.uint32)
    idx = (np.uint64(0xFFFFFFFF) - (top & np.uint64(0xFFFFFFFF))).astype(np.int32)
    return (u.view(np.float32), idx), passes, ordered


@pytest.mark.parametrize("n,cap", [(129, 8192), (2000, 8192), (2000, 2048), (3000, 4096),
                                   (4097, 8192), (12_000, 16_384)])
def test_level_select_equals_lax_top_k(n, cap):
    """The large-n select's candidate arithmetic gives lax.top_k's indices
    and values on rows of every kind: uniform (one histogram pass), within
    1e-3 of 1 (one 12-bit bin: two passes), within 1e-7 of 1 and small
    integers (ties; the ordered pass where the tied bin overflows the
    buffer), normal, -inf but for 100 items and -inf throughout; at buffer
    sizes that send rows down each path (the kernel's buffer holds at
    least the next power of two of n)."""
    import jax

    rng = np.random.default_rng(n)
    nI = 12_000
    scores = np.stack([rng.random(nI), 1 + 1e-3 * rng.random(nI), 1 + 1e-7 * rng.random(nI),
                       rng.integers(1, 10, nI).astype(np.float64), rng.standard_normal(nI),
                       np.full(nI, -np.inf), np.full(nI, -np.inf)]).astype(np.float32)
    scores[5, rng.choice(nI, 100, replace=False)] = rng.random(100)
    (vals, idx), passes, ordered = _level_select(scores, n, cap)
    ref_v, ref_i = jax.lax.top_k(scores, n)
    np.testing.assert_array_equal(idx, np.asarray(ref_i))
    np.testing.assert_array_equal(vals, np.asarray(ref_v))
    assert ordered[2] == ordered[6] == (nI > cap)
    if n <= cap - 1000:
        assert passes[0] == 1
        assert passes[1] == (2 if nI > cap else 1) and not ordered[1]


@pytest.mark.parametrize("b,nI,n,sms,R", [(1024, 376_768, 10, 132, 16),
                                          (16_384, 376_768, 10, 132, 1),
                                          (1024, 376_768, 128, 132, 16),
                                          (1024, 376_768, 128, 400, 32),
                                          (3, 100, 7, 132, 1), (70, 3001, 1, 132, 24),
                                          (1, 130, 1, 132, 2)])
def test_item_ranges_cover_the_catalog(b, nI, n, sms, R):
    """The fused K6 path's item ranges: whole tiles, R of them covering the
    catalog with no empty range, and a row's R * n candidates within the
    merge's shared-memory sort; at the MillionSong shape a 1,024-user chunk
    gets 16 ranges (256 blocks: one wave of two an SM of 132)."""
    from hpfrec_tpu_torch.ops import topk as T

    range_w, got = T._item_ranges(b, nI, n, sms)
    assert got == R
    assert range_w % T._FUSED_BN == 0 and (R - 1) * range_w < nI <= R * range_w
    assert R * n <= T._SMEM_CAND
    assert R == 1 or -(-b // T._FUSED_BM) * R <= T._FUSED_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("use_float", [True, False])
def test_predict_device_route_equals_jax(use_float):
    """70,000 pairs go through predict_pairs (K11's plain version on the
    CPU), as hpfrec_tpu sends 65,536 or more to the device."""
    mj, mt, df = _pair(use_float, reindex=False)
    rng = np.random.default_rng(3)
    u, i = rng.integers(0, 80, 70_000), rng.integers(0, 60, 70_000)
    got, ref = mt.predict(u, i), mj.predict(u, i)
    assert got.dtype == ref.dtype == (np.float32 if use_float else np.float64)
    np.testing.assert_allclose(got, ref, rtol=2e-6 if use_float else 1e-12)
    np.testing.assert_allclose(mt.predict(u[:100], i[:100]), got[:100],
                               rtol=2e-6 if use_float else 1e-12)


@pytest.mark.parametrize("use_float", [True, False])
def test_pair_reductions_equal_jax(use_float):
    import jax
    import jax.numpy as jnp

    from hpfrec_tpu.ops import metrics as MJ
    from hpfrec_tpu_torch.ops import metrics as MT

    jax.config.update("jax_enable_x64", not use_float)
    dt = np.float32 if use_float else np.float64
    rng = np.random.default_rng(4)
    th, be = rng.random((50, 9)).astype(dt), rng.random((30, 9)).astype(dt)
    iu, ii = (rng.integers(0, n, 777).astype(np.int32) for n in (50, 30))
    tt, bt, it, jt = (torch.from_numpy(a) for a in (th, be, iu, ii))
    rtol = 2e-6 if use_float else 1e-13
    np.testing.assert_allclose(MT.predict_pairs(tt, bt, it, jt).numpy(),
                               np.asarray(MJ.predict_pairs(th, be, iu, ii)), rtol=rtol)
    np.testing.assert_allclose(MT.sum_pairs_prediction(tt, bt, it, jt),
                               float(MJ.sum_pairs_prediction(th, be, iu, ii)), rtol=rtol)
    np.testing.assert_allclose(MT.rowsum_dot_rows(tt, bt, it, jt),
                               float(MJ.rowsum_dot_rows(jnp.asarray(th), jnp.asarray(be),
                                                        jnp.asarray(iu), jnp.asarray(ii))),
                               rtol=1e-6)


# ---- utils.evaluation (tests/test_evaluation.py) -----------------------

def _manual_model(Theta, Beta):
    from hpfrec_tpu_torch import HPF

    m = HPF(k=Theta.shape[1], reindex=False, verbose=False, device="cpu")
    m.Theta = np.asarray(Theta, dtype=np.float32)
    m.Beta = np.asarray(Beta, dtype=np.float32)
    m.nusers, m.nitems = Theta.shape[0], Beta.shape[0]
    m.is_fitted = True
    return m


def test_ranking_metrics_exact():
    from hpfrec_tpu_torch.utils import evaluation as ev

    m = _manual_model(np.array([[1.0], [1.0]]), np.array([[4.0], [3.0], [2.0], [1.0]]))
    test = np.array([[0, 0, 1.0], [0, 3, 1.0], [1, 1, 1.0]])
    out = ev.ranking_metrics(m, test, k=2, exclude_seen=False)
    ndcg0 = (1 / np.log2(2)) / (1 / np.log2(2) + 1 / np.log2(3))
    ndcg1 = (1 / np.log2(3)) / (1 / np.log2(2))
    assert out["n_users"] == 2 and out["k"] == 2
    np.testing.assert_allclose(out["recall"], 0.75, rtol=1e-12)
    np.testing.assert_allclose(out["ndcg"], (ndcg0 + ndcg1) / 2, rtol=1e-6)
    assert ev.ranking_metrics(m, test, k=10, exclude_seen=False)["k"] == 4


def test_roc_auc_ties_and_unknown_ids():
    from scipy.sparse import coo_array

    from hpfrec_tpu_torch.utils import evaluation as ev

    m = _manual_model(np.ones((4, 1)), np.ones((5, 1)))
    test = np.array([[0, 0, 1.0], [1, 1, 1.0], [2, 2, 1.0]])
    np.testing.assert_allclose(ev.roc_auc(m, test, random_seed=0), 0.5, atol=1e-12)
    coo = coo_array((np.ones(3), (np.arange(3), np.arange(3))), shape=(4, 5))
    np.testing.assert_allclose(ev.roc_auc(m, coo, random_seed=0), 0.5, atol=1e-12)
    m = _manual_model(np.ones((3, 2)), np.ones((4, 2)))
    y, ru, ri = ev._model_pairs(m, np.array([[0, 0, 1.0], [99, 1, 1.0], [1, 99, 1.0]]))
    assert len(y) == 1 and ru[0] == 0 and ri[0] == 0
    with pytest.raises(ValueError):
        ev.ranking_metrics(m, np.array([[99, 0, 1.0]]), k=2, exclude_seen=False)


@pytest.mark.parametrize("use_float", [True, False])
def test_evaluate_equals_jax(use_float):
    """Every statistic of ``evaluate`` (with and without ``rank_users``)
    equals the JAX package's on the same factors: ranking metrics exactly,
    the pairwise ones to the rounding of the pair scores."""
    from hpfrec_tpu.utils import evaluation as EJ
    from hpfrec_tpu_torch.utils import evaluation as ET

    mj, mt, df = _pair(use_float)
    test = _df(seed=9)
    for kw in (dict(), dict(rank_users=10)):
        got = ET.evaluate(mt, test, k=5, **kw)
        ref = EJ.evaluate(mj, test, k=5, **kw)
        assert got.keys() == ref.keys()
        for key in ("recall_at_5", "ndcg_at_5", "n_eval_users", "roc_auc"):
            assert got[key] == ref[key], key
        for key in ("mean_pred_test", "mean_pred_random", "lift", "corr_count_pred"):
            np.testing.assert_allclose(got[key], ref[key], rtol=2e-6 if use_float else 1e-12)
    assert ET.predicted_rate_stats(mt, test) == pytest.approx(EJ.predicted_rate_stats(mj, test),
                                                              rel=2e-6)
    np.testing.assert_allclose(ET.count_pred_correlation(mt, test),
                               EJ.count_pred_correlation(mj, test), rtol=2e-6)


def test_evaluation_without_pandas(monkeypatch):
    """ndarray and coo_array test sets run with no pandas (the card's
    machine has none)."""
    from scipy.sparse import coo_array

    from hpfrec_tpu_torch.utils import data as DT
    from hpfrec_tpu_torch.utils import evaluation as ev

    _, mt, df = _pair(True, reindex=False)
    X = df.to_numpy()
    with_pd = ev.evaluate(mt, X, k=5)
    monkeypatch.setattr(DT, "_pandas", lambda: None)
    assert ev.evaluate(mt, X, k=5) == with_pd
    coo = coo_array((X[:, 2], (X[:, 0].astype(int), X[:, 1].astype(int))), shape=(80, 60))
    assert ev.ranking_metrics(mt, coo, k=5)["n_users"] == with_pd["n_eval_users"]
    u = np.asarray(X[:5, 0], dtype=np.int64)
    assert mt.topN_batch(u, n=4).shape == (5, 4)
