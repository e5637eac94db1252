"""Offline ranking / held-out evaluation utilities.

The reference ships no evaluation module; its quality numbers come from ad
hoc notebook code (``example/hpfrec_echonest.ipynb`` cells 13-15: mean
predicted rate on test pairs vs random pairs, ROC-AUC of test pairs vs
random negatives, corr(Count, Predicted)), and BASELINE.md's north-star
asks for recall@k / NDCG parity.  This module packages that exact protocol
as library functions, with the scoring on the model's device: pair scores
through K11 (``ops.metrics.predict_pairs``) and the ranking through K6
(``ops.topk.topn_batch``, chunks of users scored against the whole
catalog).

A copy of ``hpfrec_tpu/utils/evaluation.py`` for :class:`hpfrec_tpu_torch.HPF`;
only the two scoring calls differ.  All functions take a fitted model and
raw-ID test triplets (an (n, 3) ndarray, a scipy ``coo_array``, or a
DataFrame with UserId/ItemId/Count when pandas is installed); unknown
users/items are dropped, mirroring the notebook's filtering of the test
split to known ids.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import data as data_utils


def _model_pairs(model, test_df):
    """Map raw-ID triplets through the model's trained index space; drops
    pairs with unknown user or item. Returns (y, row_u, row_i)."""
    u, i, y, _, _, _ = data_utils.coerce_triplets(test_df)
    if model.reindex:
        cu = data_utils.map_to_training_ids(u, model.user_mapping_)
        ci = data_utils.map_to_training_ids(i, model.item_mapping_)
    else:
        cu = np.asarray(u).astype(np.int64, copy=False)
        ci = np.asarray(i).astype(np.int64, copy=False)
        bad_u = (cu < 0) | (cu >= model.nusers)
        bad_i = (ci < 0) | (ci >= model.nitems)
        cu = np.where(bad_u, -1, cu)
        ci = np.where(bad_i, -1, ci)
    keep = (cu != -1) & (ci != -1)
    return (np.asarray(y)[keep].astype(np.float64),
            cu[keep].astype(np.int32), ci[keep].astype(np.int32))


def _score_pairs(model, row_u, row_i, chunk: int = 4_000_000):
    """Batched Theta[u].Beta[i] on the model's device (K11), chunked to
    bound transfers; Theta is uploaded once per call, Beta comes from the
    model's serving cache."""
    import torch

    from ..ops.metrics import predict_pairs

    dev = model._torch_device()
    Theta = torch.from_numpy(np.ascontiguousarray(model.Theta)).to(dev, copy=True)
    Beta = model._beta_device()
    out = np.empty(len(row_u), dtype=np.float64)
    for st in range(0, len(row_u), chunk):
        sl = slice(st, st + chunk)
        iu, ii = (torch.from_numpy(np.ascontiguousarray(a[sl], dtype=np.int32)).to(dev)
                  for a in (row_u, row_i))
        out[sl] = predict_pairs(Theta, Beta, iu, ii).cpu().numpy()
    return out


def _random_pairs(model, n: int, rng: np.random.Generator):
    return (rng.integers(0, model.nusers, n).astype(np.int32),
            rng.integers(0, model.nitems, n).astype(np.int32))


def predicted_rate_stats(model, test_df, random_seed: int = 1) -> dict:
    """Mean predicted Poisson rate on held-out observed pairs vs an equal
    number of uniformly random (user, item) pairs (notebook cell 13: a
    fitted model should rate real interactions ~3x above random).

    Returns ``{"mean_test": float, "mean_random": float, "lift": float,
    "n_pairs": int}``."""
    assert model.is_fitted
    y, ru, ri = _model_pairs(model, test_df)
    if len(y) == 0:
        raise ValueError("No test pairs with known users and items.")
    rng = np.random.default_rng(random_seed)
    qu, qi = _random_pairs(model, len(y), rng)
    mean_test = float(_score_pairs(model, ru, ri).mean())
    mean_random = float(_score_pairs(model, qu, qi).mean())
    return {"mean_test": mean_test, "mean_random": mean_random,
            "lift": mean_test / mean_random if mean_random > 0 else np.inf,
            "n_pairs": int(len(y))}


def roc_auc(model, test_df, random_seed: int = 1) -> float:
    """ROC-AUC of held-out observed pairs vs uniformly-random negative
    pairs (notebook cell 14 protocol; its recorded value is 0.7351 on
    TasteProfile).  Computed exactly as the Mann-Whitney U statistic over
    the two score samples."""
    assert model.is_fitted
    y, ru, ri = _model_pairs(model, test_df)
    if len(y) == 0:
        raise ValueError("No test pairs with known users and items.")
    rng = np.random.default_rng(random_seed)
    qu, qi = _random_pairs(model, len(y), rng)
    pos = _score_pairs(model, ru, ri)
    neg = _score_pairs(model, qu, qi)
    return _auc_from_scores(pos, neg)


def count_pred_correlation(model, test_df) -> float:
    """Pearson corr(Count, Predicted) on held-out pairs (notebook cell 15;
    recorded 0.1177 on TasteProfile — HPF optimizes rate ordering, not
    count regression, so this is intentionally modest)."""
    assert model.is_fitted
    y, ru, ri = _model_pairs(model, test_df)
    if len(y) < 2:
        raise ValueError("Need at least 2 known test pairs.")
    pred = _score_pairs(model, ru, ri)
    return float(np.corrcoef(y, pred)[0, 1])


def _per_user_test_lists(ru: np.ndarray, ri: np.ndarray, y: np.ndarray,
                         nusers: int):
    """Group test items (and counts) by user row: CSR over the test split."""
    indptr, indices, counts = data_utils.build_csr(ru, ri, y.astype(np.float32),
                                                   nusers, int(ri.max()) + 1)
    return indptr, indices, counts


def ranking_metrics(model, test_df, k: int = 10, exclude_seen: bool = True,
                    users: Optional[np.ndarray] = None,
                    user_chunk: int = 1024) -> dict:
    """Recall@k and NDCG@k over the users present in ``test_df``.

    For each test user, the full catalog is ranked (minus training items
    when ``exclude_seen``, requiring the model fitted with
    ``keep_data=True``) and compared against that user's held-out items.

      recall@k = |top-k ∩ test items| / min(k, |test items|)
      NDCG@k   = DCG@k over binary relevance / ideal DCG@k

    Scoring runs on the model's device in ``user_chunk``-user batches
    (K6).  Returns ``{"recall": float, "ndcg": float,
    "n_users": int, "k": int}`` (means over evaluated users)."""
    assert model.is_fitted
    y, ru, ri = _model_pairs(model, test_df)
    if len(y) == 0:
        raise ValueError("No test pairs with known users and items.")
    from ..ops.topk import topn_batch

    indptr, indices, _ = _per_user_test_lists(ru, ri, y, model.nusers)
    test_users = np.flatnonzero(np.diff(indptr) > 0)
    if users is not None:
        users = np.asarray(users)
        test_users = np.intersect1d(test_users, users)
    if len(test_users) == 0:
        raise ValueError("No users to evaluate.")

    seen_args: tuple
    if exclude_seen:
        assert hasattr(model, "seen") and model.seen is not None, (
            "exclude_seen requires the model fitted with keep_data=True")
        seen_args = (model._st_ix_user, model.seen, model._n_seen_by_user)
    else:
        seen_args = (None, None, None)

    k = min(k, int(model.nitems))  # topn_batch can rank at most the catalog
    disc = 1.0 / np.log2(np.arange(2, k + 2))  # DCG discounts for ranks 1..k
    ideal = np.cumsum(disc)
    recall_sum = 0.0
    ndcg_sum = 0.0
    # stage the (nI, k) table on the device once, through the model's
    # serving cache
    Beta_dev = model._beta_device()
    for st in range(0, len(test_users), user_chunk):
        batch = test_users[st:st + user_chunk]
        top = topn_batch(model.Theta, Beta_dev, batch, k,
                         seen_indptr=seen_args[0], seen_indices=seen_args[1],
                         n_seen=seen_args[2])
        for j, u in enumerate(batch):
            truth = indices[indptr[u]:indptr[u + 1]]
            hits = np.isin(top[j], truth)
            recall_sum += hits.sum() / min(k, len(truth))
            ndcg_sum += (disc * hits).sum() / ideal[min(k, len(truth)) - 1]
    n = len(test_users)
    return {"recall": recall_sum / n, "ndcg": ndcg_sum / n,
            "n_users": int(n), "k": int(k)}


def _auc_from_scores(pos: np.ndarray, neg: np.ndarray) -> float:
    """Exact Mann-Whitney AUC with midrank tie handling."""
    scores = np.concatenate([pos, neg])
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    sorted_scores = scores[order]
    tie_starts = np.flatnonzero(np.diff(sorted_scores) != 0) + 1
    bounds = np.concatenate([[0], tie_starts, [len(scores)]])
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b - a > 1:
            ranks[order[a:b]] = 0.5 * (a + 1 + b)
    n_pos, n_neg = len(pos), len(neg)
    u_stat = ranks[:n_pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u_stat / (n_pos * n_neg))


def evaluate(model, test_df, k: int = 10, exclude_seen: bool = True,
             random_seed: int = 1, rank_users: Optional[int] = None) -> dict:
    """One-call evaluation bundle: the notebook's three statistics plus
    recall@k/NDCG@k.  Scores the test pairs and the negative sample once
    and derives all pairwise statistics from them.  ``rank_users`` caps
    the ranking pass to a deterministic sample of that many test users
    (full-catalog ranking of all 1M test users at the MillionSong shape
    would dominate the evaluation).  Returns a
    flat dict."""
    assert model.is_fitted
    y, ru, ri = _model_pairs(model, test_df)
    if len(y) == 0:
        raise ValueError("No test pairs with known users and items.")
    rng = np.random.default_rng(random_seed)
    qu, qi = _random_pairs(model, len(y), rng)
    pos = _score_pairs(model, ru, ri)
    neg = _score_pairs(model, qu, qi)

    out = {}
    out["mean_pred_test"] = float(pos.mean())
    out["mean_pred_random"] = float(neg.mean())
    out["lift"] = (out["mean_pred_test"] / out["mean_pred_random"]
                   if out["mean_pred_random"] > 0 else np.inf)
    out["roc_auc"] = _auc_from_scores(pos, neg)
    out["corr_count_pred"] = (float(np.corrcoef(y, pos)[0, 1])
                              if len(y) >= 2 else np.nan)
    users = None
    if rank_users is not None:
        cand = np.unique(ru)
        if len(cand) > rank_users:
            users = rng.choice(cand, size=rank_users, replace=False)
    rk = ranking_metrics(model, test_df, k=k, exclude_seen=exclude_seen,
                         users=users)
    out[f"recall_at_{k}"] = rk["recall"]
    out[f"ndcg_at_{k}"] = rk["ndcg"]
    out["n_eval_users"] = rk["n_users"]
    return out
