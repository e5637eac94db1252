"""The generator gives each configuration's users, items and unique pairs
(at a reduced scale here), every user and item at least once, and the same
arrays for the same seed."""

import numpy as np
import pytest
import torch

from hpfbench import data, spec
from hpfbench.tests.small import config

CONFIGS = ["tasteprofile-k50", "movielens20m-k30"]


@pytest.mark.parametrize("name", CONFIGS)
def test_shape_and_unique_pairs(name):
    cfg = config(name)
    iu, ii, y = data.host_triplets(cfg, 2**31 + 11, "cpu")
    assert iu.dtype == np.int32 and ii.dtype == np.int32 and y.dtype == np.float32
    assert iu.shape[0] == cfg["nnz"]
    key = iu.astype(np.int64) * cfg["n_items"] + ii
    assert np.unique(key).shape[0] == cfg["nnz"]
    assert np.all(np.diff(key) > 0)  # sorted by user, then item
    assert np.bincount(iu, minlength=cfg["n_users"]).min() >= 1
    assert np.bincount(ii, minlength=cfg["n_items"]).min() >= 1
    assert iu.max() == cfg["n_users"] - 1 and ii.max() == cfg["n_items"] - 1
    assert y.min() >= 1 and np.all(y == np.round(y))


def test_ratings_stay_in_range():
    iu, ii, y = data.host_triplets(config("movielens20m-k30"), 5, "cpu")
    assert y.min() >= 1 and y.max() <= 10
    assert set(np.unique(y)) <= set(range(1, 11))


def test_play_counts_are_merged_by_adding():
    iu, ii, y = data.host_triplets(config("tasteprofile-k50"), 5, "cpu")
    assert y.max() > 12  # some popular pairs were drawn more than once


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_arrays(name):
    cfg = config(name)
    a = data.host_triplets(cfg, 123456789012, "cpu")
    b = data.host_triplets(cfg, 123456789012, "cpu")
    c = data.host_triplets(cfg, 123456789013, "cpu")
    assert all(np.array_equal(x, z) for x, z in zip(a, b))
    assert not all(np.array_equal(x, z) for x, z in zip(a, c))


def test_published_sizes_are_in_the_files():
    tp, ml = spec.config("tasteprofile-k50"), spec.config("movielens20m-k30")
    assert (tp["n_users"], tp["n_items"], tp["nnz"], tp["k"]) == (1019318, 376768, 38698869, 50)
    assert (ml["n_users"], ml["n_items"], ml["nnz"], ml["k"]) == (138493, 26744, 20000263, 30)
    assert sum(ml["counts"]["weights"]) == ml["nnz"]


def test_draws_cover_the_unique_pairs():
    for name in CONFIGS:
        cfg = spec.config(name)
        m = data.draws_needed(cfg["n_users"], cfg["n_items"], cfg["nnz"],
                              cfg["item_popularity"]["zipf_s"])
        assert cfg["nnz"] < m < 2 * cfg["nnz"]


def test_factors_same_seed_same_tables():
    cfg = config("tasteprofile-k50")
    t1, b1 = data.gamma_factors(cfg, 77, "cpu")
    t2, b2 = data.gamma_factors(cfg, 77, "cpu")
    assert torch.equal(t1, t2) and torch.equal(b1, b2)
    assert t1.shape == (cfg["n_users"], cfg["k"]) and b1.shape == (cfg["n_items"], cfg["k"])
    assert bool((t1 >= 0).all()) and bool((b1 >= 0).all())
