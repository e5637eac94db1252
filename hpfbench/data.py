"""The one generator of the benchmark's inputs, driven by a configuration
file and ``--seed``, on the device with a ``torch.Generator``.

Triplets (user, item, count): every item once with a uniform user, then
every user once with an item drawn by popularity, then uniform users with
items drawn by popularity, as many draws as make the configuration's
number of unique pairs with room to spare.  Repeated (user, item) pairs are
merged (``"merge": "sum"`` adds play counts, ``"first"`` keeps a rating's
first draw), and the pairs first drawn earliest are kept, exactly ``nnz``
of them, sorted by user and then item.  So every seed gives the same users,
items and unique pairs, every user and item has at least one pair, and the
same seed gives the same arrays.

Factors for a serving cell: ``Theta`` (users, k) and ``Beta`` (items, k) as
Gamma draws (shape and mean from the configuration), ``Beta``'s rows scaled
by the items' popularity.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def zipf_probs(n: int, s: float) -> np.ndarray:
    """Popularity of ranks 1..n proportional to ``rank ** -s``."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(s)
    return w / w.sum()


def draws_needed(n_users: int, n_items: int, nnz: int, s: float) -> int:
    """Draws of (uniform user, item by popularity) whose expected number of
    unique pairs exceeds ``nnz`` by a margin of six of its standard
    deviations and 1%: a function of the configuration only."""
    p = zipf_probs(n_items, s)

    def unique(m):
        return float((n_users * -np.expm1(-m * p / n_users)).sum())

    want = nnz * 1.01 + 6 * math.sqrt(nnz)
    if unique(64.0 * nnz) < want:
        raise ValueError("a configuration of %d unique pairs over %d x %d cannot be drawn"
                         % (nnz, n_users, n_items))
    lo, hi = float(nnz), 64.0 * nnz
    while hi - lo > 1:
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if unique(mid) < want else (lo, mid)
    return int(hi)


def _categorical(probs, n, g, device):
    """``n`` draws of 1..len(probs) by the given weights."""
    cdf = torch.as_tensor(np.cumsum(np.asarray(probs, dtype=np.float64) / np.sum(probs)),
                          device=device)
    u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=len(probs) - 1) + 1


def _counts(spec: dict, n: int, g, device) -> torch.Tensor:
    if spec["kind"] == "poisson_plus_one":
        lam = torch.full((n,), float(spec["lambda"]), dtype=torch.float64, device=device)
        return torch.poisson(lam, generator=g) + 1
    if spec["kind"] == "categorical":
        return _categorical(spec["weights"], n, g, device).to(torch.float64)
    raise ValueError("unknown counts kind %r" % spec["kind"])


def triplets(cfg: dict, seed: int, device="cuda"):
    """``(iu, ii, y)`` on ``device``: int32, int32, float32, sorted by user
    and then item, ``cfg["nnz"]`` unique pairs."""
    device = torch.device(device)
    n_users, n_items, nnz = int(cfg["n_users"]), int(cfg["n_items"]), int(cfg["nnz"])
    s = float(cfg["item_popularity"]["zipf_s"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    m = draws_needed(n_users, n_items, nnz, s)
    cdf = torch.as_tensor(np.cumsum(zipf_probs(n_items, s)), device=device)

    def items_by_popularity(n):
        u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
        return torch.searchsorted(cdf, u, right=True).clamp_(max=n_items - 1)

    users = torch.cat([torch.randint(n_users, (n_items,), generator=g, device=device),
                       torch.arange(n_users, device=device),
                       torch.randint(n_users, (m,), generator=g, device=device)])
    items = torch.cat([torch.arange(n_items, device=device),
                       items_by_popularity(n_users), items_by_popularity(m)])
    counts = _counts(cfg["counts"], users.shape[0], g, device)
    key = users * n_items + items
    del users, items
    sk, order = torch.sort(key, stable=True)
    del key
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    n_unique = int(first.sum())
    if n_unique < nnz:
        raise RuntimeError("drew %d unique pairs, fewer than %d" % (n_unique, nnz))
    if cfg["counts"]["merge"] == "sum":
        gid = torch.cumsum(first, 0) - 1
        merged = torch.zeros(n_unique, dtype=torch.float64, device=device)
        merged.index_add_(0, gid, counts[order])
        del gid
    elif cfg["counts"]["merge"] == "first":
        merged = counts[order[first]]
    else:
        raise ValueError("unknown merge %r" % cfg["counts"]["merge"])
    # the pairs first drawn earliest (a stable sort keeps each pair's first
    # draw first among its repeats)
    keep = torch.sort(order[first]).indices[:nnz]
    keys, y = sk[first][keep], merged[keep]
    del sk, order, first, merged, counts
    srt = torch.sort(keys).indices
    keys, y = keys[srt], y[srt]
    return ((keys // n_items).to(torch.int32), (keys % n_items).to(torch.int32),
            y.to(torch.float32))


def host_triplets(cfg: dict, seed: int, device="cuda"):
    """``triplets`` copied to host numpy arrays."""
    iu, ii, y = triplets(cfg, seed, device)
    return iu.cpu().numpy(), ii.cpu().numpy(), y.cpu().numpy()


def gamma_factors(cfg: dict, seed: int, device="cuda"):
    """``(Theta, Beta)`` on ``device`` in float32: Gamma(shape, mean) draws
    as ``cfg["factors"]`` states, ``Beta``'s rows times ``n_items`` x the
    items' popularity (mean 1 over the items)."""
    device = torch.device(device)
    f = cfg["factors"]
    n_users, n_items, k = int(cfg["n_users"]), int(cfg["n_items"]), int(cfg["k"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def gamma(n, shape, mean):
        conc = torch.full((n, k), float(shape), dtype=torch.float32, device=device)
        return torch._standard_gamma(conc, generator=g) * (float(mean) / float(shape))

    theta = gamma(n_users, f["theta_shape"], f["theta_mean"])
    beta = gamma(n_items, f["beta_shape"], f["beta_mean"])
    pop = torch.as_tensor(zipf_probs(n_items, cfg["item_popularity"]["zipf_s"]) * n_items,
                          dtype=torch.float32, device=device)
    return theta, beta * pop[:, None]
