"""End-to-end example on synthetic implicit-count data, through
hpfrec_tpu_torch on one NVIDIA card.

The twin of ``example/quickstart.py`` for the port: the same data, split,
fit, evaluation, serving and fold-in calls and the same report, without
pandas (the triplets are (n, 3) ndarrays; the histories (n, 2) ones).
Reproduces the shape of the reference's README sample usage (reference
README.md:70-150) and its EchoNest notebook workflow (fit -> monitor llk
-> evaluate -> serve).

Run (card):  python example/quickstart_torch.py
Run (CPU):   python example/quickstart_torch.py --device cpu
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_synthetic(nusers=2000, nitems=1500, nnz=120_000, seed=1):
    """Zipf-ish implicit counts with planted low-rank structure, as an
    (n, 3) int64 array of UserId, ItemId, Count: the JAX example's frame
    after ``drop_duplicates(["UserId", "ItemId"])``, row for row."""
    rng = np.random.default_rng(seed)
    k_true = 8
    theta = rng.gamma(0.5, 1.0, size=(nusers, k_true))
    beta = rng.gamma(0.5, 1.0, size=(nitems, k_true))
    u = rng.integers(nusers, size=nnz)
    i = rng.integers(nitems, size=nnz)
    rate = np.einsum("ij,ij->i", theta[u], beta[i])
    y = rng.poisson(rate) + 1
    # the first occurrence of each (user, item) pair, in the rows' order
    first = np.sort(np.unique(u.astype(np.int64) * nitems + i, return_index=True)[1])
    return np.column_stack([u, i, y]).astype(np.int64)[first]


def sample_split(arr, frac=0.15, random_state=7):
    """``df.sample(frac, random_state)`` and ``df.drop(sample.index)`` on
    an array: the rows pandas samples (``RandomState(random_state).choice``
    of ``round(frac * n)`` rows without replacement), in its order, and the
    others in theirs.  Returns (train, val)."""
    n = arr.shape[0]
    take = np.random.RandomState(random_state).choice(n, size=round(frac * n), replace=False)
    keep = np.ones(n, dtype=bool)
    keep[take] = False
    return arr[keep], arr[take]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from hpfrec_tpu_torch import HPF

    df = make_synthetic()
    train, val = sample_split(df)

    model = HPF(k=30, stop_crit="val-llk", check_every=5, stop_thr=1e-4,
                maxiter=200, random_seed=123, device=args.device)
    model.fit(train, val_set=val)
    print("fit throughput: %.3g nonzero-updates/s end-to-end "
          "(%d iterations over %d nonzeros in %.1fs)"
          % (model.fit_stats_.nnz_per_second, model.fit_stats_.iterations,
             model.fit_stats_.nnz, model.fit_stats_.wall_seconds))

    # --- evaluation ---------------------------------------------------
    print("\nheld-out llk:", model.eval_llk(val.copy()))

    from hpfrec_tpu_torch.utils import evaluation as ev

    report = ev.evaluate(model, val, k=10, exclude_seen=True, random_seed=7)
    print("ranking eval:", {kk: round(v, 4) if isinstance(v, float) else v
                            for kk, v in report.items()})

    # --- serving ------------------------------------------------------
    some_user = train[0, 0]
    print("top-10 for user", some_user, ":", model.topN(user=some_user, n=10))
    users = train[np.sort(np.unique(train[:, 0], return_index=True)[1]), 0][:64]
    recs = model.topN_batch(users, n=10)
    print("batch recommendations:", recs.shape)

    # --- fold-in a brand new user ------------------------------------
    hist = train[train[:, 0] == some_user][:, 1:]
    theta_new = model.predict_factors(hist.copy())
    print("fold-in factors:", np.round(theta_new[:6], 4))

    model.add_user(user_id=10**9, counts_df=hist.copy())
    print("after add_user, topN:", model.topN(user=10**9, n=5))
    return model


if __name__ == "__main__":
    main()
