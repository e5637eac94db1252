"""Quality parity of hpfrec_tpu_torch with a REAL comparison column.

The twin of ``scripts/quality_oracle_parity.py`` for the port: fits the
port's ``HPF`` (on the card by default) AND ``tests/oracle.py``'s
``OracleHPF`` (the independent numpy implementation of the reference math,
``reference hpfrec/cython_loops.pxi:227-259``, on the host) end to end on
the SAME synthetic split from the SAME MT19937 init, then reports the
reference notebook's quality protocol (mean predicted rate on test vs
random pairs, ROC-AUC, corr) plus recall@10 / NDCG@10 side by side, with
the same scales, split, seeds, oracle calls, llk formula and JSON line.

It then holds the port's column to the oracle's (``LIMITS``) and exits
non-zero when one fails.  After 30 float32 iterations the factors of two
float32 runs differ (~1.45x an iteration from ~1e-6), so no limit falls on
the factors; the llk and the metrics agree much closer than re-seeding
moves them (~1e-2 on recall@10).  corr(Count, Predicted) is near 0 on
these iid counts, so it is printed and not held.

Run (card):  python scripts/quality_oracle_parity_torch.py            # 3M-nnz Zipf
             QUALITY_SCALE=ml100k python scripts/quality_oracle_parity_torch.py
Run (CPU):   QUALITY_SCALE=ml100k python scripts/quality_oracle_parity_torch.py --device cpu
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

SCALES = {
    # largest the host oracle comfortably fits end-to-end (~5 s/iter)
    "zipf3m": dict(nU=120_000, nI=25_000, nnz=3_000_000, k=30, iters=30,
                   rank_users=10_000),
    # BASELINE.json configs[1]: the MovieLens-100K shape
    "ml100k": dict(nU=943, nI=1_682, nnz=100_000, k=30, iters=30,
                   rank_users=None),
}

# the port's column against the oracle's: (kind, limit), kind "rel" for
# |port / oracle - 1|, "abs" for |port - oracle|
LIMITS = {
    "train llk (no constant)": ("rel", 1e-4),
    "mean pred rate, test pairs": ("rel", 1e-3),
    "mean pred rate, random pairs": ("rel", 1e-3),
    "ROC-AUC": ("rel", 1e-3),
    # half the ~1e-2 that re-seeding moves recall@10
    "recall@10": ("abs", 5e-3),
    "NDCG@10": ("abs", 5e-3),
}


def synth_zipf(nU, nI, nnz, seed=0):
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, nU, nnz).astype(np.int64)
    ranks = np.arange(1, nI + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    ii = rng.choice(nI, size=nnz, p=p).astype(np.int64)
    y = (rng.poisson(2.0, nnz) + 1).astype(np.float64)
    return iu, ii, y


def run_parity(nU, nI, nnz, k, iters, rank_users, device="cuda", seed=123):
    """Fit the port and the oracle on the script's split; returns a dict
    of ``rows`` ((name, port, oracle) per metric), ``n_eval_users`` and
    ``fit_seconds``."""
    from oracle import OracleHPF

    from hpfrec_tpu_torch import HPF
    from hpfrec_tpu_torch.utils.evaluation import evaluate

    iu, ii, y = synth_zipf(nU, nI, nnz, seed=0)
    rng = np.random.default_rng(7)
    is_train = rng.random(nnz) < 0.8
    train = np.column_stack([iu[is_train], ii[is_train], y[is_train]])
    test = np.column_stack([iu[~is_train], ii[~is_train], y[~is_train]])

    # --- the port's fit (reindex=False: both fits share one id space) ---
    model = HPF(k=k, maxiter=iters, stop_crit="maxiter", check_every=iters,
                random_seed=seed, reindex=False, keep_data=True, verbose=False,
                device=device)
    t0 = time.time()
    model.fit(train)
    t_model = time.time() - t0
    print("# port fit: %.0f s (%d iters)" % (t_model, model.niter + 1), file=sys.stderr)

    # --- oracle fit: reference math, same seed, same data ---
    # nusers/nitems as the port derived them (max id + 1)
    onU, onI = model.nusers, model.nitems
    oracle = OracleHPF(model.a, model.a_prime, model.b_prime,
                       model.c, model.c_prime, model.d_prime, k)
    oracle.init(onU, onI, seed=seed, dtype=np.float32)
    ytr = train[:, 2].astype(np.float32)
    utr = train[:, 0].astype(np.int64)
    itr = train[:, 1].astype(np.int64)
    t0 = time.time()
    for it in range(iters):
        oracle.full_step(ytr, utr, itr)
        if (it + 1) % 10 == 0:
            print("# oracle iter %d/%d (%.0f s)" % (it + 1, iters, time.time() - t0),
                  file=sys.stderr)
    t_oracle = time.time() - t0
    print("# oracle fit: %.0f s" % t_oracle, file=sys.stderr)

    # oracle "model": the fitted parameters behind the same serving path,
    # with the port's seen lists
    shell = HPF(k=k, reindex=False, keep_data=True, verbose=False, random_seed=seed,
                device=device)
    shell.nusers, shell.nitems = onU, onI
    shell.Theta = np.ascontiguousarray(oracle.Theta, dtype=np.float32)
    shell.Beta = np.ascontiguousarray(oracle.Beta, dtype=np.float32)
    shell.seen = model.seen
    shell._st_ix_user = model._st_ix_user
    shell._n_seen_by_user = model._n_seen_by_user
    shell.is_fitted = True

    # train llk (no-constant form, reference pxi:69-79) for both, from
    # the same formula on each fit's parameters
    Th, Be = np.asarray(model.Theta, np.float64), np.asarray(model.Beta, np.float64)
    pred_tr = np.einsum("ij,ij->i", Th[utr], Be[itr])
    llk_model = float((ytr * np.log(pred_tr)).sum() - Th.sum(0).dot(Be.sum(0)))
    llk_oracle = float(oracle.train_llk(ytr, utr, itr))

    ev_m = evaluate(model, test, k=10, exclude_seen=True, rank_users=rank_users)
    ev_o = evaluate(shell, test, k=10, exclude_seen=True, rank_users=rank_users)

    rows = [
        ("train llk (no constant)", llk_model, llk_oracle),
        ("mean pred rate, test pairs", ev_m["mean_pred_test"], ev_o["mean_pred_test"]),
        ("mean pred rate, random pairs", ev_m["mean_pred_random"], ev_o["mean_pred_random"]),
        ("lift", ev_m["lift"], ev_o["lift"]),
        ("ROC-AUC", ev_m["roc_auc"], ev_o["roc_auc"]),
        ("corr(Count, Predicted)", ev_m["corr_count_pred"], ev_o["corr_count_pred"]),
        ("recall@10", float(ev_m["recall_at_10"]), float(ev_o["recall_at_10"])),
        ("NDCG@10", float(ev_m["ndcg_at_10"]), float(ev_o["ndcg_at_10"])),
    ]
    return dict(rows=rows, n_eval_users=ev_m["n_eval_users"],
                fit_seconds={"port": t_model, "oracle": t_oracle})


def failed_limits(rows):
    """The rows whose port column misses its limit against the oracle's:
    {name: (deviation, kind, limit)}."""
    out = {}
    for name, a, b in rows:
        if name not in LIMITS:
            continue
        kind, lim = LIMITS[name]
        dev = abs(a / b - 1.0) if kind == "rel" else abs(a - b)
        if not dev <= lim:
            out[name] = (dev, kind, lim)
    return out


def report(scale, cfg, res, device_name):
    """Print the side-by-side table and the JSON line; returns the failed
    limits."""
    rows = res["rows"]
    print("\n%-30s %16s %16s %12s" % ("metric (scale=%s)" % scale, "port (%s)" % device_name,
                                      "oracle (ref math)", "limit"))
    for name, a, b in rows:
        lim = "%s %g" % LIMITS[name] if name in LIMITS else "printed"
        print("%-30s %16.6g %16.6g %12s" % (name, a, b, lim))
    failed = failed_limits(rows)
    for name, (dev, kind, lim) in failed.items():
        print("FAILED: %s differs from the oracle by %.3e (%s), limit %g"
              % (name, dev, kind, lim))
    print(json.dumps({
        "scale": scale, "config": "nU=%d nI=%d nnz=%d k=%d iters=%d" % (
            cfg["nU"], cfg["nI"], cfg["nnz"], cfg["k"], cfg["iters"]),
        "device": device_name,
        "n_eval_users": res["n_eval_users"],
        "framework": {n: a for n, a, _ in rows},
        "oracle": {n: b for n, _, b in rows},
        "fit_seconds": {"framework": round(res["fit_seconds"]["port"], 1),
                        "oracle": round(res["fit_seconds"]["oracle"], 1)},
        "failed": sorted(failed),
    }))
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    import torch

    scale = os.environ.get("QUALITY_SCALE", "zipf3m")
    cfg = SCALES[scale]
    res = run_parity(**cfg, device=args.device)
    name = (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
            else "cpu")
    return 1 if report(scale, cfg, res, name) else 0


if __name__ == "__main__":
    sys.exit(main())
