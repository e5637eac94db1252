"""MillionSong/TasteProfile-scale end-to-end run on one NVIDIA card, through
hpfrec_tpu_torch.

The twin of ``example/millionsong_scale.py`` for the port: the same shape
(38.7M nonzeros, 1,019,318 users x 376,768 items, k=50; the reference's
EchoNest notebook workload, reference example/hpfrec_echonest.ipynb, on
synthetic Zipf-distributed counts), the same 80/20 split, fit (train-llk
every 10 for 30 iterations), batch serving and evaluation, and the same
report.  No pandas: the triplets and the test split are (n, 3) ndarrays.
The reference records 110 iterations in 38.3 minutes on a 24-core Skylake.

Run (card):  python example/millionsong_scale_torch.py
Run (CPU):   python example/millionsong_scale_torch.py --device cpu  (slow)
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth_tasteprofile(nU=1_019_318, nI=376_768, nnz=38_700_000, seed=0):
    """User-sorted triplets with Zipf item popularity (the head item gets
    ~3M plays, like the real catalog's skew)."""
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, nU, nnz).astype(np.int64)
    ranks = np.arange(1, nI + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    ii = rng.choice(nI, size=nnz, p=p).astype(np.int64)
    y = (rng.poisson(2.0, nnz) + 1).astype(np.float64)
    return np.stack([iu, ii, y], axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from hpfrec_tpu_torch import HPF
    from hpfrec_tpu_torch.utils.evaluation import evaluate

    print("Generating synthetic TasteProfile-size data (38.7M nonzeros)...")
    arr = synth_tasteprofile()

    # 80/20 train/test split, like the notebook's protocol (cells 5-7)
    rng = np.random.default_rng(7)
    is_train = rng.random(arr.shape[0]) < 0.8
    # as int64 (whole numbers all): integer ids reindex without pandas
    train, test = arr[is_train].astype(np.int64), arr[~is_train].astype(np.int64)

    model = HPF(k=50, maxiter=30, stop_crit="train-llk", check_every=10,
                random_seed=123, verbose=True, device=args.device)
    t0 = time.time()
    model.fit(train)
    print(f"\nTotal fit wall time: {time.time() - t0:.0f}s "
          f"(niter={model.niter + 1}, train_llk={model.train_llk:.3e})")
    print(f"End-to-end throughput: {model.fit_stats_.nnz_per_second:.3g} "
          f"nonzero-updates/s (device + host + kernel build)")

    # batch serving over the full 377K-item catalog
    users = np.arange(1024)
    t0 = time.time()
    recs = model.topN_batch(users, n=10, exclude_seen=True)
    dt = time.time() - t0
    print(f"topN_batch: {recs.shape[0]} users ranked over {model.nitems} "
          f"items in {dt*1e3:.0f} ms ({dt/len(users)*1e3:.2f} ms/user; the "
          f"reference's single-user topN records 45.8 ms)")

    # Quality protocol of the reference notebook (cells 13-15: mean
    # predicted rate on test vs random pairs, ROC-AUC against random
    # negatives, corr(Count, Predicted)), plus recall@10/NDCG@10 over a
    # 20K-user sample.  The reference's recorded values on the REAL
    # TasteProfile are AUC 0.7351, corr 0.1177, mean rate 0.0857 vs
    # 0.0282; this synthetic stand-in checks the model learns the same
    # kind of structure (AUC >> 0.5, test lift >> 1), not those numbers.
    t0 = time.time()
    stats = evaluate(model, test, k=10, exclude_seen=True, rank_users=20_000)
    print(f"\nQuality (synthetic TasteProfile, {time.time()-t0:.0f}s; "
          "reference notebook on real data: AUC 0.7351, corr 0.1177, "
          "mean rate 0.0857 vs 0.0282):")
    for key, val in stats.items():
        print(f"  {key:18s} {val:.4f}" if isinstance(val, float)
              else f"  {key:18s} {val}")


if __name__ == "__main__":
    main()
