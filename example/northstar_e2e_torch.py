"""The BASELINE.json north star on one NVIDIA card, through hpfrec_tpu_torch:
fit a MillionSong-TasteProfile-shape data set (48,373,586 rows, 1,019,318
users x 376,768 items, Zipf items, repeated (user, item) pairs, split 80/20,
k=30) to CONVERGED val-llk through the public ``HPF.fit`` API, with the
held-out 20% as the validation set; the configuration the reference's
EchoNest notebook records at 42:48 total wall (38.3 min of optimization) on
a 24-core Skylake (reference example/hpfrec_echonest.ipynb cell 10).

The twin of ``example/northstar_e2e.py`` for the port: the same data (the
same numpy calls in the same order), arguments, environment knobs and
report. It measures the whole pipeline (triplet ingest, reindex, CSR builds,
ELL packing, transfers, kernel build, optimization, val-llk checks) and
prints the per-phase wall-time attribution from ``fit_stats_``. No pandas:
the triplets go in as an (n, 3) ndarray.

Run (card):  python example/northstar_e2e_torch.py [--evaluate]
Run (CPU, small):  NORTHSTAR_NNZ=20000 python example/northstar_e2e_torch.py --device cpu
Env: NORTHSTAR_K (default 30), NORTHSTAR_MAXITER (150),
     NORTHSTAR_NNZ (48_373_586 total rows before the 80/20 split),
     NORTHSTAR_STOP_CRIT (default val-llk; ``maxiter`` with
     NORTHSTAR_MAXITER=110 runs the reference's 110 iterations).
``--evaluate`` then runs ``utils.evaluation.evaluate`` (k=10, 20,000
ranked users) on the held-out split.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_USERS, N_ITEMS, N_ROWS = 1_019_318, 376_768, 48_373_586


def synth_tasteprofile(nU=N_USERS, nI=N_ITEMS, n_rows=N_ROWS, seed=0):
    """Zipf-item triplets at the notebook's pre-split row count."""
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, nU, n_rows).astype(np.int64)
    ranks = np.arange(1, nI + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    ii = rng.choice(nI, size=n_rows, p=p).astype(np.int64)
    y = (rng.poisson(2.0, n_rows) + 1).astype(np.float64)
    return iu, ii, y


def split_80_20(iu, ii, y):
    """The script's 80/20 split as two (n, 3) int64 arrays (train, val) of
    UserId, ItemId, Count: the counts are whole numbers, and integer ids
    reindex without pandas."""
    is_train = np.random.default_rng(7).random(iu.shape[0]) < 0.8
    return tuple(np.column_stack([iu[m], ii[m], y[m].astype(np.int64)])
                 for m in (is_train, ~is_train))


def recording_hpf():
    """``HPF`` that keeps the llk of every convergence check in ``checks``."""
    from hpfrec_tpu_torch import HPF

    class RecordingHPF(HPF):
        def _evaluate_criterion(self, state, it, *args):
            out = super()._evaluate_criterion(state, it, *args)
            if self.stop_crit != "diff-norm":
                self.checks.append((it, self._last_llk))
            return out

    return RecordingHPF


def run_northstar(n_users=N_USERS, n_items=N_ITEMS, n_rows=N_ROWS, k=30, maxiter=150,
                  stop_crit="val-llk", device="cuda", dtype="float32", seed=0,
                  check_every=10, verbose=True, data=None):
    """Generate the data (``seed``: the generator's; the split and the
    model keep the script's 7 and 123), fit, and return ``(model, checks,
    fit_stats_, wall, val)``: ``checks`` the (iteration, llk) of every
    check, ``wall`` the fit's seconds, ``val`` the held-out (n, 3) array.
    ``data`` (train, val) skips the generation."""
    train, val = data if data is not None else split_80_20(
        *synth_tasteprofile(n_users, n_items, n_rows, seed))
    model = recording_hpf()(k=k, stop_crit=stop_crit, check_every=check_every, stop_thr=1e-3,
                            maxiter=maxiter, random_seed=123, verbose=verbose,
                            use_float=dtype == "float32", device=device)
    model.checks = []
    t0 = time.time()
    model.fit(train, val_set=val if stop_crit == "val-llk" else None)
    return model, model.checks, model.fit_stats_, time.time() - t0, val


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--evaluate", action="store_true",
                    help="evaluate on the held-out split (k=10, 20,000 ranked users)")
    args = ap.parse_args(argv)

    k = int(os.environ.get("NORTHSTAR_K", 30))
    maxiter = int(os.environ.get("NORTHSTAR_MAXITER", 150))
    n_rows = int(os.environ.get("NORTHSTAR_NNZ", N_ROWS))
    stop_crit = os.environ.get("NORTHSTAR_STOP_CRIT", "val-llk")

    print("Generating synthetic TasteProfile (%.1fM rows)..." % (n_rows / 1e6))
    t_gen = time.time()
    train, val = split_80_20(*synth_tasteprofile(n_rows=n_rows))
    print("  %.0fs (train %.1fM, val %.1fM rows)"
          % (time.time() - t_gen, len(train) / 1e6, len(val) / 1e6))

    model, _, st, wall, _ = run_northstar(k=k, maxiter=maxiter, stop_crit=stop_crit,
                                          device=args.device, data=(train, val))
    print("\n=== North-star result ===")
    print("Converged val-llk fit: %d iterations in %.1f s wall "
          "(reference notebook: 42:48 = 2568 s total, 110 iterations)"
          % (st.iterations, wall))
    print("End-to-end throughput: %.3g nonzero-updates/s" % st.nnz_per_second)
    print("Phase breakdown:")
    print(st.phase_report())
    print("device: %s" % st.device)

    if args.evaluate:
        from hpfrec_tpu_torch.utils.evaluation import evaluate

        t0 = time.time()
        stats = evaluate(model, val, k=10, exclude_seen=True, rank_users=20_000)
        print("\nQuality on the held-out split (%.0fs):" % (time.time() - t0))
        for key, v in stats.items():
            print(f"  {key:18s} {v:.4f}" if isinstance(v, float) else f"  {key:18s} {v}")


if __name__ == "__main__":
    main()
