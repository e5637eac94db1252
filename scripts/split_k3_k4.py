"""K3 (table update / derive), K4 (train llk) and K10 (fold-in) of
hpfrec_tpu_torch on one CUDA card, for one tree or for two trees in turn.

Run from the root of a checkout:

    python3 scripts/split_k3_k4.py [--reps N]               # this tree
    python3 scripts/split_k3_k4.py --parent DIR [--reps N]  # DIR, this, this, DIR
    python3 scripts/split_k3_k4.py [--reps N] --trees DIR...  # each in turn

With ``--parent`` the script runs itself once per turn, in a process of its
own, against the ``hpfrec_tpu_torch`` and ``chip_smoke.py`` of DIR (a parent
commit unpacked, e.g. ``git archive <commit> | tar -x -C _cmp/parent``) and
of this tree, in the order DIR, this, this, DIR, and ends with a table of
every figure side by side.  Only the wrappers' public signatures are used
(``side_update``, ``side_derive``, ``bucket_llk_parts``,
``ell_llk_rmse_sums``, ``user_factors_loop``), so the parent's tree times
the same way.

At the MillionSong TasteProfile shape (chip_smoke.py's data and seed, k=50,
float32, a random state from chip_smoke's ``random_state``), each turn
prints:

1. K3 by side (users 1,019,318 rows, items 376,768) with CUDA events: the
   update form with a float32 and a bfloat16 tab, the derive form with
   each, and the update's pad-row form (the last 1/64 of the rows padding);
   each output's bits as a digest;
2. K4 over the user-side ELL layout: ``ell_llk_rmse_sums`` (a launch a
   bucket), ``bucket_llk_parts`` bucket by bucket (width, segments, slots,
   ms) and their sum, a digest of the (ll, se, sp) sums; and the gather
   line: the slots' Beta rows in 32-byte sectors over 3.35 TB/s, and how
   much of Beta the 50 MB L2 holds;
3. K10 (``user_factors_loop``, whose digamma is K3's) on the heaviest
   user's history (the online path's fold-in), with the item tables of the
   random state and a seeded start as ``HPF.predict_factors`` makes it: as
   the online path calls it (10 iterations at most, stop at 1e-3; each
   call reads its iteration count back, so launch latency is in the time)
   and for 100 iterations (stop at 0), a digest of its outputs each;
4. in the turns of a tree whose chip_smoke.py has ``digamma_sweep``, the
   kernels' digamma against scipy's on a log sweep and on the random
   state's shapes.

The card's name and power limit (nvidia-smi) come first.  Needs a card.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L2_BYTES = 50e6  # the H100's L2 (NVIDIA data sheet)
SECTOR = 32
PEAK_BYTES = 3.35e12


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def digest(*tensors):
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def one(tree, reps):
    """One turn against the tree at ``tree``: prints its figures and a last
    ``RESULT <json>`` line of them."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as CS
    from hpfrec_tpu_torch import _cuda
    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M
    from hpfrec_tpu_torch.utils.data import process_data

    if not torch.cuda.is_available():
        print("split_k3_k4: needs a CUDA card", file=sys.stderr)
        return 1
    print("tree %s; card (nvidia-smi name, power.limit): %s" % (tree, card()))
    res = {}
    t0 = time.perf_counter()
    _cuda.load()
    dev = torch.device("cuda")
    coo = CS.powerlaw_coo(**CS.MILLIONSONG, seed=0)
    p = process_data(coo, "train-llk", False, np.float32)
    del coo
    state = CS.random_state(p.nusers, p.nitems, np.float32, dev, 2)
    hp = Hyperparams(k=CS.K)
    k = CS.K
    print("set-up %.1f s: %d users, %d items, %d triplets, k=%d"
          % (time.perf_counter() - t0, p.nusers, p.nitems, p.y.shape[0], k))

    # -- 1. K3 by side and form
    theta_cs = C.side_derive(state.G_shp, state.G_rte)[1]
    beta_cs = C.side_derive(state.L_shp, state.L_rte)[1]
    sides = (("user", state.G_shp, state.G_rte, state.k_rte, beta_cs, hp.a, hp.k_shp,
              hp.add_k_rte),
             ("item", state.L_shp, state.L_rte, state.t_rte, theta_cs, hp.c, hp.t_shp,
              hp.add_t_rte))
    bf = torch.bfloat16
    for side, shp, rte, scaler, cso, prior, scaler_shape, add in sides:
        n = shp.shape[0]
        sums = shp - prior  # phi sums that give back this shape
        n_real = n - n // 64
        forms = {
            "update": lambda: C.side_update(sums, scaler, cso, prior, scaler_shape, add),
            "update bf16": lambda: C.side_update(sums, scaler, cso, prior, scaler_shape, add,
                                                 bf),
            "derive": lambda: C.side_derive(shp, rte),
            "derive bf16": lambda: C.side_derive(shp, rte, bf),
            "update pad": lambda: C.side_update(sums, scaler, cso, prior, scaler_shape, add,
                                                None, n_real),
        }
        for form, fn in forms.items():
            ms = CS.cuda_ms(fn, reps)
            key = "K3 %s %s" % (form, side)
            res[key + " ms"] = ms
            res[key + " digest"] = digest(*fn())
            print("%s: %.4f ms (CUDA events, %d calls); digest %s"
                  % (key, ms, reps, res[key + " digest"]))
    for form in ("update", "update bf16", "derive", "derive bf16", "update pad"):
        res["K3 %s both sides ms" % form] = sum(res["K3 %s %s ms" % (form, side)]
                                                for side in ("user", "item"))
    del theta_cs, beta_cs
    torch.cuda.empty_cache()

    # -- 2. K4 over the user layout, one launch and bucket by bucket
    lay_u = E.to_device(E.build_layouts(p, np.float32)[0], dev)
    Theta, Beta = state.G_shp / state.G_rte, state.L_shp / state.L_rte
    shapes = torch.cat([state.G_shp.reshape(-1), state.L_shp.reshape(-1)]).cpu().numpy()
    l_shp = state.L_shp.cpu().double()
    l_rte = state.L_rte.cpu().double()
    del state
    res["K4 one call ms"] = CS.cuda_ms(lambda: M.ell_llk_rmse_sums(Theta, Beta, lay_u), reps)
    parts = M.ell_llk_rmse_sums(Theta, Beta, lay_u)
    res["K4 partials"] = int(parts.shape[0])
    res["K4 sums digest"] = digest(parts.sum(0))
    print("K4 ell_llk_rmse_sums: %.4f ms (CUDA events, %d calls), %d partials, sums %s, "
          "digest %s" % (res["K4 one call ms"], reps, parts.shape[0],
                         parts.sum(0).cpu().numpy().tolist(), res["K4 sums digest"]))
    print("  %6s %9s %11s %8s %10s" % ("width", "segments", "slots", "padding", "ms"))
    total = 0.0
    for b in lay_u.buckets:
        m, w = b.cols.shape
        bms = CS.cuda_ms(lambda: M.bucket_llk_parts(Theta, Beta, b.rows, b.cols, b.vals,
                                                    b.col_off, False), reps)
        total += bms
        print("  %6d %9d %11d %8.4f %10.4f" % (w, m, m * w, float((b.vals == 0).float().mean()),
                                               bms))
        res["K4 w=%d ms" % w] = bms
    res["K4 sum of buckets ms"] = total
    print("  sum of the buckets %.4f ms" % total)
    slots = int(sum(int((b.vals > 0).sum()) for b in lay_u.buckets))
    deg = np.bincount(p.ix_i, minlength=p.nitems).astype(np.float64)
    hot = np.sort(deg)[::-1]
    row_b = k * 4
    sectors = -(-row_b // SECTOR)  # row starts are 8-byte aligned: 200-byte rows span 7
    in_l2 = int(min(p.nitems, L2_BYTES // row_b))
    res["K4 gather slots"] = slots
    res["K4 gather ms"] = slots * sectors * SECTOR / PEAK_BYTES * 1e3
    res["K4 Beta MB"] = p.nitems * row_b / 1e6
    res["K4 slots on the hottest 50 MB of Beta"] = float(hot[:in_l2].sum() / hot.sum())
    print("K4 gather line: %d slots x %d sectors x %d B = %.4g B, %.4f ms at 3.35 TB/s; Beta "
          "%.1f MB, the L2 holds %.1f%% of it (%d rows), and the hottest %d rows take %.2f%% "
          "of the slots" % (slots, sectors, SECTOR, slots * sectors * SECTOR,
                            res["K4 gather ms"], res["K4 Beta MB"],
                            100 * L2_BYTES / (p.nitems * row_b), in_l2, in_l2,
                            100 * res["K4 slots on the hottest 50 MB of Beta"]))

    # -- 3. K10 on the heaviest user's history
    from hpfrec_tpu_torch.ops import svi as S

    heavy = int(np.argmax(np.bincount(p.ix_u, minlength=p.nusers)))
    pick = p.ix_u == heavy
    items = torch.from_numpy(p.ix_i[pick].astype(np.int64))
    rng = np.random.default_rng(1)
    beta_colsum = (l_shp / l_rte).sum(0).numpy()
    theta0 = rng.gamma(hp.a, 1.0 / hp.b_prime, size=k)
    g_rte0 = rng.gamma(hp.a_prime, hp.b_prime / hp.a_prime, size=1) + beta_colsum
    g_shp0 = g_rte0 * theta0 * rng.uniform(low=0.85, high=1.15, size=k)
    elogb = (torch.special.digamma(l_shp[items]) - torch.log(l_rte[items])).numpy()
    args = [torch.from_numpy(np.ascontiguousarray(a).astype(np.float32)).to(dev)
            for a in (p.y[pick], elogb, beta_colsum, theta0, g_shp0, g_rte0)]
    k_rte0 = float(np.float32(hp.b_prime + theta0.sum()))
    for name, maxiter, thr in (("online", 10, 1e-3), ("100 iterations", 100, 0.0)):
        fn = lambda: S.user_factors_loop(*args, k_rte0, hp, maxiter, thr)  # noqa: E731
        ms = CS.cuda_ms(fn, 10 * reps)
        out = fn()
        key = "K10 %s" % name
        res[key + " ms"] = ms
        res[key + " digest"] = digest(*out[:4])
        print("%s: user %d, %d items, %d iterations: %.4f ms (CUDA events, %d calls); "
              "digest %s" % (key, heavy, int(pick.sum()), out[4], ms, 10 * reps,
                             res[key + " digest"]))

    # -- 4. the digamma (this tree's kernels only)
    if hasattr(CS, "digamma_sweep"):
        sweep = CS.digamma_sweep((("log sweep of [1e-4, 1e7]", np.logspace(-4, 7, 1_000_001)),
                                  ("random state's shapes", shapes)), dev, "digamma")
        for name, row in sweep.items():
            for form, r in row.items():
                res["digamma %s %s max ulp" % (name, form)] = r["max_ulp"]
                res["digamma %s %s mean ulp" % (name, form)] = r["mean_ulp"]
    print("RESULT " + json.dumps(res))
    return 0


def turns(order, reps):
    """Each (label, tree) of ``order`` in its own process; then every figure
    side by side."""
    results = []
    print("card (nvidia-smi name, power.limit):", card())
    for label, tree in order:
        print("==== %s (%s)" % (label, tree), flush=True)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                            "--reps", str(reps)], capture_output=True, text=True)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stdout.write(r.stderr[-4000:])
            raise SystemExit("split_k3_k4: the %s turn failed (exit %d)"
                             % (label, r.returncode))
        line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    print("==== side by side: " + ", ".join(label for label, _ in order))
    keys = list(dict.fromkeys(k for res in results for k in res))
    for key in keys:
        vals = [res.get(key) for res in results]
        cells = [("%.4f" % v) if isinstance(v, float) else str(v) for v in vals]
        print("%-44s %s" % (key, "  ".join("%16s" % c for c in cells)))
    print("card (nvidia-smi name, power.limit):", card())
    return 0


def main():
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 20
    if "--one" in sys.argv:
        return one(sys.argv[sys.argv.index("--one") + 1], reps)
    if "--parent" in sys.argv:
        parent = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
        return turns([("parent", parent), ("change", HERE), ("change", HERE),
                      ("parent", parent)], reps)
    if "--trees" in sys.argv:
        trees = [os.path.abspath(t) for t in sys.argv[sys.argv.index("--trees") + 1:]
                 if not t.startswith("--")]
        return turns([(os.path.basename(t), t) for t in trees], reps)
    return one(HERE, reps)


if __name__ == "__main__":
    sys.exit(main())
