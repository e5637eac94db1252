"""K2 (segment sums to table order) and K11's predict_pairs of hpfrec_tpu_torch
on one CUDA card, for one tree or for two trees in turn.

Run from the root of a checkout:

    python3 scripts/split_k2_k11.py [--reps N] [--no-f64]               # this tree
    python3 scripts/split_k2_k11.py --parent DIR [--reps N] [--no-f64]  # DIR, this, this, DIR
    python3 scripts/split_k2_k11.py [--reps N] --trees DIR...           # each in turn

With ``--parent`` the script runs itself once per turn, in a process of its
own, against the ``hpfrec_tpu_torch`` and ``chip_smoke.py`` of DIR (a parent
commit unpacked, e.g. ``git archive <commit> | tar -x -C _cmp/parent``) and
of this tree, in the order DIR, this, this, DIR, and ends with a table of
every figure side by side.  Only public signatures are used
(``segment_table_sums``, ``all_bucket_sums``, ``predict_pairs``,
``sum_pairs_prediction``, ``HPF``), so a parent tree times the same way.

Each turn builds chip_smoke.py's MillionSong TasteProfile data (its seed;
1% held out as its SVI phases hold it out) and prints:

1. the full-batch fit (k=50, float32, 10 iterations, train-llk every 5):
   its s/iteration and a digest of its factors' bits; the same fit with
   bfloat16 exp tables; and, unless ``--no-f64``, in float64
   (``use_float=False``);
2. K2 on that fit's segment sums (K1 from its fitted exp tables), both
   sides, CUDA events and a digest of the output bits: float32 sums
   (state-dtype tables), float32 sums of bfloat16 tables, those written as
   float64 (the bfloat16 fit's form under a float64 state), and the
   float32 sums widened to float64 (the float64 form on the same layout);
   each side alone; the float32 form on the same layouts with their split
   chunks taken away (the plain permuted copy); ``index_add_`` of the
   segments into a zeroed table beside it;
3. K11's predict_pairs on the fitted tables at 100,000 pairs (``predict``),
   the held-out set's pairs (``predicted_rate_stats`` / ``roc_auc``) and
   4,194,304 pairs, float32 and float64, CUDA events and a digest; the
   float64 partials of ``sum_pairs_prediction`` (their sum); the values of
   ``theta_diff_norm`` and ``rowsum_dot_rows`` (K11's other kernels) on
   those tables; and the host-clock wall of ``HPF.predict`` of 100,000
   pairs (median of 20).

The card's name and power limit (nvidia-smi) come first.  Needs a card.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS_LARGE = 1 << 22
PAIRS_PREDICT = 100_000


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def digest(*arrays):
    import torch

    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def host_ms(fn, calls):
    """Median host-clock ms of ``calls`` calls of ``fn`` after a warm-up,
    each ended by a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def fit(CS, HPF, coo, res, label, **kw):
    model = HPF(k=CS.K, stop_crit="train-llk", check_every=5, maxiter=10, random_seed=1,
                verbose=False, device="cuda", **kw).fit(coo)
    st = model.fit_stats_
    res["fit %s s/iteration" % label] = st.phases["iterations"] / (model.niter + 1)
    res["fit %s digest" % label] = digest(model.Theta, model.Beta)
    print("fit %s: %.4f s/iteration (iterations phase), wall %.3f s, digest %s"
          % (label, res["fit %s s/iteration" % label], st.wall_seconds,
             res["fit %s digest" % label]))
    return model


def one(tree, reps, f64):
    """One turn against the tree at ``tree``: prints its figures and a last
    ``RESULT <json>`` line of them."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as CS
    from hpfrec_tpu_torch import HPF, _cuda
    from hpfrec_tpu_torch.models.state import state_from_numpy
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M

    if not torch.cuda.is_available():
        print("split_k2_k11: needs a CUDA card", file=sys.stderr)
        return 1
    print("tree %s; card (nvidia-smi name, power.limit): %s" % (tree, card()))
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    t0 = time.perf_counter()
    _cuda.load()
    dev = torch.device("cuda")
    coo = CS.powerlaw_coo(**CS.MILLIONSONG, seed=0)
    _, val = CS.holdout(coo, 0.01, seed=5)
    print("set-up %.1f s (build, data): %d x %d, %d nonzeros, %d held out"
          % (time.perf_counter() - t0, *coo.shape, coo.nnz, val.nnz))

    # -- 1. the fits
    model = fit(CS, HPF, coo, res, "float32")
    fit(CS, HPF, coo, res, "bf16 tables", gather_dtype="bfloat16")
    if f64:
        fit(CS, HPF, coo, res, "float64", use_float=False)
    torch.cuda.empty_cache()

    # -- 2. K2 on the fit's segment sums
    lay_u, lay_i, _, _ = CS.layouts_for(coo, np.float32, dev)
    st = state_from_numpy([model.Gamma_shp, model.Gamma_rte, model.Lambda_shp,
                           model.Lambda_rte, model.k_rte, model.t_rte], dev)
    t_tab = C.side_derive(st.G_shp, st.G_rte)[0]
    b_tab = C.side_derive(st.L_shp, st.L_rte)[0]
    sides = (("user", lay_u, t_tab, b_tab), ("item", lay_i, b_tab, t_tab))
    segs = {"float32": [E.all_bucket_sums(ts, to, lay) for _, lay, ts, to in sides],
            "bf16 tables": [E.all_bucket_sums(ts.bfloat16(), to.bfloat16(), lay)
                            for _, lay, ts, to in sides]}
    segs["float64"] = [s.double() for s in segs["float32"]]
    lays = [lay for _, lay, _, _ in sides]
    for lay, (name, *_) in zip(lays, sides):
        n_chunks = lay.split_seg_pos.shape[0]
        per_row = (lay.split_indptr[1:] - lay.split_indptr[:-1]).cpu().numpy()
        print("%s side: %d rows, %d segments, %d split rows, %d chunks (the most a row %d)"
              % (name, lay.n_rows, lay.n_segs, int((per_row > 0).sum()), n_chunks,
                 int(per_row.max())))
    forms = (("float32", "float32", None), ("bf16 tables", "bf16 tables", None),
             ("bf16 tables -> float64", "bf16 tables", torch.float64),
             ("float64", "float64", None))
    for label, key, out_dtype in forms:
        def k2(key=key, out_dtype=out_dtype):
            return [E.segment_table_sums(s, lay, out_dtype) for s, lay in zip(segs[key], lays)]
        ms = CS.cuda_ms(k2, reps)
        res["K2 %s ms" % label] = ms
        res["K2 %s digest" % label] = digest(*k2())
        print("K2 %s, both sides: %.4f ms (CUDA events, %d calls), digest %s"
              % (label, ms, reps, res["K2 %s digest" % label]))
    for j, (name, *_) in enumerate(sides):
        s, lay = segs["float32"][j], lays[j]
        res["K2 float32 %s side ms" % name] = CS.cuda_ms(lambda: E.segment_table_sums(s, lay),
                                                         reps)
        print("K2 float32, %s side: %.4f ms" % (name, res["K2 float32 %s side ms" % name]))
    copy_lays = [dataclasses.replace(lay, split_indptr=torch.zeros_like(lay.split_indptr))
                 for lay in lays]
    res["K2 float32, no split chunks ms"] = CS.cuda_ms(
        lambda: [E.segment_table_sums(s, lay) for s, lay in zip(segs["float32"], copy_lays)], reps)
    rows = [torch.cat([b.rows.long() for b in lay.buckets]) for lay in lays]
    res["index_add_ ms"] = CS.cuda_ms(
        lambda: [torch.zeros(lay.n_rows, CS.K, device=dev).index_add_(0, r, s)
                 for s, lay, r in zip(segs["float32"], lays, rows)], reps)
    k2_bytes = sum(CS.nbytes(s, lay.inv_perm, lay.split_indptr, lay.split_seg_pos)
                   + lay.n_rows * CS.K * 4 for s, lay in zip(segs["float32"], lays))
    res["K2 float32 bytes"] = k2_bytes
    print("K2 float32 on the layouts without split chunks (the permuted copy): %.4f ms; "
          "index_add_ of the segments: %.4f ms; bytes (inputs once, outputs once) %.4g"
          % (res["K2 float32, no split chunks ms"], res["index_add_ ms"], k2_bytes))
    del segs, copy_lays, rows, st, t_tab, b_tab, lay_u, lay_i, lays, sides
    torch.cuda.empty_cache()

    # -- 3. K11 predict_pairs
    rng = np.random.default_rng(11)
    pu, pi = rng.integers(0, model.nusers, PAIRS_PREDICT), rng.integers(0, model.nitems,
                                                                      PAIRS_PREDICT)
    big = (rng.integers(0, model.nusers, PAIRS_LARGE), rng.integers(0, model.nitems,
                                                                    PAIRS_LARGE))
    sets = (("100,000", (pu, pi)), ("held-out %d" % val.nnz, (val.row, val.col)),
            ("4M", big))
    for dt in (torch.float32, torch.float64):
        Theta = torch.from_numpy(np.ascontiguousarray(model.Theta)).to(dev, dt)
        Beta = torch.from_numpy(np.ascontiguousarray(model.Beta)).to(dev, dt)
        dname = str(dt).split(".")[1]
        for label, (u, i) in sets:
            iu, ii = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (u, i))
            f = lambda: M.predict_pairs(Theta, Beta, iu, ii)  # noqa: E731
            key = "K11 %s %s" % (label.split()[0], dname)
            res[key + " ms"] = CS.cuda_ms(f, reps)
            res[key + " digest"] = digest(f())
            res[key + " sum"] = M.sum_pairs_prediction(Theta, Beta, iu, ii)
            res[key + " plain ms"] = CS.cuda_ms(lambda: M._pairs_plain(Theta, Beta, iu, ii), reps)
            print("K11 predict_pairs, %s pairs, %s: %.4f ms (CUDA events, %d calls; plain %.4f), "
                  "digest %s, sum_pairs_prediction %.17g"
                  % (label, dname, res[key + " ms"], reps, res[key + " plain ms"],
                     res[key + " digest"], res[key + " sum"]))
        # K11's other two kernels, unchanged here: their results, to the bit
        iu, ii = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (val.row, val.col))
        noise = torch.from_numpy(np.random.default_rng(3).random(tuple(Theta.shape))).to(dev, dt)
        res["theta_diff_norm %s value" % dname] = M.theta_diff_norm(Theta * (1 + 1e-3 * noise),
                                                                   Theta)
        res["rowsum_dot_rows %s value" % dname] = M.rowsum_dot_rows(Theta, Beta, iu, ii)
        print("theta_diff_norm (Theta against Theta x (1 + 1e-3 u)), %s: %r; rowsum_dot_rows "
              "(the held-out pairs): %r" % (dname, res["theta_diff_norm %s value" % dname],
                                            res["rowsum_dot_rows %s value" % dname]))
    res["HPF.predict 100,000 wall ms"] = host_ms(lambda: model.predict(pu, pi), 20)
    print("HPF.predict of %d pairs: wall %.4f ms (host clock, median of 20)"
          % (PAIRS_PREDICT, res["HPF.predict 100,000 wall ms"]))
    print("RESULT " + json.dumps(res))
    return 0


def turns(order, reps, f64):
    """Each (label, tree) of ``order`` in its own process; then every figure
    side by side."""
    results = []
    print("card (nvidia-smi name, power.limit):", card())
    for label, tree in order:
        print("==== %s (%s)" % (label, tree), flush=True)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                            "--reps", str(reps)] + ([] if f64 else ["--no-f64"]),
                           capture_output=True, text=True)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stdout.write(r.stderr[-4000:])
            raise SystemExit("split_k2_k11: the %s turn failed (exit %d)"
                             % (label, r.returncode))
        line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    print("==== side by side: " + ", ".join(label for label, _ in order))
    keys = list(dict.fromkeys(k for res in results for k in res))
    for key in keys:
        vals = [res.get(key) for res in results]
        cells = [("%.4f" % v) if isinstance(v, float) and key.endswith(("ms", "s/iteration"))
                 else repr(v)
                 for v in vals]
        print("%-44s %s" % (key, "  ".join("%18s" % c for c in cells)))
    print("card (nvidia-smi name, power.limit):", card())
    return 0


def main():
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 20
    f64 = "--no-f64" not in sys.argv
    if "--one" in sys.argv:
        return one(sys.argv[sys.argv.index("--one") + 1], reps, f64)
    if "--parent" in sys.argv:
        parent = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
        return turns([("parent", parent), ("change", HERE), ("change", HERE),
                      ("parent", parent)], reps, f64)
    if "--trees" in sys.argv:
        trees = [os.path.abspath(t) for t in sys.argv[sys.argv.index("--trees") + 1:]
                 if not t.startswith("--")]
        return turns([(os.path.basename(t), t) for t in trees], reps, f64)
    return one(HERE, reps, f64)


if __name__ == "__main__":
    sys.exit(main())
