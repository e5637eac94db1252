"""K9 (the SVI epoch gather) and K5 (the COO llk sums) of hpfrec_tpu_torch on
one CUDA card, for one tree or for two trees in turn.

Run from the root of a checkout:

    python3 scripts/split_k5_k9.py [--reps N] [--no-k9]               # this tree
    python3 scripts/split_k5_k9.py --parent DIR [--reps N] [--no-k9]  # DIR, this, this, DIR
    python3 scripts/split_k5_k9.py [--reps N] [--no-k9] --trees DIR...  # each in turn

With ``--parent`` the script runs itself once per turn, in a process of its
own, against the ``hpfrec_tpu_torch`` and ``chip_smoke.py`` of DIR (a parent
commit unpacked, e.g. ``git archive <commit> | tar -x -C _cmp/parent``) and
of this tree, in the order DIR, this, this, DIR, and ends with a table of
every figure side by side.  Only public signatures are used
(``epoch_side``, ``epoch_offsets``, ``build_epoch_buffers``,
``svi_run_epoch``, ``llk_rmse_sums``, ``predict_pairs``, ``coo_stream``,
``device_blocked_coo``, ``HPF``), so a parent tree times the same way.

Each turn builds chip_smoke.py's MillionSong TasteProfile data (its seed;
1% held out as its SVI phases hold it out) and prints:

1. the SVI fit with the validation set (chip_smoke.py phase 3b: batches of
   100,000 users / 40,000 items, val-llk every 2 epochs, 6 epochs): its
   s per user and per item epoch and a digest of its factors' bits; and
   the blocked-COO fit (phase 3g: 10 iterations, train-llk every 5): its
   s/iteration and factor digest;
2. K9 over a user epoch and an item epoch of the training set (a seeded
   permutation each), float32 and float64: both sides and each side alone,
   CUDA events, and a digest of the three outputs' bits; then the ``host
   offsets + upload`` stage of ``svi_run_epoch`` on the host clock (from
   the call to its first ``mark``, median of N warm epochs a side);
3. K5 on the fitted factors, float32 and float64, ``full_llk`` both ways:
   the validation set (the SVI fit's factors; the plain version's time
   beside) and the COO engine's train stream (38.7M triplets, the COO
   fit's factors), CUDA events and the summed (ll, se, sp); K11's
   ``predict_pairs``, which runs K5's walk, on the held-out pairs and on 4M
   random pairs (float32), CUDA events and a digest; and ``HPF.eval_llk``
   of the validation set on the host clock (median of 20).

``--no-k9`` leaves out part 2.  The card's name and power limit
(nvidia-smi) come first.  Needs a card.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def fits(CS, HPF, coo, train, val, res):
    svi = HPF(k=CS.K, stop_crit="val-llk", check_every=2, maxiter=6, random_seed=1,
              verbose=False, device="cuda", **CS.SVI_BATCHES).fit(train, val_set=val)
    st = svi.fit_stats_
    epochs = svi.niter + 1
    n_user = sum((i + 1) % 2 == 0 for i in range(epochs))
    res["SVI fit s/user epoch"] = st.phases["user_epochs"] / n_user
    res["SVI fit s/item epoch"] = st.phases["item_epochs"] / (epochs - n_user)
    res["SVI fit digest"] = digest(svi.Theta, svi.Beta)
    print("SVI val-llk fit: %d epochs, %.4f s a user epoch, %.4f s an item epoch, wall %.3f s, "
          "digest %s" % (epochs, res["SVI fit s/user epoch"], res["SVI fit s/item epoch"],
                         st.wall_seconds, res["SVI fit digest"]))
    cf = HPF(engine="coo", k=CS.K, stop_crit="train-llk", check_every=5, maxiter=10,
             random_seed=1, verbose=False, device="cuda").fit(coo)
    st = cf.fit_stats_
    res["COO fit s/iteration"] = st.phases["iterations"] / (cf.niter + 1)
    res["COO fit digest"] = digest(cf.Theta, cf.Beta)
    res["COO fit train llk"] = cf.train_llk
    print("COO fit: %.4f s/iteration (iterations phase), wall %.3f s, train llk %r, digest %s"
          % (res["COO fit s/iteration"], st.wall_seconds, cf.train_llk, res["COO fit digest"]))
    return svi, cf


def k9(CS, train, reps, res):
    import torch

    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import svi as S
    from hpfrec_tpu_torch.utils.data import build_csr, process_data

    dev = torch.device("cuda")
    pdata = process_data(train, "val-llk", False, np.float32)
    rng = np.random.default_rng(7)
    host = []
    for name, rows, cols, n_rows, n_cols in (
            ("user", pdata.ix_u, pdata.ix_i, pdata.nusers, pdata.nitems),
            ("item", pdata.ix_i, pdata.ix_u, pdata.nitems, pdata.nusers)):
        indptr, ind, dat = build_csr(rows, cols, pdata.y, n_rows, n_cols)
        perm = rng.permutation(n_rows)
        host.append((name, indptr, ind, dat, perm))
        print("%s side: %d rows (%d empty), %d positions" % (name, n_rows,
                                                             int((np.diff(indptr) == 0).sum()),
                                                             int(indptr[-1])))
    for dt in (torch.float32, torch.float64):
        dname = str(dt).split(".")[1]
        npdt = np.float32 if dt == torch.float32 else np.float64
        sides = []
        for name, indptr, ind, dat, perm in host:
            side = S.epoch_side(indptr, ind, dat, npdt, dev)
            off = torch.from_numpy(S.epoch_offsets(side.deg, perm).astype(np.int32)).to(dev)
            sides.append((name, side, torch.from_numpy(perm.astype(np.int32)).to(dev), off))

        def run(which):
            return [t for name, side, perm_d, off in sides if name in which
                    for t in S.build_epoch_buffers(side.y, side.cols, side.indptr, perm_d, off)]
        for label, which in (("both sides", ("user", "item")), ("user side", ("user",)),
                             ("item side", ("item",))):
            key = "K9 %s %s" % (dname, label)
            res[key + " ms"] = CS.cuda_ms(lambda: run(which), reps)
            res[key + " digest"] = digest(*run(which))
            print("%s: %.4f ms (CUDA events, %d calls), digest %s"
                  % (key, res[key + " ms"], reps, res[key + " digest"]))
        res["K9 %s bytes" % dname] = sum(
            CS.nbytes(side.y, side.cols, side.indptr, perm_d, off) + side.y.numel()
            * (side.y.element_size() + 8) for _, side, perm_d, off in sides)
        print("K9 %s bytes (inputs once, outputs once): %.4g" % (dname, res["K9 %s bytes"
                                                                           % dname]))
        del sides
        torch.cuda.empty_cache()

    # the host stage beside K9, as svi_run_epoch runs it: from the call to
    # its first mark, which it calls once the offsets are computed and both
    # arrays are uploaded
    state = CS.random_state(pdata.nusers, pdata.nitems, np.float32, dev, seed=3)
    hp = Hyperparams(k=CS.K)
    for (name, indptr, ind, dat, perm), per_batch in zip(
            host, (CS.SVI_BATCHES["users_per_batch"], CS.SVI_BATCHES["items_per_batch"])):
        side = S.epoch_side(indptr, ind, dat, np.float32, dev)
        stage = []

        def epoch():
            t0 = time.perf_counter()
            marks = []
            S.svi_run_epoch(state, side, perm, per_batch, 0.5, hp, name == "user",
                            mark=lambda s: marks.append(time.perf_counter()))
            stage.append((marks[0] - t0) * 1e3)
        host_ms(epoch, 10)
        key = "host offsets + upload, %s epoch ms" % name
        res[key] = float(np.median(stage[1:]))
        print("%s (host clock, median of %d warm epochs): %.4f" % (key, len(stage) - 1,
                                                                   res[key]))


def k5(CS, svi, cf, coo, val, reps, res):
    import torch

    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import metrics as M
    from hpfrec_tpu_torch.utils.data import process_data, process_valset

    dev = torch.device("cuda")
    # the fits' own streams: the validation set in the SVI fit's ids (as the
    # fit and eval_llk map it), the training set as the COO fit streams it
    triplets = process_valset(val, "val-llk", svi.reindex, svi.user_mapping_, svi.item_mapping_,
                              svi.nusers, svi.nitems, np.float32, is_valset=False)
    vset = C.device_blocked_coo(*triplets, dev)[0]
    stream = C.coo_stream(process_data(coo, "train-llk", True, np.float32), dev).data
    print("COO train stream: %d slots in %d blocks; validation set: %d slots"
          % (stream.y.numel(), stream.y.shape[0], vset.y.numel()))
    for dt in (torch.float32, torch.float64):
        dname = str(dt).split(".")[1]
        sets = []
        for label, model, data in (("validation", svi, vset), ("COO train stream", cf, stream)):
            data = data._replace(y=data.y.to(dt))
            tabs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
                    for a in (model.Theta, model.Beta)]
            sets.append((label, tabs, data))
        for label, (Theta, Beta), data in sets:
            for full in (False, True):
                key = "K5 %s %s full_llk=%s" % (label, dname, full)
                f = lambda: M.llk_rmse_sums(Theta, Beta, data, full)  # noqa: E731
                res[key + " ms"] = CS.cuda_ms(f, reps)
                res[key + " sums"] = [float(v) for v in f().sum(0).cpu()]
                print("%s: %.4f ms (CUDA events, %d calls), (ll, se, sp) %s"
                      % (key, res[key + " ms"], reps,
                         ", ".join("%.17g" % v for v in res[key + " sums"])))
            if label == "validation":
                res["K5 validation %s plain ms" % dname] = CS.cuda_ms(
                    lambda: torch.cat([M._coo_llk_plain(Theta, Beta, data.y[b], data.ix_u[b],
                                                        data.ix_i[b], False)
                                       for b in range(data.y.shape[0])]), reps)
                print("K5 validation %s, the plain version: %.4f ms"
                      % (dname, res["K5 validation %s plain ms" % dname]))
        del sets
        torch.cuda.empty_cache()
    # predict_pairs runs the same walk: its bits and time on the held-out
    # pairs and on 4M random pairs (float32, the SVI fit's factors)
    Theta, Beta = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (svi.Theta, svi.Beta))
    rng = np.random.default_rng(11)
    for label, iu, ii in (("held-out", vset.ix_u.reshape(-1), vset.ix_i.reshape(-1)),
                          ("4M", *(torch.from_numpy(rng.integers(0, n, 1 << 22).astype(
                              np.int32)).to(dev) for n in (svi.nusers, svi.nitems)))):
        key = "K11 predict_pairs %s float32" % label
        f = lambda: M.predict_pairs(Theta, Beta, iu, ii)  # noqa: E731
        res[key + " ms"] = CS.cuda_ms(f, reps)
        res[key + " digest"] = digest(f())
        print("%s: %.4f ms (CUDA events, %d calls), digest %s"
              % (key, res[key + " ms"], reps, res[key + " digest"]))
    res["HPF.eval_llk wall ms"] = host_ms(lambda: svi.eval_llk(val), 20)
    res["HPF.eval_llk value"] = svi.eval_llk(val)["llk"]
    print("HPF.eval_llk of the validation set: wall %.4f ms (host clock, median of 20), llk %r"
          % (res["HPF.eval_llk wall ms"], res["HPF.eval_llk value"]))


def one(tree, reps):
    """One turn against the tree at ``tree``: prints its figures and a last
    ``RESULT <json>`` line of them."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as CS
    from hpfrec_tpu_torch import HPF, _cuda

    if not torch.cuda.is_available():
        print("split_k5_k9: needs a CUDA card", file=sys.stderr)
        return 1
    print("tree %s; card (nvidia-smi name, power.limit): %s" % (tree, card()))
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    t0 = time.perf_counter()
    _cuda.load()
    coo = CS.powerlaw_coo(**CS.MILLIONSONG, seed=0)
    train, val = CS.holdout(coo, 0.01, seed=5)
    print("set-up %.1f s (build, data): %d x %d, %d nonzeros, %d held out"
          % (time.perf_counter() - t0, *coo.shape, coo.nnz, val.nnz))
    svi, cf = fits(CS, HPF, coo, train, val, res)
    torch.cuda.empty_cache()
    if "--no-k9" not in sys.argv:
        k9(CS, train, reps, res)
        torch.cuda.empty_cache()
    k5(CS, svi, cf, coo, val, reps, res)
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
                            "--reps", str(reps)] + [a for a in sys.argv if a == "--no-k9"],
                           capture_output=True, text=True)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stdout.write(r.stderr[-4000:])
            raise SystemExit("split_k5_k9: the %s turn failed (exit %d)" % (label, r.returncode))
        line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    print("==== side by side: " + ", ".join(label for label, _ in order))
    keys = list(dict.fromkeys(k for res in results for k in res))
    for key in keys:
        vals = [res.get(key) for res in results]
        cells = [("%.4f" % v) if isinstance(v, float) and key.endswith(("ms", "epoch",
                                                                        "s/iteration"))
                 else repr(v)
                 for v in vals]
        print("%-52s %s" % (key, "  ".join("%18s" % c for c in cells)))
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
