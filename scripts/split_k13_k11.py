"""K13 (the table-sharded ring, step and train metric) at each sub-tile
window, and K11's rowsum_dot_rows, of hpfrec_tpu_torch on one CUDA card,
for one tree or for two trees in turn.

Run from the root of a checkout:

    python3 scripts/split_k13_k11.py [--reps N] [--no-gloo]               # this tree
    python3 scripts/split_k13_k11.py --parent DIR [--reps N] [--no-gloo]  # DIR, this, this, DIR
    python3 scripts/split_k13_k11.py [--reps N] [--no-gloo] --trees DIR...  # each in turn

With ``--parent`` the script runs itself once per turn, in a process of its
own, against the ``hpfrec_tpu_torch`` and ``chip_smoke.py`` of DIR (a parent
commit unpacked, e.g. ``git archive <commit> | tar -x -C _cmp/parent``) and
of this tree, in the order DIR, this, this, DIR, and ends with a table of
every figure side by side.  The windows are steered through
``parallel.table_sharded._FAST_GATHER_BYTES``, which ``prepare_table_sharded``
reads at the call when it is given no window (in either tree; untiled is a
window wider than any shard), and only public signatures are used besides,
so a parent tree times the same way.

Each turn builds chip_smoke.py's MillionSong TasteProfile data (its seed;
1% held out as its SVI phases hold it out), fits it on one device as
chip_smoke.py phase 3 does (10 iterations, train-llk every 5) and prints:

1. the one-device ELL step from the fit's state (CUDA events);
2. K13 (b): on a one-rank NCCL mesh, for each window (untiled, JAX's 40
   MB, 25 MB), the plan's sub-tiles, buckets and segments, then K13a (both
   sides' ring phi sums), K13b (one step) and K13c (one train metric),
   CUDA events, each with a digest of its output's bits; K1 over the
   layouts as one launch a bucket (``bucket_phi_sums``) and, in a tree
   whose ranks keep a view a ring offset, as one launch a ring offset,
   with a digest of each (they must be equal);
3. K13 (a), unless ``--no-gloo``: two ranks of this script on the one card
   over gloo (the ring staged through the host), for each window, rank 0's
   step and ring phi sums (CUDA events) from a seeded random state;
4. K11: ``rowsum_dot_rows`` on the held-out pairs (387,525) from the fit's
   factors, float32 and float64, CUDA events and its value, the plain
   version's time beside (in a tree with a device finish, its two
   launches alone too, with no value copied back); as the final eval calls it (host arrays in, one
   value out) on the host clock; ``HPF.eval_llk`` of the validation set
   on the host clock (it does not call ``rowsum_dot_rows``); and, as
   controls for the pair walk that rowsum_dot shares, ``predict_pairs``
   and K5 on the held-out pairs, float32, with a digest.

The card's name and power limit (nvidia-smi) come first.  Needs a card.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> window bytes; untiled as a window wider than any shard
WINDOWS = {"untiled": 1 << 60, "40 MB": 40 * 2 ** 20, "25 MB": 25 * 2 ** 20}


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def digest(*arrays):
    import torch

    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, (list, tuple)):
            h.update(digest(*a).encode())
            continue
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


def plan_for(TS, csr, nU, nI, world, window):
    TS._FAST_GATHER_BYTES = window
    t0 = time.perf_counter()
    plan = TS.prepare_table_sharded(*csr, nU, nI, 50, world, 4, dtype=np.float32)
    return plan, time.perf_counter() - t0


def k1_forms(E, sides):
    """K1 over both sides' shares: one launch a bucket, and one a ring
    offset where the share keeps a view an offset (None otherwise); each
    offset against the rank's own shard, which has every shard's shape."""
    import torch

    def segs(a, sh):
        return torch.empty((sh.ell.n_segs, a.shape[1]), dtype=torch.float32, device=a.device)

    def buckets():
        out = []
        for a, b, sh in sides:
            out.append(segs(a, sh))
            for bk in sh.ell.buckets:
                E.bucket_phi_sums(a, b, bk.rows, bk.cols, bk.vals, bk.col_off,
                                  out[-1][bk.start:bk.start + bk.rows.shape[0]])
        return out

    def offsets():
        out = []
        for a, b, sh in sides:
            out.append(segs(a, sh))
            for view in sh.offsets:
                E.all_bucket_sums(a, b, view, out=out[-1])
        return out

    return buckets, offsets if hasattr(sides[0][2], "offsets") else None


def k13_nccl(CS, m, coo, reps, res):
    """Part 1 and 2: the one-device step, then K13 (b) at each window."""
    import torch

    from hpfrec_tpu_torch.models.state import Hyperparams, state_from_numpy
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.parallel import distributed
    from hpfrec_tpu_torch.parallel import table_sharded as TS
    from hpfrec_tpu_torch.utils.data import build_csr, process_data

    dev = torch.device("cuda")
    pdata = process_data(coo, "train-llk", False, np.float32, sort_by_user=True)
    nU, nI = pdata.nusers, pdata.nitems
    csr = (*build_csr(pdata.ix_u, pdata.ix_i, pdata.y, nU, nI),
           *build_csr(pdata.ix_i, pdata.ix_u, pdata.y, nI, nU))
    host = state_from_numpy([m.Gamma_shp, m.Gamma_rte, m.Lambda_shp, m.Lambda_rte, m.k_rte,
                             m.t_rte], "cpu")
    hp = Hyperparams(k=CS.K)
    lay_u, lay_i = (E.to_device(h, dev) for h in E.build_layouts(pdata, np.float32))
    one = C._carry_init(type(host)(*[a.to(dev) for a in host]))
    res["one-device step ms"] = CS.cuda_ms(lambda: E.cavi_step_ell_carried(one, lay_u, lay_i, hp),
                                           reps)
    print("one-device ELL step: %.4f ms (CUDA events, %d calls)" % (res["one-device step ms"],
                                                                   reps))
    del lay_u, lay_i, one
    rdv = tempfile.mkdtemp(prefix="split_k13_")
    mesh = distributed.initialize("file://" + os.path.join(rdv, "rdv"), num_processes=1,
                                  process_id=0, backend="nccl", device="cuda:0")
    default = TS._FAST_GATHER_BYTES
    for name, window in WINDOWS.items():
        plan, pack_s = plan_for(TS, csr, nU, nI, 1, window)
        ts = TS.TableSharded(mesh, plan, nU, nI, dev)
        carry = ts.carry_init(ts.shard_state(host))
        st = carry.state
        Theta, Beta = st.G_shp / st.G_rte, st.L_shp / st.L_rte
        sides = ((carry.t_tab, carry.b_tab, ts.u), (carry.b_tab, carry.t_tab, ts.i))
        key = "K13 (b) %s" % name
        res[key + " n_sub"] = [plan.plan_u[2], plan.plan_i[2]]
        res[key + " buckets"] = [len(ts.u.ell.buckets), len(ts.i.ell.buckets)]
        res[key + " segments"] = [ts.u.ell.n_segs, ts.i.ell.n_segs]
        res[key + " host_pack s"] = pack_s
        figs = {
            "K13a": lambda: [TS.ring_table_sums(mesh, a, b, sh, torch.float32)
                             for a, b, sh in sides],
            "K13b": lambda: list(TS.table_sharded_step(mesh, carry, ts.u, ts.i, hp).state),
            "K13c": lambda: TS.table_sharded_llk_parts(mesh, Theta, Beta, ts.u, False),
        }
        buckets, offsets = k1_forms(E, sides)
        figs["K1 a bucket a launch"] = buckets
        if offsets is not None:
            figs["K1 a ring offset a launch"] = offsets
        for part, fn in figs.items():
            res["%s %s ms" % (key, part)] = CS.cuda_ms(fn, reps)
            res["%s %s digest" % (key, part)] = digest(fn())
        print("%s: sub-tiles a shard %s, buckets %s, segments %s, host_pack %.3f s; %s"
              % (key, res[key + " n_sub"], res[key + " buckets"], res[key + " segments"], pack_s,
                 "; ".join("%s %.4f ms (digest %s)" % (p, res["%s %s ms" % (key, p)],
                                                       res["%s %s digest" % (key, p)])
                           for p in figs)))
        del plan, ts, carry, st, Theta, Beta, sides
        torch.cuda.empty_cache()
    TS._FAST_GATHER_BYTES = default
    import torch.distributed as dist

    dist.destroy_process_group()


def gloo_rank(tree, rank, rdv, out, reps):
    """One of part 3's two gloo ranks: each window's plan, its step and
    ring phi sums over the host-staged ring, from a seeded random state."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as CS
    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.parallel import distributed
    from hpfrec_tpu_torch.parallel import table_sharded as TS
    from hpfrec_tpu_torch.utils.data import build_csr, process_data

    mesh = distributed.initialize("file://" + rdv, num_processes=2, process_id=rank,
                                  initialization_timeout=300, backend="gloo", device="cuda:0")
    coo = CS.powerlaw_coo(**CS.MILLIONSONG, seed=0)
    pdata = process_data(coo, "train-llk", False, np.float32, sort_by_user=True)
    nU, nI = pdata.nusers, pdata.nitems
    csr = (*build_csr(pdata.ix_u, pdata.ix_i, pdata.y, nU, nI),
           *build_csr(pdata.ix_i, pdata.ix_u, pdata.y, nI, nU))
    state = CS.random_state(nU, nI, np.float32, "cpu", seed=3)
    hp = Hyperparams(k=CS.K)
    res = {}
    for name, window in WINDOWS.items():
        plan, _ = plan_for(TS, csr, nU, nI, 2, window)
        ts = TS.TableSharded(mesh, plan, nU, nI, mesh.device)
        carry = ts.carry_init(ts.shard_state(state))
        sides = ((carry.t_tab, carry.b_tab, ts.u), (carry.b_tab, carry.t_tab, ts.i))
        key = "K13 (a) gloo %s" % name
        res[key + " n_sub"] = [plan.plan_u[2], plan.plan_i[2]]
        res[key + " step ms"] = CS.cuda_ms(
            lambda: TS.table_sharded_step(mesh, carry, ts.u, ts.i, hp), reps)
        res[key + " K13a ms"] = CS.cuda_ms(
            lambda: [TS.ring_table_sums(mesh, a, b, sh, torch.float32) for a, b, sh in sides],
            reps)
        del plan, ts, carry, sides
        torch.cuda.empty_cache()
    with open(out % rank, "w") as f:
        json.dump(res, f)
    return 0


def k13_gloo(tree, reps, res):
    d = tempfile.mkdtemp(prefix="split_k13_gloo_")
    out = os.path.join(d, "rank%d.json")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-rank", tree,
                               str(r), os.path.join(d, "rdv"), out, str(reps)])
             for r in (0, 1)]
    if any(p.wait(timeout=900) for p in procs):
        raise SystemExit("split_k13_k11: a gloo rank failed")
    r0 = json.load(open(out % 0))
    res.update(r0)
    for name in WINDOWS:
        key = "K13 (a) gloo %s" % name
        print("%s: sub-tiles a shard %s; rank 0 step %.4f ms, ring phi sums %.4f ms (CUDA events, "
              "%d calls)" % (key, r0[key + " n_sub"], r0[key + " step ms"],
                             r0[key + " K13a ms"], reps))


def k11(CS, m, val, reps, res):
    import torch

    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import metrics as M
    from hpfrec_tpu_torch.utils.data import process_valset

    dev = torch.device("cuda")
    # the held-out pairs in the fit's ids, as the fit and eval_llk map them
    y_h, iu_h, ii_h = process_valset(val, "val-llk", m.reindex, m.user_mapping_,
                                     m.item_mapping_, m.nusers, m.nitems, np.float32,
                                     is_valset=False)
    triplets = C.device_blocked_coo(y_h, iu_h, ii_h, dev)[0]
    iu_h, ii_h = iu_h.astype(np.int32), ii_h.astype(np.int32)
    iu, ii = (torch.from_numpy(a).to(dev) for a in (iu_h, ii_h))
    print("held-out pairs: %d" % len(iu_h))
    for dt in (torch.float32, torch.float64):
        dname = str(dt).split(".")[1]
        Theta, Beta = (torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
                       for a in (m.Theta, m.Beta))
        key = "K11 rowsum_dot_rows %s" % dname
        res[key + " ms"] = CS.cuda_ms(lambda: M.rowsum_dot_rows(Theta, Beta, iu, ii), reps)
        res[key + " plain ms"] = CS.cuda_ms(
            lambda: M._rowsum_dot_rows_plain(Theta, Beta, iu, ii), reps)
        if hasattr(M, "_rowsum_dot_launch"):  # the launches alone, no value copied back
            res[key + " launches only ms"] = CS.cuda_ms(
                lambda: M._rowsum_dot_launch(Theta, Beta, iu, ii), reps)
            print("%s, its two launches with no readback: %.4f ms (CUDA events, %d calls)"
                  % (key, res[key + " launches only ms"], reps))
        res[key + " value"] = M.rowsum_dot_rows(Theta, Beta, iu, ii)
        res[key + " as the final eval calls it ms"] = host_ms(
            lambda: M.rowsum_dot_rows(Theta, Beta, torch.from_numpy(iu_h).to(dev),
                                      torch.from_numpy(ii_h).to(dev)), 20)
        print("%s: %.4f ms (CUDA events, %d calls; plain %.4f ms), value %r; from host arrays "
              "%.4f ms (host clock, median of 20)"
              % (key, res[key + " ms"], reps, res[key + " plain ms"], res[key + " value"],
                 res[key + " as the final eval calls it ms"]))
    Theta, Beta = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (m.Theta, m.Beta))
    for key, fn in (("K11 predict_pairs held-out float32",
                     lambda: M.predict_pairs(Theta, Beta, iu, ii)),
                    ("K5 held-out float32", lambda: M.llk_rmse_sums(Theta, Beta, triplets))):
        res[key + " ms"] = CS.cuda_ms(fn, reps)
        res[key + " digest"] = digest(fn())
        print("%s: %.4f ms (CUDA events, %d calls), digest %s"
              % (key, res[key + " ms"], reps, res[key + " digest"]))
    res["HPF.eval_llk wall ms"] = host_ms(lambda: m.eval_llk(val), 20)
    print("HPF.eval_llk of the validation set: wall %.4f ms (host clock, median of 20)"
          % res["HPF.eval_llk wall ms"])


def one(tree, reps):
    """One turn against the tree at ``tree``: prints its figures and a last
    ``RESULT <json>`` line of them."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as CS
    from hpfrec_tpu_torch import HPF, _cuda

    if not torch.cuda.is_available():
        print("split_k13_k11: needs a CUDA card", file=sys.stderr)
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
    m = HPF(k=CS.K, stop_crit="train-llk", check_every=5, maxiter=10, random_seed=1,
            verbose=False, device="cuda").fit(coo)
    k13_nccl(CS, m, coo, reps, res)
    torch.cuda.empty_cache()
    if "--no-gloo" not in sys.argv:
        k13_gloo(tree, max(3, reps // 4), res)
    k11(CS, m, val, reps, res)
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
                            "--reps", str(reps)] + [a for a in sys.argv if a == "--no-gloo"],
                           capture_output=True, text=True)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stdout.write(r.stderr[-4000:])
            raise SystemExit("split_k13_k11: the %s turn failed (exit %d)"
                             % (label, r.returncode))
        line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    print("==== side by side: " + ", ".join(label for label, _ in order))
    keys = list(dict.fromkeys(k for res in results for k in res))
    for key in keys:
        cells = [("%.4f" % v) if isinstance(v, float) and key.endswith(("ms", " s")) else repr(v)
                 for v in (res.get(key) for res in results)]
        print("%-58s %s" % (key, "  ".join("%18s" % c for c in cells)))
    print("card (nvidia-smi name, power.limit):", card())
    return 0


def main():
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 20
    if "--gloo-rank" in sys.argv:
        i = sys.argv.index("--gloo-rank")
        tree, rank, rdv, out, reps = sys.argv[i + 1:i + 6]
        return gloo_rank(tree, int(rank), rdv, out, int(reps))
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
