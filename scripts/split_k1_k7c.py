"""Where K7c (COO phi sums) and K1 (ELL phi sums) of hpfrec_tpu_torch spend
their time on one CUDA card, for one tree or for two trees in turn.

Run from the root of a checkout:

    python3 scripts/split_k1_k7c.py [--reps N]               # this tree
    python3 scripts/split_k1_k7c.py --parent DIR [--reps N]  # DIR, this, this, DIR
    python3 scripts/split_k1_k7c.py [--no-tiles] [--no-k7c] --trees DIR...  # each in turn

With ``--parent`` the script runs itself once per turn, in a process of its
own, against the ``hpfrec_tpu_torch`` and ``chip_smoke.py`` of DIR (a parent
commit unpacked, e.g. ``git archive <commit> | tar -x -C _cmp/parent``) and
of this tree, in the order DIR, this, this, DIR, and ends with a table of
every figure side by side.  Only the wrappers' public signatures are used,
so any tree since the COO engine times the same way.

At the MillionSong TasteProfile shape (chip_smoke.py's data and seed, k=50,
float32, a random state from chip_smoke's ``random_state``), each turn
prints:

1. K7c (``ops.cavi.coo_phi_sums``) over the whole user-sorted training
   stream: the wrapper's time with CUDA events, then one call's device
   time by stage under ``torch.profiler`` (user pass, item pass, group
   passes, finishes), and a digest of its output bits;
2. K1 (``ops.ell.bucket_phi_sums``) by bucket and side: width, segments,
   slots, padding share, warps per segment, ms with CUDA events; each
   side's ``all_bucket_sums`` and K1 + K2 (``ell_phi_sums``) with CUDA
   events, and a digest of each side's sums;
3. K1 + K2 of the item side on the untiled layout and on layouts built
   with ``build_ell(col_chunk_rows=...)``: Theta tiles of ~24 MB and of
   the JAX package's 40 MB, each held against the untiled sums.

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
# K7c's kernels by the words in their names (the SVI kernel's names, which
# K7c used before its own passes, and the COO passes' own)
STAGES = (("user pass", ("phi_chunk_kernel<", ", true,")), ("user pass", ("coo_user_pass",)),
          ("item pass", ("phi_chunk_kernel<", ", false,")), ("item pass", ("coo_item_pass",)),
          ("group passes", ("phi_group_kernel",)), ("user finish", ("phi_local_finish",)),
          ("item finish", ("phi_other_finish",)))
# Theta tile sizes of section 3, in bytes (None: untiled)
TILES = (("untiled", None), ("24 MB", 24 << 20), ("40 MB (JAX)", 40 << 20))


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def one(tree, reps):
    """One turn against the tree at ``tree``: prints its figures and a last
    ``RESULT <json>`` line of them."""
    sys.path.insert(0, tree)
    import torch

    from chip_smoke import (K, MILLIONSONG, cuda_ms, host_layouts, kernel_split, powerlaw_coo,
                            random_state, user_side)
    from hpfrec_tpu_torch import _cuda
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.utils.data import build_csr, process_data

    if not torch.cuda.is_available():
        print("split_k1_k7c: needs a CUDA card", file=sys.stderr)
        return 1
    print("tree %s; card (nvidia-smi name, power.limit): %s" % (tree, card()))
    res = {}
    t0 = time.perf_counter()
    _cuda.load()
    dev = torch.device("cuda")
    coo = powerlaw_coo(**MILLIONSONG, seed=0)
    p = process_data(coo, "train-llk", False, np.float32)
    del coo
    state = random_state(p.nusers, p.nitems, np.float32, dev, 2)
    t_tab = C.side_derive(state.G_shp, state.G_rte)[0]
    b_tab = C.side_derive(state.L_shp, state.L_rte)[0]
    del state
    print("set-up %.1f s: %d users, %d items, %d triplets, k=%d"
          % (time.perf_counter() - t0, p.nusers, p.nitems, p.y.shape[0], K))

    # -- 1. K7c over the whole stream
    stream = None if "--no-k7c" in sys.argv else C.coo_stream(user_side(p, dev), p.nitems)
    if stream is not None:
        ms = cuda_ms(lambda: C.coo_phi_sums(t_tab, b_tab, stream), reps)
        res["K7c ms"] = ms
        split = {}
        for kms, key in kernel_split(lambda: C.coo_phi_sums(t_tab, b_tab, stream),
                                     max(3, reps)):
            stage = next((n for n, words in STAGES if all(w in key for w in words)), "other")
            split[stage] = split.get(stage, 0.0) + kms
        for stage, kms in sorted(split.items(), key=lambda kv: -kv[1]):
            res["K7c %s ms" % stage] = kms
        res["K7c digest"] = digest(*C.coo_phi_sums(t_tab, b_tab, stream))
        print("K7c: %.4f ms (CUDA events, %d calls); by stage (torch.profiler): %s; digest %s"
              % (ms, reps, ", ".join("%s %.4f" % kv for kv in split.items()),
                 res["K7c digest"]))
        del stream
        torch.cuda.empty_cache()

    # -- 2. K1 by bucket and side
    lay_u, lay_i = (E.to_device(h, dev) for h in host_layouts(p, np.float32))
    for side, (ts, to, lay) in (("user", (t_tab, b_tab, lay_u)),
                                ("item", (b_tab, t_tab, lay_i))):
        seg = torch.empty((lay.n_segs, K), dtype=torch.float32, device=dev)
        print("K1 %s side: %d buckets, %d segments, %d slots"
              % (side, len(lay.buckets), lay.n_segs,
                 sum(b.cols.numel() for b in lay.buckets)))
        print("  %6s %9s %11s %8s %4s %10s" % ("width", "segments", "slots", "padding",
                                               "wps", "ms"))
        total = 0.0
        for b in lay.buckets:
            m, w = b.cols.shape
            out = seg[b.start:b.start + m]
            bms = cuda_ms(lambda: E.bucket_phi_sums(ts, to, b.rows, b.cols, b.vals, b.col_off,
                                                    out), reps)
            total += bms
            pad = float((b.vals == 0).float().mean())
            print("  %6d %9d %11d %8.4f %4d %10.4f" % (w, m, m * w, pad,
                                                      E._warps_per_segment(w), bms))
            res["K1 %s w=%d ms" % (side, w)] = bms
        res["K1 %s sum of buckets ms" % side] = total
        res["K1 %s all_bucket_sums ms" % side] = cuda_ms(
            lambda: E.all_bucket_sums(ts, to, lay), reps)
        res["K1+K2 %s ms" % side] = cuda_ms(lambda: E.ell_phi_sums(ts, to, lay), reps)
        again = E.all_bucket_sums(ts, to, lay)
        res["K1 %s digest" % side] = digest(again)
        # the buckets one warp walks a segment of (wps 1)
        res["K1 %s digest, wps 1" % side] = digest(*(
            again[b.start:b.start + b.rows.shape[0]] for b in lay.buckets
            if E._warps_per_segment(b.cols.shape[1]) == 1))
        print("  sum of the buckets %.4f ms; all_bucket_sums %.4f ms; K1 + K2 %.4f ms; "
              "digest %s" % (total, res["K1 %s all_bucket_sums ms" % side],
                             res["K1+K2 %s ms" % side], res["K1 %s digest" % side]))
        del seg
    ref = E.ell_phi_sums(b_tab, t_tab, lay_i)
    del lay_u, lay_i
    torch.cuda.empty_cache()

    # -- 3. K1 + K2 of the item side on tiled layouts (Theta tiles)
    indptr, ind, dat = build_csr(p.ix_i, p.ix_u, p.y, p.nitems, p.nusers)
    for name, tile in TILES if "--no-tiles" not in sys.argv else ():
        rows = None if tile is None else tile // (K * 4)
        t1 = time.perf_counter()
        host = E.build_ell(indptr, ind, dat, p.nitems, dtype=np.float32, col_chunk_rows=rows,
                           n_cols=p.nusers)
        lay = E.to_device(host, dev)
        built = time.perf_counter() - t1
        got = E.ell_phi_sums(b_tab, t_tab, lay)
        err = float((got - ref).abs().max() / ref.abs().max())
        ms = cuda_ms(lambda: E.ell_phi_sums(b_tab, t_tab, lay), reps)
        k1 = cuda_ms(lambda: E.all_bucket_sums(b_tab, t_tab, lay), reps)
        res["tiled %s K1+K2 ms" % name] = ms
        res["tiled %s K1 ms" % name] = k1
        print("K1 + K2 item side, %s (%s rows a tile): %.4f ms (K1 %.4f); %d buckets, "
              "%d segments, %d slots; built in %.1f s; max |diff| / max against untiled %.2e"
              % (name, rows, ms, k1, len(lay.buckets), lay.n_segs,
                 sum(b.cols.numel() for b in lay.buckets), built, err))
        del lay, host, got
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(res))
    return 0


def turns(order, reps, extra=()):
    """Each (label, tree) of ``order`` in its own process; then every figure
    side by side."""
    results = []
    print("card (nvidia-smi name, power.limit):", card())
    for label, tree in order:
        print("==== %s (%s)" % (label, tree), flush=True)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                            "--reps", str(reps), *extra], capture_output=True, text=True)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stdout.write(r.stderr[-4000:])
            raise SystemExit("split_k1_k7c: the %s turn failed (exit %d)"
                             % (label, r.returncode))
        line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
        results.append(json.loads(line[len("RESULT "):]))
    print("==== side by side: " + ", ".join(label for label, _ in order))
    keys = list(dict.fromkeys(k for res in results for k in res))
    for key in keys:
        vals = [res.get(key) for res in results]
        cells = [("%.4f" % v) if isinstance(v, float) else str(v) for v in vals]
        print("%-34s %s" % (key, "  ".join("%12s" % c for c in cells)))
    print("card (nvidia-smi name, power.limit):", card())
    return 0


def main():
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 10
    if "--one" in sys.argv:
        return one(sys.argv[sys.argv.index("--one") + 1], reps)
    extra = [f for f in ("--no-tiles", "--no-k7c") if f in sys.argv]
    if "--parent" in sys.argv:
        parent = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
        return turns([("parent", parent), ("change", HERE), ("change", HERE),
                      ("parent", parent)], reps, extra)
    if "--trees" in sys.argv:
        trees = [os.path.abspath(t) for t in sys.argv[sys.argv.index("--trees") + 1:]
                 if not t.startswith("--")]
        return turns([(os.path.basename(t), t) for t in trees], reps, extra)
    return one(HERE, reps)


if __name__ == "__main__":
    sys.exit(main())
