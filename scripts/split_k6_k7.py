"""Where K6 (top-n) and K7 / K7c (SVI and COO phi sums) of hpfrec_tpu_torch
spend their time on one CUDA card.

Run from the root of a checkout:  python3 scripts/split_k6_k7.py [--reps N]

At the MillionSong TasteProfile shape (chip_smoke.py's data and seed, k=50,
float32, a random state from chip_smoke's ``random_state``):

1. K7 (``ops.svi.batch_phi_sums``) at the two batches of chip_smoke's
   ``svi_suite``: the first 100,000-user batch of a user epoch and the
   40,000-item batch that holds the rank-1 item (item 0).  For each: the
   wrapper's time with CUDA events; ``torch.sort`` of the batch's column
   ids (stable, as the parent design's wrapper runs it) on its own with
   CUDA events; then one call under ``torch.profiler``, its device time
   by kernel name (the stage split: sort, bounds, chunk passes, finish
   passes).
2. K7c (``ops.cavi.coo_phi_sums``) over the whole training stream of a
   full-batch fit: the same three readings.
3. K6 (``ops.topk.topn_rows``) on one 1,024-user chunk with the users'
   seen items masked, n=10: its time with CUDA events, the same under the
   profiler by kernel name, and ``matmul`` + ``index_put_`` + ``topk``
   timed the same way;
4. ``ops.topk.topn_batch`` of 16,384 users at n=10 with their seen items
   excluded (the host's pair list, the chunks, the copies back): its wall
   time on the host clock, three runs after a warm-up, and K6 on those
   16,384 users in one call (CUDA events).  Where the fused path exists,
   section 3 also times it at 8, 16, 17 and 33 item ranges.

Only the wrappers' public signatures are used, so the same script times a
parent commit unpacked beside the change.  Prints the card (nvidia-smi
name and power limit) first.  Needs a card.
"""

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (K, MILLIONSONG, SVI_BATCHES, cuda_ms, holdout,  # noqa: E402
                        kernel_split, powerlaw_coo, random_state, user_side)


def report(label, fn, reps, sort_fn=None):
    ms = cuda_ms(fn, reps)
    line = "%s: %.4f ms (CUDA events, %d calls)" % (label, ms, reps)
    if sort_fn is not None:
        line += "; torch.sort of the column ids alone %.4f ms" % cuda_ms(sort_fn, reps)
    print(line)
    rows = kernel_split(fn, reps)
    for kms, key in rows[:12]:
        print("  %9.4f ms  %s" % (kms, key[:120]))
    print("  %9.4f ms  device total (profiler)" % sum(r[0] for r in rows))


def main():
    import torch

    if not torch.cuda.is_available():
        print("split_k6_k7: needs a CUDA card", file=sys.stderr)
        return 1
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 10
    from hpfrec_tpu_torch import _cuda
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import svi as S
    from hpfrec_tpu_torch.ops import topk as T
    from hpfrec_tpu_torch.utils.data import build_csr, process_data

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("card (nvidia-smi name, power.limit):", smi)
    _cuda.load()
    dev = torch.device("cuda")
    coo = powerlaw_coo(**MILLIONSONG, seed=0)
    train, _ = holdout(coo, 0.01, seed=5)
    p = process_data(train, "val-llk", False, np.float32)
    state = random_state(p.nusers, p.nitems, np.float32, dev, 1)
    t_tab = C.side_derive(state.G_shp, state.G_rte)[0]
    b_tab = C.side_derive(state.L_shp, state.L_rte)[0]

    # -- 1. K7 at chip_smoke svi_suite's two batches
    rng = np.random.default_rng(7)
    csr_u = None
    for user_side, (rows, cols, n_rows, n_cols), per_batch in (
            (True, (p.ix_u, p.ix_i, p.nusers, p.nitems), SVI_BATCHES["users_per_batch"]),
            (False, (p.ix_i, p.ix_u, p.nitems, p.nusers), SVI_BATCHES["items_per_batch"])):
        csr = build_csr(rows, cols, p.y, n_rows, n_cols)
        if user_side:
            csr_u = csr
        side = S.epoch_side(*csr, np.float32, dev)
        perm = rng.permutation(n_rows)
        off_h = S.epoch_offsets(side.deg, perm)
        perm_d = torch.from_numpy(perm.astype(np.int32)).to(dev)
        off_d = torch.from_numpy(off_h.astype(np.int32)).to(dev)
        b = 0 if user_side else int(np.flatnonzero(perm == 0)[0]) // per_batch
        r0, r1 = b * per_batch, min(n_rows, (b + 1) * per_batch)
        e_y, e_row, e_col = S.build_epoch_buffers(side.y, side.cols, side.indptr, perm_d, off_d)
        e0, e1 = int(off_h[r0]), int(off_h[r1])
        t_loc, t_oth = (t_tab, b_tab) if user_side else (b_tab, t_tab)
        args = (t_loc, t_oth, e_y[e0:e1], e_row[e0:e1], e_col[e0:e1], off_d[r0:r1 + 1], e0,
                perm_d[r0:r1])
        name = "user batch" if user_side else "item batch (with item 0)"
        print("K7 %s: %d rows, %d nonzeros, %d distinct other-side rows of %d, longest "
              "other-side run %d" % (name, r1 - r0, e1 - e0, int(torch.unique(args[4]).numel()),
                                     t_oth.shape[0], int(torch.bincount(args[4].long()).max())))
        report("K7 " + name, lambda a=args: S.batch_phi_sums(*a), reps,
               lambda c=args[4]: torch.sort(c, stable=True))
        del side, e_y, e_row, e_col, args
        torch.cuda.empty_cache()

    # -- 2. K7c over a full-batch fit's stream
    pfit = process_data(coo, "train-llk", True, np.float32)
    st = random_state(pfit.nusers, pfit.nitems, np.float32, dev, 2)
    t_fit = C.side_derive(st.G_shp, st.G_rte)[0]
    b_fit = C.side_derive(st.L_shp, st.L_rte)[0]
    stream = C.coo_stream(user_side(pfit, dev), pfit.nitems)
    print("K7c: %d triplets, %d users, %d items" % (stream.nnz, pfit.nusers, pfit.nitems))
    report("K7c", lambda: C.coo_phi_sums(t_fit, b_fit, stream), max(3, reps // 3))
    del stream, st, t_fit, b_fit
    torch.cuda.empty_cache()

    # -- 3. K6 on one 1,024-user chunk, n=10, seen items masked
    Theta = (state.G_shp / state.G_rte)
    Beta = (state.L_shp / state.L_rte)
    users = np.random.default_rng(11).choice(p.nusers, 1024, replace=False)
    indptr, indices, _ = csr_u
    counts = np.diff(indptr)[users]
    items = np.concatenate([indices[indptr[u]:indptr[u + 1]] for u in users])
    mrows = torch.from_numpy(np.repeat(np.arange(1024), counts).astype(np.int32)).to(dev)
    mitems = torch.from_numpy(items.astype(np.int32)).to(dev)
    th = Theta[torch.from_numpy(users).to(dev)].contiguous()

    def library():
        sc = torch.matmul(th, Beta.T)
        sc.index_put_((mrows.long(), mitems.long()), torch.tensor(-torch.inf, device=dev))
        return torch.topk(sc, 10)

    print("K6: 1,024 users x %d items, k=%d, %d seen pairs, n=10" % (Beta.shape[0], K,
                                                                     mitems.numel()))
    report("K6 topn_rows", lambda: T.topn_rows(th, Beta, mrows, mitems, 10), reps)
    report("K6 library (matmul + index_put_ + topk)", library, reps)
    if hasattr(T, "_item_ranges"):  # the fused path: its time by range count
        chosen = T._item_ranges
        tiles = -(-Beta.shape[0] // T._FUSED_BN)
        for want in (8, 16, 17, 33):
            per = -(-tiles // want)
            T._item_ranges = lambda *a, per=per: (per * T._FUSED_BN, -(-tiles // per))
            print("K6 fused, %d ranges (%d blocks): %.4f ms (CUDA events)"
                  % (want, want * 16, cuda_ms(lambda: T.topn_rows(th, Beta, mrows, mitems, 10),
                                              reps)))
        T._item_ranges = chosen

    # -- 4. topn_batch of 16,384 users (host pair list, chunks, copies back)
    Theta_h = Theta.cpu().numpy()
    serve = np.random.default_rng(12).choice(p.nusers, 16_384, replace=False)
    args = (Theta_h, Beta, serve, 10, indptr[:-1], indices, np.diff(indptr))
    T.topn_batch(*args)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.topn_batch(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print("topn_batch, 16,384 users, n=10, seen items excluded: wall %s ms (host clock, "
          "synchronized)" % ", ".join("%.3f" % w for w in walls))
    # its device part: K6 on the 16,384 users in one call
    counts = np.diff(indptr)[serve]
    items = np.concatenate([indices[indptr[u]:indptr[u + 1]] for u in serve])
    mrows = torch.from_numpy(np.repeat(np.arange(16_384), counts).astype(np.int32)).to(dev)
    mitems = torch.from_numpy(items.astype(np.int32)).to(dev)
    th = Theta[torch.from_numpy(serve).to(dev)].contiguous()
    print("K6 on 16,384 users in one call: %.4f ms (CUDA events)"
          % cuda_ms(lambda: T.topn_rows(th, Beta, mrows, mitems, 10), 3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
