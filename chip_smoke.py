"""Smoke run of hpfrec_tpu_torch on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its lines; any failure propagates and the script exits
non-zero, with no result line):

1. device and build: the card (nvidia-smi name and power limit), the
   kernel build from csrc/ and whether the native host helpers loaded;
2. kernel checks: each CUDA kernel against its plain PyTorch version on
   the card, float32 and float64, k=50, on a ~1M-nonzero power-law data
   set: the full-batch kernels over its ELL layouts, the SVI kernels over
   one user batch and one item batch (the SVI blend with both
   ``blend_all_scalers`` values) and the COO llk over a held-out set; the
   blocked-COO engine's phi sums (K7c) over the whole stream, and the
   bfloat16-table forms of K1 and K3;
3. the full-batch path at the MillionSong TasteProfile shape (1,019,318
   users x 376,768 items, 38.7M nonzeros, k=50, float32; data made here
   from a seed): ``HPF(...).fit`` with train-llk checks, launch counters,
   then ``topN`` and ``predict``; then every full-batch kernel checked and
   timed against its plain version at the shapes of that fit, and the
   kernels' digamma against scipy's (and the stepwise form it replaced)
   on a log sweep of [1e-4, 1e7] and on the fit's shapes;
3b. the SVI path at the same shape, 1% of the triplets held out as a
   validation set: ``HPF(users_per_batch=100_000, items_per_batch=40_000,
   stop_crit='val-llk', ...).fit(train, val_set=val)``, ``eval_llk``,
   ``topN``, ``predict``, and a short SVI fit with train-llk checks; launch
   counters of each fit and of ``eval_llk``, each from its own run; then
   every SVI kernel checked and timed at the fit's shapes (a user batch,
   the item batch that holds the rank-1 item, the validation set), on the
   fitted state, with K7's split by stage at both batches (torch.profiler;
   its sort alone with CUDA events);
3c. the other two stopping paths at the same shape, one user epoch each:
   a diff-norm fit (``theta_diff_norm``, K11) and a maxiter fit with the
   validation set and verbose output (its final eval's
   ``rowsum_dot_rows``, K11);
3d. serving on the SVI fit: ``topN_batch(n=10)`` for 16,384 users (K6's
   fused path, one chunk), ``topN_batch(n=2000)`` for 1,024 of them (K6's
   three-kernel path; its first 10 equal to n=10's),
   ``utils.evaluation.ranking_metrics`` (k=10) over 16,384 held-out
   users, ``predicted_rate_stats`` and ``roc_auc`` over the held-out set
   and ``predict`` of 100,000 pairs (K11); ms per 1,024 users and the
   device/host split (the wall of each call on its own, the device split
   from a second run under torch.profiler);
3e. K6, K10 and K11 checked and timed against their plain versions at
   those shapes: one 1,024-user chunk at the full catalog with the fit's
   seen lists at n = 10 (the fused path, also held bit for bit against the
   three-kernel path at n = 10 and timed beside it and the library call)
   and n = 2,000 (the three-kernel path, also split by launch: score, mask,
   select; one user with fewer than 2,000 unseen items), the fold-in of the
   heaviest user and of the user nearest 10 items (the heaviest also as HPF
   calls it, from and to host arrays, and over 100 iterations), 4M pairs
   (and the 100,000 of ``predict`` and the held-out set's, the serving
   sizes), the diff norm and the held-out rowsum correction;
3f. online updates on the SVI fit (``reindex=False``): ``partial_fit`` of
   a 100,000-user and a 40,000-item batch of its own triplets, growth by
   1,000 users, ``predict_factors`` for 256 histories (the heaviest
   included), ``add_user`` for 64 new users by fold-in and 2 existing ones
   with ``update_all_params``; each call's wall time and its split
   (``predict_factors`` and ``add_user``, many small calls: the wall and
   each call's time from a run on its own, the split from a second run
   under torch.profiler; the others from one run under the profiler);
3g. the blocked-COO engine at the shape of phase 3 (``engine='coo'``, the
   same seed, options and data): its llk at the checks beside phase 3's
   ELL fit and the largest relative difference of the factors, s/iteration,
   launch counters (K7c and K5 launch, no ELL kernel does), then K7c
   checked and timed at the fit's shapes, with its split by stage, and K5
   over the fit's train stream (its train metric, 38.7M triplets);
3h. the ELL fit of phase 3 with ``gather_dtype='bfloat16'``: its llk beside
   the float32-table fit's, s/iteration, launch counters, then the
   bfloat16 forms of K1 and K3 checked and timed at the fit's shapes;
3i. persistence at that shape: a 5-iteration fit with ``checkpoint_every=5``
   resumed to 10 against phase 3's fit, the wall of each checkpoint write;
   ``save`` and ``load`` of the SVI fit after phase 3f's updates, the wall
   of each, and ``topN_batch`` of 1,024 users equal after the load;
3j. data parallel (``HPF(mesh=...)``, ranks that this script starts as
   processes of its own, ``--dp-rank``, after the kernels are built):
   (a) an NCCL mesh of every card (one on most machines) fits phase 3's
   ELL and COO fits and phase 3b's SVI fit at the MillionSong shape and a
   partial_fit, held against the one-device fits (ELL bit-equal); s/
   iteration beside the one-device figure; K12's exchanges timed with CUDA
   events and their bytes; (b) two ranks on the one card over gloo, named
   (NCCL refuses two ranks on one card), fit phase 2's data set in float64
   in full batch (both engines), SVI with val-llk and a partial_fit: the
   ranks bit-equal to each other, ELL bit-equal to the one-rank card fit,
   the others within stated limits; (c) with two or more cards, (a) is
   (b) over NCCL at the MillionSong shape; every rank exits with its
   group up, torn down by the exit handler of ``initialize``, and must be
   gone within ``DP_EXIT_S`` of writing its results;
3k. the table-sharded engine (``HPF(mesh=..., shard_tables=True)``, K13):
   (a) two ranks on the one card over gloo, named, fit phase 3's fit at the
   MillionSong shape (10 iterations, train-llk every 5), and phase 3h's
   with bfloat16 tables: the ranks bit-equal, the llk at the checks and the
   factors held against the one-device fits within stated limits, the
   launch counters; then every rank, on its fitted state, holds the ring
   phi sums (K13a, the real ring), the train metric (K13c), K3's pad-row
   form and the step (K13b) against their plain versions and times them,
   and splits an iteration by part (K1 per ring offset, the host-staged
   ring, K2, K3's pad-row form, the colsum exchange; host_pack of the
   sharded layouts); K1 runs once a ring offset, in no other form; (b) on
   the NCCL mesh of 3j (a) (one rank on most machines, where the ring is K1
   a ring offset with no exchange: ``HPF`` takes the engine only over two
   or more ranks, so it is called directly), from the ELL fit's state, the
   step, the ring phi sums and the train metric on the plan of each
   candidate sub-tile window (untiled, JAX's 40 MB, 25 MB) beside the
   one-device ELL step, and on the card's window (the fits') the same
   parts as (a) and the step held against the one-device step; (c) each
   rank's half of the ring phi sums (two
   ranks, every rank in this process, the ring's shards handed in) and
   K3's pad-row form (both tab dtypes) against their plain versions on
   phase 2's data set, float32 and float64; (d) with two or more cards,
   (a) over NCCL on every card (``--ts-cards`` runs (d) alone, with the
   one-device fits it is held against);
4. agreement and determinism at a small size, full batch and alternating
   SVI with val-llk, the COO engine in full batch and SVI, the ELL engine
   with bfloat16 tables: two card fits are bit-identical, and the card
   agrees with the CPU path; then (4b) a sequence of ``partial_fit``,
   ``add_user`` and ``topN_batch`` on the card against the CPU path from
   the same arrays; (4c) full-batch (both engines) and SVI fits resumed
   from a checkpoint equal the uninterrupted ones bit for bit, the
   ``save_folder`` export, and a ``profile_dir`` trace that names a port
   kernel;
5. a JSON line of the kernels (time, plain version's time, bound, launches
   on the main paths, in all and by path), and the result line.

Without a CUDA device, or without the package beside it, it exits non-zero.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

MILLIONSONG = dict(nU=1_019_318, nI=376_768, nnz=38_700_000)
K = 50
# SVI batch sizes of the full-size fit, and of the ~1M-nonzero checks
SVI_BATCHES = dict(users_per_batch=100_000, items_per_batch=40_000)
SMALL_BATCHES = dict(users_per_batch=2_600, items_per_batch=1_000)
# kernel vs plain version on the card: |kernel - plain| <= atol + rtol |plain|,
# atol = ATOL_FRAC * max|plain|.  float32: sums over up to 8192 slots (K1) or
# millions (K7's rank-1 item row) and the hand-written digamma differ from
# PyTorch's in order and rounding.
TOL = {"float32": dict(rtol=1e-4, atol_frac=1e-6),
       "float64": dict(rtol=1e-10, atol_frac=1e-12)}
# card vs CPU path at a small size (phase 4), max relative difference of the
# llk trajectory and of every element of Theta and Beta.  Full batch, 60
# iterations, measured on an H100: float64 llk 4.4e-15, Theta 3.7e-12, Beta
# 1.3e-11; float32 llk 3.9e-7, Theta 4.97e-3, Beta 1.08e-3.  In float32 the
# factors drift further apart than the llk: 60 iterations grow a ~1e-6
# one-step difference, most in the smallest entries (relative to the
# largest entry the gap is 1.7e-4).
AGREE = {"float32": dict(llk=2e-5, factors=6e-3),
         "float64": dict(llk=1e-9, factors=1e-9)}
# the same for 10 alternating SVI epochs with val-llk checks every 2,
# measured on an H100: float64 llk 1.1e-16, Theta 9.5e-15, Beta 8.9e-15;
# float32 llk 4.3e-8, Theta 7.6e-6, Beta 8.8e-6
AGREE_SVI = {"float32": dict(llk=1e-6, factors=5e-5),
             "float64": dict(llk=1e-12, factors=1e-11)}
# card vs CPU from the same fitted arrays, after two partial_fit calls, a
# growth and two add_user calls (phase 4b): max relative difference of the
# six state arrays, Theta and Beta and of a fold-in's Theta and G, max
# absolute difference of its phi; top-n indices must be equal.  Measured on
# an H100: float32 8.3e-7 (states), 7.2e-7 (fold-in), 2.4e-7 (phi); float64
# 2.4e-15, 2.4e-15, 6.7e-16.
AGREE_ONLINE = {"float32": 5e-6, "float64": 1e-13}
# the same for fits with bfloat16 gather tables (10 iterations, checks every
# 5): the card's exp differs from PyTorch's CPU exp by a few float32 ulps,
# and where that straddles a bfloat16 rounding boundary a table entry moves
# by a whole bfloat16 step (2^-8 to 2^-7 of it); those steps feed the next
# iteration, so the smallest factors part by percents while the llk agrees.
# Measured on an H100, float32 state: llk 9.3e-6, Theta 3.1e-2, Beta 2.3e-2
AGREE_BF16 = {"float32": dict(llk=1e-4, factors=1e-1),
              "float64": dict(llk=1e-4, factors=1e-1)}
# the COO fit against the ELL fit at the MillionSong shape (float32, 10
# iterations, the same seed): the same math with sums in other orders; max
# relative difference of the llk at each check
COO_VS_ELL_LLK = 1e-5
# the bfloat16 fit's llk against the float32 fit's at the same shape: a
# sanity bound (the tables carry 2^-8 relative rounding)
BF16_VS_F32_LLK = 1e-2
# K3's bfloat16 tab against its plain version: one bfloat16 step, 2^-8 to
# 2^-7 of the value (8 significant bits)
BF16_TAB_RTOL = 2.0 ** -7
# a fit resumed from a checkpoint against the uninterrupted fit at the
# MillionSong shape (float32): the same launches on the same values, so
# bit-equal is expected; a difference would come from a carry derived from
# the loaded state rather than made by the update
RESUME_LIMIT = 1e-6
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
REPLACES = {
    "ell_phi_sums": ("hpfrec_tpu_torch/csrc/ell_phi_sums.cu", "hpfrec_tpu/ops/ell.py:447"),
    "segment_table_sums": ("hpfrec_tpu_torch/csrc/segment_sums.cu", "hpfrec_tpu/ops/ell.py:574"),
    "table_update": ("hpfrec_tpu_torch/csrc/table_update.cu", "hpfrec_tpu/ops/cavi.py:50"),
    "table_derive": ("hpfrec_tpu_torch/csrc/table_update.cu", "hpfrec_tpu/ops/ell.py:743"),
    "ell_llk": ("hpfrec_tpu_torch/csrc/ell_llk.cu", "hpfrec_tpu/ops/metrics.py:79"),
    "coo_llk": ("hpfrec_tpu_torch/csrc/coo_llk.cu", "hpfrec_tpu/ops/metrics.py:22"),
    "batch_phi_sums": ("hpfrec_tpu_torch/csrc/svi_phi_sums.cu", "hpfrec_tpu/ops/svi.py:31"),
    "svi_update": ("hpfrec_tpu_torch/csrc/svi_update.cu", "hpfrec_tpu/ops/svi.py:49"),
    "epoch_gather": ("hpfrec_tpu_torch/csrc/svi_epoch.cu", "hpfrec_tpu/ops/svi.py:153"),
    "topn": ("hpfrec_tpu_torch/csrc/topn.cu", "hpfrec_tpu/ops/topk.py:39"),
    "topn_large": ("hpfrec_tpu_torch/csrc/topn.cu", "hpfrec_tpu/ops/topk.py:39"),
    "fold_in": ("hpfrec_tpu_torch/csrc/fold_in.cu", "hpfrec_tpu/ops/svi.py:313"),
    "predict_pairs": ("hpfrec_tpu_torch/csrc/pair_ops.cu", "hpfrec_tpu/ops/metrics.py:182"),
    "theta_diff_norm": ("hpfrec_tpu_torch/csrc/pair_ops.cu", "hpfrec_tpu/ops/metrics.py:195"),
    "rowsum_dot_rows": ("hpfrec_tpu_torch/csrc/pair_ops.cu", "hpfrec_tpu/ops/metrics.py:170"),
    "coo_phi_sums": ("hpfrec_tpu_torch/csrc/svi_phi_sums.cu", "hpfrec_tpu/ops/cavi.py:92"),
    "ell_phi_sums_bf16": ("hpfrec_tpu_torch/csrc/ell_phi_sums.cu", "hpfrec_tpu/ops/ell.py:447"),
    "ell_phi_sums_offset": ("hpfrec_tpu_torch/csrc/ell_phi_sums.cu", "hpfrec_tpu/ops/ell.py:447"),
    "ell_phi_sums_offset_bf16": ("hpfrec_tpu_torch/csrc/ell_phi_sums.cu",
                                 "hpfrec_tpu/ops/ell.py:447"),
    "table_update_bf16": ("hpfrec_tpu_torch/csrc/table_update.cu", "hpfrec_tpu/ops/ell.py:804"),
    "table_derive_bf16": ("hpfrec_tpu_torch/csrc/table_update.cu", "hpfrec_tpu/ops/ell.py:752"),
    "table_update_pad": ("hpfrec_tpu_torch/csrc/table_update.cu",
                         "hpfrec_tpu/parallel/table_sharded.py:432"),
    "ring_table_sums": ("hpfrec_tpu_torch/parallel/table_sharded.py",
                        "hpfrec_tpu/parallel/table_sharded.py:309"),
    "table_sharded_step": ("hpfrec_tpu_torch/parallel/table_sharded.py",
                           "hpfrec_tpu/parallel/table_sharded.py:357"),
    "table_sharded_llk_parts": ("hpfrec_tpu_torch/parallel/table_sharded.py",
                                "hpfrec_tpu/parallel/table_sharded.py:566"),
}
STATE_NAMES = ("Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte", "k_rte",
               "t_rte")
SERVE_USERS = 16_384
ONLINE = dict(user_batch=100_000, item_batch=40_000, grow=1_000, histories=256, new_users=64,
              all_params=2)


def powerlaw_coo(nU, nI, nnz, seed):
    """User-sorted COO with Zipf item popularity (bench.py:45-54), as a scipy
    coo_array so that no pandas is needed.  Item 0 is the rank-1 item."""
    from scipy.sparse import coo_array

    rng = np.random.default_rng(seed)
    iu = np.sort(rng.integers(0, nU, nnz)).astype(np.int32)
    ranks = np.arange(1, nI + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    ii = rng.choice(nI, size=nnz, p=p).astype(np.int32)
    y = (rng.poisson(2.0, nnz) + 1).astype(np.float32)
    return coo_array((y, (iu, ii)), shape=(nU, nI))


def counts_coo(nU, nI, nnz, seed):
    """Small uniform counts with (user, item) pairs made unique."""
    from scipy.sparse import coo_array

    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, nU, nnz) * nI + rng.integers(0, nI, nnz))
    y = (rng.poisson(3.0, len(key)) + 1).astype(np.float32)
    return coo_array((y, (key // nI, key % nI)), shape=(nU, nI))


def holdout(coo, frac, seed):
    """Split a coo_array into (train, val) by a seeded mask over triplets."""
    from scipy.sparse import coo_array

    keep = np.random.default_rng(seed).random(coo.nnz) >= frac
    part = lambda m: coo_array((coo.data[m], (coo.row[m], coo.col[m])),  # noqa: E731
                               shape=coo.shape)
    return part(keep), part(~keep)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, dtype_name="float32"):
    """Least time (ms) on an H100 for moving ``nbytes`` and doing ``ops``,
    and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, got, ref, dtype_name):
    """Max abs/rel error of kernel vs plain; raises beyond tolerance."""
    import torch

    got = [got] if isinstance(got, torch.Tensor) else list(got)
    ref = [ref] if isinstance(ref, torch.Tensor) else list(ref)
    tol = TOL[dtype_name]
    max_abs = max_rel = 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs {r.shape}/{r.dtype}")
        g64, r64 = g.double(), r.double()
        if not torch.isfinite(g64).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = (g64 - r64).abs()
        atol = tol["atol_frac"] * float(r64.abs().max())
        bad = err > atol + tol["rtol"] * r64.abs()
        max_abs = max(max_abs, float(err.max()) if err.numel() else 0.0)
        max_rel = max(max_rel, float((err / r64.abs().clamp_min(1e-300)).max())
                      if err.numel() else 0.0)
        if bool(bad.any()):
            raise AssertionError(f"{name} {dtype_name}: kernel differs from plain "
                                 f"(max abs {max_abs:.3e}, max rel {max_rel:.3e}, "
                                 f"rtol {tol['rtol']})")
    return max_abs, max_rel


def bits_check(name, got, ref, dtype_name):
    """Kernel and plain version that add in one order: the same bits."""
    import torch

    got = [got] if isinstance(got, torch.Tensor) else list(got)
    ref = [ref] if isinstance(ref, torch.Tensor) else list(ref)
    if len(got) != len(ref) or not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"{name} {dtype_name}: kernel and plain version differ in bits")
    return 0.0, 0.0


def run_cases(cases, dtype_name, reps, label=""):
    """Check and time each case: name -> (kernel fn, plain fn, (bytes, ops),
    library fn or None).  Returns {name: dict}."""
    import torch

    out = {}
    for name, (kern, plain, work, library, *check) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err_abs, err_rel = (check[0] if check else compare)(name, got, ref, dtype_name)
        ms, plain_ms = cuda_ms(kern, reps), cuda_ms(plain, reps)
        lib_ms = cuda_ms(library, reps) if library is not None else None
        b_ms, b_by = bound(*work, dtype_name)
        out[name] = dict(max_abs_err=err_abs, max_rel_err=err_rel, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, bytes=int(work[0]),
                         ops=int(work[1]))
        print(f"  {name:20s} {dtype_name}{label}: max abs {err_abs:.3e}  max rel {err_rel:.3e}"
              f"  (rtol {TOL[dtype_name]['rtol']})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"  bound {b_ms:.4f} ms ({b_by}; {work[0]:.4g} bytes, {work[1]:.4g} ops)"
              + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else ""))
    return out


def k1_layout_bytes(*layouts):
    """The bytes K1 must read of ELL layouts: each segment's row id, every
    slot's value (a zero marks padding), the column id of each real slot,
    and its table of the buckets."""
    from hpfrec_tpu_torch.ops import ell as E

    return sum(nbytes(b.rows, b.vals) + 4 * int((b.vals != 0).sum())
               for lay in layouts for b in lay.buckets) + sum(
        nbytes(E._bucket_table(lay)[0]) for lay in layouts)


def bucket_by_bucket(t_self, t_other, lay):
    """K1's segment sums of a layout with one launch a bucket
    (``bucket_phi_sums``): the bits of one launch a side or a ring offset;
    no path runs it, the checks time it beside them."""
    import torch

    from hpfrec_tpu_torch.ops import ell as E

    seg = torch.empty((lay.n_segs, t_self.shape[1]), dtype=E._acc_dtype(t_self.dtype),
                      device=t_self.device)
    for b in lay.buckets:
        E.bucket_phi_sums(t_self, t_other, b.rows, b.cols, b.vals, b.col_off,
                          seg[b.start:b.start + b.rows.shape[0]])
    return seg


def kernel_suite(lay_u, lay_i, state, dtype_name, reps):
    """The full-batch kernels against their plain versions on the card, over
    what one iteration runs (both sides; K4: one check).  ``state``: a
    VariationalState on the card."""
    import torch

    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M

    hp = Hyperparams(k=state.k)
    k = state.k
    t_tab, theta_colsum = C._side_derive_plain(state.G_shp, state.G_rte)
    b_tab, beta_colsum = C._side_derive_plain(state.L_shp, state.L_rte)
    Theta, Beta = state.G_shp / state.G_rte, state.L_shp / state.L_rte
    sides = ((t_tab, b_tab, lay_u), (b_tab, t_tab, lay_i))

    def phi_plain(ts, to, lay):
        return torch.cat([E._bucket_phi_sums_plain(ts, to, b.rows, b.cols, b.vals, b.col_off)
                          for b in lay.buckets])

    segs = [phi_plain(*side) for side in sides]
    su, si = (E._segment_table_sums_plain(seg, side[2]) for seg, side in zip(segs, sides))
    upd = ((su, state.k_rte, beta_colsum, hp.a, hp.k_shp, hp.add_k_rte),
           (si, state.t_rte, theta_colsum, hp.c, hp.t_shp, hp.add_t_rte))
    pairs = ((state.G_shp, state.G_rte), (state.L_shp, state.L_rte))
    seg_rows = [torch.cat([b.rows.long() for b in side[2].buckets]) for side in sides]

    def flat(*results):
        return [t for r in results for t in (r if isinstance(r, tuple) else (r,))]

    # work of one call, for the bound: each input read once, each output
    # written once; operations per real nonzero or table element
    nnz = sum(int((b.vals != 0).sum()) for b in lay_u.buckets)
    tabs = nbytes(state.G_shp) + nbytes(state.L_shp)
    elems = state.G_shp.numel() + state.L_shp.numel()
    seg_bytes = sum(nbytes(s) for s in segs)
    k1_lay = k1_layout_bytes(lay_u, lay_i)
    llk_parts = sum(-(-b.cols.shape[0] // (8 // E._warps_per_segment(b.cols.shape[1])))
                    for b in lay_u.buckets if b.cols.numel())
    llk_lay = sum(nbytes(b.rows, b.vals) + 4 * int((b.vals != 0).sum()) for b in lay_u.buckets)
    work = {
        # two exp tables per side, K1's layout bytes, the segment sums; 4k
        # flops per slot
        "ell_phi_sums": (2 * tabs + k1_lay + seg_bytes, 2 * nnz * 4 * k),
        # segment sums and index arrays in, tables out; the split-row adds
        "segment_table_sums": (seg_bytes + sum(nbytes(lay.inv_perm, lay.split_indptr,
                                                      lay.split_seg_pos)
                                               for lay in (lay_u, lay_i)) + tabs,
                               sum(s.numel() for s in segs) - elems),
        # sums in; shp, rte, tab out; ~35 operations an element (digamma,
        # log, exp, the rate and mean)
        "table_update": (4 * tabs, 35 * elems),
        # shp, rte in; tab out; ~33 operations an element
        "table_derive": (3 * tabs, 33 * elems),
        # both tables, the user layout as K1's walk reads it (row ids,
        # values, the real slots' column ids), the partials; a dot (2k) and
        # ~6 operations a slot
        "ell_llk": (tabs + llk_lay + 24 * llk_parts, nnz * (2 * k + 6)),
    }

    def index_add():
        return [torch.zeros(side[2].n_rows, k, dtype=seg.dtype, device=seg.device)
                .index_add_(0, rows, seg) for seg, side, rows in zip(segs, sides, seg_rows)]

    cases = {
        "ell_phi_sums": (lambda: flat(*(E.all_bucket_sums(*side) for side in sides)),
                         lambda: flat(*(phi_plain(*side) for side in sides)), None),
        "segment_table_sums": (
            lambda: flat(*(E.segment_table_sums(seg, side[2]) for seg, side in zip(segs, sides))),
            lambda: flat(*(E._segment_table_sums_plain(seg, side[2])
                           for seg, side in zip(segs, sides))), index_add),
        "table_update": (lambda: flat(*(C.side_update(*u) for u in upd)),
                         lambda: flat(*(C._side_update_plain(*u) for u in upd)), None),
        "table_derive": (lambda: flat(*(C.side_derive(*p) for p in pairs)),
                         lambda: flat(*(C._side_derive_plain(*p) for p in pairs)), None),
        "ell_llk": (lambda: M.ell_llk_rmse_sums(Theta, Beta, lay_u).sum(0),
                    lambda: torch.cat([M._bucket_llk_plain(Theta, Beta, b.rows, b.cols,
                                                           b.vals, b.col_off, False)
                                       for b in lay_u.buckets]).sum(0), None),
    }
    # K2 adds in its plain version's order: held to the bits
    cases = {n: (kern, plain, work[n], lib) + ((bits_check,) if n == "segment_table_sums" else ())
             for n, (kern, plain, lib) in cases.items()}
    out = run_cases(cases, dtype_name, reps)
    # the same sums a bucket a launch: the same bits; timed beside, but no
    # path runs it (the table-sharded ring launches K1 once a ring offset)
    bucket = {"ell_phi_sums_bucket": (lambda: flat(*(bucket_by_bucket(*side) for side in sides)),
                                      lambda: flat(*(E.all_bucket_sums(*side) for side in sides)),
                                      work["ell_phi_sums"], None, bits_check)}
    run_cases(bucket, dtype_name, reps, " (a bucket a launch, against one a side)")
    return out


def digamma_sweep(sets, dev, label):
    """The kernels' digamma (K3's and K10's, ``ops.cavi.kernel_digamma``)
    and the stepwise form it replaced in K3 against
    ``scipy.special.digamma`` in float64 on the host, in float32 and float64
    over each (name, values) of ``sets``: the max and mean error in ulp of
    the dtype, and where the max is.  Raises if the kernels' form is worse
    than the stepwise one in either figure."""
    import torch
    from scipy import special

    from hpfrec_tpu_torch.ops import cavi as C

    out = {}
    for dtype in (np.float32, np.float64):
        for name, values in sets:
            x = np.asarray(values, dtype=dtype)
            ref = special.digamma(x.astype(np.float64))
            ulp = np.spacing(np.abs(ref).astype(dtype)).astype(np.float64)
            xt = torch.from_numpy(x).to(dev)
            row = {}
            for form, stepwise in (("kernel", False), ("stepwise", True)):
                err = np.abs(C.kernel_digamma(xt, stepwise).cpu().numpy().astype(np.float64)
                             - ref) / ulp
                at = int(np.argmax(err))
                row[form] = dict(max_ulp=float(err.max()), mean_ulp=float(err.mean()),
                                 at=float(x[at]))
            print("[%s] digamma, %s, %s (%d values): kernel max %.2f ulp (x=%.9g), mean %.4f; "
                  "stepwise max %.2f ulp (x=%.9g), mean %.4f"
                  % (label, np.dtype(dtype).name, name, x.size, row["kernel"]["max_ulp"],
                     row["kernel"]["at"], row["kernel"]["mean_ulp"], row["stepwise"]["max_ulp"],
                     row["stepwise"]["at"], row["stepwise"]["mean_ulp"]))
            if (row["kernel"]["max_ulp"] > row["stepwise"]["max_ulp"]
                    or row["kernel"]["mean_ulp"] > row["stepwise"]["mean_ulp"]):
                raise AssertionError(f"digamma {name} {dtype}: worse than the stepwise form: "
                                     f"{row}")
            out["%s %s" % (np.dtype(dtype).name, name)] = row
    return out


def coo_llk_case(Theta, Beta, data):
    """K5's ``run_cases`` entry over ``data`` (a BlockedCOO on the card):
    the kernel's partials and the plain version's, block by block, each
    summed; its work: the triplets, and each distinct row of either table
    read once; a dot, a log and a few more operations a real triplet."""
    import torch

    from hpfrec_tpu_torch.ops import metrics as M

    y, iu, ii = (a.reshape(-1) for a in data)
    k = Theta.shape[1]
    work = (nbytes(y, iu, ii) + (int(torch.unique(iu).numel()) + int(torch.unique(ii).numel()))
            * k * Theta.element_size(), int((y > 0).sum()) * (4 * k + 8))
    return (lambda: M.llk_rmse_sums(Theta, Beta, data).sum(0),
            lambda: torch.cat([M._coo_llk_plain(Theta, Beta, data.y[b], data.ix_u[b],
                                                data.ix_i[b], False)
                               for b in range(data.y.shape[0])]).sum(0),
            work, None)


def svi_suite(pdata, val, state, batches, dtype_name, reps, blend_all=(False,), label=""):
    """The SVI kernels and the COO llk against their plain versions on the
    card, at the shapes of an epoch of ``pdata`` (host ProcessedData) with
    the given batch sizes: K9 over a user epoch and an item epoch, K7 and K8
    over one user batch and the item batch that holds item 0, K5 over
    ``val`` (a BlockedCOO on the card).  ``state``: a VariationalState on
    the card."""
    import torch

    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import svi as S
    from hpfrec_tpu_torch.utils.data import build_csr

    dev = state.G_shp.device
    dt = state.G_shp.dtype
    k = state.k
    hp = Hyperparams(k=k)
    rng = np.random.default_rng(7)
    sides = []
    for user_side, (rows, cols, n_rows, n_cols), per_batch in (
            (True, (pdata.ix_u, pdata.ix_i, pdata.nusers, pdata.nitems), batches["users_per_batch"]),
            (False, (pdata.ix_i, pdata.ix_u, pdata.nitems, pdata.nusers), batches["items_per_batch"])):
        indptr, ind, dat = build_csr(rows, cols, pdata.y, n_rows, n_cols)
        side = S.epoch_side(indptr, ind, dat, pdata.y.dtype, dev)
        perm = rng.permutation(n_rows)
        off_h = S.epoch_offsets(side.deg, perm)
        perm_d = torch.from_numpy(perm.astype(np.int32)).to(dev)
        off_d = torch.from_numpy(off_h.astype(np.int32)).to(dev)
        # the user batch: the first; the item batch: the one with item 0
        b = 0 if user_side else int(np.flatnonzero(perm == 0)[0]) // per_batch
        r0, r1 = b * per_batch, min(n_rows, (b + 1) * per_batch)
        sides.append(dict(user_side=user_side, side=side, perm=perm_d, off=off_d, off_h=off_h,
                          r0=r0, r1=r1, mult=float(S.batch_multipliers(
                              n_rows, per_batch, pdata.y.dtype)[b])))

    t_tab, theta_colsum = C.side_derive(state.G_shp, state.G_rte)
    b_tab, beta_colsum = C.side_derive(state.L_shp, state.L_rte)
    for s in sides:
        s["epoch"] = S.build_epoch_buffers(s["side"].y, s["side"].cols, s["side"].indptr,
                                           s["perm"], s["off"])
        e0, e1 = int(s["off_h"][s["r0"]]), int(s["off_h"][s["r1"]])
        t_loc, t_oth = (t_tab, b_tab) if s["user_side"] else (b_tab, t_tab)
        s["phi_args"] = (t_loc, t_oth, *(a[e0:e1] for a in s["epoch"]),
                         s["off"][s["r0"]:s["r1"] + 1], e0, s["perm"][s["r0"]:s["r1"]])
        s_loc, s_oth, omask = S.batch_phi_sums(*s["phi_args"])
        lmask = S.build_row_mask(t_loc.shape[0], s["perm"][s["r0"]:s["r1"]])
        su, si, umask, imask = ((s_loc, s_oth, lmask, omask) if s["user_side"]
                                else (s_oth, s_loc, omask, lmask))
        s["upd_args"] = (state, su, si, umask, imask, 0.37, s["mult"], hp, s["user_side"])
        s["colsum"] = beta_colsum if s["user_side"] else theta_colsum
        s["nnz_b"] = e1 - e0
        s["oth_rows"] = int(torch.unique(s["phi_args"][4]).numel())
        print("  %s batch: %d rows, %d nonzeros, %d distinct other-side rows"
              % ("user" if s["user_side"] else "item (with item 0)", s["r1"] - s["r0"],
                 s["nnz_b"], s["oth_rows"]))
        print("  K7 split of that batch (torch.profiler, device ms a call): %s; torch.sort of "
              "its column ids alone %.4f ms (CUDA events)"
              % (k7_split(lambda a=s["phi_args"]: S.batch_phi_sums(*a), reps),
                 cuda_ms(lambda c=s["phi_args"][4]: torch.sort(c, stable=True), reps)))

    def flat(results):
        return [t for r in results for t in r]

    it = state.G_shp.element_size()
    row_b = k * it
    # work of one call, for the bound: each input read once, each output
    # written once, operations per nonzero or table element
    epoch_bytes = sum(nbytes(s["side"].y, s["side"].cols, s["side"].indptr, s["perm"],
                             s["off"], *s["epoch"]) for s in sides)
    # ~4 integer operations a position (its source offset), and a row
    # search (2 log2 n) a tile of 2,048 positions
    epoch_ops = sum(4 * s["side"].y.numel() + -(-s["side"].y.numel() // 2048)
                    * 2 * int(np.log2(max(s["perm"].numel(), 2))) for s in sides)
    # the batch's triplets, bounds and rows; the t_loc rows of the batch and
    # the t_oth rows it touches; both sums and the mask out; a dot and two
    # k-wide multiply-adds per triplet
    phi_bytes = sum(s["nnz_b"] * (8 + it) + (s["r1"] - s["r0"]) * (row_b + 8)
                    + s["oth_rows"] * row_b + nbytes(s["phi_args"][0], s["phi_args"][1])
                    + s["phi_args"][1].shape[0] for s in sides)
    phi_ops = sum(s["nnz_b"] * (6 * k + 2) for s in sides)
    # local side: shp, sums, scaler, mask in; global side: shp, rte, sums,
    # scaler, mask in; both: shp, rte, scaler out; ~10 operations an element
    upd_bytes = upd_ops = 0
    for s in sides:
        n_l, n_g = ((state.G_shp.shape[0], state.L_shp.shape[0]) if s["user_side"]
                    else (state.L_shp.shape[0], state.G_shp.shape[0]))
        upd_bytes += ((2 * n_l + 3 * n_g) * row_b + (n_l + n_g) * (it + 1)
                      + 2 * (n_l + n_g) * row_b + (n_l + n_g) * it)
        upd_ops += 10 * (n_l + n_g) * k
    Theta, Beta = state.G_shp / state.G_rte, state.L_shp / state.L_rte

    cases = {
        "epoch_gather": (
            lambda: flat(S.build_epoch_buffers(s["side"].y, s["side"].cols, s["side"].indptr,
                                               s["perm"], s["off"]) for s in sides),
            lambda: flat(S._build_epoch_buffers_plain(s["side"].y, s["side"].cols,
                                                      s["side"].indptr, s["perm"], s["off"])
                         for s in sides),
            (epoch_bytes, epoch_ops), None),
        "batch_phi_sums": (
            lambda: flat(S.batch_phi_sums(*s["phi_args"]) for s in sides),
            lambda: flat(S._batch_phi_sums_plain(*s["phi_args"][:5]) for s in sides),
            (phi_bytes, phi_ops), None),
        "coo_llk": coo_llk_case(Theta, Beta, val),
    }
    out = run_cases(cases, dtype_name, reps, label)
    for ba in blend_all:
        case = {"svi_update": (
            lambda: flat(S.svi_update(*s["upd_args"], ba, s["colsum"]) for s in sides),
            lambda: flat(S._svi_update_math(*s["upd_args"], ba) for s in sides),
            (upd_bytes, upd_ops), None)}
        out.update(run_cases(case, dtype_name, reps,
                             label + ", blend_all_scalers=%s" % ba))
    return out


def coo_suite(pdata, state, dtype_name, reps, label=""):
    """K7c against its plain version on the card, over what one iteration
    of the blocked-COO engine runs: the phi sums of both sides over the
    whole user-sorted training stream of ``pdata`` (host ProcessedData).
    ``state``: a VariationalState on the card."""
    import torch

    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops.svi import phi_sums_tables

    coo = C.coo_stream(pdata, state.G_shp.device)
    t_tab = C._side_derive_plain(state.G_shp, state.G_rte)[0]
    b_tab = C._side_derive_plain(state.L_shp, state.L_rte)[0]
    y, iu, ii = coo.flat()
    it = state.G_shp.element_size()
    k = state.k

    def library():
        phi = C._phi_block(t_tab, b_tab, y, iu, ii)
        return (torch.zeros_like(t_tab).index_add_(0, iu.long(), phi),
                torch.zeros_like(b_tab).index_add_(0, ii.long(), phi))

    # per triplet: y, both ids, the item-ordered item and user ids and the
    # triplet's position in item order (int32 each), the scale written
    # once; both tables read, both sums written; a dot and two k-wide
    # multiply-adds per triplet
    work = (coo.nnz * (2 * it + 20) + nbytes(coo.user_bounds, coo.item_runs)
            + 2 * (nbytes(t_tab) + nbytes(b_tab)), coo.nnz * (6 * k + 2))
    cases = {"coo_phi_sums": (lambda: C.coo_phi_sums(t_tab, b_tab, coo),
                              lambda: phi_sums_tables(t_tab, b_tab, y, iu, ii), work, library)}
    out = run_cases(cases, dtype_name, reps, label)
    print("  K7c split (torch.profiler, device ms a call): %s"
          % k7_split(lambda: C.coo_phi_sums(t_tab, b_tab, coo), reps))
    return out


def bf16_tab_check(name, got, ref, dtype_name):
    """K3's bfloat16 form: shp, rte, scaler and colsum as ``compare`` holds
    them; each bfloat16 ``tab`` within one bfloat16 step of the plain one,
    |d| <= 2^-7 |plain| + 1e-6 max|plain|: the kernel's float32
    or float64 exp differs from PyTorch's by a few ulps, and where that
    straddles a bfloat16 rounding boundary the stored values differ by one
    bfloat16 ulp."""
    import torch

    max_abs = max_rel = 0.0
    for g, r in zip(got, ref):
        if r.dtype != torch.bfloat16:
            a, b = compare(name, g, r, dtype_name)
        else:
            if g.dtype != torch.bfloat16 or g.shape != r.shape:
                raise AssertionError(f"{name}: tab {g.shape}/{g.dtype} vs {r.shape}/{r.dtype}")
            g64, r64 = g.double(), r.double()
            err = (g64 - r64).abs()
            if bool((err > BF16_TAB_RTOL * r64.abs() + 1e-6 * float(r64.abs().max())).any()):
                raise AssertionError(f"{name} {dtype_name}: bfloat16 tab differs from plain "
                                     f"by more than one rounding step")
            a = float(err.max())
            b = float((err / r64.abs().clamp_min(1e-300)).max())
        max_abs, max_rel = max(max_abs, a), max(max_rel, b)
    return max_abs, max_rel


def bf16_suite(lay_u, lay_i, state, dtype_name, reps, label=""):
    """The bfloat16-table forms of K1 and K3 against their plain versions on
    the card, over what one iteration of a ``gather_dtype='bfloat16'`` fit
    runs: K1 over both sides' ELL layouts with the exp tables rounded to
    bfloat16 (float32 sums), K3's update (on the plain phi sums of those
    tables, in the state dtype) and derive, both sides, with a bfloat16
    tab."""
    import torch

    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E

    k = state.k
    hp = Hyperparams(k=k)
    bf = torch.bfloat16
    t_tab, theta_colsum = C._side_derive_plain(state.G_shp, state.G_rte, bf)
    b_tab, beta_colsum = C._side_derive_plain(state.L_shp, state.L_rte, bf)
    sides = ((t_tab, b_tab, lay_u), (b_tab, t_tab, lay_i))

    def phi_plain(ts, to, lay):
        return torch.cat([E._bucket_phi_sums_plain(ts, to, b.rows, b.cols, b.vals, b.col_off)
                          for b in lay.buckets])

    su, si = (E._segment_table_sums_plain(phi_plain(*side), side[2]).to(state.G_shp.dtype)
              for side in sides)
    upd = ((su, state.k_rte, beta_colsum, hp.a, hp.k_shp, hp.add_k_rte, bf),
           (si, state.t_rte, theta_colsum, hp.c, hp.t_shp, hp.add_t_rte, bf))
    pairs = ((state.G_shp, state.G_rte, bf), (state.L_shp, state.L_rte, bf))

    def flat(*results):
        return [t for r in results for t in (r if isinstance(r, tuple) else (r,))]

    it = state.G_shp.element_size()
    nnz = sum(int((b.vals != 0).sum()) for b in lay_u.buckets)
    lay_bytes = k1_layout_bytes(lay_u, lay_i)
    seg_bytes = 4 * k * sum(lay.n_segs for lay in (lay_u, lay_i))
    elems = state.G_shp.numel() + state.L_shp.numel()
    tabs16 = 2 * elems
    work = {
        # both bfloat16 tables per side, the layouts, float32 segment sums out
        "ell_phi_sums_bf16": (2 * tabs16 + lay_bytes + seg_bytes, 2 * nnz * 4 * k),
        # sums in; shp, rte out in the state dtype, tab out in bfloat16
        "table_update_bf16": (elems * (3 * it + 2), 35 * elems),
        # shp, rte in; tab out in bfloat16
        "table_derive_bf16": (elems * (2 * it + 2), 33 * elems),
    }
    # K1's arithmetic is float32 in either state dtype: its tolerance and
    # peak rate are float32's
    k1 = {"ell_phi_sums_bf16": (lambda: flat(*(E.all_bucket_sums(*side) for side in sides)),
                                lambda: flat(*(phi_plain(*side) for side in sides)),
                                work["ell_phi_sums_bf16"], None)}
    out = run_cases(k1, "float32", reps, label + ", %s state" % dtype_name)
    # a bucket a launch: the same bits, timed beside (no path runs it)
    run_cases({"ell_phi_sums_bucket_bf16": (
        lambda: flat(*(bucket_by_bucket(*side) for side in sides)),
        lambda: flat(*(E.all_bucket_sums(*side) for side in sides)),
        work["ell_phi_sums_bf16"], None, bits_check)}, "float32", reps,
        label + ", %s state (a bucket a launch, against one a side)" % dtype_name)
    cases = {
        "table_update_bf16": (lambda: flat(*(C.side_update(*u) for u in upd)),
                              lambda: flat(*(C._side_update_plain(*u) for u in upd)),
                              work["table_update_bf16"], None, bf16_tab_check),
        "table_derive_bf16": (lambda: flat(*(C.side_derive(*p) for p in pairs)),
                              lambda: flat(*(C._side_derive_plain(*p) for p in pairs)),
                              work["table_derive_bf16"], None, bf16_tab_check),
    }
    out.update(run_cases(cases, dtype_name, reps, label))
    return out


def topn_check(name, got, ref, dtype_name):
    """K6 against its plain version: the same n best scores in the same
    order (float32 scores from products summed in another order may swap
    items whose scores differ by a few ulps, so indices are checked
    through the plain scores: each index the kernel returns must carry the
    score the kernel reports).  Returns (max abs, max rel) of the values."""
    import torch

    (vals, idx), (rvals, _), scores = got, ref[:2], ref[2]
    if vals.shape != rvals.shape or idx.dtype != torch.int32:
        raise AssertionError(f"{name}: shapes {vals.shape} vs {rvals.shape}")
    tol = TOL[dtype_name]
    fin = torch.isfinite(rvals)
    if not torch.equal(fin, torch.isfinite(vals)):
        raise AssertionError(f"{name}: -inf slots differ")
    at = scores.gather(1, idx.long())
    for a, b in ((vals, rvals), (at, vals)):
        err = (a[fin].double() - b[fin].double()).abs()
        if bool((err > tol["rtol"] * b[fin].double().abs()).any()):
            raise AssertionError(f"{name} {dtype_name}: kernel differs from plain "
                                 f"(max abs {float(err.max()):.3e})")
    if bool((idx[~fin] != ref[1][~fin]).any()):
        raise AssertionError(f"{name}: -inf slots hold other indices")
    if not all(len(set(r)) == len(r) for r in idx.cpu().tolist()):
        raise AssertionError(f"{name}: repeated items in a row")
    err = (vals[fin].double() - rvals[fin].double()).abs()
    return float(err.max()), float((err / rvals[fin].double().abs()).max())


def scalar_check(name, got, ref, dtype_name):
    import torch

    return compare(name, torch.tensor([got], dtype=torch.float64),
                   torch.tensor([ref], dtype=torch.float64), dtype_name)


def serving_suite(model, users, seen_lists, n_list, histories, pairs, val_pairs, dtype_name,
                  reps, label=""):
    """K6, K10 and K11 against their plain versions on the card, on a
    fitted ``model``'s tables: K6 on one chunk of ``users`` (row indices)
    with their seen lists (``seen_lists``: indptr starts, indices, counts;
    the chunk's last row gets a synthetic list that leaves 1,000 items
    unseen) at each n of ``n_list``; K10 on each (items, counts) of
    ``histories``; K11 predict_pairs on ``pairs``, rowsum_dot_rows on
    ``val_pairs``, theta_diff_norm on Theta and a perturbed copy.  An n up
    to the fused path's cap is also run on the three-kernel path, which
    must give the same bits.  Returns ({name: dict} of the first n on each
    K6 path ("topn" fused, "topn_large" the three-kernel path) and the
    other kernels, {name: dict} of the other n)."""
    import torch

    from hpfrec_tpu_torch.ops import metrics as M
    from hpfrec_tpu_torch.ops import svi as S
    from hpfrec_tpu_torch.ops import topk as T

    dev = torch.device("cuda")
    dt = torch.float32 if dtype_name == "float32" else torch.float64
    it = 4 if dt == torch.float32 else 8
    Theta = torch.from_numpy(np.ascontiguousarray(model.Theta)).to(dev)
    Beta = torch.from_numpy(np.ascontiguousarray(model.Beta)).to(dev)
    nI, k = Beta.shape
    b = len(users)
    starts, indices, counts = seen_lists
    c = counts[users].astype(np.int64)
    items = np.concatenate([indices[s:s + n] for s, n in zip(starts[users[:-1]], c[:-1])]
                           + [np.sort(np.random.default_rng(9).choice(nI, nI - 1000,
                                                                      replace=False))])
    c[-1] = nI - 1000
    rows = torch.from_numpy(np.repeat(np.arange(b), c).astype(np.int32)).to(dev)
    items = torch.from_numpy(items.astype(np.int32)).to(dev)
    th_rows = Theta[torch.from_numpy(users).to(dev)].contiguous()

    def plain_scores():
        sc = (th_rows @ Beta.T).to(torch.float32)
        sc[rows.long(), items.long()] = -torch.inf
        return sc

    def library(n):
        sc = torch.matmul(th_rows, Beta.T)
        sc.index_put_((rows.long(), items.long()), torch.tensor(-torch.inf, dtype=sc.dtype,
                                                                 device=dev))
        return torch.topk(sc, n)

    # each input read once, each output written once; 2 b nI k flops
    topn_bytes = nbytes(th_rows, Beta, rows, items) + b * 8
    results, extra = {}, {}
    for n in n_list:
        scores = plain_scores()
        name = "topn" if n <= T._FUSED_MAX_N else "topn_large"
        case = {name: (lambda n=n: T.topn_rows(th_rows, Beta, rows, items, n),
                       lambda n=n: (*T._topn_rows_plain(th_rows, Beta, rows, items, n), scores),
                       (topn_bytes + b * n * 8, 2 * b * nI * k),
                       lambda n=n: library(n), topn_check)}
        r = run_cases(case, dtype_name, reps, label + ", %d users, n=%d" % (b, n))
        del scores
        if n <= T._FUSED_MAX_N:
            # the fused path against the three-kernel path at the same n: the
            # same score sums and the same words, so the same bits
            three = lambda n=n: T._topn_scored(th_rows, Beta, rows, items, n)  # noqa: E731
            fused, ref3 = T.topn_rows(th_rows, Beta, rows, items, n), three()
            torch.cuda.synchronize()
            if not (torch.equal(fused[0], ref3[0]) and torch.equal(fused[1], ref3[1])):
                raise AssertionError(f"topn n={n}: the fused path differs from the "
                                     "three-kernel path")
            r[name]["three_kernel_ms"] = cuda_ms(three, reps)
            print("  %-20s %s%s, %d users, n=%d: bit-equal to the three-kernel path, which "
                  "takes %.4f ms (fused %.4f ms, library %.4f ms)"
                  % (name, dtype_name, label, b, n, r[name]["three_kernel_ms"], r[name]["ms"],
                     r[name]["library_ms"]))
        else:
            # the three-kernel path by launch: score, mask, select
            split = kernel_split(lambda n=n: T._topn_scored(th_rows, Beta, rows, items, n), reps)
            r[name]["split_ms"] = {kernel_name(key): ms for ms, key in split}
            print("  %-20s %s%s, %d users, n=%d, by launch (torch.profiler): %s"
                  % (name, dtype_name, label, b, n, ", ".join(
                      "%s %.4f ms" % kv for kv in r[name]["split_ms"].items())))
        if name in results:
            extra["%s n=%d" % (name, n)] = r[name]
        else:
            results[name] = r[name]

    hp = model._hp()
    cases = {}
    for items_h, counts_h in histories:
        arrays, k_rte0 = model._fold_in_start(items_h, counts_h, 1)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        n_it = S.user_factors_loop(*args, k_rte0, hp, 10, 1e-3)[4]
        P = len(items_h)
        cases["fold_in P=%d" % P] = (
            lambda a=args, k0=k_rte0: S.user_factors_loop(*a, k0, hp, 10, 1e-3)[:4],
            lambda a=args, k0=k_rte0: S._user_factors_loop_plain(*a, k0, hp, 10, 1e-3)[:4],
            # the rows once, the outputs once; ~8 flops an element an iteration
            (sum(nbytes(a) for a in args) + (P + 3) * k * it, 8 * n_it * P * k), None)
    fold = run_cases(cases, dtype_name, reps, label)
    heavy = max(fold, key=lambda name: int(name.split("=")[1]))
    results["fold_in"] = fold.pop(heavy)
    extra.update(fold)
    # the heaviest history's fold-in as HPF calls it (host arrays in, one copy
    # up, one back), and its iteration chain over 100 iterations
    arrays, k_rte0 = model._fold_in_start(*max(histories, key=lambda h: len(h[0])), 1)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    walls = []
    for _ in range(20 * reps + 1):
        t0 = time.perf_counter()
        S.fold_in(*arrays, k_rte0, hp, 10, 1e-3, dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    res = results["fold_in"]
    res["as_called_ms"] = float(np.median(walls[1:]))
    res["iter100_ms"] = cuda_ms(lambda: S.user_factors_loop(*args, k_rte0, hp, 100, 0.0),
                                10 * reps)
    print("  %-20s %s%s, %d items: as HPF calls it (host arrays in and out) %.4f ms a call "
          "(host clock, median of %d); 100 iterations %.4f ms (CUDA events)"
          % ("fold_in", dtype_name, label, len(arrays[0]), res["as_called_ms"], 20 * reps,
             res["iter100_ms"]))

    iu, ii = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in pairs)
    vu, vi = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in val_pairs)
    rows_touched = lambda u, i: (int(torch.unique(u).numel()) + int(torch.unique(i).numel())) * k * it  # noqa: E731
    noise = torch.from_numpy(np.random.default_rng(3).random(tuple(Theta.shape))).to(dev, dt)
    Theta_prev = Theta * (1 + 1e-3 * noise)
    n = iu.numel()
    cases = {
        "predict_pairs": (lambda: M.predict_pairs(Theta, Beta, iu, ii),
                          lambda: M._pairs_plain(Theta, Beta, iu, ii),
                          (nbytes(iu, ii) + n * it + rows_touched(iu, ii), 2 * k * n), None),
        "theta_diff_norm": (lambda: M.theta_diff_norm(Theta, Theta_prev),
                            lambda: M._theta_diff_norm_plain(Theta, Theta_prev),
                            (nbytes(Theta, Theta_prev), 3 * Theta.numel()),
                            lambda: torch.dist(Theta, Theta_prev), scalar_check),
        "rowsum_dot_rows": (lambda: M.rowsum_dot_rows(Theta, Beta, vu, vi),
                            lambda: M._rowsum_dot_rows_plain(Theta, Beta, vu, vi),
                            (nbytes(vu, vi) + rows_touched(vu, vi), 2 * k * vu.numel()), None,
                            scalar_check),
    }
    results.update(run_cases(cases, dtype_name, reps, label))
    # predict_pairs at the serving sizes: predict's 100,000 pairs and the
    # held-out set that the evaluation scores
    small = {"predict_pairs n=%d" % u.numel(): (
        lambda u=u, i=i: M.predict_pairs(Theta, Beta, u, i),
        lambda u=u, i=i: M._pairs_plain(Theta, Beta, u, i),
        (nbytes(u, i) + u.numel() * it + rows_touched(u, i), 2 * k * u.numel()), None)
        for u, i in ((iu[:100_000], ii[:100_000]), (vu, vi))}
    extra.update(run_cases(small, dtype_name, reps, label))
    return results, extra


def walled(fn):
    """(``fn()``, its wall ms on the host clock, synchronized)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profiled(fn):
    """Run ``fn`` under torch.profiler: (its result, {wall_ms (host clock,
    synchronized; the profiler's per-op overhead included, which swamps
    the wall of many small calls), busy_ms (device), kernel_ms, h2d_ms,
    d2h_ms, top (the four largest device items)})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, wall = walled(fn)
    split = dict(kernel_ms=0.0, h2d_ms=0.0, d2h_ms=0.0)
    rows = []
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            ms = ev.self_device_time_total / 1e3
            part = "h2d_ms" if "HtoD" in ev.key else "d2h_ms" if "DtoH" in ev.key else "kernel_ms"
            split[part] += ms
            rows.append((ms, ev.count, ev.key))
    top = "; ".join("%s x%d %.3f ms" % (key[:48], count, ms)
                    for ms, count, key in sorted(rows, reverse=True)[:4])
    return out, dict(wall_ms=wall, busy_ms=sum(split.values()), top=top, **split)


# K7 / K7c's kernels and the wrapper's sort, by the words in their names
# (K7c's chunk passes are its own: its user pass is the local one)
K7_STAGES = (("sort", ("RadixSort",)), ("run bounds", ("run_bounds",)),
             ("local chunk pass", ("phi_chunk_kernel<", ", true,")),
             ("other chunk pass", ("phi_chunk_kernel<", ", false,")),
             ("local chunk pass", ("coo_user_pass",)), ("other chunk pass", ("coo_item_pass",)),
             ("group passes", ("phi_group_kernel",)), ("local finish", ("phi_local_finish",)),
             ("other finish", ("phi_other_finish",)))


def kernel_split(fn, reps):
    """Device ms per call of ``fn`` by kernel name, from ``reps`` (>= 3) calls
    under torch.profiler after one warm-up call: [(ms, name)], largest
    first.  A name's ms is its mean launch time times its launches a call
    (its captured launches over ``reps``, rounded): the profiler has been
    seen to drop a launch of a name in a window, and a total over ``reps``
    would then read low."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(ev.self_device_time_total / 1e3 / ev.count * max(1, round(ev.count / reps)),
             ev.key) for ev in prof.key_averages()
            if str(getattr(ev, "device_type", "")).endswith("CUDA") and ev.count]
    return sorted(rows, reverse=True)


def kernel_name(key):
    """A kernel's bare name from the profiler's key (its signature)."""
    return key.split("(")[0].split("<")[0].split("::")[-1].split()[-1]


def k7_split(fn, reps):
    """K7's (or K7c's) device ms per call by stage (``K7_STAGES``; fills and
    copies under "other"), as one printable string."""
    split = {}
    for ms, key in kernel_split(fn, reps):
        stage = next((name for name, words in K7_STAGES if all(w in key for w in words)),
                     "other")
        split[stage] = split.get(stage, 0.0) + ms
    return ", ".join("%s %.4f" % kv for kv in sorted(split.items(), key=lambda kv: -kv[1]))


def user_histories(coo, rows):
    """[(items, counts)] of each user row in ``rows``, from a coo_array."""
    pick = np.zeros(coo.shape[0], dtype=bool)
    pick[rows] = True
    sel = np.flatnonzero(pick[coo.row])
    order = sel[np.argsort(coo.row[sel], kind="stable")]
    r = coo.row[order]
    out = []
    for u in rows:
        lo, hi = np.searchsorted(r, u), np.searchsorted(r, u, side="right")
        out.append((coo.col[order[lo:hi]], coo.data[order[lo:hi]]))
    return out


def agree_online():
    """Phase 4b: the same sequence of online calls and serving on the card
    and on the CPU, each model starting from the CPU fit's arrays."""
    from hpfrec_tpu_torch import HPF

    small = counts_coo(120, 80, 2000, seed=42)
    row, col, y = small.row, small.col, small.data
    trip = lambda m: np.column_stack([row[m], col[m], y[m]])  # noqa: E731
    hist = np.column_stack([np.arange(0, 42, 3), np.arange(1.0, 15.0)])
    steps = (lambda m: m.partial_fit(trip(row < 30)),
             lambda m: m.partial_fit(trip(col < 20), batch_type="items"),
             lambda m: m.partial_fit(trip(row <= 110), new_users=True, random_seed=3),
             lambda m: m.add_user(m.nusers, hist),
             lambda m: m.add_user(7, hist, update_existing=True))
    names = ("Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte", "k_rte",
             "t_rte")
    for use_float in (True, False):
        dtype_name = "float32" if use_float else "float64"
        kw = dict(k=8, maxiter=20, check_every=10, stop_crit="maxiter", random_seed=5,
                  use_float=use_float, verbose=False)
        cpu = HPF(device="cpu", **kw).fit(small)
        card = HPF(device="cuda", **kw).fit(small)
        for name in names:
            setattr(card, name, getattr(cpu, name).copy())
        for step in steps:
            step(cpu)
            step(card)
        dev_state = max(np.abs(getattr(card, n) / getattr(cpu, n) - 1).max() for n in names)
        got = card.predict_factors(hist, return_all=True)
        ref = cpu.predict_factors(hist, return_all=True)
        dev_fold = max(np.abs(a / b - 1).max() for a, b in zip(got[:3], ref[:3]))
        dev_phi = np.abs(got[3] - ref[3]).max()
        top_card = card.topN_batch(np.arange(120), n=10)
        top_cpu = cpu.topN_batch(np.arange(120), n=10)
        print("[4b] online sequence, %s: card vs CPU max rel: state arrays %.3e, fold-in "
              "Theta/G %.3e (limit %g), phi max abs %.3e; top-10 of 120 users: %d of %d "
              "indices differ" % (dtype_name, dev_state, dev_fold, AGREE_ONLINE[dtype_name],
                                  dev_phi, int((top_card != top_cpu).sum()), top_card.size))
        if max(dev_state, dev_fold, dev_phi) > AGREE_ONLINE[dtype_name]:
            raise AssertionError(f"online sequence, {dtype_name}: card and CPU disagree")
        if not np.array_equal(top_card, top_cpu):
            raise AssertionError(f"topN_batch, {dtype_name}: card and CPU indices differ")


def persistence_small(small):
    """Phase 4c at a small size on the card: full-batch (both engines) and
    SVI fits resumed from a checkpoint equal the uninterrupted fits bit for
    bit, in float32 and float64; the save_folder export; a profile_dir
    trace that names a port kernel."""
    from hpfrec_tpu_torch import HPF

    with tempfile.TemporaryDirectory(prefix="hpf_smoke_") as tmp:
        for use_float in (True, False):
            for label, opts, total, every in (
                    ("ELL full batch", dict(check_every=5), 20, 5),
                    ("COO full batch", dict(engine="coo", check_every=5), 20, 5),
                    ("SVI", dict(check_every=3, users_per_batch=25, items_per_batch=17), 6, 3)):
                kw = dict(k=8, stop_crit="train-llk", stop_thr=1e-10, random_seed=123,
                          use_float=use_float, verbose=False, device="cuda", **opts)
                ck = os.path.join(tmp, "ck_%s_%s" % (label.replace(" ", "_"), use_float))
                full = HPF(maxiter=total, **kw).fit(small)
                HPF(maxiter=total // 2, checkpoint_folder=ck, checkpoint_every=every,
                    **kw).fit(small)
                resumed = HPF(maxiter=total, checkpoint_folder=ck, checkpoint_every=every,
                              **kw).fit(small, resume=True)
                if not (resumed.niter == full.niter and all(
                        np.array_equal(getattr(resumed, n), getattr(full, n))
                        for n in STATE_NAMES)):
                    raise AssertionError(f"resume, {label}: not equal to the uninterrupted fit")
            print("[4c] %s: full batch (ELL and COO, %d iterations) and SVI (%d epochs) resumed "
                  "at half way equal the uninterrupted fits bit for bit"
                  % ("float32" if use_float else "float64", 20, 6))
        export = os.path.join(tmp, "export")
        os.makedirs(export)
        triplets = np.column_stack([small.row, small.col, small.data])
        m = HPF(k=8, maxiter=10, check_every=5, random_seed=1, verbose=False, device="cuda",
                save_folder=export).fit(triplets)
        with open(os.path.join(export, "users.csv")) as f:
            users_csv = f.read().split("\n")
        if users_csv != ["0", *map(str, m.user_mapping_), ""]:
            raise AssertionError("save_folder: users.csv does not list the user mapping")
        arrays = dict(Theta=m.Theta, Beta=m.Beta, Gamma_shp=m.Gamma_shp, Gamma_rte=m.Gamma_rte,
                      Lambda_shp=m.Lambda_shp, Lambda_rte=m.Lambda_rte, kappa_rte=m.k_rte,
                      tau_rte=m.t_rte)
        for name, arr in arrays.items():
            got = np.loadtxt(os.path.join(export, name), delimiter=",", ndmin=2)
            if np.abs(got - arr.reshape(got.shape)).max() > 5.1e-11:  # %.10f
                raise AssertionError(f"save_folder: {name} does not hold the fitted values")
        print("[4c] save_folder: %s" % ", ".join(sorted(os.listdir(export))))
        prof = os.path.join(tmp, "prof")
        HPF(k=8, maxiter=10, check_every=5, verbose=False, device="cuda",
            profile_dir=prof).fit(small)
        path = os.path.join(prof, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        ours = sorted({e["name"].split("(")[0] for e in events
                       if e.get("cat") == "kernel" and "hpf::" in e.get("name", "")})
        print("[4c] profile_dir: trace.json %d bytes, %d port kernels named, e.g. %s"
              % (os.path.getsize(path), len(ours), "; ".join(ours[:3])))
        if not ours:
            raise AssertionError("profile_dir: the trace names no port kernel")


def layouts_for(coo, dtype, device):
    from hpfrec_tpu_torch.ops.ell import build_layouts, layout_slots, to_device
    from hpfrec_tpu_torch.utils.data import process_data

    pdata = process_data(coo, "train-llk", False, dtype)
    host_u, host_i = build_layouts(pdata, dtype)
    slots = layout_slots(host_u) + layout_slots(host_i)
    return to_device(host_u, device), to_device(host_i, device), pdata, slots


def val_blocked(coo, dtype, device):
    """A validation coo_array as the BlockedCOO that a fit builds of it."""
    from hpfrec_tpu_torch.ops.cavi import device_blocked_coo

    return device_blocked_coo(coo.data.astype(dtype), coo.row.astype(np.int32),
                              coo.col.astype(np.int32), device)[0]


def random_state(nU, nI, dtype, device, seed):
    import torch

    from hpfrec_tpu_torch.models.state import VariationalState

    rng = np.random.default_rng(seed)

    def t(*shape, lo=0.3, hi=3.0):
        return torch.from_numpy((lo + (hi - lo) * rng.random(shape)).astype(dtype)).to(device)

    return VariationalState(t(nU, K), t(nU, K, lo=20, hi=60), t(nI, K),
                            t(nI, K, lo=20, hi=60), t(nU, 1), t(nI, 1))


def kernel_counters():
    """name -> (wrapper, the attribute that counts its launches): every
    kernel wrapper, and the data-parallel exchanges (K12), which count the
    collectives they issue, and the table-sharded engine (K13), which counts
    its calls.  The bfloat16-table forms of K1 and K3 count in their
    wrappers' .launches_bf16, K1 a ring offset a launch (the table-sharded
    ring's) in .launches_offset(_bf16), K3's pad-row forms in
    .launches_pad(_bf16),
    K6's three-kernel path (n above the fused path's cap) in
    .launches_large."""
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M
    from hpfrec_tpu_torch.ops import svi as S
    from hpfrec_tpu_torch.ops import topk as T
    from hpfrec_tpu_torch.parallel import engine as P
    from hpfrec_tpu_torch.parallel import table_sharded as TS

    wrappers = {"ell_phi_sums": E.all_bucket_sums, "ell_phi_sums_bucket": E.bucket_phi_sums,
                "segment_table_sums": E.segment_table_sums,
                "table_update": C.side_update, "table_derive": C.side_derive,
                "ell_llk": M.bucket_llk_parts, "coo_llk": M.llk_rmse_sums,
                "batch_phi_sums": S.batch_phi_sums, "svi_update": S.svi_update,
                "epoch_gather": S.build_epoch_buffers, "row_mask": S.build_row_mask,
                "topn": T.topn_rows, "fold_in": S.user_factors_loop,
                "predict_pairs": M.predict_pairs, "theta_diff_norm": M.theta_diff_norm,
                "rowsum_dot_rows": M.rowsum_dot_rows, "coo_phi_sums": C.coo_phi_sums,
                "sharded_ell_phi_sums": P.sharded_ell_phi_sums,
                "sharded_svi_phi_sums": P.sharded_svi_phi_sums,
                "sharded_coo_phi_sums": P.sharded_coo_phi_sums,
                "gather_partials": P.gather_partials, "colsum_finish": C.colsum_finish,
                "ring_table_sums": TS.ring_table_sums,
                "table_sharded_step": TS.table_sharded_step,
                "table_sharded_llk_parts": TS.table_sharded_llk_parts,
                "cross_rank_colsum": TS.cross_rank_colsum}
    counters = {name: (w, "launches") for name, w in wrappers.items()}
    counters.update({"ell_phi_sums_bf16": (E.all_bucket_sums, "launches_bf16"),
                     "ell_phi_sums_offset": (E.all_bucket_sums, "launches_offset"),
                     "ell_phi_sums_offset_bf16": (E.all_bucket_sums, "launches_offset_bf16"),
                     "ell_phi_sums_bucket_bf16": (E.bucket_phi_sums, "launches_bf16"),
                     "table_update_bf16": (C.side_update, "launches_bf16"),
                     "table_derive_bf16": (C.side_derive, "launches_bf16"),
                     "table_update_pad": (C.side_update, "launches_pad"),
                     "table_update_pad_bf16": (C.side_update, "launches_pad_bf16"),
                     "topn_large": (T.topn_rows, "launches_large")})
    return counters


def reset_counters(counters):
    for w, attr in counters.values():
        setattr(w, attr, 0)


def read_counters(counters):
    import torch

    torch.cuda.synchronize()
    return {name: getattr(w, attr) for name, (w, attr) in counters.items()}


def recording_hpf():
    """``HPF`` that records the llk of every convergence check in
    ``llk_trace`` (and with ``keep_engine`` a table-sharded fit's engine
    and last state in ``engine_``)."""
    from hpfrec_tpu_torch import HPF

    class RecordingHPF(HPF):
        keep_engine = False

        def _evaluate_criterion(self, *args, **kwargs):
            out = super()._evaluate_criterion(*args, **kwargs)
            self.llk_trace.append(self._last_llk)
            return out

        def _final_eval(self, state, colsums):
            # a table-sharded fit's engine and its last padded state, which
            # the fit lets go of when it returns (phase 3k times them)
            if self.keep_engine:
                self.engine_ = (self._table_shard, state)
            return super()._final_eval(state, colsums)

    return RecordingHPF

# -- 3j. data parallel ---------------------------------------------------------
# The fits each rank of a data-parallel mesh runs (``dp_fits``), per data set:
# "msd", the MillionSong shape in float32 (the fits of phases 3, 3g and 3b),
# and "small", phase 2's ~1M-nonzero set in float64; then a partial_fit of a
# seeded user batch of the SVI model's own triplets.
DP_FITS = {
    "msd": [("ell", dict(k=K, stop_crit="train-llk", check_every=5, maxiter=10, random_seed=1),
             "all"),
            ("coo", dict(engine="coo", k=K, stop_crit="train-llk", check_every=5, maxiter=10,
                         random_seed=1), "all"),
            ("svi", dict(k=K, stop_crit="val-llk", check_every=2, maxiter=6, random_seed=1,
                         **SVI_BATCHES), "train")],
    "small": [("ell", dict(k=K, stop_crit="train-llk", check_every=5, maxiter=10, random_seed=1,
                           use_float=False), "all"),
              ("coo", dict(engine="coo", k=K, stop_crit="train-llk", check_every=5, maxiter=10,
                           random_seed=1, use_float=False), "all"),
              ("svi", dict(k=K, stop_crit="val-llk", check_every=2, maxiter=6, random_seed=1,
                           use_float=False, **SMALL_BATCHES), "train")],
    # phase 3k (a): phases 3 and 3h's fits on the table-sharded engine
    "ts": [("ts", dict(k=K, stop_crit="train-llk", check_every=5, maxiter=10, random_seed=1,
                       shard_tables=True), "all"),
           ("ts_bf16", dict(k=K, stop_crit="train-llk", check_every=5, maxiter=10,
                            random_seed=1, shard_tables=True, gather_dtype="bfloat16"), "all")],
}
DP_PARTIAL_FIT_USERS = {"msd": 100_000, "small": 2_600}
# the kernels and exchanges each data-parallel fit must launch
DP_REQUIRED = {
    "ell": ("sharded_ell_phi_sums", "ell_phi_sums", "segment_table_sums", "table_update",
            "gather_partials", "ell_llk"),
    "coo": ("sharded_coo_phi_sums", "coo_phi_sums", "table_update", "gather_partials",
            "coo_llk"),
    "svi": ("sharded_svi_phi_sums", "batch_phi_sums", "svi_update", "epoch_gather",
            "table_derive", "gather_partials", "coo_llk"),
    "partial_fit": ("sharded_svi_phi_sums", "batch_phi_sums", "svi_update", "table_derive"),
    "ts": ("table_sharded_step", "ring_table_sums", "cross_rank_colsum", "colsum_finish",
           "table_sharded_llk_parts", "ell_phi_sums_offset", "segment_table_sums",
           "table_update_pad",
           "table_derive", "ell_llk", "gather_partials"),
    "ts_bf16": ("table_sharded_step", "ring_table_sums", "cross_rank_colsum", "colsum_finish",
                "table_sharded_llk_parts", "ell_phi_sums_offset_bf16", "segment_table_sums",
                "table_update_pad_bf16", "table_derive_bf16", "ell_llk", "gather_partials"),
}
# a data-parallel fit against the one-device fit on the same card.  On one
# rank every exchange hands back its input, so every fit (ELL, COO, SVI,
# partial_fit) must be bit-equal, llk included.  On more: ELL's exchange
# copies segment sums, so its factors stay bit-equal and its llk is within
# DP_ELL_LLK relative (K4's partials are cut at other places); COO, SVI and
# partial_fit add the other side's rows over the ranks in another order.
# Their float64 limits ("small", two ranks over gloo on one card) give the
# gaps measured on the CPU (tests/test_torch_parallel.py, <= 1.8e-14) and on
# the card (<= 3.3e-14) over 300x room; the float32 ones ("msd", two or more
# cards: never run on a one-card machine) are phase 4's card-vs-CPU limits
# AGREE (full batch) and AGREE_SVI, which hold the same fits with every sum
# in another order
DP_LIMITS = {"float64": dict(llk=1e-11, factors=1e-11)}
DP_ELL_LLK = 1e-12
DP_TIMEOUT_S = 900
# the longest a rank may take to exit once its results are written
DP_EXIT_S = 60
# NVLink between two H100s of one host, each way (NVIDIA data sheet)
PEAK_LINK = 450e9
REPLACES.update({
    "sharded_ell_phi_sums": ("hpfrec_tpu_torch/parallel/engine.py",
                             "hpfrec_tpu/parallel/engine.py:65"),
    "sharded_svi_phi_sums": ("hpfrec_tpu_torch/parallel/engine.py",
                             "hpfrec_tpu/parallel/engine.py:120"),
    "sharded_coo_phi_sums": ("hpfrec_tpu_torch/parallel/engine.py",
                             "hpfrec_tpu/parallel/engine.py:143"),
    "gather_partials": ("hpfrec_tpu_torch/parallel/engine.py",
                        "hpfrec_tpu/parallel/engine.py:166"),
})


def dp_fit_names(task):
    names = [name for name, _, _ in DP_FITS[task]]
    return names + ["partial_fit"] if "svi" in names else names


def array_digests(m):
    """sha256 of each fitted state array of a model (bit-equality across
    processes without moving the arrays)."""
    import hashlib

    return {n: hashlib.sha256(np.ascontiguousarray(getattr(m, n)).tobytes()).hexdigest()
            for n in STATE_NAMES}


def fit_summary(m, launches, **extra):
    st = m.fit_stats_
    return dict(llk=[float(x) for x in m.llk_trace], niter=int(m.niter),
                phases={k: float(v) for k, v in st.phases.items()}, wall=float(st.wall_seconds),
                digests=array_digests(m), launches=launches, **extra)


def save_triplets(path, coo):
    os.makedirs(path, exist_ok=True)
    for name, a in (("row", coo.row), ("col", coo.col), ("data", coo.data)):
        np.save(os.path.join(path, name + ".npy"), a)
    with open(os.path.join(path, "shape.json"), "w") as f:
        json.dump(list(coo.shape), f)


def load_triplets(path):
    from scipy.sparse import coo_array

    with open(os.path.join(path, "shape.json")) as f:
        shape = tuple(json.load(f))
    row, col, data = (np.load(os.path.join(path, n + ".npy")) for n in ("row", "col", "data"))
    return coo_array((data, (row, col)), shape=shape)


def dp_fits(task, data, mesh, device, counters, save=None):
    """The task's fits (``DP_FITS``) on ``mesh`` (None: one device), then a
    ``partial_fit`` of a user batch on the SVI model, if the task has one.
    The float32-table table-sharded fit keeps its engine (``recording_hpf``).  Returns ({fit name:
    fit_summary}, {fit name: model}); ``save(name, model)``, if given, is
    called after each fit."""
    RecordingHPF = recording_hpf()
    out, models = {}, {}
    for name, kw, which in DP_FITS[task]:
        m = RecordingHPF(device=device, mesh=mesh, verbose=False, **kw)
        m.llk_trace = []
        m.keep_engine = name == "ts"
        reset_counters(counters)
        if which == "train":
            m.fit(data["train"], val_set=data["val"])
        else:
            m.fit(data["all"])
        out[name] = fit_summary(m, read_counters(counters))
        models[name] = m
        if save is not None:
            save(name, m)
    if "svi" not in models:
        return out, models
    train = data["train"]
    pick = np.zeros(train.shape[0], dtype=bool)
    pick[np.random.default_rng(12).choice(train.shape[0], DP_PARTIAL_FIT_USERS[task],
                                          replace=False)] = True
    sel = pick[train.row]
    m = models["svi"]
    reset_counters(counters)
    _, wall = walled(lambda: m.partial_fit(np.column_stack([train.row[sel], train.col[sel],
                                                            train.data[sel]])))
    out["partial_fit"] = fit_summary(m, read_counters(counters), wall_ms=wall)
    if save is not None:
        save("partial_fit", m)
    return out, models


def exchange_bound(nbytes_, world, kind):
    """Least time (ms) of an exchange of ``nbytes_`` (the gathered or
    reduced buffers), from the bytes it must move: on one rank an
    out-of-place all_gather reads its input and writes its output once at
    the HBM rate, and an in-place all_reduce moves nothing; on more, the
    bytes each rank sends over NVLink (an all_gather (n-1)/n of them, a ring
    all_reduce 2(n-1)/n)."""
    if world == 1:
        return 2 * nbytes_ / PEAK_BYTES * 1e3 if kind == "all_gather" else 0.0
    share_ = (world - 1) / world * (1 if kind == "all_gather" else 2)
    return share_ * nbytes_ / PEAK_LINK * 1e3


def dp_exchange_suite(mesh, data, model, reps):
    """K12's four functions at the shapes of the "msd" fits, on the ELL
    fit's state: each against the one-device computation of the same sums
    (max abs error; raises beyond its limit: none on one rank, where the
    exchange hands back its input, and for K12a's copied segment sums; on
    more ranks TOL's float32 rtol of the largest sum for the sums added over
    the ranks, DP_ELL_LLK for the llk), its exchange timed with CUDA events
    (``ms``) beside a device copy of the same bytes (``plain_ms``), and the
    whole sharded function against the one-device function (``fn_ms``,
    ``one_device_ms``); raises if an exchange reads under its bound.  Every
    rank runs the same collectives in the same order."""
    import torch

    from hpfrec_tpu_torch.models.state import state_from_numpy
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M
    from hpfrec_tpu_torch.ops import svi as S
    from hpfrec_tpu_torch.parallel import engine as P
    from hpfrec_tpu_torch.utils.data import build_csr, process_data, share

    dev, n = mesh.device, mesh.world_size
    shard = (mesh.rank, n)
    state = state_from_numpy([model.Gamma_shp, model.Gamma_rte, model.Lambda_shp,
                              model.Lambda_rte, model.k_rte, model.t_rte], dev)
    t_tab, b_tab = C.side_derive(state.G_shp, state.G_rte)[0], C.side_derive(state.L_shp,
                                                                            state.L_rte)[0]
    Theta, Beta = state.G_shp / state.G_rte, state.L_shp / state.L_rte
    pdata = process_data(data["all"], "train-llk", False, np.float32, sort_by_user=True)
    out = {}

    def case(name, exchange, plain, fn, one, nbytes_, kind, err, limit):
        if err > (0.0 if n == 1 else limit):
            raise AssertionError(f"3j {name} on {n} rank(s): max abs error {err:.3e} against "
                                 f"the one-device function (limit "
                                 f"{0.0 if n == 1 else limit:.3e})")
        ms, plain_ms = cuda_ms(exchange, reps), cuda_ms(plain, reps)
        bound_ms = exchange_bound(nbytes_, n, kind)
        if ms < bound_ms:
            raise AssertionError(f"3j {name}: exchange {ms:.4f} ms under its bound "
                                 f"{bound_ms:.4f} ms")
        out[name] = dict(ms=ms, plain_ms=plain_ms, fn_ms=cuda_ms(fn, reps),
                         one_device_ms=cuda_ms(one, reps), bytes=int(nbytes_), ops=0,
                         bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                         max_abs_err=float(err), max_rel_err=None)

    def max_err(got, ref):
        return max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))

    def summed_limit(ref):  # sums added over the ranks in another order
        return TOL["float32"]["rtol"] * max(float(r.double().abs().max()) for r in ref)

    # K12a, per iteration (both sides), and K12d, per train-llk check
    sh = [E.to_device(h, dev, shard) for h in E.build_layouts(pdata, np.float32, n)]
    full = sh if n == 1 else [E.to_device(h, dev) for h in E.build_layouts(pdata, np.float32)]
    sides = ((t_tab, b_tab, 0), (b_tab, t_tab, 1))
    local = [E.all_bucket_sums(a, b, sh[j]) for a, b, j in sides]
    gathered = [P.all_gather_rows(mesh, x) for x in local]
    bufs = [torch.empty_like(g) for g in gathered]
    case("sharded_ell_phi_sums",
         lambda: [P.all_gather_rows(mesh, x) for x in local],
         lambda: [b.copy_(g) for b, g in zip(bufs, gathered)],
         lambda: [P.sharded_ell_phi_sums(mesh, a, b, sh[j]) for a, b, j in sides],
         lambda: [E.ell_phi_sums(a, b, full[j]) for a, b, j in sides],
         nbytes(*gathered), "all_gather",
         max_err([P.sharded_ell_phi_sums(mesh, a, b, sh[j]) for a, b, j in sides],
                 [E.ell_phi_sums(a, b, full[j]) for a, b, j in sides]), 0.0)
    parts = M.ell_llk_rmse_sums(Theta, Beta, sh[0])
    part_buf = torch.empty_like(parts)
    got = float(P.gather_partials(mesh, parts)[:, 0].sum())
    ref = float(M.ell_llk_rmse_sums(Theta, Beta, full[0])[:, 0].sum())
    case("gather_partials", lambda: P.gather_partials(mesh, parts),
         lambda: part_buf.copy_(parts),
         lambda: P.gather_partials(mesh, M.ell_llk_rmse_sums(Theta, Beta, sh[0])).cpu(),
         lambda: M.ell_llk_rmse_sums(Theta, Beta, full[0]).cpu(),
         n * nbytes(parts), "all_gather", abs(got - ref), DP_ELL_LLK * abs(ref))
    out["sharded_ell_phi_sums"]["segments_per_rank"] = [lay.n_segs for lay in sh]
    del sh, full, local, gathered, bufs

    # K12c, per iteration
    part = C.coo_stream(pdata, dev, None, shard)
    whole = part if n == 1 else C.coo_stream(pdata, dev)
    su, si = P.sharded_coo_phi_sums(mesh, t_tab, b_tab, part)
    a, b = su.clone(), si.clone()
    ref = C.coo_phi_sums(t_tab, b_tab, whole)
    case("sharded_coo_phi_sums", lambda: P.all_reduce_sum(mesh, a, b),
         lambda: (a.copy_(su), b.copy_(si)),
         lambda: P.sharded_coo_phi_sums(mesh, t_tab, b_tab, part),
         lambda: C.coo_phi_sums(t_tab, b_tab, whole), nbytes(su, si), "all_reduce",
         max_err((su, si), ref), summed_limit(ref))
    out["sharded_coo_phi_sums"]["triplets_per_rank"] = part.nnz
    del part, whole, su, si, a, b

    # K12b, per batch: the first user batch of a seeded epoch of the SVI fit's
    # training set (SVI_BATCHES)
    spdata = process_data(data["train"], "val-llk", False, np.float32)
    side = S.epoch_side(*build_csr(spdata.ix_u, spdata.ix_i, spdata.y, spdata.nusers,
                                   spdata.nitems), np.float32, dev)
    perm = np.random.default_rng(7).permutation(side.n_rows)
    off_h = S.epoch_offsets(side.deg, perm)
    perm_d, off_d = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (perm, off_h))
    e_y, e_row, e_col = S.build_epoch_buffers(side.y, side.cols, side.indptr, perm_d, off_d)
    r1 = SVI_BATCHES["users_per_batch"]
    s0, s1 = int(off_h[0]), int(off_h[r1])
    whole = (t_tab, b_tab, e_y[s0:s1], e_row[s0:s1], e_col[s0:s1], off_d[:r1 + 1], s0,
             perm_d[:r1])
    q0, q1 = share(off_h[:r1 + 1], n, mesh.rank)  # the rank's rows, as ops.svi cuts them
    a0, a1 = int(off_h[q0]), int(off_h[q1])
    mine = (t_tab, b_tab, e_y[a0:a1], e_row[a0:a1], e_col[a0:a1], off_d[q0:q1 + 1], a0,
            perm_d[q0:q1])
    got = P.sharded_svi_phi_sums(mesh, *mine)
    ref = S.batch_phi_sums(*whole)
    if not torch.equal(got[2], ref[2]):
        raise AssertionError("3j sharded_svi_phi_sums: the touched-row mask differs from "
                             "the one-device mask")
    copies = [g.clone() for g in got]
    case("sharded_svi_phi_sums", lambda: P.reduce_batch_sums(mesh, *copies),
         lambda: [c.copy_(g) for c, g in zip(copies, got)],
         lambda: P.sharded_svi_phi_sums(mesh, *mine),
         lambda: S.batch_phi_sums(*whole), nbytes(*got), "all_reduce",
         max_err(got[:2], ref[:2]), summed_limit(ref[:2]))
    out["sharded_svi_phi_sums"]["batch_triplets"] = s1 - s0
    return out


def dp_rank_main(cfg_path):
    """One rank of a data-parallel mesh that ``spawn_ranks`` started: the
    task's fits on the mesh (``dp_fits``), a check that each fit launched
    its kernels and exchanges, the exchange suite where asked; writes
    ``rank<r>.json`` (and, on rank 0, the factors of the fits that are
    compared by value) to the run's directory."""
    import torch

    from hpfrec_tpu_torch.parallel import distributed

    with open(cfg_path) as f:
        cfg = json.load(f)
    warnings.filterwarnings("ignore", message="When using 'partial_fit'")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = distributed.initialize(cfg["init"], num_processes=cfg["world"],
                                  process_id=cfg["rank"], initialization_timeout=300,
                                  backend=cfg["backend"], device=cfg["device"])
    if (mesh.world_size, mesh.rank, mesh.backend) != (cfg["world"], cfg["rank"], cfg["backend"]):
        raise AssertionError(f"mesh {mesh} is not the one asked for: {cfg}")
    data = {"all": load_triplets(os.path.join(cfg["data"], "all"))}
    if os.path.isdir(os.path.join(cfg["data"], "train")):
        data.update(train=load_triplets(os.path.join(cfg["data"], "train")),
                    val=load_triplets(os.path.join(cfg["data"], "val")))
    elif any(which == "train" for _, _, which in DP_FITS[cfg["task"]]):
        data["train"], data["val"] = holdout(data["all"], 0.01, seed=5)

    def save(name, m):
        if cfg["rank"] == 0 and name in cfg["save"]:
            for attr in ("Theta", "Beta"):
                np.save(os.path.join(cfg["out"], "%s_%s.npy" % (name, attr)), getattr(m, attr))

    counters = kernel_counters()
    t0 = time.perf_counter()
    results, models = dp_fits(cfg["task"], data, mesh, mesh.device, counters, save)
    results["fits_s"] = time.perf_counter() - t0
    for name in dp_fit_names(cfg["task"]):
        missing = [k for k in DP_REQUIRED[name] if results[name]["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"rank {mesh.rank}, {name} fit: never launched {missing}")
    if "ts" in models:  # the float32-table fit: its split, its parts against plain
        engine, state = models["ts"].engine_
        del models["ts"].engine_
        results["split"] = ts_split(mesh, engine, state, reps=3)
        results["ts_cases"] = ts_cases(mesh, engine, engine.carry_init(state), reps=3)
        del engine, state
    if cfg["suite"]:
        results["exchanges"] = dp_exchange_suite(mesh, data, models["ell"], reps=5)
        results["ts_step"] = ts_step_suite(mesh, data, models["ell"], reps=3)
    results["device"] = torch.cuda.get_device_name(mesh.device)
    results["results_at"] = time.time()
    with open(os.path.join(cfg["out"], "rank%d.json" % cfg["rank"]), "w") as f:
        json.dump(results, f)
    return 0  # the group is destroyed at exit, by the handler that initialize registered


def spawn_ranks(task, world, backend, devices, data_dir, save=(), suite=False):
    """Run ``world`` ranks of a data-parallel mesh (this script with
    ``--dp-rank``), each on its device of ``devices``, rendezvous through a
    file; ``suite`` runs the exchange suite and the table-sharded step
    suite after the fits.  Waits for every rank within ``DP_TIMEOUT_S``; a rank that fails
    ends the others and fails the run, and so does a rank that takes more than
    ``DP_EXIT_S`` to exit after writing its results (its process group is
    torn down at exit).  Returns (the ranks' results, each with ``exit_s``,
    the run's directory, its wall seconds)."""
    run = tempfile.mkdtemp(prefix="hpf_dp_")
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            cfg = dict(task=task, world=world, rank=r, backend=backend, device=devices[r],
                       init="file://" + os.path.join(run, "rendezvous"), data=data_dir,
                       out=run, save=list(save), suite=suite)
            path = os.path.join(run, "rank%d.cfg.json" % r)
            with open(path, "w") as f:
                json.dump(cfg, f)
            log = open(os.path.join(run, "rank%d.log" % r), "w")
            procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                            "--dp-rank", path], stdout=log,
                                           stderr=subprocess.STDOUT), log))
        ended = {}
        while len(ended) < world:
            for r, (p, _) in enumerate(procs):
                if r not in ended and p.poll() is not None:
                    ended[r] = time.time()
            if any(p.returncode not in (None, 0) for p, _ in procs):
                break
            if time.perf_counter() - t0 > DP_TIMEOUT_S:
                raise AssertionError(f"{task} mesh: ranks still running after {DP_TIMEOUT_S} s")
            time.sleep(0.1)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:  # report a rank that failed on its own before one this script ended
        r = min(failed, key=lambda r: procs[r][0].returncode < 0)
        with open(os.path.join(run, "rank%d.log" % r)) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"{task} mesh, rank {r} of {world} exited "
                             f"{procs[r][0].returncode}:\n{tail}")
    results = []
    for r in range(world):
        with open(os.path.join(run, "rank%d.json" % r)) as f:
            results.append(json.load(f))
        results[r]["exit_s"] = ended[r] - results[r]["results_at"]
    slow = max(res["exit_s"] for res in results)
    if slow > DP_EXIT_S:
        raise AssertionError(f"{task} mesh: a rank took {slow:.1f} s to exit after its results")
    return results, run, time.perf_counter() - t0


def check_ranks_equal(task, results):
    """Every rank of a mesh holds the same fitted arrays, bit for bit."""
    for r, res in enumerate(results[1:], 1):
        for fit in dp_fit_names(task):
            if res[fit]["digests"] != results[0][fit]["digests"]:
                raise AssertionError(f"{task} mesh: rank {r}'s {fit} arrays differ from rank 0's")
            if res[fit]["llk"] != results[0][fit]["llk"]:
                raise AssertionError(f"{task} mesh: rank {r}'s {fit} llk differs from rank 0's")


def check_against_one_device(tag, name, res, ref, run, dtype_name, world):
    """A mesh fit (rank 0's ``res``) against the one-device fit ``ref``
    (llk, niter, digests, Theta, Beta); raises beyond the limits
    (``DP_LIMITS``).  Returns the printed figures."""
    llk, ref_llk = np.array(res["llk"]), np.array(ref["llk"])
    if res["niter"] != ref["niter"] or llk.shape != ref_llk.shape:
        raise AssertionError(f"{tag} {name}: {res['niter']} iterations against {ref['niter']}")
    dev_llk = float(np.abs(llk / ref_llk - 1).max()) if llk.size else 0.0
    bit_equal = res["digests"] == ref["digests"]
    if world == 1:
        if not bit_equal or dev_llk != 0.0:
            raise AssertionError(f"{tag} {name} fit on one rank: not bit-equal to the "
                                 f"one-device fit (state bit-equal {bit_equal}, llk max rel "
                                 f"{dev_llk:.3e})")
        return "state and llk bit-equal (one rank: required)"
    if name == "ell":
        if not bit_equal:
            raise AssertionError(f"{tag} ELL fit: factors not bit-equal to the one-device fit")
        if dev_llk > DP_ELL_LLK:
            raise AssertionError(f"{tag} ELL fit: llk {dev_llk:.3e} off the one-device fit's")
        return "factors bit-equal, llk max rel %.3e (limit %g)" % (dev_llk, DP_ELL_LLK)
    lim = (DP_LIMITS[dtype_name] if dtype_name in DP_LIMITS
           else (AGREE if name == "coo" else AGREE_SVI)[dtype_name])
    dev_f = max(float(np.abs(np.load(os.path.join(run, "%s_%s.npy" % (name, a))) / ref[a] - 1)
                      .max()) for a in ("Theta", "Beta"))
    if dev_llk > lim["llk"] or dev_f > lim["factors"]:
        raise AssertionError(f"{tag} {name} fit: llk {dev_llk:.3e}, factors {dev_f:.3e} off "
                             f"the one-device fit")
    return ("%s; llk max rel %.3e (limit %g), Theta/Beta max rel %.3e (limit %g)"
            % ("state bit-equal" if bit_equal else "state not bit-equal", dev_llk, lim["llk"],
               dev_f, lim["factors"]))


def fit_reference(m, s_per_it):
    """What a data-parallel fit is held against: a one-device fit's llk
    trace, iterations, digests, factors and seconds per iteration."""
    return dict(llk=list(m.llk_trace), niter=int(m.niter), digests=array_digests(m),
                Theta=np.array(m.Theta), Beta=np.array(m.Beta), s_per_it=s_per_it)


def dp_s_per_it(res):
    """Seconds per iteration (full batch) or per epoch (SVI) of a fit."""
    iters = res["niter"] + 1
    loop = res["phases"].get("iterations", res["phases"].get("user_epochs", 0.0)
                             + res["phases"].get("item_epochs", 0.0))
    return loop / iters


def phase_3j(data_root, refs, small, counters, real):
    """Phase 3j: (a) the MillionSong fits (``data_root/msd``) on an NCCL mesh
    of every card, held against the one-device fits of phases 3, 3g and 3b
    (``refs``), with K12's exchange suite, whose figures go into ``real``;
    (b) phase 2's data set (``small``) on two ranks of one card over gloo,
    held against one-rank card fits made here; (c) (b) over NCCL, which (a)
    covers when there are two or more cards.  Returns the launch counts of
    (a)'s and (b)'s rank 0."""
    import torch

    n_cards = torch.cuda.device_count()
    results, run, wall = spawn_ranks("msd", n_cards, "nccl",
                                     ["cuda:%d" % r for r in range(n_cards)],
                                     os.path.join(data_root, "msd"), save=("coo", "svi"),
                                     suite=True)
    check_ranks_equal("msd", results)
    r0 = results[0]
    print("[3j] (a) NCCL mesh of %d rank(s), one per card (%s), MillionSong shape, float32: "
          "the ranks ran %.1f s (their fits %.1f s); the ranks hold bit-equal arrays; they "
          "exited %s s after writing their results (the group torn down at exit)"
          % (n_cards, r0["device"], wall, r0["fits_s"],
             ", ".join("%.2f" % res["exit_s"] for res in results)))
    for name, unit in (("ell", "s/iteration"), ("coo", "s/iteration"), ("svi", "s/epoch")):
        ref = refs[name]
        verdict = check_against_one_device("3j", name, r0[name], ref, run, "float32", n_cards)
        print("[3j] %s fit on the mesh: %.4f %s (one device, phase %s: %.4f), wall %.3f s; "
              "llk at checks %s; against the one-device fit: %s"
              % (name, dp_s_per_it(r0[name]), unit, {"ell": "3", "coo": "3g", "svi": "3b"}[name],
                 ref["s_per_it"], r0[name]["wall"], r0[name]["llk"], verdict))
    print("[3j] partial_fit of a %d-user batch on the mesh's SVI model: wall %.3f ms"
          % (DP_PARTIAL_FIT_USERS["msd"], r0["partial_fit"]["wall_ms"]))
    for name, ex in r0["exchanges"].items():
        print("[3j] %-21s exchange %.4f ms (a device copy of its bytes %.4f ms; bound %.4f ms), "
              "%d bytes; the whole sharded function %.4f ms against %.4f ms on one device; "
              "max abs error against one device %.3e%s"
              % (name, ex["ms"], ex["plain_ms"], ex["bound_ms"], ex["bytes"], ex["fn_ms"],
                 ex["one_device_ms"], ex["max_abs_err"],
                 "".join("; %s %s" % (k, v) for k, v in ex.items()
                         if k in ("segments_per_rank", "triplets_per_rank", "batch_triplets"))))
        real[name] = ex
    launches_dp = {k: sum(r0[f]["launches"][k] for f in dp_fit_names("msd"))
                   for k in counters}
    print("[3j] launch counters, the mesh's fits (rank 0):", json.dumps(launches_dp))
    ts_step = r0["ts_step"]
    shutil.rmtree(run)
    torch.cuda.empty_cache()

    small_dir = os.path.join(data_root, "small")
    for part, c in small.items():
        save_triplets(os.path.join(small_dir, part), c)
    small_refs = {}
    dp_fits("small", small, None, "cuda", counters,
            save=lambda name, m: small_refs.__setitem__(name, fit_reference(m, None)))
    results, run, wall = spawn_ranks("small", 2, "gloo", ["cuda:0", "cuda:0"], small_dir,
                                     save=("coo", "svi", "partial_fit"))
    check_ranks_equal("small", results)
    print("[3j] (b) two ranks on one card over gloo (named), phase 2's data set (%d "
          "triplets), float64: the ranks ran %.1f s; the ranks hold bit-equal arrays; they "
          "exited %s s after writing their results"
          % (small["all"].nnz, wall, ", ".join("%.2f" % res["exit_s"] for res in results)))
    for name in dp_fit_names("small"):
        verdict = check_against_one_device("3j (b)", name, results[0][name], small_refs[name],
                                           run, "float64", 2)
        print("[3j] (b) %s against the one-rank card fit: %s" % (name, verdict))
    launches_dp_gloo = {k: sum(results[0][f]["launches"][k]
                               for f in dp_fit_names("small"))
                        for k in counters}
    shutil.rmtree(run)
    if n_cards >= 2:
        print("[3j] (c) NCCL over %d cards: (a) ran the MillionSong fits and the partial_fit "
              "on every card, ranks bit-equal" % n_cards)
    else:
        print("[3j] (c) NCCL over two or more cards: skipped, this machine has one card")
    return launches_dp, launches_dp_gloo, ts_step


# -- 3k. the table-sharded engine ---------------------------------------------------
# The table-sharded fit (float32, 10 iterations) against phase 3's
# one-device fit, max relative difference of the llk at the checks and of
# Theta and Beta: every sum the same but for the order of the cross-rank
# colsums and of the sub-tiled segments, so the two fits part by float32
# rounding that ten iterations grow.  Measured on an H100, two gloo ranks
# on one card: llk 2.7e-9, Theta 2.8e-5, Beta 4.0e-5; the limits are ~10x
# that (a fixed run is deterministic; another rank count sums in another
# order)
TS_LIMITS = dict(llk=3e-8, factors=4e-4)
# the same fit with bfloat16 exp tables (``gather_dtype='bfloat16'``, the
# ring carrying bfloat16 shards) against phase 3h's one-device bfloat16 fit:
# where a float32 difference straddles a bfloat16 rounding boundary a table
# entry moves by a whole bfloat16 step, and the smallest factors part by
# percents while the llk agrees (phase 4's AGREE_BF16 describes the same).
# Measured on an H100, two gloo ranks on one card: llk 9.6e-9, Theta
# 5.2e-2, Beta 7.9e-2; the llk limit is ~10x that, the factors' ~6x (they
# are bounded by the bfloat16 steps, not by the sums' order)
TS_BF16_LIMITS = dict(llk=1e-7, factors=5e-1)
# the fits of a table-sharded mesh (DP_FITS["ts"]) and the limits each is
# held to against its one-device fit
TS_FITS = {"ts": TS_LIMITS, "ts_bf16": TS_BF16_LIMITS}
# K3's pad-row form against its plain version: the padding rows exactly
# (rate +inf, scaler 0, mean and tab +0.0), the real rows as ``compare``
# holds them (``bf16_tab_check`` for a bfloat16 tab)


def pad_check(n_real):
    def check(name, got, ref, dtype_name):
        import torch

        shp, rte, tab, scaler, _ = got
        if not (torch.isinf(rte[n_real:]).all() and not scaler[n_real:].any()):
            raise AssertionError(f"{name}: a padding row's rate is finite or its scaler not 0")
        for zero in (shp[n_real:] / rte[n_real:], tab[n_real:]):
            if zero.any() or torch.signbit(zero).any():
                raise AssertionError(f"{name}: a padding row's mean or tab is not +0.0")
        real = [g[:n_real] for g in got[:4]] + [got[4]]
        want = [r[:n_real] for r in ref[:4]] + [ref[4]]
        return (bf16_tab_check if tab.dtype == torch.bfloat16 else compare)(name, real, want,
                                                                         dtype_name)
    return check


def ts_plain_ring_sums(mesh, t_self, t_other, share, shards=None):
    """The plain version of K13a: the same ring, the plain K1 per bucket
    and the plain K2."""
    import torch

    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.parallel import table_sharded as TS

    seg = [None] * len(share.ell.buckets)
    for o, buf in enumerate(shards if shards is not None else TS.ring(mesh, t_other)):
        for j in share.by_offset[o]:
            b = share.ell.buckets[j]
            seg[j] = E._bucket_phi_sums_plain(t_self, buf, b.rows, b.cols, b.vals, b.col_off)
    return E._segment_table_sums_plain(torch.cat(seg), share.ell)


def ts_work(share, t_self, t_other_shard, world):
    """(HBM bytes, link bytes, operations, intermediate bytes) of one side's
    K13a as a function: the rank's layout slots and index arrays, its own
    rows of the table and each opposite shard read once, its (per, k) sums
    written; 4k flops a real slot (K1); (W - 1) opposite shards over the
    link.  The segment sums that K1 writes and K2 reads back are an
    intermediate of the composition: their round trip is the fourth
    figure, outside the bound."""
    k = t_self.shape[1]
    acc = 8 if t_self.dtype.itemsize == 8 else 4  # K1's accumulation dtype
    lay = sum(nbytes(b.rows, b.cols, b.vals) for b in share.ell.buckets)
    nnz = sum(int((b.vals != 0).sum()) for b in share.ell.buckets)
    hbm = (lay + nbytes(share.ell.inv_perm, share.ell.split_seg_pos, share.ell.split_indptr)
           + nbytes(t_self) + world * nbytes(t_other_shard) + share.ell.n_rows * k * acc)
    return (hbm, (world - 1) * nbytes(t_other_shard), nnz * 4 * k,
            2 * share.ell.n_segs * k * acc)


def ts_bound(hbm, link, ops):
    """Least time (ms): the larger of HBM bytes at 3.35 TB/s, link bytes at
    NVLink's rate each way, and float32 operations at 67 TFLOP/s."""
    t = {"bytes": hbm / PEAK_BYTES * 1e3, "link": link / PEAK_LINK * 1e3,
         "operations": ops / PEAK_OPS["float32"] * 1e3}
    by = max(t, key=t.get)
    return t[by], "bytes" if by == "link" else by


def ts_cases(mesh, ts, carry, reps):
    """The table-sharded engine's parts on one rank of ``mesh``, from
    ``carry`` (float32 tables) on the rank's rows of the engine ``ts``:
    K1 as the ring launches it (once a ring offset, both sides, each offset
    against the rank's own shard, which has every shard's shape; on the
    tables and on them rounded to bfloat16; also held bit for bit against
    one launch a bucket), K13a (both sides' ring phi sums), K13c (one train
    check), K3's pad-row form (both sides' updates) and K13b (one step),
    each against its plain
    version (the same ring and composition with the plain K1, K2, K3 and
    K4; raises beyond ``compare``'s float32 tolerance, or where a padding
    row is not inert) and timed with CUDA events beside its bound (HBM,
    link and operations; ``inter_bytes``: the intermediates' round trip,
    outside the bound).  Every rank runs the same collectives in the same
    order."""
    import torch

    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M
    from hpfrec_tpu_torch.parallel import table_sharded as TS

    W, hp, f32 = mesh.world_size, Hyperparams(k=K), torch.float32
    st = carry.state
    sides = ((carry.t_tab, carry.b_tab, ts.u), (carry.b_tab, carry.t_tab, ts.i))
    sides16 = tuple((a.bfloat16(), b.bfloat16(), sh) for a, b, sh in sides)

    def k1_offsets(tabs):  # one launch a ring offset, into each side's segment sums
        segs = []
        for a, b, sh in tabs:
            segs.append(torch.empty((sh.ell.n_segs, K), dtype=f32, device=a.device))
            for view in sh.offsets:
                E.all_bucket_sums(a, b, view, out=segs[-1])
        return segs

    def k1_buckets(tabs):  # one launch a bucket, the same bits
        return [bucket_by_bucket(a, b, sh.ell) for a, b, sh in tabs]

    def k1_plain(tabs):
        return [torch.cat([E._bucket_phi_sums_plain(a, b, bk.rows, bk.cols, bk.vals, bk.col_off)
                           for bk in sh.ell.buckets]) for a, b, sh in tabs]

    def k1_work(tabs):  # layouts (real slots' cols), own rows, W shards, sums out; 4k a slot
        lay = sum(nbytes(b.rows, b.vals) + 4 * int((b.vals != 0).sum())
                  for _, _, sh in tabs for b in sh.ell.buckets)
        nnz = sum(int((b.vals != 0).sum()) for _, _, sh in tabs for b in sh.ell.buckets)
        return (lay + sum(nbytes(a) + W * nbytes(b) + sh.ell.n_segs * K * 4 for a, b, sh in tabs),
                0, nnz * 4 * K, 0)
    su, si = (TS.ring_table_sums(mesh, a, b, sh, f32) for a, b, sh in sides)
    upd = ((su, st.k_rte, carry.beta_colsum, hp.a, hp.k_shp, hp.add_k_rte, None, ts.u.n_real),
           (si, st.t_rte, carry.theta_colsum, hp.c, hp.t_shp, hp.add_t_rte, None, ts.i.n_real))
    Theta, Beta = st.G_shp / st.G_rte, st.L_shp / st.L_rte

    def llk_plain():
        parts = []
        for o, buf in enumerate(TS.ring(mesh, Beta)):
            parts += [M._bucket_llk_plain(Theta, buf, b.rows, b.cols, b.vals, b.col_off, False)
                      for b in (ts.u.ell.buckets[j] for j in ts.u.by_offset[o])]
        return torch.cat(parts).sum(0)

    def step_plain():
        sums = [ts_plain_ring_sums(mesh, a, b, sh) for a, b, sh in sides]
        G = C._side_update_plain(sums[0], *upd[0][1:])
        cs = TS.all_gather_rows(mesh, G[4]).sum(0, keepdim=True)
        L = C._side_update_plain(sums[1], st.t_rte, cs, hp.c, hp.t_shp, hp.add_t_rte, None,
                                 ts.i.n_real)
        return list(G[:4]) + list(L[:4])

    def step():  # shp, rte, tab, scaler of each side, as step_plain gives them
        c = TS.table_sharded_step(mesh, carry, ts.u, ts.i, hp)
        s_ = c.state
        return [s_.G_shp, s_.G_rte, c.t_tab, s_.k_rte, s_.L_shp, s_.L_rte, c.b_tab, s_.t_rte]

    def step_check(name, got, ref, dn):  # the real rows (padding rows' rates are +inf)
        return max((compare(name, [g[:n] for g in got[i:i + 4]], [r[:n] for r in ref[i:i + 4]],
                            dn) for i, n in ((0, ts.u.n_real), (4, ts.i.n_real))),
                   key=lambda e: e[0])

    w_a = [x + y for x, y in zip(ts_work(ts.u, carry.t_tab, carry.b_tab, W),
                                 ts_work(ts.i, carry.b_tab, carry.t_tab, W))]
    tabs = nbytes(st.G_shp) + nbytes(st.L_shp)
    elems = st.G_shp.numel() + st.L_shp.numel()
    nnz_u = sum(int((b.vals != 0).sum()) for b in ts.u.ell.buckets)
    work = {
        "ell_phi_sums_offset": k1_work(sides),
        "ell_phi_sums_offset_bf16": k1_work(sides16),
        "ring_table_sums": w_a,
        # Theta's rows, every Beta shard, the user layout; a dot (2k) and ~6
        # operations a slot
        "table_sharded_llk_parts": (nbytes(Theta) + W * nbytes(Beta)
                                    + sum(nbytes(b.rows, b.cols, b.vals) for b in ts.u.ell.buckets),
                                    (W - 1) * nbytes(Beta), nnz_u * (2 * K + 6), 0),
        # sums in; shp, rte, tab out (K3's row)
        "table_update_pad": (4 * tabs, 0, 35 * elems, 0),
        # K13a's reads, then shp, rte and tab written: the sums between K13a
        # and K3 are an intermediate, like the segments
        "table_sharded_step": (w_a[0] + 2 * tabs, w_a[1], w_a[2] + 35 * elems,
                               w_a[3] + 2 * tabs),
    }
    cases = {
        "ell_phi_sums_offset": (lambda: k1_offsets(sides), lambda: k1_plain(sides)),
        "ell_phi_sums_offset_bf16": (lambda: k1_offsets(sides16), lambda: k1_plain(sides16)),
        "ring_table_sums": (lambda: [TS.ring_table_sums(mesh, a, b, sh, f32) for a, b, sh in sides],
                            lambda: [ts_plain_ring_sums(mesh, a, b, sh) for a, b, sh in sides]),
        "table_sharded_llk_parts": (
            lambda: TS.table_sharded_llk_parts(mesh, Theta, Beta, ts.u, False).sum(0),
            llk_plain),
        "table_update_pad": (lambda: [C.side_update(*u) for u in upd],
                             lambda: [C._side_update_plain(*u) for u in upd]),
        "table_sharded_step": (step, step_plain),
    }
    out = {}
    for name, (kern, plain) in cases.items():
        got, ref = kern(), plain()
        if name == "table_update_pad":
            err = max((pad_check(u[7])(name, g, r, "float32") for u, g, r in zip(upd, got, ref)),
                      key=lambda e: e[0])
        elif name == "table_sharded_step":
            err = step_check(name, got, ref, "float32")
        else:
            err = compare(name, got, ref, "float32")
        if name.startswith("ell_phi_sums_offset"):
            bits_check(name + " against a bucket a launch", got,
                       k1_buckets(sides16 if name.endswith("bf16") else sides), "float32")
        hbm, link, ops, inter = work[name]
        b_ms, b_by = ts_bound(hbm, link, ops)
        out[name] = dict(ms=cuda_ms(kern, reps), plain_ms=cuda_ms(plain, reps), bound_ms=b_ms,
                         bound_by=b_by, library_ms=None, max_abs_err=err[0], max_rel_err=err[1],
                         bytes=int(hbm), link_bytes=int(link), ops=int(ops),
                         inter_bytes=int(inter))
    return out


def ts_windows():
    """The sub-tile windows that phase 3k (b) times, name -> ``window_bytes``:
    untiled shards, JAX's 40 MB (a TPU figure) and a width near half the
    H100's 50 MB L2."""
    from hpfrec_tpu_torch.parallel import table_sharded as TS

    return {"untiled": TS.UNTILED, "40 MB (JAX)": 40 * 2 ** 20, "25 MB": 25 * 2 ** 20}


def ts_step_suite(mesh, data, model, reps):
    """Phase 3k (b), in the NCCL rank(s) of 3j (a): the table-sharded engine
    built and called directly on that mesh (one rank on most machines: the
    ring is K1 a ring offset with no exchange, and ``HPF`` never takes the
    engine there) at the MillionSong shape, from the ELL fit's state, on
    the plan of each window of ``ts_windows``: its step, ring phi sums
    (K13a) and train metric (K13c) timed beside the one-device ELL step;
    on the card's window (``CARD_WINDOW_BYTES``, the fit's) ``ts_cases``,
    and the step against the one-device step from the same state.  The
    windows' figures are under the key "windows"."""
    import torch

    from hpfrec_tpu_torch.models.state import Hyperparams, state_from_numpy
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.parallel import table_sharded as TS
    from hpfrec_tpu_torch.utils.data import build_csr, process_data

    dev, W = mesh.device, mesh.world_size
    pdata = process_data(data["all"], "train-llk", False, np.float32, sort_by_user=True)
    nU, nI = pdata.nusers, pdata.nitems
    csr = (*build_csr(pdata.ix_u, pdata.ix_i, pdata.y, nU, nI),
           *build_csr(pdata.ix_i, pdata.ix_u, pdata.y, nI, nU))
    host = state_from_numpy([model.Gamma_shp, model.Gamma_rte, model.Lambda_shp,
                             model.Lambda_rte, model.k_rte, model.t_rte], "cpu")
    hp = Hyperparams(k=K)
    lay_u, lay_i = (E.to_device(h, dev) for h in E.build_layouts(pdata, np.float32))
    one = C._carry_init(type(host)(*[a.to(dev) for a in host]))
    one_ms = cuda_ms(lambda: E.cavi_step_ell_carried(one, lay_u, lay_i, hp), reps)
    windows, out = {}, None
    for name, window in ts_windows().items():
        t0 = time.perf_counter()
        plan = TS.prepare_table_sharded(*csr, nU, nI, K, W, 4, dtype=np.float32,
                                        window_bytes=window)
        host_pack_s = time.perf_counter() - t0
        ts = TS.TableSharded(mesh, plan, nU, nI, dev)
        carry = ts.carry_init(ts.shard_state(host))
        Theta, Beta = (s_ / r_ for s_, r_ in ((carry.state.G_shp, carry.state.G_rte),
                                              (carry.state.L_shp, carry.state.L_rte)))
        windows[name] = dict(
            window_bytes=window, n_sub=[plan.plan_u[2], plan.plan_i[2]],
            buckets=[len(ts.u.ell.buckets), len(ts.i.ell.buckets)],
            segments=[ts.u.ell.n_segs, ts.i.ell.n_segs], host_pack_s=host_pack_s,
            step_ms=cuda_ms(lambda: TS.table_sharded_step(mesh, carry, ts.u, ts.i, hp), reps),
            ring_ms=cuda_ms(lambda: [TS.ring_table_sums(mesh, a, b, sh, torch.float32)
                                     for a, b, sh in ((carry.t_tab, carry.b_tab, ts.u),
                                                      (carry.b_tab, carry.t_tab, ts.i))], reps),
            llk_ms=cuda_ms(lambda: TS.table_sharded_llk_parts(mesh, Theta, Beta, ts.u, False),
                           reps),
            one_device_ms=one_ms)
        if window == TS.CARD_WINDOW_BYTES:
            out = ts_cases(mesh, ts, carry, reps)
            got = [a.to(dev) for a in
                   ts.real_state(TS.table_sharded_step(mesh, carry, ts.u, ts.i, hp).state)]
            ref = list(E.cavi_step_ell_carried(one, lay_u, lay_i, hp).state)
            vs_one = compare("table-sharded step vs one device", got, ref, "float32")
            out["table_sharded_step"].update(
                one_device_ms=one_ms, vs_one_device=list(vs_one), host_pack_s=host_pack_s,
                world=W, window=name, n_sub=windows[name]["n_sub"],
                buckets=windows[name]["buckets"])
        del plan, ts, carry, Theta, Beta
        torch.cuda.empty_cache()
    if out is None:
        raise AssertionError(f"the card's window {TS.CARD_WINDOW_BYTES} is not among "
                             f"{ts_windows()}")
    out["windows"] = windows
    return out


def ts_split(mesh, engine, state, reps):
    """Phase 3k (a), in each rank: one iteration of the table-sharded fit
    split by part, from its last state (CUDA events, ms, both sides): K1 on
    the buckets of each ring offset (one launch a side), a whole ring pass
    of each side's
    table with nothing computed (on gloo with CUDA tables: staged through
    the host), K2, K3's pad-row form, one cross-rank colsum (three an
    iteration), and the whole step.  Every rank runs the same collectives
    in the same order."""
    import torch

    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.parallel import table_sharded as TS

    hp = Hyperparams(k=K)
    carry = engine.carry_init(state)
    st = carry.state
    sides = ((carry.t_tab, carry.b_tab, engine.u), (carry.b_tab, carry.t_tab, engine.i))
    segs = [torch.empty((sh.ell.n_segs, K), dtype=torch.float32, device=a.device)
            for a, _, sh in sides]

    def k1(o):
        for (a, b, sh), seg in zip(sides, segs):
            E.all_bucket_sums(a, b, sh.offsets[o], out=seg)

    def ring_pass():
        for a, b, _ in sides:
            for _ in TS.ring(mesh, b):
                pass

    for o in range(mesh.world_size):
        k1(o)
    su, si = (E.segment_table_sums(seg, sh.ell) for seg, (_, _, sh) in zip(segs, sides))
    out = {"k1_offset_%d" % o: cuda_ms(lambda o=o: k1(o), reps) for o in range(mesh.world_size)}
    out.update(
        ring_pass=cuda_ms(ring_pass, reps),
        k2=cuda_ms(lambda: [E.segment_table_sums(seg, sh.ell) for seg, (_, _, sh)
                            in zip(segs, sides)], reps),
        k3_pad=cuda_ms(lambda: (
            C.side_update(su, st.k_rte, carry.beta_colsum, hp.a, hp.k_shp, hp.add_k_rte, None,
                          engine.u.n_real),
            C.side_update(si, st.t_rte, carry.theta_colsum, hp.c, hp.t_shp, hp.add_t_rte, None,
                          engine.i.n_real)), reps),
        colsum_exchange=cuda_ms(lambda: TS.cross_rank_colsum(mesh, carry.beta_colsum), reps),
        step=cuda_ms(lambda: TS.table_sharded_step(mesh, carry, engine.u, engine.i, hp), reps),
        shard_bytes=[nbytes(carry.t_tab), nbytes(carry.b_tab)],
        real_rows=[engine.u.n_real, engine.i.n_real])
    return out


def ts_cases_report(tag, cases):
    """Print the engine's parts of one rank against their plain versions
    (``ts_cases``)."""
    for name, r in cases.items():
        print("[%s] %-24s max abs %.3e  max rel %.3e  kernel %.4f ms  plain %.4f ms  bound "
              "%.4f ms (%s; %d HBM bytes, %d link bytes, %d ops; intermediates %d bytes)"
              % (tag, name, r["max_abs_err"], r["max_rel_err"], r["ms"], r["plain_ms"],
                 r["bound_ms"], r["bound_by"], r["bytes"], r["link_bytes"], r["ops"],
                 r["inter_bytes"]))


def ts_fit_report(tag, results, run, wall, refs):
    """A table-sharded mesh's fits (``spawn_ranks`` of the "ts" task)
    against their one-device fits ``refs`` (fit name -> ``fit_reference``):
    the ranks bit-equal, the llk at the checks and Theta, Beta within
    ``TS_FITS``' limits, the bfloat16-table fit on bfloat16 kernels only;
    prints each fit, each rank's iteration split and its parts against
    their plain versions (``ts_cases``, which raised on a rank that
    failed); raises beyond the limits.  Returns rank 0's launch counts,
    summed over the fits."""
    check_ranks_equal("ts", results)
    r0 = results[0]
    print("[%s] %d ranks (%s), MillionSong shape, float32 state, shard_tables=True: the ranks "
          "ran %.1f s (their fits %.1f s); the ranks hold bit-equal arrays"
          % (tag, len(results), r0["device"], wall, r0["fits_s"]))
    for name, lim in TS_FITS.items():
        res, ref = r0[name], refs[name]
        llk, ref_llk = np.array(res["llk"]), np.array(ref["llk"])
        if res["niter"] != ref["niter"] or llk.shape != ref_llk.shape:
            raise AssertionError(f"{tag} {name}: {res['niter']} iterations against "
                                 f"{ref['niter']}")
        dev_llk = float(np.abs(llk / ref_llk - 1).max())
        dev_f = {a: float(np.abs(np.load(os.path.join(run, "%s_%s.npy" % (name, a))) / ref[a]
                                 - 1).max()) for a in ("Theta", "Beta")}
        print("[%s] %s fit phases (s): %s; %.4f s/iteration (one device: %.4f); llk at checks "
              "%s against %s: max rel %.3e (limit %g); Theta, Beta max rel %.3e, %.3e (limit %g)"
              % (tag, name, json.dumps({k: round(v, 3) for k, v in res["phases"].items()}),
                 dp_s_per_it(res), ref["s_per_it"], res["llk"], ref["llk"], dev_llk, lim["llk"],
                 dev_f["Theta"], dev_f["Beta"], lim["factors"]))
        if dev_llk > lim["llk"] or max(dev_f.values()) > lim["factors"]:
            raise AssertionError(f"{tag}: the {name} fit is off its one-device fit: llk "
                                 f"{dev_llk:.3e}, factors {dev_f}")
    bf = r0["ts_bf16"]["launches"]
    if bf["ell_phi_sums_offset"] or bf["table_update_pad"] or bf["table_derive"]:
        raise AssertionError(f"{tag}: the bfloat16-table fit ran a state-dtype table kernel: {bf}")
    for name in TS_FITS:  # K1 once a ring offset (that has buckets), in no other form
        lc = r0[name]["launches"]
        other = {n: lc[n] for n in ("ell_phi_sums", "ell_phi_sums_bf16", "ell_phi_sums_bucket",
                                    "ell_phi_sums_bucket_bf16") if lc[n]}
        k1 = lc["ell_phi_sums_offset"] + lc["ell_phi_sums_offset_bf16"]
        if other or not lc["ring_table_sums"] <= k1 <= len(results) * lc["ring_table_sums"]:
            raise AssertionError(f"{tag} {name}: K1 is not one launch a ring offset: {k1} "
                                 f"over {lc['ring_table_sums']} ring calls; other forms {other}")
        print("[%s] %s fit: K1 %d launches over %d ring_table_sums calls of %d ring offsets"
              % (tag, name, k1, lc["ring_table_sums"], len(results)))
    for r, res in enumerate(results):
        print("[%s] rank %d, one iteration by part (ms): %s" % (tag, r, json.dumps(res["split"])))
        ts_cases_report("%s, rank %d" % (tag, r), res["ts_cases"])
    launches = {k: sum(r0[f]["launches"][k] for f in TS_FITS) for k in r0["ts"]["launches"]}
    print("[%s] launch counters (rank 0, both fits): %s" % (tag, json.dumps(launches)))
    return launches


def ts_cards(data_dir, refs, n_cards):
    """Phase 3k (d), with two or more cards: (a)'s fits on an NCCL mesh of
    every card (the ring's ``batch_isend_irecv`` over NVLink), held and
    reported as (a)'s.  Returns rank 0's launch counts."""
    results, run, wall = spawn_ranks("ts", n_cards, "nccl",
                                     ["cuda:%d" % r for r in range(n_cards)], data_dir,
                                     save=tuple(TS_FITS))
    launches = ts_fit_report("3k (d), NCCL over %d cards" % n_cards, results, run, wall, refs)
    shutil.rmtree(run)
    return launches


def phase_3k(data_root, refs, real, ts_step, small):
    """Phase 3k: (a) the table-sharded fits of the MillionSong shape
    (float32 and bfloat16 tables) on two gloo ranks of the one card, held
    against phases 3 and 3h's fits (``refs``), every rank's engine parts
    against their plain versions on its fitted state, whose rank-0 figures
    go into ``real``; (b) the engine's parts on the NCCL mesh of 3j, from
    ``ts_step`` (3j's rank 0); (c) each rank's half of K13a and K3's
    pad-row form against their plain versions on phase 2's data set
    (``small``); (d) with two or more cards, (a) over NCCL on every card.
    Returns the launch counts of (a)'s rank 0 and of (d)'s (None on one
    card)."""
    import torch

    msd = os.path.join(data_root, "msd")
    results, run, wall = spawn_ranks("ts", 2, "gloo", ["cuda:0", "cuda:0"], msd,
                                     save=tuple(TS_FITS))
    launches_ts = ts_fit_report("3k (a), gloo on one card", results, run, wall, refs)
    real.update(results[0]["ts_cases"])
    shutil.rmtree(run)
    windows = ts_step.pop("windows")
    st = ts_step["table_sharded_step"]
    for name, w in windows.items():
        print("[3k (b)] window %-12s sub-tiles a shard %s, buckets %s, segments %s, host_pack "
              "%.3f s: step %.4f ms (one device %.4f ms), ring phi sums %.4f ms, train metric "
              "%.4f ms" % (name, w["n_sub"], w["buckets"], w["segments"], w["host_pack_s"],
                           w["step_ms"], w["one_device_ms"], w["ring_ms"], w["llk_ms"]))
    print("[3k (b)] the engine on the NCCL mesh of 3j (%d rank(s)), MillionSong shape, from "
          "the ELL fit's state, the card's window (%s; host_pack of the sharded layouts %.3f s; "
          "sub-tiles a shard %s, buckets %s):" % (st["world"], st["window"], st["host_pack_s"],
                                                  st["n_sub"], st["buckets"]))
    ts_cases_report("3k (b)", ts_step)
    print("[3k (b)] one step: %.4f ms on the engine, %.4f ms on one device (phase 3's ELL "
          "step); the states after it: max abs %.3e, max rel %.3e"
          % (st["ms"], st["one_device_ms"], *st["vs_one_device"]))
    ts_halves_check(small, torch.device("cuda"))
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print("[3k (d)] NCCL over two or more cards: skipped, this machine has one card")
        return launches_ts, None
    return launches_ts, ts_cards(msd, refs, n_cards)


def ts_halves_check(small, dev):
    """Phase 3k (c): every rank's half of K13a (two ranks, in this process,
    the ring's shards handed in) against its plain version and, reassembled,
    against the one-device E-step; K3's pad-row form (both tab dtypes) on
    rank 0's users against its plain version; float32 and float64, on
    ``small`` (phase 2's data set) from a random state."""
    import torch

    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.parallel import table_sharded as TS
    from hpfrec_tpu_torch.utils.data import build_csr, process_data

    hp = Hyperparams(k=K)
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        pdata = process_data(small, "train-llk", False, dtype, sort_by_user=True)
        nU, nI = pdata.nusers, pdata.nitems
        csr_u = build_csr(pdata.ix_u, pdata.ix_i, pdata.y, nU, nI)
        csr_i = build_csr(pdata.ix_i, pdata.ix_u, pdata.y, nI, nU)
        plan = TS.prepare_table_sharded(*csr_u, *csr_i, nU, nI, K, 2, dtype().itemsize,
                                        dtype=dtype)
        st = random_state(nU, nI, dtype, "cpu", 11)
        full = TS.permute_state(TS.pad_state(st, plan.plan_u[0], plan.plan_i[0]), plan.perm_u,
                                plan.perm_i)
        t_pad = C._side_derive_plain(full.G_shp, full.G_rte)[0].to(dev)
        b_pad = C._side_derive_plain(full.L_shp, full.L_rte)[0].to(dev)
        slot = [torch.from_numpy(np.argsort(p, kind="stable")[:n]).to(dev)
                for p, n in ((plan.perm_u, nU), (plan.perm_i, nI))]
        one = {}
        for side, (se, perm, n, mine, opp, csr) in enumerate(
                ((plan.se_u, plan.perm_u, nU, t_pad, b_pad, csr_u),
                 (plan.se_i, plan.perm_i, nI, b_pad, t_pad, csr_i))):
            per, per_opp = se.rows_per_dev, se.per_opp
            got_all = []
            for d in range(2):
                share = TS.rank_share(se, d, dev, perm, n)
                shards = [opp[e * per_opp:(e + 1) * per_opp] for e in ((d - o) % 2 for o in (0, 1))]
                rows = mine[d * per:(d + 1) * per]
                got = TS.ring_table_sums(None, rows, None, share, shards=shards)
                one["ring_table_sums side %d rank %d" % (side, d)] = compare(
                    "ring_table_sums", got, ts_plain_ring_sums(None, rows, None, share, shards),
                    name)
                got_all.append(got)
                if side == 0 and d == 0:  # K3's pad-row form on rank 0's users
                    u0 = (got, full.k_rte[:per].to(dev),
                          torch.full((1, K), 30.0, dtype=got.dtype, device=dev), hp.a, hp.k_shp,
                          hp.add_k_rte)
                    for tab_dtype in (None, torch.bfloat16):
                        u = (*u0, tab_dtype, share.n_real)
                        one["table_update_pad %s tab" % ("bfloat16" if tab_dtype else "state")] = (
                            pad_check(share.n_real)("table_update_pad", C.side_update(*u),
                                                    C._side_update_plain(*u), name))
            # the halves reassembled against the one-device E-step
            whole = E.ell_phi_sums(mine[slot[side]], opp[slot[1 - side]],
                                   E.to_device(E.build_ell(*csr, n, dtype=dtype), dev))
            one["reassembled side %d vs one device" % side] = compare(
                "reassembled", torch.cat(got_all)[slot[side]], whole, name)
        print("[3k] (c) %s, phase 2's data set, two ranks in this process (max abs, max rel): %s"
              % (name, "; ".join("%s %.3e %.3e" % (k, *v) for k, v in one.items())))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from hpfrec_tpu_torch import HPF, _cuda, _native
    from hpfrec_tpu_torch.models.state import state_from_numpy
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import svi as S
    from hpfrec_tpu_torch.utils import evaluation as EV
    from hpfrec_tpu_torch.utils.data import process_data

    warnings.filterwarnings("ignore", message="When using 'partial_fit'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = kernel_counters()
    reset_counts = lambda: reset_counters(counters)  # noqa: E731
    read_counts = lambda: read_counters(counters)  # noqa: E731

    t_start = time.perf_counter()

    def stamp(phase):
        print("[time] %s starts %.1f s into the run" % (phase, time.perf_counter() - t_start))

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print("[1] card (nvidia-smi name, power.limit):", smi)
    print("[1] torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0), "count", torch.cuda.device_count())
    t0 = time.perf_counter()
    _cuda.load()
    print("[1] kernels built/loaded in %.1f s" % (time.perf_counter() - t0))
    print("[1] native host helpers loaded:", _native.available(),
          "with OpenMP" if _native.get() else "without OpenMP",
          "" if _native.available() else "(%s)" % _native.load_error())

    # -- 2. kernel checks at ~1M nonzeros, k=50, f32 and f64 ---------------
    stamp("phase 2")
    coo_small = powerlaw_coo(26_000, 9_700, 1_000_000, seed=3)
    train_small, val_small = holdout(coo_small, 0.01, seed=4)
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        lay_u, lay_i, pdata, slots = layouts_for(coo_small, dtype, dev)
        print("[2] kernel checks, %s, %d nonzeros, %d slots, k=%d (times per iteration)"
              % (name, pdata.y.shape[0], slots, K))
        state = random_state(pdata.nusers, pdata.nitems, dtype, dev, 1)
        kernel_suite(lay_u, lay_i, state, name, reps=5)
        print("[2] COO engine (K7c) and bfloat16-table (K1, K3) kernel checks, %s" % name)
        coo_suite(pdata, state, name, reps=5)
        bf16_suite(lay_u, lay_i, state, name, reps=5)
        del lay_u, lay_i
        print("[2] SVI kernel checks, %s, batches %s, %d held-out triplets for the COO llk"
              % (name, SMALL_BATCHES, val_small.nnz))
        svi_suite(process_data(train_small, "val-llk", False, dtype),
                  val_blocked(val_small, dtype, dev), state, SMALL_BATCHES, name, reps=5,
                  blend_all=(False, True))
        print("[2] serving and fold-in kernel checks, %s: 256 users, n=10 and 2,000; "
              "fold-in of the heaviest user and the user nearest 10 items; 1M pairs" % name)
        tables = HPF(k=K, use_float=dtype == np.float32, ncores=1, device="cuda")
        host = [a.cpu().numpy() for a in state]
        tables.Theta, tables.Beta = host[0] / host[1], host[2] / host[3]
        tables.Lambda_shp, tables.Lambda_rte = host[2], host[3]
        csr = train_small.tocsr()
        deg = np.diff(csr.indptr)
        hist = [(csr.indices[csr.indptr[u]:csr.indptr[u + 1]], csr.data[csr.indptr[u]:csr.indptr[u + 1]])
                for u in (int(np.argmax(deg)), int(np.argmin(np.abs(deg - 10))))]
        rng = np.random.default_rng(8)
        serving_suite(tables, np.arange(256), (csr.indptr[:-1], csr.indices, deg), (10, 2000),
                      hist, (rng.integers(0, pdata.nusers, 1 << 20), rng.integers(0, pdata.nitems, 1 << 20)),
                      (val_small.row, val_small.col), name, reps=3)
        del state, tables

    # -- 3. the full-batch path at the MillionSong shape ----------------------
    stamp("phase 3")
    t0 = time.perf_counter()
    coo = powerlaw_coo(**MILLIONSONG, seed=0)
    print("[3] data: %d x %d, %d nonzeros, generated in %.1f s"
          % (*coo.shape, coo.nnz, time.perf_counter() - t0))

    RecordingHPF = recording_hpf()

    model = RecordingHPF(k=K, stop_crit="train-llk", check_every=5, maxiter=10,
                         random_seed=1, device="cuda")
    model.llk_trace = []
    reset_counts()
    model.fit(coo)
    launches_fb = read_counts()
    st = model.fit_stats_
    iters = model.niter + 1
    print("[3] fit phases (s):", json.dumps({k: round(v, 3) for k, v in st.phases.items()}))
    print("[3] wall %.3f s, %d iterations, %.4f s/iteration (iterations phase), "
          "%.4g nonzero-updates/s (iterations phase), %.4g end to end"
          % (st.wall_seconds, iters, st.phases["iterations"] / iters,
             st.nnz * iters / st.phases["iterations"], st.nnz_per_second))
    print("[3] train llk at checks:", model.llk_trace)
    print("[3] launch counters:", json.dumps(launches_fb))
    llk = np.array(model.llk_trace)
    if not (len(llk) == 2 and np.all(np.isfinite(llk)) and llk[1] > llk[0]):
        raise AssertionError(f"train llk not finite and ascending: {llk}")
    fb_kernels = ("ell_phi_sums", "segment_table_sums", "table_update", "table_derive", "ell_llk")
    if min(launches_fb[n] for n in fb_kernels) <= 0:
        raise AssertionError(f"a kernel of the full-batch path never launched: {launches_fb}")
    users = [0, 1, 12345]
    for u in users:
        rec = model.topN(u, n=5)
        if rec.shape != (5,):
            raise AssertionError(f"topN({u}) gave {rec}")
        print("[3] topN(user=%d, n=5):" % u, rec.tolist())
    pred = model.predict(np.array(users), np.array([0, 7, 100]))
    if pred.shape != (3,) or not np.all(np.isfinite(pred)) or np.any(pred < 0):
        raise AssertionError(f"predict gave {pred}")
    print("[3] predict(users %s, items [0, 7, 100]):" % users, pred.tolist())
    ell_fit = dict(llk=list(model.llk_trace), niter=model.niter,
                   s_per_it=st.phases["iterations"] / iters,
                   arrays={n: getattr(model, n) for n in STATE_NAMES})
    ell_ref = fit_reference(model, ell_fit["s_per_it"])

    lay_u, lay_i, _, slots = layouts_for(coo, np.float32, dev)
    fitted = state_from_numpy([model.Gamma_shp, model.Gamma_rte, model.Lambda_shp,
                               model.Lambda_rte, model.k_rte, model.t_rte], dev)
    print("[3] kernel checks at the fit's shapes (float32, fitted state, %d slots; "
          "times per iteration, both sides; ell_llk per check)" % slots)
    real = kernel_suite(lay_u, lay_i, fitted, "float32", reps=3)
    digamma_sweep((("log sweep of [1e-4, 1e7]", np.logspace(-4, 7, 1_000_001)),
                   ("the fit's shapes", np.concatenate([model.Gamma_shp.ravel(),
                                                         model.Lambda_shp.ravel()]))),
                  dev, "3")
    del lay_u, lay_i, fitted, model
    torch.cuda.empty_cache()

    # -- 3b. the SVI path at the MillionSong shape ----------------------------
    stamp("phase 3b")
    train, val = holdout(coo, 0.01, seed=5)
    print("[3b] SVI: %d training and %d held-out triplets, batches %s"
          % (train.nnz, val.nnz, SVI_BATCHES))
    model = RecordingHPF(k=K, stop_crit="val-llk", check_every=2, maxiter=6, random_seed=1,
                         device="cuda", **SVI_BATCHES)
    model.llk_trace = []
    reset_counts()
    model.fit(train, val_set=val)
    launches_val = read_counts()
    reset_counts()
    ev = model.eval_llk(val)
    launches_eval = read_counts()
    check = RecordingHPF(k=K, stop_crit="train-llk", check_every=1, maxiter=2,
                         random_seed=1, device="cuda", verbose=False, **SVI_BATCHES)
    check.llk_trace = []
    reset_counts()
    check.fit(train)
    launches_train = read_counts()
    st = model.fit_stats_
    epochs = model.niter + 1
    n_user = sum((i + 1) % 2 == 0 for i in range(epochs))
    n_item = epochs - n_user
    print("[3b] fit phases (s):", json.dumps({k: round(v, 3) for k, v in st.phases.items()}))
    print("[3b] wall %.3f s, %d epochs (%d user, %d item), %.4f s per user epoch, %.4f s per "
          "item epoch, %.4g nonzero-updates/s (epoch phases), %.4g end to end"
          % (st.wall_seconds, epochs, n_user, n_item, st.phases["user_epochs"] / n_user,
             st.phases["item_epochs"] / n_item,
             st.nnz * epochs / (st.phases["user_epochs"] + st.phases["item_epochs"]),
             st.nnz_per_second))
    print("[3b] val llk at checks:", model.llk_trace)
    svi_ref = fit_reference(model, (st.phases["user_epochs"] + st.phases["item_epochs"]) / epochs)
    print("[3b] eval_llk(val):", ev)
    print("[3b] train-llk SVI fit (2 epochs): train llk at checks", check.llk_trace,
          "phases (s):", json.dumps({k: round(v, 3) for k, v in check.fit_stats_.phases.items()}))
    print("[3b] launch counters, val-llk fit:", json.dumps(launches_val))
    print("[3b] launch counters, eval_llk:", json.dumps(launches_eval))
    print("[3b] launch counters, train-llk SVI fit:", json.dumps(launches_train))
    trace = np.array(model.llk_trace + check.llk_trace)
    if not (len(model.llk_trace) >= 1 and np.all(np.isfinite(trace))):
        raise AssertionError(f"llk trace not finite: {trace}")
    if not (np.isfinite(ev["llk"]) and ev["nobs"] == val.nnz):
        raise AssertionError(f"eval_llk gave {ev}")
    svi_kernels = ("table_derive", "batch_phi_sums", "svi_update", "epoch_gather", "row_mask")
    for path, counts, kernels in (("val-llk SVI fit", launches_val, (*svi_kernels, "coo_llk")),
                                  ("eval_llk", launches_eval, ("coo_llk",)),
                                  ("train-llk SVI fit", launches_train, (*svi_kernels, "ell_llk"))):
        if min(counts[n] for n in kernels) <= 0:
            raise AssertionError(f"a kernel of the {path} never launched: {counts}")
    for u in users:
        rec = model.topN(u, n=5)
        if rec.shape != (5,):
            raise AssertionError(f"topN({u}) gave {rec}")
    print("[3b] topN(user=%d, n=5):" % users[-1], rec.tolist())
    pred = model.predict(np.array(users), np.array([0, 7, 100]))
    if pred.shape != (3,) or not np.all(np.isfinite(pred)) or np.any(pred < 0):
        raise AssertionError(f"predict gave {pred}")
    print("[3b] predict(users %s, items [0, 7, 100]):" % users, pred.tolist())

    fitted = state_from_numpy([model.Gamma_shp, model.Gamma_rte, model.Lambda_shp,
                               model.Lambda_rte, model.k_rte, model.t_rte], dev)
    del check
    print("[3b] SVI kernel checks at the fit's shapes (float32, fitted state; times for a "
          "user epoch + an item epoch (K9), a user batch + the rank-1 item's batch (K7, K8), "
          "the validation set (K5))")
    real.update(svi_suite(process_data(train, "val-llk", False, np.float32),
                          val_blocked(val, np.float32, dev), fitted, SVI_BATCHES, "float32",
                          reps=3))
    del fitted
    torch.cuda.empty_cache()

    # -- 3c. the diff-norm and the maxiter-with-validation paths ----------------
    stamp("phase 3c")
    one_epoch = dict(k=K, maxiter=1, check_every=1, random_seed=1, device="cuda",
                     users_per_batch=SVI_BATCHES["users_per_batch"])
    dn = HPF(stop_crit="diff-norm", verbose=False, **one_epoch)
    reset_counts()
    dn.fit(train)
    launches_dn = read_counts()
    print("[3c] diff-norm SVI fit (1 user epoch): wall %.3f s; launch counters %s"
          % (dn.fit_stats_.wall_seconds, json.dumps(launches_dn)))
    mv = HPF(stop_crit="maxiter", verbose=True, **one_epoch)
    reset_counts()
    mv.fit(train, val_set=val)
    launches_mv = read_counts()
    print("[3c] maxiter SVI fit with the validation set (1 user epoch): wall %.3f s, final "
          "llk %.6g; launch counters %s"
          % (mv.fit_stats_.wall_seconds, mv.train_llk, json.dumps(launches_mv)))
    if not np.isfinite(mv.train_llk):
        raise AssertionError("maxiter fit: final llk not finite")
    for path, counts, kernel in (("diff-norm fit", launches_dn, "theta_diff_norm"),
                                 ("maxiter fit's final eval", launches_mv, "rowsum_dot_rows")):
        if counts[kernel] <= 0:
            raise AssertionError(f"{kernel} never launched on the {path}: {counts}")
    del dn, mv
    torch.cuda.empty_cache()

    # -- 3d. serving on the SVI fit ---------------------------------------------
    stamp("phase 3d")
    rng = np.random.default_rng(11)
    serve_users = rng.choice(model.nusers, SERVE_USERS, replace=False)
    val_users = rng.choice(np.unique(val.row), SERVE_USERS, replace=False)
    pu, pi = rng.integers(0, model.nusers, 100_000), rng.integers(0, model.nitems, 100_000)
    calls = {"topN_batch": lambda: model.topN_batch(serve_users, n=10),
             "topN_batch n=2000": lambda: model.topN_batch(serve_users[:1024], n=2000),
             "ranking_metrics": lambda: EV.ranking_metrics(model, val, k=10, users=val_users),
             "predicted_rate_stats": lambda: EV.predicted_rate_stats(model, val),
             "roc_auc": lambda: EV.roc_auc(model, val),
             "predict": lambda: model.predict(pu, pi)}
    reset_counts()
    serving = {name: walled(call) for name, call in calls.items()}
    launches_serving = read_counts()
    print("[3d] wall: each call on its own; device split: a second run under torch.profiler")
    for name, (out, wall) in serving.items():
        prof = profiled(calls[name])[1]
        per = (" (%.3f ms per 1,024 users)" % (wall * 1024 / SERVE_USERS)
               if name in ("topN_batch", "ranking_metrics") else "")
        print("[3d] %s: wall %.3f ms%s; device busy %.3f ms (kernels %.3f, copies to the card "
              "%.3f, back %.3f), host %.3f ms; top device work: %s"
              % (name, wall, per, prof["busy_ms"], prof["kernel_ms"], prof["h2d_ms"],
                 prof["d2h_ms"], wall - prof["busy_ms"], prof["top"]))
    rec = serving["topN_batch"][0]
    rank = serving["ranking_metrics"][0]
    stats = serving["predicted_rate_stats"][0]
    auc = serving["roc_auc"][0]
    pred = serving["predict"][0]
    print("[3d] ranking_metrics:", json.dumps(rank), "| predicted_rate_stats:",
          json.dumps(stats), "| roc_auc: %.6f" % auc)
    print("[3d] launch counters, serving:", json.dumps(launches_serving))
    seen_of = lambda u: model.seen[model._st_ix_user[u]:model._st_ix_user[u] + model._n_seen_by_user[u]]  # noqa: E731
    if (rec.shape != (SERVE_USERS, 10) or any(len(set(r)) != 10 for r in rec[:256].tolist())
            or any(np.isin(rec[j], seen_of(u)).any() for j, u in enumerate(serve_users[:256]))):
        raise AssertionError("topN_batch: wrong shape, repeated or seen items")
    if not (rank["n_users"] == SERVE_USERS and 0 <= rank["recall"] <= 1
            and 0 <= rank["ndcg"] <= 1 and 0 < auc < 1 and stats["n_pairs"] == val.nnz
            and np.isfinite(stats["lift"])):
        raise AssertionError(f"evaluation gave {rank}, {stats}, {auc}")
    if pred.shape != (100_000,) or not np.all(np.isfinite(pred)) or np.any(pred < 0):
        raise AssertionError("predict of 100,000 pairs: not finite and non-negative")
    np.testing.assert_allclose(pred[:50], np.einsum("ij,ij->i", model.Theta[pu[:50]],
                                                    model.Beta[pi[:50]]), rtol=1e-5)
    big = serving["topN_batch n=2000"][0]
    if big.shape != (1024, 2000) or not np.array_equal(big[:, :10], rec[:1024]):
        raise AssertionError("topN_batch n=2000: wrong shape, or its first 10 are not n=10's")
    for kernel in ("topn", "topn_large", "predict_pairs"):
        if launches_serving[kernel] <= 0:
            raise AssertionError(f"{kernel} never launched on the serving path")

    # -- 3e. K6, K10 and K11 at the serving and online shapes --------------------
    stamp("phase 3e")
    deg = model._n_seen_by_user
    heavy = int(np.argmax(deg))
    ten = int(np.argmin(np.abs(deg - 10)))
    hist_rows = np.concatenate([[heavy], rng.choice(model.nusers, ONLINE["histories"] - 1,
                                                    replace=False)])
    histories = user_histories(train, hist_rows)
    print("[3e] serving and fold-in kernel checks (float32, the SVI fit's tables): one "
          "1,024-user chunk at n=10 and n=2,000, fold-in of user %d (%d items) and user %d "
          "(%d items), 4M pairs (and 100,000 and the held-out set's), the held-out rowsum, "
          "the diff norm"
          % (heavy, deg[heavy], ten, deg[ten]))
    r3e, extra = serving_suite(model, serve_users[:1024].astype(np.int64),
                               (model._st_ix_user, model.seen, deg), (10, 2000),
                               [histories[0], user_histories(train, [ten])[0]],
                               (rng.integers(0, model.nusers, 1 << 22),
                                rng.integers(0, model.nitems, 1 << 22)),
                               (val.row, val.col), "float32", reps=3)
    real.update(r3e)
    torch.cuda.empty_cache()

    # -- 3f. online updates on the SVI fit ----------------------------------------
    stamp("phase 3f")
    nU0 = model.nusers
    pick_u = np.zeros(model.nusers, dtype=bool)
    pick_u[rng.choice(model.nusers, ONLINE["user_batch"], replace=False)] = True
    pick_i = np.zeros(model.nitems, dtype=bool)
    pick_i[rng.choice(model.nitems, ONLINE["item_batch"], replace=False)] = True
    top = nU0 - ONLINE["grow"] - 1
    grow_rows = (train.row > top - 10_000) & (train.row <= top)
    triplets = lambda m: np.column_stack([train.row[m], train.col[m], train.data[m]])  # noqa: E731
    per_call = {}  # label -> ms of each single-user call of the last run

    def each(label, fn, args):
        per_call[label] = []
        for a in args:
            t0 = time.perf_counter()
            fn(a)
            torch.cuda.synchronize()
            per_call[label].append((time.perf_counter() - t0) * 1e3)

    # (label, call, many): a call made of many small calls runs twice,
    # first on its own for its wall time, then under the profiler for its
    # device split (the profiler's per-op overhead would swamp its wall);
    # the others run once, under the profiler
    pf = "predict_factors x %d (the heaviest user first)" % ONLINE["histories"]
    au = "add_user x %d, fold-in" % ONLINE["new_users"]
    calls = [("partial_fit, %d-user batch" % ONLINE["user_batch"],
              lambda b=triplets(pick_u[train.row]): model.partial_fit(b), False),
             ("partial_fit, %d-item batch" % ONLINE["item_batch"],
              lambda b=triplets(pick_i[train.col]): model.partial_fit(b, batch_type="items"),
              False),
             ("partial_fit, new_users=True (+%d users)" % ONLINE["grow"],
              lambda b=triplets(grow_rows): model.partial_fit(b, new_users=True, random_seed=3),
              False),
             (pf, lambda: each(pf, lambda h: model.predict_factors(np.column_stack(h)),
                               histories), True),
             (au, lambda: each(au, lambda h: model.add_user(model.nusers, np.column_stack(h)),
                               histories[1:1 + ONLINE["new_users"]]), True),
             ("add_user x %d, update_all_params (maxiter=2)" % ONLINE["all_params"],
              lambda: [model.add_user(int(u), np.column_stack(h), update_existing=True,
                                      update_all_params=True, maxiter=2)
                       for u, h in zip(hist_rows[-ONLINE["all_params"]:],
                                       histories[-ONLINE["all_params"]:])], False)]
    sort_s = [0.0]
    group_by_rows = S.group_by_rows

    def timed_group(rows):
        t0 = time.perf_counter()
        out = group_by_rows(rows)
        sort_s[0] += time.perf_counter() - t0
        return out

    hits = []
    state_from_host = model._state_from_host

    def traced_state():
        cached = model._dev_state_cache
        state = state_from_host()
        hits.append(cached is not None and state is cached[1])
        return state

    S.group_by_rows = timed_group
    model._state_from_host = traced_state
    reset_counts()
    walls = {}
    for label, call, many in calls:
        sort_s[0] = 0.0
        hits.clear()
        if many:
            wall, prof = walled(call)[1], None
        else:
            prof = profiled(call)[1]
            wall = prof["wall_ms"]
        walls[label] = (wall, prof, sort_s[0] * 1e3, list(hits), per_call.get(label))
    S.group_by_rows = group_by_rows
    del model._state_from_host
    launches_online = read_counts()
    if model.nusers != nU0 + ONLINE["grow"] + ONLINE["new_users"]:
        raise AssertionError(f"online growth: {nU0} users became {model.nusers}")
    print("[3f] predict_factors and add_user: the wall of a run on its own, the device split "
          "of a second run under torch.profiler; the others: one run under the profiler")
    for label, call, many in calls:
        wall, prof, sort_ms, hit, ms = walls[label]
        if prof is None:
            prof = profiled(call)[1]
        state = ("device state: %d of %d calls found it cached" % (sum(hit), len(hit))
                 if hit else "no device state")
        print("[3f] %s: wall %.3f ms; host sort %.3f ms; %s; device busy %.3f ms (kernels "
              "%.3f, copies to the card %.3f, back to the host %.3f); other host work %.3f ms;"
              " top device work: %s"
              % (label, wall, sort_ms, state, prof["busy_ms"], prof["kernel_ms"],
                 prof["h2d_ms"], prof["d2h_ms"], wall - prof["busy_ms"] - sort_ms, prof["top"]))
        if ms:
            print("[3f]   per call: the first %.3f ms, the median of the others %.3f ms, the "
                  "largest %.3f ms" % (ms[0], np.median(ms[1:]), max(ms)))
    print("[3f] launch counters, online:", json.dumps(launches_online))
    for name in ("Theta", "Beta", "Gamma_shp", "Lambda_shp", "k_rte", "t_rte"):
        if not np.all(np.isfinite(getattr(model, name))):
            raise AssertionError(f"online updates: {name} not finite")
    for kernel in ("fold_in", "table_derive", "batch_phi_sums", "svi_update", "row_mask"):
        if launches_online[kernel] <= 0:
            raise AssertionError(f"{kernel} never launched on the online path")
    torch.cuda.empty_cache()

    def fit_line(tag, m, ref_s_per_it):
        st = m.fit_stats_
        iters = m.niter + 1
        print("[%s] fit phases (s):" % tag, json.dumps({k: round(v, 3) for k, v in st.phases.items()}))
        print("[%s] wall %.3f s, %d iterations, %.4f s/iteration (iterations phase; the float32 "
              "ELL fit of phase 3: %.4f), %.4g nonzero-updates/s (iterations phase), %.4g end "
              "to end" % (tag, st.wall_seconds, iters, st.phases["iterations"] / iters,
                          ref_s_per_it, st.nnz * iters / st.phases["iterations"],
                          st.nnz_per_second))

    def against_ell(tag, m, what, limit):
        llk = np.array(m.llk_trace)
        ref = np.array(ell_fit["llk"])
        if not (len(llk) == 2 and np.all(np.isfinite(llk)) and llk[1] > llk[0]):
            raise AssertionError(f"{what}: train llk not finite and ascending: {llk}")
        dev_llk = np.abs(llk / ref - 1).max()
        dev = {n: np.abs(getattr(m, n) / ell_fit["arrays"][n] - 1).max() for n in ("Theta", "Beta")}
        print("[%s] train llk at checks: %s %s, the float32 ELL fit (phase 3) %s; max rel %.3e "
              "(limit %g); max rel difference of the factors: Theta %.3e, Beta %.3e"
              % (tag, what, m.llk_trace, ell_fit["llk"], dev_llk, limit, dev["Theta"],
                 dev["Beta"]))
        if dev_llk > limit:
            raise AssertionError(f"{what}: llk differs from the ELL fit's by {dev_llk:.3e}")

    # -- 3g. the blocked-COO engine at the MillionSong shape ---------------------
    stamp("phase 3g")
    coo_fit = RecordingHPF(engine="coo", k=K, stop_crit="train-llk", check_every=5, maxiter=10,
                           random_seed=1, device="cuda")
    coo_fit.llk_trace = []
    # each iteration between CUDA events (the fit runs its blocks through
    # ops.cavi.run_cavi_block_coo; here one iteration a call)
    iter_events, coo_block = [], C.run_cavi_block_coo

    def timed_block(carry, stream, niter, hp, phi_sums=C.coo_phi_sums):
        for _ in range(int(niter)):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            carry = coo_block(carry, stream, 1, hp, phi_sums)
            ev[1].record()
            iter_events.append(ev)
        return carry

    reset_counts()
    C.run_cavi_block_coo = timed_block
    try:
        coo_fit.fit(coo)
    finally:
        C.run_cavi_block_coo = coo_block
    launches_coo = read_counts()
    fit_line("3g", coo_fit, ell_fit["s_per_it"])
    print("[3g] each iteration on the card (CUDA events, ms): %s; from the first's start to the "
          "last's end %.3f ms" % (", ".join("%.3f" % a.elapsed_time(b) for a, b in iter_events),
                                  iter_events[0][0].elapsed_time(iter_events[-1][1])))
    coo_ref = fit_reference(coo_fit, coo_fit.fit_stats_.phases["iterations"] / (coo_fit.niter + 1))
    against_ell("3g", coo_fit, "COO fit", COO_VS_ELL_LLK)
    print("[3g] launch counters:", json.dumps(launches_coo))
    if min(launches_coo[n] for n in ("coo_phi_sums", "coo_llk", "table_update")) <= 0:
        raise AssertionError(f"a kernel of the COO path never launched: {launches_coo}")
    if any(launches_coo[n] for n in ("ell_phi_sums", "ell_phi_sums_bf16", "ell_phi_sums_bucket",
                                     "ell_phi_sums_bucket_bf16", "ell_llk")):
        raise AssertionError(f"the COO fit ran an ELL kernel: {launches_coo}")
    lay_u, lay_i, pdata_full, _ = layouts_for(coo, np.float32, dev)
    fitted = state_from_numpy([coo_fit.Gamma_shp, coo_fit.Gamma_rte, coo_fit.Lambda_shp,
                               coo_fit.Lambda_rte, coo_fit.k_rte, coo_fit.t_rte], dev)
    hp = coo_fit._hp()
    del coo_fit
    # the fit's own stream: ids reindexed in order of first appearance
    pdata_fit = process_data(coo, "train-llk", True, np.float32)
    print("[3g] K7c check at the fit's shapes (float32, fitted state, the fit's stream of %d "
          "triplets; times per iteration, both sides)" % pdata_fit.y.shape[0])
    real.update(coo_suite(pdata_fit, fitted, "float32", reps=3))
    stream = C.coo_stream(pdata_full, dev)
    t_tab, b_tab = C.side_derive(fitted.G_shp, fitted.G_rte)[0], C.side_derive(
        fitted.L_shp, fitted.L_rte)[0]
    print("[3g] K7c with ids in popularity order (item 0 the rank-1 item): %.4f ms"
          % cuda_ms(lambda: C.coo_phi_sums(t_tab, b_tab, stream), 3))
    stream = C.coo_stream(pdata_fit, dev)
    print("[3g] K5 over the fit's train stream (its train metric: %d triplets in %d blocks, "
          "float32, fitted state; times per check)" % (stream.nnz, stream.data.y.shape[0]))
    real["coo_llk"]["coo_train_stream"] = run_cases(
        {"coo_llk": coo_llk_case(fitted.G_shp / fitted.G_rte, fitted.L_shp / fitted.L_rte,
                                 stream.data)}, "float32", 3, ", the COO train stream")["coo_llk"]
    carry = C._carry_init(fitted)
    _, prof = profiled(lambda: C.run_cavi_block_coo(carry, stream, 2, hp))
    print("[3g] two COO iterations (the fit's stream) under torch.profiler: wall %.3f ms, "
          "device busy %.3f ms (kernels %.3f); top device work: %s"
          % (prof["wall_ms"], prof["busy_ms"], prof["kernel_ms"], prof["top"]))
    del pdata_full, pdata_fit, fitted, stream, carry, t_tab, b_tab
    torch.cuda.empty_cache()

    # -- 3h. bfloat16 gather tables at the MillionSong shape ---------------------
    stamp("phase 3h")
    bf = RecordingHPF(gather_dtype="bfloat16", k=K, stop_crit="train-llk", check_every=5,
                      maxiter=10, random_seed=1, device="cuda")
    bf.llk_trace = []
    reset_counts()
    bf.fit(coo)
    launches_bf16 = read_counts()
    fit_line("3h", bf, ell_fit["s_per_it"])
    against_ell("3h", bf, "bfloat16-table fit", BF16_VS_F32_LLK)
    print("[3h] launch counters:", json.dumps(launches_bf16))
    bf16_kernels = ("ell_phi_sums_bf16", "table_update_bf16", "table_derive_bf16",
                    "segment_table_sums", "ell_llk")
    if min(launches_bf16[n] for n in bf16_kernels) <= 0:
        raise AssertionError(f"a kernel of the bfloat16 path never launched: {launches_bf16}")
    if (launches_bf16["ell_phi_sums"] or launches_bf16["ell_phi_sums_bucket"]
            or launches_bf16["table_update"]):
        raise AssertionError(f"the bfloat16 fit ran a state-dtype table kernel: {launches_bf16}")
    fitted = state_from_numpy([bf.Gamma_shp, bf.Gamma_rte, bf.Lambda_shp, bf.Lambda_rte,
                               bf.k_rte, bf.t_rte], dev)
    bf_ref = fit_reference(bf, bf.fit_stats_.phases["iterations"] / (bf.niter + 1))
    del bf
    print("[3h] bfloat16-table kernel checks at the fit's shapes (float32 state, fitted; times "
          "per iteration, both sides)")
    r3h = bf16_suite(lay_u, lay_i, fitted, "float32", reps=3)
    real.update(r3h)
    print("[3h] K1 per iteration: bfloat16 tables %.4f ms, float32 tables %.4f ms (phase 3); "
          "K3 update %.4f ms against %.4f ms"
          % (r3h["ell_phi_sums_bf16"]["ms"], real["ell_phi_sums"]["ms"],
             r3h["table_update_bf16"]["ms"], real["table_update"]["ms"]))
    del lay_u, lay_i, fitted
    torch.cuda.empty_cache()

    # -- 3i. persistence at full size ---------------------------------------------
    stamp("phase 3i")
    with tempfile.TemporaryDirectory(prefix="hpf_smoke_") as tmp:
        ck = os.path.join(tmp, "ck")
        kw = dict(k=K, stop_crit="train-llk", check_every=5, random_seed=1, device="cuda",
                  verbose=False, checkpoint_folder=ck, checkpoint_every=5)
        reset_counts()
        first = HPF(maxiter=5, **kw).fit(coo)
        resumed = HPF(maxiter=10, **kw).fit(coo, resume=True)
        launches_resume = read_counts()
        ref = ell_fit["arrays"]
        equal = all(np.array_equal(getattr(resumed, n), ref[n]) for n in STATE_NAMES)
        dev_resume = max(np.abs(getattr(resumed, n) / ref[n] - 1).max() for n in STATE_NAMES)
        ck_bytes = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        print("[3i] checkpoint writes: %.3f s (iteration 5), %.3f s (iteration 10), %d bytes "
              "each; resumed fit (5 + 5 iterations) against phase 3's 10: %s, max rel %.3e; "
              "launch counters %s"
              % (first.fit_stats_.phases["checkpoints"], resumed.fit_stats_.phases["checkpoints"],
                 ck_bytes, "bit-equal" if equal else "not bit-equal", dev_resume,
                 json.dumps(launches_resume)))
        if resumed.niter != ell_fit["niter"] or dev_resume > RESUME_LIMIT:
            raise AssertionError(f"the resumed fit differs from the uninterrupted one: "
                                 f"niter {resumed.niter}, max rel {dev_resume:.3e}")
        del first, resumed
        path = os.path.join(tmp, "model")
        _, save_ms = walled(lambda: model.save(path))
        loaded, load_ms = walled(lambda: HPF.load(path))
        model_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        some = serve_users[:1024]
        same = np.array_equal(loaded.topN_batch(some, n=10), model.topN_batch(some, n=10))
        print("[3i] save of the SVI model after the online updates (%d users): wall %.3f ms, %d "
              "bytes; load: wall %.3f ms; topN_batch(n=10) of 1,024 users after the load: %s"
              % (model.nusers, save_ms, model_bytes, load_ms, "equal" if same else "DIFFERENT"))
        if not same or loaded.nusers != model.nusers:
            raise AssertionError("the loaded model serves other top-n lists")
        del loaded
    data_root = tempfile.mkdtemp(prefix="hpf_dp_data_")
    try:
        save_triplets(os.path.join(data_root, "msd", "all"), coo)
        del model, train, val, coo
        torch.cuda.empty_cache()

        # -- 3j. data parallel ----------------------------------------------------
        stamp("phase 3j")
        launches_dp, launches_dp_gloo, ts_step = phase_3j(
            data_root, dict(ell=ell_ref, coo=coo_ref, svi=svi_ref),
            {"all": coo_small, "train": train_small, "val": val_small}, counters, real)
        torch.cuda.empty_cache()

        # -- 3k. the table-sharded engine -------------------------------------------
        stamp("phase 3k")
        launches_ts, launches_ts_cards = phase_3k(data_root, dict(ts=ell_ref, ts_bf16=bf_ref),
                                                  real, ts_step, coo_small)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- 4. agreement and determinism at a small size -----------------------
    stamp("phase 4")
    small = counts_coo(120, 80, 2000, seed=42)
    small_train, small_val = holdout(small, 0.1, seed=43)
    paths = (("full batch", AGREE, dict(maxiter=60, check_every=10, stop_crit="train-llk"),
              (small,), {}),
             ("SVI", AGREE_SVI, dict(maxiter=10, check_every=2, stop_crit="val-llk",
                                     users_per_batch=25, items_per_batch=17),
              (small_train,), dict(val_set=small_val)),
             ("COO full batch", AGREE, dict(engine="coo", maxiter=60, check_every=10,
                                            stop_crit="train-llk"), (small,), {}),
             ("COO SVI", AGREE_SVI, dict(engine="coo", maxiter=10, check_every=2,
                                         stop_crit="train-llk", users_per_batch=25,
                                         items_per_batch=17), (small_train,), {}),
             ("bfloat16 tables, full batch", AGREE_BF16,
              dict(gather_dtype="bfloat16", maxiter=10, check_every=5, stop_crit="train-llk"),
              (small,), {}))
    for label, limits, opts, args, fit_kw in paths:
        for use_float in (True, False):
            dtype_name = "float32" if use_float else "float64"
            lim = limits[dtype_name]
            kw = dict(k=8, stop_thr=1e-10, random_seed=123, use_float=use_float,
                      verbose=False, **opts)
            runs = []
            for device in ("cuda", "cuda", "cpu"):
                m = RecordingHPF(device=device, **kw)
                m.llk_trace = []
                runs.append(m.fit(*args, **fit_kw))
            a, b, cpu = runs
            if not (np.array_equal(a.Theta, b.Theta) and np.array_equal(a.Beta, b.Beta)
                    and a.llk_trace == b.llk_trace):
                raise AssertionError(f"{label}: two card runs differ")
            dev_llk = np.abs(np.array(a.llk_trace) / np.array(cpu.llk_trace) - 1).max()
            dev_theta = np.abs(a.Theta / cpu.Theta - 1).max()
            dev_beta = np.abs(a.Beta / cpu.Beta - 1).max()
            print("[4] %s, %s: card runs bit-identical; card vs CPU max rel: llk trajectory "
                  "%.3e (limit %g), Theta %.3e, Beta %.3e (limit %g); Theta, Beta max abs / "
                  "max value %.3e, %.3e"
                  % (label, dtype_name, dev_llk, lim["llk"], dev_theta, dev_beta,
                     lim["factors"],
                     np.abs(a.Theta - cpu.Theta).max() / np.abs(cpu.Theta).max(),
                     np.abs(a.Beta - cpu.Beta).max() / np.abs(cpu.Beta).max()))
            if dev_llk > lim["llk"]:
                raise AssertionError(f"{label}: card and CPU trajectories disagree")
            if max(dev_theta, dev_beta) > lim["factors"]:
                raise AssertionError(f"{label}: card and CPU factors disagree")

    stamp("phase 4b")
    agree_online()

    stamp("phase 4c")
    persistence_small(small)

    # -- 5. results -----------------------------------------------------------
    stamp("phase 5")
    kernels = []
    paths = {"full_batch": launches_fb, "svi_val": launches_val, "eval_llk": launches_eval,
             "svi_train": launches_train, "svi_diffnorm": launches_dn,
             "svi_maxiter_val": launches_mv, "serving": launches_serving,
             "online": launches_online, "coo": launches_coo, "bf16": launches_bf16,
             "resume": launches_resume, "dp": launches_dp, "dp_gloo": launches_dp_gloo,
             "ts": launches_ts}
    if launches_ts_cards is not None:
        paths["ts_cards"] = launches_ts_cards
    for name, r in real.items():
        src, rep = REPLACES[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "bytes": r["bytes"], "ops": r["ops"],
                        **{key: r[key] for key in ("coo_train_stream",) if key in r}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def ts_cards_main():
    """``--ts-cards``: phase 3k (d) alone, for a machine with two or more
    cards: the kernels built, phase 3's data, the one-device fits of phases
    3 and 3h on card 0 that (d) is held against, then (d).  Exits non-zero
    with fewer than two cards or on a failed check."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --ts-cards: needs two or more CUDA cards", file=sys.stderr)
        return 1
    from hpfrec_tpu_torch import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print("[1] cards (nvidia-smi name, power.limit):", smi.replace("\n", "; "))
    t0 = time.perf_counter()
    _cuda.load()
    print("[1] kernels built/loaded in %.1f s" % (time.perf_counter() - t0))
    coo = powerlaw_coo(**MILLIONSONG, seed=0)
    refs = {}
    for name, kw in (("ts", {}), ("ts_bf16", dict(gather_dtype="bfloat16"))):
        m = recording_hpf()(k=K, stop_crit="train-llk", check_every=5, maxiter=10, random_seed=1,
                            device="cuda:0", verbose=False, **kw)
        m.llk_trace = []
        m.fit(coo)
        refs[name] = fit_reference(m, m.fit_stats_.phases["iterations"] / (m.niter + 1))
        del m
    torch.cuda.empty_cache()
    data_root = tempfile.mkdtemp(prefix="hpf_ts_cards_")
    try:
        save_triplets(os.path.join(data_root, "all"), coo)
        del coo
        ts_cards(data_root, refs, torch.cuda.device_count())
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-rank":
        sys.exit(dp_rank_main(sys.argv[2]))
    if sys.argv[1:] == ["--ts-cards"]:
        sys.exit(ts_cards_main())
    sys.exit(main())
