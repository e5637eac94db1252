"""Smoke run of hpfrec_tpu_torch on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its lines; any failure propagates and the script exits
non-zero, with no result line):

1. device and build: the card (nvidia-smi name and power limit), the
   kernel build from csrc/ and whether the native host helpers loaded;
2. kernel checks: each CUDA kernel against its plain PyTorch version on
   the card, float32 and float64, k=50, on a ~1M-nonzero power-law layout;
3. the main path at the MillionSong TasteProfile shape (1,019,318 users x
   376,768 items, 38.7M nonzeros, k=50, float32; data made here from a
   seed): ``HPF(...).fit`` with train-llk checks, launch counters, then
   ``topN`` and ``predict``; then every kernel checked and timed against
   its plain version at the shapes of that fit;
4. agreement and determinism at a small size: two card fits are
   bit-identical, and the card agrees with the CPU path;
5. a JSON line of the kernels, and the result line.

Without a CUDA device, or without the package beside it, it exits non-zero.
"""

import json
import subprocess
import sys
import time

import numpy as np

MILLIONSONG = dict(nU=1_019_318, nI=376_768, nnz=38_700_000)
K = 50
# kernel vs plain version on the card: |kernel - plain| <= atol + rtol |plain|,
# atol = ATOL_FRAC * max|plain|.  float32: sums over up to 8192 slots and
# the hand-written digamma differ from PyTorch's in order and rounding.
TOL = {"float32": dict(rtol=1e-4, atol_frac=1e-6),
       "float64": dict(rtol=1e-10, atol_frac=1e-12)}
# card vs CPU path at a small size (phase 4), 60 iterations: max relative
# difference of the llk trajectory, and of every element of Theta and Beta.
# Measured on an H100: float64 llk 4.4e-15, Theta 3.7e-12, Beta 1.3e-11;
# float32 llk 3.9e-7, Theta 4.97e-3, Beta 1.08e-3.  In float32 the factors
# drift further apart than the llk: 60 iterations grow a ~1e-6 one-step
# difference, most in the smallest entries (relative to the largest entry
# the gap is 1.7e-4).
AGREE = {"float32": dict(llk=2e-5, factors=6e-3),
         "float64": dict(llk=1e-9, factors=1e-9)}
REPLACES = {
    "ell_phi_sums": ("hpfrec_tpu_torch/csrc/ell_phi_sums.cu", "hpfrec_tpu/ops/ell.py:447"),
    "segment_table_sums": ("hpfrec_tpu_torch/csrc/segment_sums.cu", "hpfrec_tpu/ops/ell.py:574"),
    "table_update": ("hpfrec_tpu_torch/csrc/table_update.cu", "hpfrec_tpu/ops/cavi.py:50"),
    "table_derive": ("hpfrec_tpu_torch/csrc/table_update.cu", "hpfrec_tpu/ops/ell.py:743"),
    "ell_llk": ("hpfrec_tpu_torch/csrc/ell_llk.cu", "hpfrec_tpu/ops/metrics.py:79"),
}


def powerlaw_coo(nU, nI, nnz, seed):
    """User-sorted COO with Zipf item popularity (bench.py:45-54), as a scipy
    coo_array so that no pandas is needed."""
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
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / r64.abs().clamp_min(1e-300)).max()))
        if bool(bad.any()):
            raise AssertionError(f"{name} {dtype_name}: kernel differs from plain "
                                 f"(max abs {max_abs:.3e}, max rel {max_rel:.3e}, "
                                 f"rtol {tol['rtol']})")
    return max_abs, max_rel


def kernel_suite(lay_u, lay_i, state, dtype_name, reps):
    """Check and time each kernel against its plain version on the card,
    over what one iteration runs (both sides; K4: one check).  ``state``: a
    VariationalState on the card.  Returns {name: (abs, rel, ms,
    plain_ms)}."""
    import torch

    from hpfrec_tpu_torch.models.state import Hyperparams
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M

    hp = Hyperparams(k=state.k)
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

    def flat(*results):
        return [t for r in results for t in (r if isinstance(r, tuple) else (r,))]

    cases = {
        "ell_phi_sums": (lambda: flat(*(E.all_bucket_sums(*side) for side in sides)),
                         lambda: flat(*(phi_plain(*side) for side in sides))),
        "segment_table_sums": (
            lambda: flat(*(E.segment_table_sums(seg, side[2]) for seg, side in zip(segs, sides))),
            lambda: flat(*(E._segment_table_sums_plain(seg, side[2])
                           for seg, side in zip(segs, sides)))),
        "table_update": (lambda: flat(*(C.side_update(*u) for u in upd)),
                         lambda: flat(*(C._side_update_plain(*u) for u in upd))),
        "table_derive": (lambda: flat(*(C.side_derive(*p) for p in pairs)),
                         lambda: flat(*(C._side_derive_plain(*p) for p in pairs))),
        "ell_llk": (lambda: M.ell_llk_rmse_sums(Theta, Beta, lay_u).sum(0),
                    lambda: torch.cat([M._bucket_llk_plain(Theta, Beta, b.rows, b.cols,
                                                           b.vals, b.col_off, False)
                                       for b in lay_u.buckets]).sum(0)),
    }
    out = {}
    for name, (kern, plain) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err_abs, err_rel = compare(name, got, ref, dtype_name)
        ms, plain_ms = cuda_ms(kern, reps), cuda_ms(plain, reps)
        out[name] = (err_abs, err_rel, ms, plain_ms)
        print(f"  {name:20s} {dtype_name}: max abs {err_abs:.3e}  max rel {err_rel:.3e}"
              f"  (rtol {TOL[dtype_name]['rtol']})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
    return out


def layouts_for(coo, dtype, device):
    from hpfrec_tpu_torch.ops.ell import build_layouts, layout_slots, to_device
    from hpfrec_tpu_torch.utils.data import process_data

    pdata = process_data(coo, "train-llk", False, dtype)
    host_u, host_i = build_layouts(pdata, dtype)
    slots = layout_slots(host_u) + layout_slots(host_i)
    return to_device(host_u, device), to_device(host_i, device), pdata, slots


def random_state(nU, nI, dtype, device, seed):
    import torch

    from hpfrec_tpu_torch.models.state import VariationalState

    rng = np.random.default_rng(seed)

    def t(*shape, lo=0.3, hi=3.0):
        return torch.from_numpy((lo + (hi - lo) * rng.random(shape)).astype(dtype)).to(device)

    return VariationalState(t(nU, K), t(nU, K, lo=20, hi=60), t(nI, K),
                            t(nI, K, lo=20, hi=60), t(nU, 1), t(nI, 1))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from hpfrec_tpu_torch import HPF, _cuda, _native
    from hpfrec_tpu_torch.ops import cavi as C
    from hpfrec_tpu_torch.ops import ell as E
    from hpfrec_tpu_torch.ops import metrics as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = {"ell_phi_sums": E.bucket_phi_sums, "segment_table_sums": E.segment_table_sums,
                "table_update": C.side_update, "table_derive": C.side_derive,
                "ell_llk": M.bucket_llk_parts}

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
    coo_small = powerlaw_coo(26_000, 9_700, 1_000_000, seed=3)
    for dtype in (np.float32, np.float64):
        lay_u, lay_i, pdata, slots = layouts_for(coo_small, dtype, dev)
        print("[2] kernel checks, %s, %d nonzeros, %d slots, k=%d (times per iteration)"
              % (np.dtype(dtype).name, pdata.y.shape[0], slots, K))
        kernel_suite(lay_u, lay_i, random_state(pdata.nusers, pdata.nitems, dtype, dev, 1),
                     np.dtype(dtype).name, reps=5)
        del lay_u, lay_i

    # -- 3. the main path at the MillionSong shape --------------------------
    t0 = time.perf_counter()
    coo = powerlaw_coo(**MILLIONSONG, seed=0)
    print("[3] data: %d x %d, %d nonzeros, generated in %.1f s"
          % (*coo.shape, coo.nnz, time.perf_counter() - t0))

    class RecordingHPF(HPF):
        def _evaluate_criterion(self, *args, **kwargs):
            out = super()._evaluate_criterion(*args, **kwargs)
            self.llk_trace.append(self._last_llk)
            return out

    model = RecordingHPF(k=K, stop_crit="train-llk", check_every=5, maxiter=10,
                         random_seed=1, device="cuda")
    model.llk_trace = []
    for w in wrappers.values():
        w.launches = 0
    model.fit(coo)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    st = model.fit_stats_
    iters = model.niter + 1
    print("[3] fit phases (s):", json.dumps({k: round(v, 3) for k, v in st.phases.items()}))
    print("[3] wall %.3f s, %d iterations, %.4f s/iteration (iterations phase), "
          "%.4g nonzero-updates/s (iterations phase), %.4g end to end"
          % (st.wall_seconds, iters, st.phases["iterations"] / iters,
             st.nnz * iters / st.phases["iterations"], st.nnz_per_second))
    print("[3] train llk at checks:", model.llk_trace)
    print("[3] launch counters:", json.dumps(launches))
    llk = np.array(model.llk_trace)
    if not (len(llk) == 2 and np.all(np.isfinite(llk)) and llk[1] > llk[0]):
        raise AssertionError(f"train llk not finite and ascending: {llk}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
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

    lay_u, lay_i, _, slots = layouts_for(coo, np.float32, dev)
    from hpfrec_tpu_torch.models.state import state_from_numpy

    fitted = state_from_numpy([model.Gamma_shp, model.Gamma_rte, model.Lambda_shp,
                               model.Lambda_rte, model.k_rte, model.t_rte], dev)
    print("[3] kernel checks at the fit's shapes (float32, fitted state, %d slots; "
          "times per iteration, both sides; ell_llk per check)" % slots)
    real = kernel_suite(lay_u, lay_i, fitted, "float32", reps=3)
    del lay_u, lay_i, fitted, model
    torch.cuda.empty_cache()

    # -- 4. agreement and determinism at a small size -----------------------
    small = counts_coo(120, 80, 2000, seed=42)
    for use_float in (True, False):
        dtype_name = "float32" if use_float else "float64"
        lim = AGREE[dtype_name]
        kw = dict(k=8, maxiter=60, check_every=10, stop_crit="train-llk", stop_thr=1e-10,
                  random_seed=123, use_float=use_float, verbose=False)
        runs = []
        for device in ("cuda", "cuda", "cpu"):
            m = RecordingHPF(device=device, **kw)
            m.llk_trace = []
            runs.append(m.fit(small))
        a, b, cpu = runs
        if not (np.array_equal(a.Theta, b.Theta) and np.array_equal(a.Beta, b.Beta)):
            raise AssertionError("two card runs differ")
        dev_llk = np.abs(np.array(a.llk_trace) / np.array(cpu.llk_trace) - 1).max()
        dev_theta = np.abs(a.Theta / cpu.Theta - 1).max()
        dev_beta = np.abs(a.Beta / cpu.Beta - 1).max()
        print("[4] %s: card runs bit-identical; card vs CPU max rel: llk trajectory %.3e "
              "(limit %g), Theta %.3e, Beta %.3e (limit %g); Theta, Beta max abs / max "
              "value %.3e, %.3e"
              % (dtype_name, dev_llk, lim["llk"], dev_theta, dev_beta, lim["factors"],
                 np.abs(a.Theta - cpu.Theta).max() / np.abs(cpu.Theta).max(),
                 np.abs(a.Beta - cpu.Beta).max() / np.abs(cpu.Beta).max()))
        if dev_llk > lim["llk"]:
            raise AssertionError("card and CPU trajectories disagree")
        if max(dev_theta, dev_beta) > lim["factors"]:
            raise AssertionError("card and CPU factors disagree")

    # -- 5. results -----------------------------------------------------------
    kernels = []
    for name, (err_abs, _, ms, plain_ms) in real.items():
        src, rep = REPLACES[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches[name], "max_abs_err": err_abs,
                        "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
