"""K6's large-n path (top-n above the fused path's cap) and K10 (the fold-in)
of hpfrec_tpu_torch on one CUDA card, for one tree or for two trees in turn.

Run from the root of a checkout:

    python3 scripts/split_k6_k10.py [--reps N]               # this tree
    python3 scripts/split_k6_k10.py --parent DIR [--reps N]  # DIR, this, this, DIR
    python3 scripts/split_k6_k10.py [--reps N] --trees DIR...  # each in turn

With ``--parent`` the script runs itself once per turn, in a process of its
own, against the ``hpfrec_tpu_torch`` and ``chip_smoke.py`` of DIR (a parent
commit unpacked, e.g. ``git archive <commit> | tar -x -C _cmp/parent``) and
of this tree, in the order DIR, this, this, DIR, and ends with a table of
every figure side by side.  Only public signatures are used (``topn_rows``,
``user_factors_loop``, ``HPF.predict_factors``, ``HPF.add_user``), so a
parent tree times the same way.

Each turn fits chip_smoke.py's full-batch model at the MillionSong
TasteProfile shape (its data and seed, k=50, float32, 10 iterations,
``reindex=False``) and prints:

1. K6 on one 1,024-user chunk (chip_smoke's first 1,024 serving users) with
   their seen items masked, n=2000: ``topn_rows`` with CUDA events, the
   same call under ``torch.profiler`` by kernel name (score, mask, select),
   a digest of its outputs' bits, and ``matmul`` + ``index_put_`` +
   ``topk`` timed the same way; then ``topn_rows`` at n=10 (the fused
   path, whose sums the score kernel shares) with CUDA events and a
   digest;
2. probe kernels built by this script (measurement only, not the port's):
   on the chunk's masked float32 scores, one histogram pass over every
   row as a select's first pass makes it: the top 8 bits of each key with
   one shared-memory ``atomicAdd`` a key (the three-kernel select's first
   radix pass before its redesign), the top 12 bits the same way, and the
   top 12 bits with one ``atomicAdd`` per distinct bin of a warp
   (``__match_any_sync``); then, per row, how many keys lie at or above
   the lower edge of the n-th largest key's bin at 12 and 24 resolved bits
   (the candidates a histogram pass of that width leaves);
3. K10 (``user_factors_loop``) on the heaviest user's history, its inputs
   as ``HPF.predict_factors`` makes them, already on the card: with the
   online path's options (10 iterations at most, stop at 1e-3; the
   iteration count read back) and for 100 iterations (stop at 0), CUDA
   events, a digest of the outputs each; the time of one iteration at P =
   1, 71 and 3,000 items (seeded synthetic histories: 400 iterations
   against 100); beside them an empty launch followed by a synchronize
   (the probe's), the latency floor of any call that reads a result back;
4. the host-clock wall of one ``HPF.predict_factors`` and one
   ``HPF.add_user`` (by fold-in, a new user each call) on that history:
   the median and the range of 50 calls after a warm-up, and a digest of
   the factors ``predict_factors`` returns.

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
N_LARGE = 2000
CHUNK = 1024

PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t float_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One block of 512 threads a row; the histogram written out so that the
// pass is not dead code.  aggregate: one atomicAdd per distinct bin of a
// warp (float4 loads); else one a key (scalar loads, as the old select).
template <int BITS, bool AGGREGATE>
__global__ void __launch_bounds__(512) probe_hist(const float* scores, uint32_t* out,
                                                  int64_t nI) {
  constexpr int kBins = 1 << BITS;
  __shared__ uint32_t hist[kBins];
  for (int i = threadIdx.x; i < kBins; i += 512) hist[i] = 0;
  __syncthreads();
  const float* row = scores + (int64_t)blockIdx.x * nI;
  if (!AGGREGATE) {
    for (int64_t e = threadIdx.x; e < nI; e += 512)
      atomicAdd(&hist[float_key(row[e]) >> (32 - BITS)], 1u);
  } else {
    const int lane = threadIdx.x & 31;
    for (int64_t c0 = 0; c0 < nI; c0 += 4 * 512) {
      const int64_t e0 = c0 + 4 * threadIdx.x;
      float v[4];
      if (e0 + 3 < nI) {
        const float4 q = *reinterpret_cast<const float4*>(row + e0);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
        for (int j = 0; j < 4; ++j) v[j] = e0 + j < nI ? row[e0 + j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = e0 + j < nI;
        const uint32_t bin = ok ? float_key(v[j]) >> (32 - BITS) : 0xffffffffu;
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (ok && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], (uint32_t)__popc(peers));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += 512) out[(int64_t)blockIdx.x * kBins + i] = hist[i];
}

__global__ void probe_empty() {}

extern "C" {
int probe_hist8(const float* s, uint32_t* out, int32_t b, int64_t nI, void* st) {
  probe_hist<8, false><<<b, 512, 0, (cudaStream_t)st>>>(s, out, nI);
  return cudaGetLastError();
}
int probe_hist12(const float* s, uint32_t* out, int32_t b, int64_t nI, void* st) {
  probe_hist<12, false><<<b, 512, 0, (cudaStream_t)st>>>(s, out, nI);
  return cudaGetLastError();
}
int probe_hist12_match(const float* s, uint32_t* out, int32_t b, int64_t nI, void* st) {
  probe_hist<12, true><<<b, 512, 0, (cudaStream_t)st>>>(s, out, nI);
  return cudaGetLastError();
}
int probe_empty_launch(void* st) {
  probe_empty<<<1, 32, 0, (cudaStream_t)st>>>();
  return cudaGetLastError();
}
}
"""


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


def probe_library():
    """The probe kernels, built with the port's nvcc flags into its build
    directory, as a ctypes library."""
    import ctypes

    from hpfrec_tpu_torch._cuda import build as cuda_build
    from hpfrec_tpu_torch._native.build import build_dir, cached_build

    src = os.path.join(build_dir(), "split_k6_k10_probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_SOURCE)
    lib = ctypes.CDLL(cached_build([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared"],
                                   [src], "split_k6_k10_probe"))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    for name in ("probe_hist8", "probe_hist12", "probe_hist12_match"):
        getattr(lib, name).argtypes = [P, P, I32, I64, P]
    lib.probe_empty_launch.argtypes = [P]
    return lib


def host_ms(fn, calls):
    """(median, min, max) host-clock ms of ``calls`` calls of ``fn`` after a
    warm-up, each ended by a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), float(min(ms)), float(max(ms))


def one(tree, reps):
    """One turn against the tree at ``tree``: prints its figures and a last
    ``RESULT <json>`` line of them."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as CS
    from hpfrec_tpu_torch import HPF, _cuda
    from hpfrec_tpu_torch.ops import svi as S
    from hpfrec_tpu_torch.ops import topk as T

    if not torch.cuda.is_available():
        print("split_k6_k10: needs a CUDA card", file=sys.stderr)
        return 1
    print("tree %s; card (nvidia-smi name, power.limit): %s" % (tree, card()))
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    t0 = time.perf_counter()
    _cuda.load()
    probe = probe_library()
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    coo = CS.powerlaw_coo(**CS.MILLIONSONG, seed=0)
    model = HPF(k=CS.K, stop_crit="train-llk", check_every=5, maxiter=10, random_seed=1,
                reindex=False, verbose=False, device="cuda").fit(coo)
    print("set-up %.1f s (build, data, a 10-iteration full-batch fit): %d users, %d items, "
          "k=%d" % (time.perf_counter() - t0, model.nusers, model.nitems, CS.K))

    # -- 1. K6 at n = 2000 on one 1,024-user chunk
    users = np.random.default_rng(11).choice(model.nusers, CS.SERVE_USERS,
                                             replace=False)[:CHUNK].astype(np.int64)
    starts, seen, counts = model._st_ix_user, model.seen, model._n_seen_by_user
    c = counts[users].astype(np.int64)
    items = np.concatenate([seen[s:s + n] for s, n in zip(starts[users], c)])
    rows = torch.from_numpy(np.repeat(np.arange(CHUNK), c).astype(np.int32)).to(dev)
    items = torch.from_numpy(items.astype(np.int32)).to(dev)
    Beta = torch.from_numpy(np.ascontiguousarray(model.Beta)).to(dev)
    th = torch.from_numpy(np.ascontiguousarray(model.Theta[users])).to(dev)
    nI = Beta.shape[0]
    fn = lambda: T.topn_rows(th, Beta, rows, items, N_LARGE)  # noqa: E731

    def library():
        sc = torch.matmul(th, Beta.T)
        sc.index_put_((rows.long(), items.long()), torch.tensor(-torch.inf, device=dev))
        return torch.topk(sc, N_LARGE)

    res["K6 n=2000 ms"] = CS.cuda_ms(fn, reps)
    res["K6 n=2000 digest"] = digest(*fn())
    res["K6 library ms"] = CS.cuda_ms(library, reps)
    print("K6 topn_rows, %d users, %d items, n=%d, %d seen pairs: %.4f ms (CUDA events, %d "
          "calls), digest %s; matmul + index_put_ + topk %.4f ms"
          % (CHUNK, nI, N_LARGE, rows.numel(), res["K6 n=2000 ms"], reps,
             res["K6 n=2000 digest"], res["K6 library ms"]))
    fused = lambda: T.topn_rows(th, Beta, rows, items, 10)  # noqa: E731
    res["K6 n=10 ms"] = CS.cuda_ms(fused, reps)
    res["K6 n=10 digest"] = digest(*fused())
    print("K6 topn_rows, the same chunk at n=10 (the fused path): %.4f ms (CUDA events, %d "
          "calls), digest %s" % (res["K6 n=10 ms"], reps, res["K6 n=10 digest"]))
    print("K6 by launch (torch.profiler, ms a call):")
    for kms, key in CS.kernel_split(fn, reps):
        name = key.split("(")[0].split("<")[0].split("::")[-1].split()[-1]
        res["K6 %s ms" % name] = res.get("K6 %s ms" % name, 0.0) + kms
        print("  %9.4f  %s" % (kms, key[:100]))

    # -- 2. first-pass probes and the candidates a histogram pass leaves
    scores = (th @ Beta.T).float()
    scores[rows.long(), items.long()] = -torch.inf
    hist = torch.empty((CHUNK, 4096), dtype=torch.int32, device=dev)
    for name in ("probe_hist8", "probe_hist12", "probe_hist12_match"):
        call = getattr(probe, name)
        res["%s ms" % name] = CS.cuda_ms(
            lambda call=call: call(scores.data_ptr(), hist.data_ptr(), CHUNK, nI, stream()), reps)
        print("%s: %.4f ms (CUDA events, %d calls; %.3e B read)"
              % (name, res["%s ms" % name], reps, scores.numel() * 4.0))
    u = scores.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    del scores, hist
    keys = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u + 0x80000000)
    del u
    t = torch.topk(keys, N_LARGE, dim=1).values[:, -1:]
    for bits in (12, 24):
        edge = t & ~((1 << (32 - bits)) - 1)
        m = (keys >= edge).sum(dim=1).double()
        q = torch.quantile(m, torch.tensor([0.0, 0.5, 0.9, 0.99, 1.0], dtype=torch.float64,
                                           device=dev)).tolist()
        res["K6 candidates at %d bits, median" % bits] = q[1]
        res["K6 candidates at %d bits, max" % bits] = q[4]
        print("keys at or above the n-th key's %d-bit bin, over the rows: min %d, median %d, "
              "p90 %d, p99 %d, max %d" % (bits, *q))
    del keys, t
    torch.cuda.empty_cache()

    # -- 3. K10 on the heaviest history, as HPF.predict_factors makes it
    deg = model._n_seen_by_user
    heavy = int(np.argmax(deg))
    h_items, h_counts = CS.user_histories(coo, [heavy])[0]
    arrays, k_rte0 = model._fold_in_start(h_items, h_counts, 1)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    hp = model._hp()
    for name, maxiter, thr in (("online (10 iterations at most)", 10, 1e-3),
                               ("100 iterations", 100, 0.0)):
        f = lambda: S.user_factors_loop(*args, k_rte0, hp, maxiter, thr)  # noqa: E731
        ms = CS.cuda_ms(f, 10 * reps)
        out = f()
        key = "K10 %s" % name
        res[key + " ms"] = ms
        res[key + " iterations"] = int(out[4])
        res[key + " digest"] = digest(*out[:4])
        print("%s: user %d, %d items, %d iterations: %.4f ms (CUDA events, %d calls); digest %s"
              % (key, heavy, len(h_items), out[4], ms, 10 * reps, res[key + " digest"]))
    # the iteration alone: synthetic histories of P items (seeded), 400
    # iterations against 100 (stop at 0), the difference over 300
    rng = np.random.default_rng(5)
    for P in (1, 71, 3000):
        rows = rng.choice(model.nitems, P, replace=False)
        arrays, k0 = model._fold_in_start(rows, rng.poisson(2, P) + 1.0, 1)
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrays]
        ms = [CS.cuda_ms(lambda m=m: S.user_factors_loop(*a, k0, hp, m, 0.0), 2 * reps)
              for m in (100, 400)]
        res["K10 us an iteration, P=%d" % P] = (ms[1] - ms[0]) / 300 * 1e3
        print("K10 at P=%d: 100 iterations %.4f ms, 400 %.4f ms: %.3f us an iteration"
              % (P, ms[0], ms[1], res["K10 us an iteration, P=%d" % P]))
    floor = lambda: probe.probe_empty_launch(stream())  # noqa: E731
    res["empty launch + sync ms"] = host_ms(floor, 10 * reps)[0]
    print("an empty launch + synchronize: %.4f ms (host clock, median of %d)"
          % (res["empty launch + sync ms"], 10 * reps))

    # -- 4. predict_factors and add_user on that history
    hist_arr = np.column_stack([h_items, h_counts])
    res["predict_factors digest"] = digest(model.predict_factors(hist_arr))
    for name, f in (("predict_factors", lambda: model.predict_factors(hist_arr)),
                    ("add_user", lambda: model.add_user(model.nusers, hist_arr))):
        med, lo, hi = host_ms(f, 50)
        res["%s wall ms" % name] = med
        print("%s, %d items: wall %.4f ms a call (host clock, median of 50; %.4f-%.4f)"
              % (name, len(h_items), med, lo, hi))
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
            raise SystemExit("split_k6_k10: the %s turn failed (exit %d)"
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
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 10
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
