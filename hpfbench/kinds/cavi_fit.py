"""Whole full-batch CAVI fits, ``HPF.fit``, back to back from one caller.

Set-up makes the configuration's triplets from the seed (on the device,
``hpfbench.data``), hands them to the program as a scipy ``coo_array``
(the shape fixes the users and items; ids are already 0..n-1), and runs
one whole fit.  The window runs fits with the traffic file's ``fit``
settings back to back, each a new ``HPF`` with the same settings and seed,
on the benchmark's clock around the whole call (after a synchronize; the
call ends with the state's copy back to the host).  It starts another fit
while the time left holds one as long as the last (at least one fit).

With ``--trace`` each fit runs inside an annotation of the window's trace,
and ``finish()`` reads each fit's loop from it: from the start of its
first kernel to the end of its last (the carried tables' derivation, the
iterations and the train-llk checks; the layouts' and the state's copies
to the card come before, the state's copy back after).

``numbers()`` holds a fit of the window, drawn from the seed, against the
float64 reference (``hpfbench.reference.hpf``) run from the same triplets
and seed by the same stopping rule: the train llk, and Theta and Beta as
wholes (a worst row drifts by tenths over 140 float32 iterations, in the
program and in a plain float32 run alike; PERF.md).  The ``control`` arm
fits with the program's bfloat16 exp tables (``gather_dtype='bfloat16'``),
the precision below the configuration's float32.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np

from .. import data
from ..trace import busy, by_name, within
from . import model_seed

FIT_ANNOTATION = "hpfbench.fit"
# a train-llk check whose criterion lies within this share of stop_thr
# either way is taken as the fit decided it (float32 rounding moves the
# criterion by ~1e-7, this band by 1e-5 at stop_thr 1e-3)
STOP_BAND = 0.01


class Fit(NamedTuple):
    wall_s: float  # the benchmark's clock around the whole call
    iterations: int
    phases: dict  # fit_stats_.phases (the program's own spans)
    # read from the traced window: first kernel start to last kernel end,
    # the device's busy seconds inside that span, kernel name -> seconds
    loop_span_s: Optional[float] = None
    loop_busy_s: Optional[float] = None
    kernels: Optional[dict] = None


def _loop(dev_spans, kernels) -> tuple:
    if not kernels:
        return None, None, None
    lo, hi = kernels[0].start, max(k.end for k in kernels)
    return hi - lo, busy(dev_spans, lo, hi), by_name(within(kernels, lo, hi))


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str = "cuda",
                 trace: bool = False, arm: str = "program"):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device, self.trace, self.arm = device, bool(trace), arm
        self.nnz = int(cfg["nnz"])
        self.hpf_kwargs = dict(
            k=int(cfg["k"]), **cfg["prior"], use_float=cfg["dtype"] == "float32",
            gather_dtype=cfg["gather_dtype"], random_seed=model_seed(seed),
            verbose=False, device=device, **traffic["fit"])
        if arm == "control":
            self.hpf_kwargs["gather_dtype"] = "bfloat16"
        elif arm != "program":
            raise ValueError("unknown arm %r" % arm)
        self.fits: list = []
        self.window_s = None  # the window's seconds, its first fit's start to its last's end
        self._picked = None
        self._pick_rng = np.random.default_rng([self.seed, 1])
        self._cuda = str(device).startswith("cuda")

    # -- set-up ------------------------------------------------------------
    def setup(self, warm: bool = True) -> None:
        from scipy.sparse import coo_array

        iu, ii, y = data.host_triplets(self.cfg, self.seed, self.device)
        self.inputs = (iu, ii, y)
        self.X = coo_array((y.copy(), (iu.copy(), ii.copy())),
                           shape=(int(self.cfg["n_users"]), int(self.cfg["n_items"])))
        if self._cuda:
            import torch

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        if warm:
            self._fit(keep=False)

    # -- the window ----------------------------------------------------------
    def _fit(self, keep: bool = True) -> Fit:
        from hpfrec_tpu_torch import HPF

        model = HPF(**self.hpf_kwargs)
        if self._cuda:
            import torch

            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.trace:
            from torch.profiler import record_function

            with record_function(FIT_ANNOTATION):
                model.fit(self.X)
        else:
            model.fit(self.X)
        st = model.fit_stats_
        rec = Fit(time.perf_counter() - t0, int(st.iterations), dict(st.phases))
        if keep:
            self.fits.append(rec)
            # one fit of the window, drawn from the seed (reservoir sampling);
            # its host factors are held, not copied
            if self._pick_rng.random() * len(self.fits) < 1.0:
                self._picked = (model.Theta, model.Beta, int(st.iterations),
                                float(model.train_llk))
        return rec

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        while True:
            last = self._fit()
            now = time.perf_counter()
            if now + last.wall_s > t0 + float(seconds):
                break
        self.window_s = now - t0

    def finish(self, tr) -> None:
        """Give each fit its loop's figures from the window's trace (one
        annotation a fit, in order)."""
        annots = [a for a in tr.annotations if a.name == FIT_ANNOTATION]
        out = []
        for f, a in zip(self.fits, annots):
            kernels = within(tr.kernels, a.start, a.end)
            out.append(f._replace(**dict(zip(("loop_span_s", "loop_busy_s", "kernels"),
                                              _loop(within(tr.device, a.start, a.end),
                                                    kernels)))))
        self.fits = out

    @property
    def attempted(self) -> int:
        return len(self.fits)

    def describe(self) -> str:
        """Each fit's wall and host phases, for standard error."""
        return "; ".join("%.3f s (%s)" % (f.wall_s, ", ".join(
            "%s %.3f" % (p, f.phases.get(p, 0.0))
            for p in ("reindex", "host_pack", "transfer", "iterations", "metric_checks")))
            for f in self.fits)

    def owners(self, tr):
        return [a for a in tr.annotations if a.name == FIT_ANNOTATION]

    def release(self) -> None:
        """Drop what the program holds on the card."""
        import gc

        self.X = None
        gc.collect()
        if self._cuda:
            import torch

            torch.cuda.empty_cache()

    # -- correctness -----------------------------------------------------------
    def reference_path(self, iterations: int):
        """The float64 reference from the seed, run by the train-llk rule
        (a check within ``STOP_BAND`` of the threshold stops where the fit
        stopped); returns it and the llk of its last iteration."""
        from ..reference.hpf import CAVI, Prior, initial_state

        cfg, fit = self.cfg, self.traffic["fit"]
        prior = Prior(**cfg["prior"], k=int(cfg["k"]))
        n_users, n_items = int(cfg["n_users"]), int(cfg["n_items"])
        state = initial_state(n_users, n_items, prior, model_seed(self.seed),
                              np.float32 if cfg["dtype"] == "float32" else np.float64)
        iu, ii, y = self.inputs
        ref = CAVI(y, iu, ii, n_users, n_items, prior, state, self.device)
        every, maxiter, thr = int(fit["check_every"]), int(fit["maxiter"]), float(fit["stop_thr"])
        llks, done = [], 0
        while done < maxiter:
            n = min(every, maxiter - done)
            for _ in range(n):
                ref.step()
            done += n
            if n != every:
                continue
            llks.append(ref.train_llk())
            if len(llks) > 1:
                crit = 1.0 - llks[-1] / llks[-2]
                if crit <= thr * (1 - STOP_BAND) or (crit <= thr * (1 + STOP_BAND)
                                                      and done == iterations):
                    break
        final = llks[-1] if done % every == 0 else ref.train_llk()
        self.reference_llks = llks
        return ref, final

    def numbers(self) -> dict:
        """The fit drawn from the window against the float64 reference,
        where the reference stopped: its train llk's relative gap, and the
        relative Frobenius gaps of its Theta and Beta."""
        import torch

        theta, beta, iterations, train_llk = self._picked
        ref, final = self.reference_path(iterations)
        dev = ref.Theta.device
        got_t = torch.from_numpy(np.array(theta)).to(dev, torch.float64)
        got_b = torch.from_numpy(np.array(beta)).to(dev, torch.float64)
        return {"llk_rel": abs(train_llk - final) / abs(final),
                "theta_fro": float(torch.linalg.norm(got_t - ref.Theta)
                                   / torch.linalg.norm(ref.Theta)),
                "beta_fro": float(torch.linalg.norm(got_b - ref.Beta)
                                  / torch.linalg.norm(ref.Beta))}
