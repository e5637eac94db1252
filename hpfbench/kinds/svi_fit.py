"""Whole mini-batch SVI fits with a validation set, ``HPF.fit(train,
val_set=val)``, back to back from one caller.

Set-up makes the configuration's triplets from the seed (on the device,
``hpfbench.data``), holds out the traffic's ``val_share`` of the pairs,
drawn uniformly by ``np.random.default_rng([seed, 2])``, and hands both
parts to the program as scipy ``coo_array``s of the whole shape (ids are
already 0..n-1); then it runs one whole fit.  The window is
``cavi_fit``'s: fits with the traffic file's ``fit`` settings back to back,
each a new ``HPF`` with the same settings and seed, on the benchmark's
clock around the whole call.  A fit's ``iterations`` are its epochs, each
of which passes every training nonzero once, as a CAVI iteration does, so
``cavi_nnz_per_s`` reads this cell unchanged (``Cell.nnz`` is the training
count).

With ``--trace`` each fit runs inside an annotation of the window's trace,
and ``finish()`` reads each fit's epochs from it: the program's own
``hpf.fit.user_epochs`` / ``hpf.fit.item_epochs`` annotations (an epoch's
host part, K9 and its batches), their seconds, the card's busy seconds
inside them and their kernels by name; and the shapes of the fits' batches
(the rows, nonzeros and other-side rows of each), for the work counts of
``hpfbench.work.svi``.

``numbers()`` holds a fit of the window, drawn from the seed, against the
float64 reference (``hpfbench.reference.svi``) run from the same triplets,
seed and schedule by the same val-llk rule: the validation llk of the last
check, and Theta and Beta as wholes.  The ``control`` arm is the precision
below the configuration's float32: SVI ignores ``gather_dtype``, so the
arm rounds the exp tables that the epochs' K3 derive hands to K7 to
bfloat16 (and back), for the length of each fit.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import NamedTuple

import numpy as np

from .. import data
from ..trace import busy, by_name, within
from . import cavi_fit, model_seed
from .cavi_fit import FIT_ANNOTATION, STOP_BAND, Fit

EPOCHS = ("hpf.fit.user_epochs", "hpf.fit.item_epochs")


class BatchShape(NamedTuple):
    user_side: bool
    rows: int  # the batch's rows of its own side
    slots: int  # their training nonzeros
    other_rows: int  # the other side's rows they touch


def holdout(n: int, share: float, seed: int) -> np.ndarray:
    """A boolean mask of the ``round(share * n)`` pairs held out, drawn
    uniformly by ``np.random.default_rng([seed, 2])``."""
    held = np.zeros(n, dtype=bool)
    held[np.random.default_rng([int(seed), 2]).choice(n, int(round(share * n)),
                                                      replace=False)] = True
    return held


def batch_shapes(iu, ii, n_users: int, n_items: int, fit: dict, seed: int, epochs: int,
                 device) -> list:
    """The ``BatchShape`` of each batch of the first ``epochs`` epochs of a
    fit's schedule (``reference.svi.schedule``), a list an epoch."""
    import torch

    from ..reference.svi import batches, schedule

    iu = torch.as_tensor(iu, device=device).long()
    ii = torch.as_tensor(ii, device=device).long()
    deg = {True: torch.bincount(iu, minlength=n_users),
           False: torch.bincount(ii, minlength=n_items)}
    out = []
    for user_side, perm in itertools.islice(schedule(n_users, n_items, seed), epochs):
        loc, oth, n_oth = (iu, ii, n_items) if user_side else (ii, iu, n_users)
        size = fit["users_per_batch"] if user_side else fit["items_per_batch"]
        shapes = []
        for rows in batches(perm, int(size)):
            rows = torch.as_tensor(rows, device=device)
            in_batch = torch.zeros(deg[user_side].shape[0], dtype=torch.bool, device=device)
            in_batch[rows] = True
            touched = torch.zeros(n_oth, dtype=torch.bool, device=device)
            touched[oth[in_batch[loc]]] = True
            shapes.append(BatchShape(user_side, int(rows.shape[0]),
                                     int(deg[user_side][rows].sum()), int(touched.sum())))
        out.append(shapes)
    return out


@contextlib.contextmanager
def bfloat16_tables():
    """The epochs' exp tables rounded to bfloat16 where K3's derive makes
    them, the colsums left as they are."""
    import torch

    import hpfrec_tpu_torch.ops.svi as S

    orig = S.side_derive

    def rounded(*a, **k):
        tab, colsum = orig(*a, **k)
        return tab.to(torch.bfloat16).to(tab.dtype), colsum

    S.side_derive = rounded
    try:
        yield
    finally:
        S.side_derive = orig


class Cell(cavi_fit.Cell):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str = "cuda",
                 trace: bool = False, arm: str = "program"):
        if arm not in ("program", "control"):
            raise ValueError("unknown arm %r" % arm)
        super().__init__(cfg, traffic, seed, device=device, trace=trace)
        self.arm = arm
        self.batches: list = []  # fit_stats_.batches of each kept fit (None: no such counter)
        self.shapes = None  # BatchShape lists an epoch, read in a traced run

    # -- set-up ------------------------------------------------------------
    def setup(self, warm: bool = True) -> None:
        from scipy.sparse import coo_array

        iu, ii, y = data.host_triplets(self.cfg, self.seed, self.device)
        held = holdout(y.shape[0], float(self.traffic["val_share"]), self.seed)
        keep = ~held
        self.inputs = (iu[keep], ii[keep], y[keep])
        self.val = (iu[held], ii[held], y[held])
        self.nnz = int(keep.sum())
        shape = (int(self.cfg["n_users"]), int(self.cfg["n_items"]))
        self.X = coo_array((self.inputs[2].copy(), (self.inputs[0].copy(),
                                                    self.inputs[1].copy())), shape=shape)
        self.V = coo_array((self.val[2].copy(), (self.val[0].copy(), self.val[1].copy())),
                           shape=shape)
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
        with contextlib.ExitStack() as stack:
            if self.arm == "control":
                stack.enter_context(bfloat16_tables())
            if self.trace:
                from torch.profiler import record_function

                stack.enter_context(record_function(FIT_ANNOTATION))
            model.fit(self.X, val_set=self.V)
        st = model.fit_stats_
        rec = Fit(time.perf_counter() - t0, int(st.iterations), dict(st.phases))
        if keep:
            self.fits.append(rec)
            self.batches.append(getattr(st, "batches", None))
            # one fit of the window, drawn from the seed (reservoir sampling)
            if self._pick_rng.random() * len(self.fits) < 1.0:
                self._picked = (model.Theta, model.Beta, int(st.iterations),
                                float(model.train_llk))
        return rec

    def finish(self, tr) -> None:
        """Give each fit its epochs' figures from the window's trace (one
        ``hpfbench.fit`` annotation a fit, in order): the seconds of its
        epoch annotations, the card's busy seconds inside them and their
        kernels' seconds by name; then the batches' shapes."""
        fits = [a for a in tr.annotations if a.name == FIT_ANNOTATION]
        out = []
        for f, a in zip(self.fits, fits):
            epochs = [e for e in within(tr.annotations, a.start, a.end) if e.name in EPOCHS]
            if not epochs:
                out.append(f)
                continue
            kernels = [k for e in epochs for k in within(tr.kernels, e.start, e.end)]
            out.append(f._replace(loop_span_s=sum(e.end - e.start for e in epochs),
                                  loop_busy_s=sum(busy(within(tr.device, e.start, e.end),
                                                       e.start, e.end) for e in epochs),
                                  kernels=by_name(kernels)))
        self.fits = out
        if self.fits:
            cfg = self.cfg
            self.shapes = batch_shapes(self.inputs[0], self.inputs[1], int(cfg["n_users"]),
                                       int(cfg["n_items"]), self.traffic["fit"],
                                       model_seed(self.seed),
                                       max(f.iterations for f in self.fits), self.device)

    def describe(self) -> str:
        """Each fit's wall, epochs and phases, for standard error."""
        return "; ".join("%.3f s, %d epochs (%s)" % (f.wall_s, f.iterations, ", ".join(
            "%s %.3f" % (p, f.phases.get(p, 0.0))
            for p in ("reindex", "host_pack", "transfer", "user_epochs", "item_epochs",
                      "epoch_offsets", "metric_checks", "copy_back")))
            for f in self.fits)

    def release(self) -> None:
        self.V = None
        super().release()

    # -- correctness -----------------------------------------------------------
    def reference_path(self, epochs: int):
        """The float64 reference from the seed, run by the val-llk rule (a
        check within ``STOP_BAND`` of the threshold stops where the fit
        stopped); returns it and the validation llk of its last check."""
        from ..reference.hpf import Prior, initial_state
        from ..reference.svi import SVI, no_tf32, schedule

        cfg, fit = self.cfg, self.traffic["fit"]
        prior = Prior(**cfg["prior"], k=int(cfg["k"]))
        n_users, n_items = int(cfg["n_users"]), int(cfg["n_items"])
        seed = model_seed(self.seed)
        state = initial_state(n_users, n_items, prior, seed,
                              np.float32 if cfg["dtype"] == "float32" else np.float64)
        every, maxiter, thr = int(fit["check_every"]), int(fit["maxiter"]), float(fit["stop_thr"])
        (iu, ii, y), (v_iu, v_ii, v_y) = self.inputs, self.val
        llks = []
        with no_tf32():
            ref = SVI(y, iu, ii, n_users, n_items, prior, state, self.device)
            for i, (user_side, perm) in enumerate(itertools.islice(schedule(n_users, n_items,
                                                                            seed), maxiter)):
                size = fit["users_per_batch"] if user_side else fit["items_per_batch"]
                ref.epoch(user_side, perm, int(size), 1.0 / np.sqrt(i + 2))
                if (i + 1) % every:
                    continue
                llks.append(ref.val_llk(v_y, v_iu, v_ii))
                if len(llks) > 1:
                    crit = 1.0 - llks[-1] / llks[-2]
                    if crit <= thr * (1 - STOP_BAND) or (crit <= thr * (1 + STOP_BAND)
                                                          and i + 1 == epochs):
                        break
            final = llks[-1] if (i + 1) % every == 0 else ref.val_llk(v_y, v_iu, v_ii)
        self.reference_llks = llks
        return ref, final
