"""Batch top-n candidate generation, ``HPF.topN_batch``, from one caller in a
closed loop.

Set-up makes ``Theta`` and ``Beta`` from the seed (Gamma draws on the
device, ``hpfbench.data.gamma_factors``), saves them as a fitted model with
``reindex=False`` (ids 0..n-1) and loads it back with ``HPF.load``, the
public route by which a serving process gets its factors; then one call of
the traffic's size warms every shape.  The window sends calls of
``users_per_call`` users back to back until ``--seconds`` have passed: the
users in the order of a shuffled pass over all of them, pass after pass.

``numbers()`` holds a sample of the answered users, drawn from the seed,
against the float64 reference ranking (``hpfbench.reference.topn``): the
largest relative gap by which a served list falls short of the reference's
best n.  The ``control`` arm answers with the reference's TF32 ranking in
the program's place.
"""

from __future__ import annotations

import tempfile
import time
from typing import NamedTuple

import numpy as np

from .. import data
from . import model_seed

CALL_ANNOTATION = "hpfbench.topN_batch"


class Call(NamedTuple):
    users: int
    wall_s: float


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str = "cuda",
                 trace: bool = False, arm: str = "program"):
        if arm not in ("program", "control"):
            raise ValueError("unknown arm %r" % arm)
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device, self.trace, self.arm = device, bool(trace), arm
        self.n = int(traffic["n"])
        self.b = int(traffic["users_per_call"])
        self.calls: list = []
        self.answers: list = []  # (users, items) of each call
        self._order = np.random.default_rng([self.seed, 2])
        self._stream = np.zeros(0, dtype=np.int64)
        self._cuda = str(device).startswith("cuda")

    def _next_users(self) -> np.ndarray:
        n_users = int(self.cfg["n_users"])
        while self._stream.shape[0] < self.b:
            self._stream = np.concatenate([self._stream, self._order.permutation(n_users)])
        users, self._stream = self._stream[:self.b], self._stream[self.b:]
        return users

    def setup(self, warm: bool = True) -> None:
        from hpfrec_tpu_torch import HPF

        theta, beta = data.gamma_factors(self.cfg, self.seed, self.device)
        self.theta, self.beta = theta.cpu().numpy(), beta.cpu().numpy()
        del theta, beta
        src = HPF(k=int(self.cfg["k"]), **self.cfg["prior"], reindex=False, verbose=False,
                  keep_data=False, random_seed=model_seed(self.seed), device=self.device)
        src.Theta, src.Beta = self.theta, self.beta
        src.nusers, src.nitems = self.theta.shape[0], self.beta.shape[0]
        src.is_fitted = True
        with tempfile.TemporaryDirectory() as d:
            src.save(d)
            self.model = HPF.load(d, device=self.device)
        if self._cuda:
            import torch

            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        if self.arm == "control":
            import torch

            self._t = torch.from_numpy(self.theta).to(self.device)
            self._b = torch.from_numpy(self.beta).to(self.device)
        if warm:
            self._answer(np.arange(self.b, dtype=np.int64) % int(self.cfg["n_users"]))

    def _answer(self, users):
        if self.arm == "control":
            import torch

            from ..reference.topn import topn_tf32

            torch.backends.cuda.matmul.allow_tf32 = False
            idx = topn_tf32(self._t[torch.from_numpy(users).to(self._t.device)], self._b,
                            self.n)
            return idx.cpu().numpy()
        return self.model.topN_batch(users, n=self.n,
                                     exclude_seen=bool(self.traffic["exclude_seen"]))

    def _call(self) -> None:
        users = self._next_users()
        t0 = time.perf_counter()
        if self.trace:
            from torch.profiler import record_function

            with record_function(CALL_ANNOTATION):
                idx = self._answer(users)
        else:
            idx = self._answer(users)
        self.calls.append(Call(users.shape[0], time.perf_counter() - t0))
        self.answers.append((users, np.asarray(idx)))

    def window(self, seconds: float) -> None:
        end = time.perf_counter() + float(seconds)
        while True:
            self._call()
            if time.perf_counter() >= end:
                break

    def finish(self, tr) -> None:
        """Nothing to add: the serving metrics read the window's trace."""

    def owners(self, tr):
        return [a for a in tr.annotations if a.name == CALL_ANNOTATION]

    @property
    def attempted(self) -> int:
        return len(self.calls)

    def describe(self) -> str:
        """The calls' walls (least, median, most), for standard error."""
        w = sorted(c.wall_s for c in self.calls)
        return "calls %.4f / %.4f / %.4f s" % (w[0], w[len(w) // 2], w[-1]) if w else "no calls"

    def release(self) -> None:
        import gc

        self.model = None
        self._t = self._b = None
        gc.collect()
        if self._cuda:
            import torch

            torch.cuda.empty_cache()

    def numbers(self) -> dict:
        import torch

        from ..reference.topn import gaps

        users = np.concatenate([u for u, _ in self.answers])
        served = np.concatenate([i for _, i in self.answers]).astype(np.int64)
        m = min(int(self.traffic["check_users"]), users.shape[0])
        pick = np.sort(np.random.default_rng([self.seed, 3]).choice(users.shape[0], m,
                                                                    replace=False))
        dev = torch.device(self.device)
        theta = torch.from_numpy(self.theta).to(dev)
        beta = torch.from_numpy(self.beta).to(dev)
        g = gaps(theta, beta, torch.from_numpy(users[pick]).to(dev),
                 torch.from_numpy(served[pick]).to(dev))
        return {"topn_gap": float(g.max())}
