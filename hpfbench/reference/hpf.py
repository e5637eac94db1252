"""Full-batch CAVI for Hierarchical Poisson Factorization in plain PyTorch,
float64, from the triplets and the seed.

Written from the model's mean-field updates in the reference package's
order (hpfrec ``cython_loops.pxi:227-259``; the same math as
``tests/oracle.py``): with the stabilized exp tables of E[log Theta] and
E[log Beta] of the current state, each nonzero's phi is ``y * t_u * b_i /
<t_u, b_i>``; the user side's shape is ``a + sum of phi over the user's
items`` and its rate ``k_shp / k_rte + colsum(Beta)``; then the item side
with ``colsum`` of the new Theta; then both row scalers.  The starting
state is drawn as the reference package draws it: MT19937 from the seed,
``G_rte, L_rte, G_shp, L_shp = prior + 0.01 * U(0, 1)`` in the state's
dtype, in that order.  The phi sums run in blocks of nonzeros so that the
reference fits beside the inputs on one card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Prior(NamedTuple):
    a: float
    a_prime: float
    b_prime: float
    c: float
    c_prime: float
    d_prime: float
    k: int


def initial_state(n_users: int, n_items: int, prior: Prior, seed: int, dtype=np.float32):
    """The six starting arrays (G_shp, G_rte, L_shp, L_rte, k_rte, t_rte)
    as host arrays of ``dtype``."""
    rng = np.random.Generator(np.random.MT19937(seed=seed if seed > 0 else None))
    k = prior.k
    G_rte = prior.a_prime + 0.01 * rng.random(size=(n_users, k), dtype=dtype)
    L_rte = prior.c_prime + 0.01 * rng.random(size=(n_items, k), dtype=dtype)
    G_shp = prior.a_prime + 0.01 * rng.random(size=(n_users, k), dtype=dtype)
    L_shp = prior.c_prime + 0.01 * rng.random(size=(n_items, k), dtype=dtype)
    k_rte = np.full((n_users, 1), prior.b_prime, dtype=dtype)
    t_rte = np.full((n_items, 1), prior.d_prime, dtype=dtype)
    return G_shp, G_rte, L_shp, L_rte, k_rte, t_rte


def _exp_tables(shp, rte):
    elog = torch.special.digamma(shp) - torch.log(rte)
    return torch.exp(elog - elog.max(dim=1, keepdim=True).values)


class CAVI:
    """The float64 state on ``device`` and the triplets it is fit to."""

    def __init__(self, y, iu, ii, n_users, n_items, prior: Prior, state, device,
                 block: int = 1 << 22):
        dev = torch.device(device)
        self.prior = prior
        self.y = torch.as_tensor(np.asarray(y), device=dev).to(torch.float64)
        self.iu = torch.as_tensor(np.asarray(iu), device=dev).to(torch.int64)
        self.ii = torch.as_tensor(np.asarray(ii), device=dev).to(torch.int64)
        self.n_users, self.n_items = int(n_users), int(n_items)
        (self.G_shp, self.G_rte, self.L_shp, self.L_rte, self.k_rte,
         self.t_rte) = (torch.as_tensor(np.asarray(a), device=dev).to(torch.float64)
                        for a in state)
        self.block = int(block)

    @property
    def Theta(self):
        return self.G_shp / self.G_rte

    @property
    def Beta(self):
        return self.L_shp / self.L_rte

    def phi_sums(self):
        t_tab = _exp_tables(self.G_shp, self.G_rte)
        b_tab = _exp_tables(self.L_shp, self.L_rte)
        su = torch.zeros_like(t_tab)
        si = torch.zeros_like(b_tab)
        for s in range(0, self.y.shape[0], self.block):
            iu, ii = self.iu[s:s + self.block], self.ii[s:s + self.block]
            p = t_tab[iu] * b_tab[ii]
            p *= (self.y[s:s + self.block] / p.sum(dim=1))[:, None]
            su.index_add_(0, iu, p)
            si.index_add_(0, ii, p)
        return su, si

    def step(self):
        """One CAVI iteration."""
        pr = self.prior
        k_shp = pr.a_prime + pr.k * pr.a
        t_shp = pr.c_prime + pr.k * pr.c
        su, si = self.phi_sums()
        self.G_rte = k_shp / self.k_rte + self.Beta.sum(dim=0, keepdim=True)
        self.G_shp = pr.a + su
        theta = self.Theta
        self.L_rte = t_shp / self.t_rte + theta.sum(dim=0, keepdim=True)
        self.L_shp = pr.c + si
        beta = self.Beta
        self.k_rte = pr.a_prime / pr.b_prime + theta.sum(dim=1, keepdim=True)
        self.t_rte = pr.c_prime / pr.d_prime + beta.sum(dim=1, keepdim=True)

    def train_llk(self) -> float:
        """``sum(y log(<Theta_u, Beta_i>)) - colsum(Theta) . colsum(Beta)``
        over the training triplets (the constant ``log(y!)`` left out, as
        hpfrec's train-llk criterion does)."""
        theta, beta = self.Theta, self.Beta
        ll = torch.zeros((), dtype=torch.float64, device=theta.device)
        for s in range(0, self.y.shape[0], self.block):
            yhat = (theta[self.iu[s:s + self.block]] * beta[self.ii[s:s + self.block]]).sum(1)
            ll += (self.y[s:s + self.block] * torch.log(yhat)).sum()
        return float(ll - theta.sum(0) @ beta.sum(0))

