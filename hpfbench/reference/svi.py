"""Mini-batch SVI for Hierarchical Poisson Factorization in plain PyTorch,
float64, from the triplets and the seed.

Written from hpfrec's SVI epochs (``cython_loops.pxi:261-377``; SURVEY.md
section 3.2).  A user epoch runs its shuffled users in batches; for each
batch, with the stabilized exp tables of the state before the batch (as
``hpf.py``'s CAVI makes them), each of the batch's nonzeros has phi ``y *
t_u * b_i / <t_u, b_i>``, summed over its user (``su``) and over its item
(``si``).  Then:

- every user's rate ``k_shp / k_rte + colsum(Beta)``, with Beta before the
  batch, and the batch users' shapes ``a + su``, overwritten;
- the touched items (those of the batch's nonzeros) blended by ``step``:
  shape ``step * mult * (c + si) + (1 - step) * shape``, with ``mult`` the
  users over the batch's users, and rate ``step * (t_shp / t_rte +
  colsum(Theta)) + (1 - step) * rate``, with the new Theta;
- the batch users' ``k_rte`` and the touched items' ``t_rte`` blended by
  ``step`` towards ``a' / b' + rowsum(Theta)`` and ``c' / d' +
  rowsum(Beta)``.

An item epoch is the mirror, items in the users' place.  The step of epoch
``i`` (from 0) is ``1 / sqrt(i + 2)``; both sides' epochs alternate, the
item epoch first.  The starting state is ``hpf.initial_state``'s.

Where this departs from hpfrec, it follows the program it checks:

- the schedule: the numeration arrays ``arange(n)`` are shuffled in place,
  an epoch at a time, by ``np.random.default_rng(seed)`` (hpfrec shuffles
  with numpy's global generator), and a batch is a run of consecutive
  shuffled rows;
- phi is never held whole: the batch's nonzeros run in blocks, so that the
  reference fits beside the inputs on the card;
- the validation llk is ``sum(y log(<Theta_u, Beta_i>)) - sum(<Theta_u,
  Beta_i>)`` over the held-out pairs (hpfrec's, without ``log(y!)``).
"""

from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch

from .hpf import Prior, _exp_tables


def schedule(n_users: int, n_items: int, seed: int):
    """The epochs of a fit with both batch sizes set, endlessly: ``(user_side,
    perm)`` an epoch, the item epoch first, each ``perm`` a copy of its
    side's numeration array after that epoch's shuffle."""
    rng = np.random.default_rng(seed=seed if seed > 0 else None)
    users = np.arange(n_users, dtype=np.int64)
    items = np.arange(n_items, dtype=np.int64)
    for i in itertools.count():
        user_side = (i + 1) % 2 == 0
        perm = users if user_side else items
        rng.shuffle(perm)
        yield user_side, perm.copy()


def batches(perm: np.ndarray, batch_rows: int):
    """The rows of each batch of an epoch in the order ``perm``."""
    return [perm[r:r + batch_rows] for r in range(0, len(perm), batch_rows)]


@contextlib.contextmanager
def no_tf32():
    """Float32 products in full precision while the reference runs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class SVI:
    """The float64 state on ``device`` and the training triplets it is fit
    to."""

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

    def _batch_sums(self, user_side: bool, rows: torch.Tensor):
        """Both sides' phi sums over the nonzeros of the batch ``rows`` (of
        the local side), and the other side's touched rows as a mask."""
        t_tab = _exp_tables(self.G_shp, self.G_rte)
        b_tab = _exp_tables(self.L_shp, self.L_rte)
        loc, oth = (self.iu, self.ii) if user_side else (self.ii, self.iu)
        n_loc, n_oth = (self.n_users, self.n_items) if user_side else (self.n_items,
                                                                       self.n_users)
        in_batch = torch.zeros(n_loc, dtype=torch.bool, device=loc.device)
        in_batch[rows] = True
        sel = torch.nonzero(in_batch[loc]).squeeze(1)
        su, si = torch.zeros_like(t_tab), torch.zeros_like(b_tab)
        for s in range(0, sel.shape[0], self.block):
            idx = sel[s:s + self.block]
            iu, ii = self.iu[idx], self.ii[idx]
            p = t_tab[iu] * b_tab[ii]
            p *= (self.y[idx] / p.sum(dim=1))[:, None]
            su.index_add_(0, iu, p)
            si.index_add_(0, ii, p)
        touched = torch.zeros((n_oth, 1), dtype=torch.bool, device=loc.device)
        touched[oth[sel]] = True
        return su, si, touched

    def batch(self, user_side: bool, rows, step: float, mult: float):
        """One batch's update (the local side's shapes and every local rate
        overwritten, the touched rows of the other side blended)."""
        pr = self.prior
        k_shp = pr.a_prime + pr.k * pr.a
        t_shp = pr.c_prime + pr.k * pr.c
        rows = torch.as_tensor(np.asarray(rows), device=self.y.device).to(torch.int64)
        su, si, touched = self._batch_sums(user_side, rows)
        if user_side:
            self.G_rte = k_shp / self.k_rte + self.Beta.sum(dim=0, keepdim=True)
            self.G_shp = self.G_shp.index_put((rows,), pr.a + su[rows])
            theta = self.Theta
            self.L_shp = torch.where(touched, step * mult * (pr.c + si)
                                     + (1 - step) * self.L_shp, self.L_shp)
            self.L_rte = torch.where(touched, step * (t_shp / self.t_rte
                                                      + theta.sum(dim=0, keepdim=True))
                                     + (1 - step) * self.L_rte, self.L_rte)
            beta = self.Beta
            u_mask = torch.zeros((self.n_users, 1), dtype=torch.bool, device=rows.device)
            u_mask[rows] = True
            i_mask = touched
        else:
            self.L_rte = t_shp / self.t_rte + self.Theta.sum(dim=0, keepdim=True)
            self.L_shp = self.L_shp.index_put((rows,), pr.c + si[rows])
            beta = self.Beta
            self.G_shp = torch.where(touched, step * mult * (pr.a + su)
                                     + (1 - step) * self.G_shp, self.G_shp)
            self.G_rte = torch.where(touched, step * (k_shp / self.k_rte
                                                      + beta.sum(dim=0, keepdim=True))
                                     + (1 - step) * self.G_rte, self.G_rte)
            theta = self.Theta
            i_mask = torch.zeros((self.n_items, 1), dtype=torch.bool, device=rows.device)
            i_mask[rows] = True
            u_mask = touched
        self.k_rte = torch.where(u_mask, step * (pr.a_prime / pr.b_prime
                                                 + theta.sum(dim=1, keepdim=True))
                                 + (1 - step) * self.k_rte, self.k_rte)
        self.t_rte = torch.where(i_mask, step * (pr.c_prime / pr.d_prime
                                                 + beta.sum(dim=1, keepdim=True))
                                 + (1 - step) * self.t_rte, self.t_rte)

    def epoch(self, user_side: bool, perm, batch_rows: int, step: float):
        """One epoch over the local side's rows in the order ``perm``."""
        n = len(perm)
        for rows in batches(perm, batch_rows):
            self.batch(user_side, rows, step, n / len(rows))

    def val_llk(self, y, iu, ii) -> float:
        """The validation llk of held-out triplets (host arrays)."""
        dev = self.y.device
        y = torch.as_tensor(np.asarray(y), device=dev).to(torch.float64)
        iu = torch.as_tensor(np.asarray(iu), device=dev).to(torch.int64)
        ii = torch.as_tensor(np.asarray(ii), device=dev).to(torch.int64)
        theta, beta = self.Theta, self.Beta
        ll = torch.zeros((), dtype=torch.float64, device=dev)
        for s in range(0, y.shape[0], self.block):
            yhat = (theta[iu[s:s + self.block]] * beta[ii[s:s + self.block]]).sum(1)
            ll += (y[s:s + self.block] * torch.log(yhat) - yhat).sum()
        return float(ll)
