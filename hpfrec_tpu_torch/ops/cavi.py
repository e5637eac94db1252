"""Per-side table math of the CAVI update (K3).

Port of ``hpfrec_tpu/ops/cavi.py:elog_tables``/``exp_elog_tables`` and of
the table math of ``hpfrec_tpu/ops/ell.py:cavi_step_ell_carried`` /
``_carry_init``.  For one side (users: prior ``a``, scaler ``k_rte``;
items: prior ``c``, scaler ``t_rte``)::

    shp    = prior + sums
    rte    = scaler_shape / scaler_old + colsum_other
    mean   = shp / rte                      (Theta or Beta)
    tab    = exp(digamma(shp) - log(rte) - rowmax)   (non-finite rowmax -> 0)
    scaler = add_scaler + rowsum(mean)
    colsum = colsum(mean)

``side_update`` runs all of it; ``side_derive`` only derives ``tab`` and
``colsum`` from a given (shp, rte).  Both launch the hand-written kernel of
``csrc/table_update.cu`` for CUDA tensors and run the plain PyTorch
version below for CPU tensors.  The SVI batches (``ops/svi.py``) derive
both sides' tables with ``side_derive`` before every batch.

``BlockedCOO`` (the validation set's layout) and ``_phi_block`` (the COO
phi, the plain form of the SVI batch phi sums) are ported; the blocked-COO
engine itself (``phi_segment_sums``, ``cavi_step``, ``run_cavi_block``) is
not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BlockedCOO(NamedTuple):
    """Padded, blocked COO stream.  All (nblocks, B); padding has y == 0."""

    y: torch.Tensor
    ix_u: torch.Tensor  # int32
    ix_i: torch.Tensor  # int32


def device_blocked_coo(y, ix_u, ix_i, device, block_size=None):
    """Host triplets as a ``BlockedCOO`` on ``device`` (``block_coo``'s
    padding), and the number of real triplets."""
    from ..utils.data import block_coo

    blk = block_coo(y, ix_u, ix_i, block_size=block_size)
    return BlockedCOO(*(torch.from_numpy(a).to(device)
                        for a in (blk.y, blk.ix_u, blk.ix_i))), blk.nnz


def _phi_block(t_tab, b_tab, y, iu, ii):
    """phi for a run of nonzeros: ``y * (t[u] * b[i]) / <t[u], b[i]>``, rows
    (n, k); ``t_tab``/``b_tab`` are the stabilized exp tables."""
    p = t_tab[iu.long()] * b_tab[ii.long()]
    denom = p.sum(-1)
    return (y / denom)[:, None] * p

# Rows per block of the colsum partials: the kernel runs a fixed grid of at
# most this many blocks (one warp per row, grid-stride), each writing one
# (k,) partial that a second pass adds in block order, so colsums are
# deterministic.
_MAX_COLSUM_BLOCKS = 1024
_WARPS_PER_BLOCK = 8


def elog_tables(shp, rte):
    """E_q[log x] for a Gamma(shp, rte) posterior: digamma(shp) - log(rte)."""
    return torch.special.digamma(shp) - torch.log(rte)


def exp_elog_tables(shp, rte):
    """Row-stabilized exp of E[log x]: ``exp(elog - rowmax(elog))``, with a
    non-finite rowmax (an all -inf row, e.g. ``rte = +inf``) set to 0 so
    that the row is exactly +0.0."""
    elog = elog_tables(shp, rte)
    m = elog.max(dim=1, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.exp(elog - m)


def _side_update_plain(sums, scaler_old, colsum_other, prior, scaler_shape,
                       add_scaler):
    shp = prior + sums
    rte = scaler_shape / scaler_old + colsum_other
    mean = shp / rte
    tab = exp_elog_tables(shp, rte)
    scaler = add_scaler + mean.sum(dim=1, keepdim=True)
    return shp, rte, tab, scaler, mean.sum(dim=0, keepdim=True)


def _side_derive_plain(shp, rte):
    return exp_elog_tables(shp, rte), (shp / rte).sum(dim=0, keepdim=True)


def _colsum_blocks(n: int) -> int:
    return max(1, min(_MAX_COLSUM_BLOCKS, -(-n // _WARPS_PER_BLOCK)))


def _finish_colsum(partials, nblocks, k):
    from .. import _cuda

    colsum = torch.empty((1, k), dtype=partials.dtype, device=partials.device)
    _cuda.launch("colsum_finish", partials.dtype, k, partials, colsum,
                 nblocks, k)
    return colsum


def side_update(sums, scaler_old, colsum_other, prior: float,
                scaler_shape: float, add_scaler: float):
    """K3 update form.  Returns ``(shp, rte, tab, scaler, colsum)`` with
    shapes (n, k) x 3, (n, 1), (1, k)."""
    if not sums.is_cuda:
        return _side_update_plain(sums, scaler_old, colsum_other, prior,
                                  scaler_shape, add_scaler)
    from .. import _cuda

    n, k = sums.shape
    _cuda.check(sums, scaler_old, colsum_other, dtype=sums.dtype)
    if scaler_old.shape != (n, 1) or colsum_other.shape != (1, k):
        raise ValueError("side_update: shape mismatch")
    shp, rte, tab = (torch.empty_like(sums) for _ in range(3))
    scaler = torch.empty_like(scaler_old)
    nblocks = _colsum_blocks(n)
    partials = torch.empty((nblocks, k), dtype=sums.dtype, device=sums.device)
    _cuda.launch("table_update", sums.dtype, k, sums, scaler_old, colsum_other,
                 float(prior), float(scaler_shape), float(add_scaler),
                 shp, rte, tab, scaler, partials, n, k, nblocks)
    side_update.launches += 1
    return shp, rte, tab, scaler, _finish_colsum(partials, nblocks, k)


side_update.launches = 0


def side_derive(shp, rte):
    """K3 derive-only form: ``(tab, colsum(shp / rte))``."""
    if not shp.is_cuda:
        return _side_derive_plain(shp, rte)
    from .. import _cuda

    n, k = shp.shape
    _cuda.check(shp, rte, dtype=shp.dtype)
    if rte.shape != (n, k):
        raise ValueError("side_derive: shape mismatch")
    tab = torch.empty_like(shp)
    nblocks = _colsum_blocks(n)
    partials = torch.empty((nblocks, k), dtype=shp.dtype, device=shp.device)
    _cuda.launch("table_derive", shp.dtype, k, shp, rte, tab, partials, n, k,
                 nblocks)
    side_derive.launches += 1
    return tab, _finish_colsum(partials, nblocks, k)


side_derive.launches = 0
