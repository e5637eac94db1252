"""Train log-likelihood / RMSE over the user-side ELL layout (K4).

Port of ``hpfrec_tpu/ops/metrics.py:ell_llk_parts`` /
``ell_llk_rmse_sums`` / ``ell_train_llk_rmse`` and ``theta_diff_norm``.
Over the slots with ``y > 0``: ``yhat = <Theta[row], Beta[off+col]>``,
``ll = y log(yhat) [- lgamma(y+1)]``, ``se = (y - yhat)^2``, ``sp = yhat``.
The kernel (``csrc/ell_llk.cu``) writes per-block (ll, se, sp) partials in
float64; a check reads them back once and adds them on the host in
float64.  The all-pairs correction ``colsum(Theta) . colsum(Beta)`` uses
the colsums that the table update (K3) produced for the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from .ell import DeviceEll


def _bucket_llk_plain(Theta, Beta, rows, cols, vals, col_off, full_llk):
    """Plain version of K4 for one bucket: a (1, 3) float64 row."""
    y = vals
    yhat = torch.einsum("ck,cwk->cw", Theta[rows.long()],
                        Beta[cols.long() + col_off])
    mask = y > 0
    zero = torch.zeros_like(yhat)
    ll = y * torch.log(torch.where(yhat > 0, yhat, torch.ones_like(yhat)))
    if full_llk:
        ll = ll - torch.lgamma(y + 1.0)
    parts = [torch.where(mask, ll, zero), torch.where(mask, (y - yhat) ** 2, zero),
             torch.where(mask, yhat, zero)]
    return torch.stack([p.sum(dtype=torch.float64) for p in parts])[None]


def bucket_llk_parts(Theta, Beta, rows, cols, vals, col_off, full_llk: bool):
    """K4 for one bucket: (n_parts, 3) float64 partial sums of (ll, se, sp)."""
    if not Theta.is_cuda:
        return _bucket_llk_plain(Theta, Beta, rows, cols, vals, col_off,
                                 full_llk)
    from .. import _cuda

    m, w = cols.shape
    k = Theta.shape[1]
    _cuda.check(Theta, Beta, vals, dtype=Theta.dtype)
    _cuda.check(rows, cols, dtype=torch.int32)
    if Beta.shape[1] != k or rows.shape != (m,) or vals.shape != (m, w):
        raise ValueError("bucket_llk_parts: shape mismatch")
    nblocks = max(1, -(-m // _cuda.WARPS_PER_BLOCK))
    out = torch.empty((nblocks, 3), dtype=torch.float64, device=Theta.device)
    _cuda.launch("ell_llk", Theta.dtype, k, Theta, Beta, rows, cols, vals, out,
                 m, w, k, col_off, int(bool(full_llk)))
    bucket_llk_parts.launches += 1
    return out


bucket_llk_parts.launches = 0


def ell_llk_rmse_sums(Theta, Beta, layout: DeviceEll, full_llk: bool = False):
    """Partials of the llk pieces over all buckets: (n_parts, 3) float64 on
    the device (columns ll, se, sp)."""
    return torch.cat([bucket_llk_parts(Theta, Beta, b.rows, b.cols, b.vals,
                                       b.col_off, full_llk)
                      for b in layout.buckets])


def ell_train_llk_rmse(Theta, Beta, layout: DeviceEll, nnz: int,
                       theta_colsum, beta_colsum, full_llk: bool = False):
    """Training criterion (reference ``pxi:78``): ``sum(ll) -
    colsum(Theta).colsum(Beta)`` and ``sqrt(sum(se) / nnz)``, as host
    floats.  One device readback.  The correction is rounded to float32,
    as ``hpfrec_tpu.ops.metrics._colsum_dot`` returns it for either
    dtype."""
    parts = ell_llk_rmse_sums(Theta, Beta, layout, full_llk)
    k = Theta.shape[1]
    host = torch.cat([parts.reshape(-1),
                      theta_colsum.reshape(-1).to(torch.float64),
                      beta_colsum.reshape(-1).to(torch.float64)]).cpu().numpy()
    parts = host[:-2 * k].reshape(-1, 3)
    correction = np.float32(np.dot(host[-2 * k:-k], host[-k:]))
    llk = float(parts[:, 0].sum()) - float(correction)
    rmse = float(np.sqrt(parts[:, 1].sum() / nnz))
    return llk, rmse


def theta_diff_norm(Theta, Theta_prev) -> float:
    """Frobenius norm of the Theta delta (diff-norm stopping criterion,
    reference ``pxi:59``)."""
    d = Theta - Theta_prev
    return float(torch.sqrt(torch.sum(d * d)))
