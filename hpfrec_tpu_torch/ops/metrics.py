"""Log-likelihood / RMSE: train over the user-side ELL layout (K4),
validation and ``eval_llk`` over blocked COO triplets (K5); and the small
pair and table reductions (K11).

Port of ``hpfrec_tpu/ops/metrics.py``: ``ell_llk_parts`` /
``ell_llk_rmse_sums`` / ``ell_train_llk_rmse`` (K4), ``llk_rmse_sums`` /
``val_llk_rmse`` / ``train_llk_rmse`` (K5; the last is the blocked-COO
engine's train metric), and ``predict_pairs`` / ``sum_pairs_prediction`` /
``theta_diff_norm`` / ``rowsum_dot_rows`` (K11, ``csrc/pair_ops.cu``).
Over the slots with ``y > 0``: ``yhat = <Theta[u], Beta[i]>``, ``ll = y
log(yhat) [- lgamma(y+1)]``, ``se = (y - yhat)^2``, ``sp = yhat``.  The
kernels (``csrc/ell_llk.cu``, ``csrc/coo_llk.cu``) write per-block (ll, se,
sp) partials in float64; a check reads them back once and adds them on the
host in float64.  The train criterion's all-pairs correction
``colsum(Theta) . colsum(Beta)`` uses colsums that the table kernel (K3)
produced for the same state; the validation criterion subtracts
``sum(sp)`` instead.  K11's reductions follow the same rule: per-block
float64 partials, added on the host in block order.
"""

from __future__ import annotations

import numpy as np
import torch

from .cavi import BlockedCOO
from .ell import DeviceEll, _warps_per_segment


def _llk_terms(y, yhat, full_llk):
    """The llk pieces of K4 and K5's plain versions: a (1, 3) float64 row
    of (ll, se, sp) sums over the entries with ``y > 0``."""
    mask = y > 0
    zero = torch.zeros_like(yhat)
    ll = y * torch.log(torch.where(yhat > 0, yhat, torch.ones_like(yhat)))
    if full_llk:
        ll = ll - torch.lgamma(y + 1.0)
    parts = [torch.where(mask, ll, zero), torch.where(mask, (y - yhat) ** 2, zero),
             torch.where(mask, yhat, zero)]
    return torch.stack([p.sum(dtype=torch.float64) for p in parts])[None]


def _bucket_llk_plain(Theta, Beta, rows, cols, vals, col_off, full_llk):
    """Plain version of K4 for one bucket: a (1, 3) float64 row."""
    yhat = torch.einsum("ck,cwk->cw", Theta[rows.long()],
                        Beta[cols.long() + col_off])
    return _llk_terms(vals, yhat, full_llk)


def bucket_llk_parts(Theta, Beta, rows, cols, vals, col_off, full_llk: bool):
    """K4 for one bucket: (n_parts, 3) float64 partial sums of (ll, se, sp),
    one a block of the kernel (none for an empty bucket); the plain version
    gives one row.  ``ell_llk_rmse_sums`` calls it bucket by bucket, the
    table-sharded engine per bucket and ring offset."""
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
    wps = _warps_per_segment(w)
    nblocks = -(-m // (_cuda.WARPS_PER_BLOCK // wps)) if m and w else 0
    out = torch.empty((nblocks, 3), dtype=torch.float64, device=Theta.device)
    if nblocks:
        _cuda.launch("ell_llk", Theta.dtype, k, Theta, Beta, rows, cols, vals, out,
                     m, w, k, col_off, int(bool(full_llk)), wps)
        bucket_llk_parts.launches += 1
    return out


bucket_llk_parts.launches = 0


def ell_llk_rmse_sums(Theta, Beta, layout: DeviceEll, full_llk: bool = False):
    """Partials of the llk pieces over all buckets: (n_parts, 3) float64 on
    the device (columns ll, se, sp), a launch a bucket."""
    return torch.cat([bucket_llk_parts(Theta, Beta, b.rows, b.cols, b.vals,
                                       b.col_off, full_llk)
                      for b in layout.buckets])


def _one_device(parts):
    return parts


def ell_train_llk_rmse(Theta, Beta, layout: DeviceEll, nnz: int,
                       theta_colsum, beta_colsum, full_llk: bool = False,
                       gather=_one_device):
    """Training criterion (reference ``pxi:78``): ``sum(ll) -
    colsum(Theta).colsum(Beta)`` and ``sqrt(sum(se) / nnz)``, as host
    floats.  One device readback.  The correction is rounded to float32,
    as ``hpfrec_tpu.ops.metrics._colsum_dot`` returns it for either
    dtype.  In a data-parallel fit ``layout`` is the rank's shard and
    ``gather`` brings every rank's partials (K12d,
    ``parallel.engine.gather_partials``)."""
    return _train_llk(gather(ell_llk_rmse_sums(Theta, Beta, layout, full_llk)),
                      nnz, theta_colsum, beta_colsum)


def _train_llk(parts, nnz, theta_colsum, beta_colsum):
    """(llk, rmse) from (n, 3) float64 partials on the device and the two
    (1, k) colsums, read back together."""
    k = theta_colsum.shape[1]
    host = torch.cat([parts.reshape(-1),
                      theta_colsum.reshape(-1).to(torch.float64),
                      beta_colsum.reshape(-1).to(torch.float64)]).cpu().numpy()
    parts = host[:-2 * k].reshape(-1, 3)
    correction = np.float32(np.dot(host[-2 * k:-k], host[-k:]))
    llk = float(parts[:, 0].sum()) - float(correction)
    rmse = float(np.sqrt(parts[:, 1].sum() / nnz))
    return llk, rmse


# ---- the pair walk's grid (K5, K11's predict_pairs) ------------------

# csrc/pair_walk.cuh: a warp takes a run of pairs (or triplets), a multiple
# of _PAIRS_RUN, the least that keeps the grid within _PAIRS_TARGET_WARPS
# warps (an H100's 132 SMs x 64), so that a launch of 100,000 pairs still
# fills the card and one of 38.7M makes ~1,050 blocks; 8 warps a block.
_PAIRS_RUN = 32
_PAIRS_TARGET_WARPS = 132 * 64


def _pairs_grid(n: int):
    """(pairs a warp, blocks) of a pair walk over ``n`` pairs: a function of
    ``n`` only, so the partials add in the same order from run to run."""
    per_warp = _PAIRS_RUN * max(1, -(-n // (_PAIRS_TARGET_WARPS * _PAIRS_RUN)))
    return per_warp, max(1, -(-n // (8 * per_warp)))


def _aligned(*tables):
    """The walk reads rows in vectors of up to 16 bytes from 16-byte
    aligned tables (a fresh allocation is); an offset view is copied, so
    the bits depend on (n, k, dtype) only."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in tables)


# ---- K5: llk pieces over blocked COO ---------------------------------


def _coo_llk_plain(Theta, Beta, y, iu, ii, full_llk):
    """Plain version of K5 for one run of triplets: a (1, 3) float64 row."""
    return _llk_terms(y, (Theta[iu.long()] * Beta[ii.long()]).sum(-1), full_llk)


def llk_rmse_sums(Theta, Beta, data: BlockedCOO, full_llk: bool = False):
    """K5: (n_parts, 3) float64 partial sums of (ll, se, sp) over the
    triplets of ``data``; padding (y == 0) counts nothing.  The plain
    version gives one row per block of ``data``, the kernel one per block
    of its grid (``_pairs_grid`` of the triplet count)."""
    if not Theta.is_cuda:
        return torch.cat([_coo_llk_plain(Theta, Beta, data.y[b], data.ix_u[b],
                                         data.ix_i[b], full_llk)
                          for b in range(data.y.shape[0])])
    from .. import _cuda

    y, iu, ii = (a.reshape(-1) for a in data)
    n = y.shape[0]
    k = Theta.shape[1]
    _cuda.check(Theta, Beta, y, dtype=Theta.dtype)
    _cuda.check(iu, ii, dtype=torch.int32)
    if Beta.shape[1] != k or iu.shape != (n,) or ii.shape != (n,):
        raise ValueError("llk_rmse_sums: shape mismatch")
    Theta, Beta = _aligned(Theta, Beta)
    per_warp, nblocks = _pairs_grid(n)
    out = torch.zeros((nblocks, 3), dtype=torch.float64, device=Theta.device)
    if n:
        _cuda.launch("coo_llk", Theta.dtype, k, Theta, Beta, y, iu, ii, out, n, k,
                     int(bool(full_llk)), per_warp, nblocks)
        llk_rmse_sums.launches += 1
    return out


llk_rmse_sums.launches = 0


def train_llk_rmse(Theta, Beta, data: BlockedCOO, nnz: int, theta_colsum,
                   beta_colsum, full_llk: bool = False, gather=_one_device):
    """Training criterion of the blocked-COO engine (JAX
    ``metrics.py:train_llk_rmse``): K5 over the training stream, with the
    all-pairs correction from the colsums that K3 made for the same state,
    as in ``ell_train_llk_rmse``.  Host floats, one device readback.  In a
    data-parallel fit ``data`` is the rank's share of the stream and
    ``gather`` brings every rank's partials (K12d)."""
    return _train_llk(gather(llk_rmse_sums(Theta, Beta, data, full_llk)), nnz,
                      theta_colsum, beta_colsum)


def val_llk_rmse(Theta, Beta, data: BlockedCOO, nnz: int, full_llk: bool = False,
                 gather=_one_device):
    """Validation criterion (reference ``pxi:72``): ``sum(ll) - sum(sp)``
    over the observed pairs and ``sqrt(sum(se) / nnz)``, as host floats.
    One device readback.  In a data-parallel fit ``data`` is the rank's
    share of the blocks and ``gather`` brings every rank's partials (K12d)."""
    parts = gather(llk_rmse_sums(Theta, Beta, data, full_llk)).cpu().numpy()
    llk = float(parts[:, 0].sum()) - float(parts[:, 2].sum())
    rmse = float(np.sqrt(parts[:, 1].sum() / nnz))
    return llk, rmse


# ---- K11: pair and table reductions ----------------------------------

def _reduce_blocks(n: int, per_block: int) -> int:
    """Blocks of a fixed-grid reduction over ``n`` items (at most 1024):
    a function of the size only, so the partials add in the same order
    from run to run."""
    return max(1, min(1024, -(-n // per_block)))


def _pairs_plain(Theta, Beta, iu, ii):
    return (Theta[iu.long()] * Beta[ii.long()]).sum(-1)


def _predict_pairs_launch(Theta, Beta, iu, ii, want_sum: bool):
    from .. import _cuda

    n = iu.shape[0]
    k = Theta.shape[1]
    _cuda.check(Theta, Beta, dtype=Theta.dtype)
    _cuda.check(iu, ii, dtype=torch.int32)
    if Beta.shape[1] != k or ii.shape != (n,):
        raise ValueError("predict_pairs: shape mismatch")
    Theta, Beta = _aligned(Theta, Beta)
    out = torch.empty(n, dtype=Theta.dtype, device=Theta.device)
    per_warp, nblocks = _pairs_grid(n)
    partials = (torch.zeros(nblocks, dtype=torch.float64, device=Theta.device)
                if want_sum else None)
    if n:
        _cuda.launch("predict_pairs", Theta.dtype, k, Theta, Beta, iu, ii, out, partials,
                     n, k, per_warp, nblocks)
        predict_pairs.launches += 1
    return out, partials


def predict_pairs(Theta, Beta, iu, ii):
    """K11: ``yhat_j = Theta[iu_j] . Beta[ii_j]`` in the state dtype, (n,)
    on the tables' device (reference ``predict_multiple``, ``pxi:803-810``).
    ``iu``/``ii`` are int32."""
    if not Theta.is_cuda:
        return _pairs_plain(Theta, Beta, iu, ii)
    return _predict_pairs_launch(Theta, Beta, iu, ii, False)[0]


predict_pairs.launches = 0


def sum_pairs_prediction(Theta, Beta, iu, ii) -> float:
    """Sum of ``predict_pairs`` (reference ``sum_prediction``,
    ``pxi:816-825``), returned in the state dtype's precision: on the card
    from the kernel's float64 per-block partials."""
    if not Theta.is_cuda:
        return float(_pairs_plain(Theta, Beta, iu, ii).sum())
    partials = _predict_pairs_launch(Theta, Beta, iu, ii, True)[1]
    return float(partials.cpu().numpy().sum().astype(_np_dtype(Theta)))


def _np_dtype(t):
    return np.float32 if t.dtype == torch.float32 else np.float64


def _theta_diff_norm_plain(Theta, Theta_prev) -> float:
    d = Theta - Theta_prev
    return float(torch.sqrt(torch.sum(d * d)))


def theta_diff_norm(Theta, Theta_prev, gather=None) -> float:
    """K11: Frobenius norm of the Theta delta (diff-norm stopping
    criterion, reference ``pxi:59``); the squared sum is rounded to the
    state dtype before the square root, as the JAX function takes it in
    that dtype.  In a table-sharded fit ``Theta`` holds the rank's rows and
    ``gather`` (K12d) brings every rank's float64 partials of the squared
    sum."""
    if not Theta.is_cuda:
        if gather is None:
            return _theta_diff_norm_plain(Theta, Theta_prev)
        d = Theta - Theta_prev
        partials = torch.sum(d * d).to(torch.float64).reshape(1)
    else:
        from .. import _cuda

        _cuda.check(Theta, Theta_prev, dtype=Theta.dtype)
        if Theta_prev.shape != Theta.shape:
            raise ValueError("theta_diff_norm: shape mismatch")
        n = Theta.numel()
        nblocks = _reduce_blocks(n, 256)
        partials = torch.empty(nblocks, dtype=torch.float64, device=Theta.device)
        _cuda.launch("theta_diff", Theta.dtype, None, Theta, Theta_prev, partials, n, nblocks)
        theta_diff_norm.launches += 1
    if gather is not None:
        partials = gather(partials)
    total = partials.cpu().numpy().sum()
    return float(np.sqrt(_np_dtype(Theta)(total)))


theta_diff_norm.launches = 0


def _rowsum_dot_rows_plain(Theta, Beta, iu, ii) -> float:
    return float(np.float32(torch.dot(Theta[iu.long()].sum(0), Beta[ii.long()].sum(0)).item()))


def _rowsum_dot_launch(Theta, Beta, iu, ii, nblocks=None):
    """The kernel and its device finish over ``_pairs_grid(n)`` (or a
    larger grid of ``nblocks``, whose blocks past the last pair add
    nothing): the float64 dot, (1,) on the device."""
    from .. import _cuda

    n = iu.shape[0]
    k = Theta.shape[1]
    _cuda.check(Theta, Beta, dtype=Theta.dtype)
    _cuda.check(iu, ii, dtype=torch.int32)
    if Beta.shape[1] != k or ii.shape != (n,):
        raise ValueError("rowsum_dot_rows: shape mismatch")
    Theta, Beta = _aligned(Theta, Beta)
    per_warp, grid = _pairs_grid(n)
    nblocks = grid if nblocks is None else nblocks
    partials = torch.empty((nblocks, 2 * k), dtype=torch.float64, device=Theta.device)
    out = torch.empty(1, dtype=torch.float64, device=Theta.device)
    _cuda.launch("rowsum_dot", Theta.dtype, k, Theta, Beta, iu, ii, partials, out, n, k,
                 per_warp, nblocks)
    rowsum_dot_rows.launches += 1
    return out


def rowsum_dot_rows(Theta, Beta, iu, ii) -> float:
    """K11: ``colsum(Theta[iu]) . colsum(Beta[ii])`` (rows counted with
    multiplicity), rounded to float32 as the JAX function returns it: the
    final eval's correction on a validation set (reference ``pxi:105``).
    On the card the column sums and the dot are float64 and stay on the
    device (the kernel's per-block partials, then a launch that adds them
    and takes the dot); one value is copied back."""
    if not Theta.is_cuda:
        return _rowsum_dot_rows_plain(Theta, Beta, iu, ii)
    if iu.shape[0] == 0:
        return 0.0
    return float(np.float32(_rowsum_dot_launch(Theta, Beta, iu, ii).item()))


rowsum_dot_rows.launches = 0
