"""Mini-batch stochastic variational inference on one device.

Port of the device-resident SVI epochs of ``hpfrec_tpu/ops/svi.py``
(reference ``cython_loops.pxi:261-377``).  An epoch of one side (users or
items) runs, with no host synchronization:

- **K9** ``build_epoch_buffers`` (``csrc/svi_epoch.cu``): the side's
  nonzeros in shuffled-row order, gathered from its CSR arrays, which stay
  on the device; the host ships the permutation and its row offsets.
- per batch of ``batch_rows`` shuffled rows: both sides' exp tables and
  mean colsums from K3's derive form (``ops/cavi.py:side_derive``);
- **K7** ``batch_phi_sums`` (``csrc/svi_phi_sums.cu``): the batch's phi
  sums on both sides and the other side's touched-row mask;
- ``build_row_mask`` (``csrc/svi_update.cu``): the batch rows' mask;
- **K8** ``svi_update`` (``csrc/svi_update.cu``): the reference's masked
  natural-gradient blend, with the ``n / |batch|`` multiplier.

``svi_batch_update`` is the single-batch entry point of ``partial_fit``,
composed of the same kernels.  ``user_factors_loop`` (**K10**,
``csrc/fold_in.cu``) is the single-user fold-in of ``predict_factors`` and
``add_user``.

Each wrapper takes its plain PyTorch version for CPU tensors, launches its
kernel for CUDA tensors, and counts its launches in ``.launches``.

The JAX module's TPU static-shape devices are not ported: the ``p_cap``
chunk capacity and the chunked inner loop, the padded permutation and pad
batches, and the batches-per-dispatch loop.  Batch boundaries come from
row offsets that the host computes with numpy while it shuffles.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.state import Hyperparams, VariationalState
from .cavi import _colsum_blocks, _finish_colsum, _phi_block, side_derive
from .ell import _INT32_MAX, _upload

# Slots per warp chunk of K7 (csrc/svi_phi_sums.cu kChunk), and chunks per
# second-level partial of a long run (kGroup).
_PHI_CHUNK = 256
_PHI_GROUP = 64


def phi_scratch(n: int, k: int, dtype, device):
    """K7's and K7c's per-call scratch for a stream of ``n`` slots: the
    scale, and per side the chunk heads, tails and group partials."""
    nchunks = max(1, -(-n // _PHI_CHUNK))
    ngroups = -(-nchunks // _PHI_GROUP)
    side = lambda: [torch.empty((m, k), dtype=dtype, device=device)  # noqa: E731
                    for m in (nchunks, nchunks, ngroups)]
    return torch.empty(n, dtype=dtype, device=device), side(), side()


@dataclass
class EpochSide:
    """One side's CSR arrays for epochs over its rows: ``y``/``cols``/
    ``indptr`` on the device (``indptr`` int32), row degrees on the host."""

    y: torch.Tensor  # (nnz,) state dtype
    cols: torch.Tensor  # (nnz,) int32, other-side ids
    indptr: torch.Tensor  # (n_rows + 1,) int32
    deg: np.ndarray  # (n_rows,) int32

    @property
    def n_rows(self) -> int:
        return int(self.deg.shape[0])


def epoch_side(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               dtype, device) -> EpochSide:
    """Upload one side's CSR for SVI epochs.  Counts must fit int32."""
    if int(indptr[-1]) > _INT32_MAX:
        raise ValueError("too many nonzeros for int32 indexing: %d" % int(indptr[-1]))
    device = torch.device(device)
    return EpochSide(y=_upload(data, dtype, device),
                     cols=_upload(indices, np.int32, device),
                     indptr=_upload(indptr, np.int32, device),
                     deg=np.diff(indptr).astype(np.int32))


def epoch_offsets(deg: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """(n + 1,) exclusive prefix sum of the permuted row degrees (host), in
    the dtype of ``deg`` (int32 for an ``EpochSide``: half the bytes of
    int64 on this per-epoch host pass): the rows ``perm[r0:r1]`` span epoch
    positions ``[offsets[r0], offsets[r1])``."""
    out = np.empty(len(perm) + 1, dtype=deg.dtype)
    out[0] = 0
    np.cumsum(np.take(deg, perm), out=out[1:])
    return out


# ---- K9: the epoch stream ----------------------------------------------

def _build_epoch_buffers_plain(y_sorted, cols_sorted, indptr, perm, offsets):
    off = offsets.long()
    pos = torch.arange(y_sorted.shape[0], dtype=torch.int64, device=y_sorted.device)
    p = torch.searchsorted(off, pos, right=True) - 1
    row = perm.long()[p]
    src = indptr.long()[row] + (pos - off[p])
    return y_sorted[src], row.to(torch.int32), cols_sorted[src]


def build_epoch_buffers(y_sorted, cols_sorted, indptr, perm, offsets):
    """K9: one epoch's nonzeros in shuffled-row order, ``(e_y, e_row,
    e_col)`` of length nnz.  ``perm`` (n,) int32 is a permutation of the
    rows, ``offsets`` (n + 1,) int32 its :func:`epoch_offsets`."""
    if not y_sorted.is_cuda:
        return _build_epoch_buffers_plain(y_sorted, cols_sorted, indptr, perm, offsets)
    from .. import _cuda

    nnz = y_sorted.shape[0]
    n_rows = perm.shape[0]
    _cuda.check(y_sorted, dtype=y_sorted.dtype)
    _cuda.check(cols_sorted, indptr, perm, offsets, dtype=torch.int32)
    if (cols_sorted.shape != (nnz,) or indptr.shape != (n_rows + 1,)
            or offsets.shape != (n_rows + 1,)):
        raise ValueError("build_epoch_buffers: shape mismatch")
    e_y = torch.empty_like(y_sorted)
    e_row = torch.empty(nnz, dtype=torch.int32, device=y_sorted.device)
    e_col = torch.empty_like(e_row)
    _cuda.launch("epoch_gather", y_sorted.dtype, None, y_sorted, cols_sorted, indptr,
                 perm, offsets, e_y, e_row, e_col, nnz, n_rows)
    build_epoch_buffers.launches += 1
    return e_y, e_row, e_col


build_epoch_buffers.launches = 0


# ---- K7: batch phi sums --------------------------------------------------

def _index_sum(shape, index, rows):
    """Rows added per index, accumulated in float64 (the yardstick for the
    kernel's fixed-order sums) and returned in the rows' dtype."""
    out = torch.zeros(shape, dtype=torch.float64, device=rows.device)
    return out.index_add_(0, index.long(), rows.double()).to(rows.dtype)


def phi_sums_tables(t_tab, b_tab, y, iu, ii):
    """Phi segment sums of a run of nonzeros, given both exp tables:
    ``(su (nU, k), si (nI, k))`` (JAX ``ops/svi.py:phi_sums_tables``)."""
    phi = _phi_block(t_tab, b_tab, y, iu, ii)
    return _index_sum(t_tab.shape, iu, phi), _index_sum(b_tab.shape, ii, phi)


def _batch_phi_sums_plain(t_loc, t_oth, y, rows, cols):
    s_loc, s_oth = phi_sums_tables(t_loc, t_oth, y, rows, cols)
    omask = torch.zeros((t_oth.shape[0], 1), dtype=torch.bool, device=t_oth.device)
    omask[cols.long()] = True
    return s_loc, s_oth, omask


def batch_phi_sums(t_loc, t_oth, y, rows, cols, bounds, base: int, seg_rows):
    """K7 for one batch: ``(s_loc (n_loc, k), s_oth (n_oth, k), omask
    (n_oth, 1) bool)``.  ``y``/``rows``/``cols`` are the batch's slice of
    the epoch stream (local ids in ``rows``, grouped by row), ``seg_rows``
    (nq,) int32 the batch rows in stream order and ``bounds`` (nq + 1,)
    int32 their epoch offsets, ``base`` the first one.  Rows outside the
    batch sum to 0."""
    if not t_loc.is_cuda:
        return _batch_phi_sums_plain(t_loc, t_oth, y, rows, cols)
    from .. import _cuda

    n = y.shape[0]
    nq = seg_rows.shape[0]
    k = t_loc.shape[1]
    n_oth = t_oth.shape[0]
    _cuda.check(t_loc, t_oth, y, dtype=t_loc.dtype)
    _cuda.check(rows, cols, bounds, seg_rows, dtype=torch.int32)
    if (t_oth.shape[1] != k or rows.shape != (n,) or cols.shape != (n,)
            or bounds.shape != (nq + 1,)):
        raise ValueError("batch_phi_sums: shape mismatch")
    skeys, order = torch.sort(cols, stable=True)
    runs = torch.zeros((n_oth, 2), dtype=torch.int32, device=y.device)
    scale, loc, oth = phi_scratch(n, k, y.dtype, y.device)
    s_loc = torch.zeros_like(t_loc)
    s_oth = torch.empty_like(t_oth)
    omask = torch.empty((n_oth, 1), dtype=torch.bool, device=y.device)
    _cuda.launch("batch_phi_sums", y.dtype, k, t_loc, t_oth, y, rows, cols, bounds,
                 int(base), seg_rows, nq, skeys, order, runs, scale, *loc, *oth,
                 s_loc, s_oth, omask, n, n_oth, k)
    batch_phi_sums.launches += 1
    return s_loc, s_oth, omask


batch_phi_sums.launches = 0


# ---- K8: row mask and the SVI blend ----------------------------------------

def build_row_mask(n_rows: int, rows):
    """(n_rows, 1) boolean mask with True at ``rows`` (duplicates are
    harmless)."""
    mask = torch.zeros((n_rows, 1), dtype=torch.bool, device=rows.device)
    if not rows.is_cuda:
        mask[rows.long()] = True
        return mask
    from .. import _cuda

    _cuda.check(rows, dtype=torch.int32)
    if rows.shape[0]:
        _cuda.launch("row_mask", None, None, rows, rows.shape[0], mask)
        build_row_mask.launches += 1
    return mask


build_row_mask.launches = 0


def _svi_update_math(state: VariationalState, su, si, umask, imask, step, mult,
                     hp: Hyperparams, user_side: bool, blend_all_scalers: bool):
    """Plain version of K8: the JAX function's arithmetic, op for op, with
    ``step`` and ``mult`` as scalars of the state dtype."""
    dt = state.G_shp.dtype
    step = torch.tensor(step, dtype=dt, device=state.G_shp.device)
    mult = torch.tensor(mult, dtype=dt, device=state.G_shp.device)
    step_prev = 1.0 - step
    G_shp, G_rte = state.G_shp, state.G_rte
    L_shp, L_rte = state.L_shp, state.L_rte
    k_rte, t_rte = state.k_rte, state.t_rte

    if user_side:
        Beta_old = L_shp / L_rte
        G_rte = hp.k_shp / k_rte + Beta_old.sum(0, keepdim=True)
        G_shp = torch.where(umask, hp.a, G_shp) + su
        Theta = G_shp / G_rte
        L_shp_scat = torch.where(imask, hp.c, L_shp) + si
        L_shp = torch.where(imask, step * mult * L_shp_scat + step_prev * L_shp, L_shp_scat)
        L_rte = torch.where(
            imask, step * (hp.t_shp / t_rte + Theta.sum(0, keepdim=True)) + step_prev * L_rte,
            L_rte)
        Beta = L_shp / L_rte
    else:
        Theta_old = G_shp / G_rte
        L_rte = hp.t_shp / t_rte + Theta_old.sum(0, keepdim=True)
        L_shp = torch.where(imask, hp.c, L_shp) + si
        G_shp_scat = torch.where(umask, hp.a, G_shp) + su
        G_shp = torch.where(umask, step * mult * G_shp_scat + step_prev * G_shp, G_shp_scat)
        Beta = L_shp / L_rte
        G_rte = torch.where(
            umask, step * (hp.k_shp / k_rte + Beta.sum(0, keepdim=True)) + step_prev * G_rte,
            G_rte)
        Theta = G_shp / G_rte

    new_k = step * (hp.add_k_rte + Theta.sum(1, keepdim=True)) + step_prev * k_rte
    new_t = step * (hp.add_t_rte + Beta.sum(1, keepdim=True)) + step_prev * t_rte
    if blend_all_scalers:
        k_rte, t_rte = new_k, new_t
    else:
        k_rte = torch.where(umask, new_k, k_rte)
        t_rte = torch.where(imask, new_t, t_rte)
    return VariationalState(G_shp, G_rte, L_shp, L_rte, k_rte, t_rte)


def svi_update(state: VariationalState, su, si, umask, imask, step: float, mult: float,
               hp: Hyperparams, user_side: bool, blend_all_scalers: bool,
               colsum_global) -> VariationalState:
    """K8: the SVI blend of one batch given its phi sums ``su``/``si`` and
    masks ``umask``/``imask`` ((n, 1) bool).  ``colsum_global`` is the
    (1, k) colsum of the global side's mean before the update, as K3's
    derive of the batch gives it; the plain version computes it itself.
    Returns a new state."""
    if not state.G_shp.is_cuda:
        return _svi_update_math(state, su, si, umask, imask, step, mult, hp, user_side,
                                blend_all_scalers)
    from .. import _cuda

    users = (state.G_shp, state.G_rte, state.k_rte, su, umask, hp.a, hp.k_shp, hp.add_k_rte)
    items = (state.L_shp, state.L_rte, state.t_rte, si, imask, hp.c, hp.t_shp, hp.add_t_rte)
    loc, glb = (users, items) if user_side else (items, users)
    dt = state.G_shp.dtype
    k = state.G_shp.shape[1]
    _cuda.check(*state, su, si, dtype=dt)
    _cuda.check(umask, imask, dtype=torch.bool)
    for shp, rte, scaler, sums, mask, *_ in (loc, glb):
        n = shp.shape[0]
        if (rte.shape != (n, k) or sums.shape != (n, k) or scaler.shape != (n, 1)
                or mask.shape != (n, 1)):
            raise ValueError("svi_update: shape mismatch")
    _cuda.check(colsum_global, dtype=dt)

    def run(side, colsum, global_pass):
        shp, rte, scaler, sums, mask, prior, scaler_shape, add_scaler = side
        n = shp.shape[0]
        out = (torch.empty_like(shp), torch.empty_like(rte), torch.empty_like(scaler))
        nblocks = _colsum_blocks(n)
        partials = None if global_pass else torch.empty((nblocks, k), dtype=dt,
                                                        device=shp.device)
        _cuda.launch("svi_pass", dt, k, shp, rte, sums, mask, scaler, colsum, float(prior),
                     float(scaler_shape), float(add_scaler), float(step), float(mult),
                     int(bool(blend_all_scalers)), int(global_pass), *out,
                     0 if partials is None else partials, n, k, nblocks)
        return out, partials, nblocks

    (shp_l, rte_l, sc_l), partials, nblocks = run(loc, colsum_global, False)
    colsum_local = _finish_colsum(partials, nblocks, k)
    (shp_g, rte_g, sc_g), _, _ = run(glb, colsum_local, True)
    svi_update.launches += 1
    if user_side:
        return VariationalState(shp_l, rte_l, shp_g, rte_g, sc_l, sc_g)
    return VariationalState(shp_g, rte_g, shp_l, rte_l, sc_g, sc_l)


svi_update.launches = 0


# ---- the epoch runner ------------------------------------------------------

def batch_multipliers(n_rows: int, batch_rows: int, dtype) -> np.ndarray:
    """``n / |batch|`` of each batch of an epoch, in the state dtype (the
    last batch may be short)."""
    nbatches = -(-n_rows // batch_rows)
    sizes = np.full(nbatches, batch_rows, dtype=np.float64)
    sizes[-1] = n_rows - (nbatches - 1) * batch_rows
    return (float(n_rows) / sizes).astype(dtype)


def svi_run_epoch(state: VariationalState, side: EpochSide, perm: np.ndarray,
                  batch_rows: int, step: float, hp: Hyperparams,
                  user_side: bool, mark=None, phi_sums=batch_phi_sums,
                  shard=(0, 1)) -> VariationalState:
    """One epoch over ``side``'s rows in the shuffled order ``perm``
    (reference ``pxi:275-377``; JAX ``svi_run_batches``): K9 once, then for
    each batch K3 derive on both sides, K7, the row mask and K8.  The host
    issues the launches and never waits on the device.  ``mark``, if given,
    is called with a stage's name as soon as the stage is issued (the
    profile script records a CUDA event there).  In a data-parallel fit
    every rank runs the epoch on its replicated state, ``phi_sums`` is K12b
    (``parallel.engine.sharded_svi_phi_sums``), and it gets the share of
    each batch's rows that falls to rank ``shard[0]`` of ``shard[1]``
    (``utils.data.share``)."""
    from ..utils.data import share

    mark = mark or (lambda stage: None)
    device = state.G_shp.device
    dt = state.G_shp.dtype
    n_rows = side.n_rows
    offsets_h = epoch_offsets(side.deg, perm)
    perm_d = _upload(perm, np.int32, device)
    offsets_d = _upload(offsets_h, np.int32, device)
    mark("host offsets + upload")
    e_y, e_row, e_col = build_epoch_buffers(side.y, side.cols, side.indptr, perm_d,
                                            offsets_d)
    mark("K9 epoch gather")
    mults = batch_multipliers(n_rows, batch_rows,
                              np.float32 if dt == torch.float32 else np.float64)
    for b, mult in enumerate(mults):
        r0, r1 = b * batch_rows, min(n_rows, (b + 1) * batch_rows)
        q0, q1 = (r0 + q for q in share(offsets_h[r0:r1 + 1], shard[1], shard[0]))
        s, e = int(offsets_h[q0]), int(offsets_h[q1])
        t_tab, theta_colsum = side_derive(state.G_shp, state.G_rte)
        b_tab, beta_colsum = side_derive(state.L_shp, state.L_rte)
        mark("K3 derive (both sides)")
        t_loc, t_oth, colsum_global = ((t_tab, b_tab, beta_colsum) if user_side
                                       else (b_tab, t_tab, theta_colsum))
        rows_b = perm_d[r0:r1]
        s_loc, s_oth, omask = phi_sums(t_loc, t_oth, e_y[s:e], e_row[s:e], e_col[s:e],
                                       offsets_d[q0:q1 + 1], s, perm_d[q0:q1])
        mark("K7 phi sums (sort included)")
        lmask = build_row_mask(t_loc.shape[0], rows_b)
        mark("row mask")
        if user_side:
            su, si, umask, imask = s_loc, s_oth, lmask, omask
        else:
            su, si, umask, imask = s_oth, s_loc, omask, lmask
        state = svi_update(state, su, si, umask, imask, step, float(mult), hp, user_side,
                           False, colsum_global)
        mark("K8 blend")
    return state


# ---- one batch of triplets (partial_fit) -----------------------------------

def group_by_rows(rows: np.ndarray):
    """Host grouping of a batch by its local ids, as K7 reads it: ``(order,
    seg_rows, bounds)`` with ``rows[order]`` stable-sorted, ``seg_rows``
    (nq,) int32 the distinct ids and ``bounds`` (nq + 1,) int32 their
    offsets in the sorted stream."""
    order = np.argsort(rows, kind="stable")
    seg_rows, starts = np.unique(rows[order], return_index=True)
    bounds = np.append(starts, len(rows)).astype(np.int32)
    return order, seg_rows.astype(np.int32), bounds


def svi_batch_update(state: VariationalState, y: np.ndarray, iu: np.ndarray,
                     ii: np.ndarray, umask, imask, step: float, mult: float,
                     hp: Hyperparams, user_side: bool = True,
                     blend_all_scalers: bool = False, phi_sums=batch_phi_sums,
                     shard=(0, 1)) -> VariationalState:
    """One SVI mini-batch update (JAX ``ops/svi.py:svi_batch_update``) from
    host triplets in any order; ``umask``/``imask`` ((n, 1) bool on the
    state's device) mark the rows to blend.  The host groups the triplets
    by their local id (users for ``user_side``, else items); then K3
    derives both exp tables, K7 sums phi on both sides over every row the
    triplets touch, and K8 blends.  ``user_side=True`` with
    ``blend_all_scalers=True`` is ``partial_fit(batch_type='users')``
    (reference ``pxi:442-473``).  In a data-parallel fit ``phi_sums`` is
    K12b and gets rank ``shard[0]``'s share of the rows, as in
    ``svi_run_epoch``.  Returns a new state."""
    from ..utils.data import share

    device = state.G_shp.device
    npdt = np.float32 if state.G_shp.dtype == torch.float32 else np.float64
    loc, oth = (iu, ii) if user_side else (ii, iu)
    order, seg_rows, bounds = group_by_rows(np.asarray(loc))
    q0, q1 = share(bounds, shard[1], shard[0])
    s, e = int(bounds[q0]), int(bounds[q1])
    order = order[s:e]
    y_d = _upload(np.asarray(y)[order], npdt, device)
    rows_d = _upload(np.asarray(loc)[order], np.int32, device)
    cols_d = _upload(np.asarray(oth)[order], np.int32, device)
    t_tab, theta_colsum = side_derive(state.G_shp, state.G_rte)
    b_tab, beta_colsum = side_derive(state.L_shp, state.L_rte)
    t_loc, t_oth, colsum_global = ((t_tab, b_tab, beta_colsum) if user_side
                                   else (b_tab, t_tab, theta_colsum))
    s_loc, s_oth, _ = phi_sums(t_loc, t_oth, y_d, rows_d, cols_d,
                               _upload(bounds[q0:q1 + 1], np.int32, device), s,
                               _upload(seg_rows[q0:q1], np.int32, device))
    su, si = (s_loc, s_oth) if user_side else (s_oth, s_loc)
    return svi_update(state, su, si, umask, imask, step, mult, hp, user_side,
                      blend_all_scalers, colsum_global)


# ---- K10: the single-user fold-in ------------------------------------------

def _user_factors_loop_plain(y, elogb_rows, beta_colsum, Theta0, G_shp0, G_rte0,
                             k_rte0, hp, maxiter, stop_thr):
    dt = y.dtype
    k_rte = torch.tensor(k_rte0, dtype=dt)
    thr = torch.tensor(stop_thr, dtype=dt)
    k_shp = torch.tensor(hp.k_shp, dtype=dt)  # a true division below, as XLA's

    def softmax_rows(G_shp, G_rte):
        logits = (torch.special.digamma(G_shp) - torch.log(G_rte))[None, :] + elogb_rows
        e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        return e, e.sum(dim=-1)

    Theta, G_shp, G_rte = Theta0, G_shp0, G_rte0
    i, done = 0, False
    while i < maxiter and not done:
        e, s = softmax_rows(G_shp, G_rte)
        phi = (y / s)[:, None] * e
        G_rte = k_shp / k_rte + beta_colsum
        G_shp = hp.a + phi.sum(dim=0)
        Theta_new = G_shp / G_rte
        k_rte = hp.add_k_rte + Theta_new.sum()
        done = bool(torch.linalg.norm(Theta_new - Theta) < thr)
        Theta = Theta_new
        i += 1
    e, s = softmax_rows(G_shp, G_rte)
    return Theta, G_shp, G_rte, e / s[:, None], i


def _launch_fold_in(y, elogb_rows, beta_colsum, Theta0, G_shp0, G_rte0, k_rte0, hp,
                    maxiter, stop_thr, out, phi):
    """K10 on CUDA tensors: Theta, G_shp, G_rte and the int32 iteration count
    into ``out`` ((3k + 1,) of the state dtype; the count in the last
    element's first four bytes), phi_norm into ``phi`` (P, k) unless it is
    None."""
    from .. import _cuda

    P, k = elogb_rows.shape
    dt = y.dtype
    _cuda.check(y, elogb_rows, beta_colsum, Theta0, G_shp0, G_rte0, out, dtype=dt)
    if (y.shape != (P,) or beta_colsum.shape != (k,) or Theta0.shape != (k,)
            or G_shp0.shape != (k,) or G_rte0.shape != (k,) or out.shape != (3 * k + 1,)
            or (phi is not None and phi.shape != (P, k))):
        raise ValueError("user_factors_loop: shape mismatch")
    if phi is not None:
        _cuda.check(phi, dtype=dt)
    _cuda.launch("fold_in", dt, k, y, elogb_rows, beta_colsum, Theta0, G_shp0, G_rte0,
                 float(k_rte0), float(hp.a), float(hp.k_shp), float(hp.add_k_rte),
                 int(maxiter), float(stop_thr), P, k, out, phi)
    user_factors_loop.launches += 1


def user_factors_loop(y, elogb_rows, beta_colsum, Theta0, G_shp0, G_rte0,
                      k_rte0: float, hp: Hyperparams, maxiter: int, stop_thr: float):
    """K10: fold-in CAVI over one user's counts with the item parameters
    frozen (JAX ``ops/svi.py:user_factors_loop``, reference
    ``calc_user_factors`` loop ``pxi:504-515``).  ``y`` (P,), ``elogb_rows``
    (P, k) the E[log beta] rows of the user's items, ``beta_colsum`` and
    the initial ``Theta0``/``G_shp0``/``G_rte0`` (k,), all of the state
    dtype on one device; ``k_rte0`` and ``stop_thr`` are rounded to it.
    Returns ``(Theta, G_shp, G_rte, phi_norm (P, k), n_iters)``; the loop
    stops when ``||Theta_new - Theta|| < stop_thr`` or at ``maxiter``.
    ``fold_in`` is the same loop from and to host arrays."""
    if not y.is_cuda:
        return _user_factors_loop_plain(y, elogb_rows, beta_colsum, Theta0, G_shp0,
                                        G_rte0, k_rte0, hp, maxiter, stop_thr)
    k = beta_colsum.shape[0]
    if elogb_rows.dim() != 2 or elogb_rows.shape[1] != k:
        raise ValueError("user_factors_loop: shape mismatch")
    out = torch.empty(3 * k + 1, dtype=y.dtype, device=y.device)
    phi = torch.empty_like(elogb_rows)
    _launch_fold_in(y, elogb_rows, beta_colsum, Theta0, G_shp0, G_rte0, k_rte0, hp, maxiter,
                    stop_thr, out, phi)
    n_iter = int(out[3 * k:].view(torch.int32)[0])
    return out[:k], out[k:2 * k], out[2 * k:3 * k], phi, n_iter


def fold_in(y, elogb_rows, beta_colsum, Theta0, G_shp0, G_rte0, k_rte0: float,
            hp: Hyperparams, maxiter: int, stop_thr: float, device, return_phi: bool = False):
    """K10 as ``HPF.predict_factors`` and ``HPF.add_user`` call it: the
    arguments of ``user_factors_loop`` as host arrays of the state dtype,
    run on ``device``.  On the card the six arrays go up as one buffer (one
    copy) and Theta, G_shp, G_rte, the count and, with ``return_phi``,
    phi_norm come back as one (one copy).  Returns host arrays ``(Theta,
    G_shp, G_rte, phi_norm or None, n_iters)``."""
    arrays = (y, elogb_rows, beta_colsum, Theta0, G_shp0, G_rte0)
    if torch.device(device).type != "cuda":
        Theta, G_shp, G_rte, phi, n = _user_factors_loop_plain(
            *[torch.from_numpy(np.array(a)) for a in arrays], k_rte0, hp, maxiter, stop_thr)
        return (Theta.numpy(), G_shp.numpy(), G_rte.numpy(),
                phi.numpy() if return_phi else None, n)
    P, k = elogb_rows.shape
    host = torch.from_numpy(np.concatenate([np.ravel(a) for a in arrays]))
    d = host.to(device)
    views = (d[:P], d[P:P + P * k].view(P, k), *d[P + P * k:].view(4, k))
    out = torch.empty(3 * k + 1 + (P * k if return_phi else 0), dtype=d.dtype, device=d.device)
    phi = out[3 * k + 1:].view(P, k) if return_phi else None
    _launch_fold_in(*views, k_rte0, hp, maxiter, stop_thr, out[:3 * k + 1], phi)
    h = out.cpu().numpy()
    n_iter = int(h[3 * k:3 * k + 1].view(np.int32)[0])
    return (h[:k], h[k:2 * k], h[2 * k:3 * k],
            h[3 * k + 1:].reshape(P, k) if return_phi else None, n_iter)


user_factors_loop.launches = 0
