"""The CAVI table math (K3), the carried iteration both full-batch
engines share, and the blocked-COO engine (K7c).

Port of ``hpfrec_tpu/ops/cavi.py`` and of the table math of
``hpfrec_tpu/ops/ell.py:cavi_step_ell_carried`` / ``_carry_init``.  For
one side (users: prior ``a``, scaler ``k_rte``; items: prior ``c``,
scaler ``t_rte``)::

    shp    = prior + sums
    rte    = scaler_shape / scaler_old + colsum_other
    mean   = shp / rte                      (Theta or Beta)
    tab    = exp(digamma(shp) - log(rte) - rowmax)   (non-finite rowmax -> 0)
    scaler = add_scaler + rowsum(mean)
    colsum = colsum(mean)

``side_update`` runs all of it; ``side_derive`` only derives ``tab`` and
``colsum`` from a given (shp, rte).  Both launch the hand-written kernel of
``csrc/table_update.cu`` for CUDA tensors and run the plain PyTorch
version below for CPU tensors; with ``tab_dtype=torch.bfloat16`` (the
``gather_dtype='bfloat16'`` option of the ELL engine) they store ``tab``
in bfloat16 (launches counted in ``.launches_bf16``, the others in
``.launches``).  ``side_update``'s pad-row form (``n_real``, for the
table-sharded engine) writes ``scaler = 0`` on a rank's padding rows,
which keeps them inert (``csrc/table_update.cu`` says how), and
``colsum_finish`` adds the ranks' (1, k) colsums in one fixed order.  The
SVI batches (``ops/svi.py``) derive both sides' tables
with ``side_derive`` before every batch.

``cavi_step_carried`` is one iteration given its phi sums: the user side
is updated first, then the item side, each producing the next iteration's
exp table and mean colsum (the ``Carry``).  The ELL engine
(``ops/ell.py``) gets its phi sums from K1/K2, the blocked-COO engine
(``engine='coo'``) from **K7c** ``coo_phi_sums``
(``csrc/svi_phi_sums.cu``): the SVI kernel's segmented reductions and
finish passes over the whole user-sorted training stream, with chunk
passes of its own that read an item-ordered copy of the stream built once
per fit (``coo_stream``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..models.state import VariationalState


class BlockedCOO(NamedTuple):
    """Padded, blocked COO stream.  All (nblocks, B); padding has y == 0."""

    y: torch.Tensor
    ix_u: torch.Tensor  # int32
    ix_i: torch.Tensor  # int32


def blocked_stream(y, ix_u, ix_i, block_size=None, shard=(0, 1)) -> BlockedCOO:
    """Triplet tensors as the rank's share of their padded, blocked stream,
    made where they are: ``utils.data.block_coo``'s blocks and padding,
    their count a multiple of ``n_shards``, and an equal share of them
    for ``shard=(rank, n_shards)``."""
    from ..utils.data import block_shape

    rank, n_shards = shard
    nnz = int(y.shape[0])
    B, nblocks = block_shape(nnz, block_size, n_shards)
    per = nblocks // n_shards
    lo, hi = (min(nnz, j * per * B) for j in (rank, rank + 1))

    def part(a):
        out = a.new_zeros(per * B)
        out[:hi - lo] = a[lo:hi]
        return out.view(per, B)

    return BlockedCOO(part(y), part(ix_u), part(ix_i))


def device_blocked_coo(y, ix_u, ix_i, device, block_size=None, shard=(0, 1)):
    """Host triplets as ``blocked_stream`` on ``device`` (only the rank's
    share goes up), and the number of all the triplets."""
    blk = blocked_stream(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (y, ix_u, ix_i)),
                         block_size, shard)
    return BlockedCOO(*(a.to(device) for a in blk)), int(y.shape[0])


def _phi_block(t_tab, b_tab, y, iu, ii):
    """phi for a run of nonzeros: ``y * (t[u] * b[i]) / <t[u], b[i]>``, rows
    (n, k); ``t_tab``/``b_tab`` are the stabilized exp tables."""
    p = t_tab[iu.long()] * b_tab[ii.long()]
    denom = p.sum(-1)
    return (y / denom)[:, None] * p

# The colsum partials of K8 (ops/svi.py): a fixed grid of at most this
# many blocks (one warp per row, grid-stride), each writing one (k,)
# partial that a second pass adds in block order, so colsums are
# deterministic.
_MAX_COLSUM_BLOCKS = 1024
_WARPS_PER_BLOCK = 8
# K3's tiling (csrc/table_update.cu): ~8 KB of a table a tile, at most 256
# rows, and 8 consecutive tiles a block, each block writing one (k,)
# colsum partial.
_K3_TILE_BYTES = 8192
_K3_MAX_ROWS = 256
_K3_TILES_PER_BLOCK = 8


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
                       add_scaler, tab_dtype=None, n_real=None):
    shp = prior + sums
    rte = scaler_shape / scaler_old + colsum_other
    mean = shp / rte
    tab = exp_elog_tables(shp, rte)
    scaler = add_scaler + mean.sum(dim=1, keepdim=True)
    if n_real is not None:
        scaler[n_real:] = 0
    return (shp, rte, tab if tab_dtype is None else tab.to(tab_dtype), scaler,
            mean.sum(dim=0, keepdim=True))


def _side_derive_plain(shp, rte, tab_dtype=None):
    tab = exp_elog_tables(shp, rte)
    return (tab if tab_dtype is None else tab.to(tab_dtype),
            (shp / rte).sum(dim=0, keepdim=True))


def _tab_kernel(name, tab_dtype):
    """K3's entry point for a tab of ``tab_dtype`` (None: the state dtype)."""
    if tab_dtype is None:
        return name
    if tab_dtype != torch.bfloat16:
        raise TypeError(f"{name}: tab_dtype must be None or torch.bfloat16")
    return name + "_bf16"


def _colsum_blocks(n: int) -> int:
    return max(1, min(_MAX_COLSUM_BLOCKS, -(-n // _WARPS_PER_BLOCK)))


def _k3_grid(n: int, k: int, itemsize: int):
    """K3's rows a tile and blocks for an (n, k) table of ``itemsize``-byte
    elements: a function of the shapes and the dtype only (so every card
    and rank adds the same partials).  Rows a tile are a multiple of 4 and
    make ``rows * k`` a multiple of 8, so that every tile starts 16-byte
    aligned in each table (bfloat16 tab included) and in the row scalers."""
    align = math.lcm(4, 8 // math.gcd(k, 8))
    rows = align * max(1, min(_K3_MAX_ROWS, _K3_TILE_BYTES // itemsize // k) // align)
    tiles = -(-n // rows)
    return rows, max(1, -(-tiles // _K3_TILES_PER_BLOCK))


def _finish_colsum(partials, nblocks, k):
    from .. import _cuda

    colsum = torch.empty((1, k), dtype=partials.dtype, device=partials.device)
    _cuda.launch("colsum_finish", partials.dtype, k, partials, colsum,
                 nblocks, k)
    return colsum


def side_update(sums, scaler_old, colsum_other, prior: float,
                scaler_shape: float, add_scaler: float, tab_dtype=None, n_real=None):
    """K3 update form.  Returns ``(shp, rte, tab, scaler, colsum)`` with
    shapes (n, k) x 3, (n, 1), (1, k); ``tab`` in ``tab_dtype`` (None: the
    state dtype).  ``n_real`` (an int in [0, n]) selects the pad-row form:
    rows ``n_real`` and after write ``scaler = 0`` (launches counted in
    ``.launches_pad`` / ``.launches_pad_bf16``)."""
    n, k = sums.shape
    if n_real is not None and not 0 <= n_real <= n:
        raise ValueError("side_update: n_real=%s outside [0, %d]" % (n_real, n))
    if not sums.is_cuda:
        return _side_update_plain(sums, scaler_old, colsum_other, prior,
                                  scaler_shape, add_scaler, tab_dtype, n_real)
    from .. import _cuda

    _cuda.check(sums, scaler_old, colsum_other, dtype=sums.dtype)
    if scaler_old.shape != (n, 1) or colsum_other.shape != (1, k):
        raise ValueError("side_update: shape mismatch")
    name = _tab_kernel("table_update", tab_dtype)
    shp, rte = torch.empty_like(sums), torch.empty_like(sums)
    tab = torch.empty_like(sums, dtype=tab_dtype)
    scaler = torch.empty_like(scaler_old)
    rows, nblocks = _k3_grid(n, k, sums.element_size())
    partials = torch.empty((nblocks, k), dtype=sums.dtype, device=sums.device)
    _cuda.launch(name, sums.dtype, k, sums, scaler_old, colsum_other,
                 float(prior), float(scaler_shape), float(add_scaler),
                 shp, rte, tab, scaler, partials, n, n if n_real is None else n_real, k,
                 rows, nblocks)
    counter = "launches" + ("" if n_real is None else "_pad") + (
        "" if tab_dtype is None else "_bf16")
    setattr(side_update, counter, getattr(side_update, counter) + 1)
    return shp, rte, tab, scaler, _finish_colsum(partials, nblocks, k)


side_update.launches = side_update.launches_bf16 = 0
side_update.launches_pad = side_update.launches_pad_bf16 = 0


def side_derive(shp, rte, tab_dtype=None):
    """K3 derive-only form: ``(tab, colsum(shp / rte))``, ``tab`` in
    ``tab_dtype`` (None: the state dtype)."""
    if not shp.is_cuda:
        return _side_derive_plain(shp, rte, tab_dtype)
    from .. import _cuda

    n, k = shp.shape
    _cuda.check(shp, rte, dtype=shp.dtype)
    if rte.shape != (n, k):
        raise ValueError("side_derive: shape mismatch")
    name = _tab_kernel("table_derive", tab_dtype)
    tab = torch.empty_like(shp, dtype=tab_dtype)
    rows, nblocks = _k3_grid(n, k, shp.element_size())
    partials = torch.empty((nblocks, k), dtype=shp.dtype, device=shp.device)
    _cuda.launch(name, shp.dtype, k, shp, rte, tab, partials, n, k, rows, nblocks)
    if tab_dtype is None:
        side_derive.launches += 1
    else:
        side_derive.launches_bf16 += 1
    return tab, _finish_colsum(partials, nblocks, k)


side_derive.launches = side_derive.launches_bf16 = 0


def colsum_finish(partials):
    """``partials.sum(0)`` as (1, k), added in one fixed order: K3's
    finishing pass, which the table-sharded engine runs over the (W, k)
    colsums of its W ranks, so that every rank gets the same bits."""
    if not partials.is_cuda:
        return partials.sum(dim=0, keepdim=True)
    from .. import _cuda

    nblocks, k = partials.shape
    _cuda.check(partials, dtype=partials.dtype)
    out = _finish_colsum(partials, nblocks, k)
    colsum_finish.launches += 1
    return out


colsum_finish.launches = 0


def kernel_digamma(x, stepwise: bool = False):
    """The digamma of K3 and K10 (``csrc/common.cuh``) elementwise on a CUDA
    tensor of float32 or float64, or with ``stepwise`` the form with a
    reciprocal a step of the shift that K3 used before its tiled form
    (``csrc/table_update.cu``): what ``chip_smoke.py`` and
    ``scripts/split_k3_k4.py`` measure the kernels' digamma with, against
    ``scipy.special.digamma``.  On a CPU tensor, PyTorch's digamma."""
    if not x.is_cuda:
        return torch.special.digamma(x)
    from .. import _cuda

    _cuda.check(x, dtype=x.dtype)
    out = torch.empty_like(x)
    _cuda.launch("digamma_eval", x.dtype, None, x, out, x.numel(), int(bool(stepwise)))
    return out


# ---- the carried iteration ---------------------------------------------

class Carry(NamedTuple):
    """Loop carry of the full-batch engines: the state, both sides' exp
    tables (in the gather dtype), and both colsums of the posterior means
    (colsum(Theta) feeds the train-llk correction, colsum(Beta) the next
    user-side rate)."""

    state: VariationalState
    t_tab: torch.Tensor
    b_tab: torch.Tensor
    theta_colsum: torch.Tensor  # (1, k)
    beta_colsum: torch.Tensor  # (1, k)


def _carry_init(state, gather_dtype=None) -> Carry:
    """Derive the exp tables and mean colsums from a state (K3 derive);
    ``gather_dtype`` (None or torch.bfloat16) is the tables' storage."""
    t_tab, theta_colsum = side_derive(state.G_shp, state.G_rte, gather_dtype)
    b_tab, beta_colsum = side_derive(state.L_shp, state.L_rte, gather_dtype)
    return Carry(state, t_tab, b_tab, theta_colsum, beta_colsum)


def cavi_step_carried(carry: Carry, su, si, hp, gather_dtype=None, colsum=None,
                      n_real=(None, None)) -> Carry:
    """The table math of one CAVI iteration (reference
    ``cython_loops.pxi:227-259``) given both sides' phi sums of the
    carried tables: the user side is updated first with the carried
    colsum(Beta) and the old k_rte, then the item side with colsum of the
    new Theta and the old t_rte (K3's update form, twice).

    The table-sharded engine holds a rank's rows of each table: it passes
    ``colsum``, which turns the rank's (1, k) colsum into the colsum over
    every rank, and ``n_real`` (users, items), the rank's real rows, for
    K3's pad-row form."""
    state = carry.state
    colsum = colsum or (lambda c: c)
    G_shp, G_rte, t_new, k_rte, theta_colsum = side_update(
        su, state.k_rte, carry.beta_colsum, hp.a, hp.k_shp, hp.add_k_rte, gather_dtype,
        n_real[0])
    theta_colsum = colsum(theta_colsum)
    L_shp, L_rte, b_new, t_rte, beta_colsum = side_update(
        si, state.t_rte, theta_colsum, hp.c, hp.t_shp, hp.add_t_rte, gather_dtype, n_real[1])
    beta_colsum = colsum(beta_colsum)
    return Carry(VariationalState(G_shp, G_rte, L_shp, L_rte, k_rte, t_rte),
                 t_new, b_new, theta_colsum, beta_colsum)


# ---- K7c: the blocked-COO engine -----------------------------------------

class CooStream(NamedTuple):
    """A fit's training triplets on the device for the blocked-COO engine:
    the padded blocked stream (user-sorted; K5's train metric reads it),
    and for K7c its first ``nnz`` entries with the user run bounds and the
    item-ordered stream (the stable sort of ``ix_i``), built once per
    fit."""

    data: BlockedCOO
    nnz: int
    user_bounds: torch.Tensor  # (nU + 1,) int32
    item_keys: torch.Tensor  # (nnz,) int32: ix_i in item order
    item_users: torch.Tensor  # (nnz,) int32: ix_u in item order
    item_pos: torch.Tensor  # (nnz,) int32: each triplet's position in item order
    item_runs: torch.Tensor  # (nI, 2) int32: each item's [start, end) in item order

    def flat(self):
        """``(y, ix_u, ix_i)`` of the real triplets, (nnz,) each."""
        return tuple(a.reshape(-1)[:self.nnz] for a in self.data)


def coo_stream(user, n_items: int, block_size=None, shard=(0, 1)) -> CooStream:
    """The blocked-COO engine's stream from a fit's user side
    (``ops.ingest.Csr``, where it was sorted), whose entries are the
    user-sorted triplets.  The item order is the stable sort of the
    stream's item ids (``torch.sort(..., stable=True)``), once per fit;
    from it the item-ordered user ids (``item_users``), each triplet's
    position in that order (``item_pos``: ``item_users[item_pos[j]] ==
    ix_u[j]``) and each item's run (K15b over the sorted ids).

    ``shard=(rank, n_shards)`` takes the rank's share of the stream: the
    stream is cut at user boundaries into near-equal shares
    (``utils.data.share``), and the share gets its own user bounds
    (empty for the other users) and item order."""
    from ..utils.data import share
    from .ingest import csr_indptr

    u0, u1 = share(user.indptr, shard[1], shard[0])
    lo, hi = int(user.indptr[u0]), int(user.indptr[u1])
    nnz = hi - lo
    device = user.cols.device
    ix_u, ix_i = user.row_ids(u0, u1), user.cols[lo:hi]
    keys, order = torch.sort(ix_i, stable=True)
    pos = torch.empty(nnz, dtype=torch.int32, device=device)
    pos[order] = torch.arange(nnz, dtype=torch.int32, device=device)
    runs = csr_indptr(keys, n_items)
    return CooStream(data=blocked_stream(user.vals[lo:hi], ix_u, ix_i, block_size), nnz=nnz,
                     user_bounds=(user.indptr_dev - lo).clamp_(0, nnz),
                     item_keys=keys, item_users=ix_u[order], item_pos=pos,
                     item_runs=torch.stack([runs[:-1], runs[1:]], dim=1))


def coo_phi_sums(t_tab, b_tab, coo: CooStream):
    """K7c: ``(su (nU, k), si (nI, k))``, the phi rows of every training
    triplet summed per user and per item (JAX ``phi_segment_sums``)."""
    y, iu, ii = coo.flat()
    if not t_tab.is_cuda:
        from .svi import phi_sums_tables

        return phi_sums_tables(t_tab, b_tab, y, iu, ii)
    from .. import _cuda
    from .svi import phi_scratch

    n = coo.nnz
    n_users, k = t_tab.shape
    n_items = b_tab.shape[0]
    _cuda.check(t_tab, b_tab, y, dtype=t_tab.dtype)
    _cuda.check(iu, ii, coo.user_bounds, coo.item_keys, coo.item_users, coo.item_pos,
                coo.item_runs, dtype=torch.int32)
    if (b_tab.shape[1] != k or coo.user_bounds.shape != (n_users + 1,)
            or coo.item_keys.shape != (n,) or coo.item_users.shape != (n,)
            or coo.item_pos.shape != (n,) or coo.item_runs.shape != (n_items, 2)):
        raise ValueError("coo_phi_sums: shape mismatch")
    scale, users, items = phi_scratch(n, k, y.dtype, y.device)
    su = torch.zeros_like(t_tab)
    si = torch.empty_like(b_tab)
    _cuda.launch("coo_phi_sums", y.dtype, k, t_tab, b_tab, y, iu, ii, coo.user_bounds,
                 n_users, coo.item_keys, coo.item_users, coo.item_pos, coo.item_runs, scale,
                 *users, *items, su, si, n, n_items, k)
    coo_phi_sums.launches += 1
    return su, si


coo_phi_sums.launches = 0


def run_cavi_block_coo(carry: Carry, coo: CooStream, niter: int, hp,
                       phi_sums=coo_phi_sums) -> Carry:
    """``niter`` CAVI iterations of the blocked-COO engine (JAX
    ``run_cavi_block``) as a loop of launches with no host sync: K7c over
    the carried tables, then K3's update for users and for items.  JAX's
    ``cavi_step`` derives both exp tables and colsum(Beta) from the state
    at the top of every iteration; the carry holds the same values, made
    where the previous iteration updated each side (JAX ``ell.py:776-777``:
    the expressions are identical on identical values).  ``phi_sums`` is
    K7c of the whole stream, or in a data-parallel fit K12c over the
    rank's share ``coo`` (``parallel.engine.sharded_coo_phi_sums``)."""
    for _ in range(int(niter)):
        su, si = phi_sums(carry.t_tab, carry.b_tab, coo)
        carry = cavi_step_carried(carry, su, si, hp)
    return carry
