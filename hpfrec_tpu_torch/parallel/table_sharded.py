"""Table-sharded (model-parallel) CAVI engine over ``torch.distributed`` (K13).

Port of ``hpfrec_tpu/parallel/table_sharded.py``.  The data-parallel
engine (``engine.py``) replicates the factor tables; this one shards both:
each rank holds a block of rows of the user tables and of the item tables,
and the ELL-packed nonzeros of exactly its own rows on both sides, so phi
sums, segment sums and the table updates are all local.  What crosses
ranks:

- **the opposite exp table, around a ring** (K13a, :func:`ring_table_sums`,
  JAX ``_ring_table_sums``).  A rank's segments are keyed at build time by
  the ring offset ``o = (d - e) % W`` of the opposite shard ``e`` they
  read, their cols local to a sub-tile of that shard
  (:func:`build_sharded_ell`).  At step ``o`` rank ``d`` holds shard
  ``(d - o) % W``, runs K1 on exactly its offset-``o`` buckets (column base
  the sub-tile's first row), and passes the shard on to rank ``d + 1``;
  K2 then reassembles the segments into the rank's rows.  Each shard
  visits each rank once, and a rank holds at most three shards (its own
  and two buffers), never the whole table.  On NCCL the next shard's
  transfer (``batch_isend_irecv``) runs while K1 reads the present one.
  gloo cannot send CUDA tensors, so on a gloo mesh with CUDA tables every
  step is staged through pinned host buffers, explicitly; that route is
  taken only for a gloo mesh, never after an NCCL failure.  The tables
  travel in the gather dtype (bfloat16 with ``gather_dtype='bfloat16'``).
- **three (1, k) colsums an iteration** (K13b, :func:`table_sharded_step`,
  JAX ``make_table_sharded_step``): colsum(Theta) between the user and the
  item update, colsum(Beta) after it (and once in :meth:`TableSharded.
  carry_init`).  Each rank's K3 colsum is gathered into (W, k) and added by
  K3's own finishing pass (``ops.cavi.colsum_finish``), so every rank gets
  the same bits; the sum runs in another order than on one device, so a
  table-sharded fit is not bit-equal to the one-device fit (float64:
  ~1e-14 relative; the tests and ``chip_smoke.py`` state the limits).
- **the train metric** (K13c, :func:`table_sharded_llk_parts`, JAX
  ``make_table_sharded_metric``): K4 over the rank's users' buckets, the
  Beta shards on the same ring, and K12d's ``gather_partials``.

Padding.  Both sides are padded so that each rank's row count is a whole
number of sub-tiles of the opposite side's plan (:func:`plan_table_sharding`),
and rows are spread over the ranks by degree (:func:`plan_balanced_rows`).
Padding rows stay inert with no mask: they start with shape 1, rate +inf
and scaler 0 (:func:`pad_state`), so their means and exp-table rows are
exactly +0.0, and K3's pad-row form (``side_update(..., n_real=)``) writes
their scaler 0 again every iteration.  The padding rows of a rank are the
tail of its rows (:func:`rank_share` checks it).  A fit reads back only the
real rows, in their original order (:meth:`TableSharded.gather_rows`).

The host half (planning, balancing, the sharded layouts) is a copy of the
JAX module's and builds the same layouts bit for bit, on the port's
``ops.ell.build_ell`` and its copy of the 40 MB sub-tile window (a TPU
figure, kept so that the layouts compare; the H100's own width is open).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.state import VariationalState
from ..ops.cavi import Carry, _carry_init, cavi_step_carried, colsum_finish
from ..ops.ell import (_FAST_GATHER_BYTES, _INT32_MAX, DeviceBucket, DeviceEll, EllBucket,
                       _acc_dtype, _upload, bucket_phi_sums, build_ell, segment_table_sums)
from ..ops.metrics import bucket_llk_parts
from .engine import all_gather_rows
from .mesh import Mesh

# ---- host half: copies of the JAX module's planning and packing ------------------


def plan_table_sharding(n_rows: int, k: int, ndev: int,
                        gather_itemsize: int = 4) -> Tuple[int, int, int, int]:
    """One side's padded row layout as a gather target: ``(n_padded,
    per_dev, n_sub, chunk)`` with ``per_dev = n_sub * chunk`` rows a rank,
    ``chunk`` rows of the exp table within the 40 MB window."""
    per0 = -(-n_rows // ndev)
    c0 = max(1, _FAST_GATHER_BYTES // (k * gather_itemsize))
    n_sub = max(1, -(-per0 // c0))
    chunk = -(-per0 // n_sub)
    per = n_sub * chunk
    return per * ndev, per, n_sub, chunk


def plan_balanced_rows(deg: np.ndarray, n_padded: int, ndev: int) -> np.ndarray:
    """Degree-aware row -> rank assignment (a row-granular snake over the
    degree-sorted rows): ``perm`` (n_padded,) int64, rank ``p // per``'s
    local slot ``p % per`` holding row ``perm[p]`` (ids past ``len(deg)``
    are padding, of degree 0).  Stable sorts: deterministic."""
    per = n_padded // ndev
    assert per * ndev == n_padded
    if len(deg) < n_padded:
        deg = np.concatenate([deg, np.zeros(n_padded - len(deg), deg.dtype)])
    order = np.argsort(-deg.astype(np.int64), kind="stable")
    c = np.arange(n_padded, dtype=np.int64) % (2 * ndev)
    d = np.where(c < ndev, c, 2 * ndev - 1 - c)
    return order[np.argsort(d, kind="stable")]


def permute_csr(indptr, indices, data, perm, inv_opp=None):
    """CSR rows reordered by ``perm`` (new row p = old row perm[p]), col ids
    renumbered through ``inv_opp`` (the opposite side's old id -> new
    position) when given.  Returns (indptr, indices, data)."""
    from .. import _native

    d = np.diff(indptr)[perm]
    new_ip = np.zeros(len(perm) + 1, dtype=np.int64)
    np.cumsum(d, out=new_ip[1:])
    if _native.available():
        vals, _, cols = _native.gather_rows(indptr, indices, data, perm)
    else:
        total = int(new_ip[-1])
        src = (np.repeat(indptr[perm], d)
               + (np.arange(total, dtype=np.int64) - np.repeat(new_ip[:-1], d)))
        cols, vals = indices[src], data[src]
    if inv_opp is not None:
        cols = inv_opp[cols].astype(np.int32)
    return new_ip, cols, vals


class ShardedEll(NamedTuple):
    """Every rank's ELL layout on one common bucket frame, stacked on a
    leading rank axis (JAX's ``ShardedEll``).

    Bucket arrays: rows (W, m) [local row ids], cols (W, m, w) [opposite ids
    local to the bucket's sub-tile], vals (W, m, w); inv_perm (W, per);
    split_rows (W, n_split) padded with row 0; split_seg_pos (W, n_split,
    P) with ``total_segs`` for an unused position.  ``bucket_meta[j] =
    (offset, lo, hi)``: bucket j reads rows [lo, hi) of the opposite shard
    present at ring step ``offset``."""

    buckets: list
    inv_perm: np.ndarray
    split_rows: np.ndarray
    split_seg_pos: np.ndarray
    rows_per_dev: int
    bucket_meta: Tuple[Tuple[int, int, int], ...]
    per_opp: int


def build_sharded_ell(indptr, indices, data, n_rows_padded, ndev,
                      opp_plan: Tuple[int, int, int], max_width=8192,
                      dtype=np.float32) -> ShardedEll:
    """One ELL layout per rank over its contiguous row range (the port's
    ``build_ell`` with ``col_chunk_rows``), re-keyed by (ring offset,
    sub-tile, width) and stacked on the union of keys, each key's segment
    count padded to the largest over the ranks.  ``opp_plan = (n_opp_padded,
    n_sub, chunk)`` is the opposite side's plan."""
    assert n_rows_padded % ndev == 0
    per = n_rows_padded // ndev
    n_opp_padded, n_sub, chunk = opp_plan
    per_opp = n_sub * chunk
    assert n_opp_padded == per_opp * ndev

    layouts = []
    for d in range(ndev):
        lo, hi = d * per, (d + 1) * per
        lptr = (indptr[lo:hi + 1] - indptr[lo]).astype(np.int64)
        lind = indices[indptr[lo]:indptr[hi]]
        ldat = data[indptr[lo]:indptr[hi]]
        layouts.append(build_ell(lptr, lind, ldat, per, max_width=max_width, dtype=dtype,
                                 col_chunk_rows=chunk, n_cols=n_opp_padded))

    # a bucket's absolute chunk index maps to opposite shard e = ac // n_sub
    # and sub-tile c = ac % n_sub; shard e reaches rank d at step (d - e) % W
    def key_of(d, span, w):
        ac = span[0] // chunk
        e, c = ac // n_sub, ac % n_sub
        return ((d - e) % ndev, c, w)

    keys = sorted({key_of(d, lay.col_spans[j], b.cols.shape[1])
                   for d, lay in enumerate(layouts) for j, b in enumerate(lay.buckets)})
    m_of = {kk: 0 for kk in keys}
    for d, lay in enumerate(layouts):
        for j, b in enumerate(lay.buckets):
            kk = key_of(d, lay.col_spans[j], b.cols.shape[1])
            m_of[kk] = max(m_of[kk], b.rows.shape[0])

    buckets, meta, offsets, slot_of = [], [], {}, {}
    pos = 0
    for s, kk in enumerate(keys):
        o, c, w = kk
        m = m_of[kk]
        offsets[kk], slot_of[kk] = pos, s
        buckets.append(EllBucket(rows=np.zeros((ndev, m), dtype=np.int32),
                                 cols=np.zeros((ndev, m, w), dtype=np.int32),
                                 vals=np.zeros((ndev, m, w), dtype=dtype)))
        meta.append((o, c * chunk, (c + 1) * chunk))
        pos += m
    total_segs = pos

    inv_perm = np.zeros((ndev, per), dtype=np.int64)
    max_split = max((lay.split_seg_pos.shape[0] for lay in layouts), default=0)
    max_segs = max((lay.split_seg_pos.shape[1] for lay in layouts), default=1)
    split_rows = np.zeros((ndev, max(max_split, 1)), dtype=np.int64)
    split_seg_pos = np.full((ndev, max(max_split, 1), max_segs), total_segs, dtype=np.int64)

    for d, lay in enumerate(layouts):
        # this rank's segment positions (build_ell's order: its buckets
        # concatenated) -> positions in the common frame
        remap_chunks = []
        for j, b in enumerate(lay.buckets):
            kk = key_of(d, lay.col_spans[j], b.cols.shape[1])
            m_local = b.rows.shape[0]
            tgt = buckets[slot_of[kk]]
            tgt.rows[d, :m_local] = b.rows
            tgt.cols[d, :m_local] = b.cols
            tgt.vals[d, :m_local] = b.vals
            remap_chunks.append(offsets[kk] + np.arange(m_local, dtype=np.int64))
        remap = np.concatenate(remap_chunks) if remap_chunks else np.zeros(0, np.int64)
        inv_perm[d] = remap[lay.inv_perm]
        ns = lay.split_rows.shape[0]
        if ns:
            split_rows[d, :ns] = lay.split_rows
            sp = lay.split_seg_pos
            split_seg_pos[d, :ns, :sp.shape[1]] = np.where(sp >= 0, remap[np.clip(sp, 0, None)],
                                                           total_segs)
    return ShardedEll(buckets=buckets, inv_perm=inv_perm, split_rows=split_rows,
                      split_seg_pos=split_seg_pos, rows_per_dev=per,
                      bucket_meta=tuple(meta), per_opp=per_opp)


class TablePlan(NamedTuple):
    """Both sides' sharded layouts, plans ``(n_padded, per, n_sub, chunk)``
    and row permutations (slot p holds row ``perm[p]``; ids >= n are
    padding)."""

    se_u: ShardedEll
    se_i: ShardedEll
    plan_u: Tuple[int, int, int, int]
    plan_i: Tuple[int, int, int, int]
    perm_u: np.ndarray
    perm_i: np.ndarray


def prepare_table_sharded(indptr_u, ind_u, dat_u, indptr_i, ind_i, dat_i, n_users, n_items,
                          k, ndev, gather_itemsize, dtype=np.float32, balance=True,
                          **build_kw) -> TablePlan:
    """Plan and build both sides' sharded layouts (JAX
    ``prepare_table_sharded``; no environment variable: ``balance`` is an
    argument).  With ``balance`` and more than one rank, both sides' rows
    are spread by degree (:func:`plan_balanced_rows`) and each side's cols
    renumbered through the opposite permutation; else the permutations are
    the identity."""
    plan_u = plan_table_sharding(n_users, k, ndev, gather_itemsize)
    plan_i = plan_table_sharding(n_items, k, ndev, gather_itemsize)
    nU_p, nI_p = plan_u[0], plan_i[0]
    ip_u = np.concatenate([indptr_u, np.full(nU_p - n_users, indptr_u[-1])])
    ip_i = np.concatenate([indptr_i, np.full(nI_p - n_items, indptr_i[-1])])
    if balance and ndev > 1:
        perm_u = plan_balanced_rows(np.diff(ip_u), nU_p, ndev)
        perm_i = plan_balanced_rows(np.diff(ip_i), nI_p, ndev)
        inv_u = np.empty(nU_p, dtype=np.int64)
        inv_u[perm_u] = np.arange(nU_p)
        inv_i = np.empty(nI_p, dtype=np.int64)
        inv_i[perm_i] = np.arange(nI_p)
        ip_u, ind_u, dat_u = permute_csr(ip_u, ind_u, dat_u, perm_u, inv_i)
        ip_i, ind_i, dat_i = permute_csr(ip_i, ind_i, dat_i, perm_i, inv_u)
    else:
        perm_u = np.arange(nU_p, dtype=np.int64)
        perm_i = np.arange(nI_p, dtype=np.int64)
    se_u = build_sharded_ell(ip_u, ind_u, dat_u, nU_p, ndev,
                             opp_plan=(plan_i[0], plan_i[2], plan_i[3]), dtype=dtype, **build_kw)
    se_i = build_sharded_ell(ip_i, ind_i, dat_i, nI_p, ndev,
                             opp_plan=(plan_u[0], plan_u[2], plan_u[3]), dtype=dtype, **build_kw)
    return TablePlan(se_u, se_i, plan_u, plan_i, perm_u, perm_i)


def pad_state(state: VariationalState, n_users_padded, n_items_padded) -> VariationalState:
    """Grow the tables to the padded row counts with inert rows: shapes 1,
    rates +inf, scalers 0 (the invariant the module docstring describes).
    A padded state's rows are never read as factors: a fit reads back the
    real rows only."""

    def pad_rows(a, n, fill):
        if a.shape[0] == n:
            return a
        return torch.cat([a, a.new_full((n - a.shape[0], a.shape[1]), fill)])

    return VariationalState(
        G_shp=pad_rows(state.G_shp, n_users_padded, 1.0),
        G_rte=pad_rows(state.G_rte, n_users_padded, float("inf")),
        L_shp=pad_rows(state.L_shp, n_items_padded, 1.0),
        L_rte=pad_rows(state.L_rte, n_items_padded, float("inf")),
        k_rte=pad_rows(state.k_rte, n_users_padded, 0.0),
        t_rte=pad_rows(state.t_rte, n_items_padded, 0.0))


def permute_state(state: VariationalState, perm_u, perm_i) -> VariationalState:
    """A padded state's rows in the balanced layout (new row p = old row
    perm[p])."""
    dev = state.G_shp.device
    pu, pi = torch.as_tensor(perm_u, device=dev), torch.as_tensor(perm_i, device=dev)
    return VariationalState(G_shp=state.G_shp[pu], G_rte=state.G_rte[pu],
                            L_shp=state.L_shp[pi], L_rte=state.L_rte[pi],
                            k_rte=state.k_rte[pu], t_rte=state.t_rte[pi])


# ---- a rank's share on its device -------------------------------------------------

@dataclass
class RankEll:
    """Rank ``rank``'s share of one side's ``ShardedEll`` on its device.

    ``ell`` holds the rank's slice of every bucket (``col_off`` = the first
    row of the bucket's sub-tile, ``start`` its place in the segment
    order), its ``inv_perm`` and its split rows in K2's convention (-1 for
    an unused position, a per-row ``split_indptr``; JAX's padding entries
    dropped); ``by_offset[o]`` the buckets read at ring step ``o``;
    ``n_real`` the rank's real rows, which come before its padding rows."""

    ell: DeviceEll
    by_offset: Tuple[Tuple[int, ...], ...]
    per_opp: int
    n_real: int


def rank_share(se: ShardedEll, rank: int, device, row_ids: Optional[np.ndarray] = None,
               n_rows_real: Optional[int] = None) -> RankEll:
    """Upload rank ``rank``'s share of ``se`` (from pinned memory for a CUDA
    device).  ``row_ids`` (n_padded,) is the row each slot holds (the
    side's permutation) and ``n_rows_real`` the side's real row count:
    raises unless the rank's padding rows (ids >= ``n_rows_real``) are the
    tail of its rows, as K3's pad-row form takes them.  Without them every
    row is real."""
    device = torch.device(device)
    world, per = se.inv_perm.shape[0], se.rows_per_dev
    if not 0 <= rank < world:
        raise ValueError("rank %d of a layout of %d ranks" % (rank, world))
    n_real = per
    if row_ids is not None:
        real = np.asarray(row_ids[rank * per:(rank + 1) * per]) < n_rows_real
        n_real = int(real.sum())
        if not real[:n_real].all():
            raise AssertionError("rank %d: padding rows are not the tail of its rows" % rank)
    buckets, by_offset, start = [], [[] for _ in range(world)], 0
    for j, (b, (o, lo, _)) in enumerate(zip(se.buckets, se.bucket_meta)):
        buckets.append(DeviceBucket(rows=_upload(b.rows[rank], np.int32, device),
                                    cols=_upload(b.cols[rank], np.int32, device),
                                    vals=_upload(b.vals[rank], b.vals.dtype, device),
                                    col_off=int(lo), start=start))
        by_offset[o].append(j)
        start += int(b.rows.shape[1])
    if max(start, per) > _INT32_MAX:
        raise ValueError("layout too large for int32 indexing: %d segments" % start)
    sp, sr = se.split_seg_pos[rank], se.split_rows[rank]
    used = (sp != start).any(axis=1)
    sp, sr = np.where(sp[used] == start, -1, sp[used]), sr[used]
    split_indptr = np.zeros(per + 1, dtype=np.int64)
    np.cumsum(np.bincount(sr, minlength=per), out=split_indptr[1:])
    ell = DeviceEll(buckets=buckets, inv_perm=_upload(se.inv_perm[rank], np.int32, device),
                    split_seg_pos=_upload(sp, np.int32, device),
                    split_indptr=_upload(split_indptr, np.int32, device),
                    n_rows=per, n_segs=start)
    return RankEll(ell=ell, by_offset=tuple(tuple(j) for j in by_offset), per_opp=se.per_opp,
                   n_real=n_real)


# ---- the ring ------------------------------------------------------------------------

def _peer(mesh: Mesh, group_rank: int) -> int:
    import torch.distributed as dist

    return group_rank if mesh.group is None else dist.get_global_rank(mesh.group, group_rank)


def ring(mesh: Mesh, first: torch.Tensor):
    """The shards a rank holds at ring steps 0 .. W-1, starting with its own
    ``first``: each step sends the present shard to rank + 1 and receives
    the next from rank - 1.  A generator: the transfer for step o + 1 is
    under way while the caller works on the shard of step o.

    NCCL: ``batch_isend_irecv`` into one of two spare buffers.  gloo: the
    same with ``isend`` / ``irecv``; for CUDA tensors each step is staged
    through pinned host buffers (gloo has no CUDA send/recv)."""
    import torch.distributed as dist

    world = mesh.world_size
    nxt, prv = _peer(mesh, (mesh.rank + 1) % world), _peer(mesh, (mesh.rank - 1) % world)
    nccl = mesh.backend == "nccl"
    staged = not nccl and first.is_cuda
    spare = [torch.empty_like(first) for _ in range(min(2, world - 1))]
    if staged:
        h_send, h_recv = (torch.empty(first.shape, dtype=first.dtype, pin_memory=True)
                          for _ in range(2))
    buf = first
    for o in range(world - 1):
        recv = spare[o % 2]
        if nccl:
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, nxt, mesh.group),
                                           dist.P2POp(dist.irecv, recv, prv, mesh.group)])
        else:
            if staged:
                h_send.copy_(buf)
            reqs = [dist.isend(h_send if staged else buf, nxt, group=mesh.group, tag=o),
                    dist.irecv(h_recv if staged else recv, prv, group=mesh.group, tag=o)]
        yield buf
        for r in reqs:
            r.wait()
        if staged:
            recv.copy_(h_recv)
        buf = recv
    yield buf


def ring_table_sums(mesh: Optional[Mesh], t_self, t_other, share: RankEll, out_dtype=None,
                    shards=None):
    """K13a: the phi sums (per, k) of the rank's rows, with ``t_other``
    (the rank's shard of the opposite exp table) travelling around the ring.
    At step o, K1 runs over the offset-o buckets against the shard present
    (``col_off`` = the sub-tile's first row); then K2 reassembles the rank's
    segments, written in ``out_dtype`` (None: K1's accumulation dtype).
    ``shards`` (the opposite shards of steps 0 .. W-1) stands in for the
    ring where the caller holds every rank's shard, as a test does."""
    seg = torch.empty((share.ell.n_segs, t_self.shape[1]), dtype=_acc_dtype(t_self.dtype),
                      device=t_self.device)
    steps = shards if shards is not None else ring(mesh, t_other)
    for o, buf in enumerate(steps):
        if buf.shape[0] != share.per_opp:
            raise ValueError("ring step %d: a shard of %d rows, the layout reads %d"
                             % (o, buf.shape[0], share.per_opp))
        for j in share.by_offset[o]:
            b = share.ell.buckets[j]
            bucket_phi_sums(t_self, buf, b.rows, b.cols, b.vals, b.col_off,
                            seg[b.start:b.start + b.rows.shape[0]])
    ring_table_sums.launches += 1
    return segment_table_sums(seg, share.ell, out_dtype)


ring_table_sums.launches = 0


def cross_rank_colsum(mesh: Mesh, colsum):
    """The (1, k) colsum over every rank's rows: the ranks' colsums
    gathered in rank order and added by K3's finishing pass, the same bits
    on every rank."""
    cross_rank_colsum.launches += 1
    return colsum_finish(all_gather_rows(mesh, colsum))


cross_rank_colsum.launches = 0


def table_sharded_step(mesh: Mesh, carry: Carry, u: RankEll, i: RankEll, hp,
                       gather_dtype=None) -> Carry:
    """K13b: one CAVI iteration on the rank's rows (JAX
    ``make_table_sharded_step``): K13a for each side against the carried
    tables, K3's pad-row form for users, the cross-rank colsum(Theta), K3's
    pad-row form for items, the cross-rank colsum(Beta)."""
    dt = carry.state.G_shp.dtype
    su = ring_table_sums(mesh, carry.t_tab, carry.b_tab, u, dt)
    si = ring_table_sums(mesh, carry.b_tab, carry.t_tab, i, dt)
    table_sharded_step.launches += 1
    return cavi_step_carried(carry, su, si, hp, gather_dtype,
                             colsum=partial(cross_rank_colsum, mesh),
                             n_real=(u.n_real, i.n_real))


table_sharded_step.launches = 0


def table_sharded_llk_parts(mesh: Optional[Mesh], Theta, Beta, u: RankEll, full_llk: bool,
                            shards=None):
    """K13c: the (n, 3) float64 llk partials of the rank's users' nonzeros,
    K4 per ring offset against the Beta shard present (``shards`` as in
    :func:`ring_table_sums`).  Padding slots and rows count nothing."""
    parts = []
    for o, buf in enumerate(shards if shards is not None else ring(mesh, Beta)):
        for j in u.by_offset[o]:
            b = u.ell.buckets[j]
            parts.append(bucket_llk_parts(Theta, buf, b.rows, b.cols, b.vals, b.col_off,
                                          full_llk))
    table_sharded_llk_parts.launches += 1
    return torch.cat(parts)


table_sharded_llk_parts.launches = 0


# ---- a fit's engine --------------------------------------------------------------------

class TableSharded:
    """One rank's table-sharded engine in a fit: its shares of both
    layouts on ``device``, and the maps between a fit's real tables and
    the rank's padded, permuted rows.  It keeps nothing of ``plan`` but
    the row counts and permutations."""

    def __init__(self, mesh: Mesh, plan: TablePlan, n_users: int, n_items: int, device):
        self.mesh = mesh
        self.rows = (plan.plan_u[:2], plan.plan_i[:2])  # (n_padded, per) of each side
        self.perms = (plan.perm_u, plan.perm_i)
        self.u = rank_share(plan.se_u, mesh.rank, device, plan.perm_u, n_users)
        self.i = rank_share(plan.se_i, mesh.rank, device, plan.perm_i, n_items)
        # slot of real row r in the padded, permuted order of all ranks, on
        # the host and on the device
        self.slots = tuple(torch.from_numpy(np.argsort(p, kind="stable")[:n])
                           for p, n in ((plan.perm_u, n_users), (plan.perm_i, n_items)))
        self.slots_dev = tuple(s.to(device) for s in self.slots)

    def shard_state(self, state: VariationalState) -> VariationalState:
        """The rank's rows of a real state (host tensors), padded and
        permuted, on the device."""
        (nU_p, per_u), (nI_p, per_i) = self.rows
        full = permute_state(pad_state(state, nU_p, nI_p), *self.perms)
        r = self.mesh.rank
        cut_u, cut_i = slice(r * per_u, (r + 1) * per_u), slice(r * per_i, (r + 1) * per_i)
        dev = self.slots_dev[0].device
        return VariationalState(*[a[cut_u if j in (0, 1, 4) else cut_i].contiguous().to(dev)
                                  for j, a in enumerate(full)])

    def carry_init(self, state: VariationalState, gather_dtype=None) -> Carry:
        """The carry of the rank's rows (K3 derive) with both colsums over
        every rank (JAX ``carry_init``)."""
        c = _carry_init(state, gather_dtype)
        return c._replace(theta_colsum=cross_rank_colsum(self.mesh, c.theta_colsum),
                          beta_colsum=cross_rank_colsum(self.mesh, c.beta_colsum))

    def run(self, carry: Carry, niter: int, hp, gather_dtype=None) -> Carry:
        for _ in range(int(niter)):
            carry = table_sharded_step(self.mesh, carry, self.u, self.i, hp, gather_dtype)
        return carry

    def gather_rows(self, x, users: bool, host: bool = False):
        """The real rows of a table sharded over the ranks (the rank's rows
        ``x``), every rank's gathered, in their original order: on ``x``'s
        device, or with ``host`` on the host, where the gathered table is
        copied before its rows are picked (the device holds one gathered
        table, not two)."""
        full = all_gather_rows(self.mesh, x)
        side = 0 if users else 1
        return full.cpu()[self.slots[side]] if host else full[self.slots_dev[side]]

    def real_state(self, state: VariationalState) -> VariationalState:
        """The whole real state on the host, gathered one array at a time
        (the device holds at most one gathered table at once)."""
        return VariationalState(*[self.gather_rows(a, j in (0, 1, 4), host=True)
                                  for j, a in enumerate(state)])
