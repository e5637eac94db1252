"""Data-parallel engine (K12): each rank's share of the nonzeros through
the port's kernels, then one ``torch.distributed`` collective.

Port of ``hpfrec_tpu/parallel/engine.py``, whose four ``shard_map``
bodies become a local half (the one-device kernel on the rank's shard,
which a test can call for every rank in one process) and an exchange:

- **K12a** :func:`sharded_ell_phi_sums` (JAX ``engine.py:65``): K1 on the
  rank's slice of every ELL bucket into one local buffer, one
  ``all_gather`` of the buffers per side and iteration (JAX gathers once
  per bucket), K2's reassembly on every rank.  The exchange copies sums
  and never adds them, so the E-step equals the one-device port's bit for
  bit.
- **K12b** :func:`sharded_svi_phi_sums` (JAX ``engine.py:120``): K7 on
  the rank's share of a mini-batch's rows (cut at row boundaries by
  ``utils.data.share`` in ``ops/svi.py``), ``all_reduce`` (sum) of both
  sides' sums and (max) of the touched-row mask; K9, K3 and K8 stay
  replicated.  ``partial_fit`` runs the same exchange.
- **K12c** :func:`sharded_coo_phi_sums` (JAX ``engine.py:143``): K7c on
  the rank's share of the user-sorted stream (cut at user boundaries by
  ``utils.data.share`` in ``ops.cavi.coo_stream(..., shard=...)``),
  ``all_reduce`` (sum) of the user and item sums.  User sums are disjoint across ranks, so they stay
  exact; item sums change order only.
- **K12d** :func:`gather_partials` (JAX ``engine.py:166``): the float64
  per-block partials of K4 (train llk over the rank's ELL slices) or K5
  (a validation set or COO stream split over the ranks) gathered from
  every rank; the host adds them in one fixed order, the same on every
  rank.

The fit (``models/hpf.py``) passes these functions, bound to its mesh,
to the loops of ``ops/`` in place of the one-device kernels; ``ops``
never imports this package.  Tables are replicated: every rank computes
the same replicated values from the same inputs with the same kernels,
so all ranks hold the same fitted state bit for bit.  NCCL and gloo both run these collectives; gloo
has no ``all_gather_into_tensor``, so on gloo the list form is used.  Each
K12 function counts the exchanges it issues in ``.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cavi import coo_phi_sums
from ..ops.ell import all_bucket_sums, segment_table_sums
from ..ops.svi import batch_phi_sums
from .mesh import Mesh


def _dist():
    import torch.distributed as dist

    return dist


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on every rank) stacked along the
    first axis in rank order: ``(world_size * x.shape[0], ...)``."""
    dist = _dist()
    x = x.contiguous()
    if mesh.backend == "gloo":
        parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)
    out = x.new_empty((mesh.world_size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


def all_reduce_sum(mesh: Mesh, *tensors):
    """In-place sum of each tensor over the ranks."""
    dist = _dist()
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)


def barrier(mesh: Mesh):
    dist = _dist()
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def agreed_seed(mesh: Mesh, seed):
    """A seed every rank shares: ``seed`` when it is a positive int (the
    packages' rule for a fixed seed), else one drawn at random on rank 0
    and broadcast, so that ranks never draw different inits or
    shuffles."""
    if seed is not None and seed > 0:
        return int(seed)
    dist = _dist()
    t = torch.tensor([int(np.random.SeedSequence().generate_state(1, np.uint32)[0]) + 1
                      if mesh.rank == 0 else 0], dtype=torch.int64, device=mesh.device)
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    dist.broadcast(t, src=src, group=mesh.group)
    return int(t.item())


# ---- K12a: ELL phi sums -----------------------------------------------------

def sharded_ell_phi_sums(mesh: Mesh, t_self, t_other, layout, out_dtype=None):
    """K12a: per-table-row phi sums (n_rows, k) from the rank's shard of an
    ELL layout (``ops.ell.to_device(..., shard=(rank, world_size))``): K1
    over the rank's slices (``ops.ell.all_bucket_sums``, the local half),
    one all_gather of every rank's segment sums, K2 on every rank."""
    if layout.n_shards != mesh.world_size:
        raise ValueError("a layout of %d shards on a mesh of %d ranks"
                         % (layout.n_shards, mesh.world_size))
    seg = all_gather_rows(mesh, all_bucket_sums(t_self, t_other, layout))
    sharded_ell_phi_sums.launches += 1
    return segment_table_sums(seg, layout, out_dtype)


sharded_ell_phi_sums.launches = 0


# ---- K12b: SVI mini-batch phi sums ------------------------------------------

def sharded_svi_phi_sums(mesh: Mesh, t_loc, t_oth, y, rows, cols, bounds, base: int,
                         seg_rows):
    """K12b: ``ops.svi.batch_phi_sums`` (whose arguments these are) of this
    rank's share of a batch's rows, which the caller cut
    (``ops.svi.svi_run_epoch`` / ``svi_batch_update`` with ``shard``),
    summed over the ranks (the mask by a max).  Returns ``(s_loc, s_oth,
    omask)`` of the whole batch on every rank."""
    s_loc, s_oth, omask = batch_phi_sums(t_loc, t_oth, y, rows, cols, bounds, base, seg_rows)
    reduce_batch_sums(mesh, s_loc, s_oth, omask)
    sharded_svi_phi_sums.launches += 1
    return s_loc, s_oth, omask


def reduce_batch_sums(mesh: Mesh, s_loc, s_oth, omask):
    """K12b's exchange, in place: both sides' sums added over the ranks,
    the touched-row mask (bool) or-ed."""
    dist = _dist()
    all_reduce_sum(mesh, s_loc, s_oth)
    dist.all_reduce(omask.view(torch.uint8), op=dist.ReduceOp.MAX, group=mesh.group)


sharded_svi_phi_sums.launches = 0


# ---- K12c: COO phi sums -----------------------------------------------------

def sharded_coo_phi_sums(mesh: Mesh, t_tab, b_tab, coo):
    """K12c: ``(su, si)`` of the whole training stream from the rank's
    share ``coo`` (``ops.cavi.coo_stream(..., shard=(rank,
    world_size))``): K7c on the share (``ops.cavi.coo_phi_sums``, the
    local half), then a sum over the ranks."""
    su, si = coo_phi_sums(t_tab, b_tab, coo)
    all_reduce_sum(mesh, su, si)
    sharded_coo_phi_sums.launches += 1
    return su, si


sharded_coo_phi_sums.launches = 0


# ---- K12d: metric partials --------------------------------------------------

def gather_partials(mesh: Mesh, parts: torch.Tensor) -> torch.Tensor:
    """K12d: the (n_r, 3) float64 llk partials of every rank, rank after
    rank, on every rank (the ranks' counts may differ: a COO share's
    blocks).  Added on the host in this order, they give every rank the
    same llk."""
    n = torch.tensor([parts.shape[0]], dtype=torch.int64, device=parts.device)
    sizes = all_gather_rows(mesh, n).cpu().tolist()
    p_max = max(sizes)
    padded = parts.new_zeros((p_max,) + tuple(parts.shape[1:]))
    padded[:parts.shape[0]] = parts
    out = all_gather_rows(mesh, padded)
    gather_partials.launches += 1
    return torch.cat([out[r * p_max:r * p_max + m] for r, m in enumerate(sizes)])


gather_partials.launches = 0
