"""Bucketed-ELL E-step: host packing, device upload, and the CAVI loop.

Port of ``hpfrec_tpu/ops/ell.py``.  The host half (``build_ell`` and its
helpers) is a copy that packs bit-identical layouts: rows of one side
grouped by degree into buckets of width w, split into segments of at most
``max_width`` slots, reassembled into table order by an inverse
permutation plus a patch for split rows.  See the JAX module's docstring
for the design.  The quarter-octave width ladder and the 2^17-slot bucket
merge are fixed constants here.

The device half runs two hand-written CUDA kernels:

- **K1** ``all_bucket_sums`` (``csrc/ell_phi_sums.cu``): per segment,
  ``sum_j vals[r,j] * t_self[rows[r]] * t_other[off+cols[r,j]] /
  <t_self[rows[r]], t_other[off+cols[r,j]]>``, every bucket of a side in
  one launch from a device table of the buckets (``_bucket_table``, built
  once per layout), or every bucket of a view of a layout (the
  table-sharded ring's, one a ring offset) into the layout's sums;
  ``bucket_phi_sums`` launches one bucket (the same walk and bits).
- **K2** ``segment_table_sums`` (``csrc/segment_sums.cu``): segment sums
  to table order, split rows added in a fixed order (no atomics).

Every fit packs its layouts on its device: ``plan_ell`` (shared with
``build_ell``) plans a side on the host from its row pointers, and **K15**
``ell_fill`` (``csrc/ell_fill.cu``, through ``pack_ell``) fills every
bucket, or on a mesh the rank's slice of every bucket, from the side's
CSR (``ops/ingest.py``) into one slab of cols and one of vals that
``device_ell``'s buckets view.  ``build_ell`` and ``to_device`` pack and
upload on the host: the table-sharded engine's tiles and the tests'
references.

Each wrapper takes its plain PyTorch version for CPU tensors, launches the
kernel for CUDA tensors, and counts its launches in ``.launches`` (K1's
bfloat16-table forms in ``.launches_bf16``).

bfloat16 gather tables (``gather_dtype='bfloat16'``): K3 stores the exp
tables in bfloat16, K1 widens each gathered row to float32 and sums in
float32, K2 reassembles in float32, and the sums reach the state dtype
after the reassembly (JAX ``ell.py:466-476, 519-524, 723-727``).  The
port's ``'auto'`` keeps the state dtype (``gather_table_dtype``).

The TPU scheduling devices of the JAX module (op chunking, barrier chains,
interleaving, mini-rows) are not ported, and the fit builds untiled
layouts; the kernels take each bucket's column base offset, so a tiled
layout (``col_chunk_rows``) runs too.
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cavi import Carry, cavi_step_carried

# Quarter-octave width ladder: pow2 x {1, 7/8, 3/4, 5/8}.
_LADDER_FRACS = (1.0, 7 / 8, 0.75, 5 / 8)
_LADDER = np.array(sorted({int(np.ceil((1 << e) * f))
                           for e in range(0, 15) for f in _LADDER_FRACS}),
                   dtype=np.int64)
# Buckets under this many slots merge into the next rung (when that rung is
# at most 1.5x wider).
MERGE_SLOTS = 1 << 17
# Narrowest bucket width.
MIN_WIDTH = 8
# Split-row patch width: positions of a split row's extra segments are
# stored in chunks of P (padding -1).
_SPLIT_P = 4

# The JAX package's column-tiling plan (its TPU gather-window thresholds).
# No fit of the port uses them (a one-device fit builds untiled layouts, a
# table-sharded fit takes parallel.table_sharded.CARD_WINDOW_BYTES); they
# are kept to reproduce the JAX package's tiled layouts and its
# table-sharded plans (their default window) for parity checks.
_FAST_GATHER_BYTES = 40 * 1024 * 1024
_TILE_THRESHOLD_BYTES = 48 * 1024 * 1024


class EllBucket(NamedTuple):
    rows: np.ndarray  # (m,) int32 — table row id of each packed segment
    cols: np.ndarray  # (m, w) int32 — opposite ids (chunk-LOCAL when tiled)
    vals: np.ndarray  # (m, w) real


@dataclass
class EllLayout:
    """Host bucketed layout for one side (users or items)."""

    buckets: List[EllBucket]
    # position (in segment order = concat of bucket rows) of each row's
    # first segment
    inv_perm: np.ndarray  # (n_rows,) int64
    split_rows: np.ndarray  # (n_split,) int64 — rows with >1 segment,
    # repeated once per chunk of P extra positions, ascending
    split_seg_pos: np.ndarray  # (n_split, P) int64 — extra segment
    # positions (-1 = none)
    n_rows: int
    # per-bucket (start, end) row span of the opposite table that the
    # bucket's cols index into; None when the layout is untiled
    col_spans: Optional[Tuple[Optional[Tuple[int, int]], ...]] = None


def plan_col_tiling(n_opposite_rows: int, k: int, gather_itemsize: int = 4
                    ) -> Optional[int]:
    """Chunk row count of the JAX package's column tiling, or None when the
    opposite table is under its threshold."""
    if n_opposite_rows * k * gather_itemsize <= _TILE_THRESHOLD_BYTES:
        return None
    return max(1, _FAST_GATHER_BYTES // (k * gather_itemsize))


def _ragged_fill(seg_start, seg_len, indices, data, cols, vals, dtype):
    """Fill pre-zeroed (m, w) cols/vals from CSR runs (native or numpy)."""
    from .. import _native

    if _native.available():
        _native.ell_fill(seg_start, seg_len, indices,
                         data.astype(dtype, copy=False), cols, vals)
        return
    m = len(seg_start)
    flat_rows = np.repeat(np.arange(m, dtype=np.int64), seg_len)
    total = int(seg_len.sum())
    flat_cols = (np.arange(total, dtype=np.int64)
                 - np.repeat(np.cumsum(seg_len) - seg_len, seg_len))
    src = np.repeat(seg_start, seg_len) + flat_cols
    cols[flat_rows, flat_cols] = indices[src]
    vals[flat_rows, flat_cols] = data[src]


def _sort_rows(indptr, indices, data, row_of, n_cols, nnz):
    """Sort cols within each CSR row (copies; callers keep their order)."""
    from .. import _native

    if (nnz and indices.dtype == np.int32
            and data.dtype in (np.float32, np.float64)):
        if _native.available():
            indices = np.ascontiguousarray(indices).copy()
            data = np.ascontiguousarray(data).copy()
            _native.sort_csr_cols(indptr, indices, data)
            return indices, data
        warnings.warn("native sort_csr_cols unavailable (%s); falling back "
                      "to the slower numpy per-row sort for ELL packing"
                      % (_native.load_error(),))
    if nnz:
        key_rc = row_of * np.int64(n_cols) + indices.astype(np.int64)
        if np.any(np.diff(key_rc) < 0):
            order = np.argsort(key_rc, kind="stable")
            indices, data = indices[order], data[order]
    return indices, data


class EllPlan(NamedTuple):
    """Where every segment of a side's layout comes from and goes: the
    O(rows) half of ``build_ell``, which ``plan_ell`` makes from the side's
    row degrees (or column-tiled runs).  The segments are listed bucket
    after bucket, in each bucket in its row order; ``first`` bounds each
    bucket's real segments in those lists, and a bucket holds ``m_pads[b]
    - (first[b + 1] - first[b])`` inert padding segments after them."""

    widths: np.ndarray  # (nb,) int64, a bucket's width w
    m_pads: np.ndarray  # (nb,) int64, a bucket's segments with its padding
    first: np.ndarray  # (nb + 1,) int64, the buckets' bounds in seg_*
    col_offs: np.ndarray  # (nb,) int64, first opposite row a bucket's cols index
    seg_row: np.ndarray  # (n_real,) int64, a segment's table row
    seg_start: np.ndarray  # (n_real,) int64, its first CSR position
    seg_len: np.ndarray  # (n_real,) int64, its entries (at most its width)
    inv_perm: np.ndarray
    split_rows: np.ndarray
    split_seg_pos: np.ndarray
    n_rows: int
    col_spans: Optional[Tuple[Optional[Tuple[int, int]], ...]]


def untiled_runs(indptr: np.ndarray):
    """The runs of an untiled side, one a row: ``plan_ell``'s first four
    arguments from the CSR row pointers alone."""
    n_rows = int(indptr.shape[0]) - 1
    return (indptr[:-1].astype(np.int64), np.diff(indptr).astype(np.int64),
            np.arange(n_rows, dtype=np.int64), np.zeros(n_rows, dtype=np.int64))


@functools.lru_cache(maxsize=8)
def _widths_of(max_width: int) -> np.ndarray:
    """(max_width + 1,) int64: the bucket width of a segment of n entries
    (0 taken as 1), the ladder rung at or above n within [MIN_WIDTH,
    max_width]; read by index in place of a search a segment."""
    n = np.arange(max_width + 1, dtype=np.int64)
    width = _LADDER[np.searchsorted(_LADDER, np.maximum(n, 1))]
    return np.minimum(np.maximum(width, MIN_WIDTH), max_width)


def _merge_rungs(width: np.ndarray, max_width: int) -> np.ndarray:
    """Small buckets merged into the next rung (per hop, gated at 1.5x;
    merges may cascade: a rung's count holds what merged into it), for the
    widths of one column chunk."""
    counts = np.bincount(width, minlength=max_width + 1)
    ws = np.flatnonzero(counts)
    counts = counts[ws]
    to = np.arange(len(ws))  # the rung each width is on now
    for j in range(len(ws) - 1):
        if counts[j] * ws[j] < MERGE_SLOTS and 2 * ws[j + 1] <= 3 * ws[j]:
            counts[j + 1] += counts[j]
            to[to == j] = j + 1
    if np.array_equal(to, np.arange(len(ws))):
        return width
    lut = np.zeros(max_width + 1, dtype=np.int64)
    lut[ws] = ws[to]
    return lut[width]


def plan_ell(run_start, run_len, run_row, run_chunk, n_rows: int, max_width: int = 8192,
             pad_shards: int = 1, col_chunk_rows: Optional[int] = None,
             n_cols: Optional[int] = None) -> EllPlan:
    """The layout of a side from its runs (``untiled_runs``, or a tiled
    side's (row, column chunk) runs), without its cols and vals: runs split
    into segments of at most ``max_width``, widths on the ladder and small
    buckets merged, the buckets' sizes, ``inv_perm`` and the split-row
    patch.  ``build_ell`` fills its buckets on the host from it, and every
    fit on its device (``pack_ell``, K15), so the two cannot pack
    different layouts.  On an untiled side every O(segments) step is
    a pass or an index (the bucket order a radix sort of small keys), none
    a comparison sort."""
    # split runs longer than max_width into bounded segments
    nseg_per_run = np.maximum(1, -(-run_len // max_width))
    if len(run_len) and int(nseg_per_run.max()) > 1:
        rep = np.repeat(np.arange(len(run_row), dtype=np.int64), nseg_per_run)
        first_of_run = np.zeros(len(run_row) + 1, dtype=np.int64)
        np.cumsum(nseg_per_run, out=first_of_run[1:])
        idx_in_run = np.arange(len(rep), dtype=np.int64) - first_of_run[rep]
        seg_row = run_row[rep]
        seg_chunk = run_chunk[rep]
        seg_start = run_start[rep] + idx_in_run * max_width
        seg_len = np.minimum(run_len[rep] - idx_in_run * max_width, max_width)
    else:  # every run one segment
        seg_row, seg_chunk, seg_start, seg_len = run_row, run_chunk, run_start, run_len

    # per-row segment counts/offsets (segments are row-contiguous)
    nseg_per_row = np.bincount(seg_row, minlength=n_rows).astype(np.int64)
    first_seg = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(nseg_per_row, out=first_seg[1:])

    # bucket by (chunk, width >= MIN_WIDTH) on the width ladder, then merge
    # small buckets into the next rung
    width = _widths_of(max_width)[seg_len]
    tiled = col_chunk_rows is not None
    if tiled:
        for c in np.unique(seg_chunk):
            in_c = np.flatnonzero(seg_chunk == c)
            width[in_c] = _merge_rungs(width[in_c], max_width)
        bucket_key = seg_chunk * (2 * max_width) + width
        keys, at, ms = np.unique(bucket_key, return_inverse=True, return_counts=True)
        at = at.reshape(-1)
        chunks = keys // (2 * max_width)
        widths = keys % (2 * max_width)
        col_offs = chunks * col_chunk_rows
        spans = tuple((int(o), min(int(o) + col_chunk_rows, int(n_cols))) for o in col_offs)
    else:
        width = _merge_rungs(width, max_width)
        ms = np.bincount(width, minlength=max_width + 1)
        widths = np.flatnonzero(ms)
        ms = ms[widths]
        lut = np.zeros(max_width + 1, dtype=np.int64)
        lut[widths] = np.arange(len(widths))
        at = lut[width]
        col_offs = np.zeros(len(widths), dtype=np.int64)
        spans = None
    # bucket after bucket, rows ascending in each
    order = np.argsort(at.astype(np.int16) if len(ms) < 2 ** 15 else at, kind="stable")
    ms = ms.astype(np.int64)
    m_pads = -(-ms // pad_shards) * pad_shards
    first = np.zeros(len(ms) + 1, dtype=np.int64)
    np.cumsum(ms, out=first[1:])
    starts = np.cumsum(m_pads) - m_pads  # a bucket's first position
    seg_positions = np.empty(len(seg_row), dtype=np.int64)
    seg_positions[order] = (np.repeat(starts - first[:-1], ms)
                            + np.arange(len(order), dtype=np.int64))

    inv_perm = seg_positions[first_seg[:-1]]

    # split rows: positions of the segments beyond the first, in chunks of
    # P positions per entry (a row with many segments repeats in
    # split_rows; the patch is additive)
    split = np.flatnonzero(nseg_per_row > 1)
    if len(split):
        P = _SPLIT_P
        counts = nseg_per_row[split] - 1
        nchunk = -(-counts // P)
        first_chunk = np.zeros(len(split) + 1, dtype=np.int64)
        np.cumsum(nchunk, out=first_chunk[1:])
        split_rows_out = np.repeat(split, nchunk)
        split_seg_pos = np.full((int(first_chunk[-1]), P), -1, dtype=np.int64)
        rep_r = np.repeat(np.arange(len(split), dtype=np.int64), counts)
        total = int(counts.sum())
        j = (np.arange(total, dtype=np.int64)
             - np.repeat(np.cumsum(counts) - counts, counts))
        src = np.repeat(first_seg[split] + 1, counts) + j
        split_seg_pos[first_chunk[rep_r] + j // P, j % P] = seg_positions[src]
        split = split_rows_out
    else:
        split_seg_pos = np.zeros((0, 1), dtype=np.int64)

    return EllPlan(widths=widths.astype(np.int64), m_pads=m_pads, first=first,
                   col_offs=col_offs.astype(np.int64), seg_row=seg_row[order],
                   seg_start=seg_start[order], seg_len=seg_len[order], inv_perm=inv_perm,
                   split_rows=split.astype(np.int64), split_seg_pos=split_seg_pos,
                   n_rows=n_rows, col_spans=spans)


def build_ell(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
              n_rows: int, max_width: int = 8192, dtype=np.float32,
              pad_shards: int = 1, col_chunk_rows: Optional[int] = None,
              n_cols: Optional[int] = None) -> EllLayout:
    """Pack a CSR side into degree buckets (host, O(nnz)); the same layout
    as ``hpfrec_tpu.ops.ell.build_ell`` for the same arguments (and its
    default ``min_width=8``).  ``pad_shards`` pads every bucket's segment
    count to a multiple of the number of ranks with inert segments (row 0,
    zero vals), so that each rank takes an equal slice of every bucket
    (``to_device(..., shard=...)``); segment positions count the padding.
    ``col_chunk_rows`` (with ``n_cols``) enables column tiling: each row's
    sorted cols are partitioned at chunk boundaries into per-(row, chunk)
    segments whose cols are stored chunk-local, and each bucket carries its
    span.  The layout is ``plan_ell``'s, filled here.  No fit packs here
    but the table-sharded engine's (``parallel.table_sharded``)."""
    deg = np.diff(indptr).astype(np.int64)
    nnz = int(indices.shape[0])

    if col_chunk_rows is not None:
        if n_cols is None:
            raise ValueError("col tiling needs n_cols")
        row_of = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
        indices, data = _sort_rows(indptr, indices, data, row_of, n_cols, nnz)
        chunk_of = indices.astype(np.int64) // col_chunk_rows
        key = row_of * ((n_cols // col_chunk_rows) + 1) + chunk_of
        boundaries = np.flatnonzero(np.diff(key) != 0) + 1
        run_start = np.concatenate([[0], boundaries]) if nnz else np.zeros(0, np.int64)
        run_len = np.diff(np.concatenate([run_start, [nnz]]))
        run_row = row_of[run_start] if nnz else np.zeros(0, np.int64)
        run_chunk = chunk_of[run_start] if nnz else np.zeros(0, np.int64)
        # rows with zero degree still need one (empty -> width-min) segment
        empty = np.flatnonzero(deg == 0)
        if len(empty):
            run_start = np.concatenate([run_start, indptr[empty]])
            run_len = np.concatenate([run_len, np.zeros(len(empty), np.int64)])
            run_row = np.concatenate([run_row, empty])
            run_chunk = np.concatenate([run_chunk, np.zeros(len(empty), np.int64)])
            order = np.argsort(run_row, kind="stable")
            run_start, run_len = run_start[order], run_len[order]
            run_row, run_chunk = run_row[order], run_chunk[order]
        runs = (run_start, run_len, run_row, run_chunk)
    else:
        runs = untiled_runs(indptr)
    plan = plan_ell(*runs, n_rows, max_width, pad_shards, col_chunk_rows, n_cols)

    buckets: List[EllBucket] = []
    for b, w in enumerate(plan.widths):
        s0, s1 = int(plan.first[b]), int(plan.first[b + 1])
        m, m_pad, off = s1 - s0, int(plan.m_pads[b]), int(plan.col_offs[b])
        cols = np.zeros((m_pad, int(w)), dtype=np.int32)
        vals = np.zeros((m_pad, int(w)), dtype=dtype)
        rows_arr = np.zeros(m_pad, dtype=np.int32)
        rows_arr[:m] = plan.seg_row[s0:s1]
        _ragged_fill(plan.seg_start[s0:s1], plan.seg_len[s0:s1], indices, data, cols[:m],
                     vals[:m], dtype)
        if off:
            # store chunk-local ids; padding slots (cols 0) stay in-bounds
            np.subtract(cols[:m], np.int32(off), out=cols[:m], where=vals[:m] != 0)
        buckets.append(EllBucket(rows=rows_arr, cols=cols, vals=vals))

    return EllLayout(buckets=buckets, inv_perm=plan.inv_perm, split_rows=plan.split_rows,
                     split_seg_pos=plan.split_seg_pos, n_rows=n_rows,
                     col_spans=plan.col_spans)


def layout_slots(layout) -> int:
    """Total slots of a layout's buckets: one E-step side visits exactly
    this many (row, col) slots."""
    return int(sum(int(np.prod(b.cols.shape)) for b in layout.buckets))


# ----------------------------------------------------------------------
# device half
# ----------------------------------------------------------------------

class DeviceBucket(NamedTuple):
    rows: torch.Tensor  # (m,) int32
    cols: torch.Tensor  # (m, w) int32, relative to col_off
    vals: torch.Tensor  # (m, w) state dtype
    col_off: int  # first row of the opposite table the cols index into
    start: int  # position of the bucket's first segment in segment order


@dataclass
class DeviceEll:
    """A layout on a device.  Index arrays are int32; ``split_indptr`` is a
    per-row CSR over the chunks of ``split_seg_pos`` (chunks of one row are
    contiguous), so that K2 adds each row's split chunks with no atomics.

    A rank's shard of a layout (``to_device(..., shard=(rank, n_shards))``)
    holds its slice of every bucket: K1 writes ``n_segs`` local segment
    sums, and K2's positions index the ``n_shards * n_segs`` sums that the
    exchange gathers from all ranks, rank after rank."""

    buckets: List[DeviceBucket]
    inv_perm: torch.Tensor  # (n_rows,) int32
    split_seg_pos: torch.Tensor  # (n_split, P) int32, -1 = none
    split_indptr: torch.Tensor  # (n_rows + 1,) int32
    n_rows: int
    n_segs: int  # segments over all buckets (of this rank's slices)
    n_shards: int = 1
    # K1's device table of the buckets, built at the first launch
    # (``_bucket_table``): (key, table, blocks)
    k1_table: Optional[tuple] = field(default=None, repr=False, compare=False)


_INT32_MAX = 2 ** 31 - 1


def _upload(a: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _gathered_positions(ms, n_shards: int) -> np.ndarray:
    """Where each segment of the layout (buckets of ``ms`` segments, each a
    multiple of ``n_shards``) lands in the gathered sums: rank r's slice of
    every bucket, in bucket order, then rank r + 1's."""
    per = np.asarray(ms, dtype=np.int64) // n_shards
    local_start = np.concatenate([[0], np.cumsum(per)[:-1]])
    pos = [r * int(per.sum()) + s + np.arange(p, dtype=np.int64)
           for s, p in zip(local_start, per) for r in range(n_shards)]
    return np.concatenate(pos) if pos else np.zeros(0, np.int64)


def _shard_positions(ms, n_shards: int, inv_perm, split_seg_pos):
    """``inv_perm`` and ``split_seg_pos`` of a layout whose buckets hold
    ``ms`` segments, remapped to the rank-major order of the sums gathered
    from ``n_shards`` ranks (as they are for one)."""
    if n_shards == 1:
        return inv_perm, split_seg_pos
    where = _gathered_positions(ms, n_shards)
    return where[inv_perm], np.where(split_seg_pos >= 0, where[np.maximum(split_seg_pos, 0)],
                                     -1)


def to_device(layout: EllLayout, device, shard: Tuple[int, int] = (0, 1)) -> DeviceEll:
    """Upload a host layout (from pinned memory when the target is CUDA).
    Counts must fit int32, which every kernel indexes with.

    ``shard=(rank, n_shards)`` uploads only the rank's slice ``[rank * m /
    n_shards, (rank + 1) * m / n_shards)`` of each bucket of m segments (a
    layout built with ``pad_shards=n_shards``) and the replicated
    reassembly arrays, its positions remapped to the rank-major order of
    the gathered segment sums (``parallel.engine``).  No fit calls it (a
    fit's layouts are ``pack_ell``'s, placed by ``device_ell``)."""
    device = torch.device(device)
    rank, n_shards = shard
    ms = [int(b.rows.shape[0]) for b in layout.buckets]
    n_segs = sum(ms)
    n_split = int(layout.split_rows.shape[0])
    if max(n_segs, layout.n_rows, n_split * layout.split_seg_pos.shape[1]) > _INT32_MAX:
        raise ValueError("layout too large for int32 indexing: %d segments, "
                         "%d rows, %d split chunks"
                         % (n_segs, layout.n_rows, n_split))
    if any(m % n_shards for m in ms) or not 0 <= rank < n_shards:
        raise ValueError("shard %s of a layout whose buckets hold %s segments "
                         "(build it with pad_shards=%d)" % (shard, ms, n_shards))
    inv_perm, split_seg_pos = _shard_positions(ms, n_shards, layout.inv_perm,
                                               layout.split_seg_pos)
    buckets = []
    start = 0
    for j, b in enumerate(layout.buckets):
        span = layout.col_spans[j] if layout.col_spans is not None else None
        per = ms[j] // n_shards
        part = slice(rank * per, (rank + 1) * per)
        buckets.append(DeviceBucket(
            rows=_upload(b.rows[part], np.int32, device),
            cols=_upload(b.cols[part], np.int32, device),
            vals=_upload(b.vals[part], b.vals.dtype, device),
            col_off=0 if span is None else int(span[0]),
            start=start))
        start += per
    return _device_ell(buckets, inv_perm, layout.split_rows, split_seg_pos, layout.n_rows,
                       start, n_shards, device)


def _device_ell(buckets, inv_perm, split_rows, split_seg_pos, n_rows, n_segs, n_shards,
                device) -> DeviceEll:
    """A ``DeviceEll`` of device buckets, with its reassembly arrays
    uploaded: ``inv_perm``, the split-row patch and its per-row CSR."""
    split_indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(split_rows, minlength=n_rows), out=split_indptr[1:])
    return DeviceEll(
        buckets=buckets,
        inv_perm=_upload(inv_perm, np.int32, device),
        split_seg_pos=_upload(split_seg_pos, np.int32, device),
        split_indptr=_upload(split_indptr, np.int32, device),
        n_rows=n_rows, n_segs=n_segs, n_shards=n_shards)


# ---- K15: a side's layout filled on the card ---------------------------

class EllPack(NamedTuple):
    """A side's layout on the device before its upload of row ids and
    reassembly arrays: the plan, the slabs of every bucket's cols and vals
    (of the rank's slice of every bucket), bucket after bucket, that K15
    filled, and the table row of each of those segments (``pack_ell``)."""

    plan: EllPlan
    cols: torch.Tensor  # (slots,) int32
    vals: torch.Tensor  # (slots,) the CSR's dtype
    bytes_to_device: int  # the segment table K15 read
    rows: np.ndarray  # (segments,) int64, host; 0 for padding
    shard: Tuple[int, int]


def _ell_fill_plain(cols, vals, seg_src, seg_len, btab, out_cols, out_vals):
    """Plain version of K15: each segment's entries to its slots, the rest
    of its width zero."""
    out_cols.zero_()
    out_vals.zero_()
    n_segs = seg_src.shape[0]
    if not n_segs:
        return
    first, base, w = (btab[:, c].contiguous() for c in range(3))
    s = torch.arange(n_segs, dtype=torch.int64, device=cols.device)
    b = torch.searchsorted(first, s, right=True) - 1
    dst = base[b] + (s - first[b]) * w[b]
    lens = seg_len.long()
    total = int(lens.sum())
    seg = torch.repeat_interleave(s, lens, output_size=total)
    j = torch.arange(total, dtype=torch.int64, device=cols.device) - (torch.cumsum(lens, 0)
                                                                      - lens)[seg]
    src = seg_src.long()[seg] + j
    out_cols[dst[seg] + j] = cols[src]
    out_vals[dst[seg] + j] = vals[src]


def ell_fill(cols, vals, seg_src, seg_len, btab, out_cols, out_vals):
    """K15: write every segment of a layout into the slabs ``out_cols`` /
    ``out_vals`` (each slot once, padding zero) from a side's CSR ``cols``
    (int32) / ``vals``.  ``seg_src`` / ``seg_len`` (int32, a segment in
    layout order) give a segment's first CSR position and its entries;
    ``btab`` (nb, 3) int64 a bucket's first segment, first slot and width.
    One launch for CUDA tensors (counted in ``.launches``); the plain
    version for CPU tensors."""
    if not cols.is_cuda:
        _ell_fill_plain(cols, vals, seg_src, seg_len, btab, out_cols, out_vals)
        return out_cols, out_vals
    from .. import _cuda

    _cuda.check(cols, seg_src, seg_len, out_cols, dtype=torch.int32)
    _cuda.check(vals, out_vals, dtype=vals.dtype)
    _cuda.check(btab, dtype=torch.int64)
    if (btab.dim() != 2 or btab.shape[1] != 3 or seg_len.shape != seg_src.shape
            or out_vals.shape != out_cols.shape or vals.shape != cols.shape):
        raise ValueError("ell_fill: shape mismatch")
    _cuda.launch("ell_fill", vals.dtype, None, cols, vals, seg_src, seg_len, btab,
                 btab.shape[0], seg_src.shape[0], out_cols, out_vals)
    ell_fill.launches += 1
    return out_cols, out_vals


ell_fill.launches = 0


def pack_ell(indptr: np.ndarray, cols: torch.Tensor, vals: torch.Tensor,
             max_width: int = 8192, shard: Tuple[int, int] = (0, 1)) -> EllPack:
    """A side's untiled layout from its CSR on the device: ``plan_ell`` on
    the host from the row pointers ``indptr`` ((n_rows + 1,) int64, host),
    then K15 from ``cols`` / ``vals`` (the CSR's entries, on the device)
    into the slabs.  The same layout as ``build_ell(indptr, cols, vals,
    n_rows, max_width)`` then ``to_device``, element for element; with
    ``shard=(rank, n_shards)``, as ``build_ell(..., pad_shards=n_shards)``
    then ``to_device(..., shard=shard)``: the rank's slice of every
    bucket, its padding segments inert (row 0, zero vals)."""
    rank, n_shards = shard
    n_rows = int(indptr.shape[0]) - 1
    plan = plan_ell(*untiled_runs(indptr), n_rows, max_width, pad_shards=n_shards)
    if int(plan.m_pads.sum()) > _INT32_MAX or int(indptr[-1]) > _INT32_MAX:
        raise ValueError("pack_ell: %d segments over %d entries overflow int32"
                         % (int(plan.m_pads.sum()), int(indptr[-1])))
    if not 0 <= rank < n_shards:
        raise ValueError("pack_ell: shard %s" % (shard,))
    per = plan.m_pads // n_shards
    seg_src, seg_len, rows = plan.seg_start, plan.seg_len, plan.seg_row
    if n_shards > 1:
        # the rank's slice of every bucket: a real segment's index into the
        # plan's lists, or past its bucket's real segments, padding
        b = np.repeat(np.arange(len(per)), per)
        q = rank * per[b] + np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per)
        real = q < np.diff(plan.first)[b]
        at = np.where(real, plan.first[b] + q, 0)
        seg_src, seg_len, rows = (np.where(real, a[at], 0) for a in (seg_src, seg_len, rows))
    device = cols.device
    slots = per * plan.widths
    btab = np.stack([np.cumsum(per) - per, np.cumsum(slots) - slots, plan.widths], axis=1)
    seg_src = _upload(seg_src, np.int32, device)
    seg_len = _upload(seg_len, np.int32, device)
    btab_dev = _upload(btab, np.int64, device)
    total = int(slots.sum())
    out_cols = torch.empty(total, dtype=torch.int32, device=device)
    out_vals = torch.empty(total, dtype=vals.dtype, device=device)
    ell_fill(cols, vals, seg_src, seg_len, btab_dev, out_cols, out_vals)
    return EllPack(plan=plan, cols=out_cols, vals=out_vals,
                   bytes_to_device=_nbytes(seg_src, seg_len, btab_dev), rows=rows, shard=shard)


def device_ell(pack: EllPack) -> DeviceEll:
    """The ``DeviceEll`` of a packed side (a rank's share of it): its
    buckets view the slabs, and their row ids and the reassembly arrays
    are uploaded."""
    plan, n_shards = pack.plan, pack.shard[1]
    device = pack.cols.device
    per = (plan.m_pads // n_shards).tolist()
    rows = _upload(pack.rows, np.int32, device)
    buckets, slot, s0 = [], 0, 0
    for m, w in zip(per, plan.widths.tolist()):
        n = m * w
        buckets.append(DeviceBucket(rows=rows[s0:s0 + m], cols=pack.cols[slot:slot + n].view(-1, w),
                                    vals=pack.vals[slot:slot + n].view(-1, w), col_off=0,
                                    start=s0))
        slot += n
        s0 += m
    inv_perm, split_seg_pos = _shard_positions(plan.m_pads, n_shards, plan.inv_perm,
                                               plan.split_seg_pos)
    return _device_ell(buckets, inv_perm, plan.split_rows, split_seg_pos, plan.n_rows, s0,
                       n_shards, device)


def uploaded_bytes(pack: EllPack, layout: DeviceEll) -> int:
    """Bytes a side packed on the device took from the host: K15's segment
    table, then the row ids and reassembly arrays ``device_ell`` uploaded."""
    return pack.bytes_to_device + _nbytes(*(b.rows for b in layout.buckets), layout.inv_perm,
                                          layout.split_seg_pos, layout.split_indptr)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---- K1: per-bucket phi sums -----------------------------------------

def _acc_dtype(table_dtype):
    """K1's accumulation dtype: float32 for bfloat16 tables (JAX
    ``ell.py:476``), else the tables' own."""
    return torch.float32 if table_dtype == torch.bfloat16 else table_dtype


def _bucket_phi_sums_plain(t_self, t_other, rows, cols, vals, col_off):
    """Plain version of K1: ``(m, k)`` phi sums of one bucket, in
    ``_acc_dtype`` of the tables (rows widened after the gather)."""
    acc = _acc_dtype(t_self.dtype)
    p = t_self[rows.long()].to(acc)[:, None, :] * t_other[cols.long() + col_off].to(acc)
    denom = p.sum(-1)
    scale = torch.where(denom > 0, vals.to(acc) / denom, torch.zeros_like(denom))
    return torch.einsum("cw,cwk->ck", scale, p)


def _warps_per_segment(w: int) -> int:
    """Warps that share one segment of width ``w`` in K1: a warp walks its
    slots as a chain of dependent loads, so wide segments are split to
    keep each warp's chain at most ~1024 slots."""
    return 1 if w < 512 else 2 if w < 1024 else 4 if w < 2048 else 8


def bucket_phi_sums(t_self, t_other, rows, cols, vals, col_off, out):
    """K1 for one bucket, written into ``out`` (m, k).  Tables of the state
    dtype, or bfloat16 tables with ``vals`` of the state dtype and a
    float32 ``out``."""
    if not t_self.is_cuda:
        out.copy_(_bucket_phi_sums_plain(t_self, t_other, rows, cols, vals,
                                         col_off))
        return out
    from .. import _cuda

    m, w = cols.shape
    k = t_self.shape[1]
    bf16 = t_self.dtype == torch.bfloat16
    _cuda.check(t_self, t_other, dtype=t_self.dtype)
    _cuda.check(vals, dtype=vals.dtype)
    _cuda.check(out, dtype=_acc_dtype(t_self.dtype))
    _cuda.check(rows, cols, dtype=torch.int32)
    if not bf16 and vals.dtype != t_self.dtype:
        raise TypeError("bucket_phi_sums: vals and tables differ in dtype")
    if (t_other.shape[1] != k or out.shape != (m, k) or rows.shape != (m,)
            or vals.shape != (m, w)):
        raise ValueError("bucket_phi_sums: shape mismatch")
    _cuda.launch("ell_phi_sums_bf16" if bf16 else "ell_phi_sums", vals.dtype, k, t_self,
                 t_other, rows, cols, vals, out, m, w, k, col_off, _warps_per_segment(w))
    if bf16:
        bucket_phi_sums.launches_bf16 += 1
    else:
        bucket_phi_sums.launches += 1
    return out


bucket_phi_sums.launches = bucket_phi_sums.launches_bf16 = 0


def _bucket_table(layout: DeviceEll):
    """K1's device table of a layout's non-empty buckets, (nb, 9) int64 rows
    of (rows, cols, vals addresses, first segment, m, col_off, w, warps per
    segment, first block), the buckets with the longest walk a warp first;
    and the blocks of all of them.  Built once per layout (cached on it
    while its buckets' arrays stay the same), checked as ``bucket_phi_sums``
    checks each bucket."""
    key = tuple((b.rows.data_ptr(), b.cols.data_ptr(), b.vals.data_ptr(), b.col_off, b.start)
                for b in layout.buckets)
    if layout.k1_table is not None and layout.k1_table[0] == key:
        return layout.k1_table[1], layout.k1_table[2]
    from .. import _cuda

    entries = []
    for b in layout.buckets:
        m, w = b.cols.shape
        _cuda.check(b.rows, b.cols, dtype=torch.int32)
        _cuda.check(b.vals, dtype=layout.buckets[0].vals.dtype)
        if b.rows.shape != (m,) or b.vals.shape != (m, w) or b.start + m > layout.n_segs:
            raise ValueError("all_bucket_sums: bucket shape mismatch")
        if m and w:
            entries.append((-(w // _warps_per_segment(w)), len(entries), b))
    rows, blocks = [], 0
    for _, _, b in sorted(entries, key=lambda e: e[:2]):  # longest walk first, then bucket order
        m, w = b.cols.shape
        wps = _warps_per_segment(w)
        rows.append([b.rows.data_ptr(), b.cols.data_ptr(), b.vals.data_ptr(), b.start, m,
                     b.col_off, w, wps, blocks])
        blocks += -(-m // (_cuda.WARPS_PER_BLOCK // wps))
    device = layout.buckets[0].rows.device
    table = torch.tensor(rows, dtype=torch.int64).reshape(-1, 9).to(device)
    layout.k1_table = (key, table, blocks)
    return table, blocks


def all_bucket_sums(t_self, t_other, layout: DeviceEll, out=None):
    """Per-segment phi sums over all buckets, in segment order: (n_segs, k),
    in K1's accumulation dtype.  One launch for CUDA tensors (counted in
    ``.launches``, bfloat16 tables in ``.launches_bf16``); the plain
    version bucket by bucket for CPU tensors.

    With ``out`` (n_segs, k), the sums of ``layout``'s buckets are written
    into it at their ``start`` and the rest of it is left as it is:
    ``layout`` is then a view of some of a layout's buckets, as the
    table-sharded ring keeps one a ring offset
    (``parallel.table_sharded.rank_share``), and these launches count in
    ``.launches_offset`` (``.launches_offset_bf16``)."""
    k = t_self.shape[1]
    if out is None:
        seg = torch.empty((layout.n_segs, k), dtype=_acc_dtype(t_self.dtype),
                          device=t_self.device)
    else:
        if out.shape != (layout.n_segs, k) or out.dtype != _acc_dtype(t_self.dtype):
            raise ValueError("all_bucket_sums: out of shape %s and %s, the layout's sums are "
                             "(%d, %d) %s" % (tuple(out.shape), out.dtype, layout.n_segs, k,
                                              _acc_dtype(t_self.dtype)))
        seg = out
    if not t_self.is_cuda:
        for b in layout.buckets:
            m = b.rows.shape[0]
            bucket_phi_sums(t_self, t_other, b.rows, b.cols, b.vals, b.col_off,
                            seg[b.start:b.start + m])
        return seg
    from .. import _cuda

    if not layout.buckets:
        return seg
    bf16 = t_self.dtype == torch.bfloat16
    vals_dtype = layout.buckets[0].vals.dtype
    _cuda.check(t_self, t_other, dtype=t_self.dtype)
    if not bf16 and vals_dtype != t_self.dtype:
        raise TypeError("all_bucket_sums: vals and tables differ in dtype")
    if t_other.shape[1] != k:
        raise ValueError("all_bucket_sums: shape mismatch")
    table, blocks = _bucket_table(layout)
    if not blocks:
        return seg
    if table.device != t_self.device:
        raise ValueError("all_bucket_sums: layout and tables on different devices")
    _cuda.check(seg, dtype=seg.dtype)
    _cuda.launch("ell_phi_sums_all_bf16" if bf16 else "ell_phi_sums_all", vals_dtype, k,
                 t_self, t_other, table, table.shape[0], blocks, seg, k)
    counter = ("launches" if out is None else "launches_offset") + ("_bf16" if bf16 else "")
    setattr(all_bucket_sums, counter, getattr(all_bucket_sums, counter) + 1)
    return seg


all_bucket_sums.launches = all_bucket_sums.launches_bf16 = 0
all_bucket_sums.launches_offset = all_bucket_sums.launches_offset_bf16 = 0


# ---- K2: segment sums to table order ---------------------------------

def _segment_table_sums_plain(seg, layout: DeviceEll):
    """Plain version of K2, in the kernel's order of adds (so with its
    bits): each row's first segment, then the row's split chunks in order,
    each chunk the sum from zero of its P positions in order (position -1
    adds nothing)."""
    out = seg[layout.inv_perm.long()]
    n_chunks = layout.split_seg_pos.shape[0]
    if n_chunks:
        pos = layout.split_seg_pos.long()
        extra = seg.new_zeros((n_chunks, seg.shape[1]))
        for p in range(pos.shape[1]):
            valid = pos[:, p] >= 0
            extra = torch.where(valid[:, None], extra + seg[pos[:, p].clamp_min(0)], extra)
        ip = layout.split_indptr.long()
        counts = ip[1:] - ip[:-1]
        rows = torch.repeat_interleave(torch.arange(layout.n_rows, device=seg.device), counts,
                                       output_size=n_chunks)
        rank = torch.arange(n_chunks, device=seg.device) - ip[rows]  # a chunk's place in its row
        for j in range(int(counts.max())):
            sel = rank == j
            out[rows[sel]] += extra[sel]  # one chunk a row: no two adds meet
    return out


def segment_table_sums(seg, layout: DeviceEll, out_dtype=None):
    """K2: reassemble per-segment sums (n_segs, k) into table order
    (n_rows, k), summed in the dtype of ``seg`` and written in
    ``out_dtype`` (None: the same; float32 sums may be written as
    float64).  On the card one call (counted once in ``.launches``) is a
    pass over the split chunks, where the layout has any, then the pass
    over every row; the chunk sums go to a scratch table allocated here."""
    out_dtype = seg.dtype if out_dtype is None else out_dtype
    if not seg.is_cuda:
        return _segment_table_sums_plain(seg, layout).to(out_dtype)
    from .. import _cuda

    k = seg.shape[1]
    _cuda.check(seg, dtype=seg.dtype)
    _cuda.check(layout.inv_perm, layout.split_indptr, layout.split_seg_pos,
                dtype=torch.int32)
    out = torch.empty((layout.n_rows, k), dtype=out_dtype, device=seg.device)
    n_chunks = layout.split_seg_pos.shape[0]
    chunk_sums = torch.empty((n_chunks, k), dtype=seg.dtype, device=seg.device)
    args = (seg, layout.inv_perm, layout.split_indptr, layout.split_seg_pos, chunk_sums, out,
            layout.n_rows, k, n_chunks, layout.split_seg_pos.shape[1])
    if out_dtype == seg.dtype:
        _cuda.launch("segment_table_sums", seg.dtype, k, *args)
    elif (seg.dtype, out_dtype) == (torch.float32, torch.float64):
        _cuda.launch("segment_table_sums_f32_f64", None, k, *args)
    else:
        raise TypeError(f"segment_table_sums: {seg.dtype} sums to {out_dtype}")
    segment_table_sums.launches += 1
    return out


segment_table_sums.launches = 0


def ell_phi_sums(t_self, t_other, layout: DeviceEll, out_dtype=None):
    """Per-table-row phi sums, shape (n_rows, k): K1 then K2, written in
    ``out_dtype`` (None: K1's accumulation dtype)."""
    return segment_table_sums(all_bucket_sums(t_self, t_other, layout), layout, out_dtype)


def gather_table_dtype(mode: str = "auto"):
    """The storage dtype of the gathered exp tables (JAX
    ``ell.py:gather_table_dtype``): ``torch.bfloat16`` for ``'bfloat16'``,
    else None (the state dtype).  JAX's ``'auto'`` switches to bfloat16
    once a float32 table exceeds 64 MiB, a threshold of the TPU's gather
    window; the port's ``'auto'`` keeps the state dtype until the H100 has
    measured the choice (``chip_smoke.py`` phase 3h)."""
    return torch.bfloat16 if mode == "bfloat16" else None


# ---- the CAVI loop ---------------------------------------------------

def cavi_step_ell_carried(carry: Carry, ell_u: DeviceEll, ell_i: DeviceEll, hp,
                          gather_dtype=None, phi_sums=None) -> Carry:
    """One CAVI iteration (reference ``cython_loops.pxi:227-259``): both
    E-step sums read the carried (old) exp tables, reach the state dtype
    after K2, then ``cavi_step_carried`` updates the user side and the
    item side.  ``phi_sums`` is ``ell_phi_sums``, or in a data-parallel
    fit K12a over the rank's shards of the layouts
    (``parallel.engine.sharded_ell_phi_sums``)."""
    dt = carry.state.G_shp.dtype
    phi_sums = phi_sums or ell_phi_sums
    su = phi_sums(carry.t_tab, carry.b_tab, ell_u, dt)
    si = phi_sums(carry.b_tab, carry.t_tab, ell_i, dt)
    return cavi_step_carried(carry, su, si, hp, gather_dtype)


def run_cavi_block_ell(carry: Carry, ell_u: DeviceEll, ell_i: DeviceEll,
                       niter: int, hp, gather_dtype=None, phi_sums=None) -> Carry:
    """``niter`` CAVI iterations as a loop of launches with no host sync;
    returns the final carry (its ``state`` is the new state).  Unlike the
    JAX function it takes the carry, not the state: a fit derives it once
    (``ops.cavi._carry_init``, with the same ``gather_dtype``) and passes it from
    block to block."""
    for _ in range(int(niter)):
        carry = cavi_step_ell_carried(carry, ell_u, ell_i, hp, gather_dtype, phi_sums)
    return carry
