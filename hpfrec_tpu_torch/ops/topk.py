"""Batch top-n ranking over the whole catalog (K6).

Port of ``hpfrec_tpu/ops/topk.py``.  A batch of users is scored against
every item in one pass, the batch's seen items are set to ``-inf``, and
the n best items of each user are selected on the device:

- ``topn_rows`` (K6, ``csrc/topn.cu``): scores ``Theta_rows @ Beta.T``
  summed in the state dtype and rounded to float32 (the JAX function's
  ``preferred_element_type=float32``), ``-inf`` at the given (row, item)
  pairs, and the n largest scores per row in ``lax.top_k``'s order (score
  descending, then index ascending).  Up to n = ``_FUSED_MAX_N`` one
  kernel scores and selects without a score buffer; a larger n writes the
  scores and selects from them (a histogram pass over each row that also
  collects the keys at or above a guessed bin, a second pass where the
  guess missed, and a sort of the keys at or above the n-th key's bin).
  Its plain version below does the same with a matrix product and a stable
  sort.
- ``topn_batch``: the host's ragged pair list of the seen items, chunks of
  users whose device buffers stay within ``_CHUNK_BYTES``, and the host
  backfill for users with fewer than n unseen items.

Chunking is the port's own: the JAX function pads the batch to a power of
two and scores it whole.  The results are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import TopNStats

# Device bytes of one chunk of users: 16,384 users at 376,768 items on the
# fused path (n <= _FUSED_MAX_N; bitmask and candidates), 1,024 on the
# three-kernel path at n <= 4,096 (scores and select scratch).
_CHUNK_BYTES = 2 << 30
# Candidates that K6's select and merge sort in shared memory
# (csrc/topn.cu kSmemCand); a larger n sorts in a global scratch row.
_SMEM_CAND = 4096
# The fused path (csrc/topn.cu kFuseMaxN, kFuseBM, kFuseBN): the largest n,
# users per block, items per tile.
_FUSED_MAX_N = 128
_FUSED_BM = 64
_FUSED_BN = 128
# Blocks of the fused kernel to aim for on each SM: one wave of the two that
# fit.  More ranges fill the card at a small chunk, but each range pays for
# filling its users' lists anew (scripts/split_k6_k7.py on an H100 80GB HBM3
# at 700 W: a 1,024-user chunk at n = 10 takes 2.66 ms with 16 ranges, 256
# blocks; 3.94 ms with 17, whose 272 blocks spill into a second wave; 3.45
# ms with 8 and 2.87 ms with 33)
_FUSED_BLOCKS_PER_SM = 2


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _topn_select_plain(scores, n):
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n].to(torch.int32)


def _topn_rows_plain(Theta_rows, Beta, mask_rows, mask_items, n):
    scores = (Theta_rows @ Beta.T).to(torch.float32)
    if mask_rows is not None:
        r, i = mask_rows.long(), mask_items.long()
        keep = (r >= 0) & (r < scores.shape[0]) & (i >= 0) & (i < scores.shape[1])
        scores[r[keep], i[keep]] = -torch.inf
    return _topn_select_plain(scores, n)


def _item_ranges(b: int, nI: int, n: int, sms: int, bm: int = _FUSED_BM):
    """``(range_w, R)``: the fused kernel's item ranges, ``R`` ranges of
    ``range_w`` items (a multiple of the tile; the last one shorter), as
    many as keep the chunk's user tiles (of ``bm`` users: the fused
    kernel's, or the score kernel's, which ``csrc/topn.cu`` exports) times
    ``R`` blocks within one wave of ``_FUSED_BLOCKS_PER_SM`` blocks an SM
    (a second, partial wave would take as long as the first), at least
    one, at most one a tile and at most ``_SMEM_CAND // n`` (the merge
    sorts a row's ``R * n`` candidates in shared memory)."""
    tiles = -(-nI // _FUSED_BN)
    user_tiles = -(-b // bm)
    want = _FUSED_BLOCKS_PER_SM * sms // user_tiles
    R = max(1, min(tiles, want, _SMEM_CAND // n))
    per = -(-tiles // R)
    return per * _FUSED_BN, -(-tiles // per)


def topn_rows(Theta_rows, Beta, mask_rows, mask_items, n: int):
    """K6 on one chunk: ``(vals (b, n) float32, idx (b, n) int32)``, the n
    best items of each row of ``Theta_rows`` (b, k) against ``Beta`` (nI,
    k), after setting ``-inf`` at the pairs ``(mask_rows[j],
    mask_items[j])`` (int32; both None for no exclusion).  A pair outside
    the (b, nI) scores is dropped, as the JAX scatter's ``mode='drop'``
    drops its padding (a negative id too, which JAX's indexing would
    wrap).  ``1 <= n <= nI``.

    On the card, n up to ``_FUSED_MAX_N`` runs the fused path (score and
    select in one kernel, no score buffer; launches in ``.launches``), a
    larger n the three-kernel path (scores, mask, select; one a select in
    ``.launches_large``, counted by ``_topn_select``).  Both give the same
    bits."""
    if not Theta_rows.is_cuda:
        return _topn_rows_plain(Theta_rows, Beta, mask_rows, mask_items, n)
    if n <= _FUSED_MAX_N:
        return _topn_fused(Theta_rows, Beta, mask_rows, mask_items, n)
    return _topn_scored(Theta_rows, Beta, mask_rows, mask_items, n)


topn_rows.launches = topn_rows.launches_large = 0


def _check(Theta_rows, Beta, mask_rows, mask_items, n):
    from .. import _cuda

    k = Theta_rows.shape[1]
    _cuda.check(Theta_rows, Beta, dtype=Theta_rows.dtype)
    if Beta.shape[1] != k or not 1 <= n <= Beta.shape[0]:
        raise ValueError("topn_rows: shape mismatch or n outside 1..nI")
    masked = mask_rows is not None and mask_rows.shape[0] > 0
    if masked:
        _cuda.check(mask_rows, mask_items, dtype=torch.int32)
    return _cuda, masked


def _topn_fused(Theta_rows, Beta, mask_rows, mask_items, n: int):
    """K6's fused path (CUDA tensors, ``n <= _FUSED_MAX_N``): the chunk's
    seen pairs as a (b, ceil(nI / 32)) bitmask, then one kernel that
    scores tiles in registers and keeps each item range's n best (key,
    ~index) words, then a merge of each row's ``R * n`` candidates."""
    _cuda, masked = _check(Theta_rows, Beta, mask_rows, mask_items, n)
    if n > _FUSED_MAX_N:
        raise ValueError("topn_rows: the fused path takes n <= %d" % _FUSED_MAX_N)
    b, k = Theta_rows.shape
    nI = Beta.shape[0]
    dev = Theta_rows.device
    W = -(-nI // 32)
    mask = None
    if masked:
        mask = torch.zeros((b, W), dtype=torch.int32, device=dev)
        _cuda.launch("topn_bitmask", None, None, mask, mask_rows, mask_items,
                     mask_rows.shape[0], b, nI, W)
    range_w, R = _item_ranges(b, nI, n, torch.cuda.get_device_properties(dev)
                              .multi_processor_count)
    cand = torch.empty((b, R * n), dtype=torch.int64, device=dev)
    _cuda.launch("topn_fused", Theta_rows.dtype, k, Theta_rows, Beta, mask, W, cand, b, nI,
                 k, n, range_w, R)
    vals = torch.empty((b, n), dtype=torch.float32, device=dev)
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    _cuda.launch("topn_merge", None, None, cand, vals, idx, b, R * n, n)
    topn_rows.launches += 1
    return vals, idx


def _topn_scored(Theta_rows, Beta, mask_rows, mask_items, n: int):
    """K6's three-kernel path (CUDA tensors, any n): the scores with the
    seen pairs at ``-inf`` (``_topn_scores``), then the select."""
    return _topn_select(_topn_scores(Theta_rows, Beta, mask_rows, mask_items, n), n)


def _topn_scores(Theta_rows, Beta, mask_rows, mask_items, n: int):
    """The (b, nI) float32 scores of K6's three-kernel path (CUDA tensors):
    summed as the fused kernel sums them, over its item ranges, then
    ``-inf`` at the seen pairs."""
    _cuda, masked = _check(Theta_rows, Beta, mask_rows, mask_items, n)
    b, k = Theta_rows.shape
    nI = Beta.shape[0]
    dev = Theta_rows.device
    scores = torch.empty((b, nI), dtype=torch.float32, device=dev)
    # item ranges as the fused kernel's at n = 1, for the score kernel's
    # users a block: one wave of its blocks
    lib = _cuda.load()
    bm = (lib.hpf_topn_score_rows_f64 if Theta_rows.dtype == torch.float64
          else lib.hpf_topn_score_rows_f32)()
    range_w, R = _item_ranges(b, nI, 1, torch.cuda.get_device_properties(dev)
                              .multi_processor_count, bm)
    _cuda.launch("topn_score", Theta_rows.dtype, k, Theta_rows, Beta, scores, b, nI, k,
                 range_w, R)
    if masked:
        _cuda.launch("topn_mask", None, None, scores, mask_rows, mask_items,
                     mask_rows.shape[0], b, nI)
    return scores


def _topn_select(scores, n: int):
    """K6's select on a (b, nI) float32 score buffer: the n largest scores
    of each row and their indices, in ``lax.top_k``'s order (score
    descending, then index ascending).  On the card, a histogram pass over
    each row's keys that also collects those at or above a guessed bin, a
    second pass where the guess missed, and a sort of the keys at or above
    the n-th key's bin (``csrc/topn.cu``)."""
    if not scores.is_cuda:
        return _topn_select_plain(scores, n)
    from .. import _cuda

    _cuda.check(scores, dtype=torch.float32)
    b, nI = scores.shape
    if not 1 <= n <= nI:
        raise ValueError("topn_rows: n outside 1..nI")
    P = _next_pow2(n)
    cand = (torch.empty((b, P), dtype=torch.int64, device=scores.device) if P > _SMEM_CAND
            else None)
    vals = torch.empty((b, n), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=scores.device)
    _cuda.launch("topn_select", None, None, scores, vals, idx, cand, b, nI, n, P)
    topn_rows.launches_large += 1
    return vals, idx


def _chunk_rows(b: int, nI: int, n: int) -> int:
    """Users per chunk: the largest power of two, at most ``b``, whose
    device buffers fit ``_CHUNK_BYTES``.  A row costs, on the fused path
    (``n <= _FUSED_MAX_N``), its bitmask words and at most ``_SMEM_CAND``
    candidate words; on the three-kernel path its float32 scores and,
    where n needs them, the select's global candidate words."""
    if n <= _FUSED_MAX_N:
        row_bytes = 4 * -(-max(nI, 1) // 32) + 8 * _SMEM_CAND
    else:
        P = _next_pow2(n)
        row_bytes = 4 * max(nI, 1) + (8 * P if P > _SMEM_CAND else 0)
    fit = max(1, _CHUNK_BYTES // row_bytes)
    return min(b, 1 << (fit.bit_length() - 1))


def _to(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def topn_batch(Theta, Beta, users, n, seen_indptr=None, seen_indices=None,
               n_seen=None, stats=None):
    """Top-n item rows for each user row in ``users``.

    ``Theta`` is the host (nU, k) table; ``Beta`` the (nI, k) table as a
    tensor, whose device K6 runs on.  With seen-lists given (CSR start
    offsets + per-user counts, the reference's
    ``_st_ix_user``/``seen``/``_n_seen_by_user`` metadata), those items are
    masked out on the device before ranking — the same exclusion as the
    reference ``topN``.  Returns a ``(len(users), min(n, nI))`` int32 array
    of item rows.  ``stats`` (a ``utils.profiling.TopNStats``) takes the
    call's phases and counters.
    """
    stats = TopNStats() if stats is None else stats
    device = Beta.device
    users = np.asarray(users, dtype=np.int64)
    b = len(users)
    nI = Beta.shape[0]
    k_eff = min(n, nI)
    stats.users += b
    if b == 0 or k_eff <= 0:
        return np.zeros((b, max(k_eff, 0)), dtype=np.int32)
    dt = Beta.dtype

    masked = seen_indptr is not None
    if masked:
        # ragged gather of the batch's seen items (host, vectorized)
        with stats.phase("rows"):
            starts = np.asarray(seen_indptr)[users]
            counts = np.asarray(n_seen)[users].astype(np.int64)
            ends = np.cumsum(counts)
            gx = (np.repeat(starts - (ends - counts), counts)
                  + np.arange(int(ends[-1]), dtype=np.int64))
            items = np.asarray(seen_indices)[gx].astype(np.int32)

    idx = np.empty((b, k_eff), dtype=np.int32)
    vals = np.empty((b, k_eff), dtype=np.float32)
    step = _chunk_rows(b, nI, k_eff)
    for r0 in range(0, b, step):
        r1 = min(b, r0 + step)
        stats.chunks += 1
        with stats.phase("gather"):
            rows_t = _to(np.asarray(Theta[users[r0:r1]]), device)
            mask_rows = mask_items = None
            if masked:
                p0 = int(ends[r0 - 1]) if r0 else 0
                p1 = int(ends[r1 - 1])
                mask_rows = _to(np.repeat(np.arange(r1 - r0, dtype=np.int32),
                                          counts[r0:r1]), device)
                mask_items = _to(items[p0:p1], device)
                stats.bytes_to_device += mask_rows.nbytes + mask_items.nbytes
            stats.bytes_to_device += rows_t.nbytes
        with stats.phase("rank"):
            v, i = topn_rows(rows_t.to(dt), Beta, mask_rows, mask_items, k_eff)
        with stats.phase("fetch"):
            vals[r0:r1] = v.cpu().numpy()
            idx[r0:r1] = i.cpu().numpy()
            stats.bytes_to_host += v.nbytes + i.nbytes
    if not masked:
        return idx

    # pathological case: a user saw nearly the whole catalog and fewer
    # than n items remain -> -inf slots.  Backfill first with any other
    # unseen items, then (when the unseen set itself is smaller than n,
    # where the reference's topN simply returns fewer rows) with the
    # user's best-scoring seen items so the output stays rectangular.
    bad = ~np.isfinite(vals)
    if bad.any():
        for j in np.flatnonzero(bad.any(axis=1)):
            seen = np.asarray(seen_indices)[starts[j]:starts[j] + counts[j]]
            good = idx[j][np.isfinite(vals[j])]
            rest = np.setdiff1d(np.arange(nI), np.concatenate([seen, good]))
            fill = np.concatenate([good, rest])
            if fill.shape[0] < k_eff:
                # score only this user's seen items: index the (device)
                # table first, never copy all of it back
                sel = Beta[_to(seen.astype(np.int64), device)]
                s_seen = np.asarray(Theta[users[j]]) @ sel.cpu().numpy().T
                order = seen[np.argsort(-s_seen, kind="stable")]
                fill = np.concatenate([fill, order])
            idx[j] = fill[:k_eff]
    return idx
