"""Batch top-n ranking over the whole catalog (K6).

Port of ``hpfrec_tpu/ops/topk.py``.  A batch of users is scored against
every item in one pass, the batch's seen items are set to ``-inf``, and
the n best items of each user are selected on the device:

- ``topn_rows`` (K6, ``csrc/topn.cu``): scores ``Theta_rows @ Beta.T``
  summed in the state dtype and rounded to float32 (the JAX function's
  ``preferred_element_type=float32``), ``-inf`` at the given (row, item)
  pairs, and the n largest scores per row in ``lax.top_k``'s order (score
  descending, then index ascending).  Its plain version below does the
  same with a matrix product and a stable sort.
- ``topn_batch``: the host's ragged pair list of the seen items, chunks of
  users whose (b, nI) score buffer and select scratch stay within
  ``_CHUNK_BYTES``, and the host backfill for users with fewer than n
  unseen items.

Chunking is the port's own: the JAX function pads the batch to a power of
two and scores it whole.  The results are the same.
"""

from __future__ import annotations

import numpy as np
import torch

# Device bytes of one chunk of users (scores and select scratch): 1,024
# users at 376,768 items and n <= 4,096.
_CHUNK_BYTES = 2 << 30
# Candidates that K6's select sorts in shared memory (csrc/topn.cu kSmemCand);
# a larger n sorts in a global scratch row.
_SMEM_CAND = 4096


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _topn_rows_plain(Theta_rows, Beta, mask_rows, mask_items, n):
    scores = (Theta_rows @ Beta.T).to(torch.float32)
    if mask_rows is not None:
        r, i = mask_rows.long(), mask_items.long()
        keep = (r >= 0) & (r < scores.shape[0]) & (i >= 0) & (i < scores.shape[1])
        scores[r[keep], i[keep]] = -torch.inf
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n].to(torch.int32)


def topn_rows(Theta_rows, Beta, mask_rows, mask_items, n: int):
    """K6 on one chunk: ``(vals (b, n) float32, idx (b, n) int32)``, the n
    best items of each row of ``Theta_rows`` (b, k) against ``Beta`` (nI,
    k), after setting ``-inf`` at the pairs ``(mask_rows[j],
    mask_items[j])`` (int32; both None for no exclusion).  A pair outside
    the (b, nI) scores is dropped, as the JAX scatter's ``mode='drop'``
    drops its padding (a negative id too, which JAX's indexing would
    wrap).  ``1 <= n <= nI``."""
    if not Theta_rows.is_cuda:
        return _topn_rows_plain(Theta_rows, Beta, mask_rows, mask_items, n)
    from .. import _cuda

    b, k = Theta_rows.shape
    nI = Beta.shape[0]
    dt = Theta_rows.dtype
    _cuda.check(Theta_rows, Beta, dtype=dt)
    if Beta.shape[1] != k or not 1 <= n <= nI:
        raise ValueError("topn_rows: shape mismatch or n outside 1..nI")
    dev = Theta_rows.device
    scores = torch.empty((b, nI), dtype=torch.float32, device=dev)
    _cuda.launch("topn_score", dt, k, Theta_rows, Beta, scores, b, nI, k)
    if mask_rows is not None and mask_rows.shape[0]:
        _cuda.check(mask_rows, mask_items, dtype=torch.int32)
        _cuda.launch("topn_mask", None, None, scores, mask_rows, mask_items,
                     mask_rows.shape[0], b, nI)
    P = _next_pow2(n)
    cand = (torch.empty((b, P), dtype=torch.int64, device=dev) if P > _SMEM_CAND
            else None)
    vals = torch.empty((b, n), dtype=torch.float32, device=dev)
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    _cuda.launch("topn_select", None, None, scores, vals, idx, cand, b, nI, n, P)
    topn_rows.launches += 1
    return vals, idx


topn_rows.launches = 0


def _chunk_rows(b: int, nI: int, n: int) -> int:
    """Users per chunk: the largest power of two whose (rows, nI) float32
    scores, and the select's global candidate rows where n needs them,
    fit ``_CHUNK_BYTES``, at most ``b``."""
    P = _next_pow2(n)
    row_bytes = 4 * max(nI, 1) + (8 * P if P > _SMEM_CAND else 0)
    fit = max(1, _CHUNK_BYTES // row_bytes)
    return min(b, 1 << (fit.bit_length() - 1))


def _to(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def topn_batch(Theta, Beta, users, n, seen_indptr=None, seen_indices=None,
               n_seen=None):
    """Top-n item rows for each user row in ``users``.

    ``Theta`` is the host (nU, k) table; ``Beta`` the (nI, k) table as a
    tensor, whose device K6 runs on.  With seen-lists given (CSR start
    offsets + per-user counts, the reference's
    ``_st_ix_user``/``seen``/``_n_seen_by_user`` metadata), those items are
    masked out on the device before ranking — the same exclusion as the
    reference ``topN``.  Returns a ``(len(users), min(n, nI))`` int32 array
    of item rows.
    """
    device = Beta.device
    users = np.asarray(users, dtype=np.int64)
    b = len(users)
    nI = Beta.shape[0]
    k_eff = min(n, nI)
    if b == 0 or k_eff <= 0:
        return np.zeros((b, max(k_eff, 0)), dtype=np.int32)
    dt = Beta.dtype

    masked = seen_indptr is not None
    if masked:
        # ragged gather of the batch's seen items (host, vectorized)
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
        rows_t = _to(np.asarray(Theta[users[r0:r1]]), device)
        mask_rows = mask_items = None
        if masked:
            p0 = int(ends[r0 - 1]) if r0 else 0
            p1 = int(ends[r1 - 1])
            mask_rows = _to(np.repeat(np.arange(r1 - r0, dtype=np.int32), counts[r0:r1]),
                            device)
            mask_items = _to(items[p0:p1], device)
        v, i = topn_rows(rows_t.to(dt), Beta, mask_rows, mask_items, k_eff)
        vals[r0:r1] = v.cpu().numpy()
        idx[r0:r1] = i.cpu().numpy()
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
