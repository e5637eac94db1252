"""Top-n items by ``Theta_u . Beta_i`` in plain PyTorch, and the gap by
which a served list falls short of it.

The reference scores in float64.  The gap of a user is the largest, over
the ranks j = 1..n, of ``best_j - served_j``, where ``best_j`` is the
reference's j-th best score of the user and ``served_j`` the reference's
score of the served item that ranks j-th among the served items by that
score; it is divided by the user's best score.  A served list that repeats
an item or names one outside the catalog has an infinite gap.  The
control, ``topn_tf32``, ranks in TF32: the float32 product with each input
rounded to TF32's 10-bit mantissa, as the tensor cores round it.
"""

from __future__ import annotations

import torch


def _scores64(theta_rows, beta):
    return theta_rows.to(torch.float64) @ beta.to(torch.float64).T


def gaps(theta, beta, users, served, block: int = 2048) -> torch.Tensor:
    """The relative gap of each served list: ``theta`` (nU, k) and
    ``beta`` (nI, k) on one device, ``users`` (m,) and ``served`` (m, n)
    int64 on the same device.  Returns (m,) float64."""
    n = served.shape[1]
    n_items = beta.shape[0]
    out = torch.empty(users.shape[0], dtype=torch.float64, device=theta.device)
    for s in range(0, users.shape[0], block):
        sc = _scores64(theta[users[s:s + block]], beta)
        best = torch.topk(sc, n, dim=1).values
        got = served[s:s + block]
        valid = ((got >= 0) & (got < n_items)).all(dim=1)
        srt = torch.sort(got.clamp(0, n_items - 1), dim=1).values
        valid &= (srt[:, 1:] != srt[:, :-1]).all(dim=1)
        got_sc = torch.sort(torch.gather(sc, 1, got.clamp(0, n_items - 1)), dim=1,
                            descending=True).values
        gap = ((best - got_sc).max(dim=1).values / best[:, 0].abs()).clamp_min(0)
        out[s:s + block] = torch.where(valid, gap, torch.full_like(gap, float("inf")))
    return out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits), to
    nearest with ties away from zero."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def topn_tf32(theta_rows, beta, n: int, block: int = 4096) -> torch.Tensor:
    """The control's answer: the n best items by TF32 scores, (b, n) int64."""
    b = round_tf32(beta).T
    return torch.cat([torch.topk(round_tf32(theta_rows[s:s + block]) @ b, n, dim=1).indices
                      for s in range(0, theta_rows.shape[0], block)])
