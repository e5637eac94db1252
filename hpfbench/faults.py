"""Faults planted in the program under a whole run, for the readings that
set a limit's upper end (``python3 -m hpfbench.control --arm
fault:<name>``) and for the tests that see ``correct`` come out false.

Each fault is ``fault(patch)``, where ``patch(obj, name, value)`` replaces
an attribute (``setattr``, or a test's ``monkeypatch.setattr``).  ``FIT``
holds the faults a fit can have, ``SERVING`` those of a top-n call.
"""

from __future__ import annotations

import functools


def state_unchanged(patch):
    """The fit loop returns its state unchanged."""
    import hpfrec_tpu_torch.ops.ell as E

    patch(E, "run_cavi_block_ell", lambda carry, *a, **k: carry)


def half_the_nonzeros(patch):
    """K1's sums over the first half of each side's segments, doubled, the
    rest dropped: the mean taken over half of the batch."""
    import hpfrec_tpu_torch.ops.ell as E

    orig = E.all_bucket_sums

    # the wrapper keeps the original's launch counters, which the card's
    # path adds to through the module's name (so do the serving faults)
    @functools.wraps(orig)
    def half(*a, **k):
        seg = orig(*a, **k)
        h = seg.shape[0] // 2
        seg[:h] *= 2
        seg[h:] = 0
        return seg

    patch(E, "all_bucket_sums", half)


def answer_altered(patch):
    """The fitted state copied back with its user shapes 10% off."""
    from hpfrec_tpu_torch import HPF

    orig = HPF._state_to_host

    def altered(self, state):
        return orig(self, state._replace(G_shp=state.G_shp * 1.1))

    patch(HPF, "_state_to_host", altered)


def half_the_users(patch):
    """The second half of each chunk gets the first half's lists."""
    import hpfrec_tpu_torch.ops.topk as T

    orig = T.topn_rows

    @functools.wraps(orig)
    def half(rows, *a, **k):
        vals, idx = orig(rows, *a, **k)
        h = idx.shape[0] // 2
        idx[h:2 * h] = idx[:h].clone()
        return vals, idx

    patch(T, "topn_rows", half)


def list_altered(patch):
    """Every list's n-th item replaced by the (n+1)-th best."""
    import torch

    import hpfrec_tpu_torch.ops.topk as T

    orig = T.topn_rows

    @functools.wraps(orig)
    def altered(rows, beta, mr, mi, n):
        vals, idx = orig(rows, beta, mr, mi, n + 1)
        keep = torch.cat([torch.arange(n - 1), torch.tensor([n])])
        return vals[:, keep].contiguous(), idx[:, keep].contiguous()

    patch(T, "topn_rows", altered)


FIT = {f.__name__: f for f in (state_unchanged, half_the_nonzeros, answer_altered)}
SERVING = {f.__name__: f for f in (half_the_users, list_altered)}
ALL = {**FIT, **SERVING}
