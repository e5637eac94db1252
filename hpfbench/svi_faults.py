"""Faults planted in the program's SVI epochs under a whole run, for the
readings that set the SVI cell's limits and for the tests that see
``correct`` come out false; ``faults.py``'s form, ``fault(patch)``, where
``patch(obj, name, value)`` replaces an attribute.  ``hpfbench.control``
knows only ``faults.ALL``, so a reading plants one of these first and then
runs the ``program`` arm::

    python3 -c "from hpfbench import control, svi_faults; \\
        svi_faults.ALL['<name>'](setattr); \\
        control.readings('<cell>', 'program', [<seed>, ...])"

``faults.answer_altered`` (the state copied back 10% off) applies to an
SVI fit as it is.
"""

from __future__ import annotations

import functools


def epochs_unchanged(patch):
    """Every epoch returns the state it was given."""
    import hpfrec_tpu_torch.ops.svi as S

    patch(S, "svi_run_epoch", lambda state, *a, **k: state)


def half_the_segments(patch):
    """K7's batch sums over the first half of each side's rows doubled, the
    rest dropped."""
    import hpfrec_tpu_torch.ops.svi as S

    orig = S.batch_phi_sums

    # the wrapper keeps the original's launch counter
    @functools.wraps(orig)
    def half(*a, **k):
        s_loc, s_oth, omask = orig(*a, **k)
        for seg in (s_loc, s_oth):
            h = seg.shape[0] // 2
            seg[:h] *= 2
            seg[h:] = 0
        return s_loc, s_oth, omask

    patch(S, "batch_phi_sums", half)


ALL = {f.__name__: f for f in (epochs_unchanged, half_the_segments)}
