"""``svi.offsets_s``: the mean seconds a fit of the program's own
``fit_stats_`` phase ``epoch_offsets``: each epoch's host part (the
shuffle, the permuted rows' offsets, the permutation's and the offsets'
uploads), summed over the fit's epochs.  Nothing where a fit has no such
phase."""

PHASE = "epoch_offsets"


def read(run):
    fits = run.cell.fits
    if not fits or any(PHASE not in f.phases for f in fits):
        return None
    return sum(f.phases[PHASE] for f in fits) / len(fits)
