"""``cavi.copy_back_s``: the mean seconds a fit of the program's own
``fit_stats_`` phase ``copy_back``: the state's copy from the card to the
host, and Theta's and Beta's divisions there.  Nothing where a fit has no
such phase."""

PHASE = "copy_back"


def read(run):
    fits = run.cell.fits
    if not fits or any(PHASE not in f.phases for f in fits):
        return None
    return sum(f.phases[PHASE] for f in fits) / len(fits)
