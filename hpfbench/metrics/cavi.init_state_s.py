"""``cavi.init_state_s``: the mean seconds a fit of the program's own
``fit_stats_`` phase ``init_state``: the state's seeded start on the host
(the MT19937 draws of the shape and rate tables), before its copy to the
card.  Nothing where a fit has no such phase."""

PHASE = "init_state"


def read(run):
    fits = run.cell.fits
    if not fits or any(PHASE not in f.phases for f in fits):
        return None
    return sum(f.phases[PHASE] for f in fits) / len(fits)
