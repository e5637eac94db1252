"""``cavi.metadata_s``: the mean seconds a fit of the program's own
``fit_stats_`` phase ``metadata``: the seen-items CSR that ``keep_data``
keeps for serving, and the id dicts.  Nothing where a fit has no such
phase."""

PHASE = "metadata"


def read(run):
    fits = run.cell.fits
    if not fits or any(PHASE not in f.phases for f in fits):
        return None
    return sum(f.phases[PHASE] for f in fits) / len(fits)
