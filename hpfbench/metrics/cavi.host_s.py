"""``cavi.host_s``: the host data layer's seconds a fit, the mean over the
window's fits of the program's own ``fit_stats_`` phases ``reindex``
(triplet ingest and the user sort), ``host_pack`` (CSR builds and ELL
packing) and ``transfer`` (the layouts' and the state's copies to the
card)."""

PHASES = ("reindex", "host_pack", "transfer")


def read(run):
    fits = run.cell.fits
    if not fits:
        return None
    return sum(sum(f.phases.get(p, 0.0) for p in PHASES) for f in fits) / len(fits)
