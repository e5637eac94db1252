"""``cavi.idle_share``: the share of the fit loops' seconds (each fit's
first kernel start to its last kernel end) in which nothing ran on the
card, in %, from the device trace."""


def read(run):
    fits = run.cell.fits
    if not fits or any(f.loop_span_s is None for f in fits):
        return None
    span = sum(f.loop_span_s for f in fits)
    return 100.0 * (1.0 - sum(f.loop_busy_s for f in fits) / span)
