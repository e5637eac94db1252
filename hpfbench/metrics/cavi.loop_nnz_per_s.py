"""``cavi.loop_nnz_per_s``: nonzeros times iterations over all the traced
window's fits, over the seconds of their loops on the card (each fit's
first kernel start to its last kernel end, from the device trace)."""


def read(run):
    fits = run.cell.fits
    if not fits or any(f.loop_span_s is None for f in fits):
        return None
    return run.cell.nnz * sum(f.iterations for f in fits) / sum(f.loop_span_s for f in fits)
