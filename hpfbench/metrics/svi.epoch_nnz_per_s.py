"""``svi.epoch_nnz_per_s``: training nonzeros times epochs over all the
traced window's fits, over the seconds of their epochs: the program's own
``hpf.fit.user_epochs`` / ``hpf.fit.item_epochs`` annotations (an epoch's
host part, K9 and its batches; the validation checks, the uploads and the
copy back outside), from the device trace.  Nothing where the trace holds
no such annotation."""


def read(run):
    fits = run.cell.fits
    if not fits or any(f.loop_span_s is None for f in fits):
        return None
    return run.cell.nnz * sum(f.iterations for f in fits) / sum(f.loop_span_s for f in fits)
