"""``svi.idle_share``: the share of the fits' epochs (the program's
``hpf.fit.user_epochs`` / ``hpf.fit.item_epochs`` annotations) in which
nothing ran on the card, in %, from the device trace: the host's part of
each epoch (``epoch_offsets``) and the gaps between the batches' launches."""


def read(run):
    fits = run.cell.fits
    if not fits or any(f.loop_span_s is None for f in fits):
        return None
    span = sum(f.loop_span_s for f in fits)
    return 100.0 * (1.0 - sum(f.loop_busy_s for f in fits) / span)
