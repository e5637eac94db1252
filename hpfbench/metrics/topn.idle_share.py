"""``topn.idle_share``: the share of the traced window in which nothing ran
on the card, in %."""

from hpfbench.trace import busy, within


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.window
    return 100.0 * (1.0 - busy(within(run.trace.device, lo, hi), lo, hi) / (hi - lo))
