"""``topn.k6_roofline``: K6's share of its roofline, in %: the least time
of ranking the window's users (``hpfbench.work.topn``) over the time of the
fused top-n kernel in the device trace (names holding ``topn_fused``).
Nothing when the calls launch no such kernel."""

from hpfbench.trace import within
from hpfbench.work import topn
from hpfbench.work.peaks import least_seconds

KERNEL = "topn_fused"


def read(run):
    cell = run.cell
    if run.trace is None or not cell.calls:
        return None
    lo, hi = run.window
    secs = sum(k.end - k.start for k in within(run.trace.kernels, lo, hi) if KERNEL in k.name)
    if secs <= 0:
        return None
    cfg = cell.cfg
    least = sum(least_seconds(*topn.call(c.users, int(cfg["n_items"]), int(cfg["k"]), cell.n))
                for c in cell.calls)
    return 100.0 * least / secs
