"""``topn.call_mfu``: a call's share of the card's peak, in %: the least
time of ranking its users (``hpfbench.work.topn``: 2 b n_items k operations
over 67 TFLOP/s, or its bytes over 3.35 TB/s, the larger) over the calls'
seconds on the host's clock."""

from hpfbench.work import topn
from hpfbench.work.peaks import least_seconds


def read(run):
    cell = run.cell
    if not cell.calls:
        return None
    cfg = cell.cfg
    least = sum(least_seconds(*topn.call(c.users, int(cfg["n_items"]), int(cfg["k"]), cell.n))
                for c in cell.calls)
    return 100.0 * least / sum(c.wall_s for c in cell.calls)
