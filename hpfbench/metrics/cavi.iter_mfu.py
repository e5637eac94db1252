"""``cavi.iter_mfu``: the whole fit loop's share of the card's peak, in %:
the least time of its iterations and train-llk checks
(``hpfbench.work.cavi``: the larger of bytes over 3.35 TB/s and operations
over 67 TFLOP/s, a piece at a time) over the loops' seconds on the card."""

from hpfbench.work import cavi
from hpfbench.work.peaks import least_seconds


def read(run):
    cell = run.cell
    fits = cell.fits
    if not fits or any(f.loop_span_s is None for f in fits):
        return None
    cfg = cell.cfg
    shape = (int(cfg["n_users"]), int(cfg["n_items"]), cell.nnz, int(cfg["k"]))
    it = least_seconds(*cavi.iteration(*shape))
    chk = least_seconds(*cavi.llk_check(*shape))
    every = int(cell.traffic["fit"]["check_every"])
    least = sum(f.iterations * it + (f.iterations // every) * chk for f in fits)
    return 100.0 * least / sum(f.loop_span_s for f in fits)
