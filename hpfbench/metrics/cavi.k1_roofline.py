"""``cavi.k1_roofline``: K1's share of its roofline, in %: the least time
of both sides' phi sums of every iteration (``hpfbench.work.cavi.phi_sums``)
over the time of K1's kernels in the device trace (names holding
``ell_phi_sums``; K2's reassembly is counted in the bound, not in the
time).  Nothing when the loop launches no such kernel."""

from hpfbench.work import cavi
from hpfbench.work.peaks import least_seconds

KERNEL = "ell_phi_sums"


def read(run):
    cell = run.cell
    fits = cell.fits
    if not fits or any(f.kernels is None for f in fits):
        return None
    secs = sum(s for f in fits for name, s in f.kernels.items() if KERNEL in name)
    if secs <= 0:
        return None
    cfg = cell.cfg
    per = least_seconds(*cavi.phi_sums(int(cfg["n_users"]), int(cfg["n_items"]), cell.nnz,
                                       int(cfg["k"])))
    return 100.0 * per * sum(f.iterations for f in fits) / secs
