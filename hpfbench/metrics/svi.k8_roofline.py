"""``svi.k8_roofline``: K8's share of its roofline, in %: the least time of
the whole-table blend of each batch the window's fits ran (``hpfbench.
work.svi.blend``; the program's ``fit_stats_.batches`` a fit, the side of
each from the fit's schedule) over the time of ``svi_pass_kernel`` inside
the fits' epochs in the device trace (``row_mask_kernel`` aside).  Nothing
where a fit has no such counter, or the epochs launch no such kernel."""

from hpfbench.work import svi
from hpfbench.work.peaks import least_seconds

KERNEL = "svi_pass_kernel"


def read(run):
    cell = run.cell
    fits = cell.fits
    if (not fits or cell.shapes is None or any(f.kernels is None for f in fits)
            or any(b is None for b in cell.batches)):
        return None
    secs = sum(s for f in fits for name, s in f.kernels.items() if KERNEL in name)
    if secs <= 0:
        return None
    n_users, n_items, k = int(cell.cfg["n_users"]), int(cell.cfg["n_items"]), int(cell.cfg["k"])
    sides = [b.user_side for shapes in cell.shapes for b in shapes]
    per = {True: least_seconds(*svi.blend(n_users, n_items, k)),
           False: least_seconds(*svi.blend(n_items, n_users, k))}
    return 100.0 * sum(per[s] for n in cell.batches for s in sides[:n]) / secs
