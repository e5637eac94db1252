"""``svi.k7_roofline``: K7's share of its roofline, in %: the least time of
the phi sums of every batch the window's fits ran (``hpfbench.work.svi.
batch_phi_sums`` on each batch's shape, a batch at a time) over the time of
K7's kernels inside the fits' epochs in the device trace (``KERNELS``; the
wrapper's sort and fills are in neither).  Nothing when the epochs launch
no such kernel."""

from hpfbench.work import svi
from hpfbench.work.peaks import least_seconds

KERNELS = ("phi_chunk_kernel", "phi_group_kernel", "phi_local_finish_kernel",
           "run_bounds_kernel", "phi_other_finish_kernel")


def read(run):
    cell = run.cell
    fits = cell.fits
    if not fits or cell.shapes is None or any(f.kernels is None for f in fits):
        return None
    secs = sum(s for f in fits for name, s in f.kernels.items()
               if any(k in name for k in KERNELS))
    if secs <= 0:
        return None
    n_users, n_items, k = int(cell.cfg["n_users"]), int(cell.cfg["n_items"]), int(cell.cfg["k"])

    def epoch(shapes):
        return sum(least_seconds(*svi.batch_phi_sums(
            b.rows, b.slots, b.other_rows, *((n_users, n_items) if b.user_side
                                             else (n_items, n_users)), k)) for b in shapes)

    per_epoch = [epoch(shapes) for shapes in cell.shapes]
    return 100.0 * sum(sum(per_epoch[:f.iterations]) for f in fits) / secs
