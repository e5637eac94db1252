"""``cavi_nnz_per_s``: nonzeros times iterations over all the window's fits,
over the window's seconds on the benchmark's clock (its first fit's start
to its last fit's end: every fit whole, ingest, packing, the copies and
the host work after the loop included)."""


def read(run):
    cell = run.cell
    if not cell.fits or not cell.window_s:
        return None
    return cell.nnz * sum(f.iterations for f in cell.fits) / cell.window_s
