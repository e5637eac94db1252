"""``cavi.fit_wall_s``: the mean seconds of a whole ``HPF.fit`` call, on
the benchmark's clock (started after a synchronize; the call ends with the
state's copy back to the host)."""


def read(run):
    fits = run.cell.fits
    if not fits:
        return None
    return sum(f.wall_s for f in fits) / len(fits)
