"""``cavi.unexplained_idle_s``: the seconds a fit in which the card idles
while the host is in none of the program's fit phases: inside each
``hpfbench.fit`` annotation of the traced window, the card's idle time
that no ``hpf.fit.<phase>`` span of the program covers, the mean over the
fits, from the device trace.  Nothing where the trace holds no such span."""

from hpfbench.spans import idle, intersect, length, named, union

FIT = "hpfbench.fit"
PHASE = "hpf.fit."


def read(run):
    if run.trace is None:
        return None
    fits = named(run, FIT)
    phases = named(run, PHASE, prefix=True)
    if not fits or not phases:
        return None
    in_fits = intersect(idle(run), union(fits))
    return (length(in_fits) - length(intersect(in_fits, union(phases)))) / len(fits)
