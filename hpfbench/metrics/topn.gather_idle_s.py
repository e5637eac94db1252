"""``topn.gather_idle_s``: the seconds a call in which the card idles
inside the program's own ``hpf.topN_batch.gather`` spans (the host
indexing a chunk's Theta rows and copying them), from the device trace:
their idle time in the traced window over the window's ``hpf.topN_batch``
calls.  Nothing where the trace holds no such span."""

from hpfbench.spans import idle, intersect, length, named, union

CALL = "hpf.topN_batch"
GATHER = CALL + ".gather"


def read(run):
    if run.trace is None:
        return None
    calls, gathers = named(run, CALL), named(run, GATHER)
    if not calls or not gathers:
        return None
    return length(intersect(idle(run), union(gathers))) / len(calls)
