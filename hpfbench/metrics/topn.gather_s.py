"""``topn.gather_s``: the seconds a call of the program's own
``hpf.topN_batch.gather`` spans (a chunk's Theta rows indexed on the host
and copied to the card), on the device trace's clock: their total in the
traced window over the window's ``hpf.topN_batch`` calls.  Nothing where
the trace holds no such span."""

from hpfbench.spans import named

CALL = "hpf.topN_batch"
GATHER = CALL + ".gather"


def read(run):
    if run.trace is None:
        return None
    calls, gathers = named(run, CALL), named(run, GATHER)
    if not calls or not gathers:
        return None
    return sum(a.end - a.start for a in gathers) / len(calls)
