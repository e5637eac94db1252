"""The card's idle time inside the program's own spans (annotations of a
traced window), as sorted, disjoint (start, end) intervals."""

from __future__ import annotations

from .trace import gaps, within


def union(spans) -> list:
    """The sorted, disjoint intervals that ``spans`` (``trace.Span``) cover."""
    out = []
    for s in sorted(spans, key=lambda sp: sp.start):
        a, b = s.start, s.end
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def intersect(x: list, y: list) -> list:
    """Where two sorted, disjoint interval lists both hold."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(x: list) -> float:
    return sum(b - a for a, b in x)


def idle(run) -> list:
    """The card's idle intervals in the traced window."""
    lo, hi = run.window
    return gaps(within(run.trace.device, lo, hi), lo, hi)


def named(run, name: str, prefix: bool = False) -> list:
    """The window's annotations called ``name`` (or, with ``prefix``,
    whose names start with it)."""
    lo, hi = run.window
    return [a for a in within(run.trace.annotations, lo, hi)
            if (a.name.startswith(name) if prefix else a.name == name)]
