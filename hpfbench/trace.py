"""The device trace: ``torch.profiler`` around a region, read back from its
Chrome trace.

``DeviceTrace`` records the card's activity (kernels, copies, fills), the
host's operators and the benchmark's own annotations (``torch.profiler.
record_function``); only the traced runs take one.  Times are in seconds
on the trace's clock, on which the host and the card agree.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Span(NamedTuple):
    name: str
    start: float
    end: float


class Trace(NamedTuple):
    device: list  # Span of every kernel, copy and fill, by start
    annotations: list  # Span of every benchmark annotation (host), by start
    kernels: list  # the device Spans that are kernels


class DeviceTrace:
    """Context manager: profile the region, then ``.trace`` holds it."""

    def __init__(self):
        self.trace = None
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                self.trace = read_chrome(path)
            finally:
                os.unlink(path)
        self._prof = None
        return False


def read_chrome(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    device, annotations, kernels = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = Span(e.get("name", ""), float(e["ts"]) * 1e-6,
                 (float(e["ts"]) + float(e["dur"])) * 1e-6)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(s)
            if cat == "kernel":
                kernels.append(s)
        elif cat == "user_annotation":
            annotations.append(s)
    key = lambda sp: sp.start  # noqa: E731
    return Trace(sorted(device, key=key), sorted(annotations, key=key),
                 sorted(kernels, key=key))


def within(spans, lo: float, hi: float) -> list:
    """The spans that start in [lo, hi]."""
    return [s for s in spans if lo <= s.start <= hi]


def busy(spans, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by at least one span."""
    total, cur_s, cur_e = 0.0, None, None
    for s in sorted(spans, key=lambda sp: sp.start):
        a, b = max(s.start, lo), min(s.end, hi)
        if b <= a:
            continue
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(spans, lo: float, hi: float) -> list:
    """The idle intervals of [lo, hi]: (start, end) where no span runs."""
    out, t = [], lo
    for s in sorted(spans, key=lambda sp: sp.start):
        if s.end <= t:
            continue
        if s.start > t:
            out.append((t, min(s.start, hi)))
        t = max(t, s.end)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def by_name(spans) -> dict:
    """Total seconds a name."""
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end - s.start)
    return out


def breakdown(tr: Trace, lo: float, hi: float, owners=None, top: int = 10) -> dict:
    """The device operations that took most time in [lo, hi], and the
    longest idle time by what the host was doing: inside which of the
    ``owners`` annotations (the benchmark's calls; all annotations if
    None), before its first device operation, between two, or after its
    last; or between them."""
    import bisect

    dev = within(tr.device, lo, hi)
    ops = sorted(by_name(dev).items(), key=lambda kv: -kv[1])[:top]
    annots = sorted((a for a in (tr.annotations if owners is None else owners)
                     if a.end >= lo and a.start <= hi), key=lambda a: a.start)
    starts = [s.start for s in dev]
    a_starts = [a.start for a in annots]
    edges = []
    for a in annots:
        i, j = bisect.bisect_left(starts, a.start), bisect.bisect_right(starts, a.end)
        edges.append((starts[i], max(s.end for s in dev[i:j])) if j > i else None)
    bounds = sorted({t for x in annots for t in (x.start, x.end)})
    cats = {}
    for a, b in gaps(dev, lo, hi):
        # a gap is split where an annotation starts or ends inside it
        cuts = [a] + bounds[bisect.bisect_right(bounds, a):bisect.bisect_left(bounds, b)] + [b]
        for p, q in zip(cuts[:-1], cuts[1:]):
            mid = (p + q) / 2
            j = bisect.bisect_right(a_starts, mid) - 1
            if j < 0 or annots[j].end < mid:
                cat = "between calls"
            else:
                name, edge = annots[j].name, edges[j]
                if edge is None or mid < edge[0]:
                    cat = "%s: before its first device op" % name
                elif mid > edge[1]:
                    cat = "%s: after its last device op" % name
                else:
                    cat = "%s: between device ops" % name
            n, tot, longest = cats.get(cat, (0, 0.0, 0.0))
            cats[cat] = (n + 1, tot + (q - p), max(longest, q - p))
    idle = sorted(cats.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[name, sec] for name, sec in ops],
            "idle_gaps": [["%s (%d gaps, longest %.6f s)" % (c, n, lg), tot]
                          for c, (n, tot, lg) in idle]}
