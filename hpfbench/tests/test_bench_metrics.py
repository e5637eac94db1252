"""The fit cells' rates: the end-to-end one over the window's whole time,
the loop's over the traced loop spans, and nothing where nothing was read."""

import pytest

from hpfbench import spec
from hpfbench.kinds.cavi_fit import Fit


class _Cell:
    def __init__(self, fits, window_s, nnz=1000):
        self.fits, self.window_s, self.nnz = fits, window_s, nnz


class _Run:
    def __init__(self, cell):
        self.cell = cell


def test_the_fit_rate_is_taken_over_the_whole_window():
    fits = [Fit(2.0, 110, {}), Fit(2.5, 110, {})]
    # the window holds the fits and the gaps between them
    got = spec.reader("cavi_nnz_per_s")(_Run(_Cell(fits, 5.0)))
    assert got == pytest.approx(1000 * 220 / 5.0)


def test_the_loop_rate_reads_the_traced_loops_only():
    read = spec.reader("cavi.loop_nnz_per_s")
    assert read(_Run(_Cell([Fit(2.0, 110, {})], 2.0))) is None
    fits = [Fit(2.0, 110, {}, loop_span_s=0.5), Fit(2.5, 20, {}, loop_span_s=0.1)]
    assert read(_Run(_Cell(fits, 5.0))) == pytest.approx(1000 * 130 / 0.6)


def test_no_fit_reads_nothing():
    assert spec.reader("cavi_nnz_per_s")(_Run(_Cell([], None))) is None
