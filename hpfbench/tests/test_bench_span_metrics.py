"""The readers of the program's own spans: the three fit phases from the
``Fit`` records, the fits' unexplained idle and the serving gather from a
traced window; nothing where the program has no such span, as a program
without them gives; and the names they look for are those the program
writes."""

import numpy as np
import pytest

from hpfbench import spec, trace as T
from hpfbench.kinds.cavi_fit import Fit

S = T.Span


class _Cell:
    def __init__(self, fits=(), calls=()):
        self.fits, self.calls = list(fits), list(calls)


class _Run:
    def __init__(self, cell=None, tr=None, window=None):
        self.cell, self.trace, self.window = cell or _Cell(), tr, window


@pytest.mark.parametrize("phase", ["init_state", "copy_back", "metadata"])
def test_a_fit_phase_is_its_mean_over_the_fits(phase):
    read = spec.reader("cavi.%s_s" % phase)
    fits = [Fit(5.0, 110, {"reindex": 0.7, phase: 0.4}), Fit(5.2, 110, {phase: 0.6})]
    assert read(_Run(_Cell(fits))) == pytest.approx(0.5)


@pytest.mark.parametrize("phase", ["init_state", "copy_back", "metadata"])
def test_a_fit_phase_reads_nothing_without_the_span(phase):
    read = spec.reader("cavi.%s_s" % phase)
    # the phases a program without the spans records
    old = {"reindex": 0.7, "host_pack": 0.9, "transfer": 0.2, "iterations": 0.9}
    assert read(_Run(_Cell([Fit(5.0, 110, old)]))) is None
    assert read(_Run(_Cell([]))) is None


def _fit_trace(with_phases=True):
    """Two fits in a 0-20 s window.  The first: the card runs 2-3 and 4-6;
    the host's phases cover 0.5-2 and 3-4 (and 6-7, where the card runs
    nothing). The second: the card runs 12-13; a phase covers 10.5-11."""
    dev = [S("k", 2.0, 3.0), S("k", 4.0, 6.0), S("k", 12.0, 13.0)]
    ann = [S("hpfbench.window", 0.0, 20.0), S("hpfbench.fit", 0.0, 8.0),
           S("hpfbench.fit", 10.0, 14.0)]
    if with_phases:
        ann += [S("hpf.fit", 0.1, 7.9), S("hpf.fit.reindex", 0.5, 2.0),
                S("hpf.fit.transfer", 3.0, 4.0), S("hpf.fit.copy_back", 6.0, 7.0),
                S("hpf.fit", 10.1, 13.9), S("hpf.fit.reindex", 10.5, 11.0)]
    return T.Trace(device=dev, annotations=sorted(ann, key=lambda a: a.start), kernels=dev)


def test_the_unexplained_idle_is_the_idle_card_outside_every_phase():
    read = spec.reader("cavi.unexplained_idle_s")
    # first fit idle 0-2, 3-4, 6-8 (5 s), phases cover 1.5 + 1 + 1: 1.5 s left;
    # second idle 10-12, 13-14 (3 s), a phase covers 0.5: 2.5 s left
    got = read(_Run(tr=_fit_trace(), window=(0.0, 20.0)))
    assert got == pytest.approx((1.5 + 2.5) / 2)


def test_the_unexplained_idle_reads_nothing_without_the_spans():
    read = spec.reader("cavi.unexplained_idle_s")
    assert read(_Run(tr=_fit_trace(with_phases=False), window=(0.0, 20.0))) is None
    assert read(_Run()) is None


def _call_trace(with_spans=True):
    """Two calls. Each: a gather 0.0-0.3 with a copy 0.2-0.3 on the card,
    a rank 0.3-0.35 and a fetch to 1.0 with K6 0.35-0.9."""
    dev, ann = [], [S("hpfbench.window", 0.0, 10.0)]
    for t in (1.0, 3.0):
        dev += [S("Memcpy HtoD", t + 0.2, t + 0.3), S("topn_fused", t + 0.35, t + 0.9)]
        ann.append(S("hpfbench.topN_batch", t - 0.05, t + 1.05))
        if with_spans:
            ann += [S("hpf.topN_batch", t - 0.01, t + 1.01), S("hpf.topN_batch.gather", t, t + 0.3),
                    S("hpf.topN_batch.rank", t + 0.3, t + 0.35),
                    S("hpf.topN_batch.fetch", t + 0.35, t + 1.0)]
    return T.Trace(device=dev, annotations=sorted(ann, key=lambda a: a.start),
                   kernels=[d for d in dev if d.name == "topn_fused"])


def test_the_gather_reads_its_spans_a_call():
    run = _Run(tr=_call_trace(), window=(0.0, 10.0))
    assert spec.reader("topn.gather_s")(run) == pytest.approx(0.3)
    assert spec.reader("topn.gather_idle_s")(run) == pytest.approx(0.2)


@pytest.mark.parametrize("name", ["topn.gather_s", "topn.gather_idle_s"])
def test_the_gather_reads_nothing_without_the_spans(name):
    read = spec.reader(name)
    assert read(_Run(tr=_call_trace(with_spans=False), window=(0.0, 10.0))) is None
    assert read(_Run()) is None


def _profiled(work, tmp_path):
    """``work()`` under a CPU profiler, read back as the benchmark reads a
    traced window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("hpfbench.window"):
            work()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tr = T.read_chrome(str(path))
    win = next(a for a in tr.annotations if a.name == "hpfbench.window")
    return _Run(tr=tr, window=(win.start, win.end))


def test_the_readers_find_the_programs_spans(tmp_path):
    from scipy.sparse import coo_array
    from torch.profiler import record_function

    from hpfrec_tpu_torch import HPF

    rng = np.random.default_rng(1)
    X = coo_array((rng.poisson(2, 3000) + 1.0, (rng.integers(60, size=3000),
                                                rng.integers(50, size=3000))), shape=(60, 50))
    model = HPF(k=4, maxiter=10, check_every=5, stop_crit="train-llk", verbose=False,
                device="cpu")

    def work():
        with record_function("hpfbench.fit"):
            model.fit(X)
        for _ in range(2):
            with record_function("hpfbench.topN_batch"):
                model.topN_batch(np.arange(60), n=5, exclude_seen=False)

    run = _profiled(work, tmp_path)
    # a CPU trace has no device ops: the card idles throughout, so what is
    # unexplained is the fit's time outside its phases
    fit = next(a for a in run.trace.annotations if a.name == "hpfbench.fit")
    st = model.fit_stats_
    got = spec.reader("cavi.unexplained_idle_s")(run)
    assert 0 < got < (fit.end - fit.start) - 0.9 * sum(st.phases.values())
    gather = spec.reader("topn.gather_s")(run)
    assert 0 < gather == pytest.approx(spec.reader("topn.gather_idle_s")(run))
    run.cell = _Cell([Fit(st.wall_seconds, st.iterations, dict(st.phases))])
    for phase in ("init_state", "copy_back", "metadata"):
        assert spec.reader("cavi.%s_s" % phase)(run) == st.phases[phase]
