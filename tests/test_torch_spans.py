"""The port's per-call accounting: ``fit_stats_`` covers a fit from entry
to return in named phases with its counters, ``topn_stats_`` a
``topN_batch`` call; under a ``torch.profiler`` each phase is an
annotation nested in its call's, and with no profiler none is entered."""

import json
import time

import numpy as np
import pytest
import torch
from scipy.sparse import coo_array

from hpfrec_tpu_torch import HPF
from hpfrec_tpu_torch.ops import topk
from hpfrec_tpu_torch.utils import profiling

FITS = {"ell": dict(), "coo": dict(engine="coo"),
        "svi": dict(users_per_batch=20, items_per_batch=15)}
NEW_PHASES = {"init_state", "copy_back", "metadata"}


def _counts(nU=80, nI=60, nnz=2500, seed=1):
    rng = np.random.default_rng(seed)
    X = coo_array((rng.poisson(2, nnz) + 1.0, (rng.integers(nU, size=nnz),
                                               rng.integers(nI, size=nnz))), shape=(nU, nI))
    X.sum_duplicates()
    return X


def _model(**kw):
    kw = dict(dict(k=5, maxiter=12, check_every=4, stop_crit="train-llk", stop_thr=1e-12,
                   random_seed=3, verbose=False, device="cpu"), **kw)
    return HPF(**kw)


def _profiled(work, path):
    """The user annotations of ``work()`` run under a CPU profiler, as
    (name, start, end) in microseconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("cat") == "user_annotation"]


def _nested(annots, root):
    """The children's names, each asserted inside one ``root`` span."""
    roots = [(a, b) for n, a, b in annots if n == root]
    kids = [(n, a, b) for n, a, b in annots if n.startswith(root + ".")]
    for n, a, b in kids:
        assert any(ra <= a and b <= rb for ra, rb in roots), n
    return {n[len(root) + 1:] for n, _, _ in kids}


@pytest.mark.parametrize("mode", sorted(FITS))
def test_a_fit_is_accounted_from_entry_to_return(mode):
    m = _model(**FITS[mode]).fit(_counts())
    st = m.fit_stats_
    assert set(st.phases) >= NEW_PHASES | {"reindex", "transfer", "metric_checks"}
    assert st.unattributed_seconds >= 0
    assert st.iterations == m.niter + 1 and st.nnz == _counts().nnz
    assert st.checks == 3
    state = (m.Gamma_shp, m.Gamma_rte, m.Lambda_shp, m.Lambda_rte, m.k_rte, m.t_rte)
    # copied back: Theta and Beta, the state, the seen-items CSR's entries;
    # none of it through the card's pinned ring on a CPU fit
    back = (m.Theta, m.Beta) + state + (m.seen,)
    assert st.bytes_to_host == sum(a.nbytes for a in back)
    assert st.staged_bytes == 0
    assert st.bytes_to_device >= sum(a.nbytes for a in state)


def test_the_wall_covers_the_copy_back(monkeypatch):
    orig = HPF._state_to_host

    def slow(self, state):
        time.sleep(0.3)
        return orig(self, state)

    monkeypatch.setattr(HPF, "_state_to_host", slow)
    st = _model().fit(_counts()).fit_stats_
    assert st.phases["copy_back"] >= 0.3
    assert st.wall_seconds >= sum(st.phases.values()) >= 0.3
    assert st.nnz_per_second == pytest.approx(st.nnz * st.iterations / st.wall_seconds)


def test_save_folder_is_its_own_phase(tmp_path):
    st = _model(save_folder=str(tmp_path)).fit(_counts()).fit_stats_
    assert "save" in st.phases and (tmp_path / "Theta").exists()
    assert "save" not in _model().fit(_counts()).fit_stats_.phases


def test_the_verbose_breakdown_prints_the_counters(capsys):
    _model(verbose=True).fit(_counts())
    out = capsys.readouterr().out
    tail = out[out.index("Wall-time breakdown:"):]
    assert "copy_back" in tail and "init_state" in tail
    assert "checks 3" in tail and "bytes_to_host" in tail and "bytes_to_device" in tail
    assert "staged_bytes 0" in tail


@pytest.mark.parametrize("mode", sorted(FITS))
def test_a_fits_phases_nest_in_its_annotation(mode, tmp_path):
    m = _model(**FITS[mode])
    annots = _profiled(lambda: m.fit(_counts()), tmp_path / "t.json")
    kids = _nested(annots, "hpf.fit")
    assert kids == set(m.fit_stats_.phases) and kids >= NEW_PHASES
    assert sum(n == "hpf.fit" for n, _, _ in annots) == 1


@pytest.mark.parametrize("masked", [False, True])
def test_topn_batch_leaves_its_stats(masked, monkeypatch):
    m = _model().fit(_counts())
    # chunks of 16 users
    monkeypatch.setattr(topk, "_CHUNK_BYTES", 16 * (4 * 2 + 8 * topk._SMEM_CAND))
    users = np.arange(50)
    step = topk._chunk_rows(users.shape[0], m.nitems, 4)
    assert step == 16
    rows = users.shape[0] * m.k * m.Theta.itemsize
    pairs = 2 * 4 * int(m._n_seen_by_user[users].sum()) if masked else 0
    # the first call after a fit uploads Beta, the next finds it cached
    for beta in (m.Beta.nbytes, 0):
        idx = m.topN_batch(users, n=4, exclude_seen=masked)
        st = m.topn_stats_
        assert isinstance(st, profiling.CallStats) and idx.shape == (50, 4)
        assert st.users == users.shape[0] and st.chunks == -(-users.shape[0] // step)
        assert st.bytes_to_device == rows + pairs + beta
        assert st.bytes_to_host == users.shape[0] * 4 * (4 + 4)
        assert set(st.phases) == {"rows", "beta", "gather", "rank", "fetch"}
        assert sum(st.phases.values()) <= st.wall_seconds


def test_topn_batch_phases_nest_in_its_annotation(tmp_path):
    m = _model().fit(_counts())
    annots = _profiled(lambda: m.topN_batch(np.arange(30), n=4), tmp_path / "t.json")
    assert _nested(annots, "hpf.topN_batch") == {"rows", "beta", "gather", "rank", "fetch"}


def test_no_annotation_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for mode in sorted(FITS):
        m = _model(**FITS[mode]).fit(_counts())
    m.topN_batch(np.arange(30), n=4)
    with pytest.raises(AssertionError):
        torch.profiler.record_function("x")


def test_device_bytes_counts_a_storage_once():
    dev = torch.device("cpu")
    a = torch.zeros(10, dtype=torch.float32)
    b = torch.zeros((3, 4), dtype=torch.float64)
    assert profiling.device_bytes(dev, a, a[2:], (b, [b.T, None])) == 40 + 96
    assert profiling.device_bytes(torch.device("cuda"), a, b) == 0
