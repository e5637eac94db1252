"""An SVI fit's own accounting: ``fit_stats_.batches`` counts the batches
its epochs ran, each epoch's host part (the shuffle, the offsets and their
uploads) is the ``epoch_offsets`` phase inside the epoch's phase, and under
a ``torch.profiler`` that phase is ``hpf.fit.epoch_offsets`` inside
``hpf.fit.user_epochs`` / ``hpf.fit.item_epochs``; a full-batch fit has
neither, and recording changes no bit of the fit."""

import json

import numpy as np
import pytest
from scipy.sparse import coo_array

from hpfrec_tpu_torch import HPF

NU, NI, K = 300, 120, 7
BATCHES = dict(users_per_batch=64, items_per_batch=25)


def _pairs(seed=5):
    """About 3,000 (user, item, count) pairs, 10% of them held out."""
    rng = np.random.default_rng(seed)
    X = coo_array((rng.poisson(2, 3100) + 1.0, (rng.integers(NU, size=3100),
                                                rng.integers(NI, size=3100))), shape=(NU, NI))
    X.sum_duplicates()
    X = X.tocoo()
    val = rng.random(X.nnz) < 0.1
    part = lambda m: coo_array((X.data[m], (X.row[m], X.col[m])), shape=(NU, NI))  # noqa: E731
    return part(~val), part(val)


def _svi(**kw):
    kw = dict(dict(k=K, maxiter=6, check_every=2, stop_crit="val-llk", stop_thr=1e-12,
                   random_seed=11, verbose=False, device="cpu", **BATCHES), **kw)
    return HPF(**kw)


def _fit(model):
    train, val = _pairs()
    return model.fit(train, val_set=val)


def _profiled(work, path):
    """(name, start, end) of the user annotations of ``work()`` under a CPU
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("maxiter", [1, 4, 5])
def test_batches_counts_every_epochs_batches(maxiter):
    m = _fit(_svi(maxiter=maxiter, check_every=1, stop_crit="maxiter"))
    epochs = m.fit_stats_.iterations
    assert epochs == maxiter
    # the item epoch first, then they alternate
    item_epochs, user_epochs = -(-epochs // 2), epochs // 2
    assert m.fit_stats_.batches == (item_epochs * -(-NI // BATCHES["items_per_batch"])
                                    + user_epochs * -(-NU // BATCHES["users_per_batch"]))


@pytest.mark.parametrize("side", ["users_per_batch", "items_per_batch"])
def test_batches_of_one_sided_epochs(side):
    other = "items_per_batch" if side == "users_per_batch" else "users_per_batch"
    m = _fit(_svi(stop_crit="maxiter", **{side: BATCHES[side], other: None}))
    rows = NU if side == "users_per_batch" else NI
    assert m.fit_stats_.batches == m.fit_stats_.iterations * -(-rows // BATCHES[side])


def test_epoch_offsets_is_a_phase_inside_the_epochs():
    st = _fit(_svi()).fit_stats_
    assert {"epoch_offsets", "user_epochs", "item_epochs"} <= set(st.phases)
    assert 0 < st.phases["epoch_offsets"] <= st.phases["user_epochs"] + st.phases["item_epochs"]
    assert 0 <= st.unattributed_seconds
    assert "batches %d" % st.batches in st.phase_report()


def test_epoch_offsets_nests_in_an_epoch_on_the_trace(tmp_path):
    m = _svi()
    annots = _profiled(lambda: _fit(m), tmp_path / "t.json")
    epochs = [(a, b) for n, a, b in annots
              if n in ("hpf.fit.user_epochs", "hpf.fit.item_epochs")]
    offsets = [(a, b) for n, a, b in annots if n == "hpf.fit.epoch_offsets"]
    assert len(epochs) == len(offsets) == m.fit_stats_.iterations
    for a, b in offsets:
        assert sum(ea <= a and b <= eb for ea, eb in epochs) == 1


@pytest.mark.parametrize("engine", ["ell", "coo"])
def test_a_full_batch_fit_runs_no_batches(engine):
    train, val = _pairs()
    m = HPF(k=K, maxiter=4, check_every=2, stop_crit="val-llk", random_seed=11, verbose=False,
            device="cpu", engine=engine).fit(train, val_set=val)
    assert m.fit_stats_.batches == 0
    assert "epoch_offsets" not in m.fit_stats_.phases


def test_recording_changes_no_bit_of_the_fit(tmp_path):
    plain = _fit(_svi())
    traced = _svi()
    _profiled(lambda: _fit(traced), tmp_path / "t.json")
    for name in ("Theta", "Beta", "Gamma_shp", "Gamma_rte", "Lambda_shp", "Lambda_rte",
                 "k_rte", "t_rte"):
        assert np.array_equal(getattr(plain, name), getattr(traced, name)), name
    assert plain.train_llk == traced.train_llk
    assert plain.fit_stats_.batches == traced.fit_stats_.batches
