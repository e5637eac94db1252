"""The SVI cell at a size a test run holds, on the CPU: the program's SVI fit
against the float64 reference (``reference/svi.py``), the cell's
``correct`` and what turns it false, the readers of its metrics, its work
counts against counts made by hand, and its hold-out and batch shapes."""

import itertools

import numpy as np
import pytest
import torch
from scipy.sparse import coo_array

from hpfbench import faults, run, spec, svi_faults
from hpfbench.kinds import svi_fit
from hpfbench.kinds.cavi_fit import Fit
from hpfbench.reference.hpf import Prior, initial_state
from hpfbench.reference.svi import SVI, batches, schedule
from hpfbench.trace import Span, Trace
from hpfbench.work import svi as W
from hpfbench.work.peaks import least_seconds

BENCH = spec.load_spec()
NAME = "tasteprofile-full-k50.svi"
WORKLOAD = spec.workload(BENCH, NAME)
# the configuration's widths but k, the scale cut; batches of a fifth of
# the users and a quarter of the items
SIZE = dict(n_users=600, n_items=400, nnz=9000, k=8)
FIT = dict(users_per_batch=128, items_per_batch=100, maxiter=10)


def small_config():
    return dict(spec.config(WORKLOAD["config"]), **SIZE)


def small_traffic():
    t = spec.traffic(WORKLOAD["traffic"])
    return dict(t, fit=dict(t["fit"], **FIT))


def run_small(seed=11):
    return run.run_cell(BENCH, WORKLOAD, seed, 0.0, device="cpu", cfg=small_config(),
                        traffic=small_traffic())


def _triplets(nU, nI, nnz, seed):
    rng = np.random.default_rng(seed)
    X = coo_array((rng.poisson(2, nnz) + 1.0, (rng.integers(nU, size=nnz),
                                               rng.integers(nI, size=nnz))), shape=(nU, nI))
    X.sum_duplicates()
    X = X.tocoo()
    return X.row.astype(np.int32), X.col.astype(np.int32), X.data


@pytest.mark.parametrize("seed", [3, 17, 2**31 + 11])
def test_the_program_is_the_float64_reference(seed):
    from hpfrec_tpu_torch import HPF

    nU, nI, k, epochs = 90, 70, 6, 5
    iu, ii, y = _triplets(nU, nI, 1500, seed)
    held = svi_fit.holdout(y.shape[0], 0.1, seed)
    train = coo_array((y[~held], (iu[~held], ii[~held])), shape=(nU, nI))
    val = coo_array((y[held], (iu[held], ii[held])), shape=(nU, nI))
    m = HPF(k=k, use_float=False, users_per_batch=25, items_per_batch=20, maxiter=epochs,
            stop_crit="maxiter", check_every=None, random_seed=seed, verbose=False,
            device="cpu")
    m.fit(train, val_set=val)
    prior = Prior(0.3, 0.3, 1.0, 0.3, 0.3, 1.0, k)
    ref = SVI(y[~held], iu[~held], ii[~held], nU, nI, prior,
              initial_state(nU, nI, prior, seed, np.float64), "cpu")
    for i, (user_side, perm) in enumerate(itertools.islice(schedule(nU, nI, seed), epochs)):
        ref.epoch(user_side, perm, 25 if user_side else 20, 1.0 / np.sqrt(i + 2))
    # float64 on both sides: the same arithmetic in another order
    for got, want in ((m.Theta, ref.Theta), (m.Beta, ref.Beta),
                      (m.k_rte, ref.k_rte), (m.t_rte, ref.t_rte)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-11)
    from hpfrec_tpu_torch.ops.metrics import _llk_terms

    parts = _llk_terms(torch.from_numpy(y[held]), (torch.from_numpy(m.Theta)[iu[held]]
                                                   * torch.from_numpy(m.Beta)[ii[held]]).sum(1),
                       False)[0]
    assert float(parts[0] - parts[2]) == pytest.approx(ref.val_llk(y[held], iu[held], ii[held]),
                                                       rel=1e-12)


def test_the_cell_is_correct():
    line = run_small()
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and set(line["checks"]) == {"llk_rel", "theta_fro",
                                                                   "beta_fro"}
    assert set(line["metrics"]) == {"cavi_nnz_per_s", "setup_s"}


FAULTS = {**{"svi:" + n: f for n, f in svi_faults.ALL.items()},
          "answer_altered": faults.answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_fit_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    assert not run_small()["correct"]


def test_the_control_rounds_the_tables_only_while_it_fits():
    import hpfrec_tpu_torch.ops.svi as S

    orig = S.side_derive
    c = svi_fit.Cell(small_config(), small_traffic(), 5, device="cpu", arm="control")
    c.setup(warm=False)
    c.window(0.0)
    assert S.side_derive is orig
    got = c.numbers()
    p = svi_fit.Cell(small_config(), small_traffic(), 5, device="cpu")
    p.setup(warm=False)
    p.window(0.0)
    assert all(got[n] > 10 * v for n, v in p.numbers().items())
    assert not run.judge(got, spec.limits(NAME))[0]


def test_the_holdout_is_the_published_share():
    held = svi_fit.holdout(48_373_586, 0.01, 2**31 + 7)
    assert held.sum() == 483_736
    assert not np.array_equal(held, svi_fit.holdout(48_373_586, 0.01, 2**31 + 8))


def test_the_batch_shapes_count_each_batchs_rows():
    iu, ii, _ = _triplets(50, 30, 400, 1)
    fit = dict(users_per_batch=12, items_per_batch=7)
    got = svi_fit.batch_shapes(iu, ii, 50, 30, fit, 9, 3, "cpu")
    for shapes, (user_side, perm) in zip(got, itertools.islice(schedule(50, 30, 9), 3)):
        loc, oth = (iu, ii) if user_side else (ii, iu)
        size = fit["users_per_batch"] if user_side else fit["items_per_batch"]
        want = [svi_fit.BatchShape(user_side, len(rows), int(np.isin(loc, rows).sum()),
                                   len(np.unique(oth[np.isin(loc, rows)])))
                for rows in batches(perm, size)]
        assert shapes == want
    assert [len(s) for s in got] == [5, 5, 5] and [s[0].user_side for s in got] == [False, True,
                                                                                    False]


def test_k7_batch_phi_sums_by_hand():
    k, rows, slots, other, n_loc, n_oth = 4, 3, 11, 5, 20, 9
    f32 = np.ones(1, np.float32).nbytes
    stream = slots * (f32 + 4 + 4)  # y, row, column a slot
    batch = rows * (4 + 4) + rows * k * f32  # ids and offsets, their table rows
    touched = other * k * f32
    sums = (n_loc + n_oth) * k * f32 + n_oth  # both sides' sums, the other side's mask
    assert W.batch_phi_sums(rows, slots, other, n_loc, n_oth, k) == (
        stream + batch + touched + sums, slots * (2 * k + 2 * k + 2 * k + 2))


def test_k8_blend_by_hand():
    k, n_l, n_g = 3, 7, 5
    table = k * 4
    reads = n_l * 2 * table + n_g * 3 * table + (n_l + n_g) * (4 + 1)  # + scaler, mask
    writes = (n_l + n_g) * (2 * table + 4)  # shape, rate, scaler
    assert W.blend(n_l, n_g, k) == (reads + writes, 10 * (n_l + n_g) * k)


class _Cell:
    def __init__(self, fits, shapes=None, batches=(), nnz=1000):
        self.fits, self.shapes, self.batches, self.nnz = fits, shapes, list(batches), nnz
        self.cfg = dict(n_users=40, n_items=30, k=8)


class _Run:
    def __init__(self, cell):
        self.cell = cell


def _traced_fits():
    user = [svi_fit.BatchShape(True, 20, 300, 25), svi_fit.BatchShape(True, 20, 280, 22)]
    item = [svi_fit.BatchShape(False, 15, 290, 38), svi_fit.BatchShape(False, 15, 290, 39)]
    kernels = {"void hpf::phi_chunk_kernel<4, true, float>(...)": 2e-6,
               "void hpf::phi_other_finish_kernel<4, float>(...)": 1e-6,
               "void hpf::svi_pass_kernel<float, 8>(...)": 4e-6,
               "void hpf::row_mask_kernel(...)": 9.0, "RadixSort": 9.0}
    fits = [Fit(1.0, 2, {"epoch_offsets": 0.01}, loop_span_s=0.5, loop_busy_s=0.4,
                kernels=kernels),
            Fit(1.2, 2, {"epoch_offsets": 0.03}, loop_span_s=0.7, loop_busy_s=0.5,
                kernels=kernels)]
    return fits, [item, user]


def test_the_readers_of_a_traced_window():
    fits, shapes = _traced_fits()
    cell = _Cell(fits, shapes, batches=[4, 4])
    read = lambda name: spec.reader(name)(_Run(cell))  # noqa: E731
    assert read("svi.epoch_nnz_per_s") == pytest.approx(1000 * 4 / 1.2)
    assert read("svi.idle_share") == pytest.approx(100 * (1 - 0.9 / 1.2))
    assert read("svi.offsets_s") == pytest.approx(0.02)
    k7 = 2 * sum(least_seconds(*W.batch_phi_sums(b.rows, b.slots, b.other_rows,
                                                 *((40, 30) if b.user_side else (30, 40)), 8))
                 for s in shapes for b in s)
    assert read("svi.k7_roofline") == pytest.approx(100 * k7 / 6e-6)
    k8 = 2 * 2 * (least_seconds(*W.blend(40, 30, 8)) + least_seconds(*W.blend(30, 40, 8)))
    assert read("svi.k8_roofline") == pytest.approx(100 * k8 / 8e-6)


@pytest.mark.parametrize("name", ["svi.epoch_nnz_per_s", "svi.idle_share", "svi.offsets_s",
                                  "svi.k7_roofline", "svi.k8_roofline"])
def test_a_reader_reads_nothing_where_nothing_was_recorded(name):
    read = spec.reader(name)
    assert read(_Run(_Cell([]))) is None
    # an untraced window, and a program without the phase or the counter
    untraced = _Cell([Fit(1.0, 2, {"user_epochs": 0.2})], batches=[None])
    assert read(_Run(untraced)) is None
    fits, shapes = _traced_fits()
    old = _Cell([f._replace(phases={}) for f in fits], shapes, batches=[None, None])
    got = read(_Run(old))
    assert (got is None) == (name in ("svi.offsets_s", "svi.k8_roofline"))


def test_finish_reads_the_programs_epochs_from_a_trace(tmp_path):
    """A CPU-profiled window: the epochs' annotations are the program's own
    (no kernels on the CPU, so the rooflines read nothing)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from hpfbench.trace import read_chrome

    cell = svi_fit.Cell(small_config(), small_traffic(), 7, device="cpu", trace=True)
    cell.setup(warm=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("hpfbench.window"):
            cell.window(0.0)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    tr = read_chrome(str(tmp_path / "t.json"))
    cell.finish(tr)
    f = cell.fits[0]
    epochs = [a for a in tr.annotations if a.name in svi_fit.EPOCHS]
    assert len(epochs) == f.iterations and f.loop_span_s == pytest.approx(
        sum(a.end - a.start for a in epochs))
    assert f.loop_busy_s == 0 and f.kernels == {}
    assert cell.batches == [f.iterations // 2 * 5 + (f.iterations - f.iterations // 2) * 4]
    assert [len(s) for s in cell.shapes] == [5 if i % 2 else 4 for i in range(f.iterations)]
    r = _Run(cell)
    assert spec.reader("svi.epoch_nnz_per_s")(r) > 0
    assert spec.reader("svi.idle_share")(r) == pytest.approx(100.0)
    assert spec.reader("svi.offsets_s")(r) > 0
    assert spec.reader("svi.k7_roofline")(r) is None and spec.reader("svi.k8_roofline")(r) is None


def test_an_empty_trace_leaves_the_fits_unread():
    cell = svi_fit.Cell(small_config(), small_traffic(), 7, device="cpu", trace=True)
    cell.fits = [Fit(1.0, 2, {})]
    cell.inputs = (np.zeros(1, np.int32), np.zeros(1, np.int32), np.ones(1, np.float32))
    cell.finish(Trace([], [Span("hpfbench.fit", 0.0, 1.0)], []))
    assert cell.fits[0].loop_span_s is None
