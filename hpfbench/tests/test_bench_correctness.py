"""``correct`` at a size a test run holds, on the CPU: the program's runs
pass each cell's limits; the control (the precision below the
configuration's, in the program's place) and each fault a cell can have,
planted in the program under a whole run (the look for a card skipped),
fail them."""

import numpy as np
import pytest
import torch

from hpfbench import control, faults, run, spec
from hpfbench.tests.small import config, traffic, workload

BENCH = spec.load_spec()
CAVI = ["tasteprofile-k50.cavi", "movielens20m-k30.cavi-20"]
TOPN = ["tasteprofile-k50.topn-candidates"]


def run_small(name, seed=11):
    w = workload(name)
    return run.run_cell(BENCH, w, seed, 0.0, device="cpu", cfg=config(w["config"], name),
                        traffic=traffic(w["traffic"]))


@pytest.mark.parametrize("name", CAVI + TOPN)
def test_the_program_is_correct(name):
    line = run_small(name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("name", CAVI + TOPN)
def test_the_control_fails_on_three_seeds(name):
    w = workload(name)
    rows = control.readings(name, "control", [3, 4, 5], device="cpu", cfg=config(w["config"], name),
                            traffic=traffic(w["traffic"]))
    limits = spec.limits(name)
    for r in rows:
        assert not run.judge(r["numbers"], limits)[0], r


@pytest.mark.parametrize("fault", sorted(faults.FIT))
@pytest.mark.parametrize("name", CAVI)
def test_a_fault_in_the_fit_is_not_correct(name, fault, monkeypatch):
    faults.FIT[fault](monkeypatch.setattr)
    assert not run_small(name)["correct"]


@pytest.mark.parametrize("fault", sorted(faults.SERVING))
@pytest.mark.parametrize("name", TOPN)
def test_a_fault_in_serving_is_not_correct(name, fault, monkeypatch):
    faults.SERVING[fault](monkeypatch.setattr)
    assert not run_small(name)["correct"]


@pytest.mark.parametrize("name", CAVI)
def test_a_fault_arm_of_the_control_reads_the_fault(name, monkeypatch):
    w = workload(name)
    rows = control.readings(name, "fault:state_unchanged", [3], device="cpu",
                            cfg=config(w["config"], name), traffic=traffic(w["traffic"]),
                            patch=monkeypatch.setattr)
    assert not run.judge(rows[0]["numbers"], spec.limits(name))[0]


def test_the_window_draws_whole_passes_over_the_users():
    from hpfbench.kinds.topn_batch import Cell

    cfg = config("tasteprofile-k50")
    c = Cell(cfg, dict(traffic("topn-candidates"), users_per_call=100), 1, device="cpu")
    users = np.concatenate([c._next_users() for _ in range(cfg["n_users"] // 100)])
    assert np.array_equal(np.sort(users), np.arange(cfg["n_users"]))
