"""The command's exits: no result without a card, none in a checkout that
holds only the benchmark; and, on a card, one correct result line a cell."""

import json
import shutil
import subprocess
import sys

import pytest

from hpfbench import spec

ROOT = spec.ROOT
BENCH = spec.load_spec()


def _run(cwd, workload, seconds=1, trace=0, seed=2**31 + 5):
    return subprocess.run([sys.executable, "-m", "hpfbench.run", "--workload", workload,
                           "--seed", str(seed), "--seconds", str(seconds), "--trace",
                           str(trace)], cwd=cwd, capture_output=True, text=True, timeout=900)


def _has_result(out):
    lines = out.strip().splitlines()
    try:
        return bool(lines) and isinstance(json.loads(lines[-1]), dict)
    except ValueError:
        return False


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hpfbench", tmp_path / "hpfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, BENCH["workloads"][0]["name"])
    assert r.returncode != 0 and not _has_result(r.stdout)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(ROOT, BENCH["workloads"][0]["name"])
    assert r.returncode == 2 and not _has_result(r.stdout)
    assert "CUDA" in r.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_runs_correct_on_the_card(card, w):
    r = _run(ROOT, w["name"])
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert {m["name"] for m in spec.metrics(BENCH, w["name"], False)} == set(line["metrics"])
