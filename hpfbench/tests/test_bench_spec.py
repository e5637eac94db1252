"""The harness finds every cell, traffic mix, configuration, limit file
and metric reader by name from BENCHMARK.json, and the file keeps the
contract's shape."""

import re

import pytest

from hpfbench import spec
from hpfbench.tests.small import SPARE

BENCH = spec.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hpfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name(w):
    assert w["name"] == "%s.%s" % (w["config"], w["traffic"])
    cfg = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    kind = spec.kind(traffic["kind"])
    assert hasattr(kind, "Cell")
    assert cfg["name"] == w["config"]
    assert spec.limits(w["name"])
    assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in spec.metrics(BENCH, w["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics(BENCH, w["name"], True)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert callable(spec.reader(m["name"]))
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in m.get("workloads", []):
        spec.workload(BENCH, w)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file(c):
    cfg = spec.config(c["name"])
    assert c["file"] == "hpfbench/configs/%s.json" % c["name"]
    assert cfg["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_per_layer_metrics_of_a_layer_share_its_name():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(x) <= 200 and "\n" not in x for x in layers)


@pytest.mark.parametrize("w", SPARE, ids=lambda w: w["name"])
def test_a_spare_cells_files_are_found_by_name(w):
    assert w["name"] == "%s.%s" % (w["config"], w["traffic"])
    assert w["name"] not in {x["name"] for x in BENCH["workloads"]}
    assert spec.config(w["config"])["name"] == w["config"]
    assert hasattr(spec.kind(spec.traffic(w["traffic"])["kind"]), "Cell")
    assert spec.limits(w["name"])
