"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<mix>`` reads ``configs/<config>.json``,
``traffic/<mix>.json`` and ``limits/<config>.<mix>.json``; the mix's
``kind`` names its driver, ``kinds/<kind>.py``; a metric ``<name>`` is
read by ``metrics/<name>.py``.  Nothing here knows a cell by name.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return _json(SPEC_FILE)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit("hpfbench: no workload %r in BENCHMARK.json" % name)


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return _json(HERE / "limits" / f"{workload_name}.json")


def kind(name: str):
    """The driver module of a traffic kind."""
    return importlib.import_module(f"hpfbench.kinds.{name}")


def _listed(metric: dict, workload_name: str) -> bool:
    return "workloads" not in metric or workload_name in metric["workloads"]


def metrics(spec: dict, workload_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: with ``trace`` its
    per-layer metrics, else its end-to-end metrics.  A per-layer metric
    without a ``workloads`` key belongs to every cell that reports the
    end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"] if _listed(m, workload_name)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if _listed(m, workload_name) and m["moves"] in names]


def reader(metric_name: str):
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"hpfbench_metric_{metric_name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
