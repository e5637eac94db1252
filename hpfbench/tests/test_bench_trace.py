"""The trace's arithmetic: busy time, idle gaps, the breakdown, and a
Chrome trace read back."""

import json

import pytest

from hpfbench import trace as T

S = T.Span


def test_busy_and_gaps():
    spans = [S("a", 1.0, 2.0), S("b", 1.5, 3.0), S("c", 4.0, 5.0)]
    assert T.busy(spans, 0.0, 6.0) == pytest.approx(3.0)
    assert T.busy(spans, 1.5, 4.5) == pytest.approx(2.0)
    assert T.gaps(spans, 0.0, 6.0) == [(0.0, 1.0), (3.0, 4.0), (5.0, 6.0)]
    assert T.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_breakdown_names_what_the_host_did():
    tr = T.Trace(device=[S("k1", 1.0, 2.0), S("k2", 2.5, 3.0), S("k1", 5.0, 6.0)],
                 annotations=[S("call", 0.5, 3.2), S("call", 4.0, 6.5)], kernels=[])
    out = T.breakdown(tr, 0.0, 7.0)
    ops = dict(out["device_ops"])
    assert ops == {"k1": pytest.approx(2.0), "k2": pytest.approx(0.5)}
    idle = {name.split(" (")[0]: sec for name, sec in out["idle_gaps"]}
    assert idle["call: before its first device op"] == pytest.approx(0.5 + 1.0)
    assert idle["call: between device ops"] == pytest.approx(0.5)
    assert idle["call: after its last device op"] == pytest.approx(0.2 + 0.5)
    assert idle["between calls"] == pytest.approx(0.5 + 0.8 + 0.5)
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def test_read_chrome(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 5.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1.0, "dur": 2.0},
              {"ph": "X", "cat": "user_annotation", "name": "hpfbench.fit", "ts": 0.0,
               "dur": 20.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 1.0},
              {"ph": "i", "cat": "kernel", "name": "x", "ts": 3.0}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    tr = T.read_chrome(str(p))
    assert [s.name for s in tr.device] == ["Memcpy HtoD", "k"]
    assert [s.name for s in tr.kernels] == ["k"]
    assert [a.name for a in tr.annotations] == ["hpfbench.fit"]
    assert tr.annotations[0].end == pytest.approx(20e-6)
    assert tr.kernels[0].end == pytest.approx(15e-6)
