"""bench.py fault isolation: one workload's failure must not hide the
other workloads' metrics (a single compile failure once produced rc=1
with no JSON, so nothing was recorded)."""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench


def test_run_workload_isolates_failures(capsys):
    sink, errors = [], []
    ok = bench._run_workload("good", lambda: 1234.5, sink, errors)
    assert ok and sink[0]["metric"] == "good" and sink[0]["value"] == 1234.5
    assert sink[0]["vs_baseline"] > 0

    def boom():
        raise RuntimeError("out of memory while compiling")

    ok = bench._run_workload("bad", boom, sink, errors)
    assert not ok
    assert len(sink) == 1, "failed workload must not append a metric"
    assert errors == [{"metric": "bad", "error": "RuntimeError: out of memory while compiling"}]
    err = capsys.readouterr().err
    assert "workload bad FAILED" in err


def test_metric_schema():
    m = bench._metric("x", 122.0 * 10)
    assert set(m) == {"metric", "value", "unit", "vs_baseline"}
    assert m["vs_baseline"] == 10.0
    assert m["unit"] == "env-steps/s"
    json.dumps(m)  # serializable
