"""The port's Chrome trace-event export (`mplc_tpu_torch/obs/chrome_trace.py`
and `python3 -m mplc_tpu_torch.obs.chrome_trace`), after the JAX package's
tests/test_chrome_trace.py: the schema, the retry/fault/requeue flows, a
real port sweep's JSONL, the torn tail, the command line and the
interpreter-exit conversion; and `to_chrome` equal to the JAX package's on
the same records.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mplc_tpu.obs import chrome_trace as jchrome
from mplc_tpu_torch.obs import chrome_trace, metrics, trace
from test_torch_report import _port_scenario, synthetic_records

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# the trace-event phases the converter may emit
_PHASES = {"X", "M", "s", "f"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(trace.TRACE_FILE_ENV, raising=False)
    monkeypatch.delenv(trace.CHROME_TRACE_FILE_ENV, raising=False)
    metrics.reset()
    yield
    metrics.reset()


def _validate_schema(doc):
    """Minimal Chrome trace-event (JSON object form) schema check."""
    assert isinstance(doc, dict)
    assert isinstance(doc["traceEvents"], list)
    for ev in doc["traceEvents"]:
        assert set(ev) >= {"name", "ph", "ts", "pid", "tid"}, ev
        assert ev["ph"] in _PHASES, ev
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        if ev["ph"] == "X":
            assert ev["dur"] >= 1.0  # zero-duration records widened to 1 us
        if ev["ph"] in ("s", "f"):
            assert "id" in ev
        if ev["ph"] == "f":
            assert ev.get("bp") == "e"
    starts = {e["id"] for e in doc["traceEvents"] if e["ph"] == "s"}
    ends = {e["id"] for e in doc["traceEvents"] if e["ph"] == "f"}
    assert starts == ends


def test_synthetic_records_schema_and_flows():
    recs = [
        {"name": "engine.evaluate", "id": 1, "parent": None, "ts": 100.0,
         "dur": 2.0, "thread": 7, "attrs": {"requested": 3}},
        {"name": "engine.fault", "id": 2, "parent": 1, "ts": 100.1,
         "dur": 0.0, "thread": 7,
         "attrs": {"kind": "transient", "site": "dispatch", "ordinal": 1}},
        {"name": "engine.retry", "id": 3, "parent": 1, "ts": 100.2,
         "dur": 0.0, "thread": 7,
         "attrs": {"site": "dispatch", "attempt": 1, "ordinal": 1}},
        {"name": "engine.batch", "id": 4, "parent": 1, "ts": 100.5,
         "dur": 0.4, "thread": 7, "attrs": {"ordinal": 1, "width": 8}},
        # another thread's batch of the same ordinal is not a flow target
        {"name": "engine.batch", "id": 5, "parent": None, "ts": 100.3,
         "dur": 0.1, "thread": 9, "attrs": {"ordinal": 1, "width": 8}},
    ]
    doc = chrome_trace.to_chrome(recs)
    _validate_schema(doc)
    flows = [e for e in doc["traceEvents"] if e["ph"] in ("s", "f")]
    assert {e["name"] for e in flows} == {"retry", "fault"}
    assert all(e["tid"] == 7 for e in flows)
    meta = [e for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"]
    assert {e["tid"] for e in meta} == {7, 9}
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert min(e["ts"] for e in xs) == 0.0


def test_requeue_flow_links_job_fault_to_next_slice():
    recs = [
        {"name": "service.slice", "id": 1, "parent": None, "ts": 10.0,
         "dur": 0.5, "thread": 1, "attrs": {"job": "job1", "tenant": "a"}},
        {"name": "service.job_fault", "id": 2, "parent": None, "ts": 10.6,
         "dur": 0.0, "thread": 1, "attrs": {"job": "job1", "attempt": 1}},
        {"name": "service.slice", "id": 3, "parent": None, "ts": 10.7,
         "dur": 0.5, "thread": 1, "attrs": {"job": "job2", "tenant": "b"}},
        {"name": "service.slice", "id": 4, "parent": None, "ts": 11.3,
         "dur": 0.5, "thread": 1, "attrs": {"job": "job1", "tenant": "a"}},
    ]
    doc = chrome_trace.to_chrome(recs)
    _validate_schema(doc)
    finish = next(e for e in doc["traceEvents"] if e["ph"] == "f")
    assert finish["name"] == "requeue"
    assert 1.3e6 <= finish["ts"] < 1.3e6 + 10


def _jax_records():
    from test_torch_report import _jax_titanic_sweep_records
    return _jax_titanic_sweep_records()


@pytest.mark.parametrize("source", ["synthetic", "jax titanic", "empty"])
def test_to_chrome_equals_jax(source):
    recs = {"synthetic": synthetic_records, "jax titanic": _jax_records,
            "empty": list}[source]()
    assert chrome_trace.to_chrome(recs) == jchrome.to_chrome(recs)


def test_port_sweep_jsonl_converts(tmp_path, monkeypatch):
    """A real port sweep traced to JSONL converts to schema-valid Chrome
    JSON holding the engine's spans, one slice a record."""
    from mplc_tpu_torch.contrib.engine import CharacteristicEngine

    trace_file = tmp_path / "sweep.jsonl"
    monkeypatch.setenv(trace.TRACE_FILE_ENV, str(trace_file))
    eng = CharacteristicEngine(_port_scenario())
    eng.evaluate([(0,), (1,), (0, 1), (0, 1, 2)])
    monkeypatch.delenv(trace.TRACE_FILE_ENV)
    trace._sink_file()  # re-sync: closes the sink, the file is complete

    summary = chrome_trace.convert(str(trace_file))
    assert summary["torn_lines"] == 0
    assert summary["records"] == len(trace_file.read_text().splitlines())
    doc = json.loads(Path(summary["out"]).read_text())
    _validate_schema(doc)
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(slices) == summary["records"]
    assert {"engine.evaluate", "engine.prep", "engine.dispatch", "engine.harvest",
            "engine.batch", "engine.hbm"} <= {e["name"] for e in slices}
    assert summary["flows"] == 0  # the port has no fault ladder yet


def test_torn_tail_tolerated_and_reported(tmp_path):
    path = tmp_path / "trace.jsonl"
    good = {"name": "engine.batch", "id": 1, "parent": None, "ts": 1.0,
            "dur": 0.1, "thread": 1, "attrs": {}}
    path.write_text(json.dumps(good) + "\n" + '{"name": "engine.ba')
    with pytest.warns(UserWarning, match="torn tail"):
        summary = chrome_trace.convert(str(path))
    assert summary["torn_lines"] == 1
    assert summary["records"] == 1
    doc = json.loads(Path(summary["out"]).read_text())
    _validate_schema(doc)
    assert doc["otherData"]["torn_lines"] == 1


def _run(args, **env):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), **env))


def test_cli(tmp_path):
    path = tmp_path / "trace.jsonl"
    rec = {"name": "engine.batch", "id": 1, "parent": None, "ts": 1.0,
           "dur": 0.1, "thread": 1, "attrs": {"ordinal": 1}}
    path.write_text(json.dumps(rec) + "\n")
    out = tmp_path / "out.json"
    proc = _run(["-m", "mplc_tpu_torch.obs.chrome_trace", str(path), "-o", str(out)])
    assert proc.returncode == 0, proc.stderr
    assert "from 1 records" in proc.stdout and "perfetto" in proc.stdout
    _validate_schema(json.loads(out.read_text()))
    # a missing input is a clean command-line error, not a traceback
    proc = _run(["-m", "mplc_tpu_torch.obs.chrome_trace", str(tmp_path / "nope.jsonl")])
    assert proc.returncode == 2
    assert "not found" in proc.stderr


def test_atexit_conversion(tmp_path):
    """MPLC_TORCH_CHROME_TRACE_FILE: the interpreter-exit hook converts the
    span JSONL (in a child process, where the hook runs), beside the JAX
    package's own hook, whose environment names differ."""
    src = tmp_path / "t.jsonl"
    out = tmp_path / "t.chrome.json"
    code = ("import mplc_tpu.obs.trace\n"
            "from mplc_tpu_torch.obs import trace\n"
            "with trace.span('engine.evaluate', requested=1):\n"
            "    trace.event('engine.batch', dur=0.1, ordinal=1)\n")
    proc = _run(["-c", code], MPLC_TORCH_TRACE_FILE=str(src),
                MPLC_TORCH_CHROME_TRACE_FILE=str(out), JAX_PLATFORMS="cpu")
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    _validate_schema(doc)
    assert {e["name"] for e in doc["traceEvents"]} >= {"engine.evaluate", "engine.batch"}
    assert len(src.read_text().splitlines()) == 2
