"""The port's observability base on the CPU (`mplc_tpu_torch/obs/`: trace,
metrics, flight; `utils.profile_trace`, `obs/analyze_trace.py`; the
`trainer.compile` event of `ops/cuda_build.py`), after the JAX package's
tests/test_obs.py: span nesting and timing, explicit end and cancel, a
leaked inner span, externally timed events, threads, the flight ring, the
JSONL sink, the no-op without a sink, metrics snapshots, labelled series,
log-bucket quantiles, the memory sample; the metrics registry against the
JAX package's after the same operations; the static scan of span names
(the counterpart of tests/test_knob_hygiene.py's); the engine's spans on a
Titanic sweep; and a CPU-activity profile written, found and summarized.
"""

import ast
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mplc_tpu.obs import metrics as jmetrics
from mplc_tpu.obs import trace as jtrace
from mplc_tpu_torch import utils
from mplc_tpu_torch.obs import analyze_trace, flight, metrics, report, trace
from mplc_tpu_torch.ops import cuda_build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No ambient trace file, fresh registries."""
    monkeypatch.delenv(trace.TRACE_FILE_ENV, raising=False)
    monkeypatch.delenv(utils.PROFILE_DIR_ENV, raising=False)
    metrics.reset()
    jmetrics.reset()
    yield
    metrics.reset()
    jmetrics.reset()


# -- spans -------------------------------------------------------------------

def test_span_nesting_and_timing():
    with trace.collect() as recs:
        with trace.span("outer", label="a") as outer:
            with trace.span("inner") as inner:
                time.sleep(0.001)
        with trace.span("sibling") as sib:
            pass
    assert [r["name"] for r in recs] == ["inner", "outer", "sibling"]
    by_name = {r["name"]: r for r in recs}
    assert by_name["inner"]["parent"] == by_name["outer"]["id"]
    assert by_name["outer"]["parent"] is None
    assert by_name["sibling"]["parent"] is None
    assert outer.duration >= inner.duration >= 0.001
    assert by_name["outer"]["dur"] == outer.duration
    assert by_name["outer"]["attrs"] == {"label": "a"}
    assert sib.duration >= 0.0
    for r in recs:
        assert set(r) == {"name", "id", "parent", "ts", "dur", "thread", "attrs"}


def test_start_span_end_and_cancel():
    with trace.collect() as recs:
        sp = trace.start_span("explicit", k=1)
        sp.end()
        dropped = trace.start_span("dropped")
        dropped.cancel()
        assert dropped.duration is not None  # cancel still measures
    assert [r["name"] for r in recs] == ["explicit"]
    d = sp.duration
    sp.end()  # idempotent
    assert sp.duration == d


def test_leaked_inner_span_does_not_corrupt_nesting():
    with trace.collect() as recs:
        outer = trace.start_span("outer")
        trace.start_span("leaked")  # never ended
        outer.end()                 # pops through the leaked span
        with trace.span("next"):
            pass
    assert next(r for r in recs if r["name"] == "next")["parent"] is None
    assert trace.active_span("leaked") is None


def test_active_span_finds_the_innermost_open_span():
    with trace.span("contributivity", method="a"):
        with trace.span("contributivity", method="b"):
            assert trace.active_span("contributivity").attrs["method"] == "b"
        assert trace.active_span("contributivity").attrs["method"] == "a"
    assert trace.active_span("contributivity") is None


def test_event_records_external_duration():
    before = time.time()
    with trace.collect() as recs:
        with trace.span("outer") as outer:
            trace.event("trainer.compile", dur=1.25, fn="unit")
    ev = recs[0]
    assert ev["dur"] == 1.25 and ev["attrs"] == {"fn": "unit"}
    assert ev["parent"] == outer.id
    # ts marks the interval's start: backdated by dur
    assert before - 1.25 - 1.0 <= ev["ts"] <= before - 1.25 + 1.0


def test_spans_are_thread_safe():
    with trace.collect() as recs:
        def work(tag):
            for _ in range(50):
                with trace.span(f"outer-{tag}"):
                    with trace.span(f"inner-{tag}"):
                        pass
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
    assert len(recs) == 8 * 50 * 2
    by_id = {r["id"]: r for r in recs}
    assert len(by_id) == len(recs)  # ids unique across threads
    for r in recs:
        if r["name"].startswith("inner-"):
            tag = r["name"].split("-")[1]
            assert by_id[r["parent"]]["name"] == f"outer-{tag}"


def test_worker_thread_spans_never_parent_to_submitter():
    done = threading.Event()

    def worker():
        with trace.span("engine.evaluate"):
            with trace.span("engine.dispatch"):
                pass
        done.set()

    with trace.collect() as recs:
        with trace.span("submit") as submit:
            t = threading.Thread(target=worker)
            t.start()
            assert done.wait(10)
            t.join(timeout=10)
    by_id = {r["id"]: r for r in recs}
    ev = next(r for r in recs if r["name"] == "engine.evaluate")
    dispatch = next(r for r in recs if r["name"] == "engine.dispatch")
    assert ev["parent"] is None
    assert dispatch["parent"] == ev["id"]
    assert ev["thread"] != by_id[submit.id]["thread"]


def test_flight_ring_is_always_on_and_bounded():
    with trace.span("engine.evaluate", requested=1):
        pass
    trace.event("engine.batch", width=1)
    assert [r["name"] for r in trace.flight_records()[-2:]] == [
        "engine.evaluate", "engine.batch"]
    assert trace._flight_ring.maxlen == 512  # the default, env unset
    for i in range(600):
        trace.event("engine.batch", ordinal=i)
    ring = trace.flight_records()
    assert len(ring) == 512
    assert ring[-1]["attrs"] == {"ordinal": 599}


def test_flight_ring_size_from_env():
    code = ("from mplc_tpu_torch.obs import trace\n"
            "[trace.event('engine.batch', ordinal=i) for i in range(10)]\n"
            "print(len(trace.flight_records()), trace._flight_ring.maxlen)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT),
                                             MPLC_TORCH_FLIGHT_RECORDER_SIZE="3"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["3", "3"]


# -- the JSONL sink -----------------------------------------------------------

def test_jsonl_sink_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "trace.jsonl"
    monkeypatch.setenv(trace.TRACE_FILE_ENV, str(path))
    with trace.span("engine.evaluate", requested=3, missing=2):
        with trace.span("engine.dispatch", width=8):
            pass
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(recs) == 2
    for r in recs:
        assert set(r) == {"name", "id", "parent", "ts", "dur", "thread", "attrs"}
        assert isinstance(r["dur"], float) and r["dur"] >= 0.0
    dispatch, evaluate = recs  # the inner span closes, and is written, first
    assert dispatch["name"] == "engine.dispatch"
    assert dispatch["parent"] == evaluate["id"]
    assert evaluate["attrs"] == {"requested": 3, "missing": 2}
    # a changed env var reopens the sink on the new path
    other = tmp_path / "other.jsonl"
    monkeypatch.setenv(trace.TRACE_FILE_ENV, str(other))
    trace.event("engine.batch", width=1)
    assert len(path.read_text().splitlines()) == 2
    assert json.loads(other.read_text())["name"] == "engine.batch"


def test_noop_when_trace_file_unset(tmp_path):
    before = set(tmp_path.iterdir())
    with trace.span("hot.path", width=16) as sp:
        pass
    assert sp.duration is not None
    assert set(tmp_path.iterdir()) == before
    assert trace._sink_file() is None


# -- metrics -----------------------------------------------------------------

def test_metrics_snapshot_correctness():
    metrics.counter("c").inc()
    metrics.counter("c").inc(2.5)
    metrics.gauge("g").set(7)
    metrics.gauge("hw").set_max(10)
    metrics.gauge("hw").set_max(4)
    for v in (0.0, 0.5, 1.0):
        metrics.histogram("h").observe(v)
    snap = metrics.snapshot()
    assert snap["counters"]["c"] == 3.5
    assert snap["gauges"] == {"g": 7, "hw": 10}
    h = dict(snap["histograms"]["h"])
    buckets = h.pop("bucket_counts")
    assert h == {"count": 3, "sum": 1.5, "min": 0.0, "max": 1.0, "mean": 0.5,
                 "p50": 0.5, "p95": 1.0, "p99": 1.0}
    assert len(buckets) == len(metrics.LOG_BUCKET_BOUNDS) + 1 and sum(buckets) == 3
    with pytest.raises(TypeError):
        metrics.gauge("c")
    metrics.reset()
    assert metrics.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_labeled_metrics_are_distinct_series():
    metrics.counter("svc.jobs").inc()
    metrics.counter("svc.jobs", tenant="a").inc(2)
    metrics.counter("svc.jobs", tenant="b").inc(3)
    assert metrics.counter("svc.jobs", tenant="a") is metrics.counter("svc.jobs", tenant="a")
    snap = metrics.snapshot()["counters"]
    assert snap == {"svc.jobs": 1, "svc.jobs{tenant=a}": 2, "svc.jobs{tenant=b}": 3}
    with pytest.raises(TypeError):
        metrics.histogram("svc.jobs", tenant="a")


def test_histogram_log_bucket_quantiles():
    h = metrics.histogram("lat")
    for i in range(1, 101):
        h.observe(i / 100.0)
    assert 0.5 <= h.quantile(0.50) <= 1.0
    assert 0.95 <= h.quantile(0.95) <= 1.0
    assert h.quantile(0.99) <= 1.0
    assert h.quantile(0.0) >= 0.01
    row = next(r for r in metrics.export_view() if r["name"] == "lat")
    assert row["kind"] == "histogram"
    assert len(row["bucket_counts"]) == len(row["bounds"]) + 1
    assert sum(row["bucket_counts"]) == 100
    assert metrics.histogram("empty").quantile(0.5) is None


def _operations(m):
    """One sequence of metric operations, on either package's registry."""
    rng = np.random.default_rng(5)
    for v in rng.lognormal(-3, 2, 200):
        m.histogram("lat").observe(float(v))
        m.histogram("lat", tenant="t1").observe(float(v) * 3)
    for v in (0.0, 1e-9, 2.0 ** -20, 1.0, 4096.0, 1e6):
        m.histogram("edges").observe(v)
    m.counter("c").inc(3)
    m.counter("c", tenant="t1").inc(0.5)
    m.gauge("hw").set_max(7)
    m.gauge("unset")


def test_metrics_equal_jax_after_the_same_operations():
    _operations(metrics)
    _operations(jmetrics)
    ours, theirs = metrics.snapshot(), jmetrics.snapshot()
    assert ours == theirs
    assert metrics.export_view() == jmetrics.export_view()
    for q in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
        for key in ("lat", "lat{tenant=t1}", "edges"):
            h = ours["histograms"][key]
            args = (h["bucket_counts"], h["count"], h["min"], h["max"], q)
            assert metrics.bucket_quantile(*args) == jmetrics.bucket_quantile(*args)
    # a second "process": a shifted copy, merged with the first
    other = json.loads(json.dumps(ours))
    other["counters"]["c"] = 4.0
    other["gauges"]["hw"] = 9
    other["histograms"]["extra"] = {"count": 0}
    snaps = [ours, other, None, {"counters": {"c": "x"}}]
    assert metrics.merge_snapshots(snaps) == jmetrics.merge_snapshots(snaps)
    merged = metrics.merge_snapshots(snaps)
    assert merged["counters"]["c"] == 7.0 and merged["gauges"]["hw"] == 9
    assert merged["histograms"]["lat"]["count"] == 400


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_sample_device_memory_is_a_no_op_off_the_card(device):
    metrics.sample_device_memory(device=device)
    snap = metrics.snapshot()
    assert snap["gauges"] == {} and snap["counters"] == {}


def test_sample_device_memory_counts_failures(monkeypatch):
    def boom(device=None):
        raise RuntimeError("CUDA context lost")

    monkeypatch.setattr(torch.cuda, "max_memory_allocated", boom)
    monkeypatch.setattr(metrics, "_mem_sample_warned", False)
    with pytest.warns(UserWarning, match="sample_device_memory failed"):
        metrics.sample_device_memory(device="cuda")
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        metrics.sample_device_memory(device="cuda")  # counted, not warned again
    assert metrics.snapshot()["counters"]["obs.memory_sample_errors"] == 2


def test_sample_device_memory_reads_the_allocator(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: seen.append(device) or 4096)
    metrics.sample_device_memory(device="cuda:0")
    metrics.gauge("engine.device_mem_high_water_bytes").set_max(100)
    assert seen == ["cuda:0"]
    assert metrics.snapshot()["gauges"]["engine.device_mem_high_water_bytes"] == 4096


# -- the flight recorder --------------------------------------------------------

def test_flight_dump_writes_ring_and_metrics(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    metrics.counter("engine.batches").inc(2)
    trace.event("engine.batch", width=4)
    with trace.collect() as recs:
        path = flight.dump("unit", extra={"job": "j1"})
    assert Path(path).parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [Path(path).name]  # no .tmp left
    doc = json.loads(Path(path).read_text())
    assert doc["reason"] == "unit" and doc["extra"] == {"job": "j1"}
    assert doc["pid"] == os.getpid()
    assert doc["ring_records"][-1]["name"] == "engine.batch"
    assert len(doc["ring_records"]) <= trace._flight_ring.maxlen
    assert doc["metrics"]["counters"]["engine.batches"] == 2
    assert metrics.snapshot()["counters"]["obs.flight_dumps"] == 1
    assert [r["name"] for r in recs] == ["flight.dump"]
    assert recs[0]["attrs"]["path"] == path


def test_flight_dump_never_raises(tmp_path, monkeypatch):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(blocker / "sub"))
    assert flight.dump("unit") is None


# -- the nvcc build's compile events --------------------------------------------

def test_build_emits_a_compile_event_per_nvcc_run(tmp_path, monkeypatch):
    """A stand-in compiler (a script writing its -o file) builds two
    sources: one `trainer.compile` event each, with the counters; a second
    build finds both libraries fresh and emits nothing."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("k_a", "k_b"):
        (csrc / f"{name}.cu").write_text("// source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ \"$1\" = -o ]; then "
                    "touch \"$2\"; fi\n  shift\ndone\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setenv("MPLC_TORCH_COMPILE_CACHE_DIR", str(build))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    with trace.collect() as recs:
        cuda_build.build(["k_a", "k_b"])
        cuda_build.build(["k_a", "k_b"])
    assert sorted(r["attrs"]["fn"] for r in recs) == ["k_a", "k_b"]
    assert all(r["name"] == "trainer.compile" and r["dur"] > 0 for r in recs)
    snap = metrics.snapshot()["counters"]
    assert snap["trainer.compiles_total"] == 2
    assert snap["trainer.compiles[k_a]"] == 1
    assert snap["trainer.compile_seconds_total"] == pytest.approx(sum(r["dur"] for r in recs))
    rep = report.sweep_report(recs)
    assert rep["compiles"] == {r["attrs"]["fn"]: {"count": 1, "seconds": r["dur"]}
                               for r in recs}


# -- the span registry -------------------------------------------------------

SCANNED = sorted((ROOT / "mplc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _span_call_names():
    """(file, line, literal name or None) of every span()/start_span()/
    event() call in the port and chip_smoke.py."""
    out = []
    for path in SCANNED:
        rel = path.relative_to(ROOT)
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name not in ("span", "start_span", "event") or not node.args:
                continue
            first = node.args[0]
            literal = (first.value if isinstance(first, ast.Constant)
                       and isinstance(first.value, str) else None)
            out.append((str(rel), node.lineno, literal))
    return out


def test_every_span_name_is_a_registered_literal():
    sites = _span_call_names()
    assert len(sites) > 10, "the scan found too few span()/event() calls"
    dynamic = [f"{rel}:{ln}" for rel, ln, name in sites if name is None]
    assert not dynamic, f"span()/event() calls with a non-literal name: {dynamic}"
    unregistered = sorted({name for _, _, name in sites} - set(trace.SPAN_REGISTRY))
    assert not unregistered, f"emitted but not in SPAN_REGISTRY: {unregistered}"


def test_span_registry_has_no_stale_entry_and_is_the_jax_packages():
    """Every registered name is emitted and described; the names shared
    with the JAX package are its names, and `PORT_SPANS` is exactly the
    port's own (the batch path's leaf spans and set-up's spans), none of
    which the JAX package has."""
    emitted = {name for _, _, name in _span_call_names()}
    assert set(trace.SPAN_REGISTRY) == emitted
    assert set(trace.SPAN_REGISTRY) - trace.PORT_SPANS <= set(jtrace.SPAN_REGISTRY)
    assert trace.PORT_SPANS == set(trace.SPAN_REGISTRY) - set(jtrace.SPAN_REGISTRY)
    for name, desc in trace.SPAN_REGISTRY.items():
        assert isinstance(desc, str) and desc.strip(), name


# -- the engine's spans ----------------------------------------------------------

def test_engine_sweep_spans_and_report(tmp_path, monkeypatch):
    """A Titanic sweep traced to JSONL: memo, padding and epoch counts as
    computed by hand, one hbm event, every dispatch and harvest inside an
    evaluate span, and the batch log and the batch events in step."""
    from mplc_tpu_torch.contrib.engine import CharacteristicEngine
    from test_torch_report import _port_scenario

    # the sink opened after set-up, whose own spans it would hold too
    eng = CharacteristicEngine(_port_scenario())
    monkeypatch.setenv(trace.TRACE_FILE_ENV, str(tmp_path / "trace.jsonl"))
    with trace.collect() as recs:
        eng.evaluate([(0,), (1,), (0, 1)])   # 3 misses
        eng.evaluate([(0,), (1,), (0, 1)])   # 3 hits
    rep = report.sweep_report(recs)
    assert rep["memo"] == {"requested": 6, "hits": 3, "misses": 3, "hit_rate": 0.5}
    # one device: 2 singles in a width of 2, 1 pair in a width of 1
    assert rep["batches"] == {"count": 2, "coalitions": 3, "padding": 0,
                              "pad_waste_fraction": 0.0, "epochs_trained": 6}
    assert eng.epochs_trained == 6
    assert [(b["width"], b["coalitions"]) for b in eng.batch_log] == \
        [(r["attrs"]["width"], r["attrs"]["coalitions"])
         for r in recs if r["name"] == "engine.batch"]
    assert [r["attrs"]["ordinal"] for r in recs if r["name"] == "engine.batch"] == [1, 2]
    assert rep["hbm"]["param_bytes"] == eng._model_param_bytes() > 0
    assert rep["hbm"]["slot_count"] == 3  # the pair's merged slot width
    assert rep["hbm"]["peak_in_use_bytes"] is None  # no CUDA device
    for key in ("evaluate_s", "prep_s", "dispatch_s", "harvest_s"):
        assert rep["wallclock"][key] > 0
    snap = metrics.snapshot()
    assert snap["counters"]["engine.memo_hits"] == 3
    assert snap["counters"]["engine.coalitions_evaluated"] == 3
    assert snap["histograms"]["engine.pad_waste_fraction"]["count"] == 2
    parsed = [json.loads(line) for line in
              (tmp_path / "trace.jsonl").read_text().splitlines()]
    assert [r["name"] for r in parsed] == [r["name"] for r in recs]
    names = [r["name"] for r in parsed]
    assert names.count("engine.evaluate") == 2 and names.count("engine.hbm") == 1
    ev_ids = {r["id"] for r in parsed if r["name"] == "engine.evaluate"}
    for r in parsed:
        if r["name"] in ("engine.dispatch", "engine.harvest", "engine.prep"):
            assert r["parent"] in ev_ids


def test_memo_counters_attribute_to_the_enclosing_method():
    from mplc_tpu_torch.contrib.engine import _memo_counters

    assert _memo_counters(1, 2) is None
    with trace.span("contributivity", method="SVARM"):
        assert _memo_counters(3, 4) == "SVARM"
    snap = metrics.snapshot()["counters"]
    assert snap == {"engine.memo_hits": 4, "engine.memo_misses": 6,
                    "engine.memo_hits[SVARM]": 3, "engine.memo_misses[SVARM]": 4}


# -- the device trace ---------------------------------------------------------------

def _forward_pass():
    """A small port forward pass: the Titanic logistic model on 64 rows."""
    from mplc_tpu_torch.models import zoo

    model = zoo.TITANIC_LOGREG
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).random((64, 27), np.float32))
    return model.apply(params, x, torch.float32, None)


def test_profile_trace_writes_a_cpu_trace_that_is_summarized(tmp_path):
    with utils.profile_trace(str(tmp_path), device="cpu") as prof:
        logits = _forward_pass()
    assert logits.shape == (64, 1)
    assert Path(prof.path).parent == tmp_path
    assert analyze_trace.newest_trace(str(tmp_path)) == prof.path
    s = analyze_trace.summarize(prof.path)
    assert s["kind"] == "cpu"
    assert 0.0 <= s["device"]["busy_share"] <= 1.0
    assert s["kernels"] and all(k["count"] >= 1 for k in s["kernels"].values())
    assert s["streams"] and s["window_us"] > 0
    text = analyze_trace.format_summary(s)
    assert "busy" in text and "of the window" in text
    proc = subprocess.run([sys.executable, "-m", "mplc_tpu_torch.obs.analyze_trace",
                           str(tmp_path), "--top", "3"], capture_output=True, text=True,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    assert "cpu activity" in proc.stdout


def test_profile_trace_env_dir_and_no_op(tmp_path, monkeypatch):
    with utils.profile_trace(device="cpu") as prof:
        _forward_pass()
    assert prof.path is None and not list(tmp_path.iterdir())
    monkeypatch.setenv(utils.PROFILE_DIR_ENV, str(tmp_path / "prof"))
    with utils.profile_trace(device="cpu") as prof:
        _forward_pass()
    assert Path(prof.path).parent == tmp_path / "prof"


def test_profile_trace_asks_for_cuda_where_there_is_none(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with utils.profile_trace(str(tmp_path)):
            pass
    assert not list(tmp_path.iterdir())


def _kernel(name, ts, dur, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0,
            "tid": stream}


def test_analyze_trace_unions_overlapping_kernels(tmp_path):
    doc = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0,
         "pid": 1, "tid": 1},
        _kernel("recon_matmul_kernel<2, 2>", 10.0, 20.0),
        _kernel("recon_matmul_kernel<2, 2>", 20.0, 20.0, stream=8),  # overlaps
        _kernel("gemm", 50.0, 10.0),
        _kernel("memcpy", 70.0, 5.0, cat="gpu_memcpy"),
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0},
    ]}
    path = tmp_path / "x.pt.trace.json"
    path.write_text(json.dumps(doc))
    s = analyze_trace.summarize(str(path))
    assert s["kind"] == "cuda" and s["window_us"] == 100.0
    assert s["device"] == {"events": 4, "busy_us": 45.0, "busy_share": 0.45}
    assert [st["busy_us"] for st in s["streams"]] == [35.0, 20.0]
    assert s["kernels"]["recon_matmul_kernel<2, 2>"] == {"us": 40.0, "count": 2}
    assert list(s["kernels"])[0] == "recon_matmul_kernel<2, 2>"


def test_newest_trace_picks_the_latest_recursively(tmp_path):
    old = tmp_path / "a" / "one.pt.trace.json"
    new = tmp_path / "b" / "deep" / "two.pt.trace.json"
    for p in (old, new):
        p.parent.mkdir(parents=True)
        p.write_text("{}")
    t = time.time()
    os.utime(old, (t - 100, t - 100))
    os.utime(new, (t, t))
    assert analyze_trace.newest_trace(str(tmp_path)) == str(new)
    assert analyze_trace.newest_trace(str(old)) == str(old)
    with pytest.raises(FileNotFoundError):
        analyze_trace.newest_trace(str(tmp_path / "a" / "none"))


def test_recon_null_coalitions_are_worth_zero(monkeypatch):
    """Under a plan that drops partner 0 from epoch 1, the reconstruction
    evaluator values {0} at 0 without a batch, as the JAX evaluator does
    (a replay of its all-zero weights would score the untrained model),
    and counts it in `engine.null_coalitions` in both packages."""
    from helpers import build_scenario
    from mplc_tpu.contrib.contributivity import Contributivity as JContributivity
    from mplc_tpu.data import datasets as jdatasets
    from mplc_tpu_torch.contrib.contributivity import Contributivity
    from test_torch_report import GAME, _port_scenario

    monkeypatch.setenv("MPLC_TORCH_PARTNER_FAULT_PLAN", "dropout@p0:epoch1")
    monkeypatch.setenv("MPLC_TPU_PARTNER_FAULT_PLAN", "dropout@p0:epoch1")
    c = Contributivity(_port_scenario())
    with trace.collect() as recs:
        c.exact_reconstructed()
    jc = JContributivity(build_scenario(dataset=jdatasets.load_titanic(),
                                        is_dry_run=True, **GAME))
    jc.exact_reconstructed()
    values = c._reconstructor().values
    assert values[(0,)] == jc._reconstructor().values[(0,)] == 0.0
    assert values[(0, 1)] > 0.0
    assert metrics.snapshot()["counters"]["engine.null_coalitions"] == \
        jmetrics.snapshot()["counters"]["engine.null_coalitions"] == 1
    assert sum(r["attrs"]["coalitions"] for r in recs
               if r["name"] == "engine.batch" and r["attrs"].get("eval_only")) == 6
