"""The port's telemetry plane (`mplc_tpu_torch/obs/export.py`) and the
service's postmortems, after tests/test_export.py, on the CPU:

- `tenant_token`, `redact_health` and `redact_varz` byte-equal to the JAX
  package's on the same documents, and the Prometheus text of one set of
  metrics the same, line for line, in both packages;
- with MPLC_TORCH_METRICS_PORT set, a service serves /metrics, /varz and
  /healthz on loopback (503 on a worker stall); without it no thread or
  socket exists; bearer tokens gate /metrics and /varz and a tenant's
  credential sees its own rows only; /fleet/* answer 404 while no fleet
  collector is configured; /router/* answer 404 unless
  MPLC_TORCH_ROUTER_SERVE=1 and a router sink is registered, as in the JAX
  package (a registered sink alone opens no mutating route);
- a quarantined job and a corrupt journal each leave a flight-recorder
  postmortem; the report's slo row; a profiled job's torch.profiler trace.
"""

import json
import logging
import os
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from mplc_tpu.obs import export as jexport
from mplc_tpu.obs import metrics as jmetrics
from mplc_tpu_torch.obs import analyze_trace, export, flight, metrics, report, trace
from mplc_tpu_torch.service import JobQuarantined, JournalCorruptError, SweepJournal, SweepService
from mplc_tpu_torch.service import scheduler as sched
from torch_service_helpers import clean_env, scenario


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    clean_env(monkeypatch, tmp_path, cap=None)
    metrics.reset()
    jmetrics.reset()
    yield
    export.stop()
    metrics.reset()
    jmetrics.reset()


def _get(url, token=None):
    req = urllib.request.Request(url)
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        resp = urllib.request.urlopen(req, timeout=10)
        return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- the same bytes as the JAX package ---------------------------------------

DOCS = [
    {"metrics": {"counters": {"service.device_seconds{tenant=alice}": 1.5,
                              "service.device_seconds{tenant=bob}": 2.5,
                              "service.device_seconds{tenant=a,b}": 0.5,
                              "engine.retries": 0}},
     "svc": {"jobs": {"job1": {"tenant": "alice", "status": "running", "priority": 1,
                               "age_sec": 2.0, "method": "Shapley values"},
                      "acme-q3": {"tenant": "bob", "status": "queued", "priority": 0,
                                  "age_sec": 0.5, "method": "GTG-Shapley"}},
             "tenant_device_seconds": {"alice": 1.5, "bob": 2.5}}},
    {"live_games": {
        "acme": {"tenant": "acme", "rounds_resident": 7, "round_stamp": 3, "queries": 2,
                 "results_cached": 1, "max_rounds": 4096, "resident": False,
                 "last_restore_s": 0.125, "journal": "/secret/path/wal.jsonl"},
        "beta": {"tenant": "beta", "rounds_resident": 1, "round_stamp": 1, "queries": 0,
                 "results_cached": 0, "max_rounds": 4096, "resident": True,
                 "last_restore_s": 0.0, "journal": None}}},
    {"fleet": {"shards": {"host-a": {"shard": "host-a", "queue_depth": 3, "stale": False},
                          "host-b": {"shard": "host-b", "queue_depth": 0, "stale": True}},
               "least_loaded": "host-a", "shard_id": "host-b", "peer": "10.0.0.2:9090",
               "cluster_queue_depth": 3}},
]


@pytest.mark.parametrize("doc", range(len(DOCS)))
@pytest.mark.parametrize("viewer,key", [("alice", None), ("beta", "master"), (None, "k")])
def test_redaction_is_byte_equal_to_jax(doc, viewer, key):
    d = DOCS[doc]
    ours = json.dumps(export.redact_varz(d, viewer=viewer, key=key), sort_keys=True)
    assert ours == json.dumps(jexport.redact_varz(d, viewer=viewer, key=key), sort_keys=True)
    assert viewer is None or (viewer in ours) == (viewer in json.dumps(d))


def test_tenant_token_and_redact_health_are_byte_equal_to_jax():
    for master, tenant in (("s3cret", "tenantA"), ("ü-key", "t,b"), ("k", 7)):
        assert export.tenant_token(master, tenant) == jexport.tenant_token(master, tenant)
    doc = {"healthy": True, "running_job": "acme-payroll-q3",
           "running_jobs": ["acme-payroll-q3", None],
           "providers": {"svc": {"workers": [
               {"worker": 0, "running_job": "acme-payroll-q3", "stalled": False}]}},
           "queue_depth": 3}
    for key in ("tok", None):
        out = export.redact_health(doc, key=key)
        assert out == jexport.redact_health(doc, key=key)
        assert "acme-payroll-q3" not in json.dumps(out)
        assert out["providers"]["svc"]["workers"][0]["stalled"] is False


def _fill(m):
    m.counter("engine.retries").inc(3)
    m.gauge("engine.device_mem_high_water_bytes").set(1024)
    m.counter("engine.memo_hits[GTG-Shapley]").inc()
    m.counter("service.device_seconds", tenant='we"ird\\t').inc(0.25)
    h = m.histogram("service.queue_wait_sec", tenant="t0")
    for v in (0.001, 0.002, 4.0, 1e-7, 3e4):
        h.observe(v)
    m.gauge("live.rounds_resident", tenant="t0")  # unset: no sample


def test_prometheus_text_is_the_jax_packages():
    _fill(metrics)
    _fill(jmetrics)
    text = export.prometheus_text()
    assert text == jexport.prometheus_text()
    lines = text.splitlines()
    assert "# TYPE mplc_engine_retries counter" in lines and "mplc_engine_retries 3" in lines
    assert 'mplc_engine_memo_hits{item="GTG-Shapley"} 1' in lines
    inf = [ln for ln in lines if ln.startswith('mplc_service_queue_wait_sec_bucket{le="+Inf"')]
    assert inf and inf[0].endswith(" 5") and 'tenant="t0"' in inf[0]
    buckets = [int(ln.rsplit(" ", 1)[1]) for ln in lines if "_bucket{" in ln]
    assert buckets == sorted(buckets)
    for ln in lines:
        if not ln.startswith("#"):
            float(ln.rsplit(" ", 1)[1])


# -- the endpoints ------------------------------------------------------------

def test_service_serves_endpoints_when_port_set(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_METRICS_PORT", "0")
    svc = SweepService(start=False)
    try:
        srv = export.active_server()
        assert srv is not None and export.active_port() == srv.port
        base = f"http://127.0.0.1:{srv.port}"
        job = svc.submit(scenario(0), tenant="tenantA")
        svc.run_until_idle()
        assert job.status == "completed"
        status, text = _get(base + "/metrics")
        assert status == 200
        assert "mplc_service_queue_wait_sec_bucket{le=" in text and 'tenant="tenantA"' in text
        assert "mplc_service_jobs_completed 1" in text
        assert 'mplc_service_device_seconds{tenant="tenantA"}' in text
        status, body = _get(base + "/varz")
        varz = json.loads(body)
        row = varz[svc._provider_key]["jobs"][job.job_id]
        assert status == 200 and row["status"] == "completed" and row["tenant"] == "tenantA"
        assert varz[svc._provider_key]["tenant_device_seconds"]["tenantA"] > 0
        assert varz["metrics"]["histograms"]["service.queue_wait_sec{tenant=tenantA}"][
            "count"] == 1
        assert "program_bank" in varz and "numerics" in varz
        status, body = _get(base + "/healthz")
        health = json.loads(body)
        assert status == 200 and health["healthy"] is True
        prov = health["providers"][svc._provider_key]
        assert prov["journal"] == "disabled" and prov["worker_alive"] is True
        assert _get(base + "/nope")[0] == 404 and _get(base + "/")[0] == 200
        # no fleet collector configured; no router without its knob
        status, body = _get(base + "/fleet/varz")
        assert status == 404 and "fleet collector" in body
        assert _get(base + "/fleet/metrics")[0] == 404
        assert _get(base + "/router/job?id=x")[0] == 404
        # a registered router sink answers the route once the operator
        # opens it with MPLC_TORCH_ROUTER_SERVE=1
        export.register_router("r", lambda op, doc: {"job": doc["job"], "tenant": "t"})
        try:
            assert _get(base + "/router/job?id=x")[0] == 404
            monkeypatch.setenv("MPLC_TORCH_ROUTER_SERVE", "1")
            status, body = _get(base + "/router/job?id=x")
            assert status == 200 and json.loads(body)["job"] == "x"
        finally:
            export.unregister("r")
    finally:
        svc.shutdown()
    assert svc._provider_key not in export.health_view()[1]["providers"]


def _post(url, doc, token=None):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(), method="POST")
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        resp = urllib.request.urlopen(req, timeout=10)
        return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("serve,sink", [(None, True), ("0", True), ("1", False), ("1", True)])
def test_router_routes_need_the_serve_knob_and_a_sink(monkeypatch, serve, sink):
    """POST /router/submit and GET /router/job exist only with
    MPLC_TORCH_ROUTER_SERVE=1 and a registered ShardServer sink: a sink
    alone (the variable unset or not "1") gives 404, as the JAX export's
    MPLC_TPU_ROUTER_SERVE gate does; with both the routes serve."""
    from mplc_tpu_torch.service.router import ShardServer
    if serve is not None:
        monkeypatch.setenv("MPLC_TORCH_ROUTER_SERVE", serve)
    srv = export.start(0)
    base = f"http://127.0.0.1:{srv.port}"
    svc = SweepService(start=False)
    server = ShardServer(svc, lambda spec: scenario(0)) if sink else None
    try:
        status, body = _post(base + "/router/submit", {"tenant": "A", "job_id": "j1"})
        job_status, job_body = _get(base + "/router/job?id=j1")
        if serve == "1" and sink:
            assert status == 200 and json.loads(body) == {"job": "j1", "tenant": "A"}
            assert job_status == 200 and json.loads(job_body)["status"] == "queued"
            assert _get(base + "/router/job?id=nope")[0] == 404
            assert _post(base + "/router/submit", [1])[0] == 400
        else:
            assert (status, job_status) == (404, 404) and "j1" not in svc._jobs
    finally:
        if server is not None:
            server.close()
        svc.shutdown(drain=False)


def test_router_gate_answers_as_the_jax_export(monkeypatch):
    """A registered sink with the serve variable unset: 404 in both
    packages; set: both serve the submission."""
    from mplc_tpu.obs import export as jexp
    for pkg, mod in (("MPLC_TORCH_", export), ("MPLC_TPU_", jexp)):
        mod.register_router("r", lambda op, doc: {"job": "j", "tenant": "t"})
        srv = mod.start(0)
        base = f"http://127.0.0.1:{srv.port}"
        try:
            monkeypatch.delenv(pkg + "ROUTER_SERVE", raising=False)
            closed = (_post(base + "/router/submit", {})[0], _get(base + "/router/job?id=j")[0])
            monkeypatch.setenv(pkg + "ROUTER_SERVE", "1")
            opened = (_post(base + "/router/submit", {})[0], _get(base + "/router/job?id=j")[0])
        finally:
            mod.unregister("r")
            mod.stop()
        assert (closed, opened) == ((404, 404), (200, 200)), pkg


def test_healthz_flips_on_worker_stall(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_METRICS_PORT", "0")
    svc = SweepService(start=False)
    try:
        base = f"http://127.0.0.1:{export.active_server().port}"
        svc._running_job = types.SimpleNamespace(job_id="jobX")
        svc._heartbeat = time.monotonic() - (sched.STALL_HEALTHY_SEC + 1)
        status, body = _get(base + "/healthz")
        prov = json.loads(body)["providers"][svc._provider_key]
        assert status == 503 and prov["stalled"] is True and prov["running_job"] == "jobX"
        svc._running_job = None
        svc._heartbeat = time.monotonic()
        assert _get(base + "/healthz")[0] == 200
    finally:
        svc._running_job = None
        svc.shutdown()


def test_no_socket_or_thread_without_the_env():
    threads = {t.name for t in threading.enumerate()}
    assert export.maybe_start_from_env() is None
    svc = SweepService(start=False)
    try:
        assert export.active_server() is None
        assert "mplc-telemetry" not in {t.name for t in threading.enumerate()} - threads
    finally:
        svc.shutdown()


def test_malformed_port_warns_and_plain_port_binds_loopback(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_METRICS_PORT", "not-a-port")
    with pytest.warns(UserWarning, match="not a port number"):
        assert export.maybe_start_from_env() is None
    monkeypatch.setenv("MPLC_TORCH_METRICS_PORT", "0")
    srv = export.maybe_start_from_env()
    assert srv.host == "127.0.0.1"
    export.stop()
    monkeypatch.setenv("MPLC_TORCH_METRICS_PORT", "127.0.0.1:0")
    srv = export.maybe_start_from_env()
    assert _get(f"http://127.0.0.1:{srv.port}/healthz")[0] in (200, 503)


def test_broken_provider_degrades_not_500():
    export.register_health("boom", lambda: 1 / 0)
    try:
        healthy, view = export.health_view()
        assert healthy is False and "error" in view["providers"]["boom"]
    finally:
        export.unregister("boom")


def test_a_dropped_service_unregisters_itself():
    svc = SweepService(start=False)
    key = svc._provider_key
    assert key in export.health_view()[1]["providers"]
    del svc
    import gc
    gc.collect()
    assert key not in export.health_view()[1]["providers"]


def test_token_gates_metrics_and_varz_but_not_healthz(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_METRICS_PORT", "0")
    monkeypatch.setenv("MPLC_TORCH_METRICS_TOKEN", "s3cret")
    svc = SweepService(start=False)
    try:
        base = f"http://127.0.0.1:{export.active_server().port}"
        for seed, tenant in ((0, "tenantA"), (1, "tenantB")):
            svc.submit(scenario(seed), tenant=tenant)
        svc.run_until_idle()
        for url in ("/metrics", "/varz"):
            assert _get(base + url)[0] == 401
            assert _get(base + url, token="wrong")[0] == 401
            assert _get(base + url, token="ümlaut")[0] == 401
        assert _get(base + "/healthz")[0] in (200, 503)
        status, text = _get(base + "/metrics", token="s3cret")
        assert status == 200 and "mplc_service_jobs_completed" in text
        status, body = _get(base + "/varz", token="s3cret")
        assert status == 200 and "tenantB" in body and "redacted" not in body
        tok_a = export.tenant_token("s3cret", "tenantA")
        status, body = _get(base + "/varz?tenant=tenantA", token=tok_a)
        jobs = json.loads(body)[svc._provider_key]["jobs"]
        rows = {r["tenant"]: r for r in jobs.values()}
        assert status == 200 and "tenantA" in rows and not rows["tenantA"].get("redacted")
        redacted = [r for r in jobs.values() if r.get("redacted")]
        assert redacted and redacted[0]["tenant"].startswith("tenant-")
        assert "method" not in redacted[0] and "tenantB" not in body
        assert _get(base + "/varz?tenant=tenantB", token=tok_a)[0] == 401
        assert _get(base + "/varz", token=tok_a)[0] == 401
        assert _get(base + "/metrics?tenant=tenantA", token=tok_a)[0] == 401
    finally:
        svc.shutdown(drain=False)


def test_unset_token_leaves_endpoints_open(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_METRICS_PORT", "0")
    svc = SweepService(start=False)
    try:
        base = f"http://127.0.0.1:{export.active_server().port}"
        assert _get(base + "/metrics")[0] == 200
        status, body = _get(base + "/varz")
        assert status == 200 and "redacted" not in body
    finally:
        svc.shutdown(drain=False)


# -- per-tenant SLO: the report row -------------------------------------------

def test_report_slo_row_from_service_records():
    with trace.collect() as recs:
        svc = SweepService(start=False)
        try:
            jobs = [svc.submit(scenario(seed), tenant=f"t{seed}") for seed in (0, 1)]
            svc.run_until_idle()
            assert all(j.status == "completed" for j in jobs)
        finally:
            svc.shutdown()
    slo = report.sweep_report(recs)["slo"]
    assert set(slo) == {"t0", "t1"}
    for row in slo.values():
        assert row["jobs"] == 1 and row["queue_wait_s"]["p50"] is not None
        assert row["ttfv_s"]["p50"] is not None and row["slice_s"]["count"] >= 1
        assert row["deadline_misses"] == 0 and row["retries"] == 0
    text = report.format_report(report.sweep_report(recs))
    assert "slo[t0]" in text and "deadline_misses=0" in text
    snap = metrics.snapshot()["histograms"]
    assert snap["service.queue_wait_sec{tenant=t0}"]["count"] == 1
    assert snap["service.time_to_first_value_sec{tenant=t1}"]["count"] == 1
    # every record the service emitted is registered
    from mplc_tpu_torch.obs.trace import SPAN_REGISTRY
    assert {r["name"] for r in recs} <= set(SPAN_REGISTRY)


def test_deadline_miss_counted_per_tenant():
    svc = SweepService(start=False)
    try:
        job = svc.submit(scenario(0), tenant="slow", deadline_sec=0.0)
        time.sleep(0.01)
        svc.run_until_idle()
        assert job.status == "cancelled" and job.deadline_missed is True
    finally:
        svc.shutdown()
    assert metrics.snapshot()["counters"]["service.deadline_misses{tenant=slow}"] == 1


# -- the crash flight recorder ------------------------------------------------

def test_quarantined_job_writes_postmortem_with_failing_batch_spans(monkeypatch, tmp_path,
                                                                     caplog):
    flight_dir = tmp_path / "flight"
    monkeypatch.setenv("MPLC_TORCH_MAX_RETRIES", "1")
    monkeypatch.setenv("MPLC_TORCH_COALITIONS_PER_DEVICE", "1")
    monkeypatch.setenv("MPLC_TORCH_SERVICE_FAULT_PLAN", "crash@job1:batch1,crash@job1:batch2")
    svc = SweepService(start=False)
    try:
        with trace.collect() as recs:
            job = svc.submit(scenario(0), tenant="victim")
            with caplog.at_level(logging.ERROR, logger="mplc_tpu_torch"):
                svc.run_until_idle()
        assert job.status == "quarantined"
        with pytest.raises(JobQuarantined):
            job.result(timeout=1)
    finally:
        svc.shutdown()
    slo = report.sweep_report(recs)["slo"]["victim"]
    assert slo["retries"] == metrics.snapshot()["counters"][
        "service.job_retries{tenant=victim}"] == 1
    dumps = sorted(flight_dir.glob("mplc_flight_job_quarantined_*.json"))
    assert dumps
    payload = json.loads(dumps[-1].read_text())
    assert payload["reason"] == "job_quarantined"
    assert payload["extra"]["job"] == job.job_id and payload["extra"]["tenant"] == "victim"
    ring = payload["ring_records"]
    start = max(i for i, r in enumerate(ring) if r["name"] == "service.submit"
                and r["attrs"].get("job") == job.job_id)
    ours = ring[start:]
    assert [r["attrs"]["ordinal"] for r in ours if r["name"] == "engine.fault"] == [1, 2]
    assert {"engine.dispatch", "service.job_fault"} <= {r["name"] for r in ours}
    logs = [r.message for r in caplog.records if "quarantining job" in r.message]
    assert logs and str(dumps[-1]) in logs[-1]


def test_journal_corruption_writes_postmortem(tmp_path):
    path = tmp_path / "wal.jsonl"
    j = SweepJournal(path)
    j.append({"type": "submit", "job": "job1"})
    j.append({"type": "value", "job": "job1", "subset": [0], "value": 0.5})
    j.close()
    lines = path.read_bytes().split(b"\n")
    lines[0] = lines[0][:-6] + b"xxxx}"
    path.write_bytes(b"\n".join(lines))
    with pytest.raises(JournalCorruptError, match="postmortem"):
        SweepJournal.replay(path)
    assert list((tmp_path / "flight").glob("mplc_flight_journal_corrupt_*.json"))


def test_flight_dump_never_raises(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_FLIGHT_RECORDER_DIR", "/proc/definitely/not/writable")
    assert flight.dump("test_reason") is None


# -- per-job device profiling -------------------------------------------------

def test_profiled_job_writes_a_torch_profiler_trace(monkeypatch, tmp_path):
    monkeypatch.setenv("MPLC_TORCH_PROFILE_DIR", str(tmp_path / "prof"))
    svc = SweepService(start=False, slice_coalitions=4)
    with trace.collect() as recs:
        job = svc.submit(scenario(0), tenant="A", profile=True)
        other = svc.submit(scenario(1), tenant="B")
        svc.run_until_idle()
    assert job.status == other.status == "completed"
    assert job.profile_path == str(tmp_path / "prof" / job.job_id)
    traces = sorted(os.listdir(job.profile_path))
    assert len(traces) == 2 and all(t.endswith(".pt.trace.json") for t in traces)
    summary = analyze_trace.summarize(os.path.join(job.profile_path, traces[0]))
    assert summary["kind"] == "cpu" and summary["kernels"]
    assert other.profile_path is None
    ends = [r for r in recs if r["name"] == "service.job" and r["attrs"]["job"] == job.job_id]
    assert ends[0]["attrs"]["profile_path"] == job.profile_path
