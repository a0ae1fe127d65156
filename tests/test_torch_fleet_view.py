"""The port's fleet collector (`mplc_tpu_torch/obs/fleet_view.py`) after the
collector's cases of tests/test_fleet_view.py, on the CPU:

- merged metrics are exact: `merge_snapshots` over W per-shard snapshots
  reports the quantiles of one histogram fed the pooled samples;
- the three sources (the published state folder, a folder of
  `result_shardI.json` files, HTTP peers' /varz), each given the same files
  or the same server in both packages: the port's `FleetCollector.collect()`
  gives the JAX collector's snapshot key for key, and `fleet_metrics_text`
  the same text;
- the export's /fleet/metrics and /fleet/varz: 404 with no collector, the
  credentials of the per-process routes, tenant redaction on every row,
  503 when the collector fails.
"""

import json
import os
import random
import urllib.error
import urllib.request

import pytest

from mplc_tpu.obs import fleet_view as jfleet_view
from mplc_tpu.obs import metrics as jmetrics
from mplc_tpu.obs import trace as jtrace
from mplc_tpu.parallel import fleet as jfleet
from mplc_tpu_torch.obs import export, fleet_view
from mplc_tpu_torch.obs import metrics as obs_metrics
from mplc_tpu_torch.obs import trace as obs_trace
from mplc_tpu_torch.parallel import fleet
from mplc_tpu_torch.service import SweepService
from torch_service_helpers import clean_env, scenario

TOKEN = "hunter2"


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    clean_env(monkeypatch, tmp_path, cap=None)
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        for knob in ("FLEET_PEERS", "FLEET_STALE_SEC", "FLEET_SHARD_ID"):
            monkeypatch.delenv(pkg + knob, raising=False)
    obs_metrics.reset()
    jmetrics.reset()
    fleet_view.set_collector(None)
    yield
    fleet_view.set_collector(None)
    export.stop()
    obs_metrics.reset()
    jmetrics.reset()


def _get(url, token=None):
    req = urllib.request.Request(url)
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _hist_snapshot_entry(h):
    """The snapshot() form of one bare Histogram."""
    return {"count": h.count, "sum": h.total,
            "min": h.min if h.count else None, "max": h.max if h.count else None,
            "p50": h.quantile(0.50), "p95": h.quantile(0.95), "p99": h.quantile(0.99),
            "bucket_counts": list(h.bucket_counts)}


def _comparable(snap: dict) -> dict:
    """A collect() snapshot less what depends on the clock (its time stamp,
    the rows' ages)."""
    out = {k: v for k, v in snap.items() if k != "ts"}
    out["shards"] = {sid: {k: v for k, v in row.items() if k != "age_sec"}
                     for sid, row in snap["shards"].items()}
    return json.loads(json.dumps(out, sort_keys=True, default=str))


# -- merge_snapshots: exactness ---------------------------------------------------

def test_merged_quantiles_equal_pooled_sample_quantiles():
    rng = random.Random(7)
    key = "service.queue_wait_sec{tenant=t0}"
    pooled = obs_metrics.Histogram("service.queue_wait_sec", {"tenant": "t0"})
    snaps = []
    for _shard in range(4):
        h = obs_metrics.Histogram("service.queue_wait_sec", {"tenant": "t0"})
        for _ in range(rng.randrange(5, 120)):
            v = rng.lognormvariate(-2.0, 3.0)
            h.observe(v)
            pooled.observe(v)
        snaps.append({"histograms": {key: _hist_snapshot_entry(h)}})
    merged = obs_metrics.merge_snapshots(snaps)["histograms"][key]
    want = _hist_snapshot_entry(pooled)
    assert merged["count"] == want["count"]
    assert merged["sum"] == pytest.approx(want["sum"])
    assert merged["min"] == want["min"] and merged["max"] == want["max"]
    assert merged["bucket_counts"] == want["bucket_counts"]
    for q in ("p50", "p95", "p99"):
        assert merged[q] == want[q], q
    for q in (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        got = obs_metrics.bucket_quantile(merged["bucket_counts"], merged["count"],
                                          merged["min"], merged["max"], q)
        assert got == pooled.quantile(q), q
    # and the JAX package's merge of the same snapshots says the same
    assert jmetrics.merge_snapshots(snaps)["histograms"][key] == merged


def test_merge_snapshots_counter_gauge_semantics():
    a = {"counters": {"engine.batches": 3, "fleet.incidents": 1},
         "gauges": {"engine.device_mem_high_water_bytes": 100}}
    b = {"counters": {"engine.batches": 4},
         "gauges": {"engine.device_mem_high_water_bytes": 900, "unset": None}}
    out = obs_metrics.merge_snapshots([a, b, None, "junk"])
    assert out["counters"]["engine.batches"] == 7
    assert out["counters"]["fleet.incidents"] == 1
    assert out["gauges"]["engine.device_mem_high_water_bytes"] == 900
    assert out["gauges"]["unset"] is None
    out2 = obs_metrics.merge_snapshots([{"histograms": {"h": {"count": 0}}}])
    assert out2["histograms"]["h"]["count"] == 0
    assert out2["histograms"]["h"]["p99"] is None


# -- the collector's sources, against the JAX collector ----------------------------

def _shard_snapshots():
    """Two shards' metrics snapshots: device seconds by tenant, a gauge and
    the SLO histograms, filled from a seed."""
    rng = random.Random(3)
    snaps = []
    for shard in range(2):
        hists = {}
        for name in ("service.queue_wait_sec", "service.slice_sec", "live.query_sec"):
            for tenant in ("t0", "t1"):
                h = obs_metrics.Histogram(name, {"tenant": tenant})
                for _ in range(rng.randrange(3, 40)):
                    h.observe(rng.lognormvariate(-3.0, 2.0))
                hists[f"{name}{{tenant={tenant}}}"] = _hist_snapshot_entry(h)
        snaps.append({
            "counters": {"service.device_seconds{tenant=t0}": 2.0 + shard,
                         "service.device_seconds{tenant=t1}": 0.5 * shard,
                         "service.jobs_completed": 3 + shard,
                         "engine.memo_hits[Shapley values]": 7},
            "gauges": {"engine.device_mem_high_water_bytes": 1000 * (shard + 1)},
            "histograms": hists})
    return snaps


def test_collector_state_dir_source_merges_published_metrics(tmp_path):
    d = str(tmp_path / "state")
    snapA = {"counters": {"service.device_seconds{tenant=t0}": 2.0}}
    snapB = {"counters": {"service.device_seconds{tenant=t0}": 3.0,
                          "service.device_seconds{tenant=t1}": 1.0}}
    fleet.publish_shard_state(d, "alpha", {"queue_depth": 1, "metrics": snapA})
    fleet.publish_shard_state(d, "beta", {"queue_depth": 2, "metrics": snapB})
    out = fleet_view.FleetCollector(state_dir=d).collect()
    assert out["shard_count"] == 2 and out["fresh_shards"] == 2
    assert out["merged_sources"] == 2
    assert out["device_seconds_total"] == pytest.approx(6.0)
    assert out["tenant_device_seconds"] == {"t0": pytest.approx(5.0),
                                            "t1": pytest.approx(1.0)}
    assert out["cluster"]["cluster_queue_depth"] == 3
    assert all("metrics" not in r for r in out["shards"].values())


def test_state_dir_snapshot_and_text_equal_the_jax_collectors(tmp_path):
    d = str(tmp_path / "state")
    for i, snap in enumerate(_shard_snapshots()):
        fleet.publish_shard_state(d, f"s{i}", {"queue_depth": i, "jobs_pending": i + 1,
                                               "admission_state": "healthy",
                                               "metrics": snap})
    # a stale shard: out of the fresh count in both packages
    fleet.publish_shard_state(d, "old", {"queue_depth": 5, "metrics": {
        "counters": {"service.device_seconds{tenant=t2}": 1.0}}})
    path = os.path.join(d, "shard_old.json")
    doc = json.load(open(path))
    doc["ts"] -= 1000.0
    json.dump(doc, open(path, "w"))
    ours = fleet_view.FleetCollector(state_dir=d).collect()
    theirs = jfleet_view.FleetCollector(state_dir=d).collect()
    assert _comparable(ours) == _comparable(theirs)
    assert ours["fresh_shards"] == 2 and ours["shard_count"] == 3
    assert set(ours["slo"]) == {f"{n}{{tenant={t}}}" for n in (
        "service.queue_wait_sec", "service.slice_sec", "live.query_sec") for t in ("t0", "t1")}
    assert fleet_view.fleet_metrics_text(ours["merged"]) == \
        jfleet_view.fleet_metrics_text(theirs["merged"])


def _write_results(out_dir, snaps):
    os.makedirs(out_dir, exist_ok=True)
    for i, snap in enumerate(snaps):
        with open(os.path.join(out_dir, f"result_shard{i}.json"), "w") as f:
            json.dump({"fleet": {"shard_id": f"shard{i}", "run_id": "fleet-abc"},
                       "sweep_s": 1.5 + i, "subsets": [[0], [1], [0, 1]][:i + 2],
                       "metrics": snap}, f)
    open(os.path.join(out_dir, ".shard0.done"), "w").close()
    # a file that is not a result and a torn one: both ignored
    open(os.path.join(out_dir, "result_shardX.json"), "w").write("{}")
    open(os.path.join(out_dir, "result_shard7.json"), "w").write("{torn")


def test_result_files_source_equals_the_jax_collectors(tmp_path):
    out = str(tmp_path / "run")
    _write_results(out, _shard_snapshots())
    ours = fleet_view.cluster_snapshot(out_dir=out)
    theirs = jfleet_view.cluster_snapshot(out_dir=out)
    assert _comparable(ours) == _comparable(theirs)
    assert set(ours["shards"]) == {"shard0", "shard1"}
    assert ours["fresh_shards"] == 1 and ours["merged_sources"] == 2
    assert ours["shards"]["shard1"]["coalitions"] == 3
    assert fleet_view.fleet_metrics_text(ours["merged"]) == \
        jfleet_view.fleet_metrics_text(theirs["merged"])
    # a missing folder is no source, never an exception
    assert fleet_view.cluster_snapshot(out_dir=str(tmp_path / "nope"))["shard_count"] == 0


def test_http_peer_source_equals_the_jax_collectors(monkeypatch):
    """A port service's /varz, read by both collectors with the operator's
    token; a dead peer is a row, never an exception."""
    monkeypatch.setenv("MPLC_TORCH_METRICS_PORT", "0")
    monkeypatch.setenv("MPLC_TORCH_METRICS_TOKEN", TOKEN)
    svc = SweepService(start=False)
    try:
        job = svc.submit(scenario(0), tenant="tenantA")
        svc.run_until_idle()
        assert job.status == "completed"
        peer = f"127.0.0.1:{export.active_port()}"
        dead = "127.0.0.1:1"
        ours = fleet_view.FleetCollector(peers=[peer, dead], token=TOKEN).collect()
        theirs = jfleet_view.FleetCollector(peers=[peer, dead], token=TOKEN).collect()
        # the port's registry moves between the two reads (its own spans)
        for snap in (ours, theirs):
            for k in ("merged", "slo", "ts"):
                snap.pop(k)
            snap["shards"][f"peer:{dead}"].pop("error")
        assert ours == theirs
        assert ours["shards"][f"peer:{peer}"]["ok"] and ours["fresh_shards"] == 1
        assert not ours["shards"][f"peer:{dead}"]["ok"]
        assert ours["tenant_device_seconds"]["tenantA"] > 0
        # a wrong token: the peer answers 401, an error row
        bad = fleet_view.FleetCollector(peers=[peer], token="wrong").collect()
        assert not bad["shards"][f"peer:{peer}"]["ok"] and bad["merged_sources"] == 0
    finally:
        svc.shutdown()


def test_fleet_metrics_text_uses_fleet_prefix():
    h = obs_metrics.Histogram("service.queue_wait_sec", {"tenant": "t0"})
    h.observe(0.5)
    merged = obs_metrics.merge_snapshots([{
        "counters": {"engine.batches": 5}, "gauges": {"g.x": 2},
        "histograms": {"service.queue_wait_sec{tenant=t0}": _hist_snapshot_entry(h)}}])
    text = fleet_view.fleet_metrics_text(merged)
    assert "mplc_fleet_engine_batches 5" in text
    assert 'mplc_fleet_service_queue_wait_sec_bucket{le="+Inf",tenant="t0"} 1' in text
    assert "\nmplc_engine_batches" not in text
    assert text == jfleet_view.fleet_metrics_text(merged)


def test_collector_spans_are_the_jax_packages(tmp_path):
    d = str(tmp_path / "state")
    fleet.publish_shard_state(d, "a", {"queue_depth": 0, "metrics": {}})
    with obs_trace.collect() as recs:
        fleet_view.FleetCollector(state_dir=d).collect()
    with jtrace.collect() as jrecs:
        jfleet_view.FleetCollector(state_dir=d).collect()
    assert [r["name"] for r in recs] == [r["name"] for r in jrecs] == \
        ["fleet.scrape", "fleet.collect"]
    assert recs[0]["attrs"] == jrecs[0]["attrs"]


# -- the cluster view the collector reads -------------------------------------------

def test_cluster_view_clamps_future_ts_to_age_zero(tmp_path):
    d = str(tmp_path / "state")
    fleet.publish_shard_state(d, "alpha", {"queue_depth": 2})
    p = os.path.join(d, "shard_alpha.json")
    doc = json.loads(open(p).read())
    doc["ts"] += 3600
    with open(p, "w") as f:
        json.dump(doc, f)
    view = fleet.cluster_view(d)
    assert view["shards"]["alpha"]["age_sec"] == 0.0
    assert view["shards"]["alpha"]["stale"] is False
    assert view["live_shards"] == 1 and view["cluster_queue_depth"] == 2


def test_cluster_view_default_strips_embedded_metrics(tmp_path):
    d = str(tmp_path / "state")
    fleet.publish_shard_state(d, "alpha", {"queue_depth": 0, "metrics": {
        "counters": {"service.device_seconds{tenant=secret}": 1.0}}})
    assert "metrics" not in fleet.cluster_view(d)["shards"]["alpha"]
    withm = fleet.cluster_view(d, include_metrics=True)
    assert "counters" in withm["shards"]["alpha"]["metrics"]
    # the JAX package reads the port's state files as its own
    assert "counters" in jfleet.cluster_view(d, include_metrics=True)["shards"]["alpha"][
        "metrics"]


def test_publish_shard_state_failure_is_counted_never_raised(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    before = obs_metrics.counter("fleet.state_publish_errors").value
    saved = fleet._publish_warned
    fleet._publish_warned = False
    try:
        fleet.publish_shard_state(str(blocker), "alpha", {})
        fleet.publish_shard_state(str(blocker), "alpha", {})
    finally:
        fleet._publish_warned = saved
    assert obs_metrics.counter("fleet.state_publish_errors").value == before + 2


def test_redact_varz_hashes_fleet_topology_keeps_load_scalars():
    doc = {"fleet": {"shards": {"alpha": {"shard": "alpha", "queue_depth": 3,
                                          "stale": False}},
                     "least_loaded": "alpha", "shard_id": "alpha"},
           "shards": {"peer:h1:9090": {"peer": "h1:9090", "ok": True, "queue_depth": 1}}}
    out = export.redact_varz(doc, viewer="tenantA", key="master")
    fv = out["fleet"]
    assert "alpha" not in fv["shards"]
    (tag,) = fv["shards"]
    assert tag.startswith("shard-")
    row = fv["shards"][tag]
    assert row["shard"] == tag
    assert row["queue_depth"] == 3 and row["stale"] is False
    assert fv["least_loaded"] == tag and fv["shard_id"] == tag
    (ptag,) = out["shards"]
    prow = out["shards"][ptag]
    assert prow["peer"].startswith("shard-") and "h1" not in prow["peer"]
    assert prow["queue_depth"] == 1


# -- the process's collector and the export's /fleet routes ---------------------------

def test_collector_from_env_and_the_installed_collector(tmp_path, monkeypatch):
    assert fleet_view.collector_from_env() is None
    assert fleet_view.get_or_create_collector() is None
    monkeypatch.setenv("MPLC_TORCH_FLEET_PEERS", " h1:1, ,h2:2 ")
    monkeypatch.setenv("MPLC_TORCH_METRICS_TOKEN", TOKEN)
    monkeypatch.setenv("MPLC_TORCH_FLEET_STATE_DIR", str(tmp_path))
    c = fleet_view.collector_from_env()
    assert (c.peers, c.token, c.state_dir) == (["h1:1", "h2:2"], TOKEN, str(tmp_path))
    mine = fleet_view.FleetCollector(state_dir=str(tmp_path))
    fleet_view.set_collector(mine)
    assert fleet_view.active_collector() is mine
    assert fleet_view.get_or_create_collector() is mine


def test_fleet_routes_serve_the_merged_view(tmp_path, monkeypatch):
    d = str(tmp_path / "state")
    for i, snap in enumerate(_shard_snapshots()):
        fleet.publish_shard_state(d, f"s{i}", {"queue_depth": i, "metrics": snap})
    monkeypatch.setenv("MPLC_TORCH_METRICS_TOKEN", TOKEN)
    srv = export.start(0)
    base = f"http://127.0.0.1:{srv.port}"
    # no collector configured: 404, saying so
    status, body = _get(base + "/fleet/varz", TOKEN)
    assert status == 404 and "fleet collector" in body
    monkeypatch.setenv("MPLC_TORCH_FLEET_STATE_DIR", d)
    status, text = _get(base + "/fleet/metrics", TOKEN)
    merged = fleet_view.FleetCollector(state_dir=d).collect()["merged"]
    assert status == 200 and text == fleet_view.fleet_metrics_text(merged)
    assert 'mplc_fleet_service_device_seconds{tenant="t1"} 0.5' in text
    status, body = _get(base + "/fleet/varz", TOKEN)
    doc = json.loads(body)
    assert status == 200 and doc["shard_count"] == 2 and doc["collector"]["state_dir"] == d
    assert set(doc["shards"]) == {"s0", "s1"}
    # the credentials: none is a 401; a tenant's unlocks the redacted JSON
    # view but never the Prometheus text
    assert _get(base + "/fleet/varz")[0] == 401
    tenant = export.tenant_token(TOKEN, "t0")
    assert _get(base + "/fleet/metrics?tenant=t0", tenant)[0] == 401
    status, body = _get(base + "/fleet/varz?tenant=t0", tenant)
    doc = json.loads(body)
    assert status == 200 and "s0" not in doc["shards"]
    assert all(s.startswith("shard-") for s in doc["shards"])
    assert doc["tenant_device_seconds"]["t0"] == pytest.approx(5.0)
    assert "t1" not in doc["tenant_device_seconds"]

    # a collector that fails is a 503, never a 500
    class Broken(fleet_view.FleetCollector):
        def collect(self):
            raise RuntimeError("peer table corrupt")
    fleet_view.set_collector(Broken())
    status, body = _get(base + "/fleet/metrics", TOKEN)
    assert status == 503 and "peer table corrupt" in body
    assert _get(base + "/fleet/varz", TOKEN)[0] == 503
