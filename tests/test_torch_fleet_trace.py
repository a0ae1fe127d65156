"""The fleet sweep's observability in the port (`obs/trace.py`'s fleet
stamps, `obs/fleet_view.py`'s merged timeline, `parallel/fleet.py`'s
incident bundle, `mplc_tpu_torch.fleet_trace_merge`) against the JAX
package's, on the CPU, one torch thread:

- every record emitted while the fleet run id is set carries `fleet_run`
  and `fleet_shard`, and none outside; a collector nested in another
  closes itself, not the outer one;
- `_clock_offset` equal to the JAX function's on a grid of manifests and
  results, with and without a done-seen time and a handshake;
- the port's `merge_fleet_traces` over a port in-process run of 2 shards:
  2 tracks, 2 flow links landing on pids 10 and 11, no shard record on
  the coordinator's pid 1;
- the JAX package's `merge_shard_results` and `merge_fleet_traces` reading
  the port's output folder to the port's values, tracks, flow links and
  offsets;
- a shard of 2 worker processes killed by `crash@batch1` leaving exactly
  one incident bundle;
- the selfcheck CLI on the CPU exiting 0; the merge CLI writing the
  timeline, and exiting non-zero on a folder without a shard stream.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mplc_tpu.obs import fleet_view as jfleet_view
from mplc_tpu.parallel import fleet as jfleet
from mplc_tpu_torch.obs import fleet_view
from mplc_tpu_torch.obs import metrics as obs_metrics
from mplc_tpu_torch.obs import trace as obs_trace
from mplc_tpu_torch.parallel import fleet

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC = fleet.FleetSpec()
KNOBS = ("DETERMINISTIC_REDUCE", "NUMERICS_LEDGER", "FAULT_PLAN", "COALITIONS_PER_DEVICE",
         "COMPILE_CACHE_DIR", "TRACE_FILE", "CHROME_TRACE_FILE", "FLEET_RUN_ID",
         "FLEET_SHARD_ID", "FLEET_STATE_DIR", "PARTNER_FAULT_PLAN", "SEED_ENSEMBLE",
         "NO_SLOTS", "PRECISION")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        for knob in KNOBS:
            monkeypatch.delenv(pkg + knob, raising=False)
    monkeypatch.setenv("MPLC_TORCH_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))


@pytest.fixture(scope="module")
def inproc_run(tmp_path_factory):
    """A port in-process run of 2 shards on the CPU: (result, folder)."""
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        for knob in KNOBS:
            os.environ.pop(pkg + knob, None)
    out = tmp_path_factory.mktemp("inproc") / "run"
    return fleet.run_fleet(SPEC, 2, str(out), inproc=True, device="cpu"), out


def test_records_stamped_with_fleet_context():
    with fleet._env_overlay({obs_trace.FLEET_RUN_ID_ENV: "fleet-abc123",
                             obs_trace.FLEET_TRACE_SHARD_ENV: "shard3"}):
        with obs_trace.collect() as recs:
            obs_trace.event("fleet.scrape", shard="s", source="t", ok=True)
            with obs_trace.span("fleet.merge", shards=1):
                pass
    assert len(recs) == 2
    assert all(r["fleet_run"] == "fleet-abc123" and r["fleet_shard"] == "shard3"
               for r in recs)
    # a run id without a shard (the coordinator) stamps the run alone
    with fleet._env_overlay({obs_trace.FLEET_RUN_ID_ENV: "fleet-abc123",
                             obs_trace.FLEET_TRACE_SHARD_ENV: None}):
        with obs_trace.collect() as recs2:
            obs_trace.event("fleet.scrape", shard="s", source="t", ok=True)
    assert recs2[0]["fleet_run"] == "fleet-abc123" and "fleet_shard" not in recs2[0]
    # a shard id without a run (a service's state-plane name) stamps nothing
    with fleet._env_overlay({obs_trace.FLEET_RUN_ID_ENV: None,
                             obs_trace.FLEET_TRACE_SHARD_ENV: "shard3"}):
        with obs_trace.collect() as recs3:
            obs_trace.event("fleet.scrape", shard="s", source="t", ok=True)
    assert "fleet_run" not in recs3[0] and "fleet_shard" not in recs3[0]
    assert obs_trace.FLEET_RUN_ID_ENV == "MPLC_TORCH_FLEET_RUN_ID"
    assert obs_trace.FLEET_TRACE_SHARD_ENV == fleet.FLEET_SHARD_ID_ENV


def test_nested_collectors_close_by_identity():
    """An inner collector that saw the same records as the outer one (the
    coordinator's collector inside a caller's) closes itself, not the
    outer one, so the caller still sees what comes after it."""
    with obs_trace.collect() as outer:
        with obs_trace.collect() as inner:
            obs_trace.event("fleet.merge", shards=1)
        assert inner == outer
        obs_trace.event("fleet.incident", run="r", reason="x", failed_shards=0, path="p")
    assert [r["name"] for r in outer] == ["fleet.merge", "fleet.incident"]
    assert [r["name"] for r in inner] == ["fleet.merge"]


MANIFESTS = [{}, {"spawn_ts": {"0": 100.0}},
             {"spawn_ts": {"0": 100.0}, "done_seen_ts": {"0": 110.0}},
             {"spawn_ts": {"1": 50.0}, "done_seen_ts": {"1": 60.5}}]
RESULTS = [None, {}, {"clock": {"worker_start_ts": 96.0, "worker_end_ts": 104.0}},
           {"clock": {"coord_spawn_ts": 99.5, "worker_start_ts": 96.0,
                      "worker_end_ts": 104.0}},
           {"clock": {"coord_spawn_ts": 99.5, "worker_start_ts": 96.0}}]


@pytest.mark.parametrize("shard", [0, 1])
def test_clock_offset_equals_jax(shard):
    for manifest in MANIFESTS:
        for result in RESULTS:
            got = fleet_view._clock_offset(manifest, result, shard)
            assert got == jfleet_view._clock_offset(manifest, result, shard), (manifest, result)
    # the midpoint rule: a 5 s skew behind, symmetric latencies, comes back 5
    assert fleet_view._clock_offset(MANIFESTS[2], RESULTS[2], 0) == 5.0
    assert fleet_view._clock_offset(MANIFESTS[1], RESULTS[2], 0) == 4.0
    assert fleet_view._clock_offset({}, None, 0) == 0.0


def test_merged_timeline_of_an_inproc_run(inproc_run):
    res, out = inproc_run
    assert len(res.values) == 7
    merged = fleet_view.merge_fleet_traces(str(out))
    assert merged["shard_tracks"] == 2 and merged["flow_links"] == 2
    assert merged["torn_lines"] == 0 and set(merged["offsets"]) == {"0", "1"}
    ev = merged["trace"]["traceEvents"]
    coord = [e for e in ev if e.get("pid") == 1 and e["ph"] == "X"]
    assert coord and all(not (e["args"] or {}).get("fleet_shard") for e in coord)
    assert {e["name"] for e in coord} == {"fleet.sweep", "fleet.shard", "fleet.merge"}
    names = {e["args"]["name"] for e in ev if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"fleet coordinator", "shard 0", "shard 1"}
    flows = [e for e in ev if e.get("cat") == "flow"]
    assert sorted(e["ph"] for e in flows) == ["f", "f", "s", "s"]
    assert {e["pid"] for e in flows if e["ph"] == "f"} == {10, 11}
    run_id = merged["trace"]["otherData"]["run_id"]
    assert run_id.startswith("fleet-")
    shard_recs = [e for e in ev if e["ph"] == "X" and (e["args"] or {}).get("fleet_shard")]
    assert shard_recs and all(e["args"]["fleet_run"] == run_id for e in shard_recs)
    assert {e["pid"] for e in shard_recs} == {10, 11}
    # every shard's root span and its engine's spans are in its stream
    for pid in (10, 11):
        assert {"fleet.shard_run", "engine.evaluate"} <= {
            e["name"] for e in ev if e.get("pid") == pid and e["ph"] == "X"}


def test_jax_merge_reads_the_ports_folder(inproc_run):
    res, out = inproc_run
    values, merged, reports = jfleet.merge_shard_results(jfleet.FleetSpec(), 2, str(out))
    assert values == res.values
    assert merged == res.ledger
    assert [r["subsets"] for r in reports] == [r["subsets"] for r in res.shard_reports]
    mine, theirs = (f.merge_fleet_traces(str(out)) for f in (fleet_view, jfleet_view))
    for key in ("shard_tracks", "flow_links", "offsets", "records", "torn_lines"):
        assert mine[key] == theirs[key], key
    strip = [{k: v for k, v in e.items() if k != "args"} for e in mine["trace"]["traceEvents"]]
    jstrip = [{k: v for k, v in e.items() if k != "args"}
              for e in theirs["trace"]["traceEvents"]]
    assert strip == jstrip
    # and the JAX collector's snapshot sees both shards, fresh
    snap = jfleet_view.cluster_snapshot(out_dir=str(out))
    assert set(snap["shards"]) == {"shard0", "shard1"} and snap["fresh_shards"] == 2


def test_killed_shard_yields_exactly_one_incident_bundle(tmp_path):
    out = tmp_path / "killed"
    before = obs_metrics.counter("fleet.incidents").value
    with obs_trace.collect() as recs:
        with pytest.raises(fleet.FleetError, match="1 fleet worker"):
            fleet.run_fleet(SPEC, 2, str(out), device="cpu", threads=1, timeout=300,
                            per_shard_env={1: {"MPLC_TORCH_FAULT_PLAN": "crash@batch1"}})
    incidents = sorted(p for p in os.listdir(out) if p.startswith("incident_"))
    assert len(incidents) == 1, incidents
    inc = out / incidents[0]
    bundle = json.loads((inc / "incident.json").read_text())
    assert bundle["reason"] == "shard_failure" and bundle["failed_shards"] == [1]
    art = bundle["shard_artifacts"]["1"]
    assert art["flight_dumps"] and all((inc / n).exists() for n in art["flight_dumps"])
    dump = json.loads((inc / art["flight_dumps"][0]).read_text())
    assert dump["reason"] == "fleet_worker_crash" and dump["extra"]["shard"] == 1
    assert (inc / art["trace_tail"]).exists() and art["trace_tail_records"] > 0
    assert "InjectedCrash" in art["log_tail"]
    assert art["ledger_digest"] is None
    assert bundle["cluster"]["shards"]["shard0"]["fresh"] is True
    assert "shard1" not in bundle["cluster"]["shards"]
    assert obs_metrics.counter("fleet.incidents").value == before + 1
    assert [r["attrs"]["reason"] for r in recs if r["name"] == "fleet.incident"] == \
        ["shard_failure"]
    assert not (out / ".shard1.done").exists() and (out / ".shard0.done").exists()
    # the surviving shard's and the coordinator's streams still merge
    merged = fleet_view.merge_fleet_traces(str(out))
    assert merged["shard_tracks"] == 2 and merged["flow_links"] >= 1


def test_selfcheck_on_the_cpu_exits_zero(tmp_path):
    env = fleet.worker_env(threads=1)
    r = subprocess.run([sys.executable, "-m", "mplc_tpu_torch.parallel.fleet", "--selfcheck",
                        "--shards", "2", "--obs-dir", str(tmp_path / "obs"), "--device", "cpu",
                        "--threads", "1"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["ok"] is True and doc["max_ulp"] == 0 and doc["kendall_tau"] == 1.0
    assert doc["subsets"] == 7 and doc["devices"] == ["cpu"]
    assert doc["obs"]["shard_tracks"] == doc["obs"]["flow_links"] == 2
    assert doc["obs"]["snapshot_shards"] == 2
    assert (tmp_path / "obs" / "fleet_trace.json").exists()


def test_merge_cli_writes_the_timeline_and_fails_on_an_empty_folder(inproc_run, tmp_path):
    _res, out = inproc_run
    target = tmp_path / "timeline.json"
    r = subprocess.run([sys.executable, "-m", "mplc_tpu_torch.fleet_trace_merge", str(out),
                        "-o", str(target)], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["shard_tracks"] == 2 and doc["flow_links"] == 2 and doc["out"] == str(target)
    trace = json.loads(target.read_text())
    assert trace["otherData"]["shards"] == 2 and trace["traceEvents"]
    (tmp_path / "empty").mkdir()
    r = subprocess.run([sys.executable, "-m", "mplc_tpu_torch.fleet_trace_merge",
                        str(tmp_path / "empty")], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 1 and "no trace_shardI.jsonl" in r.stderr
    assert not (tmp_path / "empty" / "fleet_trace.json").exists()
