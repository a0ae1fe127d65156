"""The port's fleet router (`mplc_tpu_torch/service/router.py`) after
tests/test_router.py, on the CPU, one torch thread, the Titanic 3-partner
game of tests/test_service.py:

- FAILOVER BIT-EQUALITY: a job whose accepting shard is killed mid-run is
  resubmitted to a survivor seeded from the dead shard's journal, and its
  v(S) table is bit-equal to a solo fault-free run of the port's engine;
- STICKINESS: a tenant's jobs land on its pinned shard; the pin breaks
  only on shard death or sustained overload, once an event, journaled;
- CLASSIFIED EXHAUSTION: past the budget the caller gets RoutedJobFailed
  chaining the last shard error, never an unbounded redirect loop;
- SHED COORDINATION: a deferring shard is offered nothing new while a
  healthy sibling exists;
- against the JAX package: the router fault plans parse to the same lists;
  the same inline harness (2 shards, Titanic games, a kill at a fixed pump
  or by the plan) routes every job to the same shard with the same
  attempts, re-pins and failovers, and every table is within one test
  sample of the JAX run, the port fed the JAX engine's initial params;
- the wire: a ShardServer and an HttpShard over real HTTP on port 0 (a
  failover from the peer to an in-process survivor included), the
  credential rule, HTTP errors as service errors, the load harness's
  `--router` wiring.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from mplc_tpu import faults as jfaults
from mplc_tpu.obs import metrics as jmetrics
from mplc_tpu.service import FleetRouter as JFleetRouter
from mplc_tpu.service import SweepService as JSweepService
from mplc_tpu_torch import constants, faults
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.convert import params_from_numpy
from mplc_tpu_torch.obs import export as obs_export
from mplc_tpu_torch.obs import metrics, trace
from mplc_tpu_torch.parallel import fleet
from mplc_tpu_torch.service import (FleetRouter, RoutedJobFailed, ServiceAuthError,
                                    SweepJournal, SweepService)
from mplc_tpu_torch.service.router import HttpShard, InProcShard, ShardServer
from torch_service_helpers import (P, SUBSETS, clean_env, jax_scenario, scenario,
                                   solo_values)

REPO = Path(__file__).resolve().parents[1]
ROUTER_KNOBS = ("ROUTER_BUDGET", "ROUTER_BACKOFF_SEC", "ROUTER_REPIN_OVERLOADS",
                "ROUTER_FAULT_PLAN", "ROUTER_SERVE", "FLEET_STALE_SEC", "FLEET_SHARD_ID",
                "FLEET_PEERS")


@pytest.fixture(autouse=True)
def _router_env(monkeypatch, tmp_path):
    clean_env(monkeypatch, tmp_path)
    for knob in ROUTER_KNOBS:
        for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
            monkeypatch.delenv(pkg + knob, raising=False)
    metrics.reset()
    jmetrics.reset()
    yield
    obs_export.stop()
    metrics.reset()
    jmetrics.reset()


def values_of_routed(handle) -> np.ndarray:
    vals = handle.values()
    return np.array([vals[s] for s in SUBSETS])


def _two_shard_router(tmp_path, slice_coalitions=2, **router_kw):
    s0 = SweepService(start=False, slice_coalitions=slice_coalitions,
                      journal_path=str(tmp_path / "s0.wal"))
    s1 = SweepService(start=False, slice_coalitions=slice_coalitions,
                      journal_path=str(tmp_path / "s1.wal"))
    r = FleetRouter(shards={"s0": s0, "s1": s1}, backoff_sec=0.0, **router_kw)
    return r, s0, s1


def _close(r, *services):
    r.close()
    for s in services:
        s.shutdown(drain=False)


# -- the fault-plan grammar ------------------------------------------------------

ROUTER_PLANS = ["shardkill@shard1:sec5, shardkill@pid_a:sec0.5", "shardkill@s:sec1",
                "", None]
MALFORMED = ["bogus@x, shardkill@s:sec1", "shardkill@shard0", "shardkill@a:sec1,kill@b:sec2",
             "shardkill@a b:sec1"]


@pytest.mark.parametrize("spec", ROUTER_PLANS + MALFORMED, ids=range(8))
def test_router_plan_parses_as_jax(spec):
    with _warns_if(spec in MALFORMED):
        got = faults.parse_router_fault_plan(spec)
    with _warns_if(spec in MALFORMED):
        want = jfaults.parse_router_fault_plan(spec)
    assert got == want


def _warns_if(malformed: bool):
    """`pytest.warns` of the malformed-entry warning, or a context in which
    any warning fails the test."""
    if malformed:
        return pytest.warns(UserWarning, match="malformed")
    import warnings
    cm = warnings.catch_warnings()

    class _Strict:
        def __enter__(self):
            cm.__enter__()
            warnings.simplefilter("error")

        def __exit__(self, *exc):
            return cm.__exit__(*exc)
    return _Strict()


def test_router_fault_plan_grammar(monkeypatch):
    plan = faults.parse_router_fault_plan("shardkill@shard1:sec5, shardkill@pid_a:sec0.5")
    assert plan == [{"kind": "shardkill", "shard": "pid_a", "at_sec": 0.5},
                    {"kind": "shardkill", "shard": "shard1", "at_sec": 5.0}]
    # malformed entries are warned about and dropped, never fatal
    with pytest.warns(UserWarning, match="malformed"):
        plan = faults.parse_router_fault_plan("bogus@x, shardkill@s:sec1")
    assert plan == [{"kind": "shardkill", "shard": "s", "at_sec": 1.0}]
    assert faults.parse_router_fault_plan("") == []
    assert faults.parse_router_fault_plan(None) == []
    monkeypatch.setenv("MPLC_TORCH_ROUTER_FAULT_PLAN", "shardkill@shard0:sec2")
    assert faults.router_fault_plan_from_env() == [
        {"kind": "shardkill", "shard": "shard0", "at_sec": 2.0}]


def test_router_knobs_default_as_in_jax(monkeypatch):
    r = FleetRouter(shards={})
    assert (r._budget, r._backoff, r._repin_overloads) == (8, 0.05, 3)
    r.close()
    monkeypatch.setenv("MPLC_TORCH_ROUTER_BUDGET", "3")
    monkeypatch.setenv("MPLC_TORCH_ROUTER_BACKOFF_SEC", "0.5")
    monkeypatch.setenv("MPLC_TORCH_ROUTER_REPIN_OVERLOADS", "2")
    r = FleetRouter(shards={})
    assert (r._budget, r._backoff, r._repin_overloads) == (3, 0.5, 2)
    r.close()


# -- failover ----------------------------------------------------------------------

def test_midrun_failover_is_bit_identical_and_journal_seeded(tmp_path):
    """Kill the accepting shard after one partial quantum: the survivor is
    seeded from the dead shard's WAL and the final table is bit-equal to
    the solo fault-free run."""
    ref = solo_values(7)
    r, s0, s1 = _two_shard_router(tmp_path, journal_path=str(tmp_path / "rt.wal"))
    h = r.submit(scenario(7), tenant="t0")
    first = h.shard_id
    r.pump()                      # partial progress on the first shard
    assert not h.done
    r.kill_shard(first)
    assert h.failed_over
    assert h.shard_id != first
    r.run_until_idle(timeout=600)
    assert h.status == "completed"
    # the survivor's engine was seeded from the dead shard's journal
    assert h._inner.recovered_values >= 1
    np.testing.assert_array_equal(values_of_routed(h), ref)
    assert r.stats["failovers"] == 1
    # the death broke the tenant's pin once, journaled
    assert r.stats["repins"] == 1
    records, torn = SweepJournal.replay(str(tmp_path / "rt.wal"))
    repins = [rec for rec in records if rec.get("type") == "repin"]
    assert not torn and len(repins) == 1
    assert repins[0]["reason"] == "death" and repins[0]["from"] == first
    _close(r, s0, s1)


def test_repin_once_per_death_even_with_multiple_victims(tmp_path):
    ref7, ref8 = solo_values(7), solo_values(8)
    r, s0, s1 = _two_shard_router(tmp_path)
    ha = r.submit(scenario(7), tenant="A")
    hb = r.submit(scenario(8), tenant="B", job_id="b1")
    pins = dict(r._pins)
    r.pump()
    victim_shard = ha.shard_id
    repins_expected = len({t for t, sid in pins.items() if sid == victim_shard})
    r.kill_shard(victim_shard)
    assert r.stats["repins"] == repins_expected
    r.run_until_idle(timeout=600)
    assert ha.status == "completed" and hb.status == "completed"
    np.testing.assert_array_equal(values_of_routed(ha), ref7)
    np.testing.assert_array_equal(values_of_routed(hb), ref8)
    _close(r, s0, s1)


def test_all_shards_dead_is_classified_not_hung(tmp_path):
    r, s0, s1 = _two_shard_router(tmp_path)
    h = r.submit(scenario(7), tenant="t0")
    r.pump()
    r.kill_shard("s0")
    r.kill_shard("s1")
    assert h.done
    assert h.status == "failed"
    with pytest.raises(RoutedJobFailed):
        h.result(timeout=5)
    _close(r, s0, s1)


# -- redirects and the budget ------------------------------------------------------

def test_budget_exhaustion_is_classified(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_SERVICE_RETRY_FLOOR_SEC", "0")
    svc = SweepService(start=False, max_pending=1, slice_coalitions=1)
    svc.submit(scenario(7), tenant="filler")      # the queue is full
    r = FleetRouter(shards={"only": svc}, budget=1, backoff_sec=0.0)
    with trace.collect() as recs:
        with pytest.raises(RoutedJobFailed) as ei:
            r.submit(scenario(8), tenant="t0")
    assert ei.value.attempts == 1
    assert "ServiceOverloaded" in type(ei.value.__cause__).__name__
    assert r.stats["budget_exhausted"] == 1
    assert "router.exhausted" in [rec["name"] for rec in recs]
    _close(r, svc)


def test_redirect_loop_terminates_on_budget(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_SERVICE_RETRY_FLOOR_SEC", "0")
    s0 = SweepService(start=False, max_pending=1, slice_coalitions=1)
    s1 = SweepService(start=False, max_pending=1, slice_coalitions=1)
    s0.submit(scenario(7), tenant="filler")
    s1.submit(scenario(8), tenant="filler")
    r = FleetRouter(shards={"s0": s0, "s1": s1}, budget=4, backoff_sec=0.0)
    with trace.collect() as recs:
        with pytest.raises(RoutedJobFailed) as ei:
            r.submit(scenario(9), tenant="t0")
    assert ei.value.attempts == 4
    assert len([rec for rec in recs if rec["name"] == "router.redirect"]) == 4
    assert r.stats["resubmits"] == 4
    _close(r, s0, s1)


# -- shed coordination and stickiness ---------------------------------------------

def test_deferring_shard_is_not_offered_new_work(tmp_path):
    s0 = SweepService(start=False, slice_coalitions=2, shed_p99_sec=0.001)
    s1 = SweepService(start=False, slice_coalitions=2)
    r = FleetRouter(shards={"s0": s0, "s1": s1}, backoff_sec=0.0)
    assert s0._admission.evaluate([10.0]) == "deferring"
    h = r.submit(scenario(7), tenant="t0")
    assert h.shard_id == "s1"
    r.run_until_idle(timeout=600)
    assert h.status == "completed"
    _close(r, s0, s1)


def test_tenant_stickiness_overrides_least_loaded(tmp_path):
    r, s0, s1 = _two_shard_router(tmp_path)
    h1 = r.submit(scenario(7), tenant="sticky")
    pinned = h1.shard_id
    h2 = r.submit(scenario(8), tenant="sticky", job_id="st2")
    assert h2.shard_id == pinned
    other = r.submit(scenario(9), tenant="roamer")
    assert other.shard_id != pinned
    r.run_until_idle(timeout=600)
    assert all(h.status == "completed" for h in (h1, h2, other))
    _close(r, s0, s1)


def test_sustained_overload_breaks_pin_deliberately(tmp_path, monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_SERVICE_RETRY_FLOOR_SEC", "0")
    s0 = SweepService(start=False, max_pending=1, slice_coalitions=1)
    s1 = SweepService(start=False, slice_coalitions=1)
    r = FleetRouter(shards={"s0": s0, "s1": s1}, budget=8, backoff_sec=0.0,
                    repin_overloads=1, journal_path=str(tmp_path / "rt.wal"))
    r._pins["t0"] = "s0"
    s0.submit(scenario(7), tenant="filler")
    h = r.submit(scenario(8), tenant="t0")   # overload -> break -> s1
    assert h.shard_id == "s1"
    assert r.stats["repins"] == 1
    assert r._pins["t0"] == "s1"             # the pin follows the work
    records, torn = SweepJournal.replay(str(tmp_path / "rt.wal"))
    repins = [rec for rec in records if rec.get("type") == "repin"]
    assert not torn and len(repins) == 1
    assert repins[0]["reason"] == "overload"
    assert repins[0]["from"] == "s0" and repins[0]["tenant"] == "t0"
    r.run_until_idle(timeout=600)
    assert h.status == "completed"
    _close(r, s0, s1)


# -- the authenticated submit path -------------------------------------------------

def test_submit_auth_master_and_tenant_token(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_METRICS_TOKEN", "hunter2")
    svc = SweepService(start=False, slice_coalitions=4)
    ok0 = svc.submit(scenario(7), tenant="A")
    ok1 = svc.submit(scenario(8), tenant="A", credential="hunter2", job_id="j1")
    ok2 = svc.submit(scenario(9), tenant="B",
                     credential=obs_export.tenant_token("hunter2", "B"), job_id="j2")
    with pytest.raises(ServiceAuthError):
        svc.submit(scenario(10), tenant="B", credential="wrong")
    with pytest.raises(ServiceAuthError):
        svc.submit(scenario(10), tenant="B",
                   credential=obs_export.tenant_token("hunter2", "A"))
    assert metrics.snapshot()["counters"].get("service.auth_rejected") == 2
    svc.run_until_idle()
    assert all(j.status == "completed" for j in (ok0, ok1, ok2))
    svc.shutdown(drain=False)


def test_wire_submit_requires_credential_when_token_set(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_METRICS_TOKEN", "hunter2")
    svc = SweepService(start=False, slice_coalitions=4)
    srv = ShardServer(svc, lambda spec: scenario(7))
    with pytest.raises(ServiceAuthError):
        srv.handle("submit", {"tenant": "A"})
    ack = srv.handle("submit", {"tenant": "A", "credential": "hunter2"})
    assert ack["tenant"] == "A"
    svc.run_until_idle()
    srv.close()
    svc.shutdown(drain=False)


def test_wire_submit_rejected_credential_mutates_nothing(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_METRICS_TOKEN", "hunter2")
    svc = SweepService(start=False, slice_coalitions=4)
    built = []
    srv = ShardServer(svc, lambda spec: built.append(spec) or scenario(7))
    evil = {"tenant": "A", "credential": "wrong", "job_id": "poisoned",
            "recover": {"partners_count": P, "values": [[[0], 666.0], [[1], 666.0]]}}
    with pytest.raises(ServiceAuthError):
        srv.handle("submit", evil)
    evil["credential"] = obs_export.tenant_token("hunter2", "B")
    with pytest.raises(ServiceAuthError):
        srv.handle("submit", evil)
    assert "poisoned" not in svc._recovered
    assert built == []
    svc.adopt_recovered("poisoned", tenant="A", partners_count=P, values={(0,): 0.25})
    assert svc._recovered["poisoned"]["values"] == {(0,): 0.25}
    srv.close()
    svc.shutdown(drain=False)


def _req(job_id):
    return {"scenario": scenario(7), "method": "Shapley values", "tenant": "t0",
            "job_id": job_id, "deadline_sec": None, "priority": None, "credential": None}


def test_adopt_recovered_refuses_differing_seed():
    svc = SweepService(start=False, slice_coalitions=4)
    shard = InProcShard("s", svc)
    req = _req("jD")
    shard._adopt({"values": {(1,): 0.5}, "partners_count": P}, req)
    shard._adopt({"values": {(1,): 0.5}, "partners_count": P}, req)
    with pytest.raises(ValueError, match="differs"):
        shard._adopt({"values": {(1,): 0.75}, "partners_count": P}, req)
    with pytest.raises(ValueError, match="differs"):
        shard._adopt({"values": {(1,): 0.5}, "partners_count": P + 1}, req)
    assert svc._recovered["jD"]["values"] == {(1,): 0.5}
    svc.shutdown(drain=False)


# -- the cluster view's staleness --------------------------------------------------

def test_cluster_view_excludes_stale_and_closed_from_least_loaded(tmp_path, monkeypatch):
    d = str(tmp_path)
    fleet.publish_shard_state(d, "dead", {"queue_depth": 0})
    fleet.publish_shard_state(d, "closing", {"queue_depth": 0, "closed": True})
    fleet.publish_shard_state(d, "busy", {"queue_depth": 9})
    path = os.path.join(d, "shard_dead.json")
    with open(path) as f:
        doc = json.load(f)
    doc["ts"] = time.time() - 100.0
    with open(path, "w") as f:
        json.dump(doc, f)
    view = fleet.cluster_view(d, stale_sec=30.0)
    assert view["shards"]["dead"]["stale"]
    assert view["live_shards"] == 1 and view["stale_shards"] == 1
    assert view["least_loaded"] == "busy"
    monkeypatch.setenv("MPLC_TORCH_FLEET_STALE_SEC", "1000")
    view = fleet.cluster_view(d)
    assert not view["shards"]["dead"]["stale"]
    assert view["least_loaded"] == "dead"


def test_shutdown_publishes_closed_state_immediately(tmp_path, monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_FLEET_STATE_DIR", str(tmp_path))
    monkeypatch.setenv("MPLC_TORCH_FLEET_SHARD_ID", "sX")
    svc = SweepService(start=False, slice_coalitions=4)
    svc.shutdown(drain=False)
    view = fleet.cluster_view(str(tmp_path))
    assert view["shards"]["sX"]["closed"]
    assert view["least_loaded"] is None


# -- observability ------------------------------------------------------------------

def test_router_report_row_and_varz(tmp_path):
    from mplc_tpu_torch.obs.report import format_report, sweep_report
    ref = solo_values(7)
    r, s0, s1 = _two_shard_router(tmp_path)
    with trace.collect() as recs:
        h = r.submit(scenario(7), tenant="t0")
        r.pump()
        r.kill_shard(h.shard_id)
        r.run_until_idle(timeout=600)
    np.testing.assert_array_equal(values_of_routed(h), ref)
    rep = sweep_report(recs)
    row = rep["router"]
    assert row["routed"] == 1 and row["failovers"] == 1
    assert row["repins"] == 1 and row["failover_jobs"] == 1
    assert row["route_s"]["p50"] is not None
    assert "  router " in format_report(rep)
    vz = r.varz_view()
    assert vz["jobs"][h.job_id]["failed_over"]
    assert set(vz["table"]) == {"s0", "s1"}
    counters = metrics.snapshot()["counters"]
    assert counters.get("router.jobs_routed") == 1
    assert counters.get("router.failovers") == 1
    # the router's block rides the process's /varz
    assert obs_export.varz_view()[r._provider_key]["failovers"] == 1
    _close(r, s0, s1)


def test_router_fault_plan_drives_kill(tmp_path):
    ref = solo_values(7)
    s0 = SweepService(start=False, slice_coalitions=2)
    s1 = SweepService(start=False, slice_coalitions=2)
    r = FleetRouter(shards={"s0": s0, "s1": s1}, backoff_sec=0.0,
                    fault_plan="shardkill@shard0:sec0")
    with trace.collect() as recs:
        h = r.submit(scenario(7), tenant="t0")
        r.run_until_idle(timeout=600)
    assert [rec for rec in recs if rec["name"] == "router.fault"]
    assert r._shards["s0"].dead
    assert h.status == "completed" and h.shard_id == "s1"
    np.testing.assert_array_equal(values_of_routed(h), ref)
    _close(r, s0, s1)


# -- the load harness's router mode, wired (the JAX package's bench wiring) ----------

def test_cli_router_mode_reads_the_plan_knob(monkeypatch):
    """`--router` without `--fault-plan` takes MPLC_TORCH_ROUTER_FAULT_PLAN
    (as bench config 11 does), a slice of 2 and at most 600 s."""
    from mplc_tpu_torch import load_gen
    seen = {}

    def run_router(**kw):
        seen.update(kw)
        return {"invariant": {"holds": True, "accepted": 3, "stuck": 0,
                              "values_bit_identical_to_solo": True, "failovers": 1}}

    monkeypatch.setattr(load_gen, "run_router", run_router)
    monkeypatch.setenv("MPLC_TORCH_ROUTER_FAULT_PLAN", "shardkill@shard1:sec2")
    assert load_gen.main(["--router", "--jobs", "3", "--device", "cpu"]) == 0
    assert (seen["fault_plan"], seen["slice_coalitions"], seen["jobs"], seen["device"],
            seen["timeout_sec"]) == ("shardkill@shard1:sec2", 2, 3, "cpu", 600.0)
    assert load_gen.main(["--router", "--fault-plan", "", "--device", "cpu"]) == 0
    assert seen["fault_plan"] == "" and constants.ROUTER_FAULT_PLAN_ENV == \
        "MPLC_TORCH_ROUTER_FAULT_PLAN"


def test_load_gen_router_mode_wired():
    from mplc_tpu_torch import load_gen
    assert callable(load_gen.run_router) and callable(load_gen.run_router_shard)
    sc = load_gen.scenario_from_spec({"partners": 2, "seed": 3}, "cpu")
    assert sc.partners_count == 2 and str(sc.device) == "cpu"
    out = subprocess.run([sys.executable, "-m", "mplc_tpu_torch.load_gen", "--help"],
                         capture_output=True, text=True, cwd=REPO, check=True)
    for flag in ("--router", "--router-shards", "--fault-plan", "--fleet", "--device"):
        assert flag in out.stdout, flag


# -- the in-process handle -----------------------------------------------------------

def test_inproc_shard_adoption_is_idempotent():
    svc = SweepService(start=False, slice_coalitions=4)
    shard = InProcShard("s", svc)
    req = _req("jX")
    recover = {"values": {(1,): 0.5}, "partners_count": P}
    shard._adopt(recover, req)
    shard._adopt(recover, req)
    assert svc._jobs.get("jX") is None
    shard.submit(req, recover=recover)
    svc.run_until_idle()
    job = svc._jobs["jX"]
    assert job.status == "completed"
    assert job.recovered_values == 1
    svc.shutdown(drain=False)


def test_backoff_honors_hint_beyond_cap():
    r = FleetRouter(shards={}, backoff_sec=0.0)
    t0 = time.monotonic()
    r._backoff_wait(0.12, attempt=1)
    assert time.monotonic() - t0 >= 0.12
    r.close()


def test_terminal_jobs_pruned_into_bounded_varz_archive(tmp_path):
    r, s0, s1 = _two_shard_router(tmp_path)
    h = r.submit(scenario(7), tenant="t0", job_id="jP")
    assert "jP" in r._routed
    r.run_until_idle(timeout=600)
    assert h.status == "completed"
    r._refresh()
    assert "jP" not in r._routed
    vz = r.varz_view()
    assert vz["jobs"]["jP"]["status"] == "completed"
    assert vz["jobs"]["jP"]["shard"] == h.shard_id
    with pytest.raises(ValueError, match="already routed"):
        r.submit(scenario(8), tenant="t0", job_id="jP")
    _close(r, s0, s1)


def test_threaded_shard_kill_stops_workers_before_failover(tmp_path):
    """Killing a threaded in-process shard stops its worker pool and fences
    its journal before failover replays it: nothing the corpse harvests
    afterwards reaches the WAL, and the failed-over table is bit-equal to
    a solo run."""
    ref = solo_values(7)
    s0 = SweepService(start=True, workers=1, slice_coalitions=1,
                      journal_path=str(tmp_path / "s0.wal"))
    s1 = SweepService(start=False, slice_coalitions=2, journal_path=str(tmp_path / "s1.wal"))
    r = FleetRouter(shards={"s0": s0, "s1": s1}, backoff_sec=0.0)
    r._pins["t0"] = "s0"
    h = r.submit(scenario(7), tenant="t0")
    assert h.shard_id == "s0"
    r.kill_shard("s0")
    assert s0._abandoned and s0._workers == [] and s0._journal_fenced
    wal = (tmp_path / "s0.wal").read_bytes()
    if not h.done:
        assert h.failed_over and h.shard_id == "s1"
    r.run_until_idle(timeout=600)
    assert h.status == "completed"
    np.testing.assert_array_equal(values_of_routed(h), ref)
    assert (tmp_path / "s0.wal").read_bytes() == wal
    _close(r, s0, s1)


def test_abandon_fences_a_quantum_that_outlives_the_join(tmp_path, monkeypatch):
    """A worker still inside a batch when abandon()'s join times out (a
    long batch on the card) appends nothing to the WAL once abandon() has
    returned."""
    import threading
    svc = SweepService(start=True, workers=1, slice_coalitions=2,
                       journal_path=str(tmp_path / "s.wal"))
    inside, release = threading.Event(), threading.Event()
    real = svc._on_batch

    def slow(job, slot_count):
        inside.set()
        release.wait(30)
        return real(job, slot_count)

    monkeypatch.setattr(svc, "_on_batch", slow)
    svc.submit(scenario(7), tenant="t0")
    assert inside.wait(60)
    svc.abandon(timeout=0.05)
    before = (tmp_path / "s.wal").read_bytes()
    thread = [t for t in threading.enumerate() if t.name.startswith("mplc-sweep-service")]
    release.set()
    for t in thread:
        t.join(60)
    assert (tmp_path / "s.wal").read_bytes() == before
    svc.shutdown(drain=False)


# -- the wire -----------------------------------------------------------------------

def test_http_shard_routes_over_real_http_and_fails_over(tmp_path, monkeypatch):
    """A ShardServer behind the telemetry server on port 0, found through
    the state folder: the router submits over POST /router/submit, polls
    GET /router/job, and the table is bit-equal to a solo run; with the
    token set the wire carries the tenant's credential. Then the peer's
    state goes stale and its server stops: the router finds the corpse and
    fails its job over to an in-process survivor seeded from its WAL."""
    state = tmp_path / "state"
    monkeypatch.setenv("MPLC_TORCH_METRICS_PORT", "0")
    monkeypatch.setenv("MPLC_TORCH_ROUTER_SERVE", "1")
    monkeypatch.setenv("MPLC_TORCH_METRICS_TOKEN", "hunter2")
    monkeypatch.setenv("MPLC_TORCH_FLEET_STATE_DIR", str(state))
    monkeypatch.setenv("MPLC_TORCH_FLEET_SHARD_ID", "peer")
    monkeypatch.setenv("MPLC_TORCH_FLEET_STALE_SEC", "1000")
    peer = SweepService(start=False, slice_coalitions=2, journal_path=str(tmp_path / "p.wal"))
    server = ShardServer(peer, lambda spec: scenario(int(spec["seed"])))
    peer._publish_fleet_state(force=True)
    monkeypatch.delenv("MPLC_TORCH_FLEET_STATE_DIR")
    r = FleetRouter(state_dir=str(state), backoff_sec=0.0, credential="hunter2")
    h = r.submit(spec={"partners": P, "seed": 7}, tenant="A",
                 credential=obs_export.tenant_token("hunter2", "A"))
    assert h.shard_id == "peer" and isinstance(r._shards["peer"], HttpShard)
    peer.run_until_idle()
    assert h.result(timeout=30) is not None and h.status == "completed"
    np.testing.assert_array_equal(values_of_routed(h), solo_values(7))
    # a second job, with its scenario for an in-process shard beside its
    # spec for the peer: one quantum on the peer, then the peer dies
    h2 = r.submit(scenario(8), spec={"partners": P, "seed": 8}, tenant="A", job_id="j2",
                  credential=obs_export.tenant_token("hunter2", "A"))
    peer.step()
    survivor = SweepService(start=False, slice_coalitions=2)
    r.add_shard("local", survivor)
    obs_export.stop()
    peer.abandon()
    monkeypatch.setenv("MPLC_TORCH_FLEET_STALE_SEC", "0")
    deadline = time.monotonic() + 30
    while not h2.failed_over and time.monotonic() < deadline:
        r._shards["peer"]._last_probe = 0.0
        r.pump()
    assert h2.failed_over and h2.shard_id == "local"
    r.run_until_idle(timeout=600)
    assert h2.status == "completed" and h2._inner.recovered_values == 2
    np.testing.assert_array_equal(values_of_routed(h2), solo_values(8))
    server.close()
    _close(r, peer, survivor)


def test_http_errors_map_to_service_errors():
    import io
    import urllib.error
    shard = HttpShard("x", port=1)

    def err(code, doc):
        return urllib.error.HTTPError("u", code, "m", {}, io.BytesIO(json.dumps(doc).encode()))

    from mplc_tpu_torch.service import JobShed, ServiceError, ServiceOverloaded
    from mplc_tpu_torch.service.router import ShardUnavailable
    e = shard._classify(err(429, {"kind": "shed", "retry_after_sec": 1.5,
                                  "cluster": {"least_loaded": "y"}}))
    assert isinstance(e, JobShed) and e.retry_after_sec == 1.5
    assert e.cluster == {"least_loaded": "y"}
    assert type(shard._classify(err(429, {}))) is ServiceOverloaded
    assert isinstance(shard._classify(err(403, {})), ServiceAuthError)
    assert isinstance(shard._classify(err(503, {})), ShardUnavailable)
    assert type(shard._classify(err(400, {"error": "bad"}))) is ServiceError
    # an unreachable peer is unavailable, not an error of the job
    with pytest.raises(ShardUnavailable):
        shard.job_status("j")
    assert not shard.healthz_ok()


# -- against the JAX router -----------------------------------------------------------

# the JAX-fed game: one full-batch step a pass, so training does not depend
# on the permutations (tests/test_torch_service.py's FED)
FED = dict(minibatch_count=1, gradient_updates_per_pass_count=1)
HARNESS = {"pump": None, "plan": "shardkill@shard0:sec0"}


def _route_in(pkg, case, tmp_path):
    """The inline harness in one package: two journaled shards (slice 2),
    three jobs of two tenants, s0 killed after one pump (or by the plan),
    drained. Returns (per-job (shard, attempts, failed_over, status),
    router stats, {job: v(S)})."""
    if pkg == "jax":
        Router, mets = JFleetRouter, jmetrics
        Svc = JSweepService
        make = lambda seed: jax_scenario(seed, **FED)  # noqa: E731
    else:
        from test_torch_service import _FedService
        Router, mets, Svc = FleetRouter, metrics, _FedService
        make = lambda seed: scenario(seed, **FED)  # noqa: E731
    mets.reset()
    shards = {sid: Svc(start=False, slice_coalitions=2,
                       journal_path=str(tmp_path / f"{pkg}_{sid}.wal"))
              for sid in ("s0", "s1")}
    r = Router(shards=shards, backoff_sec=0.0,
               fault_plan=HARNESS[case] if case == "plan" else "")
    jobs = [r.submit(make(seed), tenant=t, job_id=f"j{seed}")
            for t, seed in (("A", 7), ("B", 8), ("A", 9))]
    if case == "pump":
        r.pump()
        r.kill_shard("s0")
    r.run_until_idle(timeout=600)
    record = [(h.shard_id, h.attempts, h.failed_over, h.status) for h in jobs]
    stats = {k: r.stats[k] for k in ("routed", "resubmits", "repins", "failovers",
                                     "budget_exhausted")}
    values = {h.job_id: np.array([float(h.values()[s]) for s in SUBSETS]) for h in jobs}
    r.close()
    for s in shards.values():
        s.shutdown(drain=False)
    return record, stats, values


def _fed_solo(seed):
    """The port's solo engine on the fed game (the JAX engine's initial
    params), as `_FedService` builds each job's."""
    from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
    from test_torch_sweep import _stacked_np
    jsc = jax_scenario(seed, **FED)
    jeng = JEngine(jsc)
    eng = CharacteristicEngine(scenario(seed, **FED))

    def batch_start(subsets, single, replicas=None):
        init = params_from_numpy(_stacked_np(
            [jsc.dataset.model.init(jeng._coalition_rng(s)) for s in subsets]))
        return [eng.coalition_generator(s) for s in subsets], init, None

    eng._batch_start = batch_start
    return eng.evaluate(SUBSETS)


@pytest.mark.parametrize("case", sorted(HARNESS))
def test_routing_record_and_values_match_the_jax_router(monkeypatch, tmp_path, case):
    import jax
    # the port's batches hold the coalitions of the JAX engine's on the
    # tests' 8-device mesh; each quantum (2 coalitions) is one batch in both
    monkeypatch.setenv("MPLC_TORCH_COALITIONS_PER_DEVICE", str(len(jax.devices())))
    jrec, jstats, jvals = _route_in("jax", case, tmp_path)
    rec, stats, vals = _route_in("port", case, tmp_path)
    assert rec == jrec
    assert stats == jstats
    assert stats["failovers"] == 1
    if case == "pump":
        assert [r[2] for r in rec] == [True, False, True]
    else:   # s0 died at the first refresh, before any job was routed
        assert {r[0] for r in rec} == {"s1"} and not any(r[2] for r in rec)
    n_test = len(scenario(7, **FED).dataset.x_test)
    for job, want in jvals.items():
        np.testing.assert_allclose(vals[job], want, rtol=0, atol=1.0 / n_test + 1e-6)
        assert vals[job].tobytes() == _fed_solo(int(job[1:])).tobytes(), job
