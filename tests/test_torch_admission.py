"""Admission control, priorities, the worker pool and the overload
surfaces of the port's sweep service (`mplc_tpu_torch/service/
admission.py`, `scheduler.py`), after tests/test_admission.py, on the CPU:

- `TierQueue` and `AdmissionController` give the same picks, states, shed
  victims, quotas and retry hints as the JAX package's on the same seeded
  sequences (a shared fake clock for the controller);
- priorities (stride-weighted quanta), the overload governor shedding the
  lowest tier with a classified, journaled `JobShed`, deadlines expiring
  while queued, the worker pool (bit-equal to solo runs), the per-worker
  heartbeat, the /varz terminal truncation;
- the chaos draws are the JAX package's, draw for draw;
- the fleet state plane: a published shard state, the cluster view and
  the redirect hint of `ServiceOverloaded`.
"""

import json
import random
import time

import numpy as np
import pytest

from mplc_tpu import faults as jfaults
from mplc_tpu.parallel import fleet as jfleet
from mplc_tpu.service import admission as jadmission
from mplc_tpu_torch import faults
from mplc_tpu_torch.obs import metrics, report, trace
from mplc_tpu_torch.parallel import fleet
from mplc_tpu_torch.service import (AdmissionController, JobShed, ServiceOverloaded, SweepJob,
                                    SweepService, TierQueue)
from mplc_tpu_torch.service import scheduler as sched
from torch_service_helpers import clean_env, counter, scenario, solo_values, values_of


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    clean_env(monkeypatch, tmp_path)
    metrics.reset()
    yield
    metrics.reset()


class _FakeJob:
    """Queue-unit stand-in: only priority / first_quantum_at matter."""

    def __init__(self, name, priority=0, started=False):
        self.name = name
        self.job_id = name
        self.priority = priority
        self.first_quantum_at = 0.0 if started else None
        self.submitted_at = time.monotonic()

    def __repr__(self):
        return self.name


# -- TierQueue ----------------------------------------------------------------

def test_tier_queue_single_tier_is_fifo():
    q = TierQueue()
    jobs = [_FakeJob(f"j{i}") for i in range(4)]
    for j in jobs:
        q.push(j)
    assert [q.pop() for _ in range(4)] == jobs
    assert q.pop() is None


def test_tier_queue_stride_weights_quanta_by_tier():
    q = TierQueue()
    lo, hi = _FakeJob("lo", 0), _FakeJob("hi", 1)
    order = []
    for _ in range(9):
        j = q.pop() if len(q) else None
        if j is None:
            q.push(lo), q.push(hi)
            continue
        order.append(j.name)
        q.push(j)
    hi_n, lo_n = order.count("hi"), order.count("lo")
    assert lo_n >= 2 and 1.5 <= hi_n / lo_n <= 2.5


def test_tier_queue_defer_lowest_skips_only_when_another_tier_queued():
    q = TierQueue()
    lo, hi = _FakeJob("lo", 0), _FakeJob("hi", 2)
    q.push(lo)
    assert q.pop(defer_lowest=True) is lo
    q.push(lo), q.push(hi)
    assert q.pop(defer_lowest=True) is hi
    q.push(hi)
    assert q.pop(defer_lowest=True) is hi
    assert q.pop(defer_lowest=True) is lo


def test_tier_queue_shed_candidates_newest_first_never_started_only():
    q = TierQueue()
    started = _FakeJob("started", 0, started=True)
    a, b, c = (_FakeJob(n, 0) for n in "abc")
    hi = _FakeJob("hi", 1)
    for j in (started, a, b, c, hi):
        q.push(j)
    assert q.shed_candidates(2) == [c, b]
    assert set(q.jobs()) == {started, a, hi}
    assert q.shed_candidates(0) == []


@pytest.mark.parametrize("seed", range(6))
def test_tier_queue_picks_as_jax(seed):
    """A seeded sequence of pushes, pops (deferred or not), re-queues and
    sheds over four tiers: the same job at every step in both packages."""
    rng = random.Random(seed)
    ours, theirs = TierQueue(), jadmission.TierQueue()
    pool = [_FakeJob(f"j{i}", rng.randrange(4), started=rng.random() < 0.3)
            for i in range(24)]
    trail = []
    for step in range(200):
        op = rng.random()
        if op < 0.4 and pool:
            job = pool.pop(0)
            ours.push(job), theirs.push(job)
        elif op < 0.85:
            defer = rng.random() < 0.3
            a, b = ours.pop(defer_lowest=defer), theirs.pop(defer_lowest=defer)
            assert a is b, step
            if a is not None and rng.random() < 0.7:
                ours.push(a), theirs.push(a)
            trail.append(a)
        else:
            k = rng.randrange(3)
            assert ours.shed_candidates(k) == theirs.shed_candidates(k), step
        assert ours.tiers() == theirs.tiers() and len(ours) == len(theirs)
    assert any(t is not None for t in trail)


# -- AdmissionController ------------------------------------------------------

def test_controller_disabled_never_leaves_healthy():
    c = AdmissionController(0.0)
    for _ in range(3):
        assert c.evaluate([100.0, 200.0]) == "healthy"
    assert c.view()["state"] == "healthy" and c.view()["enabled"] is False


def test_controller_escalates_defer_then_shed_and_recovers():
    c = AdmissionController(1.0, defer_dwell_sec=0.0)
    assert c.evaluate([0.1]) == "healthy"
    assert c.evaluate([5.0]) == "deferring"
    assert c.evaluate([5.0]) == "shedding"
    assert c.evaluate([5.0]) == "shedding"
    assert c.evaluate([0.1]) == "healthy"
    assert c.evaluate([5.0]) == "deferring"


def test_controller_dwell_blocks_instant_escalation():
    c = AdmissionController(1.0, defer_dwell_sec=0.05)
    assert c.evaluate([5.0]) == "deferring"
    assert c.evaluate([5.0]) == "deferring"
    time.sleep(0.06)
    assert c.evaluate([5.0]) == "shedding"


def test_controller_window_ages_out_a_spike():
    c = AdmissionController(1.0, defer_dwell_sec=0.0)
    c._waits.append((time.monotonic() - 1e6, 50.0))
    assert c.evaluate([]) == "healthy" and len(c._waits) == 0
    assert c.retry_after_sec() == pytest.approx(c.retry_floor_sec)


def test_controller_sees_stuck_queue_through_live_ages():
    c = AdmissionController(1.0)
    assert c.evaluate([]) == "healthy"
    assert c.evaluate([2.0, 3.0]) == "deferring"


def test_controller_retry_after_is_windowed_p50_with_env_floor(monkeypatch):
    c = AdmissionController(1.0)
    assert c.retry_after_sec() == pytest.approx(0.05)
    for w in (0.2, 0.4, 0.6):
        c.observe_queue_wait(w)
    assert c.retry_after_sec() == pytest.approx(0.4)
    monkeypatch.setenv("MPLC_TORCH_SERVICE_RETRY_FLOOR_SEC", "0.25")
    c2 = AdmissionController(1.0)
    assert c2.retry_after_sec() == pytest.approx(0.25)
    for w in (0.6, 0.7, 0.8):
        c2.observe_queue_wait(w)
    assert c2.retry_after_sec() == pytest.approx(0.7)


def test_controller_shed_quota_targets_half_the_bound():
    c = AdmissionController(1.0, defer_dwell_sec=0.0)
    c.evaluate([5.0])
    c.evaluate([5.0])
    assert c.state == "shedding"
    assert c.shed_quota(queued=10, max_pending=8) == 6
    assert c.shed_quota(queued=5, max_pending=8) == 1
    assert c.shed_quota(queued=1, max_pending=8) == 0
    c.evaluate([0.0])
    assert c.shed_quota(queued=10, max_pending=8) == 0


@pytest.mark.parametrize("seed", range(6))
def test_controller_decisions_as_jax(monkeypatch, seed):
    """Both controllers fed one seeded stream of waits, queued ages and
    clock advances on a shared fake clock: the same state, p99, quota and
    retry hint after every step."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    rng = random.Random(seed)
    thr = rng.choice([0.5, 1.0, 2.0])
    ours = AdmissionController(thr, window=16)
    theirs = jadmission.AdmissionController(thr, window=16)
    for step in range(300):
        clock[0] += rng.choice([0.0, 0.01, 0.1, 1.0, 40.0])
        if rng.random() < 0.5:
            w = rng.expovariate(1.0 / thr)
            ours.observe_queue_wait(w), theirs.observe_queue_wait(w)
        ages = [rng.expovariate(1.0 / thr) for _ in range(rng.randrange(4))]
        assert ours.evaluate(ages) == theirs.evaluate(ages), step
        assert ours._last_p99 == theirs._last_p99
        q, m = rng.randrange(12), rng.randrange(1, 10)
        assert ours.shed_quota(q, m) == theirs.shed_quota(q, m)
        assert ours.retry_after_sec() == theirs.retry_after_sec()
        assert ours.view(ages) == theirs.view(ages)


# -- ServiceOverloaded carries retry_after_sec --------------------------------

def test_overloaded_carries_retry_after_hint():
    svc = SweepService(start=False, max_pending=1, slice_coalitions=3)
    svc.submit(scenario(9), tenant="A")
    with pytest.raises(ServiceOverloaded) as ei:
        svc.submit(scenario(11), tenant="B")
    assert ei.value.retry_after_sec == pytest.approx(0.05)
    svc.run_until_idle()
    svc.submit(scenario(11), tenant="B")
    with pytest.raises(ServiceOverloaded) as ei:
        svc.submit(scenario(13), tenant="C")
    assert ei.value.retry_after_sec > 0.0 and "retry_after_sec" in str(ei.value)


# -- priority scheduling end-to-end -------------------------------------------

def test_higher_priority_job_gets_first_quantum_and_both_complete():
    svc = SweepService(start=False, slice_coalitions=2)
    lo = svc.submit(scenario(9), tenant="lo", priority=0)
    hi = svc.submit(scenario(11), tenant="hi", priority=3)
    svc.step()
    assert hi.first_quantum_at is not None and lo.first_quantum_at is None
    svc.run_until_idle()
    assert lo.status == hi.status == "completed"
    np.testing.assert_array_equal(values_of(lo), solo_values(9))
    np.testing.assert_array_equal(values_of(hi), solo_values(11))


def test_priority_default_env_applies(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_SERVICE_PRIORITY_DEFAULT", "2")
    svc = SweepService(start=False)
    assert svc.submit(scenario(9), tenant="A").priority == 2
    assert svc.submit(scenario(11), tenant="B", priority=0).priority == 0
    with pytest.raises(ValueError, match="non-negative"):
        svc.submit(scenario(13), tenant="C", priority=-1)


# -- load shedding end-to-end -------------------------------------------------

def test_overload_sheds_lowest_tier_with_classified_jobshed(tmp_path):
    path = tmp_path / "wal.jsonl"
    svc = SweepService(start=False, slice_coalitions=2, max_pending=4,
                       shed_p99_sec=1e-9, journal_path=path)
    lo1 = svc.submit(scenario(9), tenant="lo", priority=0, job_id="lo1")
    lo2 = svc.submit(scenario(9), tenant="lo", priority=0, job_id="lo2")
    hi = svc.submit(scenario(11), tenant="hi", priority=1, job_id="hi")
    time.sleep(0.002)
    with trace.collect() as recs:
        svc.run_until_idle()
    assert hi.status == "completed"
    np.testing.assert_array_equal(values_of(hi), solo_values(11))
    shed = [j for j in (lo1, lo2) if j.status == "shed"]
    assert shed
    for job in shed:
        assert isinstance(job.error, JobShed) and job.error.retry_after_sec >= 0.0
        with pytest.raises(JobShed, match="shed by overload"):
            job.result(1.0)
        assert job.engine is None and job.first_quantum_at is None
    assert counter("service.jobs_shed") == len(shed)
    assert counter("service.jobs_cancelled") == counter("service.jobs_quarantined") == 0
    assert [r for r in recs if r["name"] == "service.shed"]
    svc.shutdown()
    svc2 = SweepService(journal_path=path, start=False)
    rec = {r["job_id"]: r for r in svc2.recovered_jobs()}
    assert all(rec[j.job_id]["shed"] for j in shed)
    svc2.shutdown()
    rep = report.sweep_report(recs)
    assert rep["service"]["shed"] == len(shed)
    assert f"shed={len(shed)}" in report.format_report(rep)


def test_shed_disabled_by_default_no_governor_interference():
    svc = SweepService(start=False, slice_coalitions=3)
    assert svc._admission.enabled is False
    jobs = [svc.submit(scenario(9), tenant=f"t{i}") for i in range(3)]
    time.sleep(0.002)
    svc.run_until_idle()
    assert all(j.status == "completed" for j in jobs)
    assert counter("service.jobs_shed") == 0


def test_deadline_expiry_while_queued_cancels_without_slo_samples():
    svc = SweepService(start=False, slice_coalitions=2)
    job = svc.submit(scenario(9), tenant="Q", deadline_sec=1000.0)
    job.submitted_at -= 10_000
    svc.run_until_idle()
    assert job.status == "cancelled" and job.engine is None
    assert job.first_quantum_at is None and job.first_value_at is None
    assert counter("service.deadline_misses{tenant=Q}") == 1
    hists = metrics.snapshot()["histograms"]
    assert "service.queue_wait_sec{tenant=Q}" not in hists
    assert "service.time_to_first_value_sec{tenant=Q}" not in hists
    ok = svc.submit(scenario(11), tenant="Q2")
    svc.run_until_idle()
    assert ok.status == "completed"


# -- worker pool --------------------------------------------------------------

def test_worker_pool_completes_tenants_bit_identically():
    svc = SweepService(start=True, workers=3, slice_coalitions=3)
    try:
        ja = svc.submit(scenario(9), tenant="A")
        jb = svc.submit(scenario(11), tenant="B")
        ja.result(timeout=300)
        jb.result(timeout=300)
    finally:
        svc.shutdown(drain=True, timeout=60)
    np.testing.assert_array_equal(values_of(ja), solo_values(9))
    np.testing.assert_array_equal(values_of(jb), solo_values(11))


def test_workers_env_knob_and_healthz_per_worker_block(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_SERVICE_WORKERS", "2")
    svc = SweepService(start=True)
    try:
        view = svc.health_view()
        assert view["healthy"] is True
        workers = [w for w in view["workers"] if w["worker"] != "inline"]
        assert len(workers) == 2
        for w in workers:
            # no card here: every worker is slot 0, unpinned
            assert w["alive"] is True and w["stalled"] is False and w["device_slot"] == 0
        assert all(w.device is None for w in svc._workers)
        assert view["admission"]["state"] == "healthy"
        svc.submit(scenario(9), tenant="A").result(timeout=300)
    finally:
        svc.shutdown(drain=True, timeout=60)


def test_one_wedged_worker_flips_only_its_own_liveness():
    svc = SweepService(start=False)
    try:
        w0, w1 = sched._WorkerSlot(0), sched._WorkerSlot(1)
        svc._workers = [w0, w1]
        w0.running_job = _FakeJob("wedged")
        w0.heartbeat = time.monotonic() - (sched.STALL_HEALTHY_SEC + 1)
        w1.running_job = _FakeJob("fine")
        w1.heartbeat = time.monotonic()
        view = svc.health_view()
        by_idx = {w["worker"]: w for w in view["workers"]}
        assert by_idx[0]["stalled"] is True and by_idx[1]["stalled"] is False
        assert view["healthy"] is True and view["stalled"] is True
        w1.heartbeat = time.monotonic() - (sched.STALL_HEALTHY_SEC + 1)
        assert svc.health_view()["healthy"] is False
    finally:
        svc._workers = []
        svc.shutdown()


def test_varz_truncates_terminal_jobs_to_most_recent_100():
    svc = SweepService(start=False)
    try:
        for i in range(130):
            job = SweepJob(svc, f"t{i}", "tenant", None, "Shapley values", None, i + 1)
            job.status = "completed"
            job._done.set()
            svc._jobs[job.job_id] = job
            svc._retire(job)
        svc._jobs["live"] = SweepJob(svc, "live", "tenant", None, "Shapley values",
                                     None, 999)
        view = svc.varz_view()
        terminal = [k for k, v in view["jobs"].items() if v["status"] == "completed"]
        assert len(terminal) == svc.VARZ_TERMINAL_JOBS == 100
        assert "t129" in view["jobs"] and "t29" not in view["jobs"] and "live" in view["jobs"]
        assert view["terminal_jobs_total"] == 130 and view["terminal_jobs_truncated"] == 30
        assert view["jobs_total"] == 131
        json.dumps(view)
    finally:
        svc.shutdown()


# -- chaos plan ---------------------------------------------------------------

def test_chaos_plan_grammar_and_validation():
    plan = faults.parse_service_fault_plan("chaos@rate0.25:seed7,crash@job2:batch1")
    assert plan["chaos"] == {"rate": 0.25, "seed": 7}
    with pytest.warns(UserWarning, match="rate must be in"):
        assert "chaos" not in faults.parse_service_fault_plan("chaos@rate1.5:seed7")
    with pytest.warns(UserWarning, match="duplicate chaos"):
        plan = faults.parse_service_fault_plan("chaos@rate0.1:seed1,chaos@rate0.9:seed2")
    assert plan["chaos"] == {"rate": 0.1, "seed": 1}
    with pytest.warns(UserWarning, match="malformed"):
        faults.parse_service_fault_plan("chaos@rate0.1")


@pytest.mark.parametrize("cfg", [{"rate": 0.5, "seed": 7}, {"rate": 0.05, "seed": 3},
                                 {"rate": 1.0, "seed": 0}, {"rate": 0.0, "seed": 1}, None])
def test_chaos_draws_are_the_jax_packages(cfg):
    draws = [faults.chaos_entry(cfg, i) for i in range(1, 201)]
    assert draws == [jfaults.chaos_entry(cfg, i) for i in range(1, 201)]
    for d in filter(None, draws):
        kinds = [k for ks in d["batch"].values() for k in ks]
        assert (kinds and set(kinds) <= {"crash", "transient"}) or d["stall_sec"] > 0
        assert not d["reject"]


def test_merge_service_entries_composes_explicit_and_chaos():
    explicit = {"batch": {("dispatch", 1): ["crash"]}, "reject": False, "stall_sec": 0.5}
    chaos = {"batch": {("dispatch", 1): ["transient"]}, "reject": False, "stall_sec": 0.1}
    merged = faults.merge_service_entries(explicit, chaos)
    assert merged == jfaults.merge_service_entries(explicit, chaos)
    assert merged["batch"][("dispatch", 1)] == ["crash", "transient"]
    assert faults.merge_service_entries(None, None) is None


def test_chaos_run_is_replayable(monkeypatch):
    """A chaos plan's faults fire by ordinal: every job still completes
    bit-equal to its solo run, and the same plan injects the same faults."""
    monkeypatch.setenv("MPLC_TORCH_SERVICE_FAULT_PLAN", "chaos@rate1.0:seed5")
    injected = []
    for _ in range(2):
        metrics.reset()
        svc = SweepService(start=False, slice_coalitions=3)
        jobs = [svc.submit(scenario(9), tenant=f"t{i}") for i in range(3)]
        svc.run_until_idle()
        for j in jobs:
            assert j.status == "completed"
            np.testing.assert_array_equal(values_of(j), solo_values(9))
        injected.append([j._fault_entry for j in jobs])
    assert injected[0] == injected[1]


# -- the fleet state plane ----------------------------------------------------

def test_fleet_state_published_and_read_by_either_package(monkeypatch, tmp_path):
    state = tmp_path / "fleet"
    monkeypatch.setenv("MPLC_TORCH_FLEET_STATE_DIR", str(state))
    monkeypatch.setenv("MPLC_TORCH_FLEET_SHARD_ID", "shardA")
    fleet.publish_shard_state(str(state), "shardB", {"queue_depth": 0, "jobs_pending": 0})
    svc = SweepService(start=False, max_pending=1)
    try:
        svc.submit(scenario(9), tenant="A")
        view = fleet.cluster_view(str(state))
        assert view == {**jfleet.cluster_view(str(state)),
                        "shards": view["shards"]}
        assert view["shards"]["shardA"]["queue_depth"] == 1
        assert view["least_loaded"] == "shardB" and view["live_shards"] == 2
        assert "metrics" not in view["shards"]["shardA"]
        assert "metrics" in fleet.cluster_view(str(state), include_metrics=True)[
            "shards"]["shardA"]
        with pytest.raises(ServiceOverloaded, match="shardB") as ei:
            svc.submit(scenario(11), tenant="B")
        assert ei.value.cluster["least_loaded"] == "shardB"
        assert svc.health_view()["fleet"]["shard_id"] == "shardA"
    finally:
        svc.shutdown(drain=False)
    # a closed shard is never the redirect target
    assert fleet.cluster_view(str(state))["shards"]["shardA"]["closed"] is True
    assert fleet.cluster_view(str(state), stale_sec=0.0)["live_shards"] == 0
