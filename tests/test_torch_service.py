"""The port's sweep service (`mplc_tpu_torch/service/`) against its own solo
engine and against the JAX package's service, on the CPU, on the Titanic
3-partner game of tests/test_service.py:

- the service fault-plan grammar parses as the JAX package parses it;
- ISOLATION: faults of tenant A's job (crash, OOM, transient, stall)
  never perturb tenant B, whose v(S) stay bit-equal to a solo run of the
  port's engine; a poison job quarantines after MPLC_TORCH_MAX_RETRIES;
- two tenants within one test sample (v(S)) and 1e-3 (Shapley values) of
  the JAX service on the same scenarios, the port fed the JAX engine's
  per-coalition initial params (tests/test_torch_sweep.py's feed);
- deadlines, backpressure, `reject@`; the journal: round trip, torn tail,
  mid-file corruption; kill, restart and replay bit-identical; the
  partners-count guard; release keeps the values; a WAL write failure
  degrades the service;
- a WAL written by the JAX service replays in the port and the port's in
  JAX; one fault plan gives the same terminal statuses, service counters
  and journal record sequence (types, jobs, tenants, subsets) in both;
- `sweep_plan` equal to the buckets `evaluate` logs, and the engine's
  progress hook.
"""

import json
import time
import warnings

import numpy as np
import pytest

from mplc_tpu import faults as jfaults
from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
from mplc_tpu.obs import metrics as jmetrics
from mplc_tpu.service import ServiceRejected as JServiceRejected
from mplc_tpu.service import SweepJournal as JSweepJournal
from mplc_tpu.service import SweepService as JSweepService
from mplc_tpu_torch import faults
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order, shapley_from_characteristic
from mplc_tpu_torch.convert import params_from_numpy
from mplc_tpu_torch.obs import metrics, report, trace
from mplc_tpu_torch.service import (JobCancelled, JobQuarantined, JournalCorruptError,
                                    ServiceOverloaded, ServiceRejected, SweepJob,
                                    SweepJournal, SweepService)
from mplc_tpu_torch.service import journal as journal_mod
from torch_service_helpers import (P, SUBSETS, clean_env, counter, jax_scenario, scenario,
                                   solo_values, values_of)


@pytest.fixture(autouse=True)
def _service_env(monkeypatch, tmp_path):
    clean_env(monkeypatch, tmp_path)
    metrics.reset()
    jmetrics.reset()
    yield
    metrics.reset()
    jmetrics.reset()


def _jax_batches(monkeypatch) -> None:
    """The port's batches hold as many coalitions as the JAX engine's on
    the tests' CPU mesh (its devices x one coalition each), so both
    packages train the same coalitions in each batch and a fault plan's
    batch ordinals address the same work. Their widths still differ (the
    JAX engine pads to a multiple of its devices), so the packing count
    agrees where each quantum is one whole game (slice 7): every bucket
    of a game then has one width in each package."""
    import jax
    monkeypatch.setenv("MPLC_TORCH_COALITIONS_PER_DEVICE", str(len(jax.devices())))


# -- the service fault-plan grammar ------------------------------------------

PLANS = ["crash@job2:batch3, oom@job2:batch3,transient@job1:batch1,reject@job4,stall@job1:sec2.5",
         "chaos@rate0.25:seed7,crash@job2:batch1",
         "stall@job3:sec0.2,stall@job3:sec1",
         "", None]


@pytest.mark.parametrize("spec", PLANS, ids=range(len(PLANS)))
def test_service_plan_parses_as_jax(spec):
    assert faults.parse_service_fault_plan(spec) == jfaults.parse_service_fault_plan(spec)


def test_service_plan_grammar_and_malformed_entries():
    plan = faults.parse_service_fault_plan(PLANS[0])
    assert plan[2]["batch"] == {("dispatch", 3): ["crash", "oom"]}
    assert plan[1]["stall_sec"] == 2.5 and plan[4]["reject"] is True
    with pytest.warns(UserWarning, match="malformed"):
        plan = faults.parse_service_fault_plan(
            "crash@job2,stall@job1,bogus@job3:batch1,crash@job1:batch2")
    assert list(plan) == [1] and plan[1]["batch"] == {("dispatch", 2): ["crash"]}
    with pytest.warns(UserWarning, match="1-based"):
        assert faults.parse_service_fault_plan("crash@job0:batch1") == {}


# -- the happy path: multi-tenant bit-identity + packing ---------------------

def test_two_tenants_bit_identical_to_solo_and_packed():
    ref_a, ref_b = solo_values(9), solo_values(11)
    with trace.collect() as recs:
        svc = SweepService(start=False, slice_coalitions=3)
        ja = svc.submit(scenario(9), tenant="A")
        jb = svc.submit(scenario(11), tenant="B")
        svc.run_until_idle()
    assert ja.status == jb.status == "completed"
    np.testing.assert_array_equal(values_of(ja), ref_a)
    np.testing.assert_array_equal(values_of(jb), ref_b)
    assert counter("service.cross_tenant_packed_batches") > 0
    assert jb.packed_batches > 0
    # tenant B's buckets were tenant A's programs (shape-scoped keys)
    keys = {(b["slot_count"], b["width"]) for b in ja.engine.batch_log}
    assert keys == {(b["slot_count"], b["width"]) for b in jb.engine.batch_log}
    rep = report.sweep_report(recs)
    svc_row = rep["service"]
    assert svc_row["jobs"] == 2 and svc_row["completed"] == 2
    assert svc_row["cross_tenant_packed_batches"] > 0
    shares = [t["cost_share"] for t in svc_row["per_tenant"].values()]
    assert len(shares) == 2 and abs(sum(shares) - 1.0) < 1e-9
    assert "tenant[A]" in report.format_report(rep)
    # device-seconds billed to each tenant, on a named basis
    for job in (ja, jb):
        assert job.device_seconds > 0 and job.device_basis in ("fenced", "host_span")
        assert counter(f"service.device_seconds{{tenant={job.tenant}}}") == \
            pytest.approx(job.device_seconds)


# the JAX-fed game: one full-batch step a pass, so training does not
# depend on the permutations (tests/test_torch_sweep.py case "i")
FED = dict(minibatch_count=1, gradient_updates_per_pass_count=1)


class _FedService(SweepService):
    """The port's service whose job engines draw the JAX engine's
    per-coalition initial params (`model.init(eng._coalition_rng(s))`)."""

    def _build_engine(self, job):
        super()._build_engine(job)
        from test_torch_sweep import _stacked_np
        jsc = jax_scenario(job.scenario.seed, **FED)
        jeng = JEngine(jsc)
        eng = job.engine

        def batch_start(subsets, single, replicas=None):
            init = params_from_numpy(_stacked_np(
                [jsc.dataset.model.init(jeng._coalition_rng(s)) for s in subsets]))
            return [eng.coalition_generator(s) for s in subsets], init, None

        eng._batch_start = batch_start


def test_two_tenants_within_tolerance_of_the_jax_service(monkeypatch):
    _jax_batches(monkeypatch)
    jsvc = JSweepService(start=False, slice_coalitions=len(SUBSETS))
    jjobs = [jsvc.submit(jax_scenario(seed, **FED), tenant=t)
             for t, seed in (("A", 9), ("B", 11))]
    jsvc.run_until_idle()
    svc = _FedService(start=False, slice_coalitions=len(SUBSETS))
    jobs = [svc.submit(scenario(seed, **FED), tenant=t) for t, seed in (("A", 9), ("B", 11))]
    svc.run_until_idle()
    n_test = len(jobs[0].scenario.dataset.x_test)
    for job, jjob in zip(jobs, jjobs):
        assert job.status == jjob.status == "completed"
        want = np.array([float(jjob.values[s]) for s in SUBSETS])
        np.testing.assert_allclose(values_of(job), want, rtol=0, atol=1.0 / n_test + 1e-6)
        np.testing.assert_allclose(job.result(1.0), np.asarray(jjob.result(1.0)),
                                   rtol=0, atol=1e-3)
    assert counter("service.cross_tenant_packed_batches") == \
        counter("service.cross_tenant_packed_batches", jmetrics)


def test_exact_shapley_scores_match_solo_table():
    svc = SweepService(start=False)
    job = svc.submit(scenario(9), tenant="A")
    svc.run_until_idle()
    vals = {(): 0.0, **dict(zip(SUBSETS, solo_values(9)))}
    np.testing.assert_array_equal(job.result(1.0), shapley_from_characteristic(P, vals))


def test_stream_yields_every_value_incrementally():
    svc = SweepService(start=False, slice_coalitions=2)
    job = svc.submit(scenario(9), tenant="A")
    svc.step()
    assert 0 < len(job._stream) < len(SUBSETS)
    svc.run_until_idle()
    got = dict(job.stream(timeout=5))
    np.testing.assert_array_equal(np.array([got[s] for s in SUBSETS]), solo_values(9))


def test_threaded_service_completes_and_drains():
    svc = SweepService(start=True, slice_coalitions=4)
    ja = svc.submit(scenario(9), tenant="A")
    jb = svc.submit(scenario(11), tenant="B")
    np.testing.assert_array_equal(ja.result(timeout=300), ja.result(timeout=1))
    jb.result(timeout=300)
    svc.shutdown(drain=True, timeout=60)
    np.testing.assert_array_equal(values_of(ja), solo_values(9))
    np.testing.assert_array_equal(values_of(jb), solo_values(11))
    with pytest.raises(Exception, match="shut down"):
        svc.submit(scenario(9))


@pytest.mark.parametrize("method", ["Independent scores", "GTG-Shapley", "TMCS"])
def test_estimator_method_job_matches_solo_run(method):
    """Estimators run as one quantum through the same isolation boundary:
    the scores are bit-equal to a solo Contributivity run (GTG-Shapley on
    the retrain-free path, whose reconstruction batches call the hook)."""
    solo = Contributivity(scenario(9))
    solo.compute_contributivity(method)
    svc = SweepService(start=False)
    job = svc.submit(scenario(9), method=method, tenant="A")
    svc.run_until_idle()
    assert job.status == "completed"
    np.testing.assert_array_equal(job.result(1.0), np.asarray(solo.contributivity_scores))


def test_auto_method_plans_with_the_job_deadline_and_journals_it(tmp_path):
    path = tmp_path / "wal.jsonl"
    svc = SweepService(journal_path=path, start=False)
    job = svc.submit(scenario(9), method="auto", tenant="A", deadline_sec=600.0)
    svc.run_until_idle()
    assert job.status == "completed" and job.plan is not None
    assert job.plan.method in ("exact", "GTG-Shapley", "SVARM")
    plans = [r for r in SweepJournal.replay(path)[0] if r["type"] == "plan"]
    assert plans and plans[0]["plan"]["method"] == job.plan.method


# -- per-tenant fault isolation ----------------------------------------------

@pytest.mark.parametrize("entry", ["crash@job1:batch2", "oom@job1:batch2",
                                   "transient@job1:batch2", "stall@job1:sec0.2"])
def test_tenant_a_fault_never_perturbs_tenant_b(monkeypatch, entry):
    ref_a, ref_b = solo_values(9), solo_values(11)
    monkeypatch.setenv("MPLC_TORCH_SERVICE_FAULT_PLAN", entry)
    svc = SweepService(start=False, slice_coalitions=3)
    ja = svc.submit(scenario(9), tenant="A")
    jb = svc.submit(scenario(11), tenant="B")
    svc.run_until_idle()
    assert ja.status == jb.status == "completed"
    np.testing.assert_array_equal(values_of(jb), ref_b)
    np.testing.assert_array_equal(values_of(ja), ref_a)
    if entry.startswith("crash"):
        assert ja.attempts == 1
    if entry.startswith("oom"):
        # A's private ladder took the rung; B's engine never stepped down
        assert ja.engine._cap_halvings == 1 and jb.engine._cap_halvings == 0


def test_poison_job_quarantined_after_retry_budget(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_MAX_RETRIES", "1")
    monkeypatch.setenv("MPLC_TORCH_SERVICE_FAULT_PLAN", "crash@job1:batch1,crash@job1:batch2")
    svc = SweepService(start=False, slice_coalitions=3)
    ja = svc.submit(scenario(9), tenant="A")
    jb = svc.submit(scenario(11), tenant="B")
    svc.run_until_idle()
    assert ja.status == "quarantined" and ja.engine is None
    with pytest.raises(JobQuarantined, match="retry budget"):
        ja.result(1.0)
    assert counter("service.jobs_quarantined") == 1
    assert jb.status == "completed"
    np.testing.assert_array_equal(values_of(jb), solo_values(11))


def test_permanent_failure_quarantines_without_retry():
    svc = SweepService(start=False)
    sc = scenario(9)
    sc.multi_partner_learning_approach_key = "bogus-approach"
    job = svc.submit(sc, tenant="A")
    svc.run_until_idle()
    assert job.status == "quarantined" and job.attempts == 1
    with pytest.raises(JobQuarantined, match="permanent failure"):
        job.result(1.0)


def test_unknown_method_is_a_clean_submit_error():
    svc = SweepService(start=False)
    with pytest.raises(ValueError, match="unknown contributivity method"):
        svc.submit(scenario(9), method="no-such-method", tenant="A")


# -- admission control / deadlines -------------------------------------------

def test_backpressure_rejects_with_clean_error():
    svc = SweepService(start=False, max_pending=1)
    svc.submit(scenario(9), tenant="A")
    with pytest.raises(ServiceOverloaded, match="MPLC_TORCH_SERVICE_MAX_PENDING") as ei:
        svc.submit(scenario(11), tenant="B")
    assert ei.value.retry_after_sec >= 0.0 and ei.value.cluster is None
    assert counter("service.jobs_rejected") == 1
    assert counter("service.jobs_accepted") == 1


def test_fault_plan_reject_refuses_admission(monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_SERVICE_FAULT_PLAN", "reject@job1")
    svc = SweepService(start=False)
    with pytest.raises(ServiceRejected):
        svc.submit(scenario(9), tenant="A")
    job = svc.submit(scenario(11), tenant="B")
    svc.run_until_idle()
    assert job.status == "completed"


def test_deadline_expiry_cancels_between_batches():
    svc = SweepService(start=False, slice_coalitions=2)
    job = svc.submit(scenario(9), tenant="A", deadline_sec=1000.0)
    svc.step()
    harvested = len(job._stream)
    assert harvested > 0
    job.submitted_at -= 10_000
    svc.run_until_idle()
    assert job.status == "cancelled" and job.engine is None
    assert len(job._stream) >= harvested
    with pytest.raises(JobCancelled, match="deadline"):
        job.result(1.0)
    assert counter("service.jobs_cancelled") == 1
    jb = svc.submit(scenario(11), tenant="B")
    svc.run_until_idle()
    assert jb.status == "completed"
    np.testing.assert_array_equal(values_of(jb), solo_values(11))


def test_deadline_cancels_cooperatively_at_batch_boundary(monkeypatch):
    svc = SweepService(start=False, slice_coalitions=len(SUBSETS))
    job = svc.submit(scenario(9), tenant="A", deadline_sec=10_000.0)
    calls = {"n": 0}
    real = SweepJob._deadline_expired

    def fake(self):
        if self is not job:
            return real(self)
        calls["n"] += 1
        return calls["n"] > 1  # the quantum-start check passes; batch 1 trips

    monkeypatch.setattr(SweepJob, "_deadline_expired", fake)
    svc.run_until_idle()
    assert job.status == "cancelled" and job.engine is None
    assert [s for s, _ in job._stream] == [SUBSETS[0]]  # batch 1's harvest kept
    with pytest.raises(JobCancelled, match="batch boundary"):
        job.result(1.0)


def test_deadline_already_expired_cancels_before_any_work():
    svc = SweepService(start=False)
    job = svc.submit(scenario(9), tenant="A", deadline_sec=0.0)
    time.sleep(0.01)
    svc.run_until_idle()
    assert job.status == "cancelled" and job.engine is None


# -- journal + crash recovery ------------------------------------------------

def test_journal_append_replay_round_trip(tmp_path):
    path = tmp_path / "wal.jsonl"
    j = SweepJournal(path)
    recs = [{"type": "submit", "job": "a", "tenant": "t"},
            {"type": "value", "job": "a", "subset": [0, 2], "value": 0.123456789012345}]
    for r in recs:
        j.append(r)
    j.close()
    assert SweepJournal.replay(path) == (recs, False)
    assert SweepJournal.replay(tmp_path / "absent.jsonl") == ([], False)


def test_journal_torn_tail_quarantined_and_truncated(tmp_path):
    path = tmp_path / "wal.jsonl"
    j = SweepJournal(path)
    j.append({"type": "submit", "job": "a"})
    j.append({"type": "value", "job": "a", "subset": [0], "value": 0.5})
    j.close()
    good = path.read_bytes()
    path.write_bytes(good + b'{"sha256": "x", "rec": {"type": "val')
    with pytest.warns(UserWarning, match="torn"):
        replayed, torn = SweepJournal.replay(path)
    assert torn is True and len(replayed) == 2
    assert path.read_bytes() == good and (tmp_path / "wal.jsonl.torn").exists()
    assert counter("service.journal_torn_records") == 1
    assert SweepJournal.replay(path) == (replayed, False)


def test_journal_mid_file_corruption_raises(tmp_path):
    path = tmp_path / "wal.jsonl"
    j = SweepJournal(path)
    j.append({"type": "submit", "job": "a"})
    j.append({"type": "value", "job": "a", "subset": [0], "value": 0.5})
    j.close()
    lines = path.read_bytes().splitlines()
    path.write_bytes(b"garbage\n" + lines[1] + b"\n")
    with pytest.raises(JournalCorruptError, match="not a torn tail"):
        SweepJournal.replay(path)
    with pytest.raises(JournalCorruptError):
        SweepService(journal_path=path, start=False)


def test_kill_and_restart_replays_journal_bit_identically(tmp_path):
    ref_a, ref_b = solo_values(9), solo_values(11)
    path = tmp_path / "service_wal.jsonl"
    svc1 = SweepService(journal_path=path, start=False, slice_coalitions=2)
    svc1.submit(scenario(9), tenant="A", job_id="gameA")
    svc1.submit(scenario(11), tenant="B", job_id="gameB")
    for _ in range(3):
        svc1.step()
    svc1.abandon()
    with open(path, "ab") as f:  # the kill lands mid-append
        f.write(b'{"sha256": "dead", "rec": {"type": "value", "job"')
    with pytest.warns(UserWarning, match="torn"):
        svc2 = SweepService(journal_path=path, start=False, slice_coalitions=2)
    rec = {r["job_id"]: r for r in svc2.recovered_jobs()}
    assert set(rec) == {"gameA", "gameB"}
    assert not rec["gameA"]["done"] and rec["gameA"]["values"] > 0
    ra = svc2.submit(scenario(9), tenant="A", job_id="gameA")
    rb = svc2.submit(scenario(11), tenant="B", job_id="gameB")
    svc2.run_until_idle()
    assert ra.status == rb.status == "completed"
    np.testing.assert_array_equal(values_of(ra), ref_a)
    np.testing.assert_array_equal(values_of(rb), ref_b)
    # the recovered engine trained only the coalitions its journal lacked
    assert ra.recovered_values > 0
    assert ra.engine._batch_ordinal == len(SUBSETS) - ra.recovered_values
    assert counter("service.jobs_recovered") >= 1
    svc2.shutdown()
    svc3 = SweepService(journal_path=path, start=False)
    rec3 = {r["job_id"]: r for r in svc3.recovered_jobs()}
    assert rec3["gameA"]["done"] and rec3["gameB"]["done"]
    fa = svc3.submit(scenario(9), tenant="A", job_id="gameA")
    svc3.run_until_idle()
    assert fa.status == "completed" and fa.engine._batch_ordinal == 0
    np.testing.assert_array_equal(values_of(fa), ref_a)
    svc3.shutdown()


def test_restart_with_tenant_a_faults_still_isolates(tmp_path, monkeypatch):
    path = tmp_path / "wal.jsonl"
    svc1 = SweepService(journal_path=path, start=False, slice_coalitions=2)
    svc1.submit(scenario(9), tenant="A", job_id="gameA")
    svc1.submit(scenario(11), tenant="B", job_id="gameB")
    svc1.step()
    svc1.step()
    monkeypatch.setenv("MPLC_TORCH_SERVICE_FAULT_PLAN", "crash@job1:batch1")
    svc2 = SweepService(journal_path=path, start=False, slice_coalitions=2)
    ra = svc2.submit(scenario(9), tenant="A", job_id="gameA")
    rb = svc2.submit(scenario(11), tenant="B", job_id="gameB")
    svc2.run_until_idle()
    assert ra.status == rb.status == "completed" and ra.attempts == 1
    np.testing.assert_array_equal(values_of(ra), solo_values(9))
    np.testing.assert_array_equal(values_of(rb), solo_values(11))
    svc2.shutdown()


def test_resubmitting_a_different_game_under_a_recovered_id_quarantines(tmp_path):
    path = tmp_path / "wal.jsonl"
    svc1 = SweepService(journal_path=path, start=False, slice_coalitions=2)
    svc1.submit(scenario(9), tenant="A", job_id="gameA")
    svc1.step()
    svc2 = SweepService(journal_path=path, start=False)
    wrong = scenario(9, partners=4, amounts=[0.1, 0.2, 0.3, 0.4])
    job = svc2.submit(wrong, tenant="A", job_id="gameA")
    svc2.run_until_idle()
    assert job.status == "quarantined"
    with pytest.raises(JobQuarantined, match="different game"):
        job.result(1.0)
    svc2.shutdown()


def test_adopt_recovered_seeds_and_refuses_a_different_seed():
    svc = SweepService(start=False)
    seed = {s: float(v) for s, v in zip(SUBSETS[:3], solo_values(9)[:3])}
    svc.adopt_recovered("moved", tenant="A", method="Shapley values",
                        partners_count=P, values=seed)
    svc.adopt_recovered("moved", partners_count=P, values=seed)  # idempotent
    with pytest.raises(ValueError, match="differs"):
        svc.adopt_recovered("moved", values={SUBSETS[0]: 0.0})
    job = svc.submit(scenario(9), tenant="A", job_id="moved")
    svc.run_until_idle()
    assert job.recovered_values == 3
    assert job.engine._batch_ordinal == len(SUBSETS) - 3
    np.testing.assert_array_equal(values_of(job), solo_values(9))


def test_completed_job_releases_device_state_but_keeps_values():
    svc = SweepService(start=False)
    job = svc.submit(scenario(9), method="GTG-Shapley", tenant="A")
    svc.run_until_idle()
    assert job.status == "completed"
    eng = job.engine
    assert eng.stacked is None and eng.val is None and eng.test is None
    assert eng.multi_pipe is None and eng.program_bank is None
    assert eng._reconstruction is None and eng.progress is None
    job2 = svc.submit(scenario(9), tenant="A")
    svc.run_until_idle()
    np.testing.assert_array_equal(values_of(job2), solo_values(9))


def test_journal_write_failure_degrades_instead_of_killing_jobs(tmp_path, monkeypatch):
    path = tmp_path / "wal.jsonl"
    svc = SweepService(journal_path=path, start=False, slice_coalitions=3)
    job = svc.submit(scenario(9), tenant="A")

    def boom(self, recs):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(journal_mod.SweepJournal, "append_many", boom)
    svc.run_until_idle()
    assert job.status == "completed" and svc._journal_broken
    assert svc.health_view()["journal"] == "broken"
    np.testing.assert_array_equal(values_of(job), solo_values(9))
    with pytest.raises(Exception, match="WAL|journal"):
        svc.submit(scenario(11), tenant="B", job_id="neverin")
    assert "neverin" not in svc._jobs


def test_quarantine_cancel_and_billing_are_journaled(tmp_path, monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_MAX_RETRIES", "1")
    monkeypatch.setenv("MPLC_TORCH_SERVICE_FAULT_PLAN", "crash@job1:batch1,crash@job1:batch2")
    path = tmp_path / "wal.jsonl"
    svc = SweepService(journal_path=path, start=False)
    ja = svc.submit(scenario(9), tenant="A", job_id="poison")
    jb = svc.submit(scenario(11), tenant="B", job_id="fine")
    svc.run_until_idle()
    assert ja.status == "quarantined" and jb.status == "completed"
    billed = dict(svc._tenant_device_seconds)
    svc.shutdown()
    metrics.reset()
    svc2 = SweepService(journal_path=path, start=False)
    rec = {r["job_id"]: r for r in svc2.recovered_jobs()}
    assert rec["poison"]["quarantined"] is True and rec["fine"]["done"] is True
    # replay restores the per-tenant meter and raises the counter to it
    assert svc2._tenant_device_seconds == pytest.approx(billed)
    assert counter("service.device_seconds{tenant=B}") == pytest.approx(billed["B"])
    svc2.shutdown()


# -- the journal across packages ---------------------------------------------

def _jax_wal(path, steps=None):
    """A JAX service's WAL of tenant A's game (seed 9): all of it, or the
    first `steps` quanta of 2 coalitions."""
    svc = JSweepService(journal_path=path, start=False, slice_coalitions=2)
    svc.submit(jax_scenario(9), tenant="A", job_id="gameA")
    if steps is None:
        svc.run_until_idle()
    else:
        for _ in range(steps):
            svc.step()
    svc.shutdown(drain=False)


def _journal_values(path) -> dict:
    return {tuple(r["subset"]): r["value"] for r in SweepJournal.replay(path)[0]
            if r["type"] == "value"}


def test_a_jax_wal_replays_in_the_port(tmp_path):
    done, partial = tmp_path / "done.jsonl", tmp_path / "partial.jsonl"
    _jax_wal(done)
    _jax_wal(partial, steps=2)
    for path in (done, partial):
        ref = JSweepService(journal_path=path, start=False).recovered_jobs()
        assert SweepService(journal_path=path, start=False).recovered_jobs() == ref
    # the complete WAL: every value seeded, bit for bit, nothing trained
    svc = SweepService(journal_path=done, start=False)
    job = svc.submit(scenario(9), tenant="A", job_id="gameA")
    svc.run_until_idle()
    assert job.status == "completed" and job.engine._batch_ordinal == 0
    assert {s: job.values[s] for s in SUBSETS} == _journal_values(done)
    # the partial WAL: its values seeded, only the rest trained
    seeded = _journal_values(partial)
    svc = SweepService(journal_path=partial, start=False)
    job = svc.submit(scenario(9), tenant="A", job_id="gameA")
    svc.run_until_idle()
    assert job.recovered_values == len(seeded) == 4
    assert job.engine._batch_ordinal == len(SUBSETS) - len(seeded)
    assert all(job.values[s] == v for s, v in seeded.items())


def test_the_port_wal_replays_in_jax(tmp_path):
    path = tmp_path / "port.jsonl"
    svc = SweepService(journal_path=path, start=False, slice_coalitions=2)
    svc.submit(scenario(9), tenant="A", job_id="gameA")
    svc.run_until_idle()
    svc.shutdown()
    jsvc = JSweepService(journal_path=path, start=False)
    assert jsvc.recovered_jobs() == SweepService(journal_path=path,
                                                 start=False).recovered_jobs()
    job = jsvc.submit(jax_scenario(9), tenant="A", job_id="gameA")
    jsvc.run_until_idle()
    assert job.status == "completed" and job.engine._batch_ordinal == 0
    assert {s: float(job.values[s]) for s in SUBSETS} == _journal_values(path)
    np.testing.assert_array_equal([job.values[s] for s in SUBSETS], solo_values(9))


def _run_in(pkg, path, slice_coalitions):
    """Tenants A (seed 9) and B (seed 11) through one package's journaled
    service: (statuses, attempts, service counters, journal sequence)."""
    if pkg == "jax":
        Svc, make, mets, Rejected, Journal = (JSweepService, jax_scenario, jmetrics,
                                              JServiceRejected, JSweepJournal)
    else:
        Svc, make, mets, Rejected, Journal = (SweepService, scenario, metrics,
                                              ServiceRejected, SweepJournal)
    mets.reset()
    svc = Svc(journal_path=path, start=False, slice_coalitions=slice_coalitions)
    jobs = []
    for tenant, seed in (("A", 9), ("B", 11)):
        try:
            jobs.append(svc.submit(make(seed), tenant=tenant, job_id=f"game{tenant}"))
        except Rejected:
            jobs.append(None)
    svc.run_until_idle()
    svc.shutdown()
    counters = {k: v for k, v in mets.snapshot()["counters"].items()
                if k.startswith("service.") and "device_seconds" not in k}
    seq = [(r["type"], r.get("job"), r.get("tenant"),
            tuple(r["subset"]) if "subset" in r else None)
           for r in Journal.replay(path)[0]]
    return ([j.status if j else "rejected" for j in jobs],
            [j.attempts if j else None for j in jobs], counters, seq)


OUTCOME_PLANS = ["", "crash@job1:batch2", "oom@job1:batch2", "transient@job2:batch2",
                 "stall@job1:sec0.05", "crash@job1:batch1,crash@job1:batch2",
                 "reject@job1"]


@pytest.mark.parametrize("plan", OUTCOME_PLANS, ids=lambda p: p or "none")
def test_same_fault_plan_same_outcomes_in_both_packages(monkeypatch, tmp_path, plan):
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        monkeypatch.setenv(pkg + "SERVICE_FAULT_PLAN", plan)
        monkeypatch.setenv(pkg + "MAX_RETRIES", "1")
    _jax_batches(monkeypatch)
    jax_run = _run_in("jax", tmp_path / "jax.jsonl", len(SUBSETS))
    port_run = _run_in("port", tmp_path / "port.jsonl", len(SUBSETS))
    assert port_run == jax_run


# -- the engine's bucket plan and progress hook -------------------------------

AMOUNTS4 = [0.1, 0.2, 0.3, 0.4]
PLAN_CASES = {
    "merge": {},
    "masked": {"MPLC_TORCH_NO_SLOTS": "1"},
    "pow2": {"MPLC_TORCH_SLOT_POW2": "1"},
    "exact": {"MPLC_TORCH_SLOT_MERGE": "0"},
    "cap2": {"MPLC_TORCH_COALITIONS_PER_DEVICE": "2"},
    "dropout": {"MPLC_TORCH_PARTNER_FAULT_PLAN": "dropout@p1:epoch1"},
    "ensemble": {"MPLC_TORCH_SEED_ENSEMBLE": "2"},
}


def _logged_buckets(eng, start=0) -> list:
    out = []
    for b in eng.batch_log[start:]:
        key = (b["kind"], b["slot_count"], b["width"])
        if not out or out[-1] != key:
            out.append(key)
    return out


def _planned(eng, subsets) -> list:
    return [("single" if pipe is eng.single_pipe else "multi", slot_count, width)
            for pipe, slot_count, width in eng.sweep_plan(subsets)]


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_sweep_plan_equals_the_logged_buckets(monkeypatch, case):
    monkeypatch.delenv("MPLC_TORCH_COALITIONS_PER_DEVICE")
    for k, v in PLAN_CASES[case].items():
        monkeypatch.setenv(k, v)
    eng = CharacteristicEngine(scenario(5, partners=4, amounts=AMOUNTS4))
    subsets = powerset_order(4)
    plan = _planned(eng, subsets)
    # a quantum's chunk, then the rest: the service's use
    eng.evaluate(subsets[:6])
    assert _logged_buckets(eng) == _planned(eng, subsets[:6])
    n = len(eng.batch_log)
    rest = [s for s in subsets if s not in eng.charac_fct_values]
    want = _planned(eng, rest)
    eng.evaluate(subsets)
    assert _logged_buckets(eng, n) == want
    fresh = CharacteristicEngine(scenario(5, partners=4, amounts=AMOUNTS4))
    fresh.evaluate(subsets)
    assert _logged_buckets(fresh) == plan
    if case == "dropout":
        # the all-dropped coalition is worth 0 and never dispatched
        assert fresh.charac_fct_values[(1,)] == 0.0
        assert sum(b["coalitions"] for b in fresh.batch_log) == len(subsets) - 1


def test_progress_hook_sees_every_batch_and_a_raise_leaves_the_engine_consistent():
    eng = CharacteristicEngine(scenario(9))
    calls = []

    def hook(done, remaining, slot_count):
        calls.append((done, remaining, slot_count, len(eng.batch_log),
                      eng.device_meter.snapshot()["batches"]))
        if len(calls) == 2:
            raise RuntimeError("hook says stop")

    eng.progress = hook
    with pytest.raises(RuntimeError, match="hook says stop"):
        eng.evaluate(SUBSETS)
    # two batches harvested and recorded, nothing of a third
    assert [(c[3], c[4]) for c in calls] == [(1, 1), (2, 2)]
    assert calls[0][:3] == (1, 2, None)  # 3 singles at cap 1
    assert len(eng.charac_fct_values) == 3 and len(eng.batch_log) == 2
    eng.progress = None
    np.testing.assert_array_equal(eng.evaluate(SUBSETS), solo_values(9))


def test_reconstruction_batches_call_the_progress_hook():
    sc = scenario(9)
    c = Contributivity(sc)
    recon = c._reconstructor()
    seen = []
    recon.engine.progress = lambda done, remaining, slot_count: seen.append(
        (done, remaining, slot_count))
    recon.evaluate(SUBSETS)
    assert sum(d for d, _, _ in seen) == len(SUBSETS)
    assert all(sc_ is None for _, _, sc_ in seen) and seen[-1][1] == 0


def test_device_ctx_is_a_no_op_on_one_card():
    svc = SweepService(start=False)
    from mplc_tpu_torch.service import scheduler as sched
    with svc._device_ctx(sched._WorkerSlot(0)):
        pass
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        json.dumps(svc.varz_view())
