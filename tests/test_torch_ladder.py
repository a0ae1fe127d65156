"""The port's fault ladder (`mplc_tpu_torch/faults.py`, the engine's
`_run_batch` and the reconstruction evaluator's) on the CPU, one torch
thread:

1. the batch-fault plan's grammar, the injector and the classifier against
   `mplc_tpu.faults` on the same specs, messages and classes, plus torch's
   own errors (CUDA OOM, cuBLAS and cuDNN allocation failures, sticky CUDA
   errors, K1's launch failure, a failed kernel build);
2. the retraining sweep (Titanic, 5 partners, cap 2) under each plan of
   `tests/test_faults.py`: every recovered run bit-equal to the port's own
   fault-free run, each coalition trained once;
3. the same game and plans through the JAX engine (one device, the same
   cap): the same batch ordinals and widths, the same ladder counters and
   the same resilience row of `obs.report.sweep_report`;
4. the retrain-free path under the plans of `tests/test_reconstruct.py`:
   GTG-Shapley and SVARM bit-equal to their fault-free runs, the CPU rung
   bit-equal (a CPU engine's: device and rung are both the CPU), an OOM on
   the CPU rung propagating;
5. the ladder's end on a card: an engine whose device is CUDA (its data
   staged on the CPU here; every batch fails at the plan's dispatch check,
   before it touches the device) raises the classified, permanent
   `LadderExhaustedError` with its flight dump, and takes no CPU rung.

Every comparison of values is exact (`assert_array_equal`). The JAX engine
is held to one device by patching its `coalition_sharding` (nothing in the
JAX package changes).
"""

import os
import warnings

import numpy as np
import pytest
import torch

from helpers import build_scenario
from mplc_tpu import faults as jfaults
from mplc_tpu.contrib import engine as jengine_mod
from mplc_tpu.obs import metrics as jmetrics
from mplc_tpu.obs import report as jreport
from mplc_tpu.obs import trace as jtrace
from mplc_tpu_torch import constants, faults
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.data import datasets
from mplc_tpu_torch.obs import metrics, report, trace
from mplc_tpu_torch.ops import cuda_build
from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

AMOUNTS = [0.1, 0.15, 0.2, 0.25, 0.3]
GAME = dict(epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2)
SUBSETS = powerset_order(5)
_KNOBS = ("FAULT_PLAN", "MAX_RETRIES", "MAX_CAP_HALVINGS", "PARTNER_FAULT_PLAN",
          "SEED_ENSEMBLE", "BATCH_CAP_CEILING")


@pytest.fixture(autouse=True)
def _fault_env(monkeypatch, tmp_path):
    for k in _KNOBS:
        monkeypatch.delenv(f"MPLC_TORCH_{k}", raising=False)
        monkeypatch.delenv(f"MPLC_TPU_{k}", raising=False)
    for prefix in ("MPLC_TORCH_", "MPLC_TPU_"):
        monkeypatch.setenv(prefix + "RETRY_BACKOFF_SEC", "0")
        # cap 2: singles in 3 batches (width 2), the width-3 slot bucket in
        # 10, the width-5 bucket in 3
        monkeypatch.setenv(prefix + "COALITIONS_PER_DEVICE", "2")
    monkeypatch.setenv("MPLC_TORCH_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))
    metrics.reset()
    jmetrics.reset()
    yield
    metrics.reset()
    jmetrics.reset()


def port_scenario(partners: int = 5) -> Scenario:
    sc = Scenario(partners, AMOUNTS[:partners] if partners == 5 else [0.2, 0.3, 0.5],
                  is_dry_run=True, dataset=datasets.load_titanic(), seed=9,
                  is_early_stopping=False, device="cpu", **GAME)
    sc.instantiate_scenario_partners()
    sc.split_data()
    sc.compute_batch_sizes()
    sc.data_corruption()
    return sc


_REF = {}


def reference() -> np.ndarray:
    """The port's fault-free v(S) of the game, computed once."""
    assert constants.FAULT_PLAN_ENV not in os.environ
    if "vals" not in _REF:
        _REF["vals"] = CharacteristicEngine(port_scenario()).evaluate(SUBSETS)
    return _REF["vals"]


def counters() -> dict:
    return metrics.snapshot()["counters"]


# ---------------------------------------------------------------------------
# 1. plan grammar, injector, classifier
# ---------------------------------------------------------------------------

PLAN_SPECS = [
    None, "",
    "transient@batch3, oom@batch5,crash@batch7,transient@harvest2,transient@batch3",
    "bogus@batch3,transient@batch2",
    "transient@epoch3", "transient@batch0", "oom@batch-1", "transient", "@batch3",
    "oom@batchx", "oom@harvest1,,crash@harvest12",
]


@pytest.mark.parametrize("spec", PLAN_SPECS)
def test_plan_grammar_matches_jax(spec):
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        plan = faults.parse_fault_plan(spec)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        jplan = jfaults.parse_fault_plan(spec)
    assert plan == jplan
    assert len(ours) == len(theirs)
    assert all(constants.FAULT_PLAN_ENV in str(w.message) for w in ours)


def _fire(mod, spec, checks):
    """[(site, ordinal, kind raised or None)] and the injector's state
    after `checks` on a fresh injector of `mod`."""
    inj = mod.FaultInjector(mod.parse_fault_plan(spec))
    out = []
    for site, ordinal in checks:
        try:
            inj.check(site, ordinal)
            out.append(None)
        except BaseException as e:  # noqa: BLE001 - the crash class is one
            out.append(type(e).__name__)
    return out, inj.injected, inj.armed


@pytest.mark.parametrize("spec", ["transient@batch2", "transient@batch1,transient@batch1,oom@harvest1",
                                  "crash@batch2,oom@batch2"])
def test_injector_fires_each_entry_once_like_jax(spec):
    checks = [("dispatch", 1), ("harvest", 2), ("dispatch", 2), ("dispatch", 2),
              ("dispatch", 1), ("dispatch", 1), ("harvest", 1), ("harvest", 1)]
    assert _fire(faults, spec, checks) == _fire(jfaults, spec, checks)


def test_injector_counts_and_emits_its_faults():
    inj = faults.FaultInjector(faults.parse_fault_plan("transient@batch2,oom@harvest2"))
    with trace.collect() as recs:
        with pytest.raises(faults.InjectedTransient):
            inj.check("dispatch", 2)
        with pytest.raises(faults.InjectedOom) as oom:
            inj.check("harvest", 2)
    assert isinstance(oom.value, torch.cuda.OutOfMemoryError)
    assert counters()["engine.faults_injected"] == 2 and inj.injected == 2 and not inj.armed
    assert [r["attrs"] for r in recs if r["name"] == "engine.fault"] == [
        {"kind": "transient", "site": "dispatch", "ordinal": 2},
        {"kind": "oom", "site": "harvest", "ordinal": 2}]
    assert not isinstance(faults.InjectedCrash("kill"), Exception)


# (message, class) pairs of tests/test_faults.py:103-158 built from plain
# classes, which both packages see alike
_PLAIN = [
    (RuntimeError, "INTERNAL: device halted"), (RuntimeError, "UNAVAILABLE: tunnel reset"),
    (RuntimeError, "INVALID_ARGUMENT: bad shape"), (RuntimeError, "INTERNAL: looks xla-ish"),
    (ValueError, "nope"), (RuntimeError, "RESOURCE_EXHAUSTED: 13.5G of 16G HBM"),
    (RuntimeError, "DEADLINE_EXCEEDED: rpc timed out"), (OSError, "DEADLINE_EXCEEDED: rpc timed out"),
    (ConnectionError, "UNAVAILABLE: rpc timed out"), (RuntimeError, "  UNAVAILABLE: x"),
    (RuntimeError, "  DEADLINE_EXCEEDED: x"),
    (RuntimeError, "got error DEADLINE_EXCEEDED somewhere"),
    (RuntimeError, "UNAVAILABLE_RESOURCE: config bug"),
    (RuntimeError, "DEADLINE_EXCEEDED2: odd custom error"), (RuntimeError, "UNAVAILABLE"),
    (RuntimeError, "INVALID_ARGUMENT: x"), (MemoryError, "Out of memory"),
    (RuntimeError, "OOM when allocating tensor"),
]


def _pairs():
    """(port error, JAX error) pairs: the plain cases, then each injected
    class beside its JAX counterpart, and the ladder's terminal error."""
    out = [(cls(msg), cls(msg)) for cls, msg in _PLAIN]
    out += [(faults.InjectedTransient("UNAVAILABLE: x"), jfaults.InjectedTransient("INTERNAL: x")),
            (faults.InjectedOom("CUDA out of memory: injected"),
             jfaults.InjectedOom("RESOURCE_EXHAUSTED: injected")),
            (faults.InjectedCrash("DEADLINE_EXCEEDED: kill"),
             jfaults.InjectedCrash("DEADLINE_EXCEEDED: kill")),
            (faults.LadderExhaustedError("device OOM persisted: RESOURCE_EXHAUSTED", halvings=3),
             jfaults.LadderExhaustedError("device OOM persisted: RESOURCE_EXHAUSTED", halvings=3))]
    return out


@pytest.mark.parametrize("i", range(len(_PLAIN) + 4))
def test_classifier_matches_jax(i):
    ours, theirs = _pairs()[i]
    assert faults.is_oom(ours) == jfaults.is_oom(theirs)
    assert faults.is_transient(ours) == jfaults.is_transient(theirs)


def _build_failure() -> RuntimeError:
    """The error a kernel build raises where nvcc is missing (the CPU)."""
    try:
        cuda_build.build(["recon_matmul"])
    except RuntimeError as e:
        return e
    pytest.fail("the kernel build did not fail without nvcc")


TORCH_CASES = [
    # (error, is_oom, is_transient)
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     True, False),
    (lambda: RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
                          "`cublasCreate(handle)`"), True, False),
    (lambda: RuntimeError("cuDNN error: CUDNN_STATUS_ALLOC_FAILED"), True, False),
    (lambda: RuntimeError("CUDA error: an illegal memory access was encountered"), False, False),
    (lambda: RuntimeError("UNAVAILABLE: CUDA error: an illegal memory access was "
                          "encountered"), False, False),
    (lambda: RuntimeError("CUDA error: device-side assert triggered"), False, False),
    (lambda: RuntimeError("CUDA error: unspecified launch failure"), False, False),
    (lambda: torch.cuda.OutOfMemoryError("CUDA error: an illegal memory access was "
                                         "encountered"), False, False),
    # K1's own launch failure (ops/recon_kernel.py `_launch_checked`);
    # cudaError 2 is cudaErrorMemoryAllocation
    (lambda: RuntimeError("recon_matmul launch failed: cudaError 2"), False, False),
    (lambda: RuntimeError("recon_matmul_bf16 launch failed: cudaError 700"), False, False),
    (lambda: RuntimeError("nvcc failed:\nrecon_matmul.cu: out of memory"), False, False),
    (_build_failure, False, False),
]


@pytest.mark.parametrize("i", range(len(TORCH_CASES)))
def test_classifier_torch_cases(i):
    make, oom, transient = TORCH_CASES[i]
    err = make()
    assert (faults.is_oom(err), faults.is_transient(err)) == (oom, transient), str(err)


# ---------------------------------------------------------------------------
# 2. the retraining sweep under each plan, against the port's own clean run
# ---------------------------------------------------------------------------

def _plan_run(monkeypatch, plan, **env):
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, plan)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = CharacteristicEngine(port_scenario())
    with trace.collect() as recs:
        vals = eng.evaluate(SUBSETS)
    return eng, vals, recs


@pytest.mark.parametrize("plan,retries,halvings", [
    ("transient@batch2", 1, 0),              # dispatch
    ("transient@harvest2", 1, 0),            # harvest: the batch is re-dispatched
    ("transient@batch2,transient@harvest5", 2, 0),
    ("oom@batch5", 0, 1),                    # halving and re-bucketing
    ("oom@harvest2", 0, 1),                  # OOM at harvest
    ("oom@harvest2,oom@batch3", 0, 2),       # OOM at harvest, then at the re-run's dispatch
])
def test_recovered_sweep_is_bit_equal(monkeypatch, plan, retries, halvings):
    ref = reference()
    eng, vals, recs = _plan_run(monkeypatch, plan)
    np.testing.assert_array_equal(vals, ref)
    assert eng._cap_halvings == halvings and not eng._cpu_degraded
    assert eng.first_charac_fct_calls_count == len(SUBSETS)
    snap = counters()
    assert snap.get("engine.retries", 0) == retries
    assert snap.get("engine.cap_halvings", 0) == halvings
    assert snap["engine.faults_injected"] == plan.count("@")
    assert not eng._faults.armed
    rep = report.sweep_report(recs)["resilience"]
    assert (rep["retries"], rep["cap_halvings"], rep["faults_injected"]) == (
        retries, halvings, plan.count("@"))


def test_oom_halves_the_width_and_rebuckets(monkeypatch):
    ref = reference()
    eng, vals, recs = _plan_run(monkeypatch, "oom@batch5")
    np.testing.assert_array_equal(vals, ref)
    widths = [r["attrs"]["width"] for r in recs if r["name"] == "engine.batch"]
    # before the rung: width 2; the width-3 bucket's batch 5 failed and its
    # remaining coalitions re-bucketed at width 1
    assert widths[:3] == [2, 2, 2] and widths[3] == 2 and set(widths[4:]) == {1}
    assert [r["attrs"]["action"] for r in recs if r["name"] == "engine.degrade"] == ["halve_cap"]


def test_retry_budget_exhaustion_propagates(monkeypatch):
    monkeypatch.setenv(constants.MAX_RETRIES_ENV, "2")
    monkeypatch.setenv(constants.FAULT_PLAN_ENV,
                       "transient@batch1,transient@batch1,transient@batch1")
    eng = CharacteristicEngine(port_scenario())
    with pytest.raises(faults.InjectedTransient):
        eng.evaluate(SUBSETS)
    assert counters()["engine.retries"] == 2


def test_backoff_is_exponential_and_bounded(monkeypatch):
    sleeps = []
    monkeypatch.setattr("time.sleep", sleeps.append)
    eng = CharacteristicEngine(port_scenario())
    eng._retry_backoff = 8.0
    eng._max_retries = 5
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 4:
            raise faults.InjectedTransient("UNAVAILABLE: flaky")
        return "ok"

    assert eng._retry_transient(flaky, "dispatch") == "ok"
    assert sleeps == [8.0, 16.0, 30.0, 30.0]
    assert constants.RETRY_BACKOFF_CAP_SEC == 30.0
    assert counters()["engine.backoff_sec"] == sum(sleeps)


def test_fetch_retry_covers_redispatch_failures():
    eng = CharacteristicEngine(port_scenario())
    calls = {"redispatch": 0}

    def redispatch():
        calls["redispatch"] += 1
        if calls["redispatch"] == 1:
            raise faults.InjectedTransient("UNAVAILABLE: redispatch flake")
        return lambda: "ok"

    def failing_fetch():
        raise faults.InjectedTransient("UNAVAILABLE: fetch flake")

    assert eng._fetch_with_retry(failing_fetch, {"redispatch": redispatch, "ordinal": 0}) == "ok"
    assert counters()["engine.retries"] == 2


def test_cpu_rung_is_bit_equal_and_loud(monkeypatch, caplog):
    ref = reference()
    with caplog.at_level("WARNING", logger="mplc_tpu_torch"):
        eng, vals, recs = _plan_run(monkeypatch, "oom@batch2,oom@batch3",
                                    **{constants.MAX_CAP_HALVINGS_ENV: "1"})
    np.testing.assert_array_equal(vals, ref)
    assert eng._cpu_degraded and eng.first_charac_fct_calls_count == len(SUBSETS)
    assert any("run on the CPU" in r.getMessage() for r in caplog.records)
    cpu = [r for r in recs if r["name"] == "engine.batch" and r["attrs"].get("degraded") == "cpu"]
    snap = counters()
    assert cpu and snap["engine.cpu_degraded_batches"] == len(cpu)
    assert snap["engine.cpu_degraded_coalitions"] == sum(r["attrs"]["coalitions"] for r in cpu)
    assert [r["attrs"]["action"] for r in recs if r["name"] == "engine.degrade"] == [
        "halve_cap", "cpu_fallback"]
    assert sum(1 for b in eng.batch_log if b.get("degraded") == "cpu") == len(cpu)
    rep = report.sweep_report(recs)
    assert rep["resilience"]["cpu_degraded"] is True
    assert rep["resilience"]["cpu_batches"] == len(cpu)
    text = report.format_report(rep)
    assert "cpu_batches=" in text and "cap_halvings=2" in text


def test_crash_is_not_swallowed(monkeypatch):
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, "crash@batch1")
    eng = CharacteristicEngine(port_scenario())
    with pytest.raises(faults.InjectedCrash):
        eng.evaluate(SUBSETS)
    assert counters().get("engine.retries") is None


def test_crash_then_resume_from_the_autosave_is_bit_equal(monkeypatch, tmp_path):
    ref = reference()
    path = tmp_path / "coalition_cache.json"
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, "crash@batch6")
    eng = CharacteristicEngine(port_scenario())
    eng.autosave_path = path
    with pytest.raises(faults.InjectedCrash):
        eng.evaluate(SUBSETS)
    monkeypatch.delenv(constants.FAULT_PLAN_ENV)
    resumed = CharacteristicEngine(port_scenario())
    resumed.load_cache(path)
    done = resumed.first_charac_fct_calls_count
    # batches 1-5 were harvested and saved before batch 6's dispatch
    # crashed: the 5 singles (2, 2, 1) and two batches of 2 of the width-3
    # bucket
    assert done == 9
    np.testing.assert_array_equal(resumed.evaluate(SUBSETS), ref)
    assert resumed.first_charac_fct_calls_count == len(SUBSETS)


# ---------------------------------------------------------------------------
# 3. the JAX engine on the same game and plans
# ---------------------------------------------------------------------------

def jax_scenario():
    from mplc_tpu.data import datasets as jdatasets
    return build_scenario(partners_count=5, amounts_per_partner=AMOUNTS,
                          dataset=jdatasets.load_titanic(), is_dry_run=True, seed=9, **GAME)


PARITY_PLANS = [
    ("transient@batch2,transient@harvest5", {}),
    ("oom@batch5", {}),
    ("oom@harvest2,oom@batch3", {}),
    ("oom@batch2,oom@batch3", {"MAX_CAP_HALVINGS": "1"}),
]


def _ladder_view(recs, snap) -> tuple:
    batches = [(r["attrs"]["ordinal"], r["attrs"]["width"], r["attrs"]["coalitions"],
                r["attrs"].get("degraded")) for r in recs if r["name"] == "engine.batch"]
    keys = ("engine.retries", "engine.faults_injected", "engine.cap_halvings",
            "engine.cpu_degraded_batches", "engine.cpu_degraded_coalitions")
    return sorted(batches), {k: snap["counters"].get(k, 0) for k in keys}


@pytest.mark.parametrize("plan,env", PARITY_PLANS)
def test_ladder_counts_like_the_jax_engine(monkeypatch, plan, env):
    for prefix in ("MPLC_TORCH_", "MPLC_TPU_"):
        monkeypatch.setenv(prefix + "FAULT_PLAN", plan)
        for k, v in env.items():
            monkeypatch.setenv(prefix + k, v)
    monkeypatch.setenv("MPLC_TPU_PROGRAM_BANK", "0")
    # the port harvests each batch before the next dispatch: the JAX
    # engine's sequential mode
    monkeypatch.setenv("MPLC_TPU_PIPELINE_BATCHES", "0")
    monkeypatch.setattr(jengine_mod, "coalition_sharding", lambda: None)
    jeng = jengine_mod.CharacteristicEngine(jax_scenario())
    with jtrace.collect() as jrecs:
        jeng.evaluate(SUBSETS)
    jsnap = jmetrics.snapshot()
    eng = CharacteristicEngine(port_scenario())
    with trace.collect() as recs:
        eng.evaluate(SUBSETS)
    assert _ladder_view(recs, metrics.snapshot()) == _ladder_view(jrecs, jsnap)
    assert (eng._cap_halvings, eng._cpu_degraded) == (jeng._cap_halvings, jeng._cpu_degraded)
    ours = report.sweep_report(recs)["resilience"]
    theirs = jreport.sweep_report(jrecs)["resilience"]
    assert ours == theirs
    assert eng.first_charac_fct_calls_count == jeng.first_charac_fct_calls_count == 31


# ---------------------------------------------------------------------------
# 4. the retrain-free path under the ladder
# ---------------------------------------------------------------------------

def _recon_run(method):
    c = Contributivity(port_scenario(3))
    if method == "GTG-Shapley":
        c.GTG_Shapley(sv_accuracy=1.0, min_iter=16, perm_batch=8)
    else:
        c.SVARM(budget=48, block=16)
    return np.array(c.contributivity_scores), c


@pytest.mark.parametrize("method", ["GTG-Shapley", "SVARM"])
@pytest.mark.parametrize("plan,expect", [
    # batch 1 is the recording; 2 on are evaluator batches
    ("transient@batch1,transient@batch3", "engine.retries"),
    ("transient@harvest2", "engine.retries"),
    ("oom@batch2", "engine.cap_halvings"),
    ("oom@harvest3", "engine.cap_halvings"),
])
def test_retrain_free_ladder_is_bit_equal(monkeypatch, method, plan, expect):
    clean, _ = _recon_run(method)
    metrics.reset()
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, plan)
    faulted, c = _recon_run(method)
    snap = counters()
    assert snap["engine.faults_injected"] == plan.count("@")
    assert snap.get(expect, 0) >= 1
    np.testing.assert_array_equal(clean, faulted)
    assert not c.engine._faults.armed


def test_recording_retries_transients_and_propagates_oom(monkeypatch):
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, "transient@batch1")
    c = Contributivity(port_scenario(3))
    rec = c._reconstructor().recorded
    assert counters()["engine.retries"] == 1
    clean = Contributivity(port_scenario(3))
    monkeypatch.delenv(constants.FAULT_PLAN_ENV)
    ref = clean._reconstructor().recorded
    assert torch.equal(rec.weights, ref.weights)
    for g in rec.deltas:
        for k in rec.deltas[g]:
            assert torch.equal(rec.deltas[g][k], ref.deltas[g][k])
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, "oom@batch1")
    with pytest.raises(faults.InjectedOom):
        Contributivity(port_scenario(3))._reconstructor()


def test_recon_cpu_rung_is_bit_equal_and_loud(monkeypatch):
    subsets = [(0, 1), (0, 2), (1, 2), (0, 1, 2), (0,), (2,)]
    ref = Contributivity(port_scenario(3))._reconstructor().evaluate(subsets)
    metrics.reset()
    monkeypatch.setenv(constants.MAX_CAP_HALVINGS_ENV, "1")
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, "oom@batch2,oom@batch3")
    c = Contributivity(port_scenario(3))
    recon = c._reconstructor()
    with trace.collect() as recs:
        vals = recon.evaluate(subsets)
    np.testing.assert_array_equal(vals, ref)
    assert c.engine._cpu_degraded
    snap = counters()
    assert snap["engine.cpu_degraded_batches"] == 1
    assert snap["engine.cpu_degraded_coalitions"] == len(subsets)
    assert [r["attrs"]["action"] for r in recs if r["name"] == "engine.degrade"] == [
        "halve_cap", "cpu_fallback"]
    batches = [r["attrs"] for r in recs if r["name"] == "engine.batch"]
    assert [(b["width"], b.get("degraded")) for b in batches] == [(8, "cpu")]


def test_recon_cpu_rung_oom_propagates(monkeypatch):
    """An OOM on the CPU rung propagates instead of re-entering the
    ladder (which would re-dispatch the same CPU batch for ever)."""
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, "oom@batch2,oom@batch3,oom@batch4")
    monkeypatch.setenv(constants.MAX_CAP_HALVINGS_ENV, "1")
    c = Contributivity(port_scenario(3))
    recon = c._reconstructor()
    with pytest.raises(Exception) as ei:
        recon.evaluate([(0, 1), (0, 2), (1, 2), (0, 1, 2)])
    assert faults.is_oom(ei.value)
    assert c.engine._cpu_degraded


def test_recon_width_halves_with_the_engine_cap(monkeypatch):
    """A chunk is RECON_BATCH coalitions, halved by every rung: after one
    halving the evaluator's batches are at most RECON_BATCH // 2 wide."""
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, "oom@batch2")
    c = Contributivity(port_scenario(3))
    recon = c._reconstructor()
    with trace.collect() as recs:
        recon.evaluate(powerset_order(3))
    widths = [r["attrs"]["width"] for r in recs if r["name"] == "engine.batch"]
    assert c.engine._cap_halvings == 1 and recon._chunk() == constants.RECON_BATCH // 2
    assert widths == [8]   # 7 coalitions padded to 8 (the failed try left no batch)


# ---------------------------------------------------------------------------
# 5. the ladder's end on a card
# ---------------------------------------------------------------------------

def _on_card(eng):
    """`eng` taken for a CUDA engine: only the ladder reads its device
    here, since every batch fails at the plan's dispatch check first."""
    eng.device = torch.device("cuda")
    return eng


def _sweep_on_card():
    eng = _on_card(CharacteristicEngine(port_scenario()))
    eng.evaluate(SUBSETS)
    return eng


def _evaluator_on_card():
    c = Contributivity(port_scenario(3))
    recon = c._reconstructor()      # batch 1, recorded on the CPU
    _on_card(c.engine)
    recon.evaluate([(0, 1), (0, 2), (1, 2), (0, 1, 2)])
    return c.engine


@pytest.mark.parametrize("run,plan", [
    (_sweep_on_card, "oom@batch1,oom@batch2"),
    (_evaluator_on_card, "oom@batch2,oom@batch3"),
], ids=["sweep", "evaluator"])
def test_card_ladder_ends_in_a_classified_error(monkeypatch, tmp_path, run, plan):
    monkeypatch.setenv(constants.MAX_CAP_HALVINGS_ENV, "1")
    monkeypatch.setenv(constants.FAULT_PLAN_ENV, plan)
    with trace.collect() as recs, pytest.raises(faults.LadderExhaustedError) as ei:
        run()
    err = ei.value
    assert isinstance(err.__cause__, faults.InjectedOom)
    assert not faults.is_transient(err) and not faults.is_oom(err)
    assert err.halvings == 2 and err.mode == "1d"
    assert err.postmortem_path and os.path.dirname(err.postmortem_path) == str(
        tmp_path / "flight")
    snap = counters()
    assert snap["engine.ladder_exhausted"] == 1 and snap["engine.cap_halvings"] == 2
    assert "engine.cpu_degraded_batches" not in snap
    assert [r["attrs"]["action"] for r in recs if r["name"] == "engine.degrade"] == [
        "halve_cap", "ladder_exhausted"]
    assert not [r for r in recs if r["name"] == "engine.batch"
                and not r["attrs"].get("recording")]
    rep = report.sweep_report(recs)["resilience"]
    assert rep["ladder_exhausted"] == 1 and not rep["cpu_degraded"]
