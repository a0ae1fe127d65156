"""The port's sweep report (`mplc_tpu_torch/obs/report.py`) and its
instrumented engines against the JAX package, on the CPU:

1. the same record list through both packages' `sweep_report` and
   `format_report`: a synthetic list that reaches every row (service, live,
   router and numerics included) and one collected from a JAX Titanic
   sweep give equal dicts and equal text;
2. the instrumented engines: a retrain-free run (GTG-Shapley, then exact
   Shapley over reconstructed models) and an exact retraining sweep, both
   on Titanic at 3 partners, each through both packages under `collect()`.
   They emit the same multiset of span and event names, apart from the
   JAX-only layers, and the same count-valued report fields. Batch widths
   follow `_bucket_size` at each package's device count and are held to it.

Deliberate differences, named here and in CHANGES.md:
  - names the JAX package does not emit: the port's own leaf spans of the
    batch path and of set-up (`obs/trace.py` `PORT_SPANS`);
  - names the port does not emit: the JAX package's jit compiles
    (`trainer.compile`: the port's only compiles are its nvcc builds, on
    the card), the program bank (`bank.*`), device fences, numerics, live,
    service, router, fleet (the fault ladder's `engine.retry/degrade/fault`
    both packages emit only under a fault plan: tests/test_torch_ladder.py);
  - widths and padding: the JAX tests' CPU mesh has 8 devices, so a JAX
    batch is a multiple of 8 rows; the port's one device pads to the next
    power of two, so it pads less;
  - the reconstruction batches' `slot_count`: the JAX evaluator groups by
    slot width, the port's by arrival (None), which leaves the batch count
    equal on these runs (each evaluate call holds one coalition size).
"""

import pytest
import torch

from helpers import build_scenario
from mplc_tpu.contrib.contributivity import Contributivity as JContributivity
from mplc_tpu.contrib.engine import _bucket_size as j_bucket_size
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.obs import metrics as jmetrics
from mplc_tpu.obs import report as jreport
from mplc_tpu.obs import trace as jtrace
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.contrib.engine import _bucket_size
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.obs import metrics, report, trace
from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

AMOUNTS = [0.2, 0.3, 0.5]
GAME = dict(epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2)
# the JAX-only layers (module docstring)
JAX_ONLY = ("trainer.compile", "bank.", "engine.device_fence", "numerics.", "live.",
            "service.", "router.", "fleet.")
# GTG: one round of 16 permutations (at sv_accuracy 1.0 the stopping rule
# never asks for more), truncation 0: every prefix is evaluated, so the
# evaluate calls follow the permutation stream and not the values
GTG = dict(sv_accuracy=1.0, truncation=0.0, min_iter=16)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in ("MPLC_TORCH_TRACE_FILE", "MPLC_TPU_TRACE_FILE"):
        monkeypatch.delenv(env, raising=False)
    metrics.reset()
    jmetrics.reset()
    yield
    metrics.reset()
    jmetrics.reset()


def _rec(name, i, dur=0.0, **attrs):
    return {"name": name, "id": i, "parent": None, "ts": 100.0 + i * 0.01,
            "dur": dur, "thread": 1, "attrs": attrs}


def synthetic_records() -> list:
    """Records reaching every row of the report."""
    specs = [
        ("mpl.fit", 0.7, dict(approach="fedavg", partners=3, epochs=2)),
        ("recon.record", 0.5, dict(partners=3, rounds=4, epochs=2,
                                   training_passes=12, memory_bytes=4096)),
        ("engine.evaluate", 2.0, dict(requested=7, missing=4, method="Shapley")),
        ("engine.evaluate", 1.0, dict(requested=3, missing=1, method="GTG-Shapley",
                                      mode="reconstruct")),
        ("engine.evaluate", 0.5, dict(requested=2, missing=2)),
        ("engine.prep", 0.25, dict(width=8, slot_count=3, coalitions=6)),
        ("engine.dispatch", 0.3, dict(width=8, slot_count=3, coalitions=6, padding=2)),
        ("engine.harvest", 0.2, dict(width=8, slot_count=3, coalitions=6)),
        ("trainer.compile", 0.5, dict(fn="brun")),
        ("bank.compile", 0.4, dict(slot_count=3, width=8, overlapped=True)),
        ("bank.compile", 0.6, dict(slot_count=None, width=4, overlapped=False)),
        ("bank.wait", 0.1, {}),
        ("engine.hbm", 0.0, dict(param_bytes=1000, slot_count=3, donation=True,
                                 per_coalition_bytes=8000,
                                 donated_bytes_per_coalition=2000,
                                 cap_before_donation=16, cap_after_donation=32,
                                 cap_effective=16, hbm_bytes_limit=10 ** 9,
                                 peak_in_use_bytes=5 * 10 ** 6)),
        ("engine.batch", 1.5, dict(ordinal=1, width=8, slot_count=3, coalitions=6,
                                   padding=2, epochs=12, samples=600,
                                   partner_passes=144, device_sec=0.9,
                                   flops=3e9, bytes_accessed=2e8)),
        ("engine.batch", 0.8, dict(ordinal=2, width=4, slot_count=None, coalitions=3,
                                   padding=1, epochs=6, samples=300,
                                   partner_passes=24, flops=1e9,
                                   bytes_accessed=1e8)),
        ("engine.batch", 0.6, dict(ordinal=3, width=4, slot_count=None, coalitions=2,
                                   padding=2, epochs=4, samples=100,
                                   partner_passes=8, degraded="cpu")),
        ("engine.batch", 0.1, dict(ordinal=4, width=8, slot_count=None, coalitions=5,
                                   padding=3, epochs=0, samples=0,
                                   partner_passes=0, eval_only=True)),
        ("engine.device_fence", 0.9, dict(ordinal=1, width=8, coalitions=6,
                                          interval=16)),
        ("engine.retry", 0.0, dict(site="dispatch", attempt=1, backoff_sec=0.05,
                                   ordinal=1)),
        ("engine.degrade", 0.0, dict(action="halve_cap")),
        ("engine.degrade", 0.0, dict(action="cpu_fallback")),
        ("engine.degrade", 0.0, dict(action="ladder_exhausted")),
        ("engine.fault", 0.0, dict(kind="transient", site="dispatch", ordinal=1)),
        ("service.slice", 0.4, dict(tenant="a", job="j1", batches=2, coalitions=8,
                                    epochs=16, samples=800, packed_batches=1,
                                    device_sec=0.3)),
        ("service.slice", 0.2, dict(tenant="b", job="j2", batches=1, coalitions=4,
                                    epochs=8, samples=400, packed_batches=0)),
        ("service.slice", 0.1, dict(tenant="b", job="j2", outcome="fault",
                                    device_sec=0.05)),
        ("service.job_fault", 0.0, dict(tenant="b", job="j2", attempt=1,
                                        requeued=True)),
        ("service.job", 0.0, dict(job="j1", tenant="a", status="completed",
                                  queue_wait_sec=0.01, ttfv_sec=0.2)),
        ("service.job", 0.0, dict(job="j2", tenant="b", status="quarantined",
                                  recovered=True, deadline_missed=True,
                                  queue_wait_sec=0.03)),
        ("router.submit", 0.0, dict(tenant="a", job="j1", shard="s0", route_s=0.02)),
        ("router.redirect", 0.0, dict(tenant="a", job="j1", attempt=1)),
        ("router.repin", 0.0, dict(tenant="a", reason="overload")),
        ("router.failover", 0.0, dict(shard="s1", jobs=2, resubmitted=2)),
        ("router.exhausted", 0.0, dict(tenant="b", job="j3", attempts=4)),
        ("numerics.audit", 0.0, dict(subset=[0, 1], max_ulp=3,
                                     reduction_mode="ordered")),
        ("numerics.drift", 0.0, dict(subset=[0, 1], round=2)),
        ("numerics.ledger", 0.0, dict(path="/x/ledger.json", entries=7,
                                      reduction_mode="ordered")),
        ("contrib.plan", 0.0, dict(method="exact", est_evals=7, reason="small")),
        ("live.plan", 0.0, dict(method="GTG-Shapley", tenant="a")),
        ("live.query", 0.3, dict(tenant="a", method="exact", rounds=4,
                                 evaluations=7, pruned=1)),
        ("live.query", 0.0, dict(tenant="a", method="exact", rounds=4,
                                 memo_hit=True)),
        ("live.append", 0.0, dict(tenant="a", seq=1)),
        ("live.recover", 0.0, dict(tenant="a", rounds=4)),
        ("live.evict", 0.0, dict(tenant="a", rounds=4)),
        ("live.restore", 0.0, dict(tenant="a", restore_s=0.12)),
        ("live.ingest", 0.0, dict(tenant="a", stamp=5)),
        ("contrib.trust", 0.0, dict(method="GTG-Shapley", kendall_tau=0.8,
                                    std=[0.1, 0.2, 0.3], source="mc_blocks")),
        ("contributivity", 2.5, dict(method="Shapley")),
        ("contributivity", 1.2, dict(method="GTG-Shapley")),
    ]
    return [_rec(name, i, dur, **attrs) for i, (name, dur, attrs) in enumerate(specs)]


def _jax_titanic_sweep_records() -> list:
    """Records collected from a JAX Titanic exact sweep (3 partners)."""
    jsc = build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True, **GAME)
    with jtrace.collect() as recs:
        JContributivity(jsc).compute_SV()
    return recs


REPORT_KW = dict(flops_per_sample=1e5, peak_flops=5e12, hbm_bytes_per_s=1e12)


@pytest.mark.parametrize("source,kw", [
    ("synthetic", {}), ("synthetic", REPORT_KW), ("jax titanic", {}),
    ("jax titanic", REPORT_KW), ("empty", {})])
def test_sweep_report_equals_jax_on_same_records(source, kw):
    recs = {"synthetic": synthetic_records, "empty": list,
            "jax titanic": _jax_titanic_sweep_records}[source]()
    snap = {"counters": {"engine.memo_hits": 3.0}, "gauges": {}, "histograms": {}}
    ours = report.sweep_report(recs, metrics_snapshot=snap, **kw)
    theirs = jreport.sweep_report(recs, metrics_snapshot=snap, **kw)
    assert ours == theirs
    assert report.format_report(ours) == jreport.format_report(theirs)
    if source == "synthetic":
        # every optional row is reached
        assert {"program_bank", "hbm", "reconstruction", "device_time", "roofline",
                "live", "planner", "service", "slo", "router", "numerics", "trust",
                "fits", "metrics"} <= set(ours)


def test_write_report_round_trip(tmp_path):
    import json

    rep = report.sweep_report(synthetic_records())
    path = tmp_path / "rep.json"
    report.write_report(str(path), rep)
    assert json.loads(path.read_text())["memo"] == rep["memo"]


# ---------------------------------------------------------------------------
# 2. the instrumented engines, both packages on one Titanic game
# ---------------------------------------------------------------------------

def _jax_scenario():
    return build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True, **GAME)


def _port_scenario():
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), seed=3,
                  is_early_stopping=False, device="cpu", **GAME)
    sc.instantiate_scenario_partners()
    sc.split_data()
    sc.compute_batch_sizes()
    sc.data_corruption()
    return sc


def _drive(sc, contributivity, collect, run: str):
    """(records, contributivity objects): the fit, then the run's methods,
    under `collect()`."""
    with collect() as recs:
        sc.mpl = sc.multi_partner_learning_approach(sc)
        sc.mpl.fit()
        methods = [contributivity(sc)]
        if run == "retrain-free":
            methods[0].GTG_Shapley(**GTG)
            methods.append(contributivity(sc))
            methods[1].exact_reconstructed()
        else:
            methods[0].compute_SV()
    return recs, methods


@pytest.fixture(scope="module")
def runs():
    """{run: (JAX records, port records, port methods, port scenario, the
    port's metrics snapshot of the run)}"""
    out = {}
    for run in ("retrain-free", "sweep"):
        jrecs, _ = _drive(_jax_scenario(), JContributivity, jtrace.collect, run)
        sc = _port_scenario()
        metrics.reset()
        recs, methods = _drive(sc, Contributivity, trace.collect, run)
        out[run] = (jrecs, recs, methods, sc, metrics.snapshot())
    return out


def _names(recs) -> list:
    return sorted(r["name"] for r in recs if not r["name"].startswith(JAX_ONLY)
                  and r["name"] not in trace.PORT_SPANS)


@pytest.mark.parametrize("run", ["retrain-free", "sweep"])
def test_engines_emit_the_jax_names(runs, run):
    jrecs, recs, _, _, _ = runs[run]
    assert _names(recs) == _names(jrecs)
    assert {r["name"] for r in recs} <= set(trace.SPAN_REGISTRY)
    # nesting: every batch's dispatch and harvest sit in an evaluate span,
    # the recording's dispatch in its recon.record span
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] in ("engine.dispatch", "engine.harvest"):
            want = ("recon.record" if r["attrs"].get("recording")
                    else "engine.evaluate")
            assert by_id[r["parent"]]["name"] == want


@pytest.mark.parametrize("run", ["retrain-free", "sweep"])
def test_engines_count_like_jax(runs, run):
    jrecs, recs, _, sc, snap = runs[run]
    ours, theirs = report.sweep_report(recs), jreport.sweep_report(jrecs)
    assert ours["memo"] == theirs["memo"]
    for key in ("coalitions", "epochs_trained"):
        assert ours["batches"][key] == theirs["batches"][key], key
    assert ours["batches"]["count"] == theirs["batches"]["count"]
    for key in ("train_samples", "partner_passes"):
        assert ours["compute"][key] == theirs["compute"][key], key
    assert [e["method"] for e in ours["estimators"]] == \
        [e["method"] for e in theirs["estimators"]]
    eng = sc._charac_engine
    assert eng.epochs_trained == ours["batches"]["epochs_trained"]
    assert eng.samples_trained == ours["compute"]["train_samples"]
    if run == "retrain-free":
        rows = ours["reconstruction"], theirs["reconstruction"]
        for key in ("reconstructions", "recon_batches", "recording_partner_passes",
                    "recorded_rounds", "recorded_partners", "train_partner_passes",
                    "train_batches"):
            assert rows[0][key] == rows[1][key], key
        assert rows[0]["reconstructions"] == eng._reconstruction.reconstructions
    else:
        assert ours["hbm"]["param_bytes"] == theirs["hbm"]["param_bytes"]
        assert ours["hbm"]["slot_count"] == theirs["hbm"]["slot_count"]
    # the metrics registry counted what the records say
    snap = snap["counters"]
    assert snap["engine.memo_hits"] == ours["memo"]["hits"]
    assert snap["engine.memo_misses"] == ours["memo"]["misses"]
    assert snap["engine.epochs_trained"] == ours["batches"]["epochs_trained"]


@pytest.mark.parametrize("run", ["retrain-free", "sweep"])
def test_widths_follow_each_packages_bucket_formula(runs, run):
    """Each batch's width is `_bucket_size` of its coalitions at the
    package's device count: 8 on the JAX tests' CPU mesh, 1 for the port,
    whose batches therefore pad no more than the JAX package's."""
    import jax

    jrecs, recs, _, _, _ = runs[run]
    n_dev = len(jax.devices())
    cap = constants.MAX_COALITIONS_PER_DEVICE_BATCH

    def batches(rs):
        return [r["attrs"] for r in rs
                if r["name"] == "engine.batch" and not r["attrs"].get("recording")]

    ours, theirs = batches(recs), batches(jrecs)
    assert [a["coalitions"] for a in ours] == [a["coalitions"] for a in theirs]
    for a, j in zip(ours, theirs):
        assert a["width"] == _bucket_size(a["coalitions"], 1, cap)
        assert j["width"] == j_bucket_size(j["coalitions"], n_dev, cap)
        assert a["padding"] == a["width"] - a["coalitions"] <= j["padding"]


def test_contributivity_span_is_the_method_timer(runs):
    _, recs, methods, sc, _ = runs["retrain-free"]
    spans = [r for r in recs if r["name"] == "contributivity"]
    assert [r["attrs"]["method"] for r in spans] == ["GTG-Shapley",
                                                     "exact (reconstructed)"]
    assert [r["dur"] for r in spans] == [c.computation_time_sec for c in methods]
    trust = [r for r in recs if r["name"] == "contrib.trust"]
    assert [r["attrs"] for r in trust] == [methods[0].trust]
    fits = [r for r in recs if r["name"] == "mpl.fit"]
    assert fits[0]["dur"] == sc.mpl.learning_computation_time
    assert fits[0]["attrs"] == {"approach": "fedavg", "partners": 3, "epochs": 2}
