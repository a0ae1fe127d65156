"""The port's load and chaos harness (`mplc_tpu_torch/load_gen.py`) after
tests/test_load_harness.py, on the CPU, one torch thread:

- the deterministic chaos smoke (inline `start=False` stepping, a fixed
  seed, small Titanic games): every accepted job terminal, none stuck,
  sheds classified, every completed table bit-equal to a solo run of the
  port's engine; the same seed gives the same outcomes twice;
- against the JAX harness (scripts/load_gen.py): under
  `chaos@rate0.05:seed7` and under a breached shed SLO, the same games
  and submissions give the same outcome classes, faults and backoffs;
- the CLI, `python3 -m mplc_tpu_torch.load_gen`, on the CPU: a load run
  with `--fleet`, and `--router`: two shard processes, one SIGKILLed by
  the plan, the router invariant with at least one failover; a shard
  process with neither a card nor `--device cpu` exits non-zero.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from mplc_tpu.obs import metrics as jmetrics
from mplc_tpu_torch import load_gen
from mplc_tpu_torch.obs import metrics
from torch_service_helpers import clean_env, scenario

REPO = Path(__file__).resolve().parents[1]


def _jax_load_gen():
    spec = importlib.util.spec_from_file_location("jax_load_gen",
                                                  REPO / "scripts" / "load_gen.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    clean_env(monkeypatch, tmp_path)
    metrics.reset()
    jmetrics.reset()
    yield
    metrics.reset()
    jmetrics.reset()


def _small_builder(partners, seed, epochs=1, dataset="titanic", device=None):
    """Small 2-epoch Titanic games of equal shares (tests/test_load_harness.py's)."""
    def build():
        return scenario(seed, partners=partners, amounts=[1.0 / partners] * partners,
                        gradient_updates_per_pass_count=2)
    return build


def test_chaos_smoke_invariant_holds_under_chaos_and_overload():
    report = load_gen.run_load(
        jobs=20, partner_shapes=(2, 3), game_seeds=(0, 1), tiers=(0, 1), threaded=False,
        max_pending=5, slice_coalitions=3, chaos_plan="chaos@rate0.3:seed7", timeout_sec=300,
        scenario_builder=_small_builder, device="cpu")
    inv = report["invariant"]
    assert inv["holds"], inv
    assert inv["accepted"] == 20 and inv["terminal"] == 20 and inv["stuck"] == 0
    assert inv["values_bit_identical_to_solo"] is True
    assert report["outcomes"].get("completed", 0) > 0
    assert report["service_report"]["resilience"]["faults_injected"] > 0
    assert report["saturation"]["overload_backoffs"] > 0
    for tier in ("0", "1"):
        row = report["per_tier"][tier]
        assert row["jobs"] > 0
        assert row["queue_wait_s"]["p50"] is not None
        assert row["e2e_s"]["p99"] is not None
    assert report["service_report"]["service"]["completed"] == report["outcomes"]["completed"]
    assert report["params"]["device"] == "cpu"


def test_chaos_smoke_is_deterministic_in_outcomes():
    kw = dict(jobs=12, partner_shapes=(2,), game_seeds=(0,), tiers=(0,), threaded=False,
              max_pending=12, slice_coalitions=4, chaos_plan="chaos@rate0.4:seed11",
              timeout_sec=300, scenario_builder=_small_builder, device="cpu")
    r1 = load_gen.run_load(**kw)
    metrics.reset()
    r2 = load_gen.run_load(**kw)
    assert r1["outcomes"] == r2["outcomes"]
    assert (r1["service_report"]["resilience"]["faults_injected"]
            == r2["service_report"]["resilience"]["faults_injected"])
    assert r1["invariant"]["holds"] and r2["invariant"]["holds"]


def test_load_with_shedding_classifies_and_accounts():
    report = load_gen.run_load(
        jobs=10, partner_shapes=(2,), game_seeds=(0,), tiers=(0, 1), threaded=False,
        max_pending=10, slice_coalitions=3, shed_p99_sec=1e-9, timeout_sec=300,
        scenario_builder=_small_builder, device="cpu")
    inv = report["invariant"]
    assert inv["holds"], inv
    assert report["outcomes"].get("shed", 0) > 0
    assert inv["sheds_classified"] is True
    assert report["service_report"]["service"]["shed"] == report["outcomes"]["shed"]
    assert report["admission"]["shed_total"] == report["outcomes"]["shed"]
    assert report["per_tier"]["0"]["shed"] > 0
    assert report["per_tier"]["0"]["shed"] >= report["per_tier"]["1"]["shed"]


@pytest.mark.slow
def test_soak_threaded_worker_pool_under_chaos():
    jobs = int(os.environ.get("SOAK_JOBS", "1200"))
    report = load_gen.run_load(
        jobs=jobs, partner_shapes=(2, 3), game_seeds=(0, 1, 2), tiers=(0, 1, 2),
        threaded=True, workers=2, max_pending=8, slice_coalitions=3,
        chaos_plan="chaos@rate0.15:seed3", timeout_sec=900,
        scenario_builder=_small_builder, device="cpu")
    inv = report["invariant"]
    assert inv["holds"], inv
    assert inv["accepted"] == jobs and inv["stuck"] == 0
    assert report["outcomes"].get("completed", 0) > 0
    assert report["saturation"]["completed_jobs_per_s"] > 0
    for tier in ("0", "1", "2"):
        assert report["per_tier"][tier]["completed"] > 0


def test_threaded_two_workers_hold_the_invariant_under_chaos():
    """The harness as the card runs it (threaded, two workers, chaos), at a
    CPU-sized job count: the invariant holds with real thread interleaving."""
    report = load_gen.run_load(
        jobs=12, partner_shapes=(2, 3), game_seeds=(0, 1, 2), tiers=(0, 1, 2),
        threaded=True, workers=2, chaos_plan="chaos@rate0.3:seed7", timeout_sec=300,
        scenario_builder=_small_builder, device="cpu")
    assert report["invariant"]["holds"], report["invariant"]
    assert report["params"]["workers"] == 2
    assert sum(report["outcomes"].values()) == 12


# -- against the JAX harness --------------------------------------------------------

def _summary(report: dict) -> dict:
    return {"outcomes": report["outcomes"],
            "accepted": report["saturation"]["accepted"],
            "overload_backoffs": report["saturation"]["overload_backoffs"],
            "rejected": report["saturation"]["rejected_by_fault_plan"],
            "faults_injected": report["service_report"]["resilience"]["faults_injected"],
            "holds": report["invariant"]["holds"],
            "per_tier": {t: (r["jobs"], r["completed"], r["shed"])
                         for t, r in report["per_tier"].items()}}


CROSS = {"chaos": dict(chaos_plan="chaos@rate0.05:seed7"),
         "shed": dict(shed_p99_sec=1e-9, tiers=(0, 1))}


@pytest.mark.parametrize("case", sorted(CROSS))
def test_outcomes_equal_the_jax_harness(monkeypatch, case):
    """The default builders of both harnesses (Titanic at 1 epoch, shares
    (i+1)/sum), inline, the same submissions: the same outcome classes."""
    import jax
    # the port's batches hold the coalitions of the JAX engine's on the
    # tests' 8-device mesh, so a chaos draw's batch ordinal names the same work
    monkeypatch.setenv("MPLC_TORCH_COALITIONS_PER_DEVICE", str(len(jax.devices())))
    kw = dict(jobs=24, partner_shapes=(2, 3), game_seeds=(0, 1, 2), tiers=(0, 1, 2),
              threaded=False, max_pending=6, slice_coalitions=3, timeout_sec=300)
    kw.update(CROSS[case])
    theirs = _jax_load_gen().run_load(**kw)
    ours = load_gen.run_load(device="cpu", **kw)
    assert _summary(ours) == _summary(theirs)
    assert ours["invariant"]["holds"]
    if case == "chaos":
        assert ours["service_report"]["resilience"]["faults_injected"] > 0
    else:
        assert ours["outcomes"].get("shed", 0) > 0


# -- the CLI -------------------------------------------------------------------------

def _cli(*args, env=None, timeout=240):
    return subprocess.run([sys.executable, "-m", "mplc_tpu_torch.load_gen", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=timeout,
                          env={**os.environ, **(env or {})})


def test_cli_load_run_with_fleet_on_the_cpu(tmp_path):
    out = tmp_path / "load.json"
    state = tmp_path / "state"
    run = _cli("--jobs", "4", "--slice", "3", "--device", "cpu", "--threads", "1",
               "--fleet", "--out", str(out),
               env={"MPLC_TORCH_FLEET_STATE_DIR": str(state),
                    "MPLC_TORCH_FLEET_SHARD_ID": "solo"})
    assert run.returncode == 0, run.stderr[-2000:]
    assert "invariant holds: True" in run.stderr
    report = json.loads(out.read_text())
    assert report["invariant"]["accepted"] == 4 and report["params"]["device"] == "cpu"
    # the service published its state there, so the fleet block sees it
    assert report["fleet"]["shard_count"] == 1 and report["fleet"]["merged_sources"] == 1


def test_cli_router_mode_survives_a_sigkilled_shard(tmp_path):
    """Two shard processes on the CPU (one torch thread each), shard 0
    SIGKILLed one second into the run or, if it then holds no work in
    progress, as soon as it does: every job terminal, every completed
    table bit-equal to the harness's solo run, at least one job failed
    over, carrying values from shard 0's WAL."""
    out = tmp_path / "router.json"
    run = _cli("--router", "--jobs", "6", "--router-shards", "2", "--device", "cpu",
               "--threads", "1", "--fault-plan", "shardkill@shard0:sec1", "--out", str(out))
    assert run.returncode == 0, run.stderr[-3000:]
    report = json.loads(out.read_text())
    inv = report["invariant"]
    assert inv["holds"] and inv["failovers"] >= 1 and inv["stuck"] == 0, inv
    assert inv["jobs_failed_over"] >= 1 and inv["values_recovered_from_wal"] >= 1, inv
    assert inv["kills_fired_sec"][0] >= 1.0
    assert inv["values_bit_identical_to_solo"] and inv["completed_games_checked"] > 0
    assert report["exit_codes"]["s0"] == -9        # the SIGKILL
    assert report["routing_table"]["s0"]["dead"]


def test_shard_process_without_a_card_exits_nonzero(tmp_path):
    """No card and no `--device cpu`: the shard process refuses to run on
    the CPU in its place."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    run = _cli("--router-shard", "--shard-id", "s0", timeout=120,
               env={"MPLC_TORCH_FLEET_STATE_DIR": str(tmp_path)})
    assert run.returncode != 0
    assert "CUDA" in run.stderr
    assert not list(tmp_path.glob("shard_*.json"))    # it never served


def test_shard_env_names_the_ports_knobs_only(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("MPLC_TPU_SERVICE_SLICE", "3")
    env = load_gen._shard_env(str(tmp_path), "s1", 2.0)
    assert not [k for k in env if k.startswith(("JAX_", "MPLC_TPU_", "XLA_"))]
    assert env["MPLC_TORCH_FLEET_SHARD_ID"] == "s1"
    assert env["MPLC_TORCH_ROUTER_SERVE"] == "1" and env["MPLC_TORCH_METRICS_PORT"] == "0"
    assert env["MPLC_TORCH_FLEET_STALE_SEC"] == "2.0"
