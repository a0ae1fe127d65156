"""Fleet shards that span several devices (`devices_per_shard` N > 1 in
`mplc_tpu_torch/parallel/fleet.py`), on the CPU: each shard's worker runs
its slice as a world of N gloo ranks (`parallel/launch.py` `spawn`), one
torch thread a rank, on the Titanic spec (3 partners, 2 epochs, the
deterministic reduce):

- 2 shards x 2 ranks merge bit-equal to 1 shard x 1 device (zero ulp,
  tau-b 1.0, every subset, `verify_against`), the ledger's meta naming 2
  devices, every shard reporting 2; only rank 0's files are in the fleet
  folder (the listing is the 1-device fleet's, one `fleet.shard_run` span
  a shard trace), and each worker log names both ranks' devices;
- `worker_env` gives each shard its own CUDA_VISIBLE_DEVICES block out of
  the coordinator's (an inherited value replaced), wraps the shards onto
  the cards at N = 1, leaves the variable alone on the CPU or without N,
  and raises when W*N exceeds the cards; `run_fleet` on the card raises
  so before it makes its folder, and with `inproc` at N > 1;
- a rank that raises inside a shard (MPLC_TORCH_FAULT_RANK=1,
  crash@batch1) ends that worker non-zero: `run_fleet` raises FleetError
  naming the shard, with one incident bundle, in well under the group's
  timeout; `spawn` kills the peers of a failed rank after
  `PEER_GRACE_SEC`;
- the selfcheck CLI at `--devices-per-shard 2 --device cpu` exits 0 with
  one worker line a rank.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from mplc_tpu_torch import constants
from mplc_tpu_torch.parallel import fleet, launch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC = fleet.FleetSpec()          # Titanic, 3 partners, 2 epochs, deterministic
KNOBS = ("DETERMINISTIC_REDUCE", "NUMERICS_LEDGER", "FAULT_PLAN", "FAULT_RANK", "NO_SLOTS",
         "SLOT_MERGE", "SLOT_POW2", "COALITIONS_PER_DEVICE", "PROGRAM_BANK",
         "COMPILE_CACHE_DIR", "TRACE_FILE", "FLEET_RUN_ID", "FLEET_SHARD_ID",
         "FLEET_STATE_DIR", "PARTNER_FAULT_PLAN", "SEED_ENSEMBLE", "PRECISION",
         "PARTNER_SHARDS")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for knob in KNOBS:
        monkeypatch.delenv("MPLC_TORCH_" + knob, raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("MPLC_TORCH_RETRY_BACKOFF_SEC", "0")
    monkeypatch.setenv("MPLC_TORCH_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """1 shard x 1 device, in process."""
    for knob in KNOBS:
        os.environ.pop("MPLC_TORCH_" + knob, None)
    return fleet.run_fleet(SPEC, 1, str(tmp_path_factory.mktemp("ref")), inproc=True,
                           device="cpu")


def test_two_shards_of_two_ranks_merge_bit_equal_to_one(ref, tmp_path):
    out = tmp_path / "w2x2"
    got = fleet.run_fleet(SPEC, 2, str(out), devices_per_shard=2, device="cpu", threads=1,
                          verify_against=ref.ledger, timeout=300)
    d = got.diff
    assert d["comparable"] and not d["drift"] and d["ulp"]["max"] == 0
    assert d["kendall_tau"] == 1.0 and d["common"] == len(SPEC.all_subsets()) == 7
    assert got.values == ref.values
    assert got.ledger["meta"]["n_devices"] == 2 and got.ledger["meta"]["topology"] == "1d"
    assert ref.ledger["meta"]["n_devices"] == 1
    assert [r["devices"] for r in got.shard_reports] == [2, 2]
    assert all(r["device"] == "cpu" and r["visible_devices"] is None
               for r in got.shard_reports)
    # only rank 0 wrote: the 1-device fleet's listing, one track a shard
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(
        ["fleet_spec.json", "fleet_trace_manifest.json", "trace_coordinator.jsonl",
         "ledger_merged.json", "cache_merged.json"]
        + [f"{k}_shard{i}.{e}" for i in (0, 1) for k, e in
           (("result", "json"), ("cache", "json"), ("ledger", "json"),
            ("trace", "jsonl"), ("worker", "log"))]
        + [".shard0.done", ".shard1.done"])
    for i in (0, 1):
        recs = [json.loads(ln) for ln in (out / f"trace_shard{i}.jsonl").read_text()
                .splitlines()]
        assert sum(r["name"] == "fleet.shard_run" for r in recs) == 1
        assert {r.get("fleet_shard") for r in recs} == {f"shard{i}"}
        lines = [ln for ln in (out / f"worker_shard{i}.log").read_text().splitlines()
                 if ln.startswith("[fleet worker]")]
        assert sorted(ln.split(":")[0] for ln in lines) == [
            f"[fleet worker] shard {i}/2 rank {r}/2" for r in (0, 1)]


def test_worker_env_gives_each_shard_its_own_cards():
    base = {"CUDA_VISIBLE_DEVICES": "3,1,2,0"}
    blocks = [fleet.worker_env(base, devices=2, shard=i, shards=2, cards=4)
              ["CUDA_VISIBLE_DEVICES"] for i in (0, 1)]
    assert blocks == ["3,1", "2,0"]
    assert fleet.worker_env({}, devices=2, shard=1, shards=2, cards=4) == {
        "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "CUDA_VISIBLE_DEVICES": "2,3"}
    # N = 1 wraps the shards onto the cards there are
    assert [fleet.worker_env({}, devices=1, shard=i, shards=3, cards=2)
            ["CUDA_VISIBLE_DEVICES"] for i in range(3)] == ["0", "1", "0"]
    assert fleet._shard_devices(3, 4, 1, ["7"]) == ["7"]
    # no N, or the CPU: the inherited value stays
    assert fleet.worker_env(base)["CUDA_VISIBLE_DEVICES"] == "3,1,2,0"
    assert fleet.worker_env(base, devices=2, shard=1, shards=2, cards=4,
                            device="cpu")["CUDA_VISIBLE_DEVICES"] == "3,1,2,0"
    # no card visible at N = 1: left as it is (the worker fails, no fallback)
    assert "CUDA_VISIBLE_DEVICES" not in fleet.worker_env({}, devices=1, cards=0)
    for shards, n, cards in ((3, 2, 4), (2, 4, 4), (1, 2, 1), (1, 2, 0)):
        with pytest.raises(ValueError, match="a card a rank"):
            fleet.worker_env({}, devices=n, shard=0, shards=shards, cards=cards)
        with pytest.raises(ValueError, match="a card a rank"):
            fleet._shard_devices(0, shards, n, [str(i) for i in range(cards)])


def test_run_fleet_refuses_what_the_cards_cannot_hold(tmp_path):
    # on the card, more cards than the host has (none here): before any folder
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="a card a rank"):
            fleet.run_fleet(SPEC, 2, str(tmp_path / "x"), devices_per_shard=2)
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="a card a rank"):
        fleet.run_fleet(SPEC, cards + 1, str(tmp_path / "x"), devices_per_shard=2,
                        env={"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(cards)))})
    with pytest.raises(ValueError, match="one process holds one device"):
        fleet.run_fleet(SPEC, 1, str(tmp_path / "x"), devices_per_shard=2, inproc=True,
                        device="cpu")
    assert not (tmp_path / "x").exists()


def test_a_failing_rank_ends_its_worker_and_fails_the_fleet(tmp_path):
    out = tmp_path / "failed"
    t0 = time.monotonic()
    with pytest.raises(fleet.FleetError, match="shard 1") as err:
        fleet.run_fleet(SPEC, 2, str(out), devices_per_shard=2, device="cpu", threads=1,
                        timeout=300,
                        per_shard_env={1: {constants.FAULT_PLAN_ENV: "crash@batch1",
                                           constants.FAULT_RANK_ENV: "1"}})
    assert time.monotonic() - t0 < 120
    assert err.value.failed_shards == [1]
    log = (out / "worker_shard1.log").read_text()
    assert "InjectedCrash" in log and "PeerFailure" in log
    assert not (out / ".shard1.done").exists() and (out / ".shard0.done").exists()
    incidents = [p for p in out.iterdir() if p.name.startswith("incident_")]
    assert len(incidents) == 1
    bundle = json.loads((incidents[0] / "incident.json").read_text())
    assert bundle["reason"] == "shard_failure" and bundle["failed_shards"] == [1]
    assert "fleet_worker_crash" in " ".join(bundle["shard_artifacts"]["1"]["flight_dumps"])


def test_spawn_kills_the_peers_of_a_failed_rank():
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailed) as err:
        launch.spawn("torch_dist_helpers:fail_on_rank", 2, (1, 120.0), timeout=90)
    assert time.monotonic() - t0 < launch.PEER_GRACE_SEC + 40
    assert "rank 1 fails" in err.value.errors[1]
    assert err.value.errors[0] == f"killed {launch.PEER_GRACE_SEC:g} s after rank 1 failed"


def test_selfcheck_cli_with_two_ranks_a_shard(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "MPLC_"))}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "mplc_tpu_torch.parallel.fleet", "--selfcheck", "--shards",
         "2", "--devices-per-shard", "2", "--device", "cpu", "--threads", "1",
         "--timeout", "300"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    doc = json.loads(lines[-1])
    assert doc["ok"] is True and doc["max_ulp"] == 0 and doc["kendall_tau"] == 1.0
    assert doc["devices_per_shard"] == 2
    assert [c["devices"] for c in doc["shard_cards"]] == [2, 2]
    assert sum(ln.startswith("[fleet worker] shard") for ln in lines) == 4
