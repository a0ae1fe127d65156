"""The port's fleet sweep (`mplc_tpu_torch/parallel/fleet.py`) against the
JAX package's (`mplc_tpu/parallel/fleet.py`), on the CPU, one torch thread:

- `FleetSpec` JSON read by either package, the legacy `amounts` tolerated;
- `plan_slices` equal to the JAX package's, integer for integer, for W =
  1-4 shards, 3 and 4 partners, on masked batches (the deterministic
  reduce) and on merged slot buckets;
- `pin_fleet_widths` (after tests/test_fleet.py's case): a slice runs at
  the full sweep's width, never narrower, and a cap halving unpins it;
- in-process fleets of 2 and 3 shards, and of 2 with a transient and an
  OOM on one shard, bit-equal to the port's 1-shard run, `verify_against`
  passing; two `--device cpu` worker processes bit-equal too, started
  together or one at a time, with their `.done` markers; a worker without a card and without `--device cpu`
  fails (no fallback to the CPU);
- the port's 1-shard values within one test sample (1/n_test + 1e-6) of
  the JAX package's `run_fleet(FleetSpec(), 1, inproc=True)` and exact
  Shapley within 1e-3 (tests/test_torch_sweep.py's tolerances), the port
  fed the JAX engine's initial params and permutations;
- the merge's refusals (a missing marker, an overlap, a fingerprint
  mismatch, `verify_against` with no ledger);
- `_rebuild_increments` and `write_cache_doc` byte for byte the JAX
  functions', the merged cache loadable by the port's engine;
- `devices_per_shard` other than None or a positive whole number raising,
  and the worker environment holding the port's knobs only.

The two packages cut the same slices and write the same files; their
`programs_planned`, `widths` and `manifest_hits` differ by route (the JAX
engine's deterministic fedavg runs on its 2-D pipeline, which has no 1-D
plan), so no test compares those.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
from mplc_tpu.contrib.shapley import shapley_from_characteristic as jshapley
from mplc_tpu.parallel import fleet as jfleet
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order, shapley_from_characteristic
from mplc_tpu_torch.convert import params_from_numpy
from mplc_tpu_torch.parallel import fleet
from test_torch_sweep import _jax_single_perms, _stacked_np

torch.set_num_threads(1)

SPEC = fleet.FleetSpec()          # Titanic, 3 partners, 2 epochs, deterministic
FAULTS = "transient@batch1,oom@batch2"
KNOBS = ("DETERMINISTIC_REDUCE", "NUMERICS_LEDGER", "FAULT_PLAN", "NO_SLOTS", "SLOT_MERGE",
         "SLOT_POW2", "COALITIONS_PER_DEVICE", "PROGRAM_BANK", "COMPILE_CACHE_DIR",
         "TRACE_FILE", "FLEET_RUN_ID", "FLEET_SHARD_ID", "FLEET_STATE_DIR",
         "PARTNER_FAULT_PLAN", "SEED_ENSEMBLE", "PRECISION")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        for knob in KNOBS:
            monkeypatch.delenv(pkg + knob, raising=False)
        monkeypatch.setenv(pkg + "RETRY_BACKOFF_SEC", "0")
    monkeypatch.setenv("MPLC_TORCH_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))


def _clear_knobs():
    """Both packages' knobs of the module fixtures unset (a module-scoped
    fixture runs outside a test's monkeypatch)."""
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        for knob in KNOBS:
            os.environ.pop(pkg + knob, None)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The port's 1-shard reference, in process on the CPU."""
    _clear_knobs()
    return fleet.run_fleet(SPEC, 1, str(tmp_path_factory.mktemp("ref")), inproc=True,
                           device="cpu")


def _engines(partners: int, deterministic: bool):
    """(JAX engine, port engine) of the spec's game at `partners`."""
    spec = dataclasses.replace(SPEC, partners=partners, deterministic=deterministic)
    jspec = jfleet.FleetSpec(**dataclasses.asdict(spec))
    flag = "1" if deterministic else None
    with fleet._env_overlay({"MPLC_TPU_DETERMINISTIC_REDUCE": flag,
                             "MPLC_TORCH_DETERMINISTIC_REDUCE": flag}):
        return JEngine(jspec.build_scenario()), CharacteristicEngine(spec.build_scenario("cpu"))


_ENGINES: dict = {}


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("partners", [3, 4])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_plan_slices_equal_jax(partners, deterministic, shards):
    key = (partners, deterministic)
    if key not in _ENGINES:
        _ENGINES[key] = _engines(partners, deterministic)
    jeng, eng = _ENGINES[key]
    assert eng._use_slots == jeng._use_slots == (not deterministic)
    subsets = powerset_order(partners)
    got = fleet.plan_slices(eng, subsets, shards)
    want = jfleet.plan_slices(jeng, subsets, shards)
    assert got == want
    assert all(type(i) is int for sl in got for s in sl for i in s)
    flat = [s for sl in got for s in sl]
    assert len(got) == shards and sorted(flat) == sorted(subsets)


def test_spec_json_reads_both_ways():
    spec = fleet.FleetSpec(dataset="mnist", partners=5, epochs=2, subsets=[[0, 1], [2]],
                           deterministic=False)
    assert jfleet.FleetSpec.from_json(spec.to_json()) == jfleet.FleetSpec(
        **dataclasses.asdict(spec))
    jspec = jfleet.FleetSpec(partners=4, seed=3)
    assert fleet.FleetSpec.from_json(jspec.to_json()) == fleet.FleetSpec(partners=4, seed=3)
    legacy = json.loads(jspec.to_json())
    legacy["amounts"] = [0.25] * 4
    assert fleet.FleetSpec.from_json(json.dumps(legacy)) == fleet.FleetSpec(partners=4, seed=3)
    assert spec.all_subsets() == [(0, 1), (2,)]
    assert SPEC.all_subsets() == jfleet.FleetSpec().all_subsets() == powerset_order(3)


def test_pin_fleet_widths_keeps_slice_widths_at_full_sweep_plan():
    """A slice smaller than its bucket runs at the full sweep's width; a
    wider request keeps its own width (the pin never shrinks); a cap
    halving unpins (a degraded cap re-buckets at the degraded width)."""
    eng = CharacteristicEngine(dataclasses.replace(SPEC, partners=4, deterministic=False)
                               .build_scenario("cpu"))
    subsets = powerset_order(4)
    pipe = eng._slot_pipe(3)       # merge mode: sizes 2 and 3 ride width 3
    small = eng._planned_width(3, 3, pipe)
    pinned = eng.pin_fleet_widths(subsets)
    # singles 4 jobs; sizes 2 and 3 at 3 slots, 10 jobs; the 4-partner one alone
    assert pinned == {None: 4, 3: 16, 4: 1}
    full = eng._planned_width(3, 3, pipe)
    # the full sweep's C(4,2) + C(4,3) = 10 width-3 jobs bucket at 16
    assert full == pinned[3] == 16 > small == 4
    # the singles' pin (4 jobs: width 4) never narrows a wider request
    assert eng._planned_width(8, None, eng.single_pipe) == 8
    assert eng._planned_width(1, None, eng.single_pipe) == pinned[None] == 4
    # another pipe of the same slot count is not pinned
    assert eng._planned_width(3, None, eng.multi_pipe) == 4
    eng._cap_halvings = 1
    assert eng._planned_width(3, 3, pipe) == small < full
    eng._cap_halvings = 0
    assert eng._planned_width(3, 3, pipe) == full


@pytest.mark.parametrize("case", ["w2", "w3", "w2_faults"])
def test_fleet_merge_bit_identical_to_single_shard(ref, tmp_path, case):
    shards = 3 if case == "w3" else 2
    per_shard = ({1: {"MPLC_TORCH_FAULT_PLAN": FAULTS}} if case == "w2_faults" else None)
    res = fleet.run_fleet(SPEC, shards, str(tmp_path / case), inproc=True, device="cpu",
                          per_shard_env=per_shard, verify_against=ref.ledger)
    assert res.values == ref.values
    d = res.diff
    assert d["comparable"] and not d["drift"]
    assert d["ulp"]["max"] == 0 and d["kendall_tau"] == 1.0 and d["common"] == 7
    assert len(res.shard_reports) == shards
    if case == "w2_faults":
        c0, c1 = (r["metrics"]["counters"] for r in res.shard_reports)
        assert c1.get("engine.retries", 0) - c0.get("engine.retries", 0) == 1
        assert c1.get("engine.cap_halvings", 0) - c0.get("engine.cap_halvings", 0) == 1


def _jax_streams(monkeypatch, jeng, jdataset, E: int) -> None:
    """The port's engines draw the JAX engine's per-coalition initial
    params and permutations (tests/test_torch_api.py's `batch_start`)."""
    def batch_start(self, subsets, single, replicas=None):
        rngs = [jeng._coalition_rng(s) for s in subsets]
        init = params_from_numpy(_stacked_np([jdataset.model.init(r) for r in rngs]))
        jtr = jeng.multi_pipe.trainer
        perms = torch.from_numpy(np.stack([
            _jax_single_perms(r, jeng.stacked.mask[s[0]], E) if single
            else np.asarray(jtr.gen_epoch_streams(r, jeng.stacked.mask, 0, E)[0])
            for s, r in zip(subsets, rngs)]))
        return [self.coalition_generator(s) for s in subsets], init, perms

    monkeypatch.setattr(CharacteristicEngine, "_batch_start", batch_start)


def test_one_shard_values_match_the_jax_fleet(monkeypatch, tmp_path):
    jres = jfleet.run_fleet(jfleet.FleetSpec(), 1, str(tmp_path / "jax"), inproc=True)
    with fleet._env_overlay({"MPLC_TPU_DETERMINISTIC_REDUCE": "1"}):
        jsc = jfleet.FleetSpec().build_scenario()
        jeng = JEngine(jsc)
    _jax_streams(monkeypatch, jeng, jsc.dataset, SPEC.epochs)
    res = fleet.run_fleet(SPEC, 1, str(tmp_path / "port"), inproc=True, device="cpu")
    subsets = SPEC.all_subsets()
    n_test = len(jsc.dataset.x_test)
    v = np.array([res.values[s] for s in subsets])
    jv = np.array([jres.values[s] for s in subsets])
    np.testing.assert_allclose(v, jv, rtol=0, atol=1.0 / n_test + 1e-6)
    np.testing.assert_allclose(shapley_from_characteristic(3, {(): 0.0, **res.values}),
                               jshapley(3, {(): 0.0, **jres.values}), rtol=0, atol=1e-3)
    # the same files and keys (the port's result adds its device, the cards
    # its worker was given and the card's name)
    for name in ("result_shard0.json", "ledger_shard0.json", "cache_shard0.json",
                 "ledger_merged.json", "cache_merged.json", "fleet_trace_manifest.json"):
        assert (tmp_path / "port" / name).exists() and (tmp_path / "jax" / name).exists()
    rep = json.loads((tmp_path / "port" / "result_shard0.json").read_text())
    jrep = json.loads((tmp_path / "jax" / "result_shard0.json").read_text())
    assert set(rep) - set(jrep) == {"device", "visible_devices", "card"}
    assert set(jrep) <= set(rep)
    assert set(rep["counters"]) == set(jrep["counters"])
    assert rep["devices"] == 1 and rep["device"] == "cpu" and rep["card"] == "cpu"
    assert set(res.ledger) == set(jres.ledger) and len(res.ledger["entries"]) == 7


def test_merge_refuses_partial_overlap_and_missing_result(tmp_path):
    out = tmp_path / "partial"
    fleet.run_shard(SPEC, 0, 2, str(out), device="cpu")
    with pytest.raises(fleet.FleetMergeError, match=r"shards \[1\]"):
        fleet.merge_shard_results(SPEC, 2, str(out))
    values, merged, reports = fleet.merge_shard_results(SPEC, 2, str(out), force=True)
    assert 0 < len(values) < 7 and merged is not None and len(reports) == 1
    # a stale marker without a result file
    (out / ".shard1.done").write_text("1")
    with pytest.raises(fleet.FleetMergeError, match="no result file"):
        fleet.merge_shard_results(SPEC, 2, str(out))
    # shard 0's result copied as shard 1's: an overlap
    (out / "result_shard1.json").write_text((out / "result_shard0.json").read_text())
    with pytest.raises(fleet.FleetMergeError, match="more than one shard"):
        fleet.merge_shard_results(SPEC, 2, str(out))


def test_merge_ledgers_refuses_fingerprint_mismatch_and_overlap():
    def doc(fp, key):
        return {"schema": 1, "engine_fingerprint": fp, "meta": {},
                "entries": {key: {"value_bits": "00" * 8}}}
    with pytest.raises(fleet.FleetMergeError, match="different games"):
        fleet.merge_ledgers([doc("aaaa", "0x3"), doc("bbbb", "0x5")])
    with pytest.raises(fleet.FleetMergeError, match="more than one shard"):
        fleet.merge_ledgers([doc("aaaa", "0x3"), doc("aaaa", "0x3")])
    with pytest.raises(fleet.FleetMergeError, match="no shard ledgers"):
        fleet.merge_ledgers([])
    docs = [doc("aaaa", "0x3"), doc("aaaa", "0x5")]
    assert fleet.merge_ledgers(docs) == jfleet.merge_ledgers(docs)
    assert fleet.merge_ledgers(docs)["meta"] == {"fleet_shards": 2, "merged": True}


def test_verify_against_without_a_ledger_refuses(ref, tmp_path):
    with pytest.raises(fleet.FleetMergeError, match="nothing was verified"):
        fleet.run_fleet(SPEC, 2, str(tmp_path / "nol"), inproc=True, device="cpu",
                        ledger=False, verify_against=ref.ledger)
    incidents = [p for p in os.listdir(tmp_path / "nol") if p.startswith("incident_")]
    assert len(incidents) == 1
    bundle = json.loads((tmp_path / "nol" / incidents[0] / "incident.json").read_text())
    assert bundle["reason"] == "merge_refused" and bundle["failed_shards"] == [0, 1]


def test_cache_doc_and_increments_equal_jax(ref, tmp_path):
    fp = ref.shard_reports[0]["fingerprint"]
    values = dict(ref.values)
    inc = fleet._rebuild_increments(values, 3)
    assert inc == jfleet._rebuild_increments(values, 3)
    assert inc[0][(1, 2)] == values[(0, 1, 2)] - values[(1, 2)]
    fleet.write_cache_doc(str(tmp_path / "port.json"), fp, values, 3)
    jfleet.write_cache_doc(str(tmp_path / "jax.json"), fp, values, 3)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    # the merged cache on a fresh port engine: every v(S), none trained
    with fleet._env_overlay({"MPLC_TORCH_DETERMINISTIC_REDUCE": "1"}):
        eng = CharacteristicEngine(SPEC.build_scenario("cpu"))
    eng.load_cache(os.path.join(ref.out_dir, "cache_merged.json"))
    got = eng.evaluate(SPEC.all_subsets())
    assert not eng.batch_log and eng.first_charac_fct_calls_count == 7
    want = np.array([ref.values[s] for s in SPEC.all_subsets()])
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("concurrent", [True, False])
def test_worker_processes_bit_equal_to_in_process(ref, tmp_path, concurrent):
    out = tmp_path / "sub"
    res = fleet.run_fleet(SPEC, 2, str(out), device="cpu", threads=1, timeout=300,
                          concurrent=concurrent, verify_against=ref.ledger)
    assert res.values == ref.values and not res.diff["drift"]
    for i in range(2):
        assert (out / f".shard{i}.done").exists()
        rep = json.loads((out / f"result_shard{i}.json").read_text())
        assert rep["device"] == "cpu" and rep["devices"] == 1 and rep["deterministic"]
        assert rep["fleet"]["shard_id"] == f"shard{i}"
        assert rep["fleet"]["run_id"].startswith("fleet-")
        assert rep["clock"]["worker_end_ts"] >= rep["clock"]["worker_start_ts"]
    assert (out / "ledger_merged.json").exists() and (out / "cache_merged.json").exists()


def test_worker_without_a_card_fails_without_falling_back(tmp_path):
    """A worker told nothing about the device runs on the card: with no
    card it exits non-zero, and the fleet fails; it never runs on the
    CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(fleet.FleetError, match="rc="):
        fleet.run_worker_subprocess(SPEC, 0, 1, str(tmp_path / "nocard"), threads=1,
                                    timeout=300)
    log = (tmp_path / "nocard" / "worker_shard0.log").read_text()
    assert "no CUDA device" in log
    assert not (tmp_path / "nocard" / ".shard0.done").exists()


def test_devices_per_shard_other_than_one_raises(tmp_path):
    """A shard runs on a whole number of devices, at least 1: 0, negative,
    fractional, boolean and string counts stay refused everywhere, before
    any folder or worker; several devices a shard need worker processes
    (tests/test_torch_fleet_world.py runs them)."""
    for bad in (0, -1, 1.5, True, "2"):
        with pytest.raises(ValueError, match="at least 1"):
            fleet.run_fleet(SPEC, 2, str(tmp_path / "x"), devices_per_shard=bad)
        with pytest.raises(ValueError, match="at least 1"):
            fleet.worker_env(devices=bad)
        with pytest.raises(ValueError, match="at least 1"):
            fleet.run_worker_subprocess(SPEC, 0, 1, str(tmp_path / "y"), devices=bad)
        with pytest.raises(ValueError, match="at least 1"):
            fleet._shard_devices(0, 1, bad, ["0"])
    for n in (2, 8):
        with pytest.raises(ValueError, match="one process holds one device"):
            fleet.run_fleet(SPEC, 2, str(tmp_path / "x"), devices_per_shard=n, inproc=True,
                            device="cpu")
    assert not (tmp_path / "x").exists() and not (tmp_path / "y").exists()
    assert fleet.worker_env(devices=1, base={}, device="cpu") == {
        "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    assert fleet.worker_env(devices=1, base={}, cards=1) == {
        "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "CUDA_VISIBLE_DEVICES": "0"}


def test_worker_env_passes_the_ports_knobs_only():
    base = {"PATH": "/bin", "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--x",
            "MPLC_TPU_FAULT_PLAN": "crash@batch1", "MPLC_TORCH_FAULT_PLAN": "oom@batch2",
            "MPLC_TORCH_TRACE_FILE": "/tmp/t.jsonl", "MPLC_TORCH_METRICS_PORT": "9000",
            "MPLC_TORCH_CHROME_TRACE_FILE": "/tmp/t.json",
            "MPLC_TORCH_PROFILE_DIR": "/tmp/p", "MPLC_TORCH_NUMERICS_LEDGER": "/tmp/l.json",
            "MPLC_TORCH_SYNTH_SCALE": "0.1"}
    env = fleet.worker_env(base, threads=1, extra={"MPLC_TORCH_SYNTH_SCALE": None,
                                                   "MPLC_TORCH_FLEET_SHARD_ID": "shard0"})
    assert env == {"PATH": "/bin", "MPLC_TORCH_FAULT_PLAN": "oom@batch2",
                   "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "OMP_NUM_THREADS": "1",
                   "MPLC_TORCH_FLEET_SHARD_ID": "shard0"}
    argv = fleet.worker_argv("/s.json", 1, 2, "/out", ledger=False, device="cpu", threads=1)
    assert argv[1:] == ["-m", "mplc_tpu_torch.parallel.fleet", "--worker", "/s.json",
                        "--shard", "1/2", "--out", "/out", "--no-ledger", "--device", "cpu",
                        "--threads", "1"]
