"""The numerics plane on the CPU, one torch thread (`mplc_tpu_torch/obs/
numerics.py` against `mplc_tpu/obs/numerics.py`):

- the value ledger's round trip, in the JAX schema: a port ledger loads
  with the JAX `ValueLedger.load`, and both packages' `diff_ledgers` give
  the same diff of the same two ledgers;
- a port engine's ledger of the 3-partner Titanic game (the port fed the
  JAX engine's initial params and permutations) against the JAX engine's
  ledger of the same game, read and diffed by the JAX `diff_ledgers`: the
  same masks (the 7 coalitions; neither engine ledgers the null
  coalition, which no batch harvests), every v(S) within one test sample
  (the sweep tests' tolerance, tests/test_torch_sweep.py) and Kendall tau-b
  1.0. The two fingerprints differ: the port's names its own random
  streams (`rng_streams`, torch's SeedSequence draws, where the JAX
  package draws threefry streams) and keys the JAX package lacks, so the
  ledgers are flagged not comparable, as the JAX diff does for any two
  games;
- `_linear_fold`, `_grouped_fold`, `_device_partials`, `ulp_distance_f32`,
  `kendall_tau_b` and `bits_to_float` bit-equal to the JAX package's on
  seeded arrays;
- the audit: v(S) bit-equal with it on or off, under the fault ladder too;
  at most 4 audits an engine, on fenced multi-partner batches only; None
  for the shapes the JAX audit skips; the deterministic reduce's
  `ordered_fold` agrees with the host fold; a divergence of the executed
  reduction is localized, counted, traced and dumped;
- the planner's "meter" basis equal to the JAX package's for the same
  meter snapshot, and the default below 8 evaluated coalitions.
"""

import json

import numpy as np
import pytest
import torch

from mplc_tpu.contrib import planner as jplanner
from mplc_tpu.obs import devcost as jdevcost, numerics as jnum
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib import planner
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.data import datasets
from mplc_tpu_torch.obs import devcost, metrics, numerics, trace
from mplc_tpu_torch.scenario import Scenario
from test_torch_sweep import _engines

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        for k in ("DEVICE_FENCE_RATE", "FAULT_PLAN", "NUMERICS_LEDGER", "NUMERICS_AUDIT",
                  "COALITIONS_PER_DEVICE", "SEED_ENSEMBLE", "DETERMINISTIC_REDUCE",
                  "PARTNER_FAULT_PLAN"):
            monkeypatch.delenv(pkg + k, raising=False)
    monkeypatch.setenv("MPLC_TORCH_RETRY_BACKOFF_SEC", "0")
    monkeypatch.setenv("MPLC_TORCH_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))
    metrics.reset()
    yield
    metrics.reset()


def test_ledger_round_trip_in_the_jax_schema(tmp_path):
    led = numerics.ValueLedger("abc123", meta={"reduction_mode": "default", "n_devices": 1},
                               path=str(tmp_path / "led.json"))
    values = {(0,): 0.5, (1, 2): 1 / 3, (0, 1, 2): 0.1 + 0.2}
    for s, v in values.items():
        led.record(s, v, slot_width=3 if len(s) > 1 else None, cap_halvings=len(s) - 1)
    led.record((1,), 0.25, source="reconstruction", degraded=True)
    assert led.save() == str(tmp_path / "led.json")
    assert metrics.counter("numerics.ledger_records").value == 4
    back = numerics.ValueLedger.load(str(tmp_path / "led.json"))
    jback = jnum.ValueLedger.load(str(tmp_path / "led.json"))
    assert back.to_doc() == jback.to_doc() == json.loads((tmp_path / "led.json").read_text())
    assert back.to_doc()["schema"] == jnum.LEDGER_SCHEMA
    for s, v in values.items():
        e = back.entries[numerics.ValueLedger.subset_key(s)]
        assert numerics.bits_to_float(e["value_bits"]) == v and e["value"] == v
    # a JAX ledger of the same records: the same entries, content hashes too
    jled = jnum.ValueLedger("abc123", meta={"reduction_mode": "default", "n_devices": 1})
    for s, v in values.items():
        jled.record(s, v, slot_width=3 if len(s) > 1 else None, cap_halvings=len(s) - 1)
    jled.record((1,), 0.25, source="reconstruction", degraded=True)
    assert jled.entries == back.entries
    other = numerics.ValueLedger("abc123", meta=led.meta)
    for s, v in values.items():
        other.record(s, np.nextafter(v, 1.0) if len(s) == 2 else v)
    assert numerics.diff_ledgers(back, other) == jnum.diff_ledgers(jback, other.to_doc())
    assert numerics.diff_ledgers(back, other)["drift"] is True
    assert numerics.ValueLedger("x").save() is None
    assert numerics.ValueLedger("x", path=str(tmp_path / "no" / "dir.json")).save() is None


def test_port_ledger_diffed_by_jax_against_the_jax_engine(monkeypatch, tmp_path):
    monkeypatch.setenv("MPLC_TPU_NUMERICS_LEDGER", str(tmp_path / "jax.json"))
    monkeypatch.setenv(constants.NUMERICS_LEDGER_ENV, str(tmp_path / "port.json"))
    jeng, eng, n_test = _engines(monkeypatch, "ii")
    subsets = powerset_order(3)
    jeng.evaluate(subsets)
    eng.evaluate(subsets)
    port = jnum.ValueLedger.load(str(tmp_path / "port.json"))
    jax_led = jnum.ValueLedger.load(str(tmp_path / "jax.json"))
    masks = {jnum.ValueLedger.subset_key(s) for s in subsets}
    assert set(port.entries) == set(jax_led.entries) == masks
    d = jnum.diff_ledgers(port, jax_led)
    assert d["common"] == 7 and d["only_a"] == d["only_b"] == 0
    assert d["kendall_tau"] == 1.0
    dv = max(abs(port.entries[k]["value"] - jax_led.entries[k]["value"]) for k in masks)
    assert dv <= 1.0 / n_test + 1e-6
    # other random streams, so another fingerprint: reported, not comparable
    assert d["same_fingerprint"] is False and d["comparable"] is False
    assert {e["source"] for e in port.entries.values()} == {"exact"}
    assert port.meta == {"topology": "1d", "part_shards": 1, "n_devices": 1,
                         "reduction_mode": "default", "precision": "fp32",
                         "slot_bucketing": "masked"}
    assert set(port.meta) == set(jax_led.meta)
    assert port.engine_fingerprint == eng._fingerprint_digest()


def test_folds_and_forensics_match_jax():
    rng = np.random.default_rng(7)
    for P in (2, 3, 4, 5, 6, 10):
        terms = (rng.standard_normal((P, 17, 5)) * 10 ** rng.uniform(-3, 3, (P, 1, 1))
                 ).astype(np.float32)
        a = numerics._linear_fold(terms)
        np.testing.assert_array_equal(a, jnum._linear_fold(terms))
        assert a.dtype == np.float32
        for s in [d for d in range(1, P + 1) if P % d == 0]:
            np.testing.assert_array_equal(numerics._grouped_fold(terms, s),
                                          jnum._grouped_fold(terms, s))
            for x, y in zip(numerics._device_partials(terms, s),
                            jnum._device_partials(terms, s)):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(
                numerics.ulp_distance_f32(a, numerics._grouped_fold(terms, s)),
                jnum.ulp_distance_f32(a, jnum._grouped_fold(terms, s)))
    x = rng.standard_normal(1000).astype(np.float32)
    y = np.nextafter(x, np.float32(np.inf) * np.sign(rng.standard_normal(1000)))
    np.testing.assert_array_equal(numerics.ulp_distance_f32(x, y), jnum.ulp_distance_f32(x, y))
    for n in (1, 2, 5, 50, 300):
        u, v = rng.random(n), rng.random(n)
        v[: n // 3] = u[: n // 3]
        u[::7] = 0.5
        assert numerics.kendall_tau_b(u, v) == jnum.kendall_tau_b(u, v)
        assert numerics.kendall_tau_b(u, u) == jnum.kendall_tau_b(u, u)
    for v in (0.0, -0.0, 1 / 3, 1e-300, -7.5, float("inf")):
        bits = numerics.float_bits(v)
        assert bits == jnum.float_bits(v)
        assert numerics.bits_to_float(bits) == jnum.bits_to_float(bits)


def _scenario(approach: str = "fedavg", epochs: int = 2) -> Scenario:
    sc = Scenario(4, [0.1, 0.2, 0.3, 0.4], is_dry_run=True, dataset=datasets.load_titanic(),
                  seed=5, epoch_count=epochs, minibatch_count=2,
                  multi_partner_learning_approach=approach,
                  gradient_updates_per_pass_count=2, is_early_stopping=epochs > 10,
                  device="cpu")
    sc.instantiate_scenario_partners()
    sc.split_data()
    return sc


SUBSETS = powerset_order(4)


@pytest.mark.parametrize("plan", [None, "transient@batch2,oom@harvest3"])
def test_audit_leaves_every_value_bit_equal(monkeypatch, plan):
    monkeypatch.setenv(constants.DEVICE_FENCE_RATE_ENV, "1")
    if plan:
        monkeypatch.setenv(constants.FAULT_PLAN_ENV, plan)
        monkeypatch.setenv(constants.COALITIONS_PER_DEVICE_ENV, "4")
    off = CharacteristicEngine(_scenario()).evaluate(SUBSETS)
    monkeypatch.setenv(constants.NUMERICS_AUDIT_ENV, "1")
    eng = CharacteristicEngine(_scenario())
    with trace.collect() as records:
        on = eng.evaluate(SUBSETS)
    np.testing.assert_array_equal(on, off)
    audits = eng.numerics_audits
    assert 1 <= len(audits) <= 4
    assert all(len(a.subset) > 1 and a.executed == "torch.sum" and a.partners == 4
               and a.rounds == 4 and a.shard_counts == (2, 4) for a in audits)
    assert len({a.subset for a in audits}) == len(audits)
    # each replayed at its batch's [width, partners or slots]
    shapes = {(b["width"], b["slot_count"] or 4) for b in eng.batch_log}
    assert all(a.executed_shape in shapes for a in audits)
    names = [r["name"] for r in records]
    assert names.count("numerics.audit") == len(audits)
    assert metrics.counter("numerics.audits").value == len(audits)


def test_audit_under_the_deterministic_reduce_finds_no_divergence(monkeypatch):
    monkeypatch.setenv(constants.DETERMINISTIC_REDUCE_ENV, "1")
    eng = CharacteristicEngine(_scenario())
    res = numerics.audit_coalition(eng, (0, 2, 3))
    assert res is not None and res.executed == "ordered_fold"
    assert res.first_divergence is None and res.max_ulp == 0 and res.divergent_elements == 0
    assert res.executed_shards is None


@pytest.mark.parametrize("width, slot_count", [(16, None), (4, 3)])
def test_the_audit_reduces_at_the_batchs_shape(monkeypatch, width, slot_count):
    """The executed reduction runs at the audited batch's shape: `width`
    runs of the 4 masked partners or of 3 slots holding (0, 2, 3) in
    order, and under the deterministic reduce agrees with the host fold."""
    from mplc_tpu_torch.ops import aggregation
    real, seen = aggregation.aggregate, []

    def spy(params, weights, deterministic=False):
        seen.append(tuple(weights.shape))
        return real(params, weights, deterministic)
    monkeypatch.setenv(constants.DETERMINISTIC_REDUCE_ENV, "1")
    eng = CharacteristicEngine(_scenario())
    monkeypatch.setattr(aggregation, "aggregate", spy)
    res = numerics.audit_coalition(eng, (0, 2, 3), width, slot_count)
    shape = (width, slot_count or 4)
    assert res.executed_shape == shape and set(seen) == {shape}
    assert res.first_divergence is None and res.max_ulp == 0


def test_audit_skips_what_the_jax_audit_skips(monkeypatch):
    eng = CharacteristicEngine(_scenario())
    assert numerics.audit_coalition(eng, (2,)) is None                  # a single
    assert numerics.audit_coalition(CharacteristicEngine(_scenario("seqavg")), (0, 1)) is None
    assert numerics.audit_coalition(CharacteristicEngine(_scenario(epochs=12)), (0, 1)) is None
    assert numerics.audit_coalition(CharacteristicEngine(_scenario(), seed_ensemble=2),
                                    (0, 1)) is None
    assert metrics.counter("numerics.audits").value == 0


def test_a_divergent_reduction_is_localized_and_dumped(monkeypatch, tmp_path):
    """The executed reduction made to part from the host fold (the
    engine's aggregation swapped for one that folds the partners right to
    left): the first divergent (round, leaf), its ulps, a drift event, a
    counter and a flight dump."""
    from mplc_tpu_torch.ops import aggregation
    real = aggregation.aggregate

    def right_to_left(params, weights, deterministic=False):
        flipped = {g: {k: torch.flip(t, [1]) for k, t in d.items()} for g, d in params.items()}
        return real(flipped, torch.flip(weights, [1]), True)
    eng = CharacteristicEngine(_scenario())
    monkeypatch.setattr(aggregation, "aggregate", right_to_left)
    with trace.collect() as records:
        res = numerics.audit_coalition(eng, (0, 1, 2, 3))
    monkeypatch.setattr(aggregation, "aggregate", real)
    assert res.first_divergence is not None and res.max_ulp > 0
    r, leaf, executed = res.first_divergence
    assert executed == "torch.sum" and leaf in ("d1/b", "d1/w") and 0 <= r < res.rounds
    assert len(res.partials_at_divergence) == 4
    drift = [x for x in records if x["name"] == "numerics.drift"]
    assert len(drift) == 1 and drift[0]["attrs"]["max_ulp"] == res.max_ulp
    assert metrics.counter("numerics.drift_events").value == 1
    dumps = list((tmp_path / "flight").glob("*numerics_drift*"))
    assert len(dumps) == 1
    doc = json.loads(dumps[0].read_text())
    assert doc["extra"]["divergent_leaf"] == leaf


class _Engine:
    def __init__(self, meter):
        self.device_meter = meter


@pytest.mark.parametrize("n", [0, 7, 8, 1023])
def test_meter_basis_matches_jax(n):
    ours, theirs = devcost.DeviceMeter(0), jdevcost.DeviceMeter(0)
    for m in (ours, theirs):
        m.note(1, span_sec=2.5)
        if n:
            m.note(n, span_sec=0.0041 * n, eval_only=True)
    got = planner.estimate_eval_seconds(_Engine(ours))
    assert got == jplanner.estimate_eval_seconds(_Engine(theirs))
    assert got[1] == ("meter" if n >= 8 else "default")
    assert planner.estimate_eval_seconds(None) == jplanner.estimate_eval_seconds(None)
    plan = planner.plan_query(10, 0.02, 20.0, eval_sec=got[0], cost_basis=got[1])
    jp = jplanner.plan_query(10, 0.02, 20.0, eval_sec=got[0], cost_basis=got[1], live=False)
    assert plan.describe() == jp.describe()
