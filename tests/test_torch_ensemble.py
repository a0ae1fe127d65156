"""Seed-ensemble sweeps and their trust row in the PyTorch port, on the CPU
(Titanic, 4 partners; after tests/test_partner_faults.py):

(a) replica 0 is the single-seed sweep bit for bit, the replicas are other
    games, and the replicas ride the same batches (fewer than K times the
    single-seed batches);
(b) the cache: replica rows saved and restored, a lost replica row
    re-trained alone, caches of another ensemble width, plan or step width
    refused, and a cache without those keys read as the single-seed,
    fault-free, per-sub-batch game;
(c) the trust row: `trust_summary` and its parts bit-equal to the JAX
    package's on the same sample table, and MPLC_TORCH_SEED_ENSEMBLE
    driving `compute_SV`'s row;
(d) the guards: K < 1, and K > 1 for fedavg under the deterministic reduce
    without a fault plan (the JAX package's 2-D pipeline case).
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from mplc_tpu.contrib import shapley as jshapley
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import (confidence_intervals, kendall_tau, powerset_order,
                                            rank_stability, shapley_sample_matrix,
                                            trust_from_replicas, trust_summary)
from test_torch_faults import _engine as _fault_engine
from test_torch_faults import _env  # noqa: F401  (the knobs cleared for every test)

torch.set_num_threads(1)

SUBSETS = powerset_order(4)


def _engine(K=None, **game):
    """The 4-partner Titanic game's engine with `seed_ensemble=K` (None:
    the knob)."""
    eng = _fault_engine(**game)
    return eng if K is None else CharacteristicEngine(eng.scenario, seed_ensemble=K)


_REF = {}


def _reference() -> np.ndarray:
    """The single-seed v(S) table, once a process."""
    if "vals" not in _REF:
        _REF["vals"] = _engine(1).evaluate(SUBSETS)
    return _REF["vals"]


# ---------------------------------------------------------------------------
# (a) replicas
# ---------------------------------------------------------------------------

def test_replica_zero_is_the_single_seed_sweep():
    eng = _engine(3)
    np.testing.assert_array_equal(eng.evaluate(SUBSETS), _reference())
    assert set(eng.charac_fct_samples) == set(SUBSETS)
    for s in SUBSETS:
        arr = eng.charac_fct_samples[s]
        assert arr.shape == (3,) and not np.isnan(arr).any()
        assert arr[0] == eng.charac_fct_values[s]
    # the replicas are other games
    assert sum(len(set(eng.charac_fct_samples[s])) > 1 for s in SUBSETS) >= len(SUBSETS) // 2
    assert eng.first_charac_fct_calls_count == len(SUBSETS)
    # replica j's stream is its own rule's, replica 0's the coalition's
    assert torch.equal(torch.rand(4, generator=eng.coalition_generator((0, 1), 0)),
                       torch.rand(4, generator=eng.coalition_generator((0, 1))))
    assert not torch.equal(torch.rand(4, generator=eng.coalition_generator((0, 1), 1)),
                           torch.rand(4, generator=eng.coalition_generator((0, 1), 2)))


@pytest.mark.parametrize("K", [2, 4])
def test_replicas_ride_the_same_batches(K):
    """Replica rows fill the rows a single-seed sweep pads: the batch count
    grows sub-linearly in K (`batch_log`)."""
    one = _engine(1)
    one.evaluate(SUBSETS)
    many = _engine(K)
    many.evaluate(SUBSETS)
    b1, bk = len(one.batch_log), len(many.batch_log)
    assert 0 < b1 and bk < K * b1, (b1, bk)
    assert sum(b["coalitions"] for b in many.batch_log) == K * len(SUBSETS)


def test_ensemble_composes_with_forever_dropout(monkeypatch):
    """Under `dropout@p2:epoch1` every replica of S is that replica of
    S \\ {2} (each row keyed by its effective subset), and an all-dropped
    coalition's replicas are 0."""
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, "dropout@p2:epoch1")
    monkeypatch.setenv(constants.NO_SLOTS_ENV, "1")
    eng = _engine(2)
    eng.evaluate(SUBSETS)
    for s in SUBSETS:
        eff = tuple(i for i in s if i != 2)
        if not eff:
            np.testing.assert_array_equal(eng.charac_fct_samples[s], np.zeros(2))
        elif eff != s:
            np.testing.assert_array_equal(eng.charac_fct_samples[s],
                                          eng.charac_fct_samples[eff])


# ---------------------------------------------------------------------------
# (b) the cache
# ---------------------------------------------------------------------------

def _rewrite(path, edit):
    """Apply `edit` to a saved cache's payload and re-sign it as
    `save_cache` does."""
    payload = json.loads(path.read_text())
    payload.pop("payload_sha256")
    edit(payload)
    body = json.dumps(payload)
    path.write_text('{"payload_sha256": "%s", %s'
                    % (hashlib.sha256(body.encode()).hexdigest(), body[1:]))


def test_cache_round_trip_and_lost_replica(tmp_path):
    eng = _engine(2)
    eng.evaluate(SUBSETS)
    path = tmp_path / "cache.json"
    eng.save_cache(path)
    resumed = _engine(2)
    resumed.load_cache(path)
    assert resumed.charac_fct_values == eng.charac_fct_values
    for s, arr in eng.charac_fct_samples.items():
        np.testing.assert_array_equal(resumed.charac_fct_samples[s], arr)
    resumed.evaluate(SUBSETS)
    assert resumed.batch_log == []

    # replica 1 of (0, 3) lost (NaN): only that subset trains again, all
    # its replicas, and its value and the call count stay
    lost = (0, 3)

    def drop(payload):
        for entry in payload["charac_fct_samples"]:
            if tuple(entry[0]) == lost:
                entry[1][1] = float("nan")
    _rewrite(path, drop)
    again = _engine(2)
    again.load_cache(path)
    assert again._incomplete(lost)
    assert [s for s in SUBSETS if again._incomplete(s)] == [lost]
    np.testing.assert_array_equal(again.evaluate(SUBSETS), eng.evaluate(SUBSETS))
    assert [(b["kind"], b["coalitions"]) for b in again.batch_log] == [("multi", 2)]
    np.testing.assert_array_equal(again.charac_fct_samples[lost], eng.charac_fct_samples[lost])
    assert again.first_charac_fct_calls_count == eng.first_charac_fct_calls_count


def test_fingerprint_refuses_another_game(tmp_path, monkeypatch):
    """A cache of K = 2 is refused by K = 1 and K = 3 engines; a fault-free
    cache by an engine under a plan; a per-sub-batch cache under k = 2."""
    eng = _engine(2)
    eng.evaluate(SUBSETS[:4])
    path = tmp_path / "ens.json"
    eng.save_cache(path)
    for K in (1, 3):
        with pytest.raises(ValueError, match="seed_ensemble"):
            _engine(K).load_cache(path)
    clean = _engine(1)
    clean.evaluate(SUBSETS[:4])
    clean_path = tmp_path / "clean.json"
    clean.save_cache(clean_path)
    with monkeypatch.context() as m:
        m.setenv(constants.PARTNER_FAULT_PLAN_ENV, "dropout@p1:epoch2")
        faulty = _engine(1)
        assert faulty._fingerprint()["partner_fault_plan"] == "dropout@p1:2"
        with pytest.raises(ValueError, match="partner_fault_plan"):
            faulty.load_cache(clean_path)
    with monkeypatch.context() as m:
        m.setenv(constants.STEP_WIDTH_MULT_ENV, "2")
        with pytest.raises(ValueError, match="step_width_mult"):
            _engine(1).load_cache(clean_path)
    # the same game loads
    _engine(1).load_cache(clean_path)


def test_cache_without_the_keys_is_the_plain_game(tmp_path):
    """A cache written without step_width_mult, partner_fault_plan,
    seed_ensemble and replica rows describes the per-sub-batch, fault-free,
    single-seed game, as the JAX package reads it."""
    eng = _engine(1)
    eng.evaluate(SUBSETS[:4])
    path = tmp_path / "old.json"
    eng.save_cache(path)

    def strip(payload):
        for key in ("step_width_mult", "partner_fault_plan", "seed_ensemble"):
            del payload["fingerprint"][key]
    _rewrite(path, strip)
    resumed = _engine(1)
    resumed.load_cache(path)
    assert resumed.charac_fct_values == eng.charac_fct_values
    assert resumed.charac_fct_samples == {}
    with pytest.raises(ValueError, match="seed_ensemble"):
        _engine(2).load_cache(path)


# ---------------------------------------------------------------------------
# (c) the trust row
# ---------------------------------------------------------------------------

def _sample_table(n=4, K=5, seed=3) -> dict:
    rng = np.random.default_rng(seed)
    return {s: rng.random(K) for s in powerset_order(n)}


@pytest.mark.parametrize("K", [1, 2, 5])
def test_trust_summary_matches_jax(K):
    table = {s: arr[:K] for s, arr in _sample_table().items()}
    sv = shapley_sample_matrix(4, table)
    assert sv.tobytes() == jshapley.shapley_sample_matrix(4, table).tobytes()
    assert trust_summary(4, table) == jshapley.trust_summary(4, table)
    for alpha in (0.9, 0.99):
        assert trust_summary(4, table, alpha) == jshapley.trust_summary(4, table, alpha)
    assert trust_from_replicas(sv) == jshapley.trust_from_replicas(sv)
    with pytest.raises(ValueError, match="empty replica table"):
        shapley_sample_matrix(4, {})


def test_trust_math():
    """tests/test_partner_faults.py's trust cases."""
    assert kendall_tau([1, 2, 3], [10, 20, 30]) == 1.0
    assert kendall_tau([1, 2, 3], [3, 2, 1]) == -1.0
    assert kendall_tau([5.0], [1.0]) == 1.0
    samples = np.array([[0.1, 0.2, 0.3], [0.15, 0.25, 0.35], [0.1, 0.22, 0.31]])
    assert rank_stability(samples) == 1.0
    assert rank_stability(np.array([[0.1, 0.2, 0.3], [0.3, 0.2, 0.1]])) == -1.0
    assert rank_stability(samples[:1]) == 1.0
    phi = np.array([0.1, 0.25, 0.65])
    # an additive game, replica j scaled by 1 + j / 10
    table = {s: np.array([sum(phi[i] for i in s) * (1 + j / 10) for j in range(4)])
             for s in powerset_order(3)}
    sv = shapley_sample_matrix(3, table)
    for j in range(4):
        np.testing.assert_allclose(sv[j], phi * (1 + j / 10), atol=1e-12)
    mean, lo, hi = confidence_intervals(sv)
    assert np.all(lo <= mean) and np.all(mean <= hi) and np.all(hi - lo > 0)
    t = trust_summary(3, table)
    assert t["ensemble"] == 4 and t["kendall_tau"] == 1.0 and t["source"] == "seed_ensemble"
    one = trust_summary(3, {s: arr[:1] for s, arr in table.items()})
    assert one["ci_low"] == one["ci_high"] == one["mean"]


def test_ensemble_knob_drives_the_trust_row(monkeypatch):
    monkeypatch.setenv(constants.SEED_ENSEMBLE_ENV, "3")
    c = Contributivity(_engine().scenario)
    eng = c.engine
    assert eng.seed_ensemble == 3 and eng._fingerprint()["seed_ensemble"] == 3
    c.compute_contributivity("Shapley values")
    assert c.trust is not None and c.trust["source"] == "seed_ensemble"
    assert c.trust["ensemble"] == 3 and -1.0 <= c.trust["kendall_tau"] <= 1.0
    assert len(c.trust["ci_low"]) == 4
    assert c.trust == trust_summary(4, eng.charac_fct_samples)
    np.testing.assert_array_equal(c.scores_std, c.trust["std"])
    assert np.any(np.asarray(c.trust["std"]) > 0)
    assert np.all(np.asarray(c.trust["ci_low"]) <= np.asarray(c.trust["mean"]))
    assert np.all(np.asarray(c.trust["mean"]) <= np.asarray(c.trust["ci_high"]))
    # the point values are the single-seed sweep's
    np.testing.assert_array_equal([eng.charac_fct_values[s] for s in SUBSETS], _reference())
    # without an ensemble the exact sweep has no trust row and zero std
    monkeypatch.delenv(constants.SEED_ENSEMBLE_ENV)
    plain = Contributivity(_engine().scenario)
    plain.compute_contributivity("Shapley values")
    assert plain.trust is None and not plain.scores_std.any()


# ---------------------------------------------------------------------------
# (d) guards
# ---------------------------------------------------------------------------

def test_ensemble_guards(monkeypatch):
    sc = _engine(1).scenario
    with pytest.raises(ValueError, match="seed_ensemble must be >= 1"):
        CharacteristicEngine(sc, seed_ensemble=0)
    monkeypatch.setenv(constants.SEED_ENSEMBLE_ENV, "0")
    with pytest.warns(UserWarning, match="positive integer"):
        assert CharacteristicEngine(sc).seed_ensemble == 1
    monkeypatch.delenv(constants.SEED_ENSEMBLE_ENV)
    # fedavg under the deterministic reduce without a plan: the JAX
    # package's 2-D pipeline, which has no ensembles
    monkeypatch.setenv(constants.DETERMINISTIC_REDUCE_ENV, "1")
    with pytest.raises(ValueError, match="DETERMINISTIC_REDUCE"):
        _engine(2)
    # with a plan the sweep runs on slots, which carry replicas
    monkeypatch.setenv(constants.PARTNER_FAULT_PLAN_ENV, "straggler@p1:delay1")
    eng = _engine(2)
    assert eng._use_slots and eng.seed_ensemble == 2
    # the seq family stays on slots under the reduce
    monkeypatch.delenv(constants.PARTNER_FAULT_PLAN_ENV)
    assert _engine(2, multi_partner_learning_approach="seqavg")._use_slots
