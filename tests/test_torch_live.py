"""The port's live tier (`mplc_tpu_torch/live/`) against the JAX package's
(`mplc_tpu/live/`), on the CPU, Titanic with 3 partners:

(a) a JAX `LiveGame.from_recording` with a journal; the port's `LiveGame`
    restored from THAT WAL (its params and rounds are the JAX recording's)
    answers exact, hierarchical, GTG-Shapley and SVARM within the
    reconstruction parity tolerance of tests/test_torch_slice.py (v(S)
    within one test sample, scores within two); and the other way round,
    a port WAL restores in JAX;
(b) the JAX tests' synthetic rounds (tests/test_live.py) appended to both
    packages' games: the same stamps and answers; the port's memo,
    invalidation, incremental-equals-up-front, round cap, shape validation,
    exact bound and prune-tau rules;
(c) DPVS info scores within 1e-6 relative of JAX's, the same pruned sets.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from helpers import build_scenario
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.live import LiveGame as JLiveGame
from mplc_tpu.live import dpvs as jdpvs
from mplc_tpu.live import residency as jresidency
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.contrib.planner import plan_query
from mplc_tpu_torch.contrib.shapley import powerset_order, shapley_from_characteristic
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.live import (LIVE_METHODS, MAX_EXACT_PARTNERS, LiveGame, LiveGameFull,
                                 info_scores, low_information, residency)
from mplc_tpu_torch.obs import metrics, report
from mplc_tpu_torch.obs import trace as obs_trace
from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

AMOUNTS = [0.2, 0.3, 0.5]
GAME = dict(epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2)
GTG = dict(sv_accuracy=1.0, min_iter=8, perm_batch=4, truncation=0.0)
SVARM = dict(budget=24, block=8)
KW = {"exact": {}, "hierarchical": {}, "GTG-Shapley": GTG, "SVARM": SVARM}


@pytest.fixture(autouse=True)
def _isolated_residency():
    residency.reset()
    jresidency.reset()
    yield
    residency.reset()
    jresidency.reset()


def port_scenario(seed=3, partners=3, amounts=AMOUNTS, **game):
    sc = Scenario(partners, amounts, is_dry_run=True, dataset=tdatasets.load_titanic(),
                  seed=seed, is_early_stopping=False, device="cpu", **{**GAME, **game})
    sc.instantiate_scenario_partners()
    sc.split_data()
    return sc


def jax_scenario():
    return build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True, **GAME)


def synth_rounds(init_params, P, k, seed=0, scale=0.08):
    """k deterministic synthetic rounds shaped like `init_params` (the JAX
    tests' recipe), as nested dicts of numpy."""
    rng = np.random.default_rng(seed)
    rounds = []
    for _ in range(k):
        deltas = {g: {n: rng.normal(0, scale, (P,) + np.shape(a)).astype(np.float32)
                      for n, a in d.items()} for g, d in init_params.items()}
        rounds.append((deltas, rng.dirichlet(np.ones(P)).astype(np.float32)))
    return rounds


def zero_round(init_params, P):
    return ({g: {n: np.zeros((P,) + np.shape(a), np.float32) for n, a in d.items()}
             for g, d in init_params.items()}, np.zeros(P, np.float32))


def n_test(game) -> int:
    return len(game.scenario.dataset.x_test)


def assert_values_close(port, jax_values, n):
    keys = powerset_order(3)
    got = np.array([port[k] for k in keys])
    want = np.array([float(jax_values[k]) for k in keys])
    # at most one test sample flips at a decision boundary
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / n + 1e-6)


@pytest.fixture(scope="module")
def jax_recorded(tmp_path_factory):
    """A JAX live game seeded from its recording, journaled; its answers
    to every method."""
    wal = tmp_path_factory.mktemp("jwal") / "live.jsonl"
    jgame = JLiveGame.from_recording(jax_scenario(), journal_path=str(wal))
    answers = {m: jgame.query(m, **KW[m]) for m in LIVE_METHODS}
    values = dict(jgame._recon.values)
    info = jgame._info_scores()
    jgame.close()
    return {"wal": wal, "answers": answers, "values": values, "info": info,
            "rounds": jgame.rounds_resident, "stamp": jgame.round_stamp}


# ---------------------------------------------------------------------------
# (a) a JAX WAL carries the JAX game into the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", LIVE_METHODS)
def test_port_game_restored_from_a_jax_wal_answers_like_jax(jax_recorded, method):
    game = LiveGame(port_scenario(), journal_path=jax_recorded["wal"])
    assert (game.rounds_resident, game.round_stamp) == (jax_recorded["rounds"],
                                                        jax_recorded["stamp"])
    r = game.query(method, **KW[method])
    want = jax_recorded["answers"][method]
    n = n_test(game)
    np.testing.assert_allclose(r.scores, want.scores, rtol=0, atol=2.0 / n)
    assert r.method == want.method and r.stamp == want.stamp and r.rounds == want.rounds
    if method == "exact":
        assert r.evaluations == want.evaluations == 7
        assert_values_close(game._recon.values, jax_recorded["values"], n)
    game.close()


def test_jax_recording_restored_equals_its_reconstruction_in_the_port(jax_recorded):
    """The restored stream is the JAX recording's, leaf for leaf: the
    port's exact values equal a port evaluator over JAX's RecordedRun,
    bit for bit."""
    from mplc_tpu_torch.contrib.engine import CharacteristicEngine
    from mplc_tpu_torch.contrib.reconstruct import ReconstructionEvaluator
    game = LiveGame(port_scenario(), journal_path=jax_recorded["wal"])
    game.query("exact")
    rec = game._build_recorded()
    recon = ReconstructionEvaluator(CharacteristicEngine(port_scenario()), rec)
    recon.evaluate(powerset_order(3))
    assert recon.values == game._recon.values
    game.close()


def test_a_port_wal_restores_in_jax(tmp_path):
    wal = tmp_path / "port.jsonl"
    game = LiveGame.from_recording(port_scenario(), journal_path=wal)
    want = game.query("exact")
    game.close()
    jgame = JLiveGame(jax_scenario(), journal_path=str(wal))
    assert (jgame.rounds_resident, jgame.round_stamp) == (game.rounds_resident,
                                                          game.round_stamp)
    got = jgame.query("exact")
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=2.0 / n_test(game))
    assert_values_close(game._recon.values, jgame._recon.values, n_test(game))
    # the JAX game appends after the port's records and the port reads them
    jgame.append_round(*synth_rounds(jgame._init_params, 3, 1, seed=3)[0])
    jgame.close()
    again = LiveGame(port_scenario(), journal_path=wal)
    assert again.rounds_resident == game.rounds_resident + 1
    again.close()


def test_from_recording_exact_equals_exact_reconstructed():
    """The replay origin: a port game seeded from its own recording gives
    `Contributivity.exact_reconstructed`'s v(S) and scores bit for bit."""
    sc = port_scenario()
    c = Contributivity(sc)
    c.exact_reconstructed()
    game = LiveGame.from_recording(port_scenario())
    r = game.query("exact")
    assert game._recon.values == c._reconstructor().values
    assert r.scores.tobytes() == c.contributivity_scores.tobytes()
    metrics.reset()
    # the live engine trained the recording and nothing else
    assert game.query("GTG-Shapley", **GTG).evaluations == 0


# ---------------------------------------------------------------------------
# (b) synthetic rounds appended to both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def twin_games(tmp_path_factory):
    """A JAX game (journaled, no recording) and the port game restored
    from its WAL: the same replay origin."""
    wal = tmp_path_factory.mktemp("twin") / "live.jsonl"
    jgame = JLiveGame(jax_scenario(), journal_path=str(wal))
    jgame.close()
    return wal


def _pair(wal, tmp_path):
    """(JAX game, port game restored from a copy of `wal`): one origin."""
    own = tmp_path / "own.jsonl"
    shutil.copy(wal, own)
    jgame = JLiveGame(jax_scenario())
    game = LiveGame(port_scenario(), journal_path=own)
    for g, d in game._init_params.items():
        for k, a in d.items():
            assert a.tobytes() == np.asarray(jgame._init_params[g][k]).tobytes()
    return jgame, game


def test_synthetic_rounds_give_jax_stamps_and_answers(twin_games, tmp_path):
    jgame, game = _pair(twin_games, tmp_path)
    rounds = synth_rounds(game._init_params, 3, 3, seed=5)
    for i, (d, w) in enumerate(rounds):
        assert game.append_round(d, w) == jgame.append_round(d, w) == i + 1
        if i == 1:
            assert game.append_round(*zero_round(game._init_params, 3)) == \
                jgame.append_round(*zero_round(game._init_params, 3)) == 2
        for method in ("exact", "GTG-Shapley"):
            r, jr = game.query(method, **KW[method]), jgame.query(method, **KW[method])
            assert r.stamp == jr.stamp and r.rounds == jr.rounds
            np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=2.0 / n_test(game))
    np.testing.assert_allclose(game._info_scores(), jgame._info_scores(), rtol=1e-6, atol=0)
    game.close()


def test_warm_query_is_a_memo_hit_with_zero_training(twin_games, tmp_path):
    game = LiveGame(port_scenario())
    for d, w in synth_rounds(game._init_params, 3, 3, seed=1):
        game.append_round(d, w)
    metrics.reset()
    with obs_trace.collect() as records:
        r1 = game.query("exact")
    snap = metrics.snapshot()["counters"]
    assert snap.get("engine.partner_passes", 0) == 0
    assert snap.get("engine.epochs_trained", 0) == 0
    batches = [rec for rec in records if rec["name"] == "engine.batch"]
    assert batches and all(b["attrs"].get("eval_only") for b in batches)
    assert r1.evaluations == 7 and r1.stamp == game.round_stamp
    with obs_trace.collect() as records2:
        r2 = game.query("exact")
    assert r2 is r1
    assert not [rec for rec in records2 if rec["name"] == "engine.batch"]
    q = [rec for rec in records2 if rec["name"] == "live.query"]
    assert len(q) == 1 and q[0]["attrs"]["memo_hit"] is True
    assert metrics.snapshot()["counters"]["live.query_memo_hits"] == 1


def test_non_invalidating_append_keeps_the_memo():
    game = LiveGame(port_scenario())
    for d, w in synth_rounds(game._init_params, 3, 2, seed=2):
        game.append_round(d, w)
    r1 = game.query("exact")
    stamp = game.round_stamp
    for _ in range(4):
        assert game.append_round(*zero_round(game._init_params, 3)) == stamp
    assert game.rounds_resident == 6 and game.round_stamp == stamp
    with obs_trace.collect() as records:
        assert game.query("exact") is r1
    assert not [rec for rec in records if rec["name"] == "engine.batch"]
    # the zero rounds are left out of the stack
    assert game._build_recorded().rounds == 2


def test_invalidating_append_never_serves_stale():
    game = LiveGame(port_scenario())
    rounds = synth_rounds(game._init_params, 3, 2, seed=4)
    game.append_round(*rounds[0])
    r1 = game.query("exact")
    K1 = game._recon._d2.shape[0]
    game.append_round(*rounds[1])
    assert r1.stamp < game.round_stamp
    r2 = game.query("exact")
    assert r2 is not r1 and r2.stamp == game.round_stamp and r2.evaluations == 7
    # the evaluator swapped its stream: K grew by P rows, the memo restarted
    assert game._recon._d2.shape[0] == K1 + 3


@pytest.mark.parametrize("method", ["exact", "hierarchical", "GTG-Shapley", "SVARM"])
def test_incremental_equals_up_front(method):
    game_a, game_b = LiveGame(port_scenario()), LiveGame(port_scenario())
    rounds = synth_rounds(game_a._init_params, 3, 3, seed=5)
    for d, w in rounds:
        game_a.append_round(d, w)
        game_a.query("exact")  # interleaved queries must not perturb
    for d, w in rounds:
        game_b.append_round(d, w)
    assert game_a.query(method, **KW[method]).scores.tobytes() == \
        game_b.query(method, **KW[method]).scores.tobytes()


def test_resident_round_cap(monkeypatch):
    game = LiveGame(port_scenario(), max_rounds=2)
    rounds = synth_rounds(game._init_params, 3, 3, seed=8)
    game.append_round(*rounds[0])
    game.append_round(*rounds[1])
    with pytest.raises(LiveGameFull, match="MPLC_TORCH_LIVE_MAX_ROUNDS") as ei:
        game.append_round(*rounds[2])
    assert ei.value.retry_after_sec == 0.0 and game.rounds_resident == 2
    monkeypatch.setenv("MPLC_TORCH_LIVE_MAX_ROUNDS", "1")
    assert LiveGame(port_scenario()).max_rounds == 1
    monkeypatch.delenv("MPLC_TORCH_LIVE_MAX_ROUNDS")
    assert LiveGame(port_scenario()).max_rounds == 4096


def test_append_round_validates_shapes():
    game = LiveGame(port_scenario())
    deltas, w = synth_rounds(game._init_params, 3, 1, seed=9)[0]
    bad = {g: {k: a[:1] for k, a in d.items()} for g, d in deltas.items()}
    with pytest.raises(ValueError, match="delta leaf has shape"):
        game.append_round(bad, w)
    with pytest.raises(ValueError, match="structure"):
        game.append_round({"other": {}}, w)
    with pytest.raises(ValueError, match="unknown live query method"):
        game.query("no-such-method")
    assert game.rounds_resident == 0
    # tensors are taken as well as arrays
    tensors = {g: {k: torch.from_numpy(a) for k, a in d.items()} for g, d in deltas.items()}
    assert game.append_round(tensors, torch.from_numpy(w)) == 1


def test_exact_query_partner_bound():
    game = LiveGame(port_scenario())
    game.append_round(*synth_rounds(game._init_params, 3, 1, seed=10)[0])
    game.engine.partners_count = MAX_EXACT_PARTNERS + 1
    try:
        with pytest.raises(ValueError, match="GTG-Shapley or SVARM"):
            game.query("exact")
    finally:
        game.engine.partners_count = 3


def test_prune_tau_out_of_range(monkeypatch):
    game = LiveGame(port_scenario())
    game.append_round(*synth_rounds(game._init_params, 3, 1, seed=23)[0])
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        game.query("exact", prune=1.5)
    monkeypatch.setenv("MPLC_TORCH_LIVE_PRUNE_TAU", "2.5")
    with pytest.warns(UserWarning, match="outside"):
        r = game.query("exact")
    assert r.prune_tau == 0.0 and r.pruned_coalitions == 0


def test_prune_off_is_the_unpruned_reconstruction():
    game = LiveGame(port_scenario())
    for d, w in synth_rounds(game._init_params, 3, 2, seed=10):
        game.append_round(d, w)
    r = game.query("exact", prune=0.0)
    recon = game._evaluator()
    recon.evaluate(powerset_order(3))
    assert r.scores.tobytes() == shapley_from_characteristic(3, recon.values).tobytes()


def test_prune_cuts_evaluations_and_zeroes_the_pruned():
    """Five partners, two of whom carry near-zero deltas and weights:
    tau 0.05 prunes exactly those two (as JAX's rule does on the same
    rounds), the query evaluates the 2^3 - 1 projections instead of 31,
    and their scores are exactly 0."""
    P = 5
    sc = port_scenario(partners=P, amounts=[0.2] * P)
    game, twin = LiveGame(sc), LiveGame(sc)
    rng = np.random.default_rng(11)
    scale = np.array([1.0, 0.8, 0.6, 1e-5, 1e-5])
    weights = (scale / scale.sum()).astype(np.float32)
    for _ in range(3):
        deltas = {g: {k: (rng.normal(0, 0.08, (P,) + a.shape)
                          * scale.reshape((P,) + (1,) * a.ndim)).astype(np.float32)
                      for k, a in d.items()} for g, d in game._init_params.items()}
        game.append_round(deltas, weights)
        twin.append_round(deltas, weights)
    metrics.reset()
    pruned = game.query("exact", prune=0.05)
    unpruned = twin.query("exact", prune=0.0)
    assert pruned.low_info == (3, 4)
    assert jdpvs.low_information(jdpvs.info_scores(game.round_history(), P), 0.05) == {3, 4}
    assert pruned.evaluations == 7 and unpruned.evaluations == 31
    assert pruned.pruned_coalitions == metrics.snapshot()["counters"]["live.pruned_coalitions"]
    np.testing.assert_array_equal(pruned.scores[3:], 0.0)


def test_journal_kill_restart_and_foreign_journals(tmp_path):
    wal = tmp_path / "live.jsonl"
    game = LiveGame.from_recording(port_scenario(), journal_path=wal)
    for d, w in synth_rounds(game._init_params, 3, 2, seed=6):
        game.append_round(d, w)
    want = game.query("exact"), game.query("GTG-Shapley", **GTG)
    game.close()
    metrics.reset()
    restored = LiveGame(port_scenario(), journal_path=wal)
    assert (restored.rounds_resident, restored.round_stamp) == (game.rounds_resident,
                                                                game.round_stamp)
    assert metrics.snapshot()["counters"]["live.games_recovered"] == 1
    got = restored.query("exact"), restored.query("GTG-Shapley", **GTG)
    assert all(a.scores.tobytes() == b.scores.tobytes() for a, b in zip(got, want))
    restored.close()
    # from_recording on a restored journal does not record again
    again = LiveGame.from_recording(port_scenario(), journal_path=wal)
    assert again.rounds_resident == game.rounds_resident
    again.close()
    with pytest.raises(ValueError, match="refusing to restore"):
        LiveGame(port_scenario(partners=4, amounts=[0.25] * 4), journal_path=wal)
    sc = port_scenario()
    eng = LiveGame(sc).engine
    import dataclasses
    eng.model = dataclasses.replace(eng.model, name="other_model")
    with pytest.raises(ValueError, match="model"):
        LiveGame(sc, engine=eng, journal_path=wal)


@pytest.mark.parametrize("deadline", [None, 1e-9])
def test_auto_query_plans_as_the_jax_live_planner(deadline):
    from mplc_tpu.contrib import planner as jplanner
    game = LiveGame(port_scenario())
    game.append_round(*synth_rounds(game._init_params, 3, 1, seed=12)[0])
    with obs_trace.collect() as records:
        r = game.query("auto", deadline_sec=deadline)
    jp = jplanner.plan_query(3, None, deadline, eval_sec=r.plan.est_eval_sec,
                             cost_basis=r.plan.cost_basis, live=True)
    assert r.plan.describe() == jp.describe()
    assert r.method == jp.method and r.prune_tau == jp.prune_tau
    assert [rec["name"] for rec in records].count("live.plan") == 1
    # the plan alone replays the query
    twin = LiveGame(port_scenario())
    twin.append_round(*game.round_history()[0])
    replay = twin.query(r.plan.method, prune=r.plan.prune_tau, **r.plan.method_kw)
    assert replay.scores.tobytes() == r.scores.tobytes()


def test_memo_is_keyed_by_precision(monkeypatch):
    """A game reopened under bf16 (its engine built under it) never serves
    the fp32 answer: the key carries the precision, the values are its
    own, within the bf16 bound of fp32."""
    game = LiveGame(port_scenario())
    rounds = synth_rounds(game._init_params, 3, 2, seed=13)
    for d, w in rounds:
        game.append_round(d, w)
    fp32 = game.query("exact")
    monkeypatch.setenv("MPLC_TORCH_PRECISION", "bf16")
    bf16 = LiveGame(port_scenario())
    for d, w in rounds:
        bf16.append_round(d, w)
    r = bf16.query("exact")
    assert bf16._recon.precision == "bf16" and r.evaluations == 7
    assert [k[2] for k in bf16._results] == ["bf16"] and [k[2] for k in game._results] == ["fp32"]
    dv = [abs(bf16._recon.values[s] - game._recon.values[s]) for s in powerset_order(3)]
    assert max(dv) <= 0.05 and fp32.stamp == r.stamp


def test_describe_and_report_row():
    game = LiveGame(port_scenario(), tenant="acme")
    with obs_trace.collect() as records:
        game.append_round(*synth_rounds(game._init_params, 3, 1, seed=14)[0])
        r = game.query("exact")
        game.query("exact")
    doc = r.describe()
    json.dumps(doc)
    json.dumps(game.describe())
    assert doc["method"] == "exact" and doc["rounds"] == 1
    assert game.describe()["results_cached"] == 1 and game.describe()["journal"] is None
    lv = report.sweep_report(records)["live"]
    assert lv["queries"] == 2 and lv["memo_hits"] == 1 and lv["evaluations"] == 7
    assert lv["rounds_appended"] == 1 and lv["query_s"]["count"] == 1
    assert "live" in report.format_report(report.sweep_report(records))


# ---------------------------------------------------------------------------
# (c) DPVS info scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [0.0, 0.2, 0.5, 0.8, 1.0])
def test_info_scores_and_low_sets_equal_jax(jax_recorded, tau):
    game = LiveGame(port_scenario(), journal_path=jax_recorded["wal"])
    rounds = game.round_history() + synth_rounds(game._init_params, 3, 2, seed=int(tau * 10))
    s = info_scores(rounds, 3)
    js = jdpvs.info_scores(rounds, 3)
    np.testing.assert_allclose(s, js, rtol=1e-6, atol=0)
    np.testing.assert_allclose(game._info_scores(), jax_recorded["info"], rtol=1e-6, atol=0)
    assert low_information(s, tau) == jdpvs.low_information(js, tau)
    game.close()


def test_dpvs_score_arithmetic():
    rounds = [({"w": {"v": np.array([[2.0], [0.5]])}}, np.array([0.5, 0.5])),
              ({"w": {"v": np.array([[1.0], [0.0]])}}, np.array([1.0, 0.0]))]
    s = info_scores(rounds, 2)
    np.testing.assert_allclose(s, [0.5 * 2.0 + 1.0 * 1.0, 0.5 * 0.5])
    assert low_information(s, 0.5) == frozenset({1})
    assert low_information(s, 1.0) == frozenset({1})
    assert low_information(s, 0.0) == frozenset()
    assert low_information(np.zeros(3), 0.9) == frozenset()


def test_recording_refuses_the_2d_mode():
    """`_check_not_2d` (the JAX evaluator's guard): an engine around a
    partner-sharded scenario cannot record or build a live game."""
    import types
    from mplc_tpu_torch.contrib.reconstruct import _check_not_2d
    _check_not_2d(types.SimpleNamespace(scenario=types.SimpleNamespace(partner_shards=1)))
    with pytest.raises(ValueError, match="partner-sharded"):
        _check_not_2d(types.SimpleNamespace(scenario=types.SimpleNamespace(partner_shards=2)))
    # a Scenario asking for the 2-D mode builds (tests/test_torch_sharding.py
    # runs it); its engine cannot record
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(),
                  device="cpu", partner_shards=2)
    with pytest.raises(ValueError, match="partner-sharded"):
        _check_not_2d(types.SimpleNamespace(scenario=sc))


def test_planner_live_rung_is_the_jax_one():
    assert plan_query(20, live=True).method == "hierarchical"


def plain_stream(init_params, rounds, dtype):
    """The plain flattened stream: (init, d2) by numpy concatenation of the
    stacked rounds, zero-padded to a multiple of 8 columns, cast last."""
    leaves = [(g, n) for g, d in init_params.items() for n in d]
    init = np.concatenate([np.ravel(init_params[g][n]) for g, n in leaves])
    pad = -init.size % 8
    K = len(rounds) * len(rounds[0][leaves[0][0]][leaves[0][1]])
    d2 = np.concatenate([np.stack([r[g][n] for r in rounds]).reshape(K, -1)
                         for g, n in leaves] + [np.zeros((K, pad), np.float32)], axis=1)
    return (torch.from_numpy(np.concatenate([init, np.zeros(pad, np.float32)])),
            torch.from_numpy(d2).to(dtype))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [1, 3, 11])
def test_live_stream_is_the_stacked_recordings_flattening(k, precision):
    """The live game's stream (its host rounds copied into K1's layout
    round by round, never stacked) equals the plain flattening of the same
    rounds stacked, bit for bit, at K = 3k (no multiple of K1-bf16's K
    tile), a zero-weight round left out."""
    from mplc_tpu_torch.ops import recon_kernel
    game = LiveGame(port_scenario())
    rounds = synth_rounds(game._init_params, 3, k, seed=k)
    zero = ({g: {n: np.zeros_like(a) for n, a in d.items()}
             for g, d in rounds[0][0].items()}, np.zeros(3, np.float32))
    for d, w in rounds[:1] + [zero] + rounds[1:]:
        game.append_round(d, w)
    rec = game._build_recorded()
    assert rec.deltas is None and rec.rounds == k and len(rec.host_rounds) == k
    dtype = recon_kernel.stream_dtype(precision)
    init, d2, layout = recon_kernel.flatten_rounds(rec.init_params, rec.host_rounds, 3,
                                                   dtype, "cpu")
    want = plain_stream(game._init_params, [d for d, _ in rounds], dtype)
    assert [(g, n) for g, n, _ in layout] == [(g, n) for g, d in game._init_params.items()
                                              for n in d]
    assert torch.equal(init, want[0]) and d2.dtype == dtype and torch.equal(d2, want[1])
    # the game's own (fp32) evaluator holds that stream
    game._evaluator()
    assert torch.equal(game._recon._d2, plain_stream(game._init_params, [d for d, _ in rounds],
                                                     torch.float32)[1])
    game.close()
