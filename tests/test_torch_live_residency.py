"""Bounded residency for the port's live tier
(`mplc_tpu_torch/live/residency.py`), the counterparts of
tests/test_live_residency.py on the CPU (Titanic, 3 partners): evict ->
restore -> query bit-identical for every method, the LRU under a cap,
refusal with a retry hint, kill -> restart over a mixed population, the
cap's knob; and the WAL's round encoding byte-identical to the JAX
package's (`mplc_tpu/live/game.py` `_encode_tree`), so either package's
journal restores in the other."""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from helpers import build_scenario
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.live import LiveGame as JLiveGame
from mplc_tpu.live import game as jgame_mod
from mplc_tpu.live import residency as jresidency
from mplc_tpu.models import zoo as jzoo
from mplc_tpu_torch.convert import params_from_numpy
from mplc_tpu_torch.live import LiveGame, LiveGameFull, LiveResidencyFull, residency
from mplc_tpu_torch.live import game as game_mod
from mplc_tpu_torch.models import zoo as tzoo

from test_torch_live import GAME, port_scenario, synth_rounds

torch.set_num_threads(1)

GTG = dict(sv_accuracy=1.0, min_iter=8, perm_batch=4, truncation=0.0)
SVARM = dict(budget=64, block=16)


@pytest.fixture(autouse=True)
def _isolated_residency():
    residency.reset()
    jresidency.reset()
    yield
    residency.reset()
    jresidency.reset()


@pytest.fixture(scope="module")
def scen3():
    return port_scenario()


def _rounds(game, k, seed):
    return synth_rounds(game._init_params, game.engine.partners_count, k, seed=seed)


# ---------------------------------------------------------------------------
# 1. evict -> restore -> query bit-identity
# ---------------------------------------------------------------------------

def test_evict_restore_query_bit_identity_all_methods(scen3, tmp_path):
    game = LiveGame(scen3, journal_path=tmp_path / "wal.jsonl")
    for d, w in _rounds(game, 2, 41):
        game.append_round(d, w)
    before = {"exact": game.query("exact").scores,
              "GTG-Shapley": game.query("GTG-Shapley", **GTG).scores,
              "SVARM": game.query("SVARM", **SVARM).scores,
              "hierarchical": game.query("hierarchical").scores}
    stamp, rounds = game.round_stamp, game.rounds_resident
    assert game.evict() is True and not game.resident and game.rounds_resident == 0
    after = game.query("exact")
    assert game.resident and (game.round_stamp, game.rounds_resident) == (stamp, rounds)
    assert after.scores.tobytes() == before["exact"].tobytes()
    kw = {"GTG-Shapley": GTG, "SVARM": SVARM, "hierarchical": {}}
    for method in ("GTG-Shapley", "SVARM", "hierarchical"):
        game.evict()
        assert game.query(method, **kw[method]).scores.tobytes() == before[method].tobytes()
    assert residency.stats()["restores"] == 4 and game.last_restore_s > 0.0
    game.close()


def test_journal_less_game_is_unevictable(scen3):
    game = LiveGame(scen3)
    game.append_round(*_rounds(game, 1, 42)[0])
    assert game.evict() is False
    assert game.resident and game.rounds_resident == 1
    game.close()


def test_describe_reports_residency_without_restoring(scen3, tmp_path):
    game = LiveGame(scen3, journal_path=tmp_path / "wal.jsonl")
    game.append_round(*_rounds(game, 1, 43)[0])
    assert game.describe()["resident"] is True
    game.evict()
    d = game.describe()
    assert d["resident"] is False and not game.resident and d["rounds_resident"] == 0
    game.close()


# ---------------------------------------------------------------------------
# 2. the LRU under a cap
# ---------------------------------------------------------------------------

def test_lru_evicts_coldest_journaled_game(scen3, tmp_path):
    residency.configure(2)
    g1 = LiveGame(scen3, tenant="t1", journal_path=tmp_path / "1.wal")
    g2 = LiveGame(scen3, tenant="t2", journal_path=tmp_path / "2.wal")
    for g, seed in ((g1, 1), (g2, 2)):
        g.append_round(*_rounds(g, 1, seed)[0])
    g1.query("exact")
    g3 = LiveGame(scen3, tenant="t3", journal_path=tmp_path / "3.wal")
    assert g3.resident and g1.resident and not g2.resident
    st = residency.stats()
    assert st["max_resident"] == 2 and st["resident"] == 2 and st["evicted"] == 1
    assert st["evictions"] == 1
    g2.query("exact")
    assert g2.resident and not g1.resident
    assert residency.stats()["restores"] == 1
    for g in (g1, g2, g3):
        g.close()
    assert residency.stats()["resident"] == 0


def test_cap_refuses_new_games_with_retry_hint(scen3):
    residency.configure(1)
    g1 = LiveGame(scen3, tenant="pinned")
    g1.append_round(*_rounds(g1, 1, 44)[0])
    residency.note_restore(0.25)
    with pytest.raises(LiveResidencyFull, match="MPLC_TORCH_LIVE_MAX_RESIDENT") as ei:
        LiveGame(scen3, tenant="newcomer")
    assert ei.value.retry_after_sec == pytest.approx(0.25)
    assert isinstance(ei.value, LiveGameFull)
    g1.append_round(*_rounds(g1, 1, 45)[0])
    assert g1.query("exact").rounds == 2
    g1.close()


def test_live_game_full_carries_retry_after_sec(scen3):
    game = LiveGame(scen3, max_rounds=1)
    rounds = _rounds(game, 2, 46)
    game.append_round(*rounds[0])
    with pytest.raises(LiveGameFull) as ei:
        game.append_round(*rounds[1])
    assert ei.value.retry_after_sec == 0.0
    game.close()


def test_retry_after_sec_is_nearest_rank_p50():
    for s in (0.4, 0.1, 0.2, 0.3):
        residency.note_restore(s)
        jresidency.note_restore(s)
    assert residency.retry_after_sec() == pytest.approx(0.2) == jresidency.retry_after_sec()
    assert residency.stats()["last_restore_s"] == pytest.approx(0.3)
    assert residency.stats() == jresidency.stats()


# ---------------------------------------------------------------------------
# 3. kill -> restart over a mixed resident/evicted population
# ---------------------------------------------------------------------------

def test_kill_restart_with_mixed_resident_and_evicted_games(tmp_path):
    sc = port_scenario()
    wal_a, wal_b = tmp_path / "a.wal", tmp_path / "b.wal"
    ga = LiveGame(sc, tenant="a", journal_path=wal_a)
    gb = LiveGame(sc, tenant="b", journal_path=wal_b)
    for g, seed in ((ga, 47), (gb, 48)):
        for d, w in _rounds(g, 2, seed):
            g.append_round(d, w)
    ra, rb = ga.query("exact"), gb.query("exact")
    ga.evict()
    ga.close()
    gb.close()
    residency.reset()
    sc2 = port_scenario()
    ga2 = LiveGame(sc2, tenant="a", journal_path=wal_a)
    gb2 = LiveGame(sc2, tenant="b", journal_path=wal_b)
    assert ga2.rounds_resident == 2 and gb2.rounds_resident == 2
    assert ga2.query("exact").scores.tobytes() == ra.scores.tobytes()
    assert gb2.query("exact").scores.tobytes() == rb.scores.tobytes()
    ga2.close()
    gb2.close()


def test_residency_cap_env_knob(scen3, tmp_path, monkeypatch):
    monkeypatch.setenv("MPLC_TORCH_LIVE_MAX_RESIDENT", "1")
    assert residency.max_resident() == 1
    g1 = LiveGame(scen3, journal_path=tmp_path / "e1.wal")
    g1.append_round(*_rounds(g1, 1, 49)[0])
    g2 = LiveGame(scen3, journal_path=tmp_path / "e2.wal")
    assert g2.resident and not g1.resident
    residency.configure(0)
    assert residency.max_resident() == 0
    g1.close()
    g2.close()


def test_torn_tail_restores_the_good_rounds(scen3, tmp_path):
    wal = tmp_path / "wal.jsonl"
    game = LiveGame(scen3, journal_path=wal)
    for d, w in _rounds(game, 2, 50):
        game.append_round(d, w)
    want = game.query("exact")
    game.close()
    wal.write_bytes(wal.read_bytes() + b'{"sha256": "ab", "rec": {"type": "live_ro')
    with pytest.warns(UserWarning, match="torn record"):
        again = LiveGame(port_scenario(), journal_path=wal)
    assert (tmp_path / "wal.jsonl.torn").exists() and again.rounds_resident == 2
    assert again.query("exact").scores.tobytes() == want.scores.tobytes()
    again.close()


# ---------------------------------------------------------------------------
# 4. the WAL's encoding, byte for byte
# ---------------------------------------------------------------------------

MODELS = {"titanic": (jzoo.TITANIC_LOGREG, tzoo.TITANIC_LOGREG),
          "mnist": (jzoo.MNIST_CNN, tzoo.MNIST_CNN),
          "cifar10": (jzoo.CIFAR10_CNN, tzoo.CIFAR10_CNN),
          "imdb": (jzoo.IMDB_CONV1D, tzoo.IMDB_CONV1D),
          "esc50": (jzoo.ESC50_CNN, tzoo.ESC50_CNN)}


def _reversed(tree):
    """The same dict with its keys inserted in reverse order at every level."""
    if isinstance(tree, dict):
        return {k: _reversed(tree[k]) for k in reversed(list(tree))}
    return tree


@pytest.mark.parametrize("name", sorted(MODELS))
def test_round_encoding_is_the_jax_packages(name):
    """JAX params converted to the port's {layer: {name: tensor}}, keys in
    any order: the port's `_encode_tree` JSON equals JAX's `_encode_tree`
    JSON byte for byte; decoding it rebuilds the same tensors; the port's
    own model has the JAX model's leaves (names, shapes, dtypes)."""
    jmodel, tmodel = MODELS[name]
    jparams = jmodel.init(jax.random.PRNGKey(7))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    want = json.dumps(jgame_mod._encode_tree(jparams))
    ported = _reversed(params_from_numpy(np_params))
    assert json.dumps(game_mod._encode_tree(ported)) == want
    if name in ("titanic", "esc50"):
        # a [P, ...] round stack too (the small models: JSON of millions of
        # floats costs seconds)
        stack = jax.tree_util.tree_map(lambda a: np.stack([a, -a]), np_params)
        assert json.dumps(game_mod._encode_tree(_reversed(stack))) == \
            json.dumps(jgame_mod._encode_tree(stack))
    like = {g: {k: t.numpy() for k, t in d.items()}
            for g, d in tmodel.init(torch.Generator().manual_seed(0)).items()}
    back = game_mod._decode_tree(json.loads(want), like)
    assert list(back) == list(like) and all(list(back[g]) == list(like[g]) for g in like)
    for g, d in back.items():
        for k, a in d.items():
            assert a.dtype == np.float32 and a.tobytes() == np_params[g][k].tobytes()
    assert [e[:2] for e in game_mod._encode_tree(like)] == \
        [e[:2] for e in jgame_mod._encode_tree(jparams)]


def test_a_port_wal_is_the_jax_wal_byte_for_byte(tmp_path):
    """A JAX game and the port game restored from a copy of its WAL (its
    `live_init` record) append the same rounds: the two files are equal
    byte for byte."""
    jwal, twal = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jg = JLiveGame(build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True, **GAME),
                   journal_path=str(jwal))
    shutil.copy(jwal, twal)
    tg = LiveGame(port_scenario(), journal_path=twal)
    rounds = synth_rounds(tg._init_params, 3, 3, seed=51)
    for d, w in rounds[:2]:
        assert jg.append_round(d, w) == tg.append_round(d, w)
    assert jg._append_rounds([rounds[2]]) == tg._append_rounds([rounds[2]])
    jg.close()
    tg.close()
    assert twal.read_bytes() == jwal.read_bytes()
