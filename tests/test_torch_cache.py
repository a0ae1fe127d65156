"""The checksummed coalition cache of the PyTorch port and the Scenario's
resume, on the CPU (Titanic, 3 partners): save/load round trips, a resumed
sweep trains nothing, corrupt files are refused and quarantined, caches of
another game (another precision, another reduce, the JAX package's streams)
are refused, and a legacy no-checksum cache is rewritten with a checksum.
"""

import json

import numpy as np
import pytest
import torch

from helpers import build_scenario
from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib import engine as engine_module
from mplc_tpu_torch.contrib.engine import CacheIntegrityError, CharacteristicEngine
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

AMOUNTS = [0.2, 0.3, 0.5]
# the JAX suite's `build_scenario` game (tests/helpers.py)
GAME = dict(epoch_count=4, minibatch_count=2, gradient_updates_per_pass_count=4,
            is_early_stopping=False)
SUBSETS = [(0,), (1,), (0, 1), (0, 1, 2)]


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for name in (constants.PRECISION_ENV, constants.DETERMINISTIC_REDUCE_ENV,
                 constants.NO_SLOTS_ENV, constants.SLOT_MERGE_ENV, constants.SLOT_POW2_ENV,
                 "MPLC_TPU_PRECISION", "MPLC_TPU_DETERMINISTIC_REDUCE"):
        monkeypatch.delenv(name, raising=False)


def _engine():
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), seed=3,
                  device="cpu", **GAME)
    sc.instantiate_scenario_partners()
    sc.split_data()
    return CharacteristicEngine(sc)


@pytest.fixture
def saved(tmp_path):
    """(engine with a few values, the path of its saved cache)."""
    eng = _engine()
    eng.evaluate(SUBSETS)
    path = tmp_path / "coalition_cache.json"
    eng.save_cache(path)
    return eng, path


def test_save_load_round_trip(saved):
    eng, path = saved
    assert "payload_sha256" in json.loads(path.read_text())
    fresh = _engine()
    fresh.load_cache(path)
    assert fresh.charac_fct_values == eng.charac_fct_values
    assert fresh.increments_values == eng.increments_values
    assert fresh.first_charac_fct_calls_count == eng.first_charac_fct_calls_count == 4
    # a loaded value is served from the memo: no batch trains
    np.testing.assert_array_equal(fresh.evaluate(SUBSETS), eng.evaluate(SUBSETS))
    assert fresh.batch_log == []


def _shapley_scenario(tmp_path, **kw):
    sc = Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(), seed=3, device="cpu",
                  experiment_path=tmp_path, methods=["Shapley values"], **GAME, **kw)
    sc.run()
    return sc


def test_resumed_scenario_trains_nothing(tmp_path):
    first = _shapley_scenario(tmp_path / "a")
    cache = first.save_folder / "coalition_cache.json"
    assert cache.exists() and len(first._charac_engine.batch_log) == 2
    resumed = _shapley_scenario(tmp_path / "b", contributivity_cache_from=cache)
    eng = resumed._charac_engine
    assert eng.batch_log == []
    assert eng.first_charac_fct_calls_count == 7
    np.testing.assert_array_equal(resumed.contributivity_list[0].contributivity_scores,
                                  first.contributivity_list[0].contributivity_scores)
    # the resumed run saved its own cache, with the same values
    again = _engine()
    again.load_cache(resumed.save_folder / "coalition_cache.json")
    assert again.charac_fct_values == first._charac_engine.charac_fct_values


def _flip_byte(path):
    """One digit of the first value changed: still valid JSON."""
    raw = bytearray(path.read_bytes())
    i = raw.index(b".", raw.index(b'"charac_fct_values"')) + 1
    raw[i] = ord("7") if raw[i] != ord("7") else ord("3")
    path.write_bytes(bytes(raw))


def _truncate(path):
    raw = path.read_bytes()
    path.write_bytes(raw[:len(raw) // 2])


@pytest.mark.parametrize("damage", [_flip_byte, _truncate], ids=["flipped", "truncated"])
def test_corrupt_cache_is_refused_and_quarantined(saved, tmp_path, damage):
    _, path = saved
    damage(path)
    with pytest.raises(CacheIntegrityError):
        _engine().load_cache(path)
    sc = _shapley_scenario(tmp_path / "run", contributivity_cache_from=path)
    assert not path.exists()
    assert path.with_name(path.name + ".corrupt").exists()
    # cold start: the whole sweep trained
    assert [b["coalitions"] for b in sc._charac_engine.batch_log] == [3, 4]


@pytest.mark.parametrize("env,value,key", [
    (constants.PRECISION_ENV, "bf16", "precision"),
    (constants.DETERMINISTIC_REDUCE_ENV, "1", "deterministic_reduce")])
def test_fingerprint_mismatch_is_refused(saved, monkeypatch, env, value, key):
    _, path = saved
    monkeypatch.setenv(env, value)
    other = _engine()
    with pytest.raises(ValueError, match=key) as info:
        other.load_cache(path)
    assert not isinstance(info.value, CacheIntegrityError)
    assert other.charac_fct_values == {(): 0.0}


def test_fingerprint_mismatch_still_raises_in_scenario(saved, tmp_path, monkeypatch):
    _, path = saved
    monkeypatch.setenv(constants.PRECISION_ENV, "mixed")
    with pytest.raises(ValueError, match="precision"):
        _shapley_scenario(tmp_path / "run", contributivity_cache_from=path)
    assert path.exists()


def test_legacy_cache_warns_once_and_is_rewritten(saved, monkeypatch):
    eng, path = saved
    doc = json.loads(path.read_text())
    del doc["payload_sha256"]
    path.write_text(json.dumps(doc))
    monkeypatch.setattr(engine_module, "_legacy_cache_warned", False)
    fresh = _engine()
    with pytest.warns(DeprecationWarning, match="predates the checksum"):
        fresh.load_cache(path)
    assert fresh.charac_fct_values == eng.charac_fct_values
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        _engine().load_cache(path)                      # once a process
    # every value is memoized: evaluate trains nothing, yet rewrites the
    # legacy file with its checksum
    fresh.autosave_path = path.with_name("elsewhere.json")
    fresh.evaluate(SUBSETS)
    assert fresh.batch_log == []
    assert "payload_sha256" in json.loads(path.read_text())
    _engine().load_cache(path)


def test_cache_of_the_jax_package_is_refused(tmp_path):
    """A cache the JAX engine wrote for the same Titanic game agrees on every
    fingerprint key, the data digest included, but its coalitions drew
    threefry streams: the port refuses it."""
    jsc = build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True)
    jeng = JEngine(jsc)
    path = tmp_path / "jax_cache.json"
    jeng.save_cache(path)
    eng = _engine()
    theirs, ours = jeng._fingerprint(), eng._fingerprint()
    assert ours.pop("rng_streams") == engine_module.RNG_STREAMS
    assert theirs == ours
    with pytest.raises(ValueError, match="rng_streams"):
        eng.load_cache(path)


def test_scenario_writes_nothing_in_a_dry_run(tmp_path):
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), seed=3,
                  device="cpu", experiment_path=tmp_path, methods=["Independent scores"],
                  **GAME)
    sc.run()
    assert sc._charac_engine.autosave_path is None
    assert list(tmp_path.iterdir()) == []
    assert sorted(sc._charac_engine.charac_fct_values) == [(), (0,), (1,), (2,)]
