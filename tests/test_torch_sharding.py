"""The engine over several ranks (`mplc_tpu_torch/contrib/engine.py` on
`parallel/mesh.py`): the 2-D [coal, part] mode, the 1-D coalition sharding
and the ladder's agreement, in worlds of gloo ranks on the CPU, held to
the engine on a world of 1 (tests/test_sharding.py's oracles):

(a) tests/test_sharding.py's 4-partner Titanic game at [2 coal x 2 part]
    under the deterministic reduce: the v(S) table bit-equal, on every
    rank, to the world of 1, within 1e-4 of the default (slot) engine,
    and discriminating (max - min > 1e-3); the ledger meta says "2d", 2
    shards, 4 devices;
(b) MPLC_TORCH_PARTNER_SHARDS=3 raises "must divide" (the JAX message),
    and a malformed or zero value raises;
(c) the Scenario parameter: `Scenario(partner_shards=2)` builds, raises
    "must divide" at a world of 1, runs in a world of 4 and records 2 in
    `to_dataframe()`; the knob wins over it;
(d) lflip at [2 x 2] bit-equal to the world of 1;
(e) the 2-D mode's singletons on partner slices bit-equal to the 1-D
    single trainer's, and the 2-D pipeline at one partner shard
    (MPLC_TORCH_PARTNER_SHARDS=1) bit-equal to the 1-D masked route, the
    port's route there;
(f) the 1-D coalition sharding of the default engine over 2 ranks
    bit-equal to one rank, also when the ranks' caps differ (each rank's
    cap is its own card's measure): they bucket at the least;
(g) an OOM on one rank of a [1 x 2] world, one halving allowed, injected
    at its dispatch or raised from inside a partner-sharded training's
    round: every rank ends with LadderExhaustedError(mode="2d"), well
    inside the spawn's time limit;
(h) the CLI launched on 2 ranks with `partner_shards: [2]` in its grid:
    both ranks exit 0, rank 0 alone writes the experiment folder, and its
    results.csv records the 2 partner shards that ran.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_dist_helpers as h
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib import engine as tengine
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.parallel import launch

torch.set_num_threads(1)

DET, SHARDS = constants.DETERMINISTIC_REDUCE_ENV, constants.PARTNER_SHARDS_ENV


@pytest.fixture
def knobs(monkeypatch):
    """The engine knobs unset, and restored after the test."""
    for k in h.KNOBS:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    env = {"MPLC_TORCH_FLIGHT_RECORDER_DIR": str(tmp_path_factory.mktemp("flight4"))}
    return launch.spawn("torch_dist_helpers:sharding_rank_4", 4, env=env, timeout=90)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    env = {"MPLC_TORCH_FLIGHT_RECORDER_DIR": str(tmp_path_factory.mktemp("flight2")),
           constants.RETRY_BACKOFF_ENV: "0"}
    return launch.spawn("torch_dist_helpers:sharding_rank_2", 2, env=env, timeout=90)


def test_engine_2d_bit_equal_to_world_of_one(world4, knobs):
    ref = h.engine_values({DET: "1"})
    default = h.engine_values({})
    assert ref["layout"] == [1, 1] and ref["slot_bucketing"] == "masked"
    assert default["slot_bucketing"] == "merge"
    for res in world4:
        got = res["det2d"]
        assert got["layout"] == [2, 2] and got["slot_bucketing"] == "masked"
        assert {"single", "multi"} <= set(got["kinds"])
        np.testing.assert_array_equal(got["values"], ref["values"])
        assert {k: got["meta"][k] for k in ("topology", "part_shards", "n_devices")} == \
            {"topology": "2d", "part_shards": 2, "n_devices": 4}
    np.testing.assert_allclose(ref["values"], default["values"], rtol=0, atol=1e-4)
    assert ref["values"].max() - ref["values"].min() > 1e-3


def test_indivisible_or_malformed_shards_raise(knobs, monkeypatch):
    monkeypatch.setenv(SHARDS, "3")
    with pytest.raises(ValueError, match="must divide both the partner count"):
        CharacteristicEngine(h.titanic_scenario())
    for bad in ("0", "two"):
        monkeypatch.setenv(SHARDS, bad)
        with pytest.raises(ValueError, match="must be an integer >= 1"):
            CharacteristicEngine(h.titanic_scenario())
    # a partner-parallel approach only
    monkeypatch.setenv(SHARDS, "2")
    with pytest.raises(ValueError, match="partner-parallel approach"):
        CharacteristicEngine(h.titanic_scenario(multi_partner_learning_approach="seqavg"))


def test_scenario_parameter_route(world4, knobs, monkeypatch):
    sc = h.titanic_scenario(partner_shards=2)
    assert sc.partner_shards == 2
    with pytest.raises(ValueError, match="must divide both the partner count \\(4\\) and "
                                         "the device count \\(1\\)"):
        CharacteristicEngine(sc)
    # the knob wins over the parameter, and the value that ran is recorded
    monkeypatch.setenv(SHARDS, "1")
    sc = h.titanic_scenario(partner_shards=2)
    eng = CharacteristicEngine(sc)
    assert eng._pipe2d is None and sc.partner_shards == 1
    scores = [res["scenario"]["scores"] for res in world4]
    for res in world4:
        assert res["scenario"]["partner_shards"] == [2]
        assert res["scenario"]["part_shards"] == 2
    assert all(s == scores[0] for s in scores) and np.isfinite(scores[0]).all()


def test_engine_2d_lflip_bit_equal(world4, knobs):
    ref = h.engine_values({DET: "1"}, lflip=True)
    assert ref["values"].max() - ref["values"].min() > 1e-3
    for res in world4:
        assert res["lflip2d"]["layout"] == [2, 2]
        np.testing.assert_array_equal(res["lflip2d"]["values"], ref["values"])


def test_singles_on_partner_slices_match_the_single_trainer(knobs, monkeypatch):
    singles = [(i,) for i in range(4)]
    monkeypatch.setenv(DET, "1")
    want = CharacteristicEngine(h.titanic_scenario()).evaluate(singles)
    monkeypatch.setenv(SHARDS, "1")
    eng = CharacteristicEngine(h.titanic_scenario())
    seen = []
    real = tengine.SlicedSinglesPipeline.dispatch_async

    def spy(self, coal, generators, stacked, *a, **kw):
        seen.append((tuple(coal.shape), stacked.partners_count))
        return real(self, coal, generators, stacked, *a, **kw)
    monkeypatch.setattr(tengine.SlicedSinglesPipeline, "dispatch_async", spy)
    np.testing.assert_array_equal(eng.evaluate(singles), want)
    # one batch of the 4 singles, their 4 partners' rows
    assert seen == [((4, 4), 4)] and [b["kind"] for b in eng.batch_log] == ["single"]


def test_2d_pipeline_at_one_shard_equals_the_1d_masked_route(knobs, monkeypatch):
    """The port's choice: under the deterministic reduce it keeps the 1-D
    masked route at one partner shard (the JAX engine takes its 2-D
    pipeline there); MPLC_TORCH_PARTNER_SHARDS=1 takes the 2-D pipeline,
    with the same bits, and its ledger meta says so."""
    subsets = powerset_order(4)
    masked = h.engine_values({DET: "1"})
    two_d = h.engine_values({DET: "1", SHARDS: "1"})
    assert masked["meta"]["topology"] == "1d" and two_d["layout"] == [1, 1]
    assert {k: two_d["meta"][k] for k in ("topology", "part_shards", "n_devices")} == \
        {"topology": "2d", "part_shards": 1, "n_devices": 1}
    np.testing.assert_array_equal(two_d["values"], masked["values"])
    assert len(two_d["values"]) == len(subsets)
    # without the deterministic reduce the knob at 1 keeps the 1-D route
    assert h.engine_values({SHARDS: "1"})["meta"]["topology"] == "1d"


def test_1d_coalition_sharding_over_two_ranks(world2, knobs):
    ref = h.engine_values({})
    for res in world2:
        got = res["coal1d"]
        assert got["layout"] == [2, 1] and got["meta"]["n_devices"] == 2
        assert got["meta"]["topology"] == "1d" and got["slot_bucketing"] == "merge"
        np.testing.assert_array_equal(got["values"], ref["values"])


def test_ranks_with_different_caps_bucket_at_the_least(world2, knobs):
    ref = h.engine_values({constants.COALITIONS_PER_DEVICE_ENV: "2"})
    first, second = (res["caps"] for res in world2)
    # 2 coalitions a rank: every bucket 4 wide (or less) on both ranks
    assert first["widths"] == second["widths"] and max(first["widths"]) == 4
    for got in (first, second):
        np.testing.assert_array_equal(got["values"], ref["values"])


def test_oom_on_one_rank_ends_every_rank_on_the_2d_ladder(world2):
    assert [res["oom"] for res in world2] == [("LadderExhaustedError", "2d", 2)] * 2


def test_oom_inside_a_round_on_one_rank_ends_every_rank_on_the_2d_ladder(world2):
    """The failed rank reports at its row's next agreement point, where its
    peer waits before the round's aggregation, so neither waits in a
    collective (the spawn's 90 s limit, against the groups' 300 s)."""
    assert [res["oom_in_round"] for res in world2] == [("LadderExhaustedError", "2d", 2)] * 2
    # rank 1's second round failed, and its retry's first
    assert [res["rounds"] for res in world2] == [0, 3]


def test_cli_on_two_ranks_writes_once(tmp_path):
    assert launch.spawn("torch_dist_helpers:cli_rank", 2, (str(tmp_path),), timeout=90) == [0, 0]
    # one experiment folder, rank 0's, with one scenario folder
    assert [p.name.startswith("ranks_") for p in (tmp_path / "experiments").iterdir()] == [True]
    results = list((tmp_path / "experiments").glob("*/results.csv"))
    assert len(results) == 1
    assert len([p for p in results[0].parent.iterdir() if p.is_dir()]) == 1
    df = pd.read_csv(results[0])
    assert set(df["partner_shards"]) == {2} and len(df) == 4
    assert np.isfinite(df["contributivity_score"]).all()
