"""The port's query planner (`mplc_tpu_torch/contrib/planner.py`) against the
JAX package's (`mplc_tpu/contrib/planner.py`), on the CPU: `plan_query`
over a grid of game sizes, accuracy targets and deadlines must describe
the same plan key for key, its live rungs (hierarchical, pruned GTG)
included; and `compute_contributivity("auto")` on an analytic game routes
and scores as the JAX one does, bit for bit."""

import json

import numpy as np
import pytest

from mplc_tpu.contrib import planner as jplanner
from mplc_tpu.contrib.contributivity import Contributivity as JContributivity
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib import planner
from mplc_tpu_torch.contrib.contributivity import Contributivity

from test_torch_estimators import GAMES, jax_scenario, port_scenario

PARTNERS = (3, 10, 17, 20)
TARGETS = (None, 0.005, 0.02, 0.1)
DEADLINES = (None, 60.0, 50.5, 20.0, 5.0)


@pytest.mark.parametrize("deadline", DEADLINES)
@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("n", PARTNERS)
def test_plan_query_describes_the_jax_plan(n, target, deadline):
    p = planner.plan_query(n, target, deadline)
    jp = jplanner.plan_query(n, target, deadline, live=False)
    assert p.describe() == jp.describe()
    assert planner.plan_from_dict(json.loads(json.dumps(p.describe()))) == p


@pytest.mark.parametrize("eval_sec", [0.001, 0.05, 0.5])
def test_plan_query_with_an_eval_cost_matches_jax(eval_sec):
    for n in (4, 10, 16, 17):
        for deadline in (None, 1.0, 30.0, 400.0):
            kw = dict(eval_sec=eval_sec, cost_basis="default")
            assert planner.plan_query(n, 0.02, deadline, **kw).describe() == \
                jplanner.plan_query(n, 0.02, deadline, live=False, **kw).describe()


def test_the_ten_partner_rungs():
    """The routes `chip_smoke.py`'s `[svarm]` phase gates at 10 partners."""
    assert planner.plan_query(10).method == "exact"
    p = planner.plan_query(10, deadline_sec=20)
    assert (p.method, p.method_kw) == ("SVARM", {"budget": 300})
    assert planner.estimate_eval_seconds(None) == (0.05, "default")
    assert planner.DEFAULT_EVAL_SEC == jplanner.DEFAULT_EVAL_SEC


def test_planner_knobs_match_jax(monkeypatch):
    for torch_env, jax_env, value in (
            (constants.PLANNER_ACCURACY_ENV, "MPLC_TPU_PLANNER_ACCURACY", "0.07"),
            (constants.PLANNER_DEADLINE_ENV, "MPLC_TPU_PLANNER_DEADLINE_SEC", "20")):
        monkeypatch.setenv(torch_env, value)
        monkeypatch.setenv(jax_env, value)
    p, jp = planner.plan_query(10), jplanner.plan_query(10, live=False)
    assert p.describe() == jp.describe()
    assert p.accuracy_target == 0.07 and p.deadline_sec == 20.0


@pytest.mark.parametrize("eval_sec", [None, 0.001, 0.5])
@pytest.mark.parametrize("deadline", [None, 1e-6, 0.5, 5.0, 60.0, 3600.0])
@pytest.mark.parametrize("n", [3, 10, 17, 33, 100])
def test_live_rungs_describe_the_jax_plan(n, deadline, eval_sec):
    """The live planner (hierarchical past 16 partners, pruned GTG last)
    describes the JAX package's plan key for key."""
    kw = {} if eval_sec is None else dict(eval_sec=eval_sec, cost_basis="meter")
    p = planner.plan_query(n, 0.02, deadline, live=True, **kw)
    jp = jplanner.plan_query(n, 0.02, deadline, live=True, **kw)
    assert p.describe() == jp.describe()
    assert planner.plan_from_dict(json.loads(json.dumps(p.describe()))) == p


@pytest.mark.parametrize("n,clusters,tau,prune", [(33, "7", "0.2", "0.3"), (100, "40", "0", "0"),
                                                  (20, "0", "0.1", "2.5")])
def test_live_rung_knobs_match_jax(monkeypatch, n, clusters, tau, prune):
    for name, value in (("LIVE_CLUSTERS", clusters), ("LIVE_CLUSTER_TAU", tau),
                        ("LIVE_PRUNE_TAU", prune)):
        monkeypatch.setenv(f"MPLC_TORCH_{name}", value)
        monkeypatch.setenv(f"MPLC_TPU_{name}", value)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for deadline in (None, 1e-6):
            assert planner.plan_query(n, live=True, deadline_sec=deadline).describe() == \
                jplanner.plan_query(n, live=True, deadline_sec=deadline).describe()


def test_bad_game_size_raises():
    with pytest.raises(ValueError):
        planner.plan_query(0)


@pytest.mark.parametrize("deadline", [None, 5.0, 0.5, 1e-6])
@pytest.mark.parametrize("game", GAMES)
def test_auto_routes_and_scores_as_jax(game, deadline):
    fn = GAMES[game]
    c, jc = Contributivity(port_scenario(5, fn)), JContributivity(jax_scenario(5, fn))
    c.compute_contributivity("auto", deadline_sec=deadline)
    jc.compute_contributivity("auto", deadline_sec=deadline)
    assert c.plan.describe() == jc.plan.describe()
    assert c.name == jc.name
    assert c.contributivity_scores.tobytes() == jc.contributivity_scores.tobytes()
    assert c.scores_std.tobytes() == jc.scores_std.tobytes()
    assert c.trust == jc.trust
    rc, jrc = c.engine._reconstruction, jc.engine._reconstruction
    assert rc.reconstructions == jrc.reconstructions
    # retrain-free: the engine trained nothing
    assert c.engine.batch_log == [] and c.batches_trained == []
    if deadline is None:
        assert c.plan.method == "exact"
        np.testing.assert_array_equal(c.scores_std, 0.0)


def test_auto_past_the_exact_wall_routes_gtg_as_jax():
    phi = [0.01 * (i + 1) for i in range(17)]
    fn = lambda s: sum(phi[i] for i in s)  # noqa: E731
    c, jc = Contributivity(port_scenario(17, fn)), JContributivity(jax_scenario(17, fn))
    c.compute_contributivity("auto")
    jc.compute_contributivity("auto")
    assert c.plan.method == "GTG-Shapley"
    assert c.plan.describe() == jc.plan.describe()
    assert c.contributivity_scores.tobytes() == jc.contributivity_scores.tobytes()
    assert c.scores_std.tobytes() == jc.scores_std.tobytes()
    np.testing.assert_allclose(c.contributivity_scores, phi, atol=0.01)
