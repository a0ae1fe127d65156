"""The port's hierarchical Shapley (`mplc_tpu_torch/live/hierarchy.py`)
against the JAX package's (`mplc_tpu/live/hierarchy.py`), on the CPU: the
clustering, the cluster-count and tail-tau resolution (their knobs
included), the planner's cost model and `hierarchical_shapley` on a
callable game all equal the JAX package's exactly; and a port live game
answers hierarchical queries with efficiency and replays its auto plan."""

import numpy as np
import pytest
import torch

from mplc_tpu.live import hierarchy as jhier
from mplc_tpu_torch.live import hierarchy as hier

torch.set_num_threads(1)


class SyntheticEv:
    """A game with the batched `evaluate(subsets)` surface: v(S) = the sum
    of its members' worths + synergy * C(|S|, 2)."""

    def __init__(self, worth, synergy=0.0):
        self.worth = np.asarray(worth, float)
        self.synergy = float(synergy)
        self.calls = []

    def evaluate(self, subsets):
        subsets = list(subsets)
        self.calls.append(subsets)
        return np.array([self.worth[list(s)].sum()
                         + self.synergy * (len(s) * (len(s) - 1)) / 2.0 for s in subsets])


def _scores(P, seed, ties=False):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 5, P)
    if ties:
        s = np.round(s)
    return s


@pytest.mark.parametrize("tau", [0.0, 0.1, 0.3, 0.9])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("P", [1, 4, 8, 17, 40])
def test_cluster_partners_equals_jax(P, k, tau):
    for seed, ties in ((P, False), (P + 1, True)):
        s = _scores(P, seed, ties)
        assert hier.cluster_partners(s, k, tau) == jhier.cluster_partners(s, k, tau)


def test_cluster_partners_edge_cases_equal_jax():
    assert hier.cluster_partners([], 3) == jhier.cluster_partners([], 3) == ()
    assert hier.cluster_partners(np.zeros(5), 2, 0.5) == jhier.cluster_partners(np.zeros(5), 2, 0.5)
    for bad in (0, hier.MAX_CLUSTERS + 1):
        with pytest.raises(ValueError):
            hier.cluster_partners(np.ones(4), bad)
        with pytest.raises(ValueError):
            jhier.cluster_partners(np.ones(4), bad)


@pytest.mark.parametrize("P", [1, 2, 3, 5, 10, 17, 20, 33, 100, 257, 10_000])
def test_default_and_resolved_clusters_equal_jax(P):
    assert hier.default_clusters(P) == jhier.default_clusters(P)
    assert hier.resolve_clusters(P) == jhier.resolve_clusters(P)
    for k in (1, 4, 16):
        assert hier.resolve_clusters(P, k) == jhier.resolve_clusters(P, k) == k
    for bad in (0, 17):
        with pytest.raises(ValueError, match="exact"):
            hier.resolve_clusters(P, bad)


@pytest.mark.parametrize("k", list(range(1, 17)))
@pytest.mark.parametrize("P", [1, 3, 12, 17, 20, 33, 100])
def test_estimate_evaluations_equals_jax(P, k):
    assert hier.estimate_evaluations(P, k) == jhier.estimate_evaluations(P, k)


@pytest.mark.parametrize("value,warns,want", [("40", "clamped", 16), ("7", None, 7),
                                              ("0", None, None), ("x", "non-negative", None)])
def test_cluster_knob_equals_jax(monkeypatch, value, warns, want):
    monkeypatch.setenv("MPLC_TORCH_LIVE_CLUSTERS", value)
    monkeypatch.setenv("MPLC_TPU_LIVE_CLUSTERS", value)
    for mod in (hier, jhier):
        if warns:
            with pytest.warns(UserWarning, match=warns):
                got = mod.resolve_clusters(100)
        else:
            got = mod.resolve_clusters(100)
        assert got == (want if want is not None else mod.default_clusters(100))


@pytest.mark.parametrize("value,warns,want", [("1.5", "outside", 0.0), ("0.2", None, 0.2),
                                              ("-1", "non-negative", 0.0)])
def test_cluster_tau_knob_equals_jax(monkeypatch, value, warns, want):
    monkeypatch.setenv("MPLC_TORCH_LIVE_CLUSTER_TAU", value)
    monkeypatch.setenv("MPLC_TPU_LIVE_CLUSTER_TAU", value)
    for mod in (hier, jhier):
        if warns:
            with pytest.warns(UserWarning, match=warns):
                assert mod.resolve_cluster_tau() == want
        else:
            assert mod.resolve_cluster_tau() == want
        assert mod.resolve_cluster_tau(0.3) == 0.3
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            mod.resolve_cluster_tau(2.0)


@pytest.mark.parametrize("tau", [0.0, 0.4])
@pytest.mark.parametrize("synergy", [0.0, 0.03, -0.01])
@pytest.mark.parametrize("P,k", [(3, 2), (12, 4), (20, 5), (30, 2), (40, 6)])
def test_hierarchical_shapley_equals_jax(P, k, synergy, tau):
    """Both splits (exact intra subgames up to 12 members, proportional
    past them), with and without a tail cluster: the same scores to the
    bit, the same detail, the same coalitions requested in one call."""
    rng = np.random.default_rng(P * 7 + k)
    worth, info = rng.uniform(0.0, 1.0, P), rng.uniform(0.0, 1.0, P)
    ev, jev = SyntheticEv(worth, synergy), SyntheticEv(worth, synergy)
    scores, detail = hier.hierarchical_shapley(ev, P, info, clusters=k, cluster_tau=tau)
    jscores, jdetail = jhier.hierarchical_shapley(jev, P, info, clusters=k, cluster_tau=tau)
    assert scores.tobytes() == jscores.tobytes()
    assert detail == jdetail
    assert ev.calls == jev.calls and len(ev.calls) == 1
    grand = float(ev.evaluate([tuple(range(P))])[0])
    assert np.isclose(scores.sum(), grand, atol=1e-8)


def test_additive_game_recovers_exact_shapley():
    rng = np.random.default_rng(5)
    worth = rng.uniform(0.1, 1.0, 30)
    scores, detail = hier.hierarchical_shapley(SyntheticEv(worth), 30, worth, clusters=2)
    np.testing.assert_allclose(scores, worth, atol=1e-9)
    assert detail["proportional_splits"] == 2 and detail["coalitions_evaluated"] == 3
    worth20, info = rng.uniform(0.1, 1.0, 20), rng.uniform(0.1, 1.0, 20)
    scores20, detail20 = hier.hierarchical_shapley(SyntheticEv(worth20), 20, info, clusters=5)
    np.testing.assert_allclose(scores20, worth20, atol=1e-9)
    assert detail20["exact_splits"] == 5
    # all-zero info: the proportional split gives equal shares
    scores, _ = hier.hierarchical_shapley(SyntheticEv(worth, 0.03), 30, np.zeros(30), clusters=2)
    assert np.isclose(scores.sum(), SyntheticEv(worth, 0.03).evaluate([tuple(range(30))])[0])
