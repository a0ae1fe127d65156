"""The port's sampling Shapley estimators against the JAX package's, on the
CPU.

1. Analytic games (the additive and the saturating game of
   tests/test_estimator_regression.py) through one fake engine per
   package, both storing coalitions in the real engines' order (singles,
   then multis by merged slot width): TMCS, ITMCS, IS_lin_S, IS_reg_S,
   AIS_Kriging_S, SMCS, WR_SMC and SVARM (over a closed-form
   reconstructor) give bit-equal scores, std and call counts. The port's
   fake runs the port's own `CharacteristicEngine.evaluate`, so its memo
   and deduplication are the ones under test.
2. The pieces: the IS_reg fallback to exact Shapley below 4 partners, the
   SVARM trust row, `KrigingModel`, and the least-squares fit that
   replaces scikit-learn's `LinearRegression` (bit-equal to it).
3. The slice: a Titanic 5-partner `Scenario.run()` of the port with the
   seven estimators and "Shapley values", its trained v(S) table replayed
   through the JAX estimators (bit-equal scores and per-method call
   counts, every estimator within 0.05 of exact); then a tiny MNIST CNN
   retrain-free game, the port's SVARM and "auto" against the JAX ones
   over the port's reconstructed table.
"""

import numpy as np
import pytest
import torch
from sklearn.linear_model import LinearRegression

from mplc_tpu.contrib.contributivity import Contributivity as JContributivity
from mplc_tpu.contrib.contributivity import KrigingModel as JKrigingModel
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib import contributivity as tcontrib
from mplc_tpu_torch.contrib.contributivity import Contributivity, KrigingModel
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order, shapley_from_characteristic
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.scenario import Scenario

from test_contrib import FakeEngine as JFakeEngine, fake_scenario as jfake_scenario
from test_torch_slice import _tiny_mnist

torch.set_num_threads(1)

# the estimators under test: registry name -> (method, kwargs for the
# analytic games)
METHODS = {
    "TMCS": ("truncated_MC", dict(sv_accuracy=0.05, alpha=0.9, truncation=0.05)),
    "ITMCS": ("interpol_TMC", dict(sv_accuracy=0.05, alpha=0.9, truncation=0.3)),
    "IS_lin_S": ("IS_lin", dict(sv_accuracy=0.05, alpha=0.95)),
    "IS_reg_S": ("IS_reg", dict(sv_accuracy=0.05, alpha=0.95)),
    "AIS_Kriging_S": ("AIS_Kriging", dict(sv_accuracy=0.05, alpha=0.95, update=50)),
    "SMCS": ("Stratified_MC", dict(sv_accuracy=0.05, alpha=0.95)),
    "WR_SMC": ("without_replacment_SMC", dict(sv_accuracy=0.05, alpha=0.95)),
}
ESTIMATORS = list(METHODS)

PHI5 = [0.05, 0.1, 0.15, 0.3, 0.4]


def additive(phi):
    return lambda s: sum(phi[i] for i in s)


def saturating(phi, lift=1.3):
    """v(S) = min(1, lift * sum phi_i): permutation-dependent marginals, so
    truncation fires mid-permutation and stratum variances differ."""
    return lambda s: min(1.0, lift * sum(phi[i] for i in s))


GAMES = {"additive": additive(PHI5), "saturating": saturating(PHI5)}


class JEngineOrderFake(JFakeEngine):
    """The JAX package's test fake, storing a request's new coalitions in
    the JAX engine's order: singles, then multis grouped by merged slot
    width, widths ascending (the engine's own `_slot_buckets`)."""

    _slot_pow2 = False
    _slot_merge = True

    def evaluate(self, subsets):
        keys = [tuple(sorted(int(i) for i in s)) for s in subsets]
        missing = [k for k in dict.fromkeys(keys) if k not in self.charac_fct_values]
        self._run_batch([k for k in missing if len(k) == 1])
        for _, group in self._slot_buckets([k for k in missing if len(k) > 1]):
            self._run_batch(group)
        return np.array([self.charac_fct_values[k] for k in keys])


class TFakeEngine(CharacteristicEngine):
    """The port's engine with training replaced by a closed-form v(S): its
    own `evaluate` (memo, deduplication, singles then merged slot buckets)
    over a `_run_batch` that stores `value_fn(S)` and logs the batch."""

    def __init__(self, n, value_fn):
        self.partners_count = n
        self.value_fn = value_fn
        self.seed = 0
        self.charac_fct_values = {(): 0.0}
        self.increments_values = [dict() for _ in range(n)]
        self.first_charac_fct_calls_count = 0
        self.batch_log = []
        self.single_pipe = self.multi_pipe = None
        self._use_slots, self._slot_merge, self._slot_pow2 = True, True, False
        self._cache_needs_upgrade = False
        self.autosave_path = None

    def _slot_pipe(self, k):
        return None

    def _run_batch(self, subsets, pipe, slot_count=None):
        for s in subsets:
            self._store(s, float(self.value_fn(s)))
        self.batch_log.append({"kind": "single" if pipe is self.single_pipe else "multi",
                               "slot_count": slot_count, "coalitions": len(subsets)})


class StubRecon:
    """A closed-form reconstructed game: the `engine._reconstruction` seam
    of both packages. `reconstructions` counts the distinct coalitions
    valued, as the port's evaluator does."""

    def __init__(self, fn):
        self.values = {(): 0.0}
        self._fn = fn
        self.reconstructions = 0

    def evaluate(self, subsets):
        keys = [tuple(sorted(int(i) for i in s)) for s in subsets]
        for k in dict.fromkeys(keys):
            if k not in self.values:
                self.values[k] = float(self._fn(k))
                self.reconstructions += 1
        return np.array([self.values[k] for k in keys])


def jax_scenario(n, fn, sizes=None, seed=0):
    sc = jfake_scenario(n, fn, sizes)
    sc.seed = seed
    sc._charac_engine = JEngineOrderFake(n, fn)
    sc._charac_engine._reconstruction = StubRecon(fn)
    return sc


def port_scenario(n, fn, sizes=None, seed=0):
    sc = jfake_scenario(n, fn, sizes)
    sc.seed = seed
    sc._charac_engine = TFakeEngine(n, fn)
    sc._charac_engine._reconstruction = StubRecon(fn)
    return sc


def _bits(x):
    return np.asarray(x, np.float64).tobytes()


def assert_same_result(c, jc):
    assert c.name == jc.name
    assert _bits(c.contributivity_scores) == _bits(jc.contributivity_scores), (
        c.contributivity_scores - jc.contributivity_scores)
    assert _bits(c.scores_std) == _bits(jc.scores_std)
    assert _bits(c.normalized_scores) == _bits(jc.normalized_scores)
    assert c.first_charac_fct_calls_count == jc.first_charac_fct_calls_count


# ---------------------------------------------------------------------------
# 1. analytic games
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("game", GAMES)
@pytest.mark.parametrize("name", ESTIMATORS)
def test_estimator_matches_jax_on_analytic_game(name, game):
    method, kw = METHODS[name]
    fn = GAMES[game]
    c, jc = Contributivity(port_scenario(5, fn)), JContributivity(jax_scenario(5, fn))
    getattr(c, method)(**kw)
    getattr(jc, method)(**kw)
    assert_same_result(c, jc)
    assert c.first_charac_fct_calls_count <= 31
    assert c._rng.bit_generator.state == jc._rng.bit_generator.state
    eng = c.engine
    assert sum(b["coalitions"] for b in eng.batch_log) == eng.first_charac_fct_calls_count
    exact = shapley_from_characteristic(5, {s: fn(s) for s in powerset_order(5)})
    if game == "additive":
        # zero-variance marginals: the sampled estimators are exact, the
        # importance samplers nearly so
        np.testing.assert_allclose(c.contributivity_scores, exact, atol=0.05)


def test_estimators_in_sequence_share_the_memo_like_jax():
    """The Scenario's pattern: one engine, one Contributivity a method, each
    seeded seed + 17; the call count after each method must match."""
    fn = saturating([0.1, 0.2, 0.05, 0.3, 0.25])
    sc, jsc = port_scenario(5, fn, seed=3), jax_scenario(5, fn, seed=3)
    for name in ESTIMATORS:
        method, kw = METHODS[name]
        c, jc = Contributivity(sc), JContributivity(jsc)
        getattr(c, method)(**kw)
        getattr(jc, method)(**kw)
        assert_same_result(c, jc)


@pytest.mark.parametrize("game", GAMES)
def test_svarm_matches_jax_on_analytic_game(game):
    fn = GAMES[game]
    c, jc = Contributivity(port_scenario(5, fn)), JContributivity(jax_scenario(5, fn))
    c.SVARM(budget=300)
    jc.SVARM(budget=300)
    assert_same_result(c, jc)
    rc, jrc = c.engine._reconstruction, jc.engine._reconstruction
    assert rc.reconstructions == jrc.reconstructions
    assert rc.values == jrc.values
    assert c.trust == jc.trust
    # the engine trained nothing: SVARM is retrain-free
    assert c.engine.batch_log == []


def test_svarm_budget_knob_and_trust_row(monkeypatch):
    fn = GAMES["saturating"]
    monkeypatch.setenv(constants.SVARM_SAMPLES_ENV, "64")
    monkeypatch.setenv("MPLC_TPU_SVARM_SAMPLES", "64")
    c, jc = Contributivity(port_scenario(5, fn)), JContributivity(jax_scenario(5, fn))
    c.compute_contributivity("SVARM")
    jc.compute_contributivity("SVARM")
    assert_same_result(c, jc)
    assert c.trust == jc.trust
    trust = c.trust
    assert trust["source"] == "mc_blocks" and trust["method"] == "SVARM"
    assert trust["ensemble"] == 5
    for key in ("mean", "std", "ci_low", "ci_high"):
        assert len(trust[key]) == 5 and np.isfinite(trust[key]).all()
    assert all(lo <= m <= hi for lo, m, hi in
               zip(trust["ci_low"], trust["mean"], trust["ci_high"]))
    # anchors (10), warm-up (at most 2 x 5 x 3 = 30 distinct) and 64 drawn
    assert c.engine._reconstruction.reconstructions <= 31


def test_svarm_malformed_budget_knob_warns_and_falls_back(monkeypatch):
    monkeypatch.setenv(constants.SVARM_SAMPLES_ENV, "-3")
    with pytest.warns(UserWarning, match=constants.SVARM_SAMPLES_ENV):
        assert constants.svarm_samples() == 0


def test_is_reg_falls_back_to_exact_below_four_partners():
    fn = saturating([0.2, 0.3, 0.5])
    c, jc = Contributivity(port_scenario(3, fn)), JContributivity(jax_scenario(3, fn))
    c.IS_reg()
    jc.IS_reg()
    assert c.name == "IS_reg Shapley values"
    assert_same_result(c, jc)
    exact = shapley_from_characteristic(3, {s: fn(s) for s in powerset_order(3)})
    assert _bits(c.contributivity_scores) == _bits(exact)


@pytest.mark.parametrize("name", ["SMCS", "WR_SMC"])
def test_stratified_lookahead_only_warms_the_memo(name):
    """lookahead = 0 evaluates one iteration at a time; the default 4 must
    give the same scores and std bit for bit."""
    method = METHODS[name][0]
    fn = GAMES["saturating"]
    a, b = (Contributivity(port_scenario(5, fn)) for _ in range(2))
    getattr(a, method)(sv_accuracy=0.05, lookahead=0)
    getattr(b, method)(sv_accuracy=0.05, lookahead=4)
    assert _bits(a.contributivity_scores) == _bits(b.contributivity_scores)
    assert _bits(a.scores_std) == _bits(b.scores_std)
    # fewer evaluate calls reach the engine with the lookahead
    assert len(b.engine.batch_log) <= len(a.engine.batch_log)


def test_kriging_model_matches_jax():
    rng = np.random.default_rng(11)
    X = [rng.random(4) * 300 for _ in range(12)]
    Y = rng.random(12) - 0.5
    phi2 = 150.0 ** 2

    def cov(a, b):
        return np.exp(-np.sum((np.asarray(a) - np.asarray(b)) ** 2) / phi2)

    def cov_batch(A, B):
        d2 = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * (A @ B.T)
        return np.exp(-np.maximum(d2, 0.0) / phi2)

    Xq = rng.random((20, 4)) * 300
    for cb in (None, cov_batch):
        m, jm = KrigingModel(2, cov, cov_batch=cb), JKrigingModel(2, cov, cov_batch=cb)
        m.fit(X, Y)
        jm.fit(X, Y)
        for attr in ("beta", "H", "invK"):
            assert _bits(getattr(m, attr)) == _bits(getattr(jm, attr))
        assert _bits(m.predict_batch(Xq)) == _bits(jm.predict_batch(Xq))
        assert _bits([m.predict(x) for x in Xq]) == _bits([jm.predict(x) for x in Xq])
    # the jitter keeps a fit through its training points
    np.testing.assert_allclose([m.predict(x) for x in X], Y, atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_linear_fit_is_bit_equal_to_sklearn(seed):
    """IS_reg's regression (size, size^2) -> increment: the port's
    least-squares fit against scikit-learn's `LinearRegression` on the
    same integer-sized design, coefficients, intercept and predictions."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 900, 24)
    X = np.stack([s, s ** 2], axis=1)          # int64, as IS_reg builds it
    X[0] = 0.0
    y = rng.normal(0, 0.1, 24) + 1e-4 * s
    fit, ref = tcontrib._LinearFit(X, y), LinearRegression().fit(X, y)
    assert _bits(fit.coef) == _bits(ref.coef_)
    assert _bits(fit.intercept) == _bits(ref.intercept_)
    w = rng.integers(0, 900, 64)
    q = np.stack([w, w * w], axis=1)
    assert _bits(fit.predict(q)) == _bits(ref.predict(q))


# ---------------------------------------------------------------------------
# 3. the slice
# ---------------------------------------------------------------------------

SLICE_METHODS = ESTIMATORS + ["Shapley values"]
# JAX method of each registry name, with the dispatcher's defaults
DEFAULTS = dict(sv_accuracy=0.01, alpha=0.95)


def _replay_in_jax(sc, table, sizes, seed):
    """The JAX estimators over the port's v(S) table, in the Scenario's
    order, one Contributivity a method on one shared engine."""
    n = len(sizes)
    jsc = jax_scenario(n, lambda s: table[tuple(s)], sizes=list(sizes), seed=seed)
    out = []
    for name in sc.methods:
        jc = JContributivity(jsc)
        jc.compute_contributivity(name)
        out.append((jc, jc.first_charac_fct_calls_count))
    return out


@pytest.fixture(scope="module")
def titanic_slice():
    sc = Scenario(5, [0.1, 0.15, 0.2, 0.25, 0.3], is_dry_run=True,
                  dataset=tdatasets.load_titanic(), epoch_count=2, minibatch_count=2,
                  gradient_updates_per_pass_count=2, is_early_stopping=False,
                  methods=SLICE_METHODS, seed=4, device="cpu")
    sc.run()
    return sc


def test_titanic_slice_estimators_match_jax_on_the_ports_table(titanic_slice):
    sc = titanic_slice
    eng = sc._charac_engine
    table = dict(eng.charac_fct_values)
    assert len(table) == 32                              # every coalition, once
    assert eng.first_charac_fct_calls_count == 31
    assert sum(b["coalitions"] for b in eng.batch_log) == 31
    sizes = [len(p.y_train) for p in sorted(sc.partners_list, key=lambda p: p.id)]
    jax_runs = _replay_in_jax(sc, table, sizes, sc.seed)
    exact = sc.contributivity_list[-1].contributivity_scores
    calls = 0
    for name, c, (jc, jcalls) in zip(sc.methods, sc.contributivity_list, jax_runs):
        calls += sum(b["coalitions"] for b in c.batches_trained)
        assert calls == jcalls, name
        assert c.name == jc.name
        assert _bits(c.contributivity_scores) == _bits(jc.contributivity_scores), name
        assert _bits(c.scores_std) == _bits(jc.scores_std), name
        assert np.isfinite(c.contributivity_scores).all()
        # the repo's value bound against exact Shapley of the same table
        assert np.abs(c.contributivity_scores - exact).max() <= 0.05, name
    # the exact sweep came last and trained only what the estimators left
    assert calls == 31


def test_tiny_mnist_svarm_and_auto_match_jax_over_the_ports_table():
    sc = Scenario(3, [0.2, 0.3, 0.5], is_dry_run=True, dataset=_tiny_mnist(),
                  epoch_count=1, minibatch_count=2, gradient_updates_per_pass_count=1,
                  is_early_stopping=False, methods=["SVARM", "auto"], seed=2,
                  device="cpu")
    sc.run()
    svarm, auto = sc.contributivity_list
    recon = svarm._reconstructor()
    assert sc._charac_engine.batch_log == []            # nothing retrained
    table = dict(recon.values)
    assert len(table) == 8
    assert recon.reconstructions == 7                    # each coalition once
    sizes = [len(p.y_train) for p in sorted(sc.partners_list, key=lambda p: p.id)]
    jsc = jax_scenario(3, lambda s: table[tuple(s)], sizes=sizes, seed=sc.seed)
    jsvarm = JContributivity(jsc)
    jsvarm.compute_contributivity("SVARM")
    assert _bits(svarm.contributivity_scores) == _bits(jsvarm.contributivity_scores)
    assert _bits(svarm.scores_std) == _bits(jsvarm.scores_std)
    assert svarm.trust == jsvarm.trust
    jauto = JContributivity(jsc)
    jauto.compute_contributivity("auto")
    assert auto.plan.describe() == jauto.plan.describe()
    assert auto.plan.method == "exact"
    assert _bits(auto.contributivity_scores) == _bits(jauto.contributivity_scores)
    exact = shapley_from_characteristic(3, table)
    assert _bits(auto.contributivity_scores) == _bits(exact)
    assert np.abs(svarm.contributivity_scores - exact).max() <= 0.05
