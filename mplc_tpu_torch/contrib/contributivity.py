"""Contributivity measurement (port of `mplc_tpu/contrib/contributivity.py`).

Over retrained coalitions (`CharacteristicEngine.evaluate`): exact Shapley
values, independent scores and the sampling estimators TMCS, ITMCS,
IS_lin_S, IS_reg_S, AIS_Kriging_S, SMCS and WR_SMC. Over reconstructed
models (`ReconstructionEvaluator.evaluate`): GTG-Shapley, SVARM and exact
Shapley; "auto" plans the query (contrib/planner.py) and runs the method
the plan names.

Same API as the JAX package: `Contributivity(scenario)` +
`compute_contributivity(method_name)`, filling `contributivity_scores`,
`scores_std`, `normalized_scores` and `computation_time_sec`. The
estimators are the JAX package's numpy, statement for statement: they
consume the `default_rng(seed + 17)` stream call for call, so on the same
v(S) they give the same scores, std and call counts. How they batch:

  - TMCS/ITMCS run a wavefront over 16 permutations at once: at prefix
    length j, every non-truncated permutation's prefix is evaluated in one
    batch, each permutation keeping its own truncation rule;
  - the importance-sampling methods draw a block of 8 iterations up front
    and evaluate the block's (S, S u {k}) pairs in one batch, the draws
    coming from tabulated samplers (contrib/sampling.py);
  - the stratified methods keep their per-iteration adaptive allocation,
    but each iteration's evaluate call also carries the next `lookahead`
    iterations' draws, simulated on a cloned rng: a missed speculation only
    warms the memo, it never changes the estimator's stream.

Over the grand coalition's training: the Federated step-by-step scores
(linear, quadratic, constant) from `scenario.mpl.history`, LFlip from a
label-flip fit's thetas, and PVRL from its own REINFORCE-driven run, one
epoch at a time. A name the JAX package does not know is logged and
ignored.
"""

from __future__ import annotations

import datetime
import logging
from itertools import combinations
from math import comb, factorial

import numpy as np
from scipy import linalg
from scipy.stats import norm

import torch

from .. import constants
from ..mpl.engine import MplTrainer, TrainConfig, epoch_streams
from ..obs import trace as obs_trace
from .engine import CharacteristicEngine
from .planner import estimate_eval_seconds, plan_query
from .sampling import (WithoutReplacementRanks, make_importance_sampler,
                       randbelow, svarm_batch_draws, svarm_warmup_draws,
                       unrank_combination)
from .shapley import (powerset_order, shapley_from_characteristic, trust_from_replicas,
                      trust_summary)

logger = logging.getLogger("mplc_tpu_torch")


class KrigingModel:
    """Gaussian-process regressor with polynomial trend, used by AIS
    (reference MPLC contributivity.py:22-61). Vectorized numpy."""

    def __init__(self, degre: int, covariance_func, cov_batch=None):
        self.degre = degre
        self.cov_f = covariance_func
        # optional vectorized covariance: (queries [B,d], train [M,d]) -> [B,M]
        self.cov_batch = cov_batch
        self.X = self.Y = self.beta = self.H = self.invK = None

    def fit(self, X, Y):
        X = [np.asarray(x, float) for x in X]
        Y = np.asarray(Y, float)
        self.X, self.Y = X, Y
        m = len(X)
        K = np.zeros((m, m))
        H = np.zeros((m, self.degre + 1))
        for i, a in enumerate(X):
            for j, b in enumerate(X):
                K[i, j] = self.cov_f(a, b)
            for j in range(self.degre + 1):
                H[i, j] = np.sum(a) ** j
        K += 1e-9 * np.eye(m)  # numerical jitter; the reference inverts raw K
        self.H = H
        self.invK = np.linalg.inv(K)
        Ht_invK_H = H.T @ self.invK @ H
        self.beta = np.linalg.inv(Ht_invK_H) @ H.T @ self.invK @ self.Y

    def predict(self, x):
        x = np.asarray(x, float)
        gx = np.array([np.sum(x) ** i for i in range(self.degre + 1)])
        cx = np.array([self.cov_f(xi, x) for xi in self.X])
        return gx @ self.beta + cx @ self.invK @ (self.Y - self.H @ self.beta)

    def predict_batch(self, Xq):
        """Vectorized predict over [B, d] query rows: one matmul instead of
        B python-level predict calls (feeds the tabulated IS sampler)."""
        Xq = np.asarray(Xq, float)
        s = Xq.sum(axis=1)
        G = np.stack([s ** i for i in range(self.degre + 1)], axis=1)
        Xtr = np.stack(self.X)
        if self.cov_batch is not None:
            C = self.cov_batch(Xq, Xtr)
        else:
            C = np.array([[self.cov_f(xt, xq) for xt in Xtr] for xq in Xq])
        return G @ self.beta + C @ (self.invK @ (self.Y - self.H @ self.beta))


class _LinearFit:
    """Ordinary least squares with an intercept, for dense float input: the
    arithmetic of scikit-learn's `LinearRegression().fit(X, y)` and
    `.predict(X)` (centre X and y on their means, `scipy.linalg.lstsq` on
    the centred data with its default tolerance `cond=1e-6`, intercept =
    y_mean - x_mean @ coef), which the card's machine does not have."""

    def __init__(self, X, y):
        X = np.array(X, dtype=np.float64)
        y = np.array(y, dtype=np.float64)
        x_mean = np.mean(X, axis=0)
        X -= x_mean
        y_mean = np.mean(y, axis=0)
        y -= y_mean
        self.coef = linalg.lstsq(X, y, cond=1e-6)[0]
        self.intercept = y_mean - x_mean @ self.coef

    def predict(self, X):
        return np.asarray(X, dtype=np.float64) @ self.coef + self.intercept


def power_set(lst):
    """Every non-empty subset of `lst` as a list, by size then in
    combination order (the reference's helper, contributivity.py:1205-1206)."""
    return [list(c) for i in range(len(lst)) for c in combinations(lst, i + 1)]


class Contributivity:
    def __init__(self, scenario, name: str = ""):
        self.name = name
        self.scenario = scenario
        nb_partners = len(scenario.partners_list)
        self.contributivity_scores = np.zeros(nb_partners)
        self.scores_std = np.zeros(nb_partners)
        self.normalized_scores = np.zeros(nb_partners)
        self.computation_time_sec = 0.0
        # Monte-Carlo trust row (per-partner CI + Kendall-tau rank
        # stability over disjoint sample blocks), set by GTG-Shapley and
        # SVARM
        self.trust = None
        # the QueryPlan "auto" resolved to
        self.plan = None
        # the engine's batch-log entries trained while this object's
        # compute_contributivity ran
        self.batches_trained: list[dict] = []
        # one engine per scenario, so the staged data and the recorded
        # run are shared by every method of the scenario
        if getattr(scenario, "_charac_engine", None) is None:
            scenario._charac_engine = CharacteristicEngine(scenario)
        self.engine: CharacteristicEngine = scenario._charac_engine
        self._rng = np.random.default_rng(getattr(scenario, "seed", 0) + 17)

    def __str__(self):
        t = str(datetime.timedelta(seconds=self.computation_time_sec))
        out = "\n" + self.name + "\n"
        out += "Computation time: " + t + "\n"
        out += ("Number of characteristic function computed: "
                + str(self.first_charac_fct_calls_count) + "\n")
        out += f"Contributivity scores: {np.round(self.contributivity_scores, 3)}\n"
        out += f"Std of the contributivity scores: {np.round(self.scores_std, 3)}\n"
        out += f"Normalized contributivity scores: {np.round(self.normalized_scores, 3)}\n"
        return out

    # -- reference-API passthroughs to the engine's memo

    @property
    def charac_fct_values(self):
        return self.engine.charac_fct_values

    @property
    def increments_values(self):
        return self.engine.increments_values

    @property
    def first_charac_fct_calls_count(self):
        return self.engine.first_charac_fct_calls_count

    def not_twice_characteristic(self, subset):
        return self.engine.not_twice_characteristic(subset)

    def _method_span(self, method: str) -> obs_trace.Span:
        """The method's timer: `_finish` takes `computation_time_sec` from
        it, and ending it emits one `contributivity` record a method run
        when tracing is on."""
        return obs_trace.start_span("contributivity", method=method)

    def _finish(self, name, scores, std, span: obs_trace.Span):
        self.name = name
        self.contributivity_scores = np.asarray(scores, float)
        self.scores_std = np.asarray(std, float)
        total = np.sum(self.contributivity_scores)
        self.normalized_scores = self.contributivity_scores / (total if total else 1.0)
        span.attrs["method"] = name  # the final display name
        self.computation_time_sec = span.end().duration

    @property
    def _n(self):
        return len(self.scenario.partners_list)

    def _sizes(self):
        return np.array([len(p.y_train) for p in
                         sorted(self.scenario.partners_list, key=lambda q: q.id)])

    def _truncated_permutation_sweep(self, n, v_all, eval_fn, values,
                                     sv_accuracy, alpha, truncation,
                                     interpolate, sizes, perm_batch,
                                     min_iter=100):
        """The truncated-permutation wavefront: `perm_batch` permutations
        advance in lock-step, and at prefix length j only the
        non-truncated permutations' prefixes are evaluated, in one batch
        through `eval_fn`. `values` is the memo `eval_fn` fills. Returns
        (contributions [T, n], T)."""
        q = norm.ppf((1 - alpha) / 2, loc=0, scale=1)
        contributions = np.zeros((0, n))
        t = 0
        v_max = 0.0
        while t < min_iter or t < q ** 2 * v_max / sv_accuracy ** 2:
            k_round = perm_batch
            perms = [self._rng.permutation(n) for _ in range(k_round)]
            rows = np.zeros((k_round, n))
            prefix_vals = np.zeros(k_round)
            interp_slope = np.full(k_round, np.nan)  # ITMCS per-perm slope a
            for j in range(n):
                need = [k for k in range(k_round)
                        if abs(v_all - prefix_vals[k]) >= truncation]
                if need:
                    eval_fn([tuple(sorted(perms[k][:j + 1]))
                             for k in need])
                need_set = set(need)
                for k in range(k_round):
                    key = tuple(sorted(int(x) for x in perms[k][:j + 1]))
                    if k in need_set:
                        new_val = values[key]
                    elif interpolate:
                        if np.isnan(interp_slope[k]):
                            size_of_rest = sizes[perms[k][j:]].sum()
                            interp_slope[k] = ((v_all - prefix_vals[k])
                                               / max(size_of_rest, 1))
                        new_val = prefix_vals[k] + interp_slope[k] * sizes[perms[k][j]]
                    else:
                        new_val = prefix_vals[k]
                    rows[k, perms[k][j]] = new_val - prefix_vals[k]
                    prefix_vals[k] = new_val
            contributions = np.vstack([contributions, rows])
            t += k_round
            v_max = np.max(np.var(contributions, axis=0))
        return contributions, t

    def compute_SV(self):
        """Exact Shapley values over retrained coalitions: all 2^n - 1
        coalitions valued in one batched sweep, then the closed-form
        Shapley sum. Under a seed ensemble (K > 1) the replicas' Shapley
        values give the trust row (source "seed_ensemble") and their std
        is scores_std; otherwise scores_std is exactly zero."""
        t0 = self._method_span("Shapley")
        logger.info("# Launching computation of Shapley Value of all partners")
        n = self._n
        self.engine.evaluate(powerset_order(n))
        sv = shapley_from_characteristic(n, self.engine.charac_fct_values)
        std = np.zeros(n)
        samples = getattr(self.engine, "charac_fct_samples", None)
        if getattr(self.engine, "seed_ensemble", 1) > 1 and samples:
            self.trust = trust_summary(n, samples)
            std = np.asarray(self.trust["std"])
            obs_trace.event("contrib.trust", **self.trust)
            logger.info("# Seed-ensemble trust: K=%d, kendall_tau=%.3f",
                        self.trust["ensemble"], self.trust["kendall_tau"])
        self._finish("Shapley", sv, std, t0)

    def compute_independent_scores(self):
        """v({i}) of every partner: a model trained on its data alone
        (memo hits after a Shapley sweep)."""
        t0 = self._method_span("Independent scores raw")
        logger.info("# Launching computation of perf. scores of models trained "
                    "independently on each partner")
        n = self._n
        scores = self.engine.evaluate([(i,) for i in range(n)])
        self._finish("Independent scores raw", scores, np.zeros(n), t0)

    # ------------------------------------------------------------------
    # truncated MC (+ interpolated variant): the permutation wavefront
    # ------------------------------------------------------------------

    def _tmc(self, sv_accuracy, alpha, truncation, interpolate, perm_batch=16):
        name = "ITMCS" if interpolate else "TMC Shapley"
        t0 = self._method_span(name)
        n = self._n
        v_all = float(self.engine.evaluate([tuple(range(n))])[0])
        if n == 1:
            self._finish(name, np.array([v_all]), np.array([0.0]), t0)
            return
        contributions, t = self._truncated_permutation_sweep(
            n, v_all, self.engine.evaluate, self.engine.charac_fct_values,
            sv_accuracy, alpha, truncation, interpolate, self._sizes(),
            perm_batch)
        sv = np.mean(contributions, axis=0)
        std = np.std(contributions, axis=0) / np.sqrt(t - 1)
        self._finish(name, sv, std, t0)

    def truncated_MC(self, sv_accuracy=0.01, alpha=0.9, truncation=0.05):
        logger.info("# Launching TMCS (truncated Monte-Carlo Shapley)")
        self._tmc(sv_accuracy, alpha, truncation, interpolate=False)

    def interpol_TMC(self, sv_accuracy=0.01, alpha=0.9, truncation=0.05):
        logger.info("# Launching ITMCS (interpolated truncated Monte-Carlo Shapley)")
        self._tmc(sv_accuracy, alpha, truncation, interpolate=True)

    # ------------------------------------------------------------------
    # importance sampling (linear / regression / adaptive Kriging)
    # ------------------------------------------------------------------

    def _build_samplers(self, n, batch_fn_for):
        """One importance sampler per partner. `batch_fn_for(k)` returns a
        vectorized |approx increment| model over [B, n-1] membership masks
        of N\\{k}; the sampler tabulates the reference's IS proposal from
        it (exact up to MAX_EXACT_BITS other partners, size-stratified
        above)."""
        return [make_importance_sampler(n, k, batch_fn_for(k), self._rng)
                for k in range(n)]

    def _is_sampling_loop(self, n, samplers, sv_accuracy, alpha,
                          t0, name, block=8, refit_every=None, refit_fn=None):
        q = -norm.ppf((1 - alpha) / 2, loc=0, scale=1)
        contributions = []
        t = 0
        v_max = 0.0
        since_refit = 0
        while t < 100 or t < 4 * q ** 2 * v_max / sv_accuracy ** 2:
            if refit_every is not None and refit_fn is not None and \
                    since_refit >= refit_every:
                samplers = refit_fn()
                since_refit = 0
            rounds = []
            requests = []
            for _ in range(block):
                row = []
                for k in range(n):
                    u = self._rng.uniform()
                    S, weight = samplers[k].draw(u, self._rng)
                    row.append((S, weight))
                    requests.append(tuple(sorted(S.tolist() + [k])))
                    requests.append(tuple(sorted(S.tolist())))
                rounds.append(row)
            # the empty coalition is never requested: v(empty) = 0
            self.engine.evaluate([r for r in requests if len(r) > 0])
            vals = self.engine.charac_fct_values
            for row in rounds:
                contrib_row = np.zeros(n)
                for k, (S, weight) in enumerate(row):
                    s_key = tuple(sorted(int(x) for x in S))
                    sk_key = tuple(sorted(list(s_key) + [k]))
                    increment = vals[sk_key] - vals.get(s_key, 0.0)
                    contrib_row[k] = increment * weight
                contributions.append(contrib_row)
            t += block
            since_refit += block
            v_max = np.max(np.var(np.asarray(contributions), axis=0))
        contributions = np.asarray(contributions)
        sv = np.mean(contributions, axis=0)
        std = np.std(contributions, axis=0) / np.sqrt(t - 1)
        self._finish(name, sv, std, t0)

    def IS_lin(self, sv_accuracy=0.01, alpha=0.95):
        """Linear-interpolation importance sampling (reference :326-439)."""
        t0 = self._method_span("IS_lin Shapley")
        logger.info("# Launching IS_lin Shapley")
        n = self._n
        v_all = float(self.engine.evaluate([tuple(range(n))])[0])
        if n == 1:
            self._finish("IS_lin Shapley", np.array([v_all]), np.array([0.0]), t0)
            return
        # batched prefetch of v(N\k) and v({k})
        self.engine.evaluate([tuple(sorted(set(range(n)) - {k})) for k in range(n)]
                             + [(k,) for k in range(n)])
        vals = self.engine.charac_fct_values
        last_inc = [v_all - vals[tuple(sorted(set(range(n)) - {k}))] for k in range(n)]
        first_inc = [vals[(k,)] for k in range(n)]
        sizes = self._sizes()
        size_of_i = sizes.sum()

        def batch_fn_for(k):
            sizes_k = sizes[np.delete(np.arange(n), k)]

            def batch(masks):
                beta = (masks @ sizes_k) / size_of_i
                return (1 - beta) * first_inc[k] + beta * last_inc[k]
            return batch

        samplers = self._build_samplers(n, batch_fn_for)
        self._is_sampling_loop(n, samplers, sv_accuracy, alpha,
                               t0, "IS_lin Shapley")

    def IS_reg(self, sv_accuracy=0.01, alpha=0.95):
        """Regression importance sampling (reference :443-569). Falls back to
        exact SV for n < 4 like the reference."""
        t0 = self._method_span("IS_reg Shapley")
        logger.info("# Launching IS_reg Shapley")
        n = self._n
        if n < 4:
            # compute_SV times itself through its own span
            t0.cancel()
            self.compute_SV()
            self.name = "IS_reg Shapley values"
            return
        # warm-up: (n+2) permutations' prefix chains, fully batched
        perm = self._rng.permutation(n)
        chains = [perm.copy(), np.flip(perm)]
        p = np.flip(perm)
        for _ in range(n):
            p = np.append(p[-1], p[:-1])
            chains.append(p.copy())
        requests = [tuple(sorted(int(x) for x in chain[:j + 1]))
                    for chain in chains for j in range(n)]
        self.engine.evaluate(requests)

        sizes = self._sizes()

        def makedata(subset):
            s = sizes[np.asarray(subset, int)].sum() if len(subset) else 0.0
            return np.array([s, s ** 2])

        models = []
        for k in range(n):
            x = [makedata(subset) for subset in self.engine.increments_values[k]]
            y = list(self.engine.increments_values[k].values())
            models.append(_LinearFit(np.array(x), np.array(y)))

        def batch_fn_for(k):
            sizes_k = sizes[np.delete(np.arange(n), k)]
            model_k = models[k]

            def batch(masks):
                w = masks @ sizes_k
                return model_k.predict(np.stack([w, w * w], axis=1))
            return batch

        samplers = self._build_samplers(n, batch_fn_for)
        self._is_sampling_loop(n, samplers, sv_accuracy, alpha,
                               t0, "IS_reg Shapley")

    def AIS_Kriging(self, sv_accuracy=0.01, alpha=0.95, update=50):
        """Adaptive Kriging importance sampling (reference :573-723): the
        samplers are refit every `update` iterations."""
        t0 = self._method_span("AIS Shapley")
        logger.info("# Launching AIS Kriging Shapley")
        n = self._n
        # seed evaluations: full set, singletons, pairs + their complements
        requests = [tuple(range(n))]
        for k1 in range(n):
            requests.append((k1,))
            requests.append(tuple(sorted(set(range(n)) - {k1})))
            for k2 in range(n):
                if k1 != k2:
                    requests.append(tuple(sorted((k1, k2))))
                    requests.append(tuple(sorted(set(range(n)) - {k1, k2})))
        self.engine.evaluate(list(dict.fromkeys(requests)))

        sizes = self._sizes()

        def make_coordinate(subset, k):
            coord = np.zeros(n)
            for i in np.asarray(subset, int):
                coord[i] = sizes[i]
            return np.delete(coord, k)

        def dist(x1, x2):
            return np.sqrt(np.sum((np.asarray(x1) - np.asarray(x2)) ** 2))

        phi = np.array([np.median(make_coordinate(np.delete(np.arange(n), k), k))
                        for k in range(n)])

        def make_cov(k):
            return lambda x1, x2: np.exp(-dist(x1, x2) ** 2 / max(phi[k] ** 2, 1e-12))

        def make_cov_batch(k):
            denom = max(phi[k] ** 2, 1e-12)

            def cb(A, B):
                # ||a-b||^2 via the inner-product identity: only the [B, M]
                # result, never a [B, M, d] broadcast (B can be 2^16 rows)
                d2 = ((A * A).sum(1)[:, None] + (B * B).sum(1)[None, :]
                      - 2.0 * (A @ B.T))
                return np.exp(-np.maximum(d2, 0.0) / denom)
            return cb

        def refit():
            models = []
            for k in range(n):
                x = [make_coordinate(subset, k)
                     for subset in self.engine.increments_values[k]]
                y = list(self.engine.increments_values[k].values())
                m = KrigingModel(2, make_cov(k), cov_batch=make_cov_batch(k))
                m.fit(x, y)
                models.append(m)

            def batch_fn_for(k):
                sizes_k = sizes[np.delete(np.arange(n), k)]
                model_k = models[k]

                def batch(masks):
                    return model_k.predict_batch(masks * sizes_k)
                return batch

            return self._build_samplers(n, batch_fn_for)

        samplers = refit()
        self._is_sampling_loop(n, samplers, sv_accuracy, alpha,
                               t0, "AIS Shapley", block=min(8, update),
                               refit_every=update, refit_fn=refit)

    # ------------------------------------------------------------------
    # stratified Monte-Carlo (with and without replacement)
    # ------------------------------------------------------------------

    @staticmethod
    def _smcs_e(t: int, N: int) -> float:
        """SMCS's exploration/exploitation schedule (reference :739-741)."""
        gamma, beta = 0.2, 0.0075
        return (1 + 1 / (1 + np.exp(gamma / beta))
                - 1 / (1 + np.exp(-(t - gamma * N) / (beta * N))))

    def _spec_rng(self) -> np.random.Generator:
        """A clone of the estimator rng continuing from its live state: the
        stratified methods' speculative lookahead draws from it, so
        speculation never advances the real stream."""
        g = np.random.Generator(type(self._rng.bit_generator)())
        g.bit_generator.state = self._rng.bit_generator.state
        return g

    def _smcs_draw_plan(self, rng, e, N, sigma2):
        """One SMCS iteration's [(k, strata, S)] draw plan: the reference's
        draw sequence, over the generator passed, so the lookahead can
        replay it on a cloned rng."""
        plan = []
        for k in range(N):
            if np.sum(sigma2[k]) == 0:
                p = np.repeat(1 / N, N)
            else:
                p = np.repeat(1 / N, N) * (1 - e) + sigma2[k] / np.sum(sigma2[k]) * e
            strata = rng.choice(np.arange(N), 1, p=p)[0]
            # a uniform size-`strata` subset of N\{k}: the reference walks
            # the C(N-1, strata) combinations summing a constant probability
            # per step; the walk stops at floor(u * C), unranked directly
            u = rng.uniform()
            list_k = np.delete(np.arange(N), k)
            total = comb(N - 1, int(strata))
            if total <= 2 ** 53:
                idx = min(int(u * total), total - 1)
            else:
                # a float inverse-CDF cannot index strata above 2^53
                idx = randbelow(rng, total)
            S = np.array(list_k[unrank_combination(N - 1, int(strata), idx)],
                         int)
            plan.append((k, strata, S))
        return plan

    @staticmethod
    def _pair_requests(plan) -> list:
        """The (S u {k}, S) requests of a draw plan, the empty S skipped."""
        reqs = []
        for k, _strata, S in plan:
            reqs.append(tuple(sorted(S.tolist() + [k])))
            if len(S):
                reqs.append(tuple(sorted(S.tolist())))
        return reqs

    def Stratified_MC(self, sv_accuracy=0.01, alpha=0.95, lookahead=4):
        """Stratified MC Shapley (reference :727-819): per-partner strata by
        coalition size, adaptive allocation toward high-variance strata.
        Each iteration's evaluate call also carries the next `lookahead`
        iterations' draws, simulated on a cloned rng under the current
        sigma2, so consecutive iterations' pairs pack into one batch;
        lookahead=0 evaluates strictly one iteration at a time."""
        t0 = self._method_span("Stratified MC Shapley")
        logger.info("# Launching Stratified MC Shapley")
        N = self._n
        v_all = float(self.engine.evaluate([tuple(range(N))])[0])
        if N == 1:
            self._finish("Stratified MC Shapley", np.array([v_all]), np.array([0.0]), t0)
            return
        t = 0
        sigma2 = np.zeros((N, N))
        mu = np.zeros((N, N))
        v_max = 0.0
        continuer = [[True] * N for _ in range(N)]
        contributions = [[list() for _ in range(N)] for _ in range(N)]
        while np.any(continuer) or (1 - alpha) < v_max / sv_accuracy ** 2:
            t += 1
            plan = self._smcs_draw_plan(self._rng, self._smcs_e(t, N), N,
                                        sigma2)
            reqs = self._pair_requests(plan)
            if lookahead:
                srng = self._spec_rng()
                for j in range(1, int(lookahead) + 1):
                    reqs += self._pair_requests(self._smcs_draw_plan(
                        srng, self._smcs_e(t + j, N), N, sigma2))
            self.engine.evaluate(reqs)
            vals = self.engine.charac_fct_values
            for k, strata, S in plan:
                s_key = tuple(sorted(int(x) for x in S))
                increment = vals[tuple(sorted(list(s_key) + [k]))] - vals.get(s_key, 0.0)
                contributions[k][strata].append(increment)
                sigma2[k, strata] = np.var(contributions[k][strata])
                mu[k, strata] = np.mean(contributions[k][strata])
            shap = np.mean(mu, axis=1)
            var = np.zeros(N)
            for k in range(N):
                for strata in range(N):
                    n_ks = len(contributions[k][strata])
                    if n_ks == 0:
                        var[k] = np.inf
                    else:
                        var[k] += sigma2[k, strata] ** 2 / n_ks
                    if n_ks > 20:
                        continuer[k][strata] = False
                var[k] /= N ** 2
            v_max = np.max(var)
        self._finish("Stratified MC Shapley", shap, np.sqrt(var), t0)

    @staticmethod
    def _clone_pool(pool: WithoutReplacementRanks) -> WithoutReplacementRanks:
        clone = WithoutReplacementRanks(pool.total)
        clone._moved = dict(pool._moved)
        return clone

    def _wr_draw_plan(self, rng, N, sigma2, continuer, pools):
        """One WR_SMC iteration's [(k, strata, S)] draw plan over the passed
        continuer and pool state: the real loop mutates its live state, the
        lookahead replays on clones."""
        plan = []
        for k in range(N):
            if np.any(continuer[k]):
                p = np.array(continuer[k], float) / np.sum(continuer[k])
            elif np.sum(sigma2[k]) == 0:
                continue
            else:
                p = sigma2[k] / np.sum(sigma2[k])
            strata = rng.choice(np.arange(N), 1, p=p)[0]
            if pools[k][strata].total <= 0:  # __len__ caps at sys.maxsize
                continuer[k][strata] = False
                continue
            rank = pools[k][strata].pop_random(rng)
            list_k = np.delete(np.arange(N), k)
            subset = tuple(int(i) for i in
                           list_k[unrank_combination(N - 1, int(strata), rank)])
            plan.append((k, strata, np.array(subset, int)))
        return plan

    def without_replacment_SMC(self, sv_accuracy=0.01, alpha=0.95,
                               lookahead=4):
        """Without-replacement stratified MC (reference :823-938; the name's
        spelling is the reference's). The same lookahead as
        `Stratified_MC`, replayed on a cloned rng with cloned pools and
        continuer state, so the real stream and its pools are untouched."""
        t0 = self._method_span("WR_SMC Shapley")
        logger.info("# Launching WR_SMC Shapley")
        N = self._n
        v_all = float(self.engine.evaluate([tuple(range(N))])[0])
        if N == 1:
            self._finish("WR_SMC Shapley", np.array([v_all]), np.array([0.0]), t0)
            return
        t = 0
        sigma2 = np.zeros((N, N))
        mu = np.zeros((N, N))
        v_max = 0.0
        continuer = [[True] * N for _ in range(N)]
        inc_generated = [[dict() for _ in range(N)] for _ in range(N)]
        # without-replacement pools over combination ranks (sparse
        # Fisher-Yates), unranked lazily at draw time
        pools = [[WithoutReplacementRanks(comb(N - 1, strata))
                  for strata in range(N)] for _ in range(N)]
        while np.any(continuer) or (1 - alpha) < v_max / sv_accuracy ** 2:
            t += 1
            plan = self._wr_draw_plan(self._rng, N, sigma2, continuer, pools)
            reqs = self._pair_requests(plan)
            if lookahead:
                srng = self._spec_rng()
                spools = [[self._clone_pool(p) for p in row]
                          for row in pools]
                scont = [list(row) for row in continuer]
                for _ in range(int(lookahead)):
                    reqs += self._pair_requests(self._wr_draw_plan(
                        srng, N, sigma2, scont, spools))
            if reqs:
                self.engine.evaluate(reqs)
            vals = self.engine.charac_fct_values
            for k, strata, S in plan:
                s_key = tuple(sorted(int(x) for x in S))
                increment = vals[tuple(sorted(list(s_key) + [k]))] - vals.get(s_key, 0.0)
                inc_generated[k][strata][s_key] = increment
                m = len(inc_generated[k][strata])
                mu[k, strata] = (mu[k, strata] * (m - 1) + increment) / m
                var_s = sum((v - mu[k, strata]) ** 2
                            for v in inc_generated[k][strata].values())
                sigma2[k, strata] = var_s / (m - 1) if m > 1 else 0.0
                sigma2[k, strata] *= (1 / m - factorial(N - 1 - strata)
                                      * factorial(strata) / factorial(N - 1))
            shap = np.mean(mu, axis=1)
            var = np.zeros(N)
            for k in range(N):
                for strata in range(N):
                    n_ks = len(inc_generated[k][strata])
                    if n_ks == 0:
                        var[k] = np.inf
                    else:
                        var[k] += sigma2[k, strata] ** 2 / n_ks
                    if n_ks > 20:
                        continuer[k][strata] = False
                    total = (factorial(N - 1) /
                             (factorial(N - 1 - strata) * factorial(strata)))
                    if n_ks >= total:
                        continuer[k][strata] = False
                var[k] /= N ** 2
            v_max = np.max(var)
        self._finish("WR_SMC Shapley", shap, np.sqrt(var), t0)

    def _reconstructor(self):
        """The engine's shared ReconstructionEvaluator, recording the grand
        coalition on first use: one training run per scenario, reused by
        every retrain-free method."""
        eng = self.engine
        if getattr(eng, "_reconstruction", None) is None:
            from .reconstruct import ReconstructionEvaluator
            eng._reconstruction = ReconstructionEvaluator(eng)
        return eng._reconstruction

    def _recon_for(self, span: obs_trace.Span):
        """`_reconstructor()` for a retrain-free method whose span is open:
        when the recording raises, the span is dropped, so no later
        evaluate attributes its memo traffic to this method."""
        try:
            return self._reconstructor()
        except BaseException:
            span.cancel()
            raise

    def _set_mc_trust(self, contributions, alpha, method):
        """The trust row from a Monte-Carlo run: the iteration rows split
        into up to 5 disjoint blocks whose means are independent unbiased
        pseudo-replicas (source="mc_blocks")."""
        T = len(contributions)
        if T < 2:
            return
        blocks = np.array_split(np.asarray(contributions), min(5, T), axis=0)
        reps = np.stack([b.mean(axis=0) for b in blocks])
        self.trust = {**trust_from_replicas(reps, alpha, source="mc_blocks"),
                      "method": method}
        obs_trace.event("contrib.trust", **self.trust)

    def exact_reconstructed(self, alpha=0.95):
        """Exact Shapley over reconstructed coalition models: the full
        2^P - 1 powerset evaluated by the shared ReconstructionEvaluator
        (the one recorded grand-coalition run is the only training), then
        the closed-form Shapley sum; scores_std is exactly zero."""
        t0 = self._method_span("exact (reconstructed)")
        logger.info("# Launching exact Shapley over reconstructed models")
        n = self._n
        recon = self._recon_for(t0)
        recon.evaluate(powerset_order(n))
        sv = np.asarray(shapley_from_characteristic(n, recon.values))
        self._finish("exact (reconstructed)", sv, np.zeros(n), t0)

    def GTG_Shapley(self, sv_accuracy=0.01, alpha=0.95, truncation=None,
                    perm_batch=16, min_iter=100):
        """GTG-Shapley (arXiv:2109.02053): truncated-permutation Shapley
        over reconstructed coalition models. A permutation's remaining
        positions are pruned once |v(N) - v(prefix)| < `truncation`
        (default MPLC_TORCH_GTG_TRUNCATION, 0.05)."""
        t0 = self._method_span("GTG-Shapley")
        logger.info("# Launching GTG-Shapley (retrain-free reconstruction)")
        n = self._n
        recon = self._recon_for(t0)
        if truncation is None:
            truncation = constants.gtg_truncation()
        v_all = float(recon.evaluate([tuple(range(n))])[0])
        if n == 1:
            self._finish("GTG-Shapley", np.array([v_all]), np.array([0.0]), t0)
            return
        contributions, t = self._truncated_permutation_sweep(
            n, v_all, recon.evaluate, recon.values, sv_accuracy, alpha,
            truncation, False, self._sizes(), perm_batch, min_iter)
        sv = np.mean(contributions, axis=0)
        std = np.std(contributions, axis=0) / np.sqrt(t - 1)
        self._set_mc_trust(contributions, alpha, "GTG-Shapley")
        self._finish("GTG-Shapley", sv, std, t0)

    def SVARM(self, budget=None, alpha=0.95, block=64):
        """SVARM ("Approximating the Shapley Value without Marginal
        Contributions", arXiv:2302.00736): stratified sampling where one
        evaluated coalition A updates the plus-strata estimates of every
        member and the minus-strata estimates of every non-member, with no
        paired (S, S u {i}) marginals, so whole sample blocks pack into
        single batches. Runs over reconstructed models; strata 0 and n-1
        are exact anchors, every other (partner, size) stratum gets one
        warm-up sample, then `budget` sampled coalitions
        (MPLC_TORCH_SVARM_SAMPLES; 0 or unset: max(4 n^2, 128))."""
        t0 = self._method_span("SVARM")
        logger.info("# Launching SVARM (stratified, marginal-free sampling)")
        n = self._n
        recon = self._recon_for(t0)
        full = tuple(range(n))
        v_all = float(recon.evaluate([full])[0])
        if n == 1:
            self._finish("SVARM", np.array([v_all]), np.array([0.0]), t0)
            return
        if budget is None:
            budget = constants.svarm_samples() or max(4 * n * n, 128)
        # exact anchors: strata s=0 (v({i}), v(empty)) and s=n-1
        # (v(N), v(N \ {i})) need no sampling at all
        recon.evaluate([(i,) for i in range(n)]
                       + [tuple(sorted(set(range(n)) - {i}))
                          for i in range(n)])
        vals = recon.values
        exact_plus = np.full((n, n), np.nan)
        exact_minus = np.full((n, n), np.nan)
        for i in range(n):
            exact_plus[i, 0] = vals[(i,)]
            exact_minus[i, 0] = 0.0
            exact_plus[i, n - 1] = v_all
            exact_minus[i, n - 1] = vals[tuple(sorted(set(range(n)) - {i}))]
        psum = np.zeros((n, n))
        psq = np.zeros((n, n))
        pcnt = np.zeros((n, n))
        msum = np.zeros((n, n))
        msq = np.zeros((n, n))
        mcnt = np.zeros((n, n))
        K_rep = 5  # pseudo-replica accumulators for the trust row
        rp = np.zeros((K_rep, n, n))
        rpc = np.zeros((K_rep, n, n))
        rm = np.zeros((K_rep, n, n))
        rmc = np.zeros((K_rep, n, n))

        # guaranteed coverage: one warm-up draw per non-exact stratum,
        # updating only its designated (sign, i, s) cell
        warm = svarm_warmup_draws(n, self._rng)
        recon.evaluate([w[3] for w in warm if w[3]])
        for sign, i, s, A in warm:
            v = vals[A] if A else 0.0
            if sign == "plus":
                psum[i, s] += v
                psq[i, s] += v * v
                pcnt[i, s] += 1
            else:
                msum[i, s] += v
                msq[i, s] += v * v
                mcnt[i, s] += 1

        it = 0
        drawn = 0
        # n < 3 has no non-exact stratum: the anchors above already
        # determine every phi exactly and svarm_batch_draws returns []
        while n >= 3 and drawn < budget:
            # each draw is an (A+, A-) pair, two sampled coalitions, so the
            # coalition budget buys ceil(remaining / 2) pairs
            draws = svarm_batch_draws(
                n, min(block, max(1, (budget - drawn + 1) // 2)),
                self._rng)
            recon.evaluate([a for pair in draws for a in pair if a])
            for ap, am in draws:
                rep = it % K_rep
                it += 1
                va = vals[ap]
                sa = len(ap) - 1
                for i in ap:
                    if np.isnan(exact_plus[i, sa]):
                        psum[i, sa] += va
                        psq[i, sa] += va * va
                        pcnt[i, sa] += 1
                        rp[rep, i, sa] += va
                        rpc[rep, i, sa] += 1
                vb = vals[am] if am else 0.0
                sb = len(am)
                in_a = set(am)
                for i in range(n):
                    if i in in_a or not np.isnan(exact_minus[i, sb]):
                        continue
                    msum[i, sb] += vb
                    msq[i, sb] += vb * vb
                    mcnt[i, sb] += 1
                    rm[rep, i, sb] += vb
                    rmc[rep, i, sb] += 1
            drawn += 2 * len(draws)

        pmean = np.where(~np.isnan(exact_plus), np.nan_to_num(exact_plus),
                         psum / np.maximum(pcnt, 1))
        mmean = np.where(~np.isnan(exact_minus), np.nan_to_num(exact_minus),
                         msum / np.maximum(mcnt, 1))
        sv = (pmean - mmean).mean(axis=1)

        def sem2(sumv, sq, cnt):
            # variance of each stratum mean (unbiased sample variance /
            # count); exact strata carry count 0 and contribute 0
            c = np.maximum(cnt, 1)
            var = np.maximum(sq / c - (sumv / c) ** 2, 0.0)
            var = np.where(cnt > 1, var * cnt / np.maximum(cnt - 1, 1), 0.0)
            return np.where(cnt > 0, var / c, 0.0)

        var_i = (sem2(psum, psq, pcnt) + sem2(msum, msq, mcnt)).sum(axis=1) \
            / n ** 2
        std = np.sqrt(var_i)

        reps = np.zeros((K_rep, n))
        for r in range(K_rep):
            pm = np.where(~np.isnan(exact_plus), np.nan_to_num(exact_plus),
                          np.where(rpc[r] > 0,
                                   rp[r] / np.maximum(rpc[r], 1), pmean))
            mm = np.where(~np.isnan(exact_minus),
                          np.nan_to_num(exact_minus),
                          np.where(rmc[r] > 0,
                                   rm[r] / np.maximum(rmc[r], 1), mmean))
            reps[r] = (pm - mm).mean(axis=1)
        self.trust = {**trust_from_replicas(reps, alpha, source="mc_blocks"),
                      "method": "SVARM"}
        obs_trace.event("contrib.trust", **self.trust)
        self._finish("SVARM", sv, std, t0)

    # ------------------------------------------------------------------
    # Federated step-by-step scores (history post-processing)
    # ------------------------------------------------------------------

    def compute_relative_perf_matrix(self):
        """Per round, each partner's val accuracy over the collective
        model's, 10% of the rounds skipped at each end: [rounds, P]."""
        init_skip = 0.1
        final_skip = 0.1
        mpl = self.scenario.mpl
        coll = np.asarray(mpl.history.history["mpl_model"]["val_accuracy"])
        partner_mats = [np.asarray(v["val_accuracy"])
                        for k, v in mpl.history.history.items() if k != "mpl_model"]
        per_partner = np.stack(partner_mats, axis=-1)  # [E, MB, P]
        E, MB, P = per_partner.shape
        first = int(np.round(E * MB * init_skip))
        last = int(np.round(E * MB * (1 - final_skip)))
        coll_flat = coll.reshape(E * MB)
        per_flat = per_partner.reshape(E * MB, P)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.divide(per_flat, coll_flat[:, None])
        return rel[first:last, :]

    def _sbs(self, importance_fn, name):
        t0 = self._method_span(name)
        rel = self.compute_relative_perf_matrix()
        scores = importance_fn(rel.shape[0]) @ np.nan_to_num(rel)
        self._finish(name, scores, np.zeros(self._n), t0)

    def federated_SBS_linear(self):
        logger.info("# Federated SBS linear")
        self._sbs(lambda r: np.arange(r, dtype=float),
                  "Federated step by step linear scores")

    def federated_SBS_quadratic(self):
        logger.info("# Federated SBS quadratic")
        self._sbs(lambda r: np.square(np.arange(r, dtype=float)),
                  "Federated step by step quadratic scores")

    def federated_SBS_constant(self):
        t0 = self._method_span("Federated step by step constant scores")
        logger.info("# Federated SBS constant")
        scores = np.nanmean(self.compute_relative_perf_matrix(), axis=0)
        self._finish("Federated step by step constant scores", scores,
                     np.zeros(self._n), t0)

    # ------------------------------------------------------------------
    # LFlip and PVRL
    # ------------------------------------------------------------------

    def flip_label(self):
        """Train MplLabelFlip; partner i scores exp(-||theta_i - I||_F) of
        its last epoch's theta."""
        t0 = self._method_span("Label Flip")
        from ..mpl.approaches import MplLabelFlip
        mpl = MplLabelFlip(self.scenario)
        mpl.fit()
        self.thetas_history = mpl.history.theta
        self.score = mpl.history.score
        last = mpl.history.theta[-1]
        scores = np.exp(-np.array([
            np.linalg.norm(last[i] - np.identity(last[i].shape[0]))
            for i in range(self._n)]))
        self._finish("Label Flip", scores, np.zeros(self._n), t0)

    def _pvrl_start(self, trainer: MplTrainer):
        """(generators, initial params, streams) of PVRL's run: one
        generator seeded seed + 99 draws the initial params and every
        epoch's streams, so epoch e draws what epoch e of one E-epoch run
        would (None, None). The parity tests substitute the JAX package's
        initial params and per-epoch streams ([1, E, ...]) here."""
        return [torch.Generator().manual_seed(int(self.scenario.seed) + 99)], None, None

    def PVRL(self, learning_rate):
        """Per-epoch Bernoulli partner selection trained by REINFORCE on the
        val-loss improvement, the selection being the epoch's coalition
        mask; the probabilities in the gradient are clamped and the logits
        bounded, so the update never produces inf or NaN."""
        t0 = self._method_span("PVRL")
        logger.info("# Launching PVRL")
        sc = self.scenario
        n = self._n
        eng = self.engine
        cfg = TrainConfig(
            approach=sc.multi_partner_learning_approach_key,
            aggregator=sc.aggregation_name,
            epoch_count=sc.epoch_count,
            minibatch_count=sc.minibatch_count,
            gradient_updates_per_pass=sc.gradient_updates_per_pass_count,
            is_early_stopping=False,
            compute_dtype=sc.compute_dtype,
            record_partner_val=False,
            # the reward comes from a fresh end-of-epoch eval below
            record_val_history=False,
        )
        trainer = MplTrainer(sc.dataset.model, cfg)
        generators, init_params, streams = self._pvrl_start(trainer)
        state = trainer.init_state(generators, n, eng.device, init_params)

        def val_loss():
            return float(trainer.evaluate_models(state.params, eng.val)[0][0])

        w = np.zeros(n)
        values = 1.0 / (1.0 + np.exp(-w))
        prev_loss = val_loss()
        for epoch in range(sc.epoch_count):
            is_in = np.zeros(n)
            while is_in.sum() == 0:
                is_in = self._rng.binomial(1, p=values)
            mask = torch.tensor(is_in[None], dtype=torch.float32, device=eng.device)
            trainer.run_epoch(state, eng.stacked, eng.val, mask, generators,
                              epoch_streams(streams, epoch))
            # the reward from the end-of-epoch model
            loss = val_loss()
            G = -loss + prev_loss
            dp_dw = np.exp(w) / (1 + np.exp(w)) ** 2
            safe = np.clip(values, 1e-6, 1.0 - 1e-6)
            prodp = np.prod(safe)
            grad = (is_in / safe - (1.0 - is_in) / (1.0 - safe)
                    - prodp / (1.0 - prodp) / (1.0 - safe))
            w = np.clip(w + learning_rate * G * dp_dw * grad, -10.0, 10.0)
            values = 1.0 / (1.0 + np.exp(-w))
            prev_loss = loss
        self._finish("PVRL", values, np.zeros(n), t0)

    def compute_contributivity(self, method_to_compute, sv_accuracy=0.01,
                               alpha=0.95, truncation=0.05, update=50,
                               accuracy_target=None, deadline_sec=None):
        """Run `method_to_compute`; the engine batches it trains are kept in
        `batches_trained`."""
        first = len(self.engine.batch_log)
        fedavg_only = ("Federated SBS linear", "Federated SBS quadratic",
                       "Federated SBS constant")
        if method_to_compute in fedavg_only and \
                self.scenario.multi_partner_learning_approach_key != "fedavg":
            logger.warning("Step by step contributivity methods are only suited "
                           "for federated averaging learning approaches")
        if method_to_compute == "auto":
            # the planner resolves (game size, accuracy target, deadline)
            # to a concrete estimator; the plan is kept and the concrete
            # method runs, so repeating the plan never plans again
            eval_sec, basis = estimate_eval_seconds(self.engine)
            plan = plan_query(self._n, accuracy_target, deadline_sec,
                              eval_sec=eval_sec, cost_basis=basis,
                              live=False)
            self.plan = plan
            obs_trace.event("contrib.plan", **plan.describe())
            if plan.method == "exact":
                # the planner's exact row is the retrain-free exact
                # powerset, not the retraining sweep ("Shapley values")
                self.exact_reconstructed(alpha=alpha)
            elif plan.method == "GTG-Shapley":
                self.GTG_Shapley(alpha=alpha, **plan.method_kw)
            else:
                self.SVARM(alpha=alpha, **plan.method_kw)
        elif method_to_compute == "Shapley values":
            self.compute_SV()
        elif method_to_compute == "Independent scores":
            self.compute_independent_scores()
        elif method_to_compute == "TMCS":
            self.truncated_MC(sv_accuracy=sv_accuracy, alpha=alpha,
                              truncation=truncation)
        elif method_to_compute == "ITMCS":
            self.interpol_TMC(sv_accuracy=sv_accuracy, alpha=alpha,
                              truncation=truncation)
        elif method_to_compute == "IS_lin_S":
            self.IS_lin(sv_accuracy=sv_accuracy, alpha=alpha)
        elif method_to_compute == "IS_reg_S":
            self.IS_reg(sv_accuracy=sv_accuracy, alpha=alpha)
        elif method_to_compute == "AIS_Kriging_S":
            self.AIS_Kriging(sv_accuracy=sv_accuracy, alpha=alpha, update=update)
        elif method_to_compute == "SMCS":
            self.Stratified_MC(sv_accuracy=sv_accuracy, alpha=alpha)
        elif method_to_compute == "WR_SMC":
            self.without_replacment_SMC(sv_accuracy=sv_accuracy, alpha=alpha)
        elif method_to_compute == "GTG-Shapley":
            # truncation=None: GTG's own within-round threshold, not TMCS's
            self.GTG_Shapley(sv_accuracy=sv_accuracy, alpha=alpha)
        elif method_to_compute == "SVARM":
            self.SVARM(alpha=alpha)
        elif method_to_compute == "Federated SBS linear":
            self.federated_SBS_linear()
        elif method_to_compute == "Federated SBS quadratic":
            self.federated_SBS_quadratic()
        elif method_to_compute == "Federated SBS constant":
            self.federated_SBS_constant()
        elif method_to_compute == "PVRL":
            self.PVRL(learning_rate=0.2)
        elif method_to_compute == "LFlip":
            self.flip_label()
        else:
            logger.warning("Unrecognized name of method, statement ignored!")
        self.batches_trained = self.engine.batch_log[first:]
