"""Contributivity measurement (port of `mplc_tpu/contrib/contributivity.py`:
exact Shapley values and independent scores over retrained coalitions,
GTG-Shapley and exact Shapley over reconstructed models).

Same API as the JAX package: `Contributivity(scenario)` +
`compute_contributivity(method_name)`, filling `contributivity_scores`,
`scores_std`, `normalized_scores` and `computation_time_sec`. The other
methods the JAX package knows raise NotImplementedError until their slice
is ported (ROADMAP.md); a name it does not know is logged and ignored.
"""

from __future__ import annotations

import datetime
import logging
import time

import numpy as np
from scipy.stats import norm

from .. import constants
from .engine import CharacteristicEngine
from .shapley import powerset_order, shapley_from_characteristic, trust_from_replicas

logger = logging.getLogger("mplc_tpu_torch")


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
        # stability over disjoint sample blocks), set by GTG-Shapley
        self.trust = None
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
        out += f"Contributivity scores: {np.round(self.contributivity_scores, 3)}\n"
        out += f"Std of the contributivity scores: {np.round(self.scores_std, 3)}\n"
        out += f"Normalized contributivity scores: {np.round(self.normalized_scores, 3)}\n"
        return out

    @property
    def first_charac_fct_calls_count(self):
        return self.engine.first_charac_fct_calls_count

    def _finish(self, name, scores, std, t0):
        self.name = name
        self.contributivity_scores = np.asarray(scores, float)
        self.scores_std = np.asarray(std, float)
        total = np.sum(self.contributivity_scores)
        self.normalized_scores = self.contributivity_scores / (total if total else 1.0)
        self.computation_time_sec = time.perf_counter() - t0

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
        Shapley sum; scores_std is exactly zero."""
        t0 = time.perf_counter()
        logger.info("# Launching computation of Shapley Value of all partners")
        n = self._n
        self.engine.evaluate(powerset_order(n))
        sv = shapley_from_characteristic(n, self.engine.charac_fct_values)
        self._finish("Shapley", sv, np.zeros(n), t0)

    def compute_independent_scores(self):
        """v({i}) of every partner: a model trained on its data alone
        (memo hits after a Shapley sweep)."""
        t0 = time.perf_counter()
        logger.info("# Launching computation of perf. scores of models trained "
                    "independently on each partner")
        n = self._n
        scores = self.engine.evaluate([(i,) for i in range(n)])
        self._finish("Independent scores raw", scores, np.zeros(n), t0)

    def _reconstructor(self):
        """The engine's shared ReconstructionEvaluator, recording the grand
        coalition on first use: one training run per scenario, reused by
        every retrain-free method."""
        eng = self.engine
        if getattr(eng, "_reconstruction", None) is None:
            from .reconstruct import ReconstructionEvaluator
            eng._reconstruction = ReconstructionEvaluator(eng)
        return eng._reconstruction

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

    def exact_reconstructed(self, alpha=0.95):
        """Exact Shapley over reconstructed coalition models: the full
        2^P - 1 powerset evaluated by the shared ReconstructionEvaluator
        (the one recorded grand-coalition run is the only training), then
        the closed-form Shapley sum; scores_std is exactly zero."""
        t0 = time.perf_counter()
        logger.info("# Launching exact Shapley over reconstructed models")
        n = self._n
        recon = self._reconstructor()
        recon.evaluate(powerset_order(n))
        sv = np.asarray(shapley_from_characteristic(n, recon.values))
        self._finish("exact (reconstructed)", sv, np.zeros(n), t0)

    def GTG_Shapley(self, sv_accuracy=0.01, alpha=0.95, truncation=None,
                    perm_batch=16, min_iter=100):
        """GTG-Shapley (arXiv:2109.02053): truncated-permutation Shapley
        over reconstructed coalition models. A permutation's remaining
        positions are pruned once |v(N) - v(prefix)| < `truncation`
        (default MPLC_TORCH_GTG_TRUNCATION, 0.05)."""
        t0 = time.perf_counter()
        logger.info("# Launching GTG-Shapley (retrain-free reconstruction)")
        n = self._n
        recon = self._reconstructor()
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

    def compute_contributivity(self, method_to_compute, sv_accuracy=0.01,
                               alpha=0.95):
        if method_to_compute == "Shapley values":
            self.compute_SV()
        elif method_to_compute == "Independent scores":
            self.compute_independent_scores()
        elif method_to_compute == "GTG-Shapley":
            # truncation=None: GTG's own within-round threshold
            self.GTG_Shapley(sv_accuracy=sv_accuracy, alpha=alpha)
        elif method_to_compute in constants.CONTRIBUTIVITY_METHODS:
            raise NotImplementedError(
                f"contributivity method '{method_to_compute}' is not ported "
                "yet (ROADMAP.md queue 1)")
        else:
            logger.warning("Unrecognized name of method, statement ignored!")
