"""DPVS-style dynamic coalition pruning for the live tier (port of
`mplc_tpu/live/dpvs.py`).

DPVS-Shapley (arXiv:2410.15093) prunes low-contribution participants from
the coalition-evaluation schedule. Here, against a live game's resident
round history:

  - **Information scores.** Each partner p gets
    `s_p = sum_r |w_h[r, p]| * ||delta_p^r||_2` over the game's recorded
    rounds: the weighted parameter motion the partner contributed to the
    grand-coalition trajectory. Zero-weight rounds and a dropped partner's
    exact-zero deltas score 0.
  - **Pruning rule.** With threshold tau in (0, 1], partners with
    `s_p < tau * max_q s_q` are low-information. A requested coalition S
    is projected onto the others (`proj(S) = S minus the low set`), and
    every coalition sharing a projection is served the projection's value
    from one evaluation, so pruned partners carry exact-zero marginals.
  - **Off switch.** tau = 0 (the MPLC_TORCH_LIVE_PRUNE_TAU default)
    disables pruning: the query never builds a `PrunedReconstruction`, and
    its values are the unpruned reconstruction's bit for bit.

The pruning signal is derived after the fact from the recorded update
stream (the only signal a retrain-free game has), and pruning selects
coalitions to evaluate; it filters no partner out of training.

A round's deltas are a dict of host arrays, `{layer: {name: [P, ...]}}`;
scores visit the leaves in sorted key order, as the JAX package's pytree
walk does.
"""

from __future__ import annotations

import numpy as np

from ..obs import metrics as obs_metrics


def _leaves(tree) -> list:
    """The leaves of a nested dict, keys sorted at every level (the order
    `jax.tree_util.tree_leaves` visits a dict in)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def info_scores(rounds, partners_count: int) -> np.ndarray:
    """Per-partner information score over `rounds`, a list of
    `(deltas, weights)` pairs with host-array leaves of shape `[P, ...]` /
    `[P]`: `s_p = sum_r |w[r, p]| * ||delta_p^r||_2` (the L2 norm over
    every parameter leaf of round r's partner-p delta), in float64."""
    s = np.zeros(partners_count, float)
    for deltas, weights in rounds:
        sq = np.zeros(partners_count, float)
        for leaf in _leaves(deltas):
            flat = np.asarray(leaf, float).reshape(partners_count, -1)
            sq += np.sum(flat * flat, axis=1)
        s += np.abs(np.asarray(weights, float)) * np.sqrt(sq)
    return s


def low_information(scores: np.ndarray, tau: float) -> frozenset:
    """The pruned-partner set for threshold `tau`: partners whose score
    falls below `tau * max(scores)`. The max-scoring partner is never
    pruned (strict inequality), and an all-zero score vector prunes
    nobody."""
    if tau <= 0 or scores.size == 0:
        return frozenset()
    mx = float(scores.max())
    if mx <= 0:
        return frozenset()
    return frozenset(int(i) for i in np.nonzero(scores < tau * mx)[0])


class PrunedReconstruction:
    """A coalition-selection policy around a `ReconstructionEvaluator`:
    requested coalitions are projected onto the high-information partners
    and served from the projection's value. It has the evaluator's
    estimator-facing surface (`evaluate` and a `values` memo), so every
    live query method runs against it unchanged."""

    def __init__(self, recon, low: frozenset):
        self.recon = recon
        self.low = low
        self.values: dict[tuple, float] = {(): 0.0}
        # coalitions served from a projected representative instead of
        # their own evaluation (the DPVS saving)
        self.pruned = 0

    @property
    def reconstructions(self) -> int:
        return self.recon.reconstructions

    def _project(self, key: tuple) -> tuple:
        return tuple(i for i in key if i not in self.low)

    def evaluate(self, subsets) -> np.ndarray:
        keys = [tuple(sorted(int(i) for i in s)) for s in subsets]
        unique = [k for k in dict.fromkeys(keys) if k not in self.values]
        proj = {k: self._project(k) for k in unique}
        need = [p for p in dict.fromkeys(proj.values()) if p]
        if need:
            self.recon.evaluate(need)
        pruned = 0
        for k in unique:
            p = proj[k]
            if k != p:
                pruned += 1
            self.values[k] = self.recon.values[p] if p else 0.0
        if pruned:
            self.pruned += pruned
            obs_metrics.counter("live.pruned_coalitions").inc(pruned)
        return np.array([self.values[k] for k in keys])
