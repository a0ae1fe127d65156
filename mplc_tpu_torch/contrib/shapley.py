"""Exact Shapley values from a characteristic-function table, and the trust
row of seed ensembles and Monte-Carlo estimates (a copy of
`mplc_tpu/contrib/shapley.py`, pure numpy).

Exact Shapley is direct bit-twiddling over coalition bitmasks: O(n 2^n)
with O(1) lookups. The trust helpers turn a [K, n] matrix of replica
Shapley vectors into per-partner confidence intervals and a Kendall-tau
rank-stability score.
"""

from __future__ import annotations

from math import factorial

import numpy as np


def subset_to_bitmask(subset) -> int:
    m = 0
    for i in subset:
        m |= 1 << int(i)
    return m


def bitmask_to_subset(mask: int) -> tuple:
    """The sorted partner indices of a membership bitmask."""
    out = []
    i = 0
    while mask:
        if mask & 1:
            out.append(i)
        mask >>= 1
        i += 1
    return tuple(out)


def powerset_order(n: int) -> list[tuple]:
    """The reference's coalition enumeration order: all subsets sorted by
    size then lexicographically (contributivity.py:149-151) — kept for
    results parity in logs/CSV."""
    from itertools import combinations
    return [tuple(c) for k in range(1, n + 1) for c in combinations(range(n), k)]


def shapley_from_characteristic(n: int, value_of: dict) -> np.ndarray:
    """value_of: dict mapping sorted subset tuple -> v(S); v(empty)=0.

    SV_i = sum_{S not containing i} |S|! (n-|S|-1)! / n! * (v(S+i) - v(S)).
    """
    v = np.zeros(1 << n)
    for subset, val in value_of.items():
        v[subset_to_bitmask(subset)] = val
    weights = np.array([factorial(k) * factorial(n - k - 1) / factorial(n)
                        for k in range(n)])
    sv = np.zeros(n)
    for mask in range(1 << n):
        size = bin(mask).count("1")
        for i in range(n):
            if not (mask >> i) & 1:
                sv[i] += weights[size] * (v[mask | (1 << i)] - v[mask])
    return sv


# ---------------------------------------------------------------------------
# Trust row: CI + rank stability over K replica Shapley vectors
# ---------------------------------------------------------------------------

def shapley_sample_matrix(n: int, samples_of: dict) -> np.ndarray:
    """[K, n] per-replica Shapley values from a replica-valued table
    (`samples_of`: sorted subset tuple -> [K] array,
    CharacteristicEngine.charac_fct_samples): replica j's Shapley vector
    from replica j's v(S), K games in one table."""
    if not samples_of:
        raise ValueError("empty replica table — run a seed-ensemble sweep "
                         "(seed_ensemble > 1) first")
    K = len(next(iter(samples_of.values())))
    rows = []
    for j in range(K):
        rows.append(shapley_from_characteristic(
            n, {s: float(arr[j]) for s, arr in samples_of.items()}))
    return np.stack(rows)


def kendall_tau(a, b) -> float:
    """Kendall's tau-a between the rankings induced by two score vectors:
    (concordant - discordant) / (n choose 2) over all index pairs. Ties
    count as discordant-free zeros; n < 2 returns 1.0 (a single partner
    cannot be mis-ranked)."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    n = len(a)
    if n < 2:
        return 1.0
    conc = disc = 0
    for i in range(n):
        for j in range(i + 1, n):
            s = (a[i] - a[j]) * (b[i] - b[j])
            if s > 0:
                conc += 1
            elif s < 0:
                disc += 1
    return (conc - disc) / (n * (n - 1) / 2)


def rank_stability(sv_samples: np.ndarray) -> float:
    """Mean pairwise Kendall tau across the K replicas' Shapley rankings:
    1.0 = every seed agrees on the partner ordering, values near 0 = the
    ranking is noise (the volatility failure mode). K = 1 returns 1.0."""
    K = sv_samples.shape[0]
    if K < 2:
        return 1.0
    taus = [kendall_tau(sv_samples[i], sv_samples[j])
            for i in range(K) for j in range(i + 1, K)]
    return float(np.mean(taus))


def confidence_intervals(sv_samples: np.ndarray, alpha: float = 0.95
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mean, ci_low, ci_high) per partner over the K replica Shapley
    vectors: a Student-t interval on the mean at confidence `alpha`
    (half-width t_{K-1} * s / sqrt(K)). K = 1 collapses to zero-width
    intervals at the point estimate."""
    sv_samples = np.asarray(sv_samples, float)
    K = sv_samples.shape[0]
    mean = sv_samples.mean(axis=0)
    if K < 2:
        return mean, mean.copy(), mean.copy()
    from scipy.stats import t
    half = (t.ppf(0.5 + alpha / 2.0, K - 1)
            * sv_samples.std(axis=0, ddof=1) / np.sqrt(K))
    return mean, mean - half, mean + half


def trust_from_replicas(sv_samples, alpha: float = 0.95,
                        source: str = "replicas") -> dict:
    """The `trust` row dict from an explicit [K, n] replica Shapley
    matrix. Two producers share it: seed ensembles (replicas = independent
    seeds, `trust_summary`, source="seed_ensemble") and the retrain-free
    Monte-Carlo estimators (replicas = disjoint sample blocks of one run,
    source="mc_blocks"). Plain lists and floats, JSON-ready."""
    sv = np.asarray(sv_samples, float)
    n = sv.shape[1]
    mean, lo, hi = confidence_intervals(sv, alpha)
    std = (sv.std(axis=0, ddof=1) if sv.shape[0] > 1
           else np.zeros(n))
    return {
        "ensemble": int(sv.shape[0]),
        "source": source,
        "alpha": float(alpha),
        "mean": [float(x) for x in mean],
        "std": [float(x) for x in std],
        "ci_low": [float(x) for x in lo],
        "ci_high": [float(x) for x in hi],
        "kendall_tau": rank_stability(sv),
    }


def trust_summary(n: int, samples_of: dict, alpha: float = 0.95) -> dict:
    """The exact sweep's trust row over a seed ensemble: per-partner
    Shapley mean / std / CI bounds and the Kendall-tau rank stability."""
    return trust_from_replicas(shapley_sample_matrix(n, samples_of), alpha,
                               source="seed_ensemble")
