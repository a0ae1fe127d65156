"""Subset samplers for the sampling Shapley estimators (a copy of
`mplc_tpu/contrib/sampling.py`, pure numpy; the port keeps its own).

The reference MPLC implementation draws each importance sample by walking
the full power set of N\\{k} with a Python loop: O(2^(n-1)) per draw, per
partner, per iteration. Here the same distributions come from precomputed,
vectorized tables:

  * `ExactSubsetSampler`: enumerates the subsets of N\\{k} once per refit
    (size-ascending, lexicographic within a size, the reference's order),
    evaluates the |approximate increment| over the whole table in one
    vectorized call, and turns each draw into a binary search over the
    cumulative distribution. The draw distribution and the importance
    weights are the reference's.

  * `SizeStratifiedSubsetSampler`: where enumeration is infeasible
    (m = n-1 > MAX_EXACT_BITS), an exact-weight two-stage proposal: draw
    the coalition size l from p_l proportional to P_shapley(l) C(m,l) g(l)
    (g = the probed mean |increment| per size, mixed with a uniform floor
    so every size keeps mass), then a uniform size-l subset. Because
    P_shapley(l) C(m,l) = 1/n exactly, the importance weight
    P(S)/q(S) = 1/(n p_l) is closed-form and the estimator stays unbiased
    for any probe quality: g shapes the variance, never the bias.

Both expose `draw(u, rng) -> (subset ndarray, weight)`, `weight` being the
multiplier of the observed increment in the Shapley estimator (the
reference's `renorm / |approx_increment(S)|`).

Also here: lexicographic combination unranking (the stratified methods'
uniform-subset draws as O(l m) arithmetic instead of enumeration walks), a
sparse without-replacement rank pool (WR_SMC never materializes all C(m,l)
subsets of a stratum), and SVARM's stratified draws.

Every function consumes its numpy Generator exactly as the JAX package's
copy does, call for call, so one seed gives the same draws in both.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import combinations
from math import comb, factorial

import numpy as np

# Above this many non-k partners the IS samplers switch from exact power-set
# tables (2^m rows) to the two-stage size-stratified proposal.
MAX_EXACT_BITS = 16


def shapley_size_prob(size: int, n: int) -> float:
    """P_shapley(S) for one |S|=size subset of N\\{k}: |S|!(n-1-|S|)!/n!."""
    return factorial(n - 1 - size) * factorial(size) / factorial(n)


@lru_cache(maxsize=4)
def combination_mask_table(m: int) -> tuple[np.ndarray, np.ndarray]:
    """All subsets of range(m) as a [2^m, m] bool matrix, in the reference's
    enumeration order (size-ascending, lexicographic within a size).
    Returns (masks, sizes-per-row). Cached: every per-partner sampler (and
    every AIS refit) shares one table — callers must treat it as
    read-only."""
    blocks = []
    sizes = []
    for length in range(m + 1):
        if length == 0:
            blocks.append(np.zeros((1, m), bool))
            sizes.append(np.zeros(1, int))
            continue
        idx = np.array(list(combinations(range(m), length)), int)
        rows = np.zeros((len(idx), m), bool)
        rows[np.arange(len(idx))[:, None], idx] = True
        blocks.append(rows)
        sizes.append(np.full(len(idx), length, int))
    return np.concatenate(blocks), np.concatenate(sizes)


def unrank_combination(m: int, length: int, rank: int) -> list[int]:
    """rank-th (0-based) size-`length` combination of range(m) in
    lexicographic order, without enumerating its predecessors."""
    out = []
    x = 0
    for i in range(length):
        while True:
            c = comb(m - x - 1, length - i - 1)
            if rank < c:
                out.append(x)
                x += 1
                break
            rank -= c
            x += 1
    return out


def randbelow(rng: np.random.Generator, n: int) -> int:
    """Uniform integer in [0, n) for arbitrarily large Python ints (numpy's
    integers() caps at int64; WR_SMC stratum cardinalities can exceed it)."""
    if n <= 0:
        raise ValueError("randbelow needs n >= 1")
    bits = n.bit_length()
    nbytes = (bits + 7) // 8
    while True:
        r = int.from_bytes(rng.bytes(nbytes), "little") >> (nbytes * 8 - bits)
        if r < n:
            return r


class WithoutReplacementRanks:
    """Sparse Fisher-Yates over ranks [0, total): pop a uniformly random
    not-yet-seen rank in O(1) time and O(draws) memory."""

    def __init__(self, total: int):
        self.total = total
        self._moved: dict[int, int] = {}

    def __len__(self):
        return self.total

    def pop_random(self, rng: np.random.Generator) -> int:
        if self.total <= 0:
            raise IndexError("pool exhausted")
        j = randbelow(rng, self.total)
        val = self._moved.get(j, j)
        last = self.total - 1
        self._moved[j] = self._moved.pop(last, last)
        if j == last:
            self._moved.pop(j, None)
        self.total = last
        return val


class ExactSubsetSampler:
    """Inverse-CDF sampler over all subsets of N\\{k}, weighted by
    P_shapley(|S|)·|approx_increment(S, k)| — the reference's IS proposal,
    tabulated once. `batch_fn(masks) -> [B] increments` is evaluated
    vectorized over the whole table at construction."""

    def __init__(self, n: int, k: int, batch_fn):
        self.n = n
        self.k = k
        self.members = np.delete(np.arange(n), k)
        m = n - 1
        self.masks, sizes = combination_mask_table(m)
        probs = np.array([shapley_size_prob(int(s), n) for s in range(m + 1)])
        self.f = np.abs(np.asarray(batch_fn(self.masks), float))
        w = probs[sizes] * self.f
        self.renorm = float(w.sum())
        if self.renorm <= 0:
            # degenerate model (all-zero increments): fall back to the
            # plain Shapley size distribution, weights handled below
            w = probs[sizes]
            self.renorm = float(w.sum())
            self.f = np.ones_like(self.f)
        self._cdf = np.cumsum(w) / self.renorm

    def draw(self, u: float, rng=None):
        idx = int(np.searchsorted(self._cdf, u, side="right"))
        idx = min(idx, len(self._cdf) - 1)
        subset = self.members[self.masks[idx]]
        weight = self.renorm / max(self.f[idx], 1e-300)
        return subset, weight


class SizeStratifiedSubsetSampler:
    """Two-stage exact-weight proposal for large n (see module docstring)."""

    def __init__(self, n: int, k: int, batch_fn, rng: np.random.Generator,
                 probes_per_size: int = 8, uniform_mix: float = 0.05):
        self.n = n
        self.k = k
        self.members = np.delete(np.arange(n), k)
        m = n - 1
        g = np.zeros(m + 1)
        for length in range(m + 1):
            rows = np.zeros((probes_per_size, m), bool)
            for r in range(probes_per_size):
                if length:
                    rows[r, rng.choice(m, length, replace=False)] = True
            g[length] = float(np.mean(np.abs(np.asarray(
                batch_fn(rows), float))))
        total = g.sum()
        if total <= 0:
            g = np.ones(m + 1)
            total = g.sum()
        p = (1 - uniform_mix) * g / total + uniform_mix / (m + 1)
        self._p = p
        self._cdf = np.cumsum(p)
        # P_shapley(l)·C(m,l) = l!(n-1-l)!/n! · (n-1)!/(l!(n-1-l)!) = 1/n
        self._weight_per_size = 1.0 / (n * p)

    def draw(self, u: float, rng: np.random.Generator):
        length = int(np.searchsorted(self._cdf, u, side="right"))
        length = min(length, len(self._cdf) - 1)
        if length:
            subset = np.sort(rng.choice(self.members, length, replace=False))
        else:
            subset = np.array([], int)
        return subset, float(self._weight_per_size[length])


# ---------------------------------------------------------------------------
# SVARM stratified sampling ("Approximating the Shapley Value without
# Marginal Contributions", arXiv:2302.00736). The Shapley value splits as
#
#   phi_i = (1/n) * sum_{s=0}^{n-1} (phi+_{i,s} - phi-_{i,s}),
#   phi+_{i,s} = E[v(S u {i})],  phi-_{i,s} = E[v(S)]   over uniform
#                size-s subsets S of N \ {i}
#
# so ONE sampled coalition A updates phi+ estimates for every i in A
# (stratum |A|-1) and phi- estimates for every i not in A (stratum |A|) —
# no paired (S, S u {i}) marginal evaluations at all, which is what lets a
# whole sample block pack into one eval batch. Uniformity is inherited:
# A uniform among size-s sets, conditioned on i in A, has A \ {i} uniform
# among size-(s-1) subsets of N \ {i}.
# ---------------------------------------------------------------------------

def svarm_warmup_draws(n: int, rng: np.random.Generator
                       ) -> list[tuple[str, int, int, tuple]]:
    """One guaranteed sample per non-exact stratum: for every partner i
    and size s in 1..n-2, one uniform S subset of N\\{i} for the minus
    estimator and its i-joined set for the plus estimator. (Strata s=0 and
    s=n-1 are exact anchors — v({i}), v(empty), v(N), v(N\\{i}) — and need
    no samples.) Returns (sign, i, s, coalition) entries; each warm-up
    coalition updates ONLY its designated stratum, keeping every stratum
    mean a mean of uniform draws."""
    draws = []
    for i in range(n):
        others = np.delete(np.arange(n), i)
        for s in range(1, n - 1):
            sp = rng.choice(others, s, replace=False)
            draws.append(("plus", i, s,
                          tuple(sorted([int(x) for x in sp] + [i]))))
            sm = rng.choice(others, s, replace=False)
            draws.append(("minus", i, s,
                          tuple(sorted(int(x) for x in sm))))
    return draws


def svarm_batch_draws(n: int, block: int, rng: np.random.Generator
                      ) -> list[tuple[tuple, tuple]]:
    """`block` main-loop iterations of (A_plus, A_minus) coalition pairs:
    A_plus uniform among sets of a uniform size 2..n-1 (updates plus
    strata for its members), A_minus uniform among sets of a uniform
    size 1..n-2 (updates minus strata for its non-members). Sizes that
    would only touch the exact anchor strata (|A+| in {1, n}, |A-| in
    {0, n-1}) are excluded — their updates are skipped anyway, so
    sampling them would burn budget on no-op evaluations; conditional
    uniformity within each remaining stratum is unchanged. n < 3 has no
    non-exact stratum at all: returns [] (the caller's sampling loop
    must not spin on an empty block)."""
    if n < 3:
        return []
    out = []
    for _ in range(block):
        sp = int(rng.integers(2, n))
        ap = tuple(sorted(int(x) for x in
                          rng.choice(n, sp, replace=False)))
        sm = int(rng.integers(1, n - 1))
        am = tuple(sorted(int(x) for x in
                          rng.choice(n, sm, replace=False)))
        out.append((ap, am))
    return out


def make_importance_sampler(n: int, k: int, batch_fn,
                            rng: np.random.Generator,
                            max_exact_bits: int = MAX_EXACT_BITS):
    if n - 1 <= max_exact_bits:
        return ExactSubsetSampler(n, k, batch_fn)
    return SizeStratifiedSubsetSampler(n, k, batch_fn, rng)
