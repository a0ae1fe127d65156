"""Hierarchical (grouped) Shapley: live queries past the 16-partner exact
wall (port of `mplc_tpu/live/hierarchy.py`).

Exact live queries build the 2^P host table, so `live/game.py` caps them at
16 partners. Past it, partners are grouped by their DPVS info scores
(live/dpvs.py): coalitions of CLUSTERS are evaluated exactly (at most 16
clusters, through the same batched evaluator), then each cluster's macro
Shapley value is split among its members:

  - a cluster of one: the member takes the macro value (exact);
  - up to `INTRA_EXACT_MAX` members: an exact Shapley split of the
    subgame restricted to the cluster, shifted by each member's share of
    the synergy residual (the macro value minus the subgame sum), so
    efficiency holds exactly: `phi_i = psi_i + (PHI_C - sum(psi)) / |C|`;
  - larger clusters: split in proportion to the members' info scores
    (equal shares when all are zero).

Efficiency holds by construction at every rung, so `sum(scores) ==
v(grand coalition)` up to float rounding whatever the cluster count.

Grouped Shapley is exact only when partners interact through their
cluster alone: the within-cluster split ignores cross-cluster synergies
below the macro level. Clustering on DPVS scores puts same-signal
partners, whose cross terms matter most, in one cluster.
"""

from __future__ import annotations

import math
from itertools import combinations

import numpy as np

from .. import constants
from .dpvs import low_information

#: intra-cluster exact-split ceiling: up to this many members, a cluster
#: is split by an exact subgame Shapley (2^size extra evaluations);
#: larger clusters fall back to the info-score-proportional split
INTRA_EXACT_MAX = 12

#: coalitions of clusters ride the exact 2^k host table, so the cluster
#: count inherits the exact wall
MAX_CLUSTERS = 16


def default_clusters(partners_count: int) -> int:
    """The auto cluster count: ceil(sqrt(P)) clamped to [2, 16] — keeps
    both the macro powerset (2^k) and the intra subgames (~2^(P/k))
    small for the partner counts the live tier serves."""
    p = max(1, int(partners_count))
    return max(2, min(MAX_CLUSTERS, math.isqrt(p - 1) + 1))


def resolve_clusters(partners_count: int,
                     clusters: "int | None" = None) -> int:
    """The effective cluster count: explicit argument, else the
    MPLC_TORCH_LIVE_CLUSTERS knob, else the auto heuristic. An explicit
    out-of-range argument fails fast (the usual knob contract)."""
    if clusters is None:
        k = constants._env_nonneg_int(constants.LIVE_CLUSTERS_ENV, 0)
        if k > MAX_CLUSTERS:
            import warnings
            warnings.warn(
                f"{constants.LIVE_CLUSTERS_ENV}={k} exceeds the exact "
                f"wall; clamped to {MAX_CLUSTERS}", stacklevel=3)
            k = MAX_CLUSTERS
        clusters = k if k else default_clusters(partners_count)
    k = int(clusters)
    if not 1 <= k <= MAX_CLUSTERS:
        raise ValueError(
            f"hierarchical cluster count must be in [1, {MAX_CLUSTERS}] "
            f"(coalitions of clusters ride the exact 2^k table), got {k}")
    return k


def resolve_cluster_tau(cluster_tau: "float | None" = None) -> float:
    """The effective tail threshold: explicit argument (fail-fast on
    out-of-range), else the MPLC_TORCH_LIVE_CLUSTER_TAU knob (degrades
    to 0 with a warning — the typo'd-knob contract)."""
    if cluster_tau is None:
        tau = constants._env_nonneg_float(
            constants.LIVE_CLUSTER_TAU_ENV, 0.0)
        if tau > 1.0:
            import warnings
            warnings.warn(
                f"{constants.LIVE_CLUSTER_TAU_ENV}={tau} is outside "
                "[0, 1]; tail clustering disabled", stacklevel=3)
            tau = 0.0
        return tau
    tau = float(cluster_tau)
    if not 0.0 <= tau <= 1.0:
        raise ValueError(f"cluster_tau must be in [0, 1], got {tau}")
    return tau


def cluster_partners(scores, clusters: int, tau: float = 0.0) -> tuple:
    """Deterministic score-balanced clustering: partners ordered by
    descending DPVS info score (index-tiebroken) are chopped into
    `clusters` contiguous near-equal chunks, so same-signal partners —
    whose cross-cluster synergies the split would otherwise lose — share
    a cluster. With `tau` > 0, partners scoring below tau x max
    (`dpvs.low_information`; the max scorer never qualifies) are pulled
    into ONE shared tail cluster appended last. Returns a tuple of
    clusters, each a sorted tuple of partner indices."""
    scores = np.asarray(scores, float)
    P = int(scores.size)
    if P == 0:
        return ()
    k = int(clusters)
    if not 1 <= k <= MAX_CLUSTERS:
        raise ValueError(
            f"cluster count must be in [1, {MAX_CLUSTERS}], got {k}")
    tail = tuple(sorted(low_information(scores, tau))) if tau > 0 else ()
    core = sorted((p for p in range(P) if p not in tail),
                  key=lambda p: (-scores[p], p))
    out = []
    if core:
        k_core = max(1, min(k - (1 if tail else 0), len(core)))
        base, extra = divmod(len(core), k_core)
        start = 0
        for j in range(k_core):
            size = base + (1 if j < extra else 0)
            out.append(tuple(sorted(core[start:start + size])))
            start += size
    if tail:
        out.append(tail)
    return tuple(out)


def estimate_evaluations(partners_count: int, clusters: int) -> int:
    """The planner's cost model for a hierarchical query: the macro
    cluster powerset plus every exact intra split, assuming near-equal
    chunks (info scores — and any tau tail — are unknown at plan
    time)."""
    n = int(partners_count)
    k = max(1, min(int(clusters), n))
    total = (1 << k) - 1
    base, extra = divmod(n, k)
    for j in range(k):
        size = base + (1 if j < extra else 0)
        if 1 < size <= INTRA_EXACT_MAX:
            total += (1 << size) - 1
    return total


def hierarchical_shapley(ev, partners_count: int, info,
                         clusters: "int | None" = None,
                         cluster_tau: "float | None" = None
                         ) -> "tuple[np.ndarray, dict]":
    """Grouped Shapley against evaluator `ev` (a
    `ReconstructionEvaluator` or `PrunedReconstruction` — anything with
    the batched `evaluate(subsets) -> values` surface). `info` is the
    game's per-partner DPVS score vector. Returns `(scores, detail)`
    with `detail` JSON-ready for spans/tests. Fully deterministic given
    (ev, info, clusters, cluster_tau) — a journaled plan's frozen kwargs
    replay bit-identically."""
    from ..contrib.shapley import shapley_from_characteristic

    n = int(partners_count)
    info = np.asarray(info, float)
    k = resolve_clusters(n, clusters)
    tau = resolve_cluster_tau(cluster_tau)
    groups = cluster_partners(info, k, tau)
    m = len(groups)

    # every coalition the query needs, evaluated in ONE batched call:
    # cluster unions for the macro game, member powersets for the exact
    # intra splits (full-cluster sets overlap the singleton unions —
    # dict.fromkeys dedups, the evaluator memo would anyway)
    union_of = {}
    for size in range(1, m + 1):
        for T in combinations(range(m), size):
            union_of[T] = tuple(sorted(
                p for j in T for p in groups[j]))
    intra_of = {}
    for j, C in enumerate(groups):
        if 1 < len(C) <= INTRA_EXACT_MAX:
            intra_of[j] = [tuple(c)
                           for s in range(1, len(C) + 1)
                           for c in combinations(C, s)]
    todo = list(dict.fromkeys(
        list(union_of.values())
        + [s for subs in intra_of.values() for s in subs]))
    vals = ev.evaluate(todo)
    v = {s: float(x) for s, x in zip(todo, vals)}

    macro_sv = shapley_from_characteristic(
        m, {T: v[members] for T, members in union_of.items()})

    scores = np.zeros(n)
    exact_splits = proportional_splits = 0
    for j, C in enumerate(groups):
        phi = float(macro_sv[j])
        size = len(C)
        if size == 1:
            scores[C[0]] = phi
        elif j in intra_of:
            sub = {S: v[tuple(C[i] for i in S)]
                   for s in range(1, size + 1)
                   for S in combinations(range(size), s)}
            psi = shapley_from_characteristic(size, sub)
            residual = (phi - float(psi.sum())) / size
            for i, p in enumerate(C):
                scores[p] = float(psi[i]) + residual
            exact_splits += 1
        else:
            w = info[list(C)]
            tot = float(w.sum())
            share = w / tot if tot > 0 else np.full(size, 1.0 / size)
            for i, p in enumerate(C):
                scores[p] = phi * float(share[i])
            proportional_splits += 1

    detail = {
        "clusters": [list(c) for c in groups],
        "cluster_tau": tau,
        "macro_coalitions": (1 << m) - 1,
        "coalitions_evaluated": len(todo),
        "exact_splits": exact_splits,
        "proportional_splits": proportional_splits,
    }
    return scores, detail
