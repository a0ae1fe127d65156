"""Value drift diffing (port of the value half of
`mplc_tpu/obs/numerics.py`).

Two runs' v(S) over the same coalitions (two precision modes, two devices)
diff into per-coalition ulp distances, a log2 ulp histogram and the Kendall
tau-b of the induced value ranking (`diff_values`): a run in a non-fp32
precision mode is held against fp32 this way. The JAX module's persistent
value ledger and its per-device reduction audit are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import struct

import numpy as np


# ---------------------------------------------------------------------------
# float forensics
# ---------------------------------------------------------------------------

def float_bits(v: float) -> str:
    """Exact IEEE-754 double bits of a Python float, as 16 hex chars."""
    return struct.pack(">d", float(v)).hex()


def _ordinal(v: float) -> int:
    """Monotonic integer mapping of a double: adjacent floats map to
    adjacent integers, so |ordinal(a) - ordinal(b)| is the ulp distance."""
    (i,) = struct.unpack(">q", struct.pack(">d", float(v)))
    return i if i >= 0 else -(i & 0x7FFFFFFFFFFFFFFF)


def ulp_distance(a: float, b: float) -> int:
    """Units-in-the-last-place distance between two doubles (0 iff equal,
    +0.0 and -0.0 included; two NaNs are 0 apart, a NaN and a number the
    largest distance)."""
    fa, fb = float(a), float(b)
    if fa == fb:
        return 0
    if np.isnan(fa) and np.isnan(fb):
        return 0
    if np.isnan(fa) or np.isnan(fb):
        return int(2 ** 63 - 1)
    return abs(_ordinal(fa) - _ordinal(fb))


def ulp_distance_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise ulp distance between two float32 arrays."""
    ia = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia >= 0, ia, -(ia & 0x7FFFFFFF))
    ib = np.where(ib >= 0, ib, -(ib & 0x7FFFFFFF))
    d = np.abs(ia - ib)
    return np.where(np.asarray(a, np.float32) == np.asarray(b, np.float32),
                    0, d)


def _discordant_pairs(ranks: np.ndarray) -> int:
    """Strict inversions in a rank sequence via a binary indexed tree
    (O(n log n); ties are not inversions)."""
    m = int(ranks.max()) + 1
    tree = [0] * (m + 1)
    disc = 0
    for seen, r in enumerate(ranks):
        r = int(r)
        # earlier elements with rank strictly greater than r
        s, i = 0, r
        while i > 0:
            s += tree[i]
            i -= i & (-i)
        disc += seen - s
        i = r
        while i <= m:
            tree[i] += 1
            i += i & (-i)
    return disc


def kendall_tau_b(a, b) -> float | None:
    """Kendall tau-b over two paired value lists (tie-aware: two identical
    ledgers score exactly 1.0 even when values tie); None below two pairs
    or when either side is constant. Knight's O(n log n) formulation."""
    n = len(a)
    if n < 2:
        return None
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    order = np.lexsort((b, a))
    a_s, b_s = a[order], b[order]

    def ties(counts: np.ndarray) -> int:
        return int((counts * (counts - 1) // 2).sum())

    n0 = n * (n - 1) // 2
    n1 = ties(np.unique(a_s, return_counts=True)[1])
    n2 = ties(np.unique(b_s, return_counts=True)[1])
    n3 = ties(np.unique(np.stack([a_s, b_s], axis=1), axis=0,
                        return_counts=True)[1])
    # b ranks in a-major order: within equal-a runs lexsort sorted b
    # ascending, so a-tied pairs contribute no inversions
    ranks = np.unique(b_s, return_inverse=True)[1] + 1
    disc = _discordant_pairs(ranks)
    conc_minus_disc = n0 - n1 - n2 + n3 - 2 * disc
    denom = ((n0 - n1) * (n0 - n2)) ** 0.5
    return conc_minus_disc / denom if denom else None


def diff_values(a, b) -> dict:
    """Compare two runs' values of the same coalitions, paired by position.

    Returns {common, ulp: {max, p50, p99, nonzero}, histogram (log2-bucketed
    ulp counts), kendall_tau, drift}, with the JAX module's `diff_ledgers`
    definitions: `drift` is True when any pair's bits differ."""
    if len(a) != len(b):
        raise ValueError(f"{len(a)} values against {len(b)}")
    va, vb = [float(x) for x in a], [float(y) for y in b]
    dists = [ulp_distance(x, y) for x, y in zip(va, vb)]
    hist: dict[str, int] = {}
    for d in dists:
        bucket = "0" if d == 0 else f"2^{max(int(d).bit_length() - 1, 0)}"
        hist[bucket] = hist.get(bucket, 0) + 1
    sd = sorted(dists)

    def pct(q):
        if not sd:
            return None
        return sd[min(max(int(q * len(sd)), 1), len(sd)) - 1]

    return {
        "common": len(dists),
        "ulp": {
            "max": max(dists) if dists else None,
            "p50": pct(0.50),
            "p99": pct(0.99),
            "nonzero": sum(1 for d in dists if d),
        },
        "histogram": hist,
        "kendall_tau": kendall_tau_b(va, vb),
        "drift": any(dists),
    }
