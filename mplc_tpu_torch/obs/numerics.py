"""The numerics plane: the value ledger, drift diffing and the reduction
audit (port of `mplc_tpu/obs/numerics.py`).

1. **The value ledger** (`ValueLedger`, `MPLC_TORCH_NUMERICS_LEDGER`): every
   harvested v(S), of the retraining sweep ("exact") and of the
   retrain-free path ("reconstruction"), with its exact float bits, a
   content hash and its float path (device count, reduction mode, slot
   width, cap halvings, CPU rung), keyed by (subset bitmask, engine
   fingerprint), saved as JSON in the JAX package's schema: the JAX
   `ValueLedger.load` and `diff_ledgers` read a port ledger unchanged.
   Two ledgers diff into per-subset ulp distances, a log2 histogram and the
   Kendall tau-b of the induced ranking (`diff_ledgers`); two runs' values
   paired by position diff the same way (`diff_values`).

2. **The reduction audit** (`audit_coalition`, `MPLC_TORCH_NUMERICS_AUDIT=1`):
   at fenced batches the engine captures one coalition's per-round,
   per-partner aggregation terms through a separate recording trainer (the
   engine's own batches are never touched, so v(S) is bit-equal with the
   audit on or off), then replays the partner reduction: the left-to-right
   fold on the host (`_linear_fold`, the reference order) against the order
   the engine executes on its device, `torch.sum` over the partner axis
   under the default reduce or `ordered_fold` under
   `MPLC_TORCH_DETERMINISTIC_REDUCE`, run at the audited batch's shape (its
   width of runs, by P masked partners or its K slots, the coalition's
   terms where its trainer puts them). The terms are the recorded deltas
   times the weights, as in the JAX audit (the engine folds the weighted
   partner params themselves). The first (round, leaf) where they
   part, with its ulp distance, is a `numerics.drift` event and a flight
   dump. The JAX audit's grouped folds (`_grouped_fold`: the order a psum
   over `s` partner shards induces) are replayed for every divisor of P as
   evidence of what sharding would do (`ulp_by_shards`); the port runs on
   one device, so no grouping is executed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import struct
import time

import numpy as np

from .. import constants
from . import metrics as obs_metrics
from . import trace as obs_trace

logger = logging.getLogger("mplc_tpu_torch")

LEDGER_SCHEMA = 1


def audit_enabled() -> bool:
    """MPLC_TORCH_NUMERICS_AUDIT=1 (default off)."""
    return os.environ.get(constants.NUMERICS_AUDIT_ENV, "") == "1"


def ledger_path_from_env() -> "str | None":
    return os.environ.get(constants.NUMERICS_LEDGER_ENV) or None



# ---------------------------------------------------------------------------
# float forensics
# ---------------------------------------------------------------------------

def float_bits(v: float) -> str:
    """Exact IEEE-754 double bits of a Python float, as 16 hex chars."""
    return struct.pack(">d", float(v)).hex()


def bits_to_float(bits: str) -> float:
    return struct.unpack(">d", bytes.fromhex(bits))[0]


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


# ---------------------------------------------------------------------------
# the value ledger
# ---------------------------------------------------------------------------

class ValueLedger:
    """An engine's harvested v(S) bits and float paths, keyed by (subset
    bitmask, engine fingerprint), in the JAX package's JSON schema."""

    def __init__(self, engine_fingerprint: str, meta: dict | None = None,
                 path: "str | None" = None):
        self.engine_fingerprint = engine_fingerprint
        self.meta = dict(meta or {})
        self.path = path
        self.entries: dict[str, dict] = {}

    @staticmethod
    def subset_key(subset) -> str:
        """The membership bitmask as hex."""
        bits = 0
        for i in subset:
            bits |= 1 << int(i)
        return hex(bits)

    def record(self, subset, value: float, *, source: str = "exact",
               slot_width: "int | None" = None,
               cap_halvings: int = 0, degraded: bool = False) -> None:
        key = self.subset_key(subset)
        entry = {
            "mask": key,
            "value": float(value),
            "value_bits": float_bits(value),
            "source": source,
            "slot_width": slot_width,
            "cap_halvings": int(cap_halvings),
            "degraded": bool(degraded),
        }
        body = json.dumps({**entry, "fingerprint": self.engine_fingerprint,
                           **{k: self.meta.get(k) for k in
                              ("topology", "part_shards", "n_devices",
                               "reduction_mode")}},
                          sort_keys=True)
        entry["content_hash"] = hashlib.sha256(body.encode()).hexdigest()[:16]
        self.entries[key] = entry
        obs_metrics.counter("numerics.ledger_records").inc()

    def to_doc(self) -> dict:
        return {
            "schema": LEDGER_SCHEMA,
            "engine_fingerprint": self.engine_fingerprint,
            "meta": self.meta,
            "entries": self.entries,
        }

    def save(self, path: "str | None" = None) -> "str | None":
        """Write the ledger atomically (a temporary file, then
        `os.replace`); returns the path, or None without one. An OSError
        (a full disk) is logged and gives None: a ledger never stops a
        sweep."""
        path = path or self.path
        if not path:
            return None
        try:
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(self.to_doc(), f)
            os.replace(tmp, path)
        except OSError as e:
            logger.error("numerics ledger save to %r failed: %s", path, e)
            return None
        obs_trace.event("numerics.ledger", path=str(path),
                        entries=len(self.entries),
                        reduction_mode=self.meta.get("reduction_mode"))
        return path

    @classmethod
    def load(cls, path: str) -> "ValueLedger":
        with open(path) as f:
            doc = json.load(f)
        led = cls(doc.get("engine_fingerprint", "?"), doc.get("meta"), path=path)
        led.entries = dict(doc.get("entries", {}))
        return led


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


def _ulp_summary(dists: list) -> tuple[dict, dict]:
    """({max, p50, p99, nonzero}, log2-bucketed histogram) of ulp
    distances."""
    hist: dict[str, int] = {}
    for d in dists:
        bucket = "0" if d == 0 else f"2^{max(int(d).bit_length() - 1, 0)}"
        hist[bucket] = hist.get(bucket, 0) + 1
    sd = sorted(dists)

    def pct(q):
        if not sd:
            return None
        return sd[min(max(int(q * len(sd)), 1), len(sd)) - 1]

    return ({"max": max(dists) if dists else None, "p50": pct(0.50),
             "p99": pct(0.99), "nonzero": sum(1 for d in dists if d)}, hist)


def diff_ledgers(a, b) -> dict:
    """Compare two ledgers (`ValueLedger`s or their `to_doc()` dicts) on
    their common subsets: {comparable, same_fingerprint, common, only_a,
    only_b, ulp: {max, p50, p99, nonzero}, histogram, per_subset,
    kendall_tau, drift, meta_a, meta_b}, the JAX module's keys and
    definitions. `drift` is True when any common subset's bits differ;
    ledgers of other fingerprints describe other games, so their deltas
    are reported but not comparable."""
    da = a.to_doc() if isinstance(a, ValueLedger) else a
    db = b.to_doc() if isinstance(b, ValueLedger) else b
    ea, eb = da.get("entries", {}), db.get("entries", {})
    common = sorted(set(ea) & set(eb))
    same_fp = da.get("engine_fingerprint") == db.get("engine_fingerprint")
    dists, va, vb, per_subset = [], [], [], {}
    for k in common:
        x = bits_to_float(ea[k]["value_bits"])
        y = bits_to_float(eb[k]["value_bits"])
        d = ulp_distance(x, y)
        dists.append(d)
        per_subset[k] = d
        va.append(x)
        vb.append(y)
    ulp, hist = _ulp_summary(dists)
    return {
        "comparable": same_fp and bool(common),
        "same_fingerprint": same_fp,
        "common": len(common),
        "only_a": len(set(ea) - set(eb)),
        "only_b": len(set(eb) - set(ea)),
        "ulp": ulp,
        "histogram": hist,
        "per_subset": per_subset,
        "kendall_tau": kendall_tau_b(va, vb),
        "drift": any(dists),
        "meta_a": da.get("meta", {}),
        "meta_b": db.get("meta", {}),
    }


def diff_values(a, b) -> dict:
    """Compare two runs' values of the same coalitions, paired by position.

    Returns {common, ulp: {max, p50, p99, nonzero}, histogram (log2-bucketed
    ulp counts), kendall_tau, drift}, with the JAX module's `diff_ledgers`
    definitions: `drift` is True when any pair's bits differ."""
    if len(a) != len(b):
        raise ValueError(f"{len(a)} values against {len(b)}")
    va, vb = [float(x) for x in a], [float(y) for y in b]
    dists = [ulp_distance(x, y) for x, y in zip(va, vb)]
    ulp, hist = _ulp_summary(dists)
    return {
        "common": len(dists),
        "ulp": ulp,
        "histogram": hist,
        "kendall_tau": kendall_tau_b(va, vb),
        "drift": any(dists),
    }


# ---------------------------------------------------------------------------
# the reduction audit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AuditResult:
    subset: tuple
    rounds: int
    partners: int
    # the grouped folds replayed as evidence: every divisor of P from 2
    shard_counts: tuple
    # the port runs on one device: no grouping is executed (the JAX
    # field's value for every 1-D engine)
    executed_shards: "int | None"
    # first (round, leaf path, executed reduction) where the engine's
    # executed reduction parts from the left-to-right fold; None when they
    # agree bit for bit
    first_divergence: "tuple | None"
    # max ulp of that divergence (0 when none) and the elements it touches
    max_ulp: int
    divergent_elements: int
    # {shard count: the max ulp its grouped fold would part by}
    ulp_by_shards: dict
    # the per-shard partial sums at the first divergence, P shards of one
    # partner each (the terms themselves), small leaves in full
    partials_at_divergence: "list | None"
    seconds: float
    # the reduction the engine executes: "torch.sum" or "ordered_fold"
    executed: str = "torch.sum"
    # the [runs, partners or slots] it was replayed at: the audited batch's
    executed_shape: tuple = ()


def _linear_fold(terms: np.ndarray) -> np.ndarray:
    """The strict left-to-right fold over axis 0 in float32, on the host
    (numpy float32 adds are IEEE single adds): the reference order, and
    what `ordered_fold` computes."""
    out = terms[0].astype(np.float32)
    for i in range(1, terms.shape[0]):
        out = out + terms[i].astype(np.float32)
    return out


def _grouped_fold(terms: np.ndarray, shards: int) -> np.ndarray:
    """Per-shard partial sums over contiguous partner blocks (linear
    within a block), then a linear combine across shards: the order a psum
    over `shards` partner shards induces on the same terms."""
    return _linear_fold(np.stack(_device_partials(terms, shards)))


def _device_partials(terms: np.ndarray, shards: int) -> list:
    P = terms.shape[0]
    block = P // shards
    return [_linear_fold(terms[d * block:(d + 1) * block])
            for d in range(shards)]


def _summary(p: np.ndarray):
    return p.tolist() if p.size <= 8 else {
        "shape": list(p.shape), "max": float(np.max(p)), "min": float(np.min(p))}


def audit_coalition(engine, subset, width: int = 1,
                    slot_count: int | None = None) -> "AuditResult | None":
    """Capture one coalition's per-round, per-partner aggregation terms
    (the recorded deltas times the applied weights) through a separate
    recording trainer (masked fedavg, from the coalition's own stream), and
    hold the reduction the engine executes on its device (`torch.sum` over
    the partner axis, or `ordered_fold` under the deterministic reduce) to
    the left-to-right fold replayed on the host, localizing the first
    divergent (round, leaf). The reduction runs at the shape of the batch
    that trained the coalition: `width` runs (the coalition's terms in
    each) of P masked partners, or of `slot_count` slots holding its
    members in order and zero terms after them, as the slot trainer lays
    them out.

    Touches nothing the engine serves: its own trainer and state, no memo,
    cache or ordinal, so v(S) is bit-equal with the audit on or off. None
    for the shapes the JAX audit skips (an approach other than fedavg,
    early stopping on, a seed ensemble, a coalition of fewer than two
    effective members); an error while auditing is logged and gives None
    (an audit never stops a sweep)."""
    t0 = time.perf_counter()
    try:
        import torch

        from ..mpl.engine import MplTrainer
        from ..ops import aggregation

        cfg = engine._multi_cfg
        if (cfg.approach != "fedavg" or cfg.is_early_stopping
                or getattr(engine, "seed_ensemble", 1) > 1):
            return None
        subset = tuple(sorted(int(i) for i in subset))
        eff = engine._effective_subset(subset)
        if len(eff) < 2:
            return None  # a single never aggregates
        trainer = MplTrainer(engine.model, dataclasses.replace(
            cfg, record_updates=True, slot_count=None))
        P = engine.partners_count
        gens = [engine.coalition_generator(eff)]
        mask = torch.from_numpy(engine._coalition_arrays([subset])).to(engine.device)
        state = trainer.init_state(gens, P, engine.device)
        trainer.epoch_chunk(state, engine.stacked, engine.val, mask, gens,
                            cfg.epoch_count)
        leaves = [(f"{g}/{k}", state.upd_h[g][k][0].cpu().numpy())
                  for g in sorted(state.upd_h) for k in sorted(state.upd_h[g])]
        w_h = state.w_h[0].cpu().numpy()                       # [R, P]
        R = w_h.shape[0]
        executed = "ordered_fold" if cfg.deterministic_reduce else "torch.sum"
        cands = sorted({s for s in range(2, P + 1) if P % s == 0})
        # slot -> partner (-1: an unused slot), or the P masked partners
        cols = (np.arange(P) if slot_count is None
                else engine._coalition_arrays([subset], slot_count)[0])
        used = cols >= 0
        shape = (int(width), len(cols))

        def run_executed(leaf: np.ndarray, w: np.ndarray) -> np.ndarray:
            # the engine's own aggregation (`ops/aggregation.aggregate`) at
            # the batch's [width, P or K] shape, on its device; row 0's sum
            t = np.where(used.reshape((-1,) + (1,) * (leaf.ndim - 1)),
                         leaf[np.maximum(cols, 0)], np.float32(0))
            wt = np.where(used, w[np.maximum(cols, 0)], np.float32(0))
            out = aggregation.aggregate(
                {"l": {"t": torch.from_numpy(np.ascontiguousarray(
                    np.broadcast_to(t, (width,) + t.shape))).to(engine.device)}},
                torch.from_numpy(np.ascontiguousarray(
                    np.broadcast_to(wt, (width,) + wt.shape))).to(engine.device),
                cfg.deterministic_reduce)
            return out["l"]["t"][0].cpu().numpy()

        first = partials = None
        max_ulp = diverged = 0
        by_shards = {s: 0 for s in cands}
        for r in range(R):
            w = w_h[r]
            if not np.any(w):
                continue  # a round never reached, or no survivor
            for path, leaf in leaves:
                terms = (leaf[r] * w.reshape((-1,) + (1,) * (leaf.ndim - 2))
                         ).astype(np.float32)
                ref = _linear_fold(terms)
                for s in cands:
                    d = ulp_distance_f32(ref, _grouped_fold(terms, s))
                    by_shards[s] = max(by_shards[s], int(d.max()) if d.size else 0)
                d = ulp_distance_f32(ref, run_executed(leaf[r], w))
                dmax = int(d.max()) if d.size else 0
                if dmax:
                    diverged += int((d > 0).sum())
                    max_ulp = max(max_ulp, dmax)
                    if first is None:
                        first = (r, path, executed)
                        partials = [_summary(p) for p in _device_partials(terms, P)]
        res = AuditResult(
            subset=subset, rounds=R, partners=P, shard_counts=tuple(cands),
            executed_shards=None, first_divergence=first, max_ulp=max_ulp,
            divergent_elements=diverged, ulp_by_shards=by_shards,
            partials_at_divergence=partials,
            seconds=time.perf_counter() - t0, executed=executed, executed_shape=shape)
    except Exception as e:  # noqa: BLE001 - an audit never stops a sweep
        logger.warning("numerics audit for %r failed: %s", subset, e)
        return None
    mode = "deterministic" if cfg.deterministic_reduce else "default"
    key = ValueLedger.subset_key(subset)
    obs_metrics.counter("numerics.audits").inc()
    obs_trace.event(
        "numerics.audit", dur=res.seconds, subset=key, rounds=R,
        shard_counts=list(cands), executed_shards=None, executed=executed,
        executed_shape=list(shape),
        max_ulp=max_ulp, hypothetical_max_ulp=max(by_shards.values(), default=0),
        divergent_elements=diverged,
        first_round=None if first is None else first[0],
        first_leaf=None if first is None else first[1], reduction_mode=mode)
    if first is not None:
        # under the default reduce, the order `torch.sum` takes on this
        # device made concrete; under the deterministic reduce it would
        # mean the pinned order does not hold
        obs_metrics.counter("numerics.drift_events").inc()
        obs_trace.event("numerics.drift", subset=key, round=first[0], leaf=first[1],
                        executed=executed, max_ulp=max_ulp, reduction_mode=mode)
        from . import flight as obs_flight
        obs_flight.dump("numerics_drift", extra={
            "subset": list(subset), "first_divergent_round": first[0],
            "divergent_leaf": first[1], "executed": executed, "max_ulp": max_ulp,
            "divergent_elements": diverged,
            "ulp_by_shards": {str(k): v for k, v in by_shards.items()},
            "per_partner_terms": partials})
    return res
