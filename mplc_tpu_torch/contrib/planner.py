"""Query planner: route `compute_contributivity("auto")` and the live
tier's `LiveGame.query("auto")` to an estimator (port of
`mplc_tpu/contrib/planner.py`).

A `(game size, accuracy_target, deadline_sec)` triple resolves
deterministically, by written-down rules, to a concrete QueryPlan that the
caller keeps (`Contributivity.plan`, `LiveQueryResult.plan`), so running
the plan's method with its kwargs repeats the query without planning
again.

Cost model (`estimate_eval_seconds`), best first: "meter", the engine's
measured host seconds a reconstructed coalition (obs/devcost.py
`DeviceMeter`, once it has seen at least 8); else "bank_cost_model", the
median FLOPs of the programs in the program bank's manifest
(contrib/bank.py, MPLC_TORCH_COMPILE_CACHE_DIR) over the H100's fp32 peak
(obs/devcost.py) at the JAX package's assumed 10% utilization (a
program's FLOPs cover a whole batch, so this over-estimates a coalition:
the deadline-safe side); else "default", a fixed per-coalition constant
(`DEFAULT_EVAL_SEC`).

Accuracy contract: `accuracy_target` is the trust-row CI half-width on
normalized scores the caller asks for (MPLC_TORCH_PLANNER_ACCURACY, default
0.02). GTG-Shapley receives it as its stopping threshold (`sv_accuracy`);
exact queries meet any target by construction (CI width 0).

Routing table (deterministic given the inputs; every plan carries its
reason):

  1. exact        P <= MAX_EXACT_PARTNERS and the 2^P - 1 sweep fits the
                  deadline (no deadline: any exact-capable game routes
                  exact).
  2. hierarchical live games past the exact wall (P > 16) whose grouped
                  sweep (the 2^k cluster powerset and the exact intra
                  splits, live/hierarchy.py) fits the deadline; the
                  cluster count and tail tau are frozen into the plan's
                  method_kw, so the plan replays the same query.
  3. GTG-Shapley  the truncated-permutation budget (min_iter x P evals)
                  fits the deadline (or no deadline on a big game).
  4. SVARM        tighter deadlines: its sample budget is clamped to what
                  the deadline affords (anchors + stratum warm-up + at
                  least the 128-sample floor).
  5. below even that floor: live games run GTG-Shapley over the
                  DPVS-pruned game (tau MPLC_TORCH_LIVE_PRUNE_TAU, else
                  0.5); other queries best-effort SVARM at the floor
                  budget.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import constants

#: per-coalition eval seconds without a measurement
DEFAULT_EVAL_SEC = 0.05
#: assumed utilization when seconds are derived from counted FLOPs
_COST_MODEL_MFU = 0.10
#: the card whose fp32 peak (obs/devcost.py) prices the bank's FLOPs
_COST_MODEL_CARD = "H100 80GB HBM3"
#: DPVS tau of the pruned rung when MPLC_TORCH_LIVE_PRUNE_TAU is unset
_PRUNE_TAU_FALLBACK = 0.5
#: SVARM's minimum useful sampled budget (mirrors its 128-sample floor)
_SVARM_FLOOR = 128
#: GTG's default permutation budget per partner (min_iter default)
_GTG_MIN_ITER = 100

MAX_EXACT_PARTNERS = 16


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One resolved plan: everything a repeat needs to run the same
    concrete query, plus the cost and accuracy evidence behind the choice."""
    method: str                    # "exact"/"hierarchical"/"GTG-Shapley"/"SVARM"
    partners: int
    accuracy_target: float         # contracted trust-row CI half-width
    deadline_sec: "float | None"   # None = loose
    est_evals: int                 # estimated coalition evaluations
    est_eval_sec: float            # per-coalition eval-seconds estimate
    est_cost_sec: float            # est_evals * est_eval_sec
    cost_basis: str                # "meter" | "bank_cost_model" | "default"
    prune_tau: float               # 0 = unpruned
    reason: str
    method_kw: dict = dataclasses.field(default_factory=dict)

    def describe(self) -> dict:
        d = dataclasses.asdict(self)
        d["method_kw"] = dict(self.method_kw)
        return d


def plan_from_dict(doc: dict) -> QueryPlan:
    """Rebuild a plan from its `describe()` dict."""
    fields = {f.name for f in dataclasses.fields(QueryPlan)}
    return QueryPlan(**{k: v for k, v in doc.items() if k in fields})


def estimate_eval_seconds(engine=None) -> tuple:
    """(seconds per coalition evaluation, basis): the engine's metered
    eval-only seconds a coalition once it has reconstructed 8 or more
    ("meter"), else the bank manifest's median FLOPs priced at the H100's
    fp32 peak ("bank_cost_model"), else the default constant."""
    meter = getattr(engine, "device_meter", None) if engine else None
    if meter is not None:
        snap = meter.snapshot()
        if snap.get("eval_coalitions", 0) >= 8 and snap.get("eval_span_sec", 0.0) > 0.0:
            return (snap["eval_span_sec"] / snap["eval_coalitions"], "meter")
    bank = getattr(engine, "program_bank", None) if engine else None
    if bank is not None:
        from ..obs.devcost import peak_flops_per_chip
        peak = peak_flops_per_chip(_COST_MODEL_CARD, "fp32")
        costs = [c["flops"] for c in bank.persistent_costs().values() if c.get("flops")]
        if peak and costs:
            return (float(np.median(costs)) / (peak * _COST_MODEL_MFU), "bank_cost_model")
    return (DEFAULT_EVAL_SEC, "default")


def _estimated_evals(partners: int) -> dict:
    """Estimated coalition-evaluation budgets per estimator family."""
    n = int(partners)
    warmup = max(n * n - 2 * n, 0)  # SVARM per-(partner, size) strata
    return {
        "exact": (1 << n) - 1,
        "GTG-Shapley": _GTG_MIN_ITER * n,
        # anchors (2n) + stratum warm-up + the sampled floor
        "SVARM_floor": 2 * n + warmup + _SVARM_FLOOR,
        "SVARM_auto": 2 * n + warmup + max(4 * n * n, _SVARM_FLOOR),
    }


def default_accuracy_target() -> float:
    t = constants._env_nonneg_float(constants.PLANNER_ACCURACY_ENV, 0.0)
    return t if t > 0 else 0.02


def default_deadline_sec() -> "float | None":
    d = constants._env_nonneg_float(constants.PLANNER_DEADLINE_ENV, 0.0)
    return d if d > 0 else None


def plan_query(partners_count: int,
               accuracy_target: "float | None" = None,
               deadline_sec: "float | None" = None, *,
               eval_sec: "float | None" = None,
               cost_basis: str = "default",
               live: bool = False) -> QueryPlan:
    """Resolve `method="auto"` to a concrete QueryPlan (routing table in
    the module docstring). Pure given its inputs."""
    n = int(partners_count)
    if n < 1:
        raise ValueError(f"partners_count must be >= 1, got {n}")
    if accuracy_target is None:
        accuracy_target = default_accuracy_target()
    if deadline_sec is None:
        deadline_sec = default_deadline_sec()
    if eval_sec is None:
        eval_sec, cost_basis = DEFAULT_EVAL_SEC, "default"
    evals = _estimated_evals(n)

    def _plan(method, est_evals, reason, prune_tau=0.0, **method_kw):
        return QueryPlan(
            method=method, partners=n,
            accuracy_target=float(accuracy_target),
            deadline_sec=None if deadline_sec is None else float(deadline_sec),
            est_evals=int(est_evals), est_eval_sec=float(eval_sec),
            est_cost_sec=float(est_evals) * float(eval_sec),
            cost_basis=cost_basis, prune_tau=float(prune_tau),
            reason=reason, method_kw=method_kw)

    def _fits(est_evals):
        return deadline_sec is None or est_evals * eval_sec <= deadline_sec

    # 1. exact: zero sampling error, so it satisfies any accuracy target
    if n <= MAX_EXACT_PARTNERS and _fits(evals["exact"]):
        return _plan(
            "exact", evals["exact"],
            f"2^{n}-1 exact sweep fits "
            + ("a loose deadline" if deadline_sec is None
               else f"the {deadline_sec:g}s deadline")
            + "; exact Shapley meets any accuracy target (CI width 0)")
    # 2. hierarchical (live only): past the exact wall, exact Shapley over
    # <= 16 DPVS-score clusters and exact intra splits; the knobs are
    # resolved here and frozen into method_kw
    if live and n > MAX_EXACT_PARTNERS:
        from ..live import hierarchy
        k = hierarchy.resolve_clusters(n)
        ctau = hierarchy.resolve_cluster_tau()
        hier_evals = hierarchy.estimate_evaluations(n, k)
        if _fits(hier_evals):
            return _plan(
                "hierarchical", hier_evals,
                f"game too large for the exact table (P={n} > "
                f"{MAX_EXACT_PARTNERS}) but the grouped sweep over {k} "
                "clusters fits; exact macro Shapley + exact intra splits",
                clusters=int(k), cluster_tau=float(ctau))
    # 3. GTG-Shapley: permutation sampling to the accuracy target
    if _fits(evals["GTG-Shapley"]):
        reason = (f"game too large for the exact table (P={n} > "
                  f"{MAX_EXACT_PARTNERS})" if n > MAX_EXACT_PARTNERS
                  else "exact sweep would blow the deadline")
        return _plan(
            "GTG-Shapley", evals["GTG-Shapley"],
            reason + "; truncated-permutation budget fits",
            sv_accuracy=float(accuracy_target))
    # 4. SVARM: explicit budget clamped to the deadline
    if _fits(evals["SVARM_floor"]):
        affordable = int(deadline_sec / eval_sec) if deadline_sec else 0
        overhead = evals["SVARM_floor"] - _SVARM_FLOOR
        budget = min(max(affordable - overhead, _SVARM_FLOOR),
                     max(4 * n * n, _SVARM_FLOOR))
        return _plan(
            "SVARM", overhead + budget,
            "deadline below the GTG permutation budget; SVARM's sample "
            f"budget clamps to {budget} coalitions",
            budget=int(budget))
    # 5. pruned GTG (live) or floor-budget SVARM (best effort)
    if live:
        tau = constants._env_nonneg_float(
            constants.LIVE_PRUNE_TAU_ENV, 0.0) or _PRUNE_TAU_FALLBACK
        tau = min(tau, 1.0)
        return _plan(
            "GTG-Shapley", evals["GTG-Shapley"] // 2,
            "deadline below every unpruned estimator's floor; DPVS "
            f"pruning at tau={tau:g} collapses low-information partners",
            prune_tau=tau, sv_accuracy=float(accuracy_target))
    return _plan(
        "SVARM", evals["SVARM_floor"],
        "deadline below every estimator's floor — best-effort SVARM at "
        "the minimum sample budget (expect the deadline to be missed)",
        budget=_SVARM_FLOOR)
