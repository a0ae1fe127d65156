"""The partner fault plan (a copy of the partner-plan half of
`mplc_tpu/faults.py`, pure Python).

Where an infrastructure fault changes the schedule, a partner fault changes
the GAME: v(S) itself. `MPLC_TORCH_PARTNER_FAULT_PLAN` holds comma-separated
entries

    <kind>@p<ID>:<param><value>

      dropout@p2:epoch3     partner 2 leaves at epoch 3 (1-based) and never
                            returns: exactly-zero gradients and zero FedAvg
                            weight from then on, the survivors
                            renormalized. `epoch1`: it never participates.
      straggler@p0:delay2   partner 0's local pass of every round starts
                            from the global params of 2 aggregation rounds
                            ago (delay k >= 1); its result still joins the
                            current round's aggregation.
      noisy@p1:sigma0.1     seeded Gaussian noise (sigma 0.1) on partner 1's
                            training features, applied by
                            `Scenario.data_corruption`.
      glabel@p3:frac0.5     half of partner 3's labels flipped to one seeded
                            target class, applied likewise.

dropout and straggler are the trainer's (`TrainConfig.partner_drop_epochs`,
`partner_straggler_delays`, fedavg and the single trainer only); noisy and
glabel the data's, through the partner's seeded generator. Malformed
entries warn and are skipped; a repeated (kind, partner) pair warns and
keeps the first entry; entries for partner ids outside the scenario warn
and are dropped (`clip_partner_plan`).

The JAX module's batch-fault injector and error classifier wait for the
port's runtime plane, and its service and router plans for the service
(ROADMAP.md queue 1, items 8 and 10).
"""

from __future__ import annotations

import os
import re
import warnings

from .constants import PARTNER_FAULT_PLAN_ENV

# kind -> (expected param name, value parser, validator). dropout's epoch
# and straggler's delay are 1-based ordinals; noisy's sigma is a noise
# stddev; glabel's frac is a corrupted-label fraction.
_PARTNER_KINDS = {
    "dropout": ("epoch", int, lambda v: v >= 1),
    "straggler": ("delay", int, lambda v: v >= 1),
    "noisy": ("sigma", float, lambda v: v >= 0.0),
    "glabel": ("frac", float, lambda v: 0.0 <= v <= 1.0),
}

_PARTNER_ENTRY_RE = re.compile(
    r"^(dropout|straggler|noisy|glabel)@p([0-9]+):"
    r"(epoch|delay|sigma|frac)([0-9]+(?:\.[0-9]+)?)$")


def parse_partner_fault_plan(spec: str | None) -> dict:
    """`{partner_id: {kind: value, ...}}` from the plan grammar. An empty
    or unset spec is the empty plan."""
    plan: dict = {}
    if not spec:
        return plan
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        m = _PARTNER_ENTRY_RE.match(entry)
        if m is not None:
            kind, pid, param, value = (m.group(1), int(m.group(2)),
                                       m.group(3), m.group(4))
            want_param, cast, ok = _PARTNER_KINDS[kind]
            if param == want_param:
                try:
                    v = cast(value)
                except ValueError:
                    v = None
                if v is not None and ok(v):
                    if kind in plan.get(pid, {}):
                        warnings.warn(
                            f"{PARTNER_FAULT_PLAN_ENV}: duplicate "
                            f"{kind}@p{pid} entry {entry!r} ignored "
                            "(keeping the first)", stacklevel=2)
                    else:
                        plan.setdefault(pid, {})[kind] = v
                    continue
        warnings.warn(
            f"{PARTNER_FAULT_PLAN_ENV}: ignoring malformed entry {entry!r} "
            "(expected dropout@p<I>:epoch<N> | straggler@p<I>:delay<K> | "
            "noisy@p<I>:sigma<F> | glabel@p<I>:frac<F>)", stacklevel=2)
    return plan


def partner_fault_plan_from_env() -> dict:
    return parse_partner_fault_plan(os.environ.get(PARTNER_FAULT_PLAN_ENV))


def clip_partner_plan(plan: dict, partners_count: int) -> dict:
    """The plan without (and warning of) entries for partner ids outside
    the scenario: a plan written for a bigger game degrades."""
    bad = sorted(p for p in plan if p >= partners_count)
    if bad:
        warnings.warn(
            f"{PARTNER_FAULT_PLAN_ENV}: ignoring entries for partner ids "
            f"{bad} (scenario has {partners_count} partners)", stacklevel=2)
    return {p: f for p, f in plan.items() if p < partners_count}


def trainer_fault_arrays(plan: dict, partners_count: int
                         ) -> tuple[tuple | None, tuple | None]:
    """The trainer's view: per-partner `(drop_epochs, straggler_delays)`
    tuples of length P (0 = no fault for that partner), or None where no
    partner carries that fault, which keeps the trainer fault-free."""
    drops = [0] * partners_count
    delays = [0] * partners_count
    for pid, entry in plan.items():
        drops[pid] = int(entry.get("dropout", 0))
        delays[pid] = int(entry.get("straggler", 0))
    return (tuple(drops) if any(drops) else None,
            tuple(delays) if any(delays) else None)


def data_fault_specs(plan: dict) -> dict:
    """The data's view: `{partner_id: [(kind, value), ...]}` of the noisy
    and glabel entries."""
    out: dict = {}
    for pid, entry in plan.items():
        specs = [(k, entry[k]) for k in ("noisy", "glabel") if k in entry]
        if specs:
            out[pid] = specs
    return out


def forever_dropped(plan: dict) -> frozenset:
    """Partner ids dropped from epoch 1. They never train, so the engine
    keys a coalition's random stream by its membership without them: a
    `dropout@pK:epoch1` coalition trains as the coalition without K."""
    return frozenset(p for p, entry in plan.items()
                     if entry.get("dropout") == 1)


def normalized_plan_repr(plan: dict) -> str:
    """The canonical (sorted) string of a parsed plan: the cache
    fingerprint's field, since two plans describe two games."""
    parts = []
    for pid in sorted(plan):
        for kind in sorted(plan[pid]):
            parts.append(f"{kind}@p{pid}:{plan[pid][kind]}")
    return ",".join(parts)
