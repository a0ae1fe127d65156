"""Deterministic fault injection and the error classifier (a copy of
`mplc_tpu/faults.py`'s batch-fault, partner-fault, service-fault and
router-fault parts, on torch's errors).

The batch-fault plan (`MPLC_TORCH_FAULT_PLAN`) turns the three families of
failure a long sweep dies to into injectable, deterministic events, so
every recovery path of the engine's fault ladder (contrib/engine.py:
retry with backoff, OOM cap halving, the ladder's end (a CUDA engine's
`LadderExhaustedError`, a CPU engine's CPU rung), resume from the
autosave) runs on the CPU in the tests. Comma-separated entries

    <kind>@<site><ordinal>

      kind  ::= transient | oom | crash
      site  ::= batch   (the dispatch boundary of the Nth batch)
              | harvest (the result-fetch boundary of the Nth batch)

    e.g.  MPLC_TORCH_FAULT_PLAN=transient@batch3,oom@batch5,crash@batch7

Batches are numbered from 1 in the engine's dispatch order, the
reconstruction evaluator's batches and the recording included. A retry of
batch N keeps ordinal N, so `transient@batch3` fails batch 3's first
attempt and lets the retry through. A repeated entry queues faults at one
boundary (`transient@batch1,transient@batch1` fails the first attempt and
the first retry). Each entry fires once. A malformed entry warns and is
skipped: a typo in a plan must never crash a run.

The injected classes are those of the real failures, so the classifier's
code paths are the ones the tests run:

  - `InjectedTransient` is a RuntimeError whose message leads with the
    `UNAVAILABLE` status, which `is_transient` retries;
  - `InjectedOom` subclasses `torch.cuda.OutOfMemoryError`, the class the
    CUDA caching allocator raises: it drives the cap-halving ladder;
  - `InjectedCrash` subclasses `BaseException`, so no recovery path that
    catches `Exception` can swallow it: it stands for a kill, and a run
    resumes from the autosave in a new engine.

The classifier (`is_oom`, `is_transient`) keeps the JAX package's table:
  - OOM: `torch.cuda.OutOfMemoryError`, and any exception whose message
    holds "out of memory", `CUBLAS_STATUS_ALLOC_FAILED`,
    `CUDNN_STATUS_ALLOC_FAILED` or one of the JAX package's markers
    (`RESOURCE_EXHAUSTED`, "Out of memory", "OOM when allocating");
  - transient: the injected class, and any exception whose message leads
    with a `DEADLINE_EXCEEDED` or `UNAVAILABLE` status token. torch has no
    class of retryable runtime errors (the JAX package's XlaRuntimeError
    with a non-permanent status), so nothing else is transient;
  - permanent, never transient nor OOM: the sticky CUDA errors ("illegal
    memory access", "device-side assert", "unspecified launch failure",
    "misaligned address", "illegal instruction"), after which every call
    in the process fails again; a kernel's own launch failure
    (ops/recon_kernel.py, "launch failed: cudaError N") and a failed
    kernel build (ops/cuda_build.py): a kernel that does not build or
    launch raises, and never rides the ladder; and `LadderExhaustedError`.

The partner fault plan (`MPLC_TORCH_PARTNER_FAULT_PLAN`). Where the batch
plan changes the schedule, a partner fault changes the GAME: v(S) itself.
Comma-separated entries

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
      glabel@p3:frac0.5     half of partner 3's labels flipped to one
                            seeded target class, applied likewise.

dropout and straggler are the trainer's (`TrainConfig.partner_drop_epochs`,
`partner_straggler_delays`, fedavg and the single trainer only); noisy and
glabel the data's, through the partner's seeded generator. Malformed
entries warn and are skipped; a repeated (kind, partner) pair warns and
keeps the first entry; entries for partner ids outside the scenario warn
and are dropped (`clip_partner_plan`).

The service fault plan (`MPLC_TORCH_SERVICE_FAULT_PLAN`) addresses the
sweep service's jobs by submission ordinal, and the router's
(`MPLC_TORCH_ROUTER_FAULT_PLAN`, `shardkill@shard1:sec5`) kills a fleet
router's shards (service/router.py); grammars below. Over several ranks
(parallel/mesh.py) each rank reads its own batch plan (MPLC_TORCH_FAULT_RANK
arms it on one rank alone), and the engine
agrees every batch's failure across the ranks, so a fault injected on
one rank takes every rank down the same rung, as a real OOM inside a
partner-sharded training does (at its mesh row's next agreement point).
"""

from __future__ import annotations

import os
import re
import warnings

import torch

from .constants import (FAULT_PLAN_ENV, FAULT_RANK_ENV, PARTNER_FAULT_PLAN_ENV,
                        ROUTER_FAULT_PLAN_ENV, SERVICE_FAULT_PLAN_ENV)


class InjectedTransient(RuntimeError):
    """A retryable runtime failure: its message leads with `UNAVAILABLE`."""


class InjectedOom(torch.cuda.OutOfMemoryError):
    """An injected device OOM, of the class the CUDA caching allocator
    raises: it drives the cap-halving ladder."""


class InjectedCrash(BaseException):
    """A simulated kill. A BaseException, so that no recovery path catching
    `Exception` can swallow it."""


class LadderExhaustedError(RuntimeError):
    """The OOM ladder ran out of rungs with work still missing, where no
    CPU rung exists: on a CUDA engine (mode "1d"; the port never moves a
    card's work to the CPU) and in the JAX package's 2-D partner-sharded
    mode ("2d"). Permanent: a re-dispatch at the same exhausted cap would
    fail alike, so neither `is_transient` nor `is_oom` holds for it.
    `halvings` is the rung count, `mode` the mode that ran,
    `postmortem_path` the flight-recorder dump (obs/flight.py) written
    when the ladder died, or None."""

    def __init__(self, msg: str, *, halvings: int = 0, mode: str = "2d",
                 postmortem_path: "str | None" = None):
        super().__init__(msg)
        self.halvings = halvings
        self.mode = mode
        self.postmortem_path = postmortem_path


# Statuses that are transient whatever the exception's class (the JAX
# package's service-layer timeout family); the token must lead the message.
_TRANSIENT_STATUS = ("DEADLINE_EXCEEDED", "UNAVAILABLE")
_OOM_MARKERS = ("out of memory", "CUBLAS_STATUS_ALLOC_FAILED",
                "CUDNN_STATUS_ALLOC_FAILED",
                # the JAX package's, so its messages classify alike
                "RESOURCE_EXHAUSTED", "Out of memory", "OOM when allocating")
# A sticky CUDA error poisons the context: every later call fails again.
# A kernel that fails to build or launch is a fault of the program.
_PERMANENT_MARKERS = ("illegal memory access", "device-side assert",
                      "unspecified launch failure", "misaligned address",
                      "illegal instruction", "launch failed: cudaError",
                      "nvcc failed", "nvcc was not found")


def _permanent(err: BaseException) -> bool:
    if isinstance(err, LadderExhaustedError):
        return True
    msg = str(err)
    return any(m in msg for m in _PERMANENT_MARKERS)


def is_oom(err: BaseException) -> bool:
    """True for device or host memory exhaustion: the cap-halving family,
    never retried as it stands (the same batch would exhaust alike)."""
    if isinstance(err, InjectedOom):
        return True
    if not isinstance(err, Exception) or _permanent(err):
        return False
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    msg = str(err)
    return any(m in msg for m in _OOM_MARKERS)


def is_transient(err: BaseException) -> bool:
    """True for a failure worth retrying as it stands: the injected
    transient, and any exception whose message leads with a
    `DEADLINE_EXCEEDED` or `UNAVAILABLE` status token. OOM and the
    permanent errors are not; other exceptions (bugs) never are."""
    if isinstance(err, InjectedTransient):
        return True
    if not isinstance(err, Exception) or is_oom(err) or _permanent(err):
        return False
    msg = str(err).lstrip()

    def leads_with(code: str) -> bool:
        # a status token is followed by ':' or whitespace, or ends the
        # message: "UNAVAILABLE_RESOURCE: ..." is no status
        if not msg.startswith(code):
            return False
        rest = msg[len(code):]
        return not rest or not (rest[0].isalnum() or rest[0] == "_")

    return any(leads_with(code) for code in _TRANSIENT_STATUS)


_ENTRY_RE = re.compile(r"^(transient|oom|crash)@(batch|harvest)([0-9]+)$")


def parse_fault_plan(spec: str | None) -> dict:
    """`{(site, ordinal): [kind, ...]}` from the plan grammar, the batch
    site named "dispatch". Malformed entries warn and are dropped; an
    empty or unset spec is the empty plan."""
    plan: dict = {}
    if not spec:
        return plan
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        m = _ENTRY_RE.match(entry)
        if m is None or int(m.group(3)) < 1:
            warnings.warn(
                f"{FAULT_PLAN_ENV}: ignoring malformed entry {entry!r} "
                f"(expected <transient|oom|crash>@<batch|harvest><N>, N >= 1)",
                stacklevel=2)
            continue
        kind, site, ordinal = m.group(1), m.group(2), int(m.group(3))
        site = "dispatch" if site == "batch" else site
        plan.setdefault((site, ordinal), []).append(kind)
    return plan


class FaultInjector:
    """Consulted by the engine at every dispatch and harvest boundary.

    `check(site, ordinal)` raises the next planned fault of that boundary,
    each plan entry once; with an empty plan it returns at once. The engine
    numbers its batches and passes the ordinal in, so a retry re-checks
    the same ordinal and finds its entry consumed. Each fault counts
    `engine.faults_injected` and emits an `engine.fault` event."""

    __slots__ = ("plan", "injected")

    def __init__(self, plan: dict | None = None):
        self.plan = plan or {}
        self.injected = 0

    @classmethod
    def from_env(cls) -> "FaultInjector":
        """The plan of MPLC_TORCH_FAULT_PLAN; in a world of ranks, empty on
        every rank but MPLC_TORCH_FAULT_RANK's where that is set."""
        only = os.environ.get(FAULT_RANK_ENV, "").strip()
        if only:
            from .parallel import mesh
            if only != str(mesh.world_rank()):
                return cls()
        return cls(parse_fault_plan(os.environ.get(FAULT_PLAN_ENV)))

    @property
    def armed(self) -> bool:
        return bool(self.plan)

    def check(self, site: str, ordinal: int) -> None:
        if not self.plan:
            return
        kinds = self.plan.get((site, ordinal))
        if not kinds:
            return
        kind = kinds.pop(0)
        if not kinds:
            del self.plan[(site, ordinal)]
        self.injected += 1
        from .obs import metrics as obs_metrics
        from .obs import trace as obs_trace
        obs_metrics.counter("engine.faults_injected").inc()
        obs_trace.event("engine.fault", kind=kind, site=site, ordinal=ordinal)
        where = f"({site} boundary, batch {ordinal})"
        if kind == "transient":
            raise InjectedTransient(f"UNAVAILABLE: injected transient fault {where}")
        if kind == "oom":
            raise InjectedOom(f"CUDA out of memory: injected device OOM {where}")
        raise InjectedCrash(f"injected crash {where}")

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


# ---------------------------------------------------------------------------
# Service-level fault plan (MPLC_TORCH_SERVICE_FAULT_PLAN)
# ---------------------------------------------------------------------------
#
# Where MPLC_TORCH_FAULT_PLAN injects batch-boundary faults into ONE engine,
# this plan targets the multi-tenant sweep service (service/):
# entries address jobs by their 1-based SUBMISSION ordinal, so a two-tenant
# isolation test can fault exactly tenant A's job and assert tenant B's
# results bit-identical to a solo run. Comma-separated entries:
#
#   crash@job2:batch3      an InjectedCrash at the dispatch boundary of
#                          job 2's 3rd device batch (batch ordinals are
#                          per-JOB: each tenant engine counts its own)
#   oom@job2:batch3        ditto, InjectedOom (drives that job's private
#                          degrade ladder; other tenants' caps untouched)
#   transient@job2:batch3  ditto, InjectedTransient (rides the retry rung)
#   reject@job4            admission control refuses the 4th submission
#                          (clean ServiceRejected, counted as rejected)
#   stall@job1:sec2        the scheduler sleeps 2 s before job 1's next
#                          quantum (a simulated hang; consumed once, and
#                          the stall bills against THAT job's deadline)
#
# Batch-kind entries are installed into the target job's private engine
# injector at job start, so the firing semantics (once per entry, retries
# keep their ordinal) are exactly `FaultInjector`'s. Malformed entries
# warn and are skipped — same contract as the other plans.
#
# Chaos mode (the load harness's randomized-but-seeded extension):
#
#   chaos@rate0.05:seed7   every submitted job independently draws, with
#                          probability 0.05, ONE random fault — an
#                          injected crash, a transient, or a scheduler
#                          stall — from a generator seeded by
#                          (seed, job ordinal). The draw depends only on
#                          the ordinal, never on scheduling order or
#                          thread interleaving, so a chaos run is
#                          REPLAYABLE: same seed + same submission order
#                          = same faults, under any worker count.
#
# A chaos entry composes with explicit per-job entries (both apply); at
# most one chaos entry is honored per plan (a duplicate warns and is
# ignored). Chaos never injects `reject` or `oom`: admission decisions
# stay deterministic, and an OOM would re-shape the victim's batch caps
# rather than exercise the retry/stall recovery paths the harness is
# probing (it remains available as an explicit per-job entry).

_SERVICE_ENTRY_RE = re.compile(
    r"^(crash|oom|transient)@job([0-9]+):batch([0-9]+)$"
    r"|^(reject)@job([0-9]+)$"
    r"|^(stall)@job([0-9]+):sec([0-9]+(?:\.[0-9]+)?)$"
    r"|^(chaos)@rate([0-9]+(?:\.[0-9]+)?):seed([0-9]+)$")


def parse_service_fault_plan(spec: str | None) -> dict:
    """`{job_ordinal: {"batch": {(site, ordinal): [kind, ...]},
    "reject": bool, "stall_sec": float}}` from the service-plan grammar,
    plus — when the plan carries a chaos entry — a `"chaos"` key (a
    string, so it can never collide with the integer job ordinals)
    holding `{"rate": float, "seed": int}`. Job ordinals are 1-based
    submission order. Malformed entries warn and are dropped;
    empty/unset spec is the empty plan."""
    plan: dict = {}
    if not spec:
        return plan

    def slot(job: int) -> dict:
        return plan.setdefault(job, {"batch": {}, "reject": False,
                                     "stall_sec": 0.0})

    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        m = _SERVICE_ENTRY_RE.match(entry)
        if m is None:
            warnings.warn(
                f"{SERVICE_FAULT_PLAN_ENV}: ignoring malformed entry "
                f"{entry!r} (expected <crash|oom|transient>@job<J>:batch<B> "
                "| reject@job<J> | stall@job<J>:sec<F> | "
                "chaos@rate<F>:seed<N>)", stacklevel=2)
            continue
        if m.group(1):  # batch-boundary kind
            job, ordinal = int(m.group(2)), int(m.group(3))
            if job < 1 or ordinal < 1:
                warnings.warn(
                    f"{SERVICE_FAULT_PLAN_ENV}: ignoring entry {entry!r} "
                    "(job and batch ordinals are 1-based)", stacklevel=2)
                continue
            slot(job)["batch"].setdefault(
                ("dispatch", ordinal), []).append(m.group(1))
        elif m.group(4):  # reject
            job = int(m.group(5))
            if job < 1:
                warnings.warn(
                    f"{SERVICE_FAULT_PLAN_ENV}: ignoring entry {entry!r} "
                    "(job ordinals are 1-based)", stacklevel=2)
                continue
            slot(job)["reject"] = True
        elif m.group(6):  # stall
            job, sec = int(m.group(7)), float(m.group(8))
            if job < 1:
                warnings.warn(
                    f"{SERVICE_FAULT_PLAN_ENV}: ignoring entry {entry!r} "
                    "(job ordinals are 1-based)", stacklevel=2)
                continue
            slot(job)["stall_sec"] += sec
        else:  # chaos
            rate, seed = float(m.group(10)), int(m.group(11))
            if not 0.0 <= rate <= 1.0:
                warnings.warn(
                    f"{SERVICE_FAULT_PLAN_ENV}: ignoring entry {entry!r} "
                    "(chaos rate must be in [0, 1])", stacklevel=2)
                continue
            if "chaos" in plan:
                warnings.warn(
                    f"{SERVICE_FAULT_PLAN_ENV}: ignoring duplicate chaos "
                    f"entry {entry!r} (keeping the first)", stacklevel=2)
                continue
            plan["chaos"] = {"rate": rate, "seed": seed}
    return plan


# chaos stall draws are short: the point is scheduling jitter (a quantum
# that takes noticeably longer than its work), not wall-clock burn — a
# thousand-job harness run at rate 0.05 sleeps ~1-4 s total
_CHAOS_KINDS = ("crash", "transient", "stall")
_CHAOS_STALL_RANGE = (0.02, 0.2)
_CHAOS_MAX_BATCH = 3


def chaos_entry(chaos: "dict | None", ordinal: int) -> "dict | None":
    """The chaos plan's deterministic per-job draw: None (no fault for
    this submission) or a plan-slot-shaped entry — `{"batch": {...},
    "reject": False, "stall_sec": s}` — to merge with any explicit entry
    for the same ordinal. The generator is seeded by (seed, ordinal)
    alone, so the draw is identical under any worker count, submission
    interleaving or retry schedule; batch-kind faults target an early
    batch ordinal (1..3) so they reliably fire even on small games."""
    if not chaos:
        return None
    rate = float(chaos.get("rate", 0.0))
    if rate <= 0.0:
        return None
    import random
    rng = random.Random((int(chaos.get("seed", 0)) << 24) ^ int(ordinal))
    if rng.random() >= rate:
        return None
    kind = rng.choice(_CHAOS_KINDS)
    if kind == "stall":
        lo, hi = _CHAOS_STALL_RANGE
        return {"batch": {}, "reject": False,
                "stall_sec": round(rng.uniform(lo, hi), 3)}
    batch = rng.randint(1, _CHAOS_MAX_BATCH)
    return {"batch": {("dispatch", batch): [kind]}, "reject": False,
            "stall_sec": 0.0}


def merge_service_entries(*entries) -> "dict | None":
    """Combine explicit and chaos-drawn plan entries for one job into a
    fresh slot dict (batch fault lists concatenated per boundary, stall
    seconds summed, reject OR'd). Returns None when every input is None
    — the common no-fault case stays allocation-free."""
    live = [e for e in entries if e]
    if not live:
        return None
    out = {"batch": {}, "reject": False, "stall_sec": 0.0}
    for e in live:
        for key, kinds in (e.get("batch") or {}).items():
            out["batch"].setdefault(key, []).extend(kinds)
        out["reject"] = out["reject"] or bool(e.get("reject"))
        out["stall_sec"] += float(e.get("stall_sec") or 0.0)
    return out


def service_fault_plan_from_env() -> dict:
    return parse_service_fault_plan(os.environ.get(SERVICE_FAULT_PLAN_ENV))


# The router fault plan (`MPLC_TORCH_ROUTER_FAULT_PLAN`) injects into a
# fleet router's routing table, as the service plan injects into one
# scheduler:
#
#   shardkill@shard1:sec5   kill the named shard 5 seconds into the run
#                           (the router abandons the shard without a
#                           clean shutdown: its state file goes stale, its
#                           journal keeps the incomplete jobs, and failover
#                           must resubmit them elsewhere)
#
# The shard name matches a routing-table shard id exactly, or `shard<N>`
# addresses the N-th shard (0-based) of the router's table, so one plan
# works against generated `pid<...>` shard ids too. Times count from the
# FleetRouter's construction.

_ROUTER_ENTRY_RE = re.compile(
    r"^(shardkill)@([A-Za-z0-9_.-]+):sec([0-9]+(?:\.[0-9]+)?)$")


def parse_router_fault_plan(spec: str | None) -> list:
    """`[{"kind": "shardkill", "shard": str, "at_sec": float}, ...]`
    sorted by fire time, from the router-plan grammar above. A malformed
    entry warns and is dropped (a typo in a chaos plan must never crash a
    routed run); an empty or unset spec is the empty plan."""
    plan: list = []
    if not spec:
        return plan
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        m = _ROUTER_ENTRY_RE.match(entry)
        if m is None:
            warnings.warn(
                f"{ROUTER_FAULT_PLAN_ENV}: ignoring malformed entry "
                f"{entry!r} (expected shardkill@<shard>:sec<F>)",
                stacklevel=2)
            continue
        plan.append({"kind": m.group(1), "shard": m.group(2),
                     "at_sec": float(m.group(3))})
    plan.sort(key=lambda e: e["at_sec"])
    return plan


def router_fault_plan_from_env() -> list:
    return parse_router_fault_plan(os.environ.get(ROUTER_FAULT_PLAN_ENV))
