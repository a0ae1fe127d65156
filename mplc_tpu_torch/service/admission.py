"""SLO-driven admission control and priority scheduling for the sweep
service (port of `mplc_tpu/service/admission.py`, line for line: pure
Python, so the same sequences give the same picks, states and hints).

The bounded queue is a *capacity* control: past
`MPLC_TORCH_SERVICE_MAX_PENDING` pending jobs, `submit` raises
`ServiceOverloaded`. It says nothing about *latency*: a service can sit
well under its admission bound and still be drowning — every queued job
waiting minutes for its first quantum because the jobs ahead of it are
huge. This module closes that gap with two cooperating pieces, both
driven by the live queue-wait SLO signal the scheduler already measures:

  **`TierQueue`** — the scheduler's run queue, split into priority tiers
  (`submit(..., priority=)`, default `MPLC_TORCH_SERVICE_PRIORITY_DEFAULT`;
  higher integers are more important). Tiers are served by deterministic
  stride scheduling: tier `t` carries weight `t + 1`, so a tier-2 job
  receives three scheduling quanta for every tier-0 quantum while BOTH
  keep making progress — weighting, not starvation. Within a tier the
  order stays round-robin FIFO, so a single-tier service schedules as a
  plain round-robin deque.

  **`AdmissionController`** — a three-state overload governor:

      healthy ──p99 over threshold──▶ deferring ──still over──▶ shedding
         ▲                                                         │
         └───────────────p99 back under threshold──────────────────┘

  The signal is the queue-wait p99 over a sliding window of recent
  observed waits PLUS the live ages of everything still queued (so a
  wedged queue registers even when nothing is being scheduled and no new
  samples arrive). Past `MPLC_TORCH_SERVICE_SHED_P99_SEC` (0 / unset =
  governor off) the controller first *defers*: the scheduler skips the
  lowest priority tier while any higher tier has work (strict priority
  under pressure; a no-op when only one tier is queued — deferral must
  never deadlock a uniform-priority service). If the p99 is still over
  the threshold at the next evaluation, it escalates to *shedding*: the
  newest never-started jobs of the lowest queued tier are terminated
  with a classified `JobShed` (journaled, counted in
  `service.jobs_shed` — separate from rejected/cancelled/quarantined,
  and never silent) until the queue is back to half the admission bound.
  Shed errors and `ServiceOverloaded` both carry a `retry_after_sec`
  hint — the windowed queue-wait p50, floored at
  `MPLC_TORCH_SERVICE_RETRY_FLOOR_SEC` (default 0.05; without the floor a
  no-history hint of 0.0 tells a retrying client to hammer immediately)
  — so callers back off for roughly one queue's worth of time instead
  of hammering `submit` in a tight loop.

  The controller is deliberately *windowed*, not cumulative: the SLO
  histograms (obs/metrics.py) never forget, so a single overload spike
  would otherwise latch p99 above threshold forever and the service
  would shed until restart. The window is bounded BOTH by count (the
  most recent 256 waits) and by AGE (samples older than
  `max(10 x threshold, 30 s)` are pruned at evaluation time): a
  post-spike idle service stops shedding once the spike ages out, even
  if nothing new is ever scheduled to displace the stale samples. Two
  further anti-latch rules: escalation from deferring to shedding
  requires the p99 to still be over threshold after a DWELL of
  `0.1 x threshold` seconds (deferral gets wall-clock time to relieve
  the queue before jobs are destroyed, not just one scheduling
  decision), and the shed quota is zero whenever the queue is already
  at or below half the admission bound (a near-empty queue has nothing
  worth shedding — the next job runs, lands a fresh wait sample, and
  the window recovers). De-escalation back to `healthy` happens the
  moment the windowed p99 drops under the threshold.

All methods are caller-synchronized: the scheduler invokes them under
its own lock (one logical admission decision per scheduling quantum),
so neither class carries a lock of its own.
"""

from __future__ import annotations

import math
import time
from collections import deque

from .. import constants


def nearest_rank(samples, q: float) -> "float | None":
    """Exact nearest-rank quantile of a sample list (None when empty) —
    the same rule the report's slo row uses, so the controller and the
    offline quantiles can't disagree about what "p99" means."""
    if not samples:
        return None
    s = sorted(samples)
    return s[min(max(math.ceil(q * len(s)), 1), len(s)) - 1]


class TierQueue:
    """Priority-tiered run queue with stride scheduling across tiers.

    `push` files a job under its integer `priority` tier; `pop` serves
    tiers proportionally to weight `tier + 1` via stride scheduling
    (each tier holds a monotone "pass" value advanced by `1 / weight`
    per quantum served; the smallest pass runs next, ties to the higher
    tier) and round-robin FIFO within a tier. With `defer_lowest=True`
    the lowest nonempty tier is skipped — unless it is the ONLY
    nonempty tier, so deferral degrades to a no-op rather than a
    deadlock. `shed_candidates` returns the lowest tier's never-started
    jobs, newest first — the cheapest work to throw away."""

    def __init__(self):
        self._tiers: dict = {}   # tier -> deque of jobs
        self._pass: dict = {}    # tier -> stride pass value

    def __len__(self) -> int:
        return sum(len(d) for d in self._tiers.values())

    def jobs(self) -> list:
        """Every queued job (scheduling order not implied)."""
        return [j for d in self._tiers.values() for j in d]

    def tiers(self) -> list:
        """Sorted nonempty tier numbers."""
        return sorted(t for t, d in self._tiers.items() if d)

    def push(self, job) -> None:
        tier = int(getattr(job, "priority", 0))
        d = self._tiers.get(tier)
        if d is None:
            d = self._tiers[tier] = deque()
            # a tier joining mid-run starts at the current minimum pass:
            # it neither owes quanta for the time it was empty nor jumps
            # the tiers that were already waiting
            live = [self._pass[t] for t, q in self._tiers.items() if q]
            self._pass[tier] = min(live) if live else 0.0
        elif not d:
            live = [self._pass[t] for t, q in self._tiers.items()
                    if q and t != tier]
            if live:
                self._pass[tier] = max(self._pass[tier], min(live))
        d.append(job)

    def pop(self, defer_lowest: bool = False):
        """Next job to run, or None when empty (or everything eligible
        is deferred away — impossible by construction, see above)."""
        live = self.tiers()
        if not live:
            return None
        if defer_lowest and len(live) > 1:
            live = live[1:]
        tier = min(live, key=lambda t: (self._pass[t], -t))
        self._pass[tier] += 1.0 / (tier + 1)
        return self._tiers[tier].popleft()

    def shed_candidates(self, limit: int) -> list:
        """Up to `limit` never-started jobs from the lowest nonempty
        tier, NEWEST submission first (they have waited least — shedding
        them throws away the least invested patience), removed from the
        queue. Jobs that already ran a quantum are never shed: their
        harvested values represent paid-for device work."""
        victims = []
        live = self.tiers()
        if not live or limit <= 0:
            return victims
        d = self._tiers[live[0]]
        keep = deque()
        # walk from the newest end; keep relative order of survivors
        for job in reversed(d):
            if len(victims) < limit and job.first_quantum_at is None:
                victims.append(job)
            else:
                keep.appendleft(job)
        self._tiers[live[0]] = keep
        return victims


class AdmissionController:
    """The overload governor (module docstring). `shed_p99_sec <= 0`
    disables it: state stays `healthy` and nothing is ever deferred or
    shed; `retry_after_sec()` still serves the backoff hint."""

    HEALTHY = "healthy"
    DEFERRING = "deferring"
    SHEDDING = "shedding"

    # window samples older than max(_AGE_FACTOR x threshold, _AGE_MIN_SEC)
    # are pruned at read time: a post-spike idle service must recover
    # even when nothing new is scheduled to displace the stale waits
    _AGE_FACTOR = 10.0
    _AGE_MIN_SEC = 30.0

    def __init__(self, shed_p99_sec: float = 0.0, window: int = 256,
                 defer_dwell_sec: "float | None" = None):
        self.shed_p99_sec = float(shed_p99_sec)
        # escalation dwell: deferring must have been in force this long
        # (wall-clock, not decision count — under a worker pool two
        # scheduling decisions can be microseconds apart) before the
        # governor starts destroying jobs
        self.defer_dwell_sec = (float(defer_dwell_sec)
                                if defer_dwell_sec is not None
                                else 0.1 * self.shed_p99_sec)
        # floor under the retry hint: a fresh (or long-idle) service has
        # no queue-wait history, and a 0.0 hint is an instruction to
        # retry in a tight loop — resolved once at construction so a
        # governor's contract can't drift mid-run
        self.retry_floor_sec = constants._env_nonneg_float(
            constants.SERVICE_RETRY_FLOOR_ENV, 0.05)
        self._waits: deque = deque(maxlen=window)  # (monotonic ts, wait)
        self.state = self.HEALTHY
        self.shed_total = 0
        self.rejected_total = 0
        self._last_p99: "float | None" = None
        self._deferring_since: "float | None" = None

    @property
    def enabled(self) -> bool:
        return self.shed_p99_sec > 0.0

    # -- signal feeds ----------------------------------------------------

    def observe_queue_wait(self, sec: float) -> None:
        """One job's measured submit -> first-quantum wait."""
        self._waits.append((time.monotonic(), float(sec)))

    def note_reject(self) -> None:
        self.rejected_total += 1

    def note_shed(self, n: int = 1) -> None:
        self.shed_total += n

    # -- the decision ----------------------------------------------------

    def _recent_waits(self, now: "float | None" = None) -> list:
        now = time.monotonic() if now is None else now
        horizon = max(self._AGE_FACTOR * self.shed_p99_sec,
                      self._AGE_MIN_SEC)
        while self._waits and now - self._waits[0][0] > horizon:
            self._waits.popleft()
        return [w for _, w in self._waits]

    def _p99(self, queued_ages) -> "float | None":
        return nearest_rank(self._recent_waits() + list(queued_ages), 0.99)

    def evaluate(self, queued_ages) -> str:
        """Advance the governor one decision step and return the state.
        `queued_ages` are the current waiting times of still-queued jobs
        (their queue wait is AT LEAST that much), so a queue nothing is
        draining pushes p99 up without waiting for samples."""
        now = time.monotonic()
        p99 = self._last_p99 = self._p99(queued_ages)
        if (not self.enabled or p99 is None
                or p99 <= self.shed_p99_sec):
            self.state = self.HEALTHY
            self._deferring_since = None
        elif self.state == self.HEALTHY:
            self.state = self.DEFERRING
            self._deferring_since = now
        elif self.state == self.DEFERRING:
            # escalate only once deferral has had `defer_dwell_sec` of
            # wall-clock to relieve the p99 — never on the literal next
            # scheduling decision
            if now - (self._deferring_since or now) >= self.defer_dwell_sec:
                self.state = self.SHEDDING
        return self.state

    def shed_quota(self, queued: int, max_pending: int) -> int:
        """How many queued jobs to shed right now: enough to bring the
        queue back to half the admission bound. Zero when the queue is
        already at or below that target — shedding exists to cut a
        BACKLOG; a near-empty queue under a stale-window breach must
        run its jobs (and land fresh wait samples), not destroy them."""
        if self.state != self.SHEDDING:
            return 0
        return max(queued - max(max_pending // 2, 1), 0)

    def retry_after_sec(self) -> float:
        """The backoff hint carried by `ServiceOverloaded` and `JobShed`:
        the windowed queue-wait p50 — roughly one queue's worth of
        patience — floored at `retry_floor_sec` (a no-history hint of
        0.0 would tell a retrying client to hammer immediately)."""
        p50 = nearest_rank(self._recent_waits(), 0.50)
        return max(float(p50) if p50 is not None else 0.0,
                   self.retry_floor_sec)

    # -- observability ---------------------------------------------------

    def view(self, queued_ages=()) -> dict:
        """The /healthz `admission` block: current state, the live p99
        vs the threshold, and shed/reject accounting — overload made
        visible BEFORE it becomes a 503."""
        return {
            "state": self.state if self.enabled else self.HEALTHY,
            "enabled": self.enabled,
            "queue_wait_p99_sec": self._p99(queued_ages),
            "shed_threshold_sec": (self.shed_p99_sec
                                   if self.enabled else None),
            "shed_total": self.shed_total,
            "rejected_total": self.rejected_total,
            "retry_after_sec": self.retry_after_sec(),
            "window_samples": len(self._waits),
        }
