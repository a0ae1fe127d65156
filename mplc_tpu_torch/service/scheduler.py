"""Sweep-as-a-service: the multi-tenant scheduler (port of
`mplc_tpu/service/scheduler.py`; the fleet router in front of N of them
is service/router.py).

A `SweepService` is a long-lived process-level engine front end: tenants
submit `Scenario` + method jobs onto a bounded queue and get a `SweepJob`
handle that streams per-coalition values back incrementally and resolves
to the method's contributivity scores. A pool of
`MPLC_TORCH_SERVICE_WORKERS` worker threads (default 1) round-robins a
scheduling quantum ("slice") across active jobs — each worker pinned to
a device slot (`worker index % torch.cuda.device_count()`; its quanta run
under `torch.cuda.device(slot)` when the host has more than one card) and
beating its OWN heartbeat, so many concurrent
contributivity games share one process, one device pool and one program
bank without any tenant monopolizing the device, and one wedged worker
flips only its own liveness on /healthz.

The headline is the fault model, not the queue:

  **Per-tenant fault isolation.** Every job runs on its own private
  `CharacteristicEngine` — private memo, private retry/degrade ladder,
  private fault injector — so a transient error, OOM, fault-plan
  injection or outright crash attributable to tenant A re-buckets/retries
  only A's batches and can never numerically perturb tenant B: B's values
  are bit-identical to a solo-engine run of the same scenario
  (equality-tested in tests/test_torch_service.py). What tenants SHARE is
  the program bank, in its shape-scoped mode (`ProgramBank shared=True`):
  same `(slots, width)` bucket => same program key regardless of which
  game a subset came from, so a second tenant of the same shape records
  no new program (`service.cross_tenant_packed_batches` counts the
  batches that rode another tenant's programs). Tenants also share the
  card, its default stream and cuDNN's settings: the engine's
  deterministic mode and its gradient-call width rule keep a tenant's
  bits independent of what runs beside it. A job whose
  attempt dies with a retryable failure (transient, OOM that escaped the
  engine ladder, injected crash) is re-queued — its harvested values
  persist in the engine memo and the journal, so the continuation is
  bit-identical — and quarantined after `MPLC_TORCH_MAX_RETRIES` failed
  attempts instead of retrying forever. Permanent failures (a classified
  `LadderExhaustedError`, a genuine bug) quarantine immediately.

  **Admission control, priorities and deadlines.** The queue is bounded
  (`MPLC_TORCH_SERVICE_MAX_PENDING`): past the bound, `submit` raises
  `ServiceOverloaded` — a clean, synchronous backpressure signal
  carrying a `retry_after_sec` hint (the live queue-wait p50; 0.0 with
  no history), never a silent drop. Jobs carry an integer priority tier
  (`submit(..., priority=)`, default
  `MPLC_TORCH_SERVICE_PRIORITY_DEFAULT`; higher = more important): the run
  queue (service/admission.py `TierQueue`) weights scheduling quanta by
  `tier + 1` via stride scheduling, round-robin FIFO within a tier. On
  top sits the SLO-driven overload governor (`AdmissionController`):
  when the queue-wait p99 — over a sliding window of recent waits plus
  the live ages of everything still queued — crosses
  `MPLC_TORCH_SERVICE_SHED_P99_SEC` (0/unset = governor off), the
  scheduler first DEFERS the lowest queued tier, then SHEDS its newest
  never-started jobs with a classified, journaled `JobShed` (counted in
  `service.jobs_shed`, separate from rejected/cancelled/quarantined,
  and also carrying `retry_after_sec`). A per-job `deadline_sec` is
  enforced cooperatively at every batch boundary (the engine's progress
  hook) and every quantum boundary: an expired job raises `JobCancelled`
  between batches — no in-flight dispatch is abandoned mid-device — its
  engine is dropped (the only references to its device buffers), and the
  cancellation is journaled; a deadline that expires while the job is
  STILL QUEUED cancels before any work and records no queue-wait/ttfv
  SLO sample (an expired wait is not a latency datum). `shutdown(
  drain=True)` stops admissions and completes every queued job before
  returning.

  **Journaled crash recovery.** When constructed with a `journal_path`,
  every accepted submission and every harvested `(tenant, subset, value)`
  is appended to a checksummed, fsync'd write-ahead journal
  (service/journal.py) BEFORE the service acts on it. A killed process
  restarts by constructing a new service on the same path: the journal
  replays (quarantining a torn tail record), `recovered_jobs()` lists the
  interrupted submissions, and re-submitting a scenario under its old
  `job_id` seeds the fresh engine's memo with every journaled value — the
  sweep completes training only what was never harvested, bit-identically
  to an uninterrupted run (each coalition draws its own stream, and the
  gradient-call width rule makes a v(S) independent of the batch that
  trains it).

  **Device-seconds metering.** Every quantum bills its engine's
  device-meter delta (obs/devcost.py) to the owning tenant: fenced-
  sample-extrapolated measured seconds when a batch of the quantum was
  fenced (CUDA events, MPLC_TORCH_DEVICE_FENCE_RATE), the batches' host
  span otherwise (the port has no compiler cost model) — the basis rides the
  `service.slice` span and the terminal `service.job` event. The meter
  is exported per tenant (`service.device_seconds{tenant=...}` on
  /metrics, `tenant_device_seconds` on /varz), drives the report's
  `cost_share` (span-seconds kept as `host_share`), and is JOURNALED
  with every job terminal so a kill→restart never loses billing.
  `submit(..., profile=True)` additionally captures a `torch.profiler`
  device trace of exactly that job's quanta into
  `MPLC_TORCH_PROFILE_DIR/<job_id>` (best-effort; path on the terminal
  event).

  **The live contributivity tier.** `live_game(scenario, tenant=...)`
  registers a tenant's RESIDENT incremental game (live/:
  recorded rounds stay in-process, journaled, round-stamp invalidated),
  `append_round(tenant, deltas, weights)` feeds it, and
  `submit_live(tenant, method=..., prune=...)` runs "what is my Shapley
  value now" as a LOW-LATENCY job class on this same machinery —
  admission bound, tier-weighted quanta (default one tier above the
  batch default), overload shedding, deadlines
  (`MPLC_TORCH_LIVE_QUERY_DEADLINE_SEC` default), journaled terminals —
  answered from reconstruction against banked programs with zero
  training batches. The resident game's engine is shared across queries
  and never released at job completion; per-tenant games appear on
  /varz (`live_games`) and the `live.rounds_resident` gauge.

Live telemetry: when `MPLC_TORCH_METRICS_PORT` is set, constructing a
service starts the obs/export.py HTTP plane — /metrics (Prometheus,
incl. the per-tenant SLO histograms instrumented here: queue wait,
time-to-first-value, slice duration, deadline misses, retries),
/healthz (worker heartbeat age; 503 when a running job's quantum stalls
past STALL_HEALTHY_SEC) and /varz (the per-job state table via
`varz_view`). With it unset no thread or socket exists; `health_view()`
and `varz_view()` remain directly callable either way. Quarantines dump
the crash flight recorder (obs/flight.py) and reference the postmortem
file from the quarantine log line.

Deterministic testability: `MPLC_TORCH_SERVICE_FAULT_PLAN` (faults.py)
addresses jobs by submission ordinal — `crash@job2:batch3` installs an
injected crash into job 2's private engine injector, `reject@job4` makes
admission refuse the 4th submission, `stall@job1:sec2` sleeps the
scheduler before job 1's next quantum (billed against job 1's own
deadline; with a single shared device, a stalled tenant's compute slot is
indistinguishable from slow compute for whoever is behind it in line).
A `chaos@rate0.05:seed7` entry extends the plan with randomized-but-
replayable injection: every submission independently draws (seeded by
plan seed x job ordinal, so the draw survives any worker interleaving)
one crash/transient/stall fault with the given probability — how a
load harness proves the isolation and accounting machinery holds at
thousands of jobs.
"""

from __future__ import annotations

import contextlib
import hmac
import itertools
import logging
import os
import threading
import time
from collections import deque

import numpy as np

from .. import constants, faults
from ..obs import devcost
from ..obs import export as obs_export
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .admission import AdmissionController, TierQueue
from .journal import SweepJournal
from .packer import CrossTenantPacker

logger = logging.getLogger("mplc_tpu_torch")


def _live_residency_stats() -> dict:
    """The residency manager's /varz block (lazy import: the live tier
    is only loaded once a service actually touches it)."""
    from ..live import residency
    return residency.stats()


# /healthz stall rule: the service is unhealthy when a job is RUNNING and
# the worker heartbeat (beaten at every quantum start and every batch
# boundary) is older than this — a single device batch legitimately
# longer than the bound would false-flag, so it is generous. Idle
# services (no running job) are healthy at any heartbeat age.
STALL_HEALTHY_SEC = 30.0

_SERVICE_IDS = itertools.count(1)


class ServiceError(RuntimeError):
    """Base class for service-level failures."""


class ServiceClosed(ServiceError):
    """submit() after shutdown started."""


class ServiceOverloaded(ServiceError):
    """Backpressure: the bounded submission queue is full. Resubmit after
    draining — nothing about the request itself is wrong.

    `retry_after_sec` is the live backoff hint: the service's windowed
    queue-wait p50 (roughly one queue's worth of patience), or 0.0 when
    no job has ever been scheduled. Callers should sleep about that long
    before resubmitting instead of hammering `submit` in a tight loop.

    `cluster` (sharded fleet deployments, MPLC_TORCH_FLEET_STATE_DIR) is
    the cross-shard queue view at rejection time — its `least_loaded`
    shard is the redirect hint; None outside a fleet."""

    cluster: "dict | None" = None

    def __init__(self, msg: str, retry_after_sec: float = 0.0):
        super().__init__(msg)
        self.retry_after_sec = float(retry_after_sec)


class ServiceRejected(ServiceError):
    """Admission control refused the job (fault-plan injected reject)."""


class ServiceAuthError(ServiceError):
    """The submit-path credential check failed: `MPLC_TORCH_METRICS_TOKEN`
    is set (the service authenticates tenants) and the presented
    credential is neither the master/operator token nor the tenant's own
    HMAC credential (`obs.export.tenant_token(master, tenant)`). A
    SYNCHRONOUS submission error — nothing was accepted, journaled or
    quarantined; the caller's identity claim was simply wrong."""


class JobShed(ServiceError):
    """The overload governor terminated this still-queued job to protect
    the queue-wait SLO of higher-priority work (service/admission.py).
    A classified, journaled outcome — never a silent drop: the job's
    status is `"shed"`, it is counted in `service.jobs_shed` (separate
    from rejected/cancelled/quarantined), and `retry_after_sec` carries
    the same live backoff hint as `ServiceOverloaded`. Nothing about the
    request itself is wrong; resubmit later (or at a higher priority)."""

    def __init__(self, msg: str, retry_after_sec: float = 0.0):
        super().__init__(msg)
        self.retry_after_sec = float(retry_after_sec)


class JobQuarantined(ServiceError):
    """The job exhausted its retry budget (or failed permanently) and was
    quarantined; `__cause__` carries the terminal error."""


class JobCancelled(Exception):
    """Raised cooperatively at a batch/quantum boundary when a job's
    deadline expired. Plain Exception (not ServiceError): it unwinds
    through the engine's recovery ladder untouched (`is_transient` /
    `is_oom` are both False for it)."""


class SweepJob:
    """Handle for one submitted job. Thread-safe consumer surface:
    `stream()` yields `(subset, value)` incrementally as batches harvest,
    `result()` blocks for the final contributivity scores."""

    def __init__(self, service, job_id, tenant, scenario, method,
                 deadline_sec, ordinal, priority=0, profile=False):
        self.service = service
        self.job_id = job_id
        self.tenant = tenant
        self.scenario = scenario
        self.method = method
        self.deadline_sec = deadline_sec
        self.ordinal = ordinal  # 1-based submission ordinal (fault plan)
        self.priority = int(priority)  # tier: higher = more important
        # per-job device profiling: when True and MPLC_TORCH_PROFILE_DIR
        # is set, every quantum of THIS job runs under a torch.profiler
        # device trace into <dir>/<job_id>; the
        # trace path lands on the terminal service.job event
        self.profile = bool(profile)
        self.profile_path: "str | None" = None
        # metered device-seconds billed to this job (obs/devcost.py):
        # fenced-sample extrapolation when a batch of a quantum was fenced,
        # the host span otherwise — `device_basis` names the best basis
        # seen
        self.device_seconds = 0.0
        self.device_basis: "str | None" = None
        # the job's resolved service-fault entry (explicit plan merged
        # with the chaos draw), snapshotted at submit so consumption
        # (stall fires once) is per-job state, never shared plan state
        self._fault_entry: "dict | None" = None
        self.status = "queued"
        self.engine = None
        self.subsets = None
        # live-query jobs (submit_live): {"game", "method", "prune", "kw"}
        # — the quantum answers from the tenant's RESIDENT LiveGame
        # instead of building a private sweep engine. `_live_billed`
        # carries the quantum's game-lock-scoped (device_sec, basis)
        # delta to the slice span / failure-billing paths (the generic
        # pre-quantum meter snapshot is skipped: the shared meter may be
        # mid-sibling-quantum at snapshot time)
        self._live_query: "dict | None" = None
        self._live_billed: "tuple | None" = None
        self._live_counts: "dict | None" = None
        self.live_result = None
        # the resolved QueryPlan when the caller asked for
        # method="auto": pinned at submit time for live queries (the
        # resident game's meter is available synchronously), at quantum
        # run time for batch jobs — either way it is journaled and lands
        # on the terminal service.job event so a replay runs the SAME
        # concrete method/kwargs
        self.plan = None
        self.attempts = 0
        self.recovered_values = 0
        self.packed_batches = 0
        self.scores = None
        # the completed job's full v(S) table (host-side floats), stashed
        # at completion so the engine's device state can be released
        self.values: "dict | None" = None
        self.error: "BaseException | None" = None
        self.submitted_at = time.monotonic()
        # SLO landmarks (per-tenant histograms + the report's slo row):
        # first scheduling quantum (queue wait) and first streamed value
        self.first_quantum_at: "float | None" = None
        self.first_value_at: "float | None" = None
        self.deadline_missed = False
        self._done = threading.Event()
        self._journal_cursor = 0    # items of charac_fct_values journaled
        self._cancel_raised = False
        self._slice_packed: dict = {}
        self._stream: list = []     # [(subset, value)] in harvest order
        self._stream_lock = threading.Condition()

    # -- consumer surface ------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: "float | None" = None):
        """Block for the job's contributivity scores; raises the job's
        terminal error (JobQuarantined / JobCancelled) on failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} not finished within {timeout} s "
                f"(status={self.status})")
        if self.error is not None:
            raise self.error
        return self.scores

    def stream(self, timeout: "float | None" = None):
        """Yield `(subset, value)` pairs as they are harvested, ending
        when the job reaches a terminal state. Values arrive in journal
        order; a consumer that starts late still sees every pair."""
        i = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._stream_lock:
                while i >= len(self._stream) and not self._done.is_set():
                    wait = (None if deadline is None
                            else max(deadline - time.monotonic(), 0.0))
                    if wait == 0.0:
                        raise TimeoutError(
                            f"job {self.job_id} stream stalled")
                    self._stream_lock.wait(wait)
                if i < len(self._stream):
                    item = self._stream[i]
                else:
                    return
            yield item
            i += 1

    # -- service-side helpers -------------------------------------------

    def _push_stream(self, items) -> None:
        items = list(items)
        with self._stream_lock:
            self._stream.extend(items)
            self._stream_lock.notify_all()
        if items and self.first_value_at is None:
            # time-to-first-value: submit -> the first v(S) a consumer
            # could observe (journal-recovered seeds count — the tenant
            # sees them just the same)
            self.first_value_at = time.monotonic()
            obs_metrics.histogram(
                "service.time_to_first_value_sec",
                tenant=self.tenant).observe(
                    self.first_value_at - self.submitted_at)

    def _slo_attrs(self) -> dict:
        """SLO fields attached to the terminal `service.job` event (the
        report's slo row reads them back out)."""
        return {
            "queue_wait_sec": (self.first_quantum_at - self.submitted_at
                               if self.first_quantum_at is not None
                               else None),
            "ttfv_sec": (self.first_value_at - self.submitted_at
                         if self.first_value_at is not None else None),
            "deadline_missed": self.deadline_missed,
        }

    def _finish(self) -> None:
        with self._stream_lock:
            self._stream_lock.notify_all()
        self._done.set()

    def _deadline_expired(self) -> bool:
        return (self.deadline_sec is not None
                and time.monotonic() - self.submitted_at > self.deadline_sec)


class _WorkerSlot:
    """One pool worker's scheduler-visible state: its thread, its own
    heartbeat (beaten at quantum starts and batch boundaries — a wedged
    worker flips only ITS liveness on /healthz), the job it is currently
    running, and the device slot it is pinned to."""

    __slots__ = ("index", "thread", "heartbeat", "running_job",
                 "device_slot", "device")

    def __init__(self, index: int, device_slot: int = 0, device=None):
        self.index = index
        self.thread = None
        self.heartbeat = time.monotonic()
        self.running_job = None
        self.device_slot = device_slot
        self.device = device

    def view(self, now: float, stall_sec: float) -> dict:
        age = now - self.heartbeat
        running = self.running_job
        alive = self.thread is None or self.thread.is_alive()
        return {
            "worker": self.index,
            "alive": alive,
            "heartbeat_age_sec": age,
            "running_job": running.job_id if running is not None else None,
            "stalled": running is not None and age > stall_sec,
            "device_slot": self.device_slot,
        }


# torch.profiler traces one window at a time per process (its kineto
# profiler is process-global): quanta of profiled jobs serialize their
# captures through this lock; a quantum that can't get it (another
# profiled job's quantum is mid-capture on a sibling worker) simply runs
# unprofiled — profiling is best-effort observability, never a
# scheduling constraint
_PROFILE_LOCK = threading.Lock()
_profile_warned = False


class _QuantumProfiler:
    """Best-effort `torch.profiler` trace of ONE scheduling quantum
    (`utils.profile_trace` on the job's device: the host's activity and,
    on a card, CUDA's), one Chrome trace a quantum in the job's folder,
    which `obs/analyze_trace.py` summarizes. Serialized process-wide.
    NEVER raises into the quantum: a profiler failure is a warning and
    the quantum runs unprofiled — a job must not quarantine because
    observability hiccuped."""

    def __init__(self, job, path: str):
        self.job = job
        self.path = path
        self._trace = None

    def __enter__(self) -> "_QuantumProfiler":
        global _profile_warned
        if not _PROFILE_LOCK.acquire(blocking=False):
            return self  # a sibling quantum owns the profiler
        try:
            from ..utils import profile_trace
            self._trace = profile_trace(self.path, device=self.job.scenario.device)
            self._trace.__enter__()
            self.job.profile_path = self.path
        except Exception as e:
            self._trace = None
            _PROFILE_LOCK.release()
            if not _profile_warned:
                _profile_warned = True
                logger.warning(
                    "service: torch.profiler trace for job %s failed to "
                    "start (%s); the job runs unprofiled",
                    self.job.job_id, e)
        return self

    def __exit__(self, *exc) -> bool:
        if self._trace is not None:
            try:
                self._trace.__exit__(None, None, None)
            except Exception as e:
                logger.warning(
                    "service: torch.profiler stop failed for job %s (%s)",
                    self.job.job_id, e)
            finally:
                self._trace = None
                _PROFILE_LOCK.release()
        return False


class SweepService:
    """The long-lived multi-tenant sweep scheduler (module docstring)."""

    def __init__(self, journal_path=None, max_pending: "int | None" = None,
                 slice_coalitions: "int | None" = None, start: bool = True,
                 workers: "int | None" = None,
                 shed_p99_sec: "float | None" = None):
        self._lock = threading.Condition()
        self._queue = TierQueue()
        self._jobs: dict = {}
        self._ordinal = 0
        self._closed = False
        self._abandoned = False  # abandon(): SIGKILL-shaped worker stop
        self._running_job = None
        self._workers: list = []
        self._tl = threading.local()  # .worker: the slot running a quantum
        self._packer = CrossTenantPacker()
        self._plan = faults.service_fault_plan_from_env()
        self._max_pending = (max_pending if max_pending is not None
                             else constants._env_positive_int(
                                 constants.SERVICE_MAX_PENDING_ENV, 32))
        self._slice = (slice_coalitions if slice_coalitions is not None
                       else constants._env_positive_int(
                           constants.SERVICE_SLICE_ENV, 16))
        self._n_workers = (workers if workers is not None
                           else constants._env_positive_int(
                               constants.SERVICE_WORKERS_ENV, 1))
        self._priority_default = constants._env_nonneg_int(
            constants.SERVICE_PRIORITY_DEFAULT_ENV, 0)
        self._admission = AdmissionController(
            shed_p99_sec if shed_p99_sec is not None
            else constants._env_nonneg_float(
                constants.SERVICE_SHED_P99_ENV, 0.0))
        self._max_job_retries = constants._env_positive_int(
            constants.MAX_RETRIES_ENV, 3)
        # the live contributivity tier (live/): per-tenant
        # RESIDENT games + the default deadline for the low-latency
        # live-query job class
        self._live_games: dict = {}
        self._live_create_lock = threading.Lock()
        self._live_deadline = constants._env_nonneg_float(
            constants.LIVE_QUERY_DEADLINE_ENV, 0.0)
        self._heartbeat = time.monotonic()
        # fleet scale-out (parallel/fleet.py): when MPLC_TORCH_FLEET_STATE_DIR
        # names a shared state dir, this process publishes its queue
        # depth / admission state there (rate-limited, at submits and
        # heartbeats) and reads the CLUSTER aggregate back into /healthz
        # and into ServiceOverloaded redirect hints — the cross-shard
        # queue view the single-process admission governor lacked. Unset
        # = single-process behavior, byte-identical.
        self._fleet_dir = os.environ.get(constants.FLEET_STATE_DIR_ENV) \
            or None
        self._fleet_shard = (os.environ.get(constants.FLEET_SHARD_ID_ENV)
                             or f"pid{os.getpid()}")
        self._fleet_pub_ts = 0.0
        # live telemetry plane: the /metrics//healthz//varz endpoints
        # exist ONLY when MPLC_TORCH_METRICS_PORT is set (no thread, no
        # socket otherwise); health/varz providers register either way,
        # so an embedding process can poll them directly
        self._export = obs_export.maybe_start_from_env()
        self._provider_key = f"service{next(_SERVICE_IDS)}"
        # WeakMethod: a service dropped without shutdown() must not keep
        # reporting into /healthz //varz forever (shutdown unregisters
        # explicitly; the weakref covers the leak path)
        import weakref
        obs_export.register_health(self._provider_key,
                                   weakref.WeakMethod(self.health_view))
        obs_export.register_varz(self._provider_key,
                                 weakref.WeakMethod(self.varz_view))
        # streaming ingestion sink (POST /live/<tenant>/round): same
        # WeakMethod lifetime contract as the health/varz providers; the
        # route itself only exists when MPLC_TORCH_LIVE_INGEST=1
        obs_export.register_live_ingest(
            self._provider_key, weakref.WeakMethod(self._ingest_live_round))

        # lifetime device-seconds metered per tenant (obs/devcost.py) —
        # fed by every quantum's meter delta AND by journal replay below
        # (terminal records carry the meter), so a restarted service's
        # billing continues where the killed one stopped
        self._tenant_device_seconds: dict = {}
        # journal replay BEFORE the append handle opens: a restart reads
        # history (quarantining a torn tail), then appends to it
        self._journal = None
        self._journal_broken = False
        # abandon() fences the WAL under this lock: no harvest of a quantum
        # still running past the workers' join reaches it afterwards
        self._journal_fence = threading.Lock()
        self._journal_fenced = False
        # terminal jobs retained for handle lookups, FIFO-bounded so a
        # long-lived service's _jobs map can't grow without bound (the
        # caller's own handle keeps an evicted job alive)
        self._terminal_order: deque = deque()
        self._max_terminal_jobs = 256
        # lifetime terminal count: the _jobs map is FIFO-bounded, so
        # counting done entries there would cap /varz's scalar at the
        # retention bound instead of the true total
        self._terminal_seen = 0
        self._recovered: dict = {}
        if journal_path is not None:
            records, _torn = SweepJournal.replay(journal_path)
            for rec in records:
                self._replay_record(rec)
            # restore the /metrics billing counter by RAISING it to the
            # journal's per-tenant totals, never blind-incrementing: the
            # counter is process-global, so a service reconstructed in
            # the SAME process as the one that billed live (tests, an
            # embedding app restarting its service object) must not
            # double-count what both the live path and the journal saw.
            # A fresh process starts at zero and lands exactly on the
            # journaled totals.
            for tenant, total in self._tenant_device_seconds.items():
                c = obs_metrics.counter("service.device_seconds",
                                        tenant=tenant)
                if total > c.value:
                    c.inc(total - c.value)
            self._journal = SweepJournal(journal_path)

        if start:
            self._start_workers()

    def _start_workers(self) -> None:
        """Spin up the worker pool: `MPLC_TORCH_SERVICE_WORKERS` threads,
        each pinned to a device slot (`index % torch.cuda.device_count()`)
        and carrying its own heartbeat. With one card (or none) every slot
        is slot 0 and no device context is applied."""
        import torch
        n_dev = max(torch.cuda.device_count(), 1)
        for i in range(self._n_workers):
            w = _WorkerSlot(index=i, device_slot=i % n_dev,
                            device=(i % n_dev if n_dev > 1 else None))
            w.thread = threading.Thread(
                target=self._worker_loop, args=(w,), daemon=True,
                name=f"mplc-sweep-service-{i}")
            self._workers.append(w)
            w.thread.start()

    # -- recovery --------------------------------------------------------

    def _replay_record(self, rec: dict) -> None:
        kind = rec.get("type")
        job = rec.get("job")
        if kind == "submit":
            slot = self._recovered.setdefault(
                job, {"values": {}, "done": False, "quarantined": False,
                      "cancelled": False, "shed": False})
            # a resubmission after a previous restart re-journals the
            # submit record: MERGE (keep already-replayed values)
            slot.update(tenant=rec.get("tenant"), method=rec.get("method"),
                        partners_count=rec.get("partners_count"))
        elif kind == "value" and job in self._recovered:
            self._recovered[job]["values"][
                tuple(rec["subset"])] = rec["value"]
        elif kind == "done" and job in self._recovered:
            self._recovered[job]["done"] = True
        elif kind == "quarantine" and job in self._recovered:
            self._recovered[job]["quarantined"] = True
        elif kind == "cancel" and job in self._recovered:
            self._recovered[job]["cancelled"] = True
        elif kind == "shed" and job in self._recovered:
            self._recovered[job]["shed"] = True
        if kind in ("done", "quarantine", "cancel", "shed"):
            # terminal records carry the job's metered device-seconds:
            # restore the per-tenant meter so a kill→restart never
            # loses billing (the /metrics counter is raised AFTER the
            # whole replay — see __init__)
            ds = rec.get("device_seconds")
            if ds:
                tenant = (rec.get("tenant")
                          or (self._recovered.get(job) or {}).get("tenant")
                          or "?")
                self._tenant_device_seconds[tenant] = \
                    self._tenant_device_seconds.get(tenant, 0.0) + float(ds)

    # -- live telemetry providers ---------------------------------------

    def health_view(self) -> dict:
        """The /healthz provider: per-worker liveness/heartbeat ages,
        admission-governor state, queue depth and journal status.

        Each worker beats its OWN heartbeat at quantum starts and batch
        boundaries, so one wedged worker flips only its own `stalled`
        flag in the `workers` block. The service-level `healthy` flips
        False when any worker thread DIED, or when every slot currently
        running a job is stalled past STALL_HEALTHY_SEC (a single-worker
        service: its only quantum wedging = unhealthy; in a pool,
        siblings still making progress
        keep the service up while the `workers` block names the wedged
        one). An idle service is healthy at any heartbeat age. The
        `admission` block surfaces overload BEFORE it becomes a 503:
        governor state (healthy|deferring|shedding), the live queue-wait
        p99 vs the shed threshold, and shed/reject accounting."""
        now = time.monotonic()
        with self._lock:
            running = self._running_job
            queue_depth = len(self._queue)
            pending = sum(1 for j in self._jobs.values() if not j.done)
            closed = self._closed
            workers = [w.view(now, STALL_HEALTHY_SEC)
                       for w in self._workers]
            queued_ages = [now - j.submitted_at
                           for j in self._queue.jobs()]
            admission = self._admission.view(queued_ages)
        # the inline slot (start=False / step() mode) has the service's
        # single heartbeat; it only matters when a quantum is actually
        # running there
        inline_age = now - self._heartbeat
        slots = list(workers)
        if not workers or running is not None:
            slots.append({
                "worker": "inline", "alive": True,
                "heartbeat_age_sec": inline_age,
                "running_job": (running.job_id
                                if running is not None else None),
                "stalled": (running is not None
                            and inline_age > STALL_HEALTHY_SEC),
                "device_slot": 0,
            })
        worker_alive = all(w["alive"] for w in workers) if workers else True
        busy = [s for s in slots if s["running_job"] is not None]
        stalled_busy = [s for s in busy if s["stalled"]]
        stalled = bool(stalled_busy)
        all_wedged = bool(busy) and len(stalled_busy) == len(busy)
        running_names = [s["running_job"] for s in busy]
        fleet_view = self._fleet_view()
        extra = {} if fleet_view is None else {"fleet": fleet_view}
        return {
            **extra,
            "healthy": worker_alive and not all_wedged,
            "worker_alive": worker_alive,
            "workers": slots,
            "worker_heartbeat_age_sec": min(
                (s["heartbeat_age_sec"] for s in slots), default=inline_age),
            "stalled": stalled,
            "running_job": running_names[0] if running_names else None,
            "running_jobs": running_names,
            "queue_depth": queue_depth,
            "jobs_pending": pending,
            "closed": closed,
            "admission": admission,
            "journal": ("disabled" if self._journal is None
                        else "broken" if self._journal_broken else "ok"),
        }

    # /varz job-table bound: every non-terminal job is always listed, but
    # only this many of the MOST RECENT terminal jobs — a load-generator
    # run submitting thousands of jobs must not balloon the endpoint
    # response (the full terminal count is retained as a scalar)
    VARZ_TERMINAL_JOBS = 100

    def varz_view(self) -> dict:
        """The /varz provider: the engine-state snapshot — a per-job
        status table (all live jobs + the `VARZ_TERMINAL_JOBS` most
        recent terminal ones; `jobs_total` / `terminal_jobs_total` keep
        the full counts) plus the scheduler's admission/queue knobs."""
        with self._lock:
            recent_terminal = set(
                list(self._terminal_order)[-self.VARZ_TERMINAL_JOBS:])
            jobs = {
                job_id: {
                    "tenant": j.tenant, "method": j.method,
                    "status": j.status, "attempts": j.attempts,
                    "ordinal": j.ordinal, "priority": j.priority,
                    "values_streamed": len(j._stream),
                    "packed_batches": j.packed_batches,
                    "recovered_values": j.recovered_values,
                    "deadline_sec": j.deadline_sec,
                    "age_sec": time.monotonic() - j.submitted_at,
                    "device_seconds": round(j.device_seconds, 6),
                    "device_basis": j.device_basis,
                } for job_id, j in self._jobs.items()
                if not j.done or job_id in recent_terminal}
            listed_terminal = sum(1 for row in jobs.values()
                                  if row["status"] not in ("queued",
                                                           "running"))
            return {
                "jobs": jobs,
                # lifetime totals (the _jobs map itself is FIFO-bounded
                # at 256 terminals, so these come from the monotone
                # counter, not a scan of what happens to be retained)
                "jobs_total": self._terminal_seen + sum(
                    1 for j in self._jobs.values() if not j.done),
                "terminal_jobs_total": self._terminal_seen,
                "terminal_jobs_truncated": max(
                    self._terminal_seen - listed_terminal, 0),
                "queue_depth": len(self._queue),
                "max_pending": self._max_pending,
                "workers": self._n_workers,
                "slice_coalitions": self._slice,
                "admission": self._admission.view(),
                "closed": self._closed,
                "recovered_jobs": len(self._recovered),
                # the live tier's per-tenant resident games: rounds
                # resident, round-stamp, query counts (the dashboard's
                # rounds-resident gauge mirrors live.rounds_resident
                # on /metrics)
                "live_games": {t: g.describe()
                               for t, g in sorted(self._live_games.items())},
                # the process-wide residency manager's state: resident/
                # evicted counts, lifetime evictions/restores, last
                # WAL-restore latency (live/residency.py)
                "live_residency": _live_residency_stats(),
                # lifetime metered device-seconds per tenant (restored
                # from the journal on restart — the billing meter)
                "tenant_device_seconds": {
                    t: round(v, 6)
                    for t, v in sorted(
                        self._tenant_device_seconds.items())},
            }

    def recovered_jobs(self) -> list:
        """Descriptors of journaled submissions from previous service
        lives: `[{job_id, tenant, method, values, done, ...}]`. Resubmit
        each unfinished one with its old `job_id` to complete it — the
        engine memo is seeded from the journaled values, so only
        never-harvested coalitions train."""
        return [{"job_id": jid, "tenant": r.get("tenant"),
                 "method": r.get("method"), "values": len(r["values"]),
                 "done": r["done"], "quarantined": r["quarantined"],
                 "cancelled": r["cancelled"],
                 "shed": r.get("shed", False)}
                for jid, r in self._recovered.items()]

    def adopt_recovered(self, job_id: str, tenant: "str | None" = None,
                        method: "str | None" = None,
                        partners_count: "int | None" = None,
                        values: "dict | None" = None) -> None:
        """Install another shard's journaled partial job into THIS
        service's recovered-jobs table — the fleet router's failover
        path. The router replays a dead shard's WAL
        (`SweepJournal.replay`), hands each incomplete job's harvested
        `{subset_tuple: value}` map here, then resubmits under the old
        `job_id`: `_build_engine` seeds the fresh engine's memo from
        these values exactly as it would from this shard's own journal,
        so the continuation is bit-identical to a solo fault-free run
        and only never-harvested coalitions train. Refuses a `job_id`
        already known to this service (live, or recovered with a
        DIFFERENT seed — adopting over either would mix two games' v(S)
        tables); re-adopting the exact same seed is idempotent, so a
        routing retry that already adopted here (then hit backpressure)
        is a no-op rather than an error."""
        norm = {tuple(s): float(v) for s, v in (values or {}).items()}
        pc = int(partners_count) if partners_count is not None else None
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is shut down")
            if job_id in self._jobs:
                raise ValueError(
                    f"job id {job_id!r} is already live on this service "
                    "— cannot adopt a foreign journal's values for it")
            if job_id in self._recovered:
                slot = self._recovered[job_id]
                if (not slot["done"] and slot["values"] == norm
                        and (pc is None
                             or slot.get("partners_count") is None
                             or pc == slot["partners_count"])):
                    return  # identical seed: idempotent re-adoption
                raise ValueError(
                    f"job id {job_id!r} already has recovered state on "
                    "this service that differs from the adoption "
                    "payload — refusing to overwrite it with a foreign "
                    "journal's")
            self._recovered[job_id] = {
                "values": norm,
                "done": False, "quarantined": False, "cancelled": False,
                "shed": False, "tenant": tenant, "method": method,
                "partners_count": pc}

    # -- submission ------------------------------------------------------

    def _check_credential(self, tenant: str,
                          credential: "str | None") -> None:
        """Authenticate a submit-path tenant claim:
        with `MPLC_TORCH_METRICS_TOKEN` set, a presented credential must be
        the master/operator token or `tenant_token(master, tenant)` —
        anything else raises `ServiceAuthError` synchronously (an auth
        error is a caller mistake, never a quarantine). `credential=None`
        stays the trusted in-process embedder path (the process that can
        call this method could also read the master token from its own
        environment); the HTTP routed-submit surface REQUIRES the
        credential, so the trust boundary authenticates. With no master
        token configured there is no credential scheme to check against
        and every claim passes, unchanged."""
        if credential is None:
            return
        master = os.environ.get(constants.METRICS_TOKEN_ENV)
        if not master:
            return
        cred = str(credential).encode("utf-8", "surrogatepass")
        ok = hmac.compare_digest(cred, master.encode())
        if not ok:
            expect = obs_export.tenant_token(master, tenant)
            ok = hmac.compare_digest(cred, expect.encode())
        if not ok:
            obs_metrics.counter("service.auth_rejected").inc()
            obs_trace.event("service.auth_reject", tenant=tenant)
            raise ServiceAuthError(
                f"credential does not authenticate tenant {tenant!r} "
                "(expected the master token or tenant_token(master, "
                "tenant))")

    def submit(self, scenario, method: str = "Shapley values",
               tenant: str = "tenant0",
               deadline_sec: "float | None" = None,
               job_id: "str | None" = None,
               priority: "int | None" = None,
               profile: bool = False,
               credential: "str | None" = None,
               _live: "dict | None" = None) -> SweepJob:
        """Accept a Scenario+method job onto the bounded queue.

        `priority` is the job's integer tier (default
        `MPLC_TORCH_SERVICE_PRIORITY_DEFAULT`, 0; higher = more
        important): the scheduler weights quanta by `tier + 1` and the
        overload governor defers/sheds the lowest tier first.

        `profile=True` captures a `torch.profiler` device trace of exactly
        this job's quanta into `MPLC_TORCH_PROFILE_DIR/<job_id>` (a no-op
        when the dir knob is unset; best-effort — a profiler failure
        degrades to a warning, never a job fault). The trace path is
        recorded on the job's terminal `service.job` event.

        `credential` authenticates the `tenant` claim when
        `MPLC_TORCH_METRICS_TOKEN` is set (master token or
        `tenant_token(master, tenant)`; a mismatch raises
        `ServiceAuthError` synchronously). None = the trusted in-process
        caller, unchanged — the HTTP routed-submit surface is where the
        credential is mandatory.

        Raises `ServiceClosed` after shutdown, `ServiceOverloaded` when
        the queue is at `MPLC_TORCH_SERVICE_MAX_PENDING` (backpressure —
        its `retry_after_sec` is the live queue-wait p50 backoff hint),
        `ServiceRejected` on a fault-plan injected admission reject,
        `ServiceAuthError` on a bad credential. The accepted submission
        is journaled before this returns."""
        self._check_credential(tenant, credential)
        if _live is not None:
            from ..live import LIVE_METHODS
            if _live["method"] not in LIVE_METHODS:
                raise ValueError(
                    f"unknown live query method {_live['method']!r} "
                    f"(expected one of {LIVE_METHODS})")
        elif method not in constants.CONTRIBUTIVITY_METHODS:
            # validated synchronously: the dispatcher would only log a
            # warning for an unknown name, and a job that "completes"
            # with no scores is worse than a clean submit-time error
            raise ValueError(
                f"unknown contributivity method {method!r} (expected one "
                f"of {constants.CONTRIBUTIVITY_METHODS})")
        if priority is None:
            priority = self._priority_default
        elif int(priority) < 0:
            raise ValueError(
                f"priority must be a non-negative tier, got {priority!r}")
        # cross-shard redirect data is read OUTSIDE the lock (the fleet
        # state dir is typically a shared/network filesystem — per-file
        # reads under the service-wide lock would stall every worker
        # heartbeat exactly when the service is saturated), gated on an
        # unlocked approximate fullness pre-check so the happy path
        # never touches the dir. A race (queue drains between the
        # pre-check and the locked check) only costs the hint, never
        # correctness.
        fleet_view = None
        if self._fleet_dir is not None:
            try:
                approx_pending = sum(1 for j in list(self._jobs.values())
                                     if not j.done)
            except RuntimeError:   # dict mutated mid-iteration
                approx_pending = self._max_pending
            if approx_pending >= self._max_pending:
                fleet_view = self._fleet_view()
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is shut down")
            self._ordinal += 1
            ordinal = self._ordinal
            # the job's resolved fault entry: the explicit per-ordinal
            # plan entry merged with the chaos draw (both deterministic
            # in the submission ordinal)
            entry = faults.merge_service_entries(
                self._plan.get(ordinal),
                faults.chaos_entry(self._plan.get("chaos"), ordinal))
            if entry is not None and entry.get("reject"):
                obs_metrics.counter("service.jobs_rejected").inc()
                self._admission.note_reject()
                obs_trace.event("service.reject", tenant=tenant,
                                ordinal=ordinal, reason="fault_plan")
                raise ServiceRejected(
                    f"admission control rejected submission #{ordinal} "
                    f"({faults.SERVICE_FAULT_PLAN_ENV} reject entry)")
            pending = sum(1 for j in self._jobs.values() if not j.done)
            if pending >= self._max_pending:
                obs_metrics.counter("service.jobs_rejected").inc()
                self._admission.note_reject()
                obs_trace.event("service.reject", tenant=tenant,
                                ordinal=ordinal, reason="backpressure")
                hint = self._admission.retry_after_sec()
                # cross-shard redirect hint: in a sharded fleet
                # deployment a full local queue is not a full CLUSTER —
                # name the least-loaded live sibling so a router can
                # resubmit there instead of backing off (view read
                # before the lock; None when the pre-check raced)
                redirect = ""
                if fleet_view is not None:
                    least = fleet_view.get("least_loaded")
                    if least and least != self._fleet_shard:
                        redirect = (f"; fleet shard {least!r} has the "
                                    "shallowest queue (cluster depth "
                                    f"{fleet_view['cluster_queue_depth']})")
                err = ServiceOverloaded(
                    f"submission queue is full ({pending} pending >= "
                    f"{constants.SERVICE_MAX_PENDING_ENV}="
                    f"{self._max_pending}); resubmit after jobs drain "
                    f"(retry_after_sec={hint:.3f}){redirect}",
                    retry_after_sec=hint)
                err.cluster = fleet_view
                raise err
            if job_id is None:
                job_id = f"job{ordinal}"
            if job_id in self._jobs:
                raise ValueError(f"job id {job_id!r} already submitted "
                                 "to this service")
            job = SweepJob(self, job_id, tenant, scenario,
                           (f"live:{_live['method']}" if _live is not None
                            else method),
                           deadline_sec, ordinal, priority=priority,
                           profile=profile)
            job._fault_entry = entry
            job._live_query = _live
            if _live is not None and _live.get("plan") is not None:
                job.plan = _live["plan"]
            if self._journal is not None:
                # journal BEFORE registering: an un-journalable
                # submission must fail synchronously (the caller is owed
                # the durability contract), never become a phantom job
                # that occupies a MAX_PENDING slot forever
                if self._journal_broken:
                    raise ServiceError(
                        "the service WAL is broken (an earlier append "
                        "failed); refusing new submissions whose "
                        "durability cannot be honored — in-flight jobs "
                        "continue without recovery coverage")
                try:
                    self._journal.append({
                        "type": "submit", "job": job_id, "tenant": tenant,
                        "method": job.method, "priority": int(priority),
                        "partners_count": int(scenario.partners_count),
                        # a submit-time plan (live method="auto") rides
                        # the submit record: replay re-runs the SAME
                        # concrete method, never a re-plan under
                        # different meter state
                        **({"plan": job.plan.describe()}
                           if job.plan is not None else {})})
                except OSError as e:
                    raise ServiceError(
                        f"could not journal submission {job_id!r}: "
                        f"{e}") from e
            self._jobs[job_id] = job
            obs_metrics.counter("service.jobs_accepted").inc()
            obs_trace.event("service.submit", tenant=tenant, job=job_id,
                            method=job.method, ordinal=ordinal,
                            priority=int(priority),
                            **({"planned": job.plan.method,
                                "plan_reason": job.plan.reason}
                               if job.plan is not None else {}))
            self._queue.push(job)
            self._lock.notify_all()
        # the accepted submission moved the queue depth: let the fleet's
        # sibling shards (and their overload hints) see it promptly
        self._publish_fleet_state(force=True)
        return job

    # -- the live contributivity tier ------------------------------------

    def live_game(self, scenario, tenant: str = "tenant0",
                  journal_path=None, **kw):
        """Create (or return) the tenant's RESIDENT live game
        (live/): the recorded round history stays in this
        process across queries, so `submit_live` answers without a
        sweep. One game per tenant; a second call returns the existing
        game (the scenario/journal arguments of the first call win)."""
        from ..live import LiveGame
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is shut down")
            game = self._live_games.get(tenant)
        if game is not None:
            return game
        # creation serialized OUTSIDE the scheduler lock (engine/data
        # construction can take seconds and must not stall every quantum
        # pick) but under its own lock: two racing callers must not BOTH
        # construct — the loser would leak an open journal handle and
        # append a duplicate live_init record to the same WAL
        with self._live_create_lock:
            with self._lock:
                game = self._live_games.get(tenant)
            if game is None:
                game = LiveGame(scenario, tenant=tenant,
                                journal_path=journal_path, **kw)
                with self._lock:
                    self._live_games[tenant] = game
        return game

    def append_round(self, tenant: str, deltas, weights) -> int:
        """Append one aggregation round to the tenant's resident game
        (LiveGame.append_round — journaled, round-stamp invalidation).
        Returns the game's round-stamp after the append."""
        game = self._live_games.get(tenant)
        if game is None:
            raise ServiceError(
                f"no live game for tenant {tenant!r} — call live_game() "
                "first")
        return game.append_round(deltas, weights)

    def _ingest_live_round(self, tenant: str, doc: dict) -> dict:
        """The telemetry server's streaming-ingestion sink
        (`POST /live/<tenant>/round`, obs/export.py, gated on
        `MPLC_TORCH_LIVE_INGEST=1`): decode one wire round — `{"deltas":
        [[shape, dtype, flat-values], ...], "weights": [P floats]}`, the
        exact triples the WAL journals for `live_round` records — and
        feed the tenant's resident game, so round arrival needs no
        in-process call. Error contract (mapped to HTTP by the handler):
        KeyError = unknown tenant (404), ValueError = malformed round
        (400), `ServiceAuthError` = a wire credential that does not
        authenticate the tenant (403); `LiveGameFull`/
        `LiveResidencyFull` propagate with their `retry_after_sec`
        backoff hint (429 + Retry-After)."""
        # a credential riding the wire document authenticates the tenant
        # claim exactly as on submit (the HTTP handler ALSO checks its
        # path-bound bearer token — this covers in-process dispatchers)
        self._check_credential(tenant, doc.get("credential"))
        game = self._live_games.get(tenant)
        if game is None:
            raise KeyError(f"no live game for tenant {tenant!r}")
        from ..live.game import _decode_tree
        try:
            deltas = _decode_tree(doc["deltas"], game._init_params)
            weights = np.asarray(doc["weights"], np.float32)
        except Exception as e:
            raise ValueError(f"malformed live_round document ({e}); "
                             'expected {"deltas": [[shape, dtype, '
                             'flat-values], ...], "weights": [P floats]}')
        stamp = game.append_round(deltas, weights)
        obs_metrics.counter("live.rounds_ingested").inc()
        obs_trace.event("live.ingest", tenant=game.tenant, stamp=stamp,
                        rounds=game.rounds_resident)
        return {"tenant": game.tenant, "stamp": stamp,
                "rounds_resident": game.rounds_resident}

    def submit_live(self, tenant: str, method: str = "GTG-Shapley",
                    deadline_sec: "float | None" = None,
                    job_id: "str | None" = None,
                    priority: "int | None" = None,
                    prune: "float | None" = None,
                    accuracy_target: "float | None" = None,
                    credential: "str | None" = None,
                    **method_kw) -> SweepJob:
        """Submit a low-latency live contributivity query against the
        tenant's resident game. Rides the EXISTING admission/priority/
        SLO machinery — bounded queue, tier-weighted quanta, overload
        shedding, deadlines, journaled terminals — as its own job class:
        by default one priority tier ABOVE the batch default (live
        queries are the latency-sensitive traffic the governor protects)
        with `MPLC_TORCH_LIVE_QUERY_DEADLINE_SEC` as the default deadline
        (0/unset = none; an explicit `deadline_sec` wins). `method` is
        "exact" | "hierarchical" | "GTG-Shapley" | "SVARM" | "auto";
        `prune` is the DPVS threshold tau (None = the env default). The
        answer is `job.result()` (the scores) with the full
        `LiveQueryResult` on `job.live_result`.

        `method="auto"` resolves HERE, synchronously: the adaptive
        planner (contrib/planner.py) routes
        `(partners, accuracy_target, deadline_sec)` to a concrete
        estimator using the resident game's measured per-eval cost, the
        resolved QueryPlan is pinned into the live spec AND the journal's
        submit record (a replay runs the same concrete query, never a
        re-plan), and the plan's prune tau wins when the caller passed
        none — even tau=0 (unpruned) is the plan's decision. The plan is
        admission-aware: the queue's measured p50 wait is subtracted
        from the deadline before routing (floored at a tenth of the
        SLO), so the chosen estimator fits what REMAINS of the tier's
        SLO after queueing, not the wall-clock deadline the job itself
        is still held to.

        `credential` authenticates the tenant claim exactly as in
        `submit` — checked BEFORE the planner runs (an unauthenticated
        caller must not even spend the planning work)."""
        self._check_credential(tenant, credential)
        game = self._live_games.get(tenant)
        if game is None:
            raise ServiceError(
                f"no live game for tenant {tenant!r} — call live_game() "
                "first")
        # the planner must see the EFFECTIVE deadline, so the env
        # default resolves before the auto branch (explicit wins, as
        # documented)
        if deadline_sec is None and self._live_deadline > 0:
            deadline_sec = self._live_deadline
        plan = None
        if method == "auto":
            from ..contrib.planner import (estimate_eval_seconds,
                                           plan_query)
            eval_sec, basis = estimate_eval_seconds(game.engine)
            # admission-aware per-tier SLO: a queued job spends the
            # queue's current p50 wait before any compute runs, so the
            # planner routes against the COMPUTE budget that remains of
            # the deadline (floored at a tenth — a saturated queue must
            # degrade the method choice, not zero the budget). The job's
            # own deadline stays the full SLO.
            plan_deadline = deadline_sec
            if deadline_sec is not None:
                wait = self._admission.retry_after_sec()
                plan_deadline = max(float(deadline_sec) - wait,
                                    float(deadline_sec) * 0.1)
            plan = plan_query(game.engine.partners_count,
                              accuracy_target, plan_deadline,
                              eval_sec=eval_sec, cost_basis=basis,
                              live=True)
            method = plan.method
            if prune is None:
                prune = plan.prune_tau
            method_kw = {**plan.method_kw, **method_kw}
        # validate what the quantum would deterministically reject
        # SYNCHRONOUSLY (same rule as submit()'s method check): a job
        # that can only ever ValueError must not burn the retry budget,
        # quarantine and dump a postmortem for a caller mistake
        from ..live import MAX_EXACT_PARTNERS
        if (method in ("exact", "Shapley values")
                and game.engine.partners_count > MAX_EXACT_PARTNERS):
            raise ValueError(
                f"live exact queries are limited to {MAX_EXACT_PARTNERS} "
                f"partners (this game has {game.engine.partners_count}) "
                "— use hierarchical, GTG-Shapley or SVARM")
        if prune is not None and not 0.0 <= float(prune) <= 1.0:
            raise ValueError(
                f"prune tau must be in [0, 1], got {prune}")
        if priority is None:
            priority = self._priority_default + 1
        return self.submit(game.scenario, tenant=tenant,
                           deadline_sec=deadline_sec, job_id=job_id,
                           priority=priority,
                           _live={"game": game, "method": method,
                                  "prune": prune, "kw": method_kw,
                                  "plan": plan})

    # -- scheduling loop -------------------------------------------------

    def _pick_locked(self) -> tuple:
        """One admission decision + queue pop, caller holding the lock:
        evaluate the overload governor on the live queue-wait signal,
        REMOVE any shed victims from the queue (their terminal
        bookkeeping — journal fsync, metrics, events — happens in
        `_shed_job` AFTER the caller releases the lock: shedding exists
        to recover latency, so it must not stall every worker and
        submit() behind per-victim fsyncs), then pop the next job
        (lowest tier deferred while the governor is unhealthy). Returns
        `(victims, job)`; job is None when the queue is empty."""
        if not len(self._queue):
            return [], None
        now = time.monotonic()
        state = self._admission.evaluate(
            [now - j.submitted_at for j in self._queue.jobs()])
        victims = []
        if state == AdmissionController.SHEDDING:
            victims = self._queue.shed_candidates(
                self._admission.shed_quota(len(self._queue),
                                           self._max_pending))
            self._admission.note_shed(len(victims))
        return victims, self._queue.pop(
            defer_lowest=state != AdmissionController.HEALTHY)

    def _shed_job(self, job: SweepJob) -> None:
        """One victim's classified, journaled `JobShed` terminal —
        never a silent drop. Runs WITHOUT the scheduler lock held."""
        hint = self._admission.retry_after_sec()
        p99 = self._admission._last_p99
        obs_trace.event("service.shed", tenant=job.tenant,
                        job=job.job_id, priority=job.priority,
                        queue_wait_p99_sec=p99,
                        retry_after_sec=hint)
        logger.warning(
            "service: SHED job %s (tier %d) — queue-wait p99 %.2fs "
            "over %s=%.2fs; retry after ~%.2fs", job.job_id,
            job.priority, p99 if p99 is not None else float("nan"),
            constants.SERVICE_SHED_P99_ENV,
            self._admission.shed_p99_sec, hint)
        self._terminal(job, "shed", JobShed(
            f"job {job.job_id} shed by overload admission control "
            f"(queue-wait p99 {p99:.3f}s > "
            f"{constants.SERVICE_SHED_P99_ENV}="
            f"{self._admission.shed_p99_sec}s); resubmit in "
            f"~{hint:.3f}s or at a higher priority",
            retry_after_sec=hint))

    def _shed_all(self, victims) -> None:
        if not victims:
            return
        for job in victims:
            self._shed_job(job)
        # terminal states changed outside the lock: wake drain()/waiters
        with self._lock:
            self._lock.notify_all()

    def _worker_loop(self, worker: "_WorkerSlot") -> None:
        while True:
            with self._lock:
                if self._abandoned:
                    # abandon(): stop at the quantum boundary, leaving
                    # queue/jobs/journal exactly as a SIGKILL would
                    return
                victims, job = self._pick_locked()
                while job is None and not victims and not self._closed:
                    # in a fleet deployment the idle wait is BOUNDED so an
                    # idle shard keeps publishing its (empty) queue state —
                    # an idle sibling that goes stale is excluded from
                    # least_loaded exactly when it is the best redirect
                    # target. Non-fleet services keep the untimed wait.
                    timed_out = not self._lock.wait(
                        timeout=10.0 if self._fleet_dir else None)
                    victims, job = self._pick_locked()
                    if timed_out and job is None and not victims:
                        break
                if job is not None:
                    worker.running_job = job
            self._shed_all(victims)
            if job is None:
                if self._closed:
                    return  # closed and drained
                # idle heartbeat: publish outside the lock (no-op
                # without MPLC_TORCH_FLEET_STATE_DIR), then re-check
                self._publish_fleet_state()
                continue  # everything poppable was shed; re-check
            alive = False
            try:
                alive = self._run_quantum(job, worker=worker)
            finally:
                # clear running AND re-queue under ONE lock hold: a
                # drain() between the two would otherwise see an idle
                # service with a live job in neither place
                with self._lock:
                    worker.running_job = None
                    if alive and not job.done:
                        self._queue.push(job)  # round-robin re-queue
                    self._lock.notify_all()

    def step(self) -> bool:
        """Process ONE scheduling quantum inline (start=False mode — the
        deterministic harness the crash-recovery and chaos-smoke tests
        drive). Returns True while work remains."""
        with self._lock:
            victims, job = self._pick_locked()
            if job is not None:
                self._running_job = job
        self._shed_all(victims)
        if job is None:
            with self._lock:
                return bool(len(self._queue))
        alive = False
        try:
            alive = self._run_quantum(job)
        finally:
            with self._lock:
                self._running_job = None
                if alive and not job.done:
                    self._queue.push(job)
        with self._lock:
            return bool(len(self._queue))

    def run_until_idle(self) -> None:
        """Drain the queue inline (start=False mode)."""
        while self.step():
            pass

    def drain(self, timeout: "float | None" = None) -> None:
        """Block until every accepted job reached a terminal state."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if not self._workers:
            self.run_until_idle()
            return
        with self._lock:
            while (len(self._queue)
                   or any(w.running_job is not None for w in self._workers)
                   or self._running_job is not None):
                wait = (None if deadline is None
                        else max(deadline - time.monotonic(), 0.0))
                if wait == 0.0:
                    raise TimeoutError("service did not drain in time")
                self._lock.wait(wait)

    def abandon(self, timeout: "float | None" = 5.0) -> None:
        """Chaos/test hook: die like a SIGKILL, minus the threads. Stops
        the worker pool at the next quantum boundary WITHOUT draining,
        cancelling, publishing or closing the journal — queued and
        running jobs stay non-terminal and the WAL on disk is exactly
        what a process death would leave, which is what a fleet router's
        failover replays. The currently-running quantum cannot be
        preempted: it finishes, journaling its harvest if it ends within
        `timeout` (the per-thread join). A batch still on the card after
        that (a long quantum) harvests nothing into the WAL, which is
        fenced before abandon() returns, so the journal a router replays
        is final, as a dead process's is. Either way a survivor's re-run
        of its coalitions is bit-identical. Idempotent; an inline
        (start=False) service has no threads to stop, and is only closed
        and its journal fenced."""
        with self._lock:
            self._abandoned = True
            self._closed = True
            self._lock.notify_all()
        for w in self._workers:
            if w.thread is not None \
                    and w.thread is not threading.current_thread():
                w.thread.join(timeout)
        self._workers = []
        with self._journal_fence:
            self._journal_fenced = True

    def shutdown(self, drain: bool = True,
                 timeout: "float | None" = None) -> None:
        """Stop accepting submissions; with `drain` (the default) finish
        every queued job first, otherwise cancel whatever never started.
        Idempotent; closes the journal last. After `abandon()` the
        service is already dead: shutdown only releases resources —
        no draining, no cancel records, no state publishing (the corpse
        must not journal or heartbeat post-mortem)."""
        with self._lock:
            abandoned = self._abandoned
            self._closed = True
            if not drain and not abandoned:
                while len(self._queue):
                    job = self._queue.pop()
                    self._terminal(job, "cancelled",
                                   JobCancelled("service shutdown"))
            self._lock.notify_all()
        if not abandoned:
            # force-publish the `closed: true` state BEFORE draining:
            # without this a cleanly shut-down shard keeps its last
            # (healthy, queue_depth 0) state file for up to the
            # staleness bound and the cluster view recommends a corpse
            # as "least loaded" — exactly the redirect a router must
            # never follow
            self._publish_fleet_state(force=True)
            if drain:
                self.drain(timeout)
        for w in self._workers:
            if w.thread is not None:
                w.thread.join(timeout)
        self._workers = []
        if self._journal is not None:
            self._journal.close()
        for game in self._live_games.values():
            game.close()
        obs_export.unregister(self._provider_key)

    def __enter__(self) -> "SweepService":
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown(drain=exc == (None, None, None))
        return False

    # -- one scheduling quantum ------------------------------------------

    def _beat(self, worker: "_WorkerSlot | None" = None) -> None:
        """Advance the current scheduling slot's heartbeat: the worker's
        own when a pool worker is running the quantum, the service-level
        one in inline (start=False / step()) mode."""
        now = time.monotonic()
        if worker is None:
            worker = getattr(self._tl, "worker", None)
        if worker is not None:
            worker.heartbeat = now
        else:
            self._heartbeat = now
        self._publish_fleet_state()

    def _publish_fleet_state(self, force: bool = False) -> None:
        """Mirror this shard's queue/admission state into the shared
        fleet state dir (no-op without MPLC_TORCH_FLEET_STATE_DIR).
        Rate-limited so the per-batch heartbeat path never turns into a
        per-batch fsync; the snapshot is taken under the lock, the file
        write happens outside it. Never raises."""
        if not self._fleet_dir:
            return
        now = time.monotonic()
        if not force and now - self._fleet_pub_ts < 0.5:
            return
        self._fleet_pub_ts = now
        with self._lock:
            payload = {
                "queue_depth": len(self._queue),
                "jobs_pending": sum(1 for j in self._jobs.values()
                                    if not j.done),
                "max_pending": self._max_pending,
                "workers": max(len(self._workers), 1),
                "admission_state": self._admission.state,
                "closed": self._closed,
                # where a fleet router reaches this shard's HTTP surface
                # (None when no telemetry server is up): the published
                # state dir doubles as the router's service discovery
                "port": obs_export.active_port(),
                # where this shard's WAL lives (None when unjournaled):
                # a router performing failover replays the dead shard's
                # journal from here to resubmit its incomplete jobs
                "journal_path": (self._journal.path
                                 if self._journal is not None else None),
            }
        # the full metrics snapshot rides along (shared log2 buckets):
        # this is what makes the published state dir a SERVERLESS fleet
        # metrics source — the FleetCollector (obs/fleet_view.py, in
        # either package) merges these per-shard
        # snapshots into cluster-true per-tenant SLO quantiles without any
        # shard exposing an HTTP port
        payload["metrics"] = obs_metrics.snapshot()
        from ..parallel import fleet
        fleet.publish_shard_state(self._fleet_dir, self._fleet_shard,
                                  payload)

    def _fleet_view(self) -> "dict | None":
        """The cross-shard cluster aggregate (None without a state dir):
        per-shard queue depths, cluster totals, and the least-loaded
        live shard — what /healthz exposes and overload hints cite."""
        if not self._fleet_dir:
            return None
        from ..parallel import fleet
        view = fleet.cluster_view(self._fleet_dir)
        view["shard_id"] = self._fleet_shard
        return view

    @staticmethod
    def _device_ctx(worker: "_WorkerSlot | None"):
        """The worker's device-slot pin: its quanta run under
        `torch.cuda.device(slot)`, so work a job does not place explicitly
        lands on that card. A single-card host — and the inline mode —
        runs unpinned (a job's engine places its own tensors on its
        scenario's device either way)."""
        if worker is None or worker.device is None:
            return contextlib.nullcontext()
        import torch
        return torch.cuda.device(worker.device)

    def _run_quantum(self, job: SweepJob,
                     worker: "_WorkerSlot | None" = None) -> bool:
        """Run one slice of `job`. Returns True when the job should be
        re-queued (work remains), False on any terminal state. EVERY
        failure is contained here: nothing a job does may unwind into
        the scheduler loop (per-tenant isolation)."""
        self._beat(worker)
        self._tl.worker = worker
        expired = job._deadline_expired()
        if job.first_quantum_at is None:
            if expired:
                # expired while STILL QUEUED: cancel before any work —
                # and before the queue-wait observation below, so an
                # expired wait never lands in the SLO histograms (it is
                # a deadline miss, not a latency datum) and ttfv stays
                # unset
                self._note_deadline_miss(job)
                self._terminal(job, "cancelled", JobCancelled(
                    f"job {job.job_id} exceeded deadline_sec="
                    f"{job.deadline_sec} while still queued"))
                return False
            # queue wait: submit -> the scheduler first picks the job up
            # (the injected stall below bills against the job's SLICE
            # time, like any slow quantum, not its queue wait); the same
            # sample feeds the admission governor's sliding window
            job.first_quantum_at = time.monotonic()
            wait = job.first_quantum_at - job.submitted_at
            obs_metrics.histogram(
                "service.queue_wait_sec",
                tenant=job.tenant).observe(wait)
            with self._lock:
                self._admission.observe_queue_wait(wait)
        entry = job._fault_entry
        if entry is not None and entry.get("stall_sec"):
            sec, entry["stall_sec"] = entry["stall_sec"], 0.0
            obs_trace.event("service.stall", tenant=job.tenant,
                            job=job.job_id, seconds=sec)
            logger.warning("service: injected stall of %.2f s before %s",
                           sec, job.job_id)
            time.sleep(sec)
            # the stall billed against the job's own deadline
            expired = expired or job._deadline_expired()
        if expired:
            self._note_deadline_miss(job)
            self._terminal(job, "cancelled", JobCancelled(
                f"job {job.job_id} exceeded deadline_sec="
                f"{job.deadline_sec} before its quantum"))
            return False
        job.status = "running"
        span = obs_trace.start_span("service.slice", tenant=job.tenant,
                                    job=job.job_id)
        try:
            with self._device_ctx(worker), self._profile_ctx(job):
                return self._run_quantum_body(job, span)
        finally:
            self._tl.worker = None

    def _profile_ctx(self, job: SweepJob):
        """The per-job device-trace context (submit's `profile=True`
        flag x `MPLC_TORCH_PROFILE_DIR`): captures exactly this job's
        quanta — sibling tenants' quanta on other workers never enter
        the trace."""
        if not job.profile:
            return contextlib.nullcontext()
        profile_dir = os.environ.get(constants.PROFILE_DIR_ENV)
        if not profile_dir:
            return contextlib.nullcontext()
        return _QuantumProfiler(job, os.path.join(profile_dir, job.job_id))

    def _run_quantum_body(self, job: SweepJob, span) -> bool:
        meter_before = None
        try:
            if job.engine is None:
                if job._live_query is not None:
                    self._attach_live_engine(job)
                else:
                    self._build_engine(job)
            eng = job.engine
            meter = getattr(eng, "device_meter", None)
            # live quanta snapshot/bill inside the GAME lock instead —
            # the resident engine's meter is shared with sibling quanta
            meter_before = (meter.snapshot()
                            if meter is not None
                            and job._live_query is None else None)
            b0, e0 = eng._batch_ordinal, eng.epochs_trained
            s0, p0 = eng.samples_trained, job.packed_batches
            c0 = len(eng.charac_fct_values)
            if job._live_query is not None:
                finished = self._run_live_quantum(job)
            elif job.method == "Shapley values":
                finished = self._run_exact_slice(job)
            else:
                finished = self._run_method_quantum(job)
            if job._live_query is not None:
                dev_sec, dev_basis = job._live_billed or (0.0, None)
                job._live_billed = None
            else:
                dev_sec, dev_basis = self._meter_quantum(job, meter_before)
            meter_before = None  # billed; the except paths must not re-bill
            if job._live_query is not None:
                # counters snapshotted under the GAME lock (sibling
                # quanta share the resident engine; unlocked deltas
                # would report their work too); coalitions = this
                # query's reconstruction evaluations
                counts = job._live_counts or {}
                job._live_counts = None
                span.attrs.update(
                    **counts, packed_batches=job.packed_batches - p0,
                    device_sec=dev_sec, device_basis=dev_basis)
            else:
                span.attrs.update(
                    batches=eng._batch_ordinal - b0,
                    coalitions=len(eng.charac_fct_values) - c0,
                    epochs=eng.epochs_trained - e0,
                    samples=eng.samples_trained - s0,
                    packed_batches=job.packed_batches - p0,
                    device_sec=dev_sec, device_basis=dev_basis)
            span.end()
            obs_metrics.histogram(
                "service.slice_sec", tenant=job.tenant).observe(
                    span.duration)
            if finished:
                self._complete(job)
                return False
            return True
        except JobCancelled as e:
            span.cancel()
            self._bill_failed_quantum(job, meter_before, span, "cancelled")
            self._journal_new_values(job)  # keep what the drain harvested
            self._terminal(job, "cancelled", e)
            return False
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — the isolation boundary
            span.cancel()
            # bill + preserve whatever the failed attempt harvested
            # before the fault: the journal (and the engine memo) make
            # the retry a bit-identical continuation, not a restart —
            # and the tenant pays for the device time its fault consumed
            self._bill_failed_quantum(job, meter_before, span, "fault")
            try:
                self._journal_new_values(job)
            except Exception:
                logger.exception(
                    "service: journaling after a fault failed for %s",
                    job.job_id)
            return self._fail_attempt(job, e)

    def _bill_failed_quantum(self, job: SweepJob, before: "dict | None",
                             span, outcome: str) -> None:
        """Billing for a quantum that did NOT complete (deadline cancel,
        fault): the tenant pays for the device time its quantum
        consumed, and — because the `service.slice` span was CANCELLED,
        never emitted — a replacement slice EVENT carries the billed
        delta into the trace stream. Without it the report's per-tenant
        device_seconds/cost_share would silently disagree with the
        /metrics counter and the journal for exactly the tenants whose
        faults consumed device time. Live quanta were already billed
        inside the game lock (`_run_live_quantum`'s finally) — their
        stashed delta feeds the replacement event here instead of a
        second metering pass."""
        if job._live_query is not None:
            dsec, dbasis = job._live_billed or (0.0, None)
            job._live_billed = None
        else:
            dsec, dbasis = self._meter_quantum(job, before)
        if dsec:
            obs_trace.event(
                "service.slice", dur=span.duration or 0.0,
                tenant=job.tenant, job=job.job_id,
                device_sec=dsec, device_basis=dbasis, outcome=outcome)

    def _meter_quantum(self, job: SweepJob,
                       before: "dict | None") -> "tuple[float, str | None]":
        """Bill the quantum's device-seconds delta (obs/devcost.py) to
        the job and its tenant: the `service.device_seconds{tenant=...}`
        counter, the scheduler's lifetime per-tenant map (/varz), and
        the job's own total (journaled at terminal). Returns the
        (seconds, basis) pair the `service.slice` span records."""
        eng = job.engine
        meter = getattr(eng, "device_meter", None) if eng is not None \
            else None
        if meter is None or before is None:
            return 0.0, None
        delta = devcost.meter_delta(before, meter.snapshot())
        sec, basis = devcost.estimate_device_seconds(delta)
        if sec > 0:
            job.device_seconds += sec
            job.device_basis = devcost.merge_basis(job.device_basis, basis)
            obs_metrics.counter("service.device_seconds",
                                tenant=job.tenant).inc(sec)
            with self._lock:
                self._tenant_device_seconds[job.tenant] = \
                    self._tenant_device_seconds.get(job.tenant, 0.0) + sec
        return sec, (basis if sec > 0 else None)

    def _fail_attempt(self, job: SweepJob, err: BaseException) -> bool:
        """Attempt-level retry/quarantine policy. Retryable failures
        (transient-classified, OOM that escaped the engine's own ladder,
        injected crash) re-queue the job up to MPLC_TORCH_MAX_RETRIES
        attempts; permanent ones (LadderExhaustedError, genuine bugs)
        quarantine immediately — a poison job must never retry forever."""
        job.attempts += 1
        retryable = (faults.is_transient(err) or faults.is_oom(err)
                     or isinstance(err, faults.InjectedCrash))
        requeued = retryable and job.attempts <= self._max_job_retries
        # `requeued` distinguishes a retry from the quarantining final
        # attempt, so the report's slo row counts exactly what the live
        # service.job_retries counter counts
        obs_trace.event("service.job_fault", tenant=job.tenant,
                        job=job.job_id, attempt=job.attempts,
                        retryable=retryable, requeued=requeued,
                        error=str(err)[:200])
        if requeued:
            obs_metrics.counter("service.job_retries",
                                tenant=job.tenant).inc()
            logger.warning(
                "service: job %s attempt %d failed (%s) — re-queueing "
                "(its harvested values persist; the continuation is "
                "bit-identical)", job.job_id, job.attempts, err)
            return True
        kind = ("retry budget exhausted" if retryable
                else "permanent failure")
        # postmortem BEFORE the terminal bookkeeping: the flight ring
        # still holds the failing attempt's spans (engine.dispatch /
        # engine.fault / service.job_fault of the batch that died)
        postmortem = obs_flight.dump("job_quarantined", extra={
            "job": job.job_id, "tenant": job.tenant,
            "attempts": job.attempts, "kind": kind,
            "error": str(err)[:500]})
        logger.error(
            "service: quarantining job %s after %s: %s%s",
            job.job_id, kind, err,
            f" — postmortem flight record: {postmortem}"
            if postmortem else "")
        q = JobQuarantined(
            f"job {job.job_id} quarantined ({kind}, "
            f"{job.attempts} attempt(s)): {err}")
        # __cause__ accepts any BaseException — the injected-crash case
        # must not be the one place the root cause is lost
        q.__cause__ = err
        self._terminal(job, "quarantined", q)
        return False

    # -- engine lifecycle ------------------------------------------------

    def _build_engine(self, job: SweepJob) -> None:
        from ..contrib.bank import ProgramBank
        from ..contrib.engine import CharacteristicEngine
        from ..contrib.shapley import powerset_order

        eng = CharacteristicEngine(job.scenario)
        if eng.program_bank is not None:
            # shape-scoped keys: same (slots, width) bucket => same banked
            # program regardless of which tenant's game it serves
            eng.program_bank = ProgramBank(eng, shared=True)
        entry = job._fault_entry
        if entry is not None and entry.get("batch"):
            # install the job's injected batch faults (explicit plan
            # merged with the chaos draw) into ITS engine's private
            # injector: FaultInjector's fire-once/retry-keeps-ordinal
            # semantics apply per tenant, exactly as solo
            eng._faults = faults.FaultInjector(
                {k: list(v) for k, v in entry["batch"].items()})

        def on_batch(done_in_group, remaining, slot_count,
                     _job=job) -> None:
            self._on_batch(_job, slot_count)

        eng.progress = on_batch
        job.engine = eng
        job.subsets = powerset_order(eng.partners_count)

        rec = self._recovered.get(job.job_id)
        if rec and rec["values"]:
            # the journaled submission is the authority on which GAME the
            # job_id names: seeding a different scenario's engine from it
            # would silently mix two games' v(S) tables
            jp = rec.get("partners_count")
            if jp is not None and int(jp) != eng.partners_count:
                raise ValueError(
                    f"journaled job {job.job_id!r} was submitted with "
                    f"{jp} partners but the resubmitted scenario has "
                    f"{eng.partners_count} — refusing to seed v(S) from "
                    "a different game's journal (resubmit the original "
                    "scenario, or use a fresh job_id)")
            # seed the fresh engine's memo from the journal: replay in
            # journal (= harvest) order reproduces the increment
            # bookkeeping of the original run, and the journaled floats
            # round-trip exactly — the continuation is bit-identical
            for subset, value in rec["values"].items():
                if subset and subset not in eng.charac_fct_values:
                    eng._store(subset, float(value))
            job.recovered_values = len(rec["values"])
            job._journal_cursor = len(eng.charac_fct_values)
            job._push_stream([(s, v) for s, v in rec["values"].items()])
            obs_metrics.counter("service.jobs_recovered").inc()
            obs_trace.event("service.recover", tenant=job.tenant,
                            job=job.job_id, values=job.recovered_values)
            # the seeded table now lives in the engine memo; a duplicate
            # job_id can't be resubmitted in this service life, so free
            # the replayed copy (a restart on a long journal must not pin
            # every historical job's 2^P-entry table twice). Entries for
            # jobs never resubmitted keep theirs until process exit —
            # WAL compaction is future work.
            rec["values"] = {}
        else:
            # the engine pre-seeds v(empty)=0; never journal it
            job._journal_cursor = len(eng.charac_fct_values)

    def _on_batch(self, job: SweepJob, slot_count) -> None:
        """The engine's per-batch progress hook: journal what the batch
        harvested, count cross-tenant packed batches, and enforce the
        deadline cooperatively — raising BETWEEN batches, never inside a
        dispatch."""
        self._beat()  # the running worker's own heartbeat (thread-local)
        self._journal_new_values(job)
        if job._slice_packed.get(slot_count):
            job.packed_batches += 1
            obs_metrics.counter("service.cross_tenant_packed_batches").inc()
        if job._deadline_expired() and not job._cancel_raised:
            # raise ONCE: the engine's exception-unwind drain re-enters
            # this hook for the in-flight batch, and a second raise there
            # would abort the drain's bookkeeping
            job._cancel_raised = True
            self._note_deadline_miss(job)
            raise JobCancelled(
                f"job {job.job_id} exceeded deadline_sec="
                f"{job.deadline_sec} (cancelled at a batch boundary)")

    def _journal_safe(self, *recs) -> None:
        """Async-path WAL appends (harvest values, terminal states): a
        journal write failure here (disk full, dead volume) must DEGRADE
        the service — recovery coverage stops, loudly — never unwind into
        the scheduler loop and kill the worker with jobs still blocked on
        their handles. (submit() is the synchronous path and propagates
        instead: an unacknowledged durability contract is the caller's to
        handle.)"""
        with self._journal_fence:
            if self._journal is None or self._journal_broken or self._journal_fenced:
                return
            try:
                self._journal.append_many(list(recs))
            except OSError as e:
                self._journal_broken = True
                obs_trace.event("service.journal_broken", error=str(e)[:200])
                logger.error(
                    "service: WAL append failed (%s) — journaling DISABLED; "
                    "crash recovery no longer covers work from this point on",
                    e)

    def _journal_new_values(self, job: SweepJob) -> None:
        """Append every not-yet-journaled `(tenant, subset, value)` to the
        WAL — one fsync for the whole batch — and the tenant's stream, in
        memo insertion (= harvest) order."""
        eng = job.engine
        if eng is None:
            return
        items = list(eng.charac_fct_values.items())
        fresh = items[job._journal_cursor:]
        if not fresh:
            return
        job._journal_cursor = len(items)
        self._journal_safe(*[
            {"type": "value", "job": job.job_id, "tenant": job.tenant,
             "subset": list(subset), "value": float(value)}
            for subset, value in fresh])
        job._push_stream(fresh)

    def _attach_live_engine(self, job: SweepJob) -> None:
        """Point a live-query job at its tenant's RESIDENT game engine
        (shared across queries — never rebuilt, never released). The
        journal cursor is parked at the engine's current memo size: live
        answers are reconstruction-derived and journaled by the game's
        OWN WAL, so the service WAL must not re-journal the shared
        engine's exact memo under this job."""
        eng = job._live_query["game"].engine
        job.engine = eng
        job.subsets = None
        job._journal_cursor = len(eng.charac_fct_values)

    def _run_live_quantum(self, job: SweepJob) -> bool:
        """One live query runs as ONE quantum (like the estimator
        methods): the resident game answers from reconstruction — zero
        training batches — while the heartbeat and cooperative deadline
        ride the shared engine's per-batch progress hook for the
        quantum's duration.

        The whole quantum body holds the GAME's lock: the engine, its
        progress hook, its device meter and the evaluator memo are all
        shared with every other quantum of this tenant, so a sibling
        worker's live quantum must not interleave — it would clobber
        this quantum's hook (driving the wrong job's heartbeat/deadline)
        and its device work would land inside both quanta's meter
        windows (double-billed device-seconds). The meter snapshot is
        therefore taken INSIDE the lock (the generic quantum pre-snapshot
        is skipped for live jobs) and the billed delta is stashed on the
        job for the slice span / failure-billing paths."""
        spec = job._live_query
        game = spec["game"]
        eng = job.engine

        def on_batch(done_in_group, remaining, slot_count,
                     _job=job) -> None:
            self._on_batch(_job, slot_count)

        with game._lock:
            meter = getattr(eng, "device_meter", None)
            before = meter.snapshot() if meter is not None else None
            # batch/epoch/sample accounting snapshotted INSIDE the lock
            # too: the shared engine's counters advance under sibling
            # quanta, and this quantum's slice span must report only its
            # own work (same rule as the meter)
            b0, e0, s0 = (eng._batch_ordinal, eng.epochs_trained,
                          eng.samples_trained)
            prev = eng.progress
            eng.progress = on_batch
            try:
                result = game.query(method=spec["method"],
                                    prune=spec.get("prune"),
                                    **(spec.get("kw") or {}))
            finally:
                eng.progress = prev
                # bill inside the lock: the window contains exactly this
                # quantum's device work (a faulted/cancelled query pays
                # for what it consumed, like any quantum)
                job._live_billed = self._meter_quantum(job, before)
                job._live_counts = {
                    "batches": eng._batch_ordinal - b0,
                    "epochs": eng.epochs_trained - e0,
                    "samples": eng.samples_trained - s0,
                }
            job._live_counts["coalitions"] = result.evaluations
            # the completed query's v(S) table, snapshotted while appends
            # are still excluded — _complete must not touch the shared
            # evaluator outside the lock (a racing append_round would
            # reset_recorded under it)
            job.values = dict(game._evaluator().values)
        job.scores = np.asarray(result.scores)
        job.live_result = result
        # a submit-time plan (method="auto") rides the result handle:
        # the game saw only the concrete method, so the plan attaches
        # here for `job.live_result.describe()` consumers
        if spec.get("plan") is not None and result.plan is None:
            result.plan = spec["plan"]
        # stream the answer as one terminal item so stream() consumers
        # (and the ttfv SLO histogram) see live answers like batch values
        job._push_stream([(("live", spec["method"]),
                           [float(x) for x in result.scores])])
        return True

    # -- the two execution shapes ---------------------------------------

    def _run_exact_slice(self, job: SweepJob) -> bool:
        """One slice of an exact-Shapley sweep: evaluate the next
        `MPLC_TORCH_SERVICE_SLICE` missing coalitions. Returns True when
        the sweep's table is complete."""
        eng = job.engine
        missing = [s for s in job.subsets
                   if s not in eng.charac_fct_values]
        if missing:
            chunk = missing[:self._slice]
            # the chunk is all-missing, so sweep_plan == the buckets
            # evaluate() will actually dispatch
            job._slice_packed = self._packer.observe_plan(
                job.tenant, eng, eng.sweep_plan(chunk))
            eng.evaluate(chunk)
            self._journal_new_values(job)
        return len(missing) <= self._slice

    def _run_method_quantum(self, job: SweepJob) -> bool:
        """Estimator methods (TMCS, GTG-Shapley, ...) drive the engine
        from their own host loop, so they run as ONE quantum: the worker
        is theirs for the method's duration, but per-batch journaling,
        deadline cancellation and fault isolation all still apply through
        the engine hooks."""
        from ..contrib.contributivity import Contributivity

        eng = job.engine
        job._slice_packed = self._packer.observe_plan(
            job.tenant, eng, eng.sweep_plan(job.subsets))
        job.scenario._charac_engine = eng
        contrib = Contributivity(job.scenario)
        # method="auto" resolves at run time (the engine's meter/bank
        # cost truth exists only once the job's engine is built); the
        # job's deadline is the planner's budget. The resolved plan is
        # journaled so the WAL replay knows the concrete query, and
        # lands on the terminal service.job event.
        contrib.compute_contributivity(job.method,
                                       deadline_sec=job.deadline_sec)
        plan = getattr(contrib, "plan", None)
        if plan is not None:
            job.plan = plan
            self._journal_safe({"type": "plan", "job": job.job_id,
                                "tenant": job.tenant,
                                "plan": plan.describe()})
        self._journal_new_values(job)
        job.scores = np.asarray(contrib.contributivity_scores)
        return True

    # -- terminal states -------------------------------------------------

    def _note_deadline_miss(self, job: SweepJob) -> None:
        if not job.deadline_missed:
            job.deadline_missed = True
            obs_metrics.counter("service.deadline_misses",
                                tenant=job.tenant).inc()

    def _release_engine_data(self, job: SweepJob) -> None:
        """Drop the completed job's device-resident state (stacked data,
        eval sets, trainers and their pipelines, the reconstruction
        evaluator and its flattened stream, the bank view) while KEEPING
        the engine object and its host-side v(S)/counters for the handle's
        consumers — a long-lived service completing many jobs must not
        accumulate one game's device tensors per job."""
        eng = job.engine
        if eng is None:
            return
        if job._live_query is not None:
            # the engine belongs to the tenant's RESIDENT live game —
            # shared across queries; drop only this handle's reference
            job.engine = None
            return
        eng.progress = None
        for attr in ("stacked", "val", "test", "trainer", "multi_pipe",
                     "single_pipe", "program_bank", "_reconstruction"):
            setattr(eng, attr, None)
        eng._slot_pipes = {}

    def _retire(self, job: SweepJob) -> None:
        """FIFO-bound the terminal-job registry: handles returned to
        callers stay alive through their own reference, but the service's
        _jobs map (and its job-id dedupe window) is bounded."""
        with self._lock:
            self._terminal_seen += 1
            self._terminal_order.append(job.job_id)
            while len(self._terminal_order) > self._max_terminal_jobs:
                old = self._terminal_order.popleft()
                j = self._jobs.get(old)
                if j is not None and j.done:
                    self._jobs.pop(old, None)

    def _complete(self, job: SweepJob) -> None:
        if job.scores is None:
            from ..contrib.shapley import shapley_from_characteristic
            job.scores = shapley_from_characteristic(
                job.engine.partners_count, job.engine.charac_fct_values)
        if job._live_query is None:
            job.values = dict(job.engine.charac_fct_values)
        # live jobs: `job.values` was snapshotted from the game's
        # evaluator UNDER the game lock in _run_live_quantum — touching
        # the shared evaluator here would race a sibling append_round's
        # reset_recorded (and a concurrent query's memo inserts)
        job.status = "completed"
        # the terminal record carries the job's metered device-seconds:
        # replay restores per-tenant billing across restarts
        self._journal_safe({"type": "done", "job": job.job_id,
                            "tenant": job.tenant,
                            "device_seconds": job.device_seconds,
                            "device_basis": job.device_basis})
        obs_metrics.counter("service.jobs_completed").inc()
        obs_metrics.histogram("service.job_attempts",
                              tenant=job.tenant).observe(job.attempts)
        obs_trace.event(
            "service.job", tenant=job.tenant, job=job.job_id,
            status="completed", attempts=job.attempts,
            recovered=job.recovered_values > 0,
            packed_batches=job.packed_batches,
            seconds=time.monotonic() - job.submitted_at,
            device_seconds=job.device_seconds,
            device_basis=job.device_basis,
            **({"profile_path": job.profile_path}
               if job.profile_path else {}),
            **({"planned": job.plan.method,
                "plan_reason": job.plan.reason,
                "plan": job.plan.describe()}
               if job.plan is not None else {}),
            **job._slo_attrs())
        self._release_engine_data(job)
        self._retire(job)
        job._finish()

    def _terminal(self, job: SweepJob, status: str,
                  err: BaseException) -> None:
        job.status = status
        job.error = err
        # the engine holds the only references to the job's device
        # buffers (stacked data, eval sets, any banked-state leftovers):
        # dropping it here is what "cancelled without leaking device
        # buffers" means
        job.engine = None
        kind = {"cancelled": "cancel", "quarantined": "quarantine",
                "shed": "shed"}[status]
        self._journal_safe({"type": kind, "job": job.job_id,
                            "tenant": job.tenant,
                            "device_seconds": job.device_seconds,
                            "device_basis": job.device_basis,
                            "error": str(err)[:500]})
        counter = {"cancelled": "service.jobs_cancelled",
                   "quarantined": "service.jobs_quarantined",
                   "shed": "service.jobs_shed"}[status]
        obs_metrics.counter(counter).inc()
        obs_metrics.histogram("service.job_attempts",
                              tenant=job.tenant).observe(job.attempts)
        obs_trace.event(
            "service.job", tenant=job.tenant, job=job.job_id,
            status=status, attempts=job.attempts,
            recovered=job.recovered_values > 0,
            packed_batches=job.packed_batches,
            seconds=time.monotonic() - job.submitted_at,
            device_seconds=job.device_seconds,
            device_basis=job.device_basis,
            **({"profile_path": job.profile_path}
               if job.profile_path else {}),
            **({"planned": job.plan.method,
                "plan_reason": job.plan.reason}
               if job.plan is not None else {}),
            error=str(err)[:200], **job._slo_attrs())
        self._retire(job)
        job._finish()
