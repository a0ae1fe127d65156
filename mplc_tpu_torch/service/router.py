"""The fleet router (port of `mplc_tpu/service/router.py`): the
redirect-acting, tenant-sticky front over N `SweepService` shards.

The fleet's state plane (parallel/fleet.py) gives every shard a published
state file and every `ServiceOverloaded` a least-loaded redirect hint;
this module acts on them:

  **Redirects, acted on.** `FleetRouter.submit` resubmits on
  `ServiceOverloaded` and `JobShed`, following the error's cluster
  redirect hint (`least_loaded`) with capped exponential backoff that
  honours the error's own `retry_after_sec` in full. A per-job routing
  budget (`MPLC_TORCH_ROUTER_BUDGET`, default 8 attempts) bounds the loop;
  past it the failure surfaces classified as `RoutedJobFailed`, never a
  silent drop, never an unbounded retry storm.

  **Tenant stickiness.** A tenant's resident `LiveGame` and banked
  programs live on one shard, and routing its next job elsewhere forfeits
  that residency. The router pins each tenant to the shard that last
  accepted its work and keeps routing there, breaking the pin only on
  shard death or after `MPLC_TORCH_ROUTER_REPIN_OVERLOADS` overloads in a
  row from the pinned shard: a deliberate, journaled re-pin
  (`router.repin`).

  **Cluster-wide shed coordination.** A shard's published state carries
  its admission governor's state. The router offers no new work to a
  deferring or shedding shard while a healthy one remains, so per-shard
  shedding becomes fleet-level degradation; with every shard unhealthy it
  falls back to the least loaded of the living (refusing all work would
  turn an overload into an outage).

  **Failover.** A shard whose published heartbeat goes stale
  (`cluster_view`'s staleness bound), whose `/healthz` fails, or which a
  fault plan kills is drained from the table. The router replays the dead
  shard's journal (`SweepJournal.replay`), hands each incomplete job's
  harvested `{subset: value}` map to a survivor through
  `SweepService.adopt_recovered`, and resubmits under the old job id: the
  survivor's engine is seeded from those values, so a failed-over job's
  v(S) table is bit-equal to a solo fault-free run on the same device and
  only never-harvested coalitions train again. The router computes no
  number: every v(S) comes from a shard's engine.

Two shard flavours share one routing core:

  `InProcShard` wraps a `SweepService` in this process (inline
  `start=False` services are advanced by `FleetRouter.pump`). A killed
  in-process shard is abandoned, not shut down: its journal stays exactly
  as a SIGKILL would leave it, which is what failover replays.

  `HttpShard` is a peer process discovered through the shared fleet state
  folder (a shard publishes its telemetry port and journal path there).
  Submission is `POST /router/submit` on the peer's telemetry server
  (`ShardServer` and obs/export.py, gated on `MPLC_TORCH_ROUTER_SERVE=1`);
  results are polled with `GET /router/job?id=`. With
  `MPLC_TORCH_METRICS_TOKEN` set the wire requires the per-tenant HMAC
  credential: the in-process embedder is trusted, the network is not.

The router fault plan (`MPLC_TORCH_ROUTER_FAULT_PLAN`, faults.py) kills
shards on a schedule (`shardkill@shard1:sec5`), so failover is a routine,
deterministically exercised path.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import urllib.error
import urllib.request
import weakref
from urllib.parse import quote as _urlquote

from .. import constants, faults
from ..obs import export as obs_export
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .journal import SweepJournal
from .scheduler import (JobShed, ServiceAuthError, ServiceClosed,
                        ServiceError, ServiceOverloaded)

logger = logging.getLogger("mplc_tpu_torch")

# capped exponential backoff: attempt k waits
# max(retry_after hint, min(base * 2^(k-1), base * _BACKOFF_CAP_MULT)); the
# cap bounds the router's own exponential term, never a shard's explicit
# retry_after_sec hint
_BACKOFF_CAP_MULT = 32.0
# liveness probes (healthz, cluster view) are rate-limited per shard, so a
# tight routing loop never becomes a tight HTTP or stat loop
_PROBE_INTERVAL_SEC = 0.5
_HTTP_TIMEOUT_SEC = 10.0
# terminal routed jobs are archived as small summaries (shard, status,
# attempts), not kept as full records: a long-lived router must not keep
# one request and handle a job forever. /varz shows the most recent
_DONE_JOBS_KEEP = 256


class RoutedJobFailed(ServiceError):
    """The routing budget ran out (or no live shard remained) before any
    shard accepted the job. A classified terminal outcome, counted in
    `router.budget_exhausted`, journaled on the `router.exhausted` event,
    its `__cause__` the last shard error. Nothing is wrong with the job
    itself: resubmit when the cluster has capacity."""

    def __init__(self, msg: str, tenant: "str | None" = None,
                 job_id: "str | None" = None, attempts: int = 0):
        super().__init__(msg)
        self.tenant = tenant
        self.job_id = job_id
        self.attempts = int(attempts)


class ShardUnavailable(ServiceError):
    """The targeted shard is dead or unreachable at submit time
    (connection refused, a closed service, a killed handle). Routing
    counts it as a failed attempt and excludes the shard; it never leaves
    `FleetRouter.submit`."""


# -- shard handles --------------------------------------------------------------

class InProcShard:
    """One in-process `SweepService` behind the router. `kill()` abandons
    the service (no shutdown, no journal close): the WAL on disk is what a
    SIGKILL would leave, which is what failover replays. A threaded
    (`start=True`) service also has its worker pool stopped
    (`SweepService.abandon`), and no batch of it appends to the WAL once
    the kill returns: a dead shard must not keep executing the jobs that
    failover resubmits to survivors."""

    kind = "inproc"

    def __init__(self, shard_id: str, service):
        self.shard_id = str(shard_id)
        self.service = service
        self.dead = False
        self._drained = False  # failover ran for this shard

    @property
    def journal_path(self) -> "str | None":
        j = self.service._journal
        return j.path if j is not None else None

    def admission_state(self) -> str:
        return self.service._admission.state

    def queue_depth(self) -> int:
        return len(self.service._queue)

    def closed(self) -> bool:
        return bool(self.service._closed)

    def submit(self, req: dict, recover: "dict | None" = None):
        if self.dead:
            raise ShardUnavailable(f"shard {self.shard_id!r} is dead")
        if recover is not None:
            self._adopt(recover, req)
        return self.service.submit(
            req["scenario"], method=req["method"], tenant=req["tenant"],
            deadline_sec=req.get("deadline_sec"), job_id=req["job_id"],
            priority=req.get("priority"), credential=req.get("credential"))

    def _adopt(self, recover: dict, req: dict) -> None:
        # re-adopting the same seed on a routing retry is idempotent inside
        # adopt_recovered; a differing seed raises: a real bug, never
        # swallowed (it would break the bit-equality silently)
        self.service.adopt_recovered(
            req["job_id"], tenant=req["tenant"], method=req["method"],
            partners_count=recover.get("partners_count"),
            values=recover.get("values") or {})

    def job_status(self, job_id: str) -> dict:
        job = self.service._jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        return _job_doc(job)

    def kill(self) -> None:
        self.dead = True
        if self.service._workers:
            # a threaded service's workers would otherwise keep executing
            # the very jobs failover is about to resubmit to survivors
            # (duplicate execution, double metering). abandon() stops them
            # and fences the journal without draining, cancelling or
            # closing it, so the WAL stays SIGKILL-shaped for the replay
            self.service.abandon()

    def pump(self) -> bool:
        """Advance an inline (start=False) service one scheduling quantum;
        True while it has work. Threaded services drain themselves:
        pumping them would run quanta on the router's thread."""
        if self.dead or self.service._workers:
            return False
        try:
            return self.service.step()
        except Exception:  # a shard's crash is its own; the router routes
            logger.exception("router: in-process shard %s pump failed", self.shard_id)
            return False

    def describe(self) -> dict:
        return {"kind": self.kind, "dead": self.dead, "closed": self.closed(),
                "admission_state": self.admission_state(),
                "queue_depth": self.queue_depth(),
                "journal_path": self.journal_path}


class HttpShard:
    """A peer shard process reached over its telemetry server's routed
    surface (`POST /router/submit`, `GET /router/job`: ShardServer, gated
    on MPLC_TORCH_ROUTER_SERVE=1). Discovered through the fleet state
    folder: the shard's published state carries its `port` and
    `journal_path`, refreshed at every cluster-view poll."""

    kind = "http"

    def __init__(self, shard_id: str, port: "int | None" = None,
                 host: str = "127.0.0.1", journal_path: "str | None" = None,
                 credential: "str | None" = None):
        self.shard_id = str(shard_id)
        self.host = host
        self.port = port
        self.journal_path = journal_path
        self.dead = False
        self._drained = False
        self._admission_state = "healthy"
        self._queue_depth = 0
        self._closed = False
        self._last_probe = 0.0
        # the operator's bearer for the polling GET (the submit credential
        # rides each request's body)
        self._credential = credential

    def update_from_state(self, row: dict) -> None:
        """Fold one published cluster_view row into the handle."""
        if row.get("port") is not None:
            self.port = int(row["port"])
        if row.get("journal_path"):
            self.journal_path = row["journal_path"]
        self._admission_state = row.get("admission_state") or "healthy"
        self._queue_depth = int(row.get("queue_depth") or 0)
        self._closed = bool(row.get("closed"))

    def admission_state(self) -> str:
        return self._admission_state

    def queue_depth(self) -> int:
        return self._queue_depth

    def closed(self) -> bool:
        return self._closed

    # -- the wire ----------------------------------------------------------

    def _url(self, path: str) -> str:
        if self.port is None:
            raise ShardUnavailable(f"shard {self.shard_id!r} has not published a port")
        return f"http://{self.host}:{self.port}{path}"

    def _request(self, path: str, body: "dict | None" = None) -> dict:
        req = urllib.request.Request(
            self._url(path),
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self._credential}"}
                        if self._credential else {})},
            method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=_HTTP_TIMEOUT_SEC) as resp:
                return json.loads(resp.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            raise self._classify(e) from e
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise ShardUnavailable(f"shard {self.shard_id!r} unreachable: {e}") from e

    def _classify(self, e: "urllib.error.HTTPError") -> ServiceError:
        """An HTTP error status as the service error it stands for."""
        try:
            doc = json.loads(e.read().decode() or "{}")
        except Exception:
            doc = {}
        msg = doc.get("error") or f"HTTP {e.code}"
        if e.code == 429:
            err = (JobShed if doc.get("kind") == "shed" else ServiceOverloaded)(
                msg, retry_after_sec=float(doc.get("retry_after_sec") or 0.0))
            err.cluster = doc.get("cluster")
            return err
        if e.code in (401, 403):
            return ServiceAuthError(msg)
        if e.code == 503:
            return ShardUnavailable(msg)
        return ServiceError(msg)

    def submit(self, req: dict, recover: "dict | None" = None):
        body = {"spec": req.get("spec"), "method": req["method"],
                "tenant": req["tenant"], "job_id": req["job_id"],
                "priority": req.get("priority"),
                "deadline_sec": req.get("deadline_sec"),
                "credential": req.get("credential")}
        if recover is not None:
            body["recover"] = {
                "partners_count": recover.get("partners_count"),
                "values": [[list(s), v] for s, v in
                           sorted((recover.get("values") or {}).items())]}
        ack = self._request("/router/submit", body)
        return ack.get("job") or req["job_id"]

    def job_status(self, job_id: str) -> dict:
        return self._request(f"/router/job?id={_urlquote(job_id)}")

    def healthz_ok(self) -> bool:
        try:
            self._request("/healthz")
            return True
        except ShardUnavailable:
            return False
        except ServiceError:
            # an HTTP error status other than 503 still proves liveness
            return True

    def kill(self) -> None:
        # whoever owns the process kills it (load_gen's router mode, an
        # operator); the router's part is draining the table
        self.dead = True

    def pump(self) -> bool:
        return False

    def describe(self) -> dict:
        return {"kind": self.kind, "dead": self.dead, "closed": self._closed,
                "port": self.port, "admission_state": self._admission_state,
                "queue_depth": self._queue_depth, "journal_path": self.journal_path}


def _job_doc(job) -> dict:
    """One job's status document (shared by the in-process handle and the
    ShardServer's GET /router/job): terminal status, scores and the full
    v(S) table, host floats that round-trip exactly through JSON, which
    keeps the bit-equality check valid over the wire."""
    doc = {"job": job.job_id, "tenant": job.tenant, "status": job.status,
           "done": job.done,
           "error": (f"{type(job.error).__name__}: {job.error}"
                     if job.error is not None else None)}
    if job.done and job.error is None:
        scores = job.scores
        if scores is not None and hasattr(scores, "tolist"):
            scores = scores.tolist()
        doc["scores"] = scores
        if job.values is not None:
            doc["values"] = [[list(s), float(v)] for s, v in sorted(job.values.items())]
    return doc


# -- the routed job's handle ----------------------------------------------------

class RoutedJob:
    """The handle of one router-submitted job. It has the `SweepJob`
    consumer surface (`done`, `status`, `result`) and survives failover:
    when the accepting shard dies, the router resubmits and swaps the
    inner handle, and `result()` keeps working and returns the values a
    fault-free run would."""

    def __init__(self, router, job_id: str, tenant: str):
        self.router = router
        self.job_id = job_id
        self.tenant = tenant
        self.shard_id: "str | None" = None
        self.attempts = 0
        self.failed_over = False
        self.recovered_values = 0   # the v(S) its last failover seeded from the WAL
        self._inner = None          # the SweepJob (in-process shards)
        self._remote: "HttpShard | None" = None
        self._error: "BaseException | None" = None
        self._final: "dict | None" = None

    @property
    def done(self) -> bool:
        if self._error is not None or self._final is not None:
            return True
        if self._inner is not None:
            return self._inner.done
        return False

    @property
    def status(self) -> str:
        if self._error is not None:
            return "failed"
        if self._final is not None:
            return self._final.get("status", "done")
        if self._inner is not None:
            return self._inner.status
        return "routed"

    def result(self, timeout: "float | None" = None):
        """Block for the contributivity scores; raises the terminal error
        (`RoutedJobFailed` after the budget ran out, else the shard's own
        `JobQuarantined`, `JobCancelled` or `JobShed`)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._error is not None:
                raise self._error
            if self._inner is not None:
                wait = (None if deadline is None
                        else max(deadline - time.monotonic(), 0.0))
                try:
                    return self._inner.result(wait)
                except TimeoutError:
                    raise
                except ServiceError:
                    # the shard may have died during the wait and the router
                    # swapped the handle: only a terminal error that is still
                    # this job's own surfaces
                    if self._error is not None:
                        raise self._error from None
                    raise
            doc = self._final or self.router._poll_job(self)
            if doc is not None and doc.get("done"):
                self._final = doc
                if doc.get("error"):
                    raise ServiceError(f"routed job {self.job_id} failed on shard "
                                       f"{self.shard_id}: {doc['error']}")
                return doc.get("scores")
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"routed job {self.job_id} not finished "
                                   f"(status={self.status})")
            time.sleep(0.05)

    def values(self) -> "dict | None":
        """The completed job's full v(S) table `{subset_tuple: float}`
        (None until done): what the bit-equality checks compare against
        a solo fault-free run."""
        if self._inner is not None and self._inner.values is not None:
            return dict(self._inner.values)
        doc = self._final
        if doc is None and self._remote is not None:
            doc = self.router._poll_job(self)
            if doc is not None and doc.get("done"):
                self._final = doc
        if doc and doc.get("values") is not None:
            return {tuple(s): float(v) for s, v in doc["values"]}
        return None


# -- the router -----------------------------------------------------------------

class FleetRouter:
    """The routing front (module docstring). Build it with explicit shards
    (`add_shard`, or `shards=` mapping ids to SweepServices for an
    in-process fleet) and/or a fleet `state_dir` whose published shard
    states fold into the table at every refresh (HTTP peers).

    Thread-safe for concurrent `submit` callers; the backoff waits happen
    outside the table's lock. `close()` unregisters the /varz provider and
    closes the router's own re-pin journal; it does not shut the shards
    down (the router fronts services it does not own)."""

    def __init__(self, shards: "dict | None" = None,
                 state_dir: "str | None" = None,
                 budget: "int | None" = None,
                 backoff_sec: "float | None" = None,
                 repin_overloads: "int | None" = None,
                 journal_path: "str | None" = None,
                 fault_plan: "list | str | None" = None,
                 credential: "str | None" = None):
        self._budget = (int(budget) if budget is not None
                        else constants._env_positive_int(constants.ROUTER_BUDGET_ENV, 8))
        self._backoff = (float(backoff_sec) if backoff_sec is not None
                         else constants._env_nonneg_float(constants.ROUTER_BACKOFF_ENV, 0.05))
        self._repin_overloads = (
            int(repin_overloads) if repin_overloads is not None
            else constants._env_positive_int(constants.ROUTER_REPIN_OVERLOADS_ENV, 3))
        if fault_plan is None:
            fault_plan = faults.router_fault_plan_from_env()
        elif isinstance(fault_plan, str):
            fault_plan = faults.parse_router_fault_plan(fault_plan)
        self._plan = list(fault_plan)
        self._fired: set = set()
        self._state_dir = state_dir
        self._credential = credential
        self._lock = threading.RLock()
        self._shards: dict = {}          # shard_id -> handle, in insertion order
        self._pins: dict = {}            # tenant -> shard_id
        self._pin_overloads: dict = {}   # tenant -> overloads in a row
        self._routed: dict = {}          # job_id -> {"req", "shard", "handle"}
        self._done_jobs: dict = {}       # job_id -> summary (bounded archive)
        self._next_id = 0
        self._t0 = time.monotonic()
        self._journal = SweepJournal(journal_path) if journal_path else None
        # totals mirrored on /varz and the report's router row
        self.stats = {"routed": 0, "resubmits": 0, "repins": 0,
                      "failovers": 0, "budget_exhausted": 0}
        if shards:
            for sid, svc in shards.items():
                self.add_shard(sid, svc)
        self._provider_key = f"router_{id(self):x}"
        obs_export.register_varz(self._provider_key, weakref.WeakMethod(self.varz_view))

    # -- the table -----------------------------------------------------------

    def add_shard(self, shard_id: str, service_or_handle) -> None:
        """Add a shard: a `SweepService` (wrapped in an `InProcShard`) or a
        handle (`InProcShard` or `HttpShard`)."""
        handle = service_or_handle
        if not isinstance(handle, (InProcShard, HttpShard)):
            handle = InProcShard(shard_id, service_or_handle)
        with self._lock:
            self._shards[str(shard_id)] = handle

    def shard_ids(self) -> list:
        with self._lock:
            return list(self._shards)

    def close(self) -> None:
        obs_export.unregister(self._provider_key)
        if self._journal is not None:
            self._journal.close()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- liveness and the fault plan -----------------------------------------

    def _resolve_shard_name(self, name: str) -> "str | None":
        """A fault plan's shard name: the exact table id first, else
        `shard<N>` addresses the N-th shard (0-based insertion order), so
        one plan works against generated `pid<...>` ids."""
        with self._lock:
            if name in self._shards:
                return name
            m = re.fullmatch(r"shard(\d+)", name)
            if m is not None:
                ids = list(self._shards)
                n = int(m.group(1))
                if n < len(ids):
                    return ids[n]
        return None

    def _poll_faults(self) -> None:
        if not self._plan:
            return
        elapsed = time.monotonic() - self._t0
        for i, entry in enumerate(self._plan):
            if i in self._fired or elapsed < entry["at_sec"]:
                continue
            self._fired.add(i)
            sid = self._resolve_shard_name(entry["shard"])
            obs_trace.event("router.fault", kind=entry["kind"],
                            shard=sid or entry["shard"], at_sec=entry["at_sec"])
            if sid is not None:
                self.kill_shard(sid)
            else:
                logger.warning("router: fault plan names unknown shard %r (table: %s)",
                               entry["shard"], list(self._shards))

    def kill_shard(self, shard_id: str) -> None:
        """Kill a shard (in-process: abandon the service without a
        shutdown; HTTP: drain the handle, its owner kills the process)
        and run failover for its incomplete jobs."""
        with self._lock:
            shard = self._shards[str(shard_id)]
        # outside the lock: abandoning a threaded shard waits for its
        # workers' running quantum
        shard.kill()
        self._failover(shard)

    def _refresh(self) -> None:
        """One liveness pass: fire due fault-plan entries, fold the
        published cluster view into the table (HTTP discovery, admission
        states), and fail over any shard newly found dead (stale state, a
        failed /healthz, unreachable). Also retires terminal routed jobs:
        their full records are dropped and a summary archived for /varz,
        so a long-lived router holds what is in flight, not every job it
        ever routed."""
        with self._lock:
            for jid in [j for j, rec in self._routed.items() if rec["handle"].done]:
                h = self._routed.pop(jid)["handle"]
                self._done_jobs[jid] = {"shard": h.shard_id, "status": h.status,
                                        "attempts": h.attempts,
                                        "failed_over": h.failed_over}
            while len(self._done_jobs) > _DONE_JOBS_KEEP:
                del self._done_jobs[next(iter(self._done_jobs))]
        self._poll_faults()
        view = None
        if self._state_dir:
            from ..parallel import fleet
            view = fleet.cluster_view(self._state_dir)
            with self._lock:
                for sid, row in view["shards"].items():
                    handle = self._shards.get(sid)
                    if handle is None:
                        handle = HttpShard(sid, credential=self._credential)
                        handle.update_from_state(row)
                        self._shards[sid] = handle
                    elif isinstance(handle, HttpShard):
                        handle.update_from_state(row)
        dead = []
        with self._lock:
            for shard in self._shards.values():
                if shard.dead:
                    continue
                if self._looks_dead(shard, view):
                    shard.kill()
                    dead.append(shard)
        for shard in dead:
            self._failover(shard)

    def _looks_dead(self, shard, view: "dict | None") -> bool:
        if isinstance(shard, InProcShard):
            return False  # killed only explicitly (kill_shard, the plan)
        row = (view or {}).get("shards", {}).get(shard.shard_id)
        if row is not None and row.get("stale"):
            # the heartbeat went stale: probe /healthz before declaring
            # death (a shard starved of publish cycles may still serve)
            return not self._probe(shard)
        if row is None and view is not None:
            return not self._probe(shard)
        return False

    def _probe(self, shard: "HttpShard") -> bool:
        now = time.monotonic()
        if now - shard._last_probe < _PROBE_INTERVAL_SEC:
            return not shard.dead
        shard._last_probe = now
        return shard.healthz_ok()

    # -- picking a shard -------------------------------------------------------

    def _offerable(self, exclude) -> list:
        """The shards offered new work: alive, not closed and
        admission-healthy (the cluster-wide shed coordination: a deferring
        or shedding governor gets nothing new). Falls back to the alive
        but unhealthy ones when no healthy shard remains: degraded routing
        beats refusing the whole fleet's work."""
        with self._lock:
            alive = [s for sid, s in self._shards.items()
                     if not s.dead and not s.closed() and sid not in exclude]
        healthy = [s for s in alive if s.admission_state() == "healthy"]
        return healthy or alive

    def _pick(self, tenant: str, exclude, prefer: "str | None" = None):
        """The tenant's pin first, the redirect hint second, the least
        loaded last. None when nothing is offerable."""
        cands = self._offerable(exclude)
        if not cands:
            return None
        by_id = {s.shard_id: s for s in cands}
        with self._lock:
            pin = self._pins.get(tenant)
        if pin in by_id:
            return by_id[pin]
        if prefer in by_id:
            return by_id[prefer]
        return min(cands, key=lambda s: s.queue_depth())

    # -- stickiness -------------------------------------------------------------

    def _break_pin(self, tenant: str, reason: str, to: "str | None" = None) -> None:
        with self._lock:
            old = self._pins.pop(tenant, None)
            if old is None:
                return
            self._pin_overloads.pop(tenant, None)
            self.stats["repins"] += 1
        obs_metrics.counter("router.repins").inc()
        obs_trace.event("router.repin", tenant=tenant, **{"from": old}, to=to, reason=reason)
        if self._journal is not None:
            try:
                self._journal.append({"type": "repin", "tenant": tenant,
                                      "from": old, "to": to, "reason": reason})
            except OSError as e:
                logger.warning("router: could not journal a re-pin: %s", e)

    def _note_overload(self, tenant: str, shard_id: str) -> None:
        # counting and breaking must be one atomic step: a concurrent
        # _accept (a re-pin to a fresh shard, its count reset) between the
        # two would otherwise have its new pin broken
        with self._lock:
            if self._pins.get(tenant) != shard_id:
                return
            n = self._pin_overloads.get(tenant, 0) + 1
            self._pin_overloads[tenant] = n
            if n >= self._repin_overloads:
                # sustained overload from the pinned shard: a deliberate
                # re-pin (the new pin lands on the next accepted submit)
                self._break_pin(tenant, reason="overload")

    # -- submission ---------------------------------------------------------------

    def submit(self, scenario=None, method: str = "Shapley values",
               tenant: str = "tenant0", deadline_sec: "float | None" = None,
               job_id: "str | None" = None, priority: "int | None" = None,
               credential: "str | None" = None,
               spec: "dict | None" = None) -> RoutedJob:
        """Route one job to the fleet. `scenario` feeds in-process shards;
        `spec` is the serializable game description (the
        `scenario_builder`'s argument) an HTTP peer rebuilds it from; a
        fleet of both flavours needs both. Returns a `RoutedJob`; raises
        `RoutedJobFailed` when the budget runs out and `ServiceAuthError`
        when a shard rejects the credential (the caller's mistake:
        retrying it would spend the budget on a wrong password)."""
        with self._lock:
            self._next_id += 1
            if job_id is None:
                job_id = f"rt{self._next_id}"
            if job_id in self._routed or job_id in self._done_jobs:
                # terminal jobs older than the archive window are
                # forgotten, and their ids can be used again
                raise ValueError(f"job id {job_id!r} already routed by this router")
        if credential is None:
            credential = self._credential
        req = {"scenario": scenario, "spec": spec, "method": method,
               "tenant": tenant, "deadline_sec": deadline_sec,
               "job_id": job_id, "priority": priority, "credential": credential}
        handle = RoutedJob(self, job_id, tenant)
        t0 = time.monotonic()
        inner, shard, attempts = self._route(req, handle)
        route_s = time.monotonic() - t0
        handle.attempts = attempts
        self._accept(handle, req, shard, inner)
        self.stats["routed"] += 1
        obs_metrics.counter("router.jobs_routed").inc()
        obs_metrics.histogram("router.route_sec", tenant=tenant).observe(route_s)
        obs_trace.event("router.submit", tenant=tenant, job=job_id,
                        shard=shard.shard_id, attempts=attempts,
                        route_s=round(route_s, 6))
        return handle

    def _accept(self, handle: RoutedJob, req: dict, shard, inner) -> None:
        with self._lock:
            handle.shard_id = shard.shard_id
            if isinstance(shard, InProcShard):
                handle._inner = inner
                handle._remote = None
            else:
                handle._inner = None
                handle._remote = shard
            self._routed[handle.job_id] = {"req": req, "shard": shard.shard_id,
                                           "handle": handle}
            self._pins[req["tenant"]] = shard.shard_id
            self._pin_overloads[req["tenant"]] = 0

    def _route(self, req: dict, handle: RoutedJob, recover: "dict | None" = None,
               exclude: "frozenset | set" = frozenset()) -> tuple:
        """The routing core: pick, submit, follow redirects, bounded by the
        budget. Returns `(inner, shard, attempts)`."""
        exclude = set(exclude)
        tenant, job_id = req["tenant"], req["job_id"]
        attempts = 0
        prefer = None
        last: "BaseException | None" = None
        while True:
            self._refresh()
            shard = self._pick(tenant, exclude, prefer)
            prefer = None
            if shard is None:
                raise self._exhaust(req, attempts,
                                    "no live shard remains in the routing table", last)
            attempts += 1
            try:
                inner = shard.submit(req, recover=recover)
            except (ServiceOverloaded, JobShed) as e:
                last = e
                self._note_overload(tenant, shard.shard_id)
                self.stats["resubmits"] += 1
                obs_metrics.counter("router.resubmits").inc()
                hint = float(getattr(e, "retry_after_sec", 0.0) or 0.0)
                prefer = (getattr(e, "cluster", None) or {}).get("least_loaded")
                if prefer == shard.shard_id:
                    prefer = None
                obs_trace.event("router.redirect", tenant=tenant, job=job_id,
                                attempt=attempts, retry_after_sec=round(hint, 6),
                                to=prefer, **{"from": shard.shard_id})
                if attempts >= self._budget:
                    raise self._exhaust(req, attempts,
                                        f"last shard {shard.shard_id!r} said: {e}", e)
                self._backoff_wait(hint, attempts)
            except (ShardUnavailable, ServiceClosed) as e:
                # the table was wrong: the shard died between the refresh
                # and the submit. Drain it (failover resubmits its jobs;
                # this one was never accepted there) and move on
                last = e
                with self._lock:
                    dead_shard = self._shards.get(shard.shard_id)
                if dead_shard is not None and not dead_shard.dead:
                    dead_shard.kill()
                    self._failover(dead_shard)
                exclude.add(shard.shard_id)
                if attempts >= self._budget:
                    raise self._exhaust(req, attempts,
                                        f"last shard {shard.shard_id!r} said: {e}", e)
            else:
                return inner, shard, attempts

    def _exhaust(self, req: dict, attempts: int, why: str,
                 cause: "BaseException | None") -> RoutedJobFailed:
        self.stats["budget_exhausted"] += 1
        obs_metrics.counter("router.budget_exhausted").inc()
        obs_trace.event("router.exhausted", tenant=req["tenant"], job=req["job_id"],
                        attempts=attempts, budget=self._budget)
        err = RoutedJobFailed(
            f"routing budget exhausted for job {req['job_id']!r} (tenant "
            f"{req['tenant']!r}): {attempts} attempt(s) of "
            f"{constants.ROUTER_BUDGET_ENV}={self._budget}; {why}",
            tenant=req["tenant"], job_id=req["job_id"], attempts=attempts)
        err.__cause__ = cause
        return err

    def _backoff_wait(self, hint: float, attempt: int) -> None:
        """Capped exponential backoff that honours the shard's own
        retry_after hint in full; inline in-process shards are pumped
        while the router waits, so the backpressure being backed off from
        actually drains."""
        delay = max(hint, min(self._backoff * (2.0 ** (attempt - 1)),
                              self._backoff * _BACKOFF_CAP_MULT))
        deadline = time.monotonic() + delay
        while True:
            worked = False
            with self._lock:
                shards = list(self._shards.values())
            for s in shards:
                worked = s.pump() or worked
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            if not worked:
                time.sleep(min(remaining, 0.01))

    # -- failover -------------------------------------------------------------------

    def _failover(self, shard) -> None:
        """Drain a dead shard: replay its journal, resubmit its incomplete
        routed jobs to survivors through the recovered-jobs path (their
        continuations bit-equal), and break the pins that pointed at the
        corpse: each tenant re-pins once per death, on its first
        resubmitted job."""
        with self._lock:
            if shard._drained:
                return
            shard._drained = True
            victims = [rec for rec in self._routed.values()
                       if rec["shard"] == shard.shard_id and not rec["handle"].done]
            pinned_tenants = [t for t, sid in self._pins.items() if sid == shard.shard_id]
        self.stats["failovers"] += 1
        obs_metrics.counter("router.failovers").inc()
        recovered = self._replay_journal(shard)
        resubmitted = 0
        for rec in victims:
            req, handle = rec["req"], rec["handle"]
            jrec = recovered.get(req["job_id"]) or {}
            if jrec.get("done") and handle._inner is not None and handle._inner.done:
                continue  # completed before the death; the handle has it
            recover = {"values": jrec.get("values") or {},
                       "partners_count": (jrec.get("partners_count")
                                          if jrec.get("partners_count") is not None
                                          else self._partners_of(req))}
            # the re-pin: break the dead pin before routing so the pick
            # lands on a survivor; the accept below sets the new pin, one
            # re-pin per (tenant, death)
            with self._lock:
                pinned_to_corpse = self._pins.get(req["tenant"]) == shard.shard_id
            if pinned_to_corpse:
                self._break_pin(req["tenant"], reason="death")
            try:
                inner, new_shard, attempts = self._route(
                    req, handle, recover=recover, exclude={shard.shard_id})
            except RoutedJobFailed as e:
                # surfaced classified on the handle: a failover that cannot
                # place a job must not hang its consumer
                handle._error = e
                handle._inner = None
                continue
            handle.attempts += attempts
            handle.failed_over = True
            handle.recovered_values = len(recover["values"])
            self._accept(handle, req, new_shard, inner)
            resubmitted += 1
        # tenants pinned to the corpse with no job in flight still lose
        # their pin (their next submit re-pins)
        with self._lock:
            remaining = [t for t in pinned_tenants if self._pins.get(t) == shard.shard_id]
        for t in remaining:
            self._break_pin(t, reason="death")
        obs_trace.event("router.failover", shard=shard.shard_id, jobs=len(victims),
                        resubmitted=resubmitted)

    @staticmethod
    def _partners_of(req: dict) -> "int | None":
        sc = req.get("scenario")
        if sc is not None:
            return int(sc.partners_count)
        spec = req.get("spec") or {}
        return int(spec["partners"]) if spec.get("partners") is not None else None

    def _replay_journal(self, shard) -> dict:
        """A dead shard's WAL as `{job_id: {"values": {subset: float},
        "done": bool, "partners_count": int}}`: the records
        `SweepService._replay_record` reads, replayed here because the
        dead service can no longer do it. A missing or torn journal gives
        what it gives: failover seeds from whatever was durably harvested,
        and the rest trains again, to the same bits."""
        path = shard.journal_path
        out: dict = {}
        if not path or not os.path.exists(path):
            return out
        try:
            records, _torn = SweepJournal.replay(path)
        except Exception as e:  # corrupt in the middle: recover nothing
            logger.warning("router: journal replay for dead shard %s failed: %s",
                           shard.shard_id, e)
            return out
        for rec in records:
            kind, job = rec.get("type"), rec.get("job")
            if kind == "submit":
                slot = out.setdefault(job, {"values": {}, "done": False})
                slot["partners_count"] = rec.get("partners_count")
            elif kind == "value" and job in out:
                out[job]["values"][tuple(rec["subset"])] = rec["value"]
            elif kind in ("done", "quarantine", "cancel", "shed") and job in out:
                out[job]["done"] = True
        return out

    # -- polling and pumping -----------------------------------------------------

    def _poll_job(self, handle: RoutedJob) -> "dict | None":
        self._refresh()
        with self._lock:
            shard = self._shards.get(handle.shard_id)
        if shard is None or shard.dead:
            return None
        try:
            return shard.job_status(handle.job_id)
        except (ShardUnavailable, KeyError):
            return None

    def pump(self) -> bool:
        """Advance every alive inline in-process shard one quantum (and
        fire due fault-plan entries). True while any shard has work or any
        routed job is not terminal: the deterministic drive loop."""
        self._refresh()
        with self._lock:
            shards = list(self._shards.values())
            handles = [r["handle"] for r in self._routed.values()]
        busy = False
        for s in shards:
            busy = s.pump() or busy
        return busy or any(not h.done for h in handles)

    def run_until_idle(self, timeout: "float | None" = None) -> None:
        """Pump until every routed job is terminal."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.pump():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("router did not drain in time")

    # -- observability -----------------------------------------------------------

    def varz_view(self) -> dict:
        """The /varz `router_*` block: the routing table, the tenants'
        pins and the routing totals. `jobs` holds every job in flight and
        the last `_DONE_JOBS_KEEP` terminal ones (older ones live on only
        in the totals)."""
        with self._lock:
            table = {sid: s.describe() for sid, s in self._shards.items()}
            pins = dict(self._pins)
            jobs = {jid: dict(s) for jid, s in self._done_jobs.items()}
            jobs.update({jid: {"shard": r["shard"], "status": r["handle"].status,
                               "attempts": r["handle"].attempts,
                               "failed_over": r["handle"].failed_over}
                         for jid, r in self._routed.items()})
        return {"budget": self._budget, "backoff_sec": self._backoff,
                "repin_overloads": self._repin_overloads,
                "table": table, "pins": pins, "jobs": jobs, **self.stats}


# -- the shard's side of the wire -------------------------------------------------

class ShardServer:
    """The shard's half of the HTTP wire: wraps this process's
    `SweepService` as a routed peer. Registers the obs/export.py sink
    behind `POST /router/submit` and `GET /router/job` (the routes exist
    only with `MPLC_TORCH_ROUTER_SERVE=1` and a running telemetry server,
    `MPLC_TORCH_METRICS_PORT`), rebuilds each wire spec into a `Scenario`
    through the injected `scenario_builder(spec)`, and enforces the wire's
    rule: with `MPLC_TORCH_METRICS_TOKEN` set a routed submission must
    carry a credential, checked before any state changes (adopting a
    recover payload and building the scenario come after the check)."""

    def __init__(self, service, scenario_builder):
        self.service = service
        self.scenario_builder = scenario_builder
        self._key = f"router_shard_{id(self):x}"
        obs_export.register_router(self._key, weakref.WeakMethod(self.handle))

    def close(self) -> None:
        obs_export.unregister(self._key)

    def handle(self, op: str, payload: dict) -> dict:
        if op == "submit":
            return self._handle_submit(payload)
        if op == "job":
            return self._handle_job(payload)
        raise ValueError(f"unknown router op {op!r}")

    def _handle_submit(self, doc: dict) -> dict:
        tenant = doc.get("tenant") or "tenant0"
        credential = doc.get("credential")
        if os.environ.get(constants.METRICS_TOKEN_ENV) and not credential:
            raise ServiceAuthError(
                "the routed submit surface requires a credential when "
                f"{constants.METRICS_TOKEN_ENV} is set (the master token, or "
                "tenant_token(master, tenant))")
        # authenticate before touching any service state: an invalid wire
        # caller must not install recover values (or spend scenario_builder
        # work) on its way to the 403
        self.service._check_credential(tenant, credential)
        job_id = doc.get("job_id")
        recover = doc.get("recover")
        if recover is not None:
            if not job_id:
                raise ValueError("a recover payload requires the original job_id")
            values = {tuple(int(i) for i in s): float(v)
                      for s, v in (recover.get("values") or [])}
            # re-adopting an identical seed on a routing retry is
            # idempotent inside adopt_recovered; a differing seed for a
            # known job raises (400 on the wire), never kept silently
            self.service.adopt_recovered(
                job_id, tenant=tenant, method=doc.get("method"),
                partners_count=recover.get("partners_count"), values=values)
        scenario = self.scenario_builder(doc.get("spec") or {})
        job = self.service.submit(
            scenario, method=doc.get("method") or "Shapley values", tenant=tenant,
            deadline_sec=doc.get("deadline_sec"), job_id=job_id,
            priority=doc.get("priority"), credential=credential)
        return {"job": job.job_id, "tenant": job.tenant}

    def _handle_job(self, payload: dict) -> dict:
        job_id = payload["job"]
        job = self.service._jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        return _job_doc(job)
