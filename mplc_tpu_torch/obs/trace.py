"""Structured tracing with no dependency beyond the stdlib (port of
`mplc_tpu/obs/trace.py`): spans with monotonic timing, nesting and an
optional JSONL sink.

The port's hot paths are instrumented with

    with span("engine.dispatch", width=b, slot_count=k):
        ...

A span always measures its duration (two `perf_counter` calls and a push
and pop on a thread-local list: no device sync), but it emits a record only
when a sink is active:

  - the JSONL file named by `MPLC_TORCH_TRACE_FILE` (read when a span ends,
    so a process can switch it at run time), or
  - an in-memory collector opened with `collect()` (how `obs.report` and
    `chip_smoke.py` gather a run's spans without touching the disk).

With neither, the instrumentation costs the timing and one dict for the
flight ring, and nothing else: no serialization, no I/O.

Record schema (one JSON object a line):

    {"name": str, "id": int, "parent": int | null, "ts": float (epoch s),
     "dur": float (s), "thread": int, "attrs": {...}}

One clock, and host time only:
  - a record's `ts` is `time.time()` at its start (an event's is
    backdated by its `dur`): the clock a device trace is aligned to by a
    marker op launched at a known `time.time()` (the benchmark's
    `devtrace.py`), so a device idle gap is named by the span open then;
  - a record with `dur > 0` is a host interval. Device seconds never pose
    as one: the sampled fence is a point event (`dur` 0) at its batch's
    harvest carrying them as `device_sec`.

Nesting is per thread (a thread-local span stack): `parent` is the
innermost span open on the same thread when the span started. File writes
hold a module lock, so threads interleave whole lines, never parts.

Set-up seconds: a span named in `SECONDS_COUNTERS` adds its duration to
that counter of `obs/metrics.py` when it ends, unless a span enclosing it
feeds the same counter (whose seconds already hold it).

Profiler mirroring: while the program's own profiler is open
(`utils.profile_trace`, which calls `set_profiler_mirror`), every span
also opens a `torch.profiler.record_function` of its name, so the
profiler's Chrome trace holds the spans on the device trace's clock.
Off, that costs one bool check a span.

Every closed span and event also lands in a bounded in-memory ring
(`MPLC_TORCH_FLIGHT_RECORDER_SIZE` records, default 512), sink or not; the
flight recorder (`obs/flight.py`) dumps it with a metrics snapshot.

The JSONL sink is flushed and closed by an `atexit` hook, so a normal exit
never tears the last line (a hard kill can; `obs/chrome_trace.py` tolerates
it). The same hook converts the trace to Chrome trace-event JSON when
`MPLC_TORCH_CHROME_TRACE_FILE` names an output path.

Fleet trace context: while `MPLC_TORCH_FLEET_RUN_ID` is set, every record
carries it as `fleet_run`, and `MPLC_TORCH_FLEET_SHARD_ID`, when set too, as
`fleet_shard` (parallel/fleet.py sets both in each shard's environment).
Both are read a record, so the in-process fleet path's environment overlay
stamps its shards' records correctly; `obs/fleet_view.merge_fleet_traces`
correlates the W shard streams of one run by them.
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import threading
import time

from . import metrics

_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
# (path, file) of the open JSONL sink, reopened when the env var changes
# between spans. Guarded by _lock.
_sink_state: dict = {"path": None, "file": None}
# active in-memory collectors (lists _emit appends to). Guarded by _lock.
_collectors: list[list] = []

TRACE_FILE_ENV = "MPLC_TORCH_TRACE_FILE"
CHROME_TRACE_FILE_ENV = "MPLC_TORCH_CHROME_TRACE_FILE"
FLIGHT_SIZE_ENV = "MPLC_TORCH_FLIGHT_RECORDER_SIZE"
# the fleet trace context (constants.FLEET_RUN_ID_ENV, FLEET_SHARD_ID_ENV)
FLEET_RUN_ID_ENV = "MPLC_TORCH_FLEET_RUN_ID"
FLEET_TRACE_SHARD_ENV = "MPLC_TORCH_FLEET_SHARD_ID"


# Every literal name passed to span()/start_span()/event() in the port and
# in chip_smoke.py, and no other (tests/test_torch_obs.py scans for both).
# Each key outside `PORT_SPANS` is also a key of the JAX package's
# registry, so one `obs.report.sweep_report` reads either package's
# records; it ignores the port-only names.
SPAN_REGISTRY = {
    "engine.evaluate": "one evaluate() call of the engine or of the "
                       "reconstruction evaluator (attrs: requested/missing, "
                       "method; mode=reconstruct for the evaluator)",
    "engine.prep": "whole-call host-side batch construction",
    "engine.dispatch": "the work of one coalition batch up to its first "
                       "host read",
    "engine.harvest": "the host read of one batch's results (the batch's "
                      "one sync)",
    "engine.batch": "per-batch accounting event (batch start to the end of "
                    "its bookkeeping; attrs: ordinal/width/slot_count/"
                    "coalitions/padding/epochs/samples/partner_passes; a "
                    "trained batch also seconds/lead_s/record_s/grad_calls/"
                    "grad_call_host_s/models_called/models_padded)",
    "engine.hbm": "per-evaluate device-memory snapshot (attrs: "
                  "param_bytes/slot_count/per_coalition_bytes/"
                  "fixed_bytes/caps/hbm_bytes_limit/peak_in_use_bytes)",
    "engine.retry": "transient failure retried (attrs: site/attempt/"
                    "ordinal/backoff_sec/error)",
    "engine.degrade": "OOM ladder rung taken (action=halve_cap/"
                      "cpu_fallback/ladder_exhausted, halvings)",
    "engine.fault": "injected fault fired (MPLC_TORCH_FAULT_PLAN; attrs: "
                    "kind/site/ordinal)",
    "engine.device_fence": "sampled device fence: a point event (dur 0) at "
                           "the batch's harvest carrying its device seconds "
                           "between CUDA events recorded before its "
                           "dispatch and after its last queued work (attrs: "
                           "device_sec/ordinal/width/slot_count/coalitions/"
                           "interval)",
    "numerics.audit": "reduction audit of one coalition (attrs: subset/"
                      "rounds/executed/max_ulp/first_round/first_leaf/"
                      "reduction_mode)",
    "numerics.drift": "the executed partner reduction diverged from the "
                      "left-to-right fold (attrs: subset/round/leaf/"
                      "executed/max_ulp); also a flight dump",
    "numerics.ledger": "value ledger saved (attrs: path/entries/"
                       "reduction_mode)",
    "trainer.compile": "nvcc build of one CUDA source (fn: the source's "
                       "name; dur: the compiler's seconds)",
    "recon.record": "grand-coalition recording run (retrain-free)",
    "contributivity": "one estimator method end to end",
    "contrib.trust": "trust row (CIs + rank stability)",
    "contrib.plan": "the planner resolved method='auto' (attrs: "
                    "QueryPlan.describe())",
    "mpl.fit": "one multi-partner fit",
    "live.plan": "the planner resolved method='auto' for a live query "
                 "(attrs: tenant + QueryPlan.describe())",
    "live.query": "one live contributivity query (attrs: tenant/method/"
                  "rounds/stamp/prune_tau/memo_hit/evaluations/pruned)",
    "live.append": "one aggregation round appended to a resident live "
                   "game (attrs: tenant/seq/stamp/invalidating)",
    "live.recover": "journal-restored live game (attrs: tenant/rounds/"
                    "stamp)",
    "live.evict": "live game's round stack LRU-evicted to a WAL-backed "
                  "stub (attrs: tenant/rounds/stamp)",
    "live.restore": "evicted live game restored from its WAL on touch "
                    "(attrs: tenant/rounds/stamp/restore_s)",
    "live.ingest": "one wire round accepted via POST /live/<tenant>/"
                   "round (attrs: tenant/stamp/rounds)",
    "service.submit": "job accepted onto the service queue",
    "service.reject": "admission refused (backpressure or fault plan)",
    "service.slice": "one scheduling quantum of one job (attrs: tenant/job/"
                     "batches/coalitions/epochs/samples/packed_batches/"
                     "device_sec/device_basis)",
    "service.stall": "injected scheduler stall (service fault plan)",
    "service.shed": "job shed by the overload admission governor "
                    "(attrs: priority/queue_wait_p99_sec/retry_after_sec)",
    "service.job": "terminal job event (attrs incl. SLO: queue_wait_sec/"
                   "ttfv_sec/deadline_missed)",
    "service.job_fault": "one failed job attempt (pre retry/quarantine)",
    "service.recover": "journal-seeded job recovery",
    "service.journal_broken": "WAL append failure (journaling disabled)",
    "service.auth_reject": "submit-path credential check failed (attrs: "
                           "tenant): a synchronous auth error, never a "
                           "quarantine",
    "router.submit": "one job routed end to end by the fleet router "
                     "(attrs: tenant/job/shard/attempts/route_s)",
    "router.redirect": "one overload or shed redirect followed (attrs: "
                       "tenant/job/from/to/attempt/retry_after_sec)",
    "router.repin": "a tenant's sticky shard pin deliberately broken "
                    "(attrs: tenant/from/to/reason=death|overload)",
    "router.failover": "a dead shard drained from the routing table and "
                       "its journaled incomplete jobs resubmitted "
                       "(attrs: shard/jobs/resubmitted)",
    "router.exhausted": "a job's routing budget ran out: the failure "
                        "surfaced classified as RoutedJobFailed (attrs: "
                        "tenant/job/attempts/budget)",
    "router.fault": "a router fault-plan entry fired (attrs: kind/shard/"
                    "at_sec)",
    "fleet.sweep": "one coordinated fleet sweep: start the shards, then "
                   "merge (attrs: shards/inproc/devices_per_shard)",
    "fleet.shard": "one fleet shard completed (attrs: shard/shards/"
                   "wallclock_s/coalitions)",
    "fleet.merge": "per-shard ledgers/memos merged into one sweep "
                   "(attrs: shards/coalitions/verified/wallclock_s)",
    "fleet.shard_run": "root span of one fleet worker's shard execution "
                       "(attrs: shard/shards/run), the flow-link target "
                       "of the coordinator's fleet.shard event in the "
                       "merged Perfetto timeline",
    "fleet.incident": "fleet incident bundle written on a shard failure or "
                      "a merge refusal (attrs: run/reason/failed_shards/"
                      "path)",
    "fleet.collect": "one FleetCollector pass assembling the cluster "
                     "snapshot (attrs: sources)",
    "fleet.scrape": "one shard read (HTTP /varz, published state or a "
                    "result file) by the fleet collector (attrs: shard/"
                    "source/ok)",
    "flight.dump": "flight-recorder postmortem written (attrs: reason/"
                   "path/records)",
    # the port's own names (PORT_SPANS): the batch path's leaf spans and
    # set-up's spans
    "trainer.init": "a batch's initial parameters drawn on the host from "
                    "each coalition's generator and uploaded "
                    "(`MplTrainer.init_state`)",
    "trainer.draws": "one epoch's random streams drawn on the host and "
                     "uploaded (`MplTrainer._draws`)",
    "trainer.minibatch": "one minibatch enqueued (a FedAvg aggregation round; "
                         "attrs: mb/grad_calls)",
    "trainer.finalize": "the test evaluation of a batch's models enqueued",
    "trainer.sync": "a host read of a device tensor inside a dispatch (attrs: "
                    "what)",
    "engine.flops": "a batch's logged calls counted (`call_flops`; a shape's "
                    "first count runs on meta tensors)",
    "engine.record": "the engine's bookkeeping: a batch's from its harvest to "
                     "its engine.batch event (phase=batch), the work after "
                     "that event (phase=after), an evaluate call's tail "
                     "(phase=evaluate)",
    "engine.progress": "the progress hook (the caller's code) after a batch",
    "engine.stage": "the scenario's data staged on the engine's device "
                    "(stacked partners, val and test sets)",
    "recon.reconstruct": "a batch of coalition models reconstructed (flatten "
                         "and K1 enqueued)",
    "recon.evaluate": "a batch of reconstructed models' test evaluation "
                      "enqueued (`evaluate_models`)",
    "data.prepare": "a Dataset built (its global train/val split)",
    "scenario.prepare": "one step of a Scenario's preparation (attrs: step = "
                        "init/partners/split/batch_sizes/corrupt)",
    "kernels.load": "a CUDA source's library loaded, built first by nvcc when "
                    "the build folder lacks it (attrs: source)",
}

# the names of SPAN_REGISTRY the JAX package lacks
PORT_SPANS = frozenset({
    "trainer.init", "trainer.draws", "trainer.minibatch", "trainer.finalize",
    "trainer.sync", "engine.flops", "engine.record", "engine.progress",
    "engine.stage", "recon.reconstruct", "recon.evaluate", "data.prepare",
    "scenario.prepare", "kernels.load"})

# span name -> the counter its seconds feed (module docstring)
SECONDS_COUNTERS = {
    "data.prepare": "scenario.prepare_seconds_total",
    "scenario.prepare": "scenario.prepare_seconds_total",
    "engine.stage": "engine.stage_seconds_total",
    "kernels.load": "kernels.load_seconds_total",
    "recon.record": "recon.record_seconds_total",
}

# set by `utils.profile_trace` while its profiler is open
_profiler_mirror = False


def set_profiler_mirror(on: bool) -> bool:
    """Mirror every span opened from now on as a `torch.profiler`
    `record_function` (on) or not; returns the previous setting."""
    global _profiler_mirror
    prev, _profiler_mirror = _profiler_mirror, bool(on)
    return prev


def _flight_size() -> int:
    raw = os.environ.get(FLIGHT_SIZE_ENV)
    if raw:
        try:
            n = int(raw)
            if n > 0:
                return n
        except ValueError:
            pass
        import warnings
        warnings.warn(f"{FLIGHT_SIZE_ENV}={raw!r} is not a positive "
                      "integer; using 512", stacklevel=2)
    return 512


# Always-on bounded ring of recent records for the flight recorder, sized
# once at import (process-global state, like the ids).
_flight_ring: collections.deque = collections.deque(maxlen=_flight_size())


def flight_records() -> list:
    """The flight ring's current contents, oldest first."""
    return list(_flight_ring)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _sink_file():
    """The open JSONL sink, or None; reopened when the env var changed.
    A path that cannot be opened gives one warning, never an exception in
    the instrumented path (the path stays recorded, so the open is not
    retried on every span). After the atexit close the sink stays closed:
    a daemon thread emitting during shutdown must not reopen the file the
    exit hook just finished."""
    if _sink_state.get("closed"):
        return None
    path = os.environ.get(TRACE_FILE_ENV) or None
    if path == _sink_state["path"]:
        return _sink_state["file"]
    with _lock:
        if path != _sink_state["path"]:
            if _sink_state["file"] is not None:
                try:
                    _sink_state["file"].close()
                except OSError:
                    pass
            _sink_state["path"] = path
            _sink_state["file"] = None
            if path:
                try:
                    _sink_state["file"] = open(path, "a")
                except OSError as e:
                    import warnings
                    warnings.warn(f"{TRACE_FILE_ENV}={path!r} could not be "
                                  f"opened ({e}); tracing to file disabled")
    return _sink_state["file"]


def _emit(record: dict) -> None:
    # the fleet trace context, read a record (the in-process fleet path
    # sets it through an environment overlay)
    run = os.environ.get(FLEET_RUN_ID_ENV)
    if run:
        record["fleet_run"] = run
        shard = os.environ.get(FLEET_TRACE_SHARD_ENV)
        if shard:
            record["fleet_shard"] = shard
    # the flight ring sees every record, sink or not (deque.append is
    # atomic; maxlen bounds it)
    _flight_ring.append(record)
    f = _sink_file()
    if f is None and not _collectors:
        return
    with _lock:
        for c in _collectors:
            c.append(record)
        if f is not None:
            try:
                f.write(json.dumps(record) + "\n")
                f.flush()
            except ValueError:
                # emitted after the atexit hook closed the sink: the ring
                # has the record, the file write is dropped
                _sink_state["file"] = None


class Span:
    """One timed region. Use as a context manager, or through `start_span`
    with an explicit `end()` (regions with early returns) or `cancel()`
    (close without emitting). `duration` is set once closed."""

    __slots__ = ("name", "attrs", "id", "parent", "ts", "_t0", "duration",
                 "_closed", "_mirror")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        st = _stack()
        self.parent = st[-1].id if st else None
        st.append(self)
        self._mirror = None
        if _profiler_mirror:
            from torch.profiler import record_function
            self._mirror = record_function(name)
            self._mirror.__enter__()
        self.ts = time.time()
        self.duration = None
        self._closed = False
        self._t0 = time.perf_counter()

    def _close(self) -> None:
        self.duration = time.perf_counter() - self._t0
        self._closed = True
        if self._mirror is not None:
            self._mirror.__exit__(None, None, None)
        st = _stack()
        # pop up to and including self: a caller that leaked an inner span
        # must not corrupt the nesting of what follows
        while st:
            if st.pop() is self:
                break

    def end(self) -> "Span":
        if self._closed:
            return self
        self._close()
        counter = SECONDS_COUNTERS.get(self.name)
        if counter is not None and not any(SECONDS_COUNTERS.get(s.name) == counter
                                           for s in _stack()):
            metrics.counter(counter).inc(self.duration)
        _emit({"name": self.name, "id": self.id, "parent": self.parent,
               "ts": self.ts, "dur": self.duration,
               "thread": threading.get_ident(), "attrs": self.attrs})
        return self

    def cancel(self) -> None:
        """Close without emitting (the duration is still recorded)."""
        if not self._closed:
            self._close()

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


def span(name: str, **attrs) -> Span:
    """Context manager: `with span("engine.dispatch", width=16): ...`"""
    return Span(name, attrs)


def start_span(name: str, **attrs) -> Span:
    """A span for a region that outlives one block; pair it with `.end()`
    or `.cancel()`."""
    return Span(name, attrs)


def active_span(name: str) -> "Span | None":
    """The innermost open span named `name` on this thread, or None: how
    the engine attributes its memo counters to the estimator method of
    the enclosing `contributivity` span."""
    for sp in reversed(_stack()):
        if sp.name == name:
            return sp
    return None


def event(name: str, dur: float = 0.0, **attrs) -> None:
    """Emit a point-in-time or externally timed record without opening a
    span (a build whose seconds the caller measured, a batch's accounting).

    `ts` is backdated by `dur`, so it marks the interval's start as a
    span's does: events are emitted after the work they time. `dur` is
    host seconds (module docstring); device seconds ride an attribute."""
    st = _stack()
    _emit({"name": name, "id": next(_ids),
           "parent": st[-1].id if st else None,
           "ts": time.time() - float(dur), "dur": float(dur),
           "thread": threading.get_ident(), "attrs": attrs})


class collect:
    """Context manager capturing every record emitted while it is open:

        with collect() as records:
            ...
        report = sweep_report(records)

    Works with or without the JSONL sink; collectors nest (each sees every
    record emitted while it is open)."""

    def __enter__(self) -> list:
        self.records: list = []
        with _lock:
            _collectors.append(self.records)
        return self.records

    def __exit__(self, *exc) -> bool:
        # removed by identity: two nested collectors hold equal lists (both
        # saw the same records), and `list.remove` would take the outer one
        with _lock:
            for i, c in enumerate(_collectors):
                if c is self.records:
                    del _collectors[i]
                    break
        return False


@atexit.register
def _close_sink_at_exit() -> None:
    """Flush and close the JSONL sink at interpreter exit, so the last
    record is a whole line; with `MPLC_TORCH_CHROME_TRACE_FILE` set beside
    the trace file, convert the finished JSONL to Chrome trace-event JSON
    (what `python3 -m mplc_tpu_torch.obs.chrome_trace` does by hand)."""
    with _lock:
        f, _sink_state["file"] = _sink_state["file"], None
        _sink_state["path"] = None
        _sink_state["closed"] = True  # _sink_file stays None from here on
    if f is not None:
        try:
            f.flush()
            f.close()
        except (OSError, ValueError):
            pass
    src = os.environ.get(TRACE_FILE_ENV)
    out = os.environ.get(CHROME_TRACE_FILE_ENV)
    if src and out and os.path.exists(src):
        try:
            from .chrome_trace import convert
            convert(src, out)
        except Exception as e:  # telemetry never breaks the exit
            import warnings
            warnings.warn(f"Chrome-trace export to {out!r} failed: {e}")
