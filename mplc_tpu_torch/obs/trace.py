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

Nesting is per thread (a thread-local span stack): `parent` is the
innermost span open on the same thread when the span started. File writes
hold a module lock, so threads interleave whole lines, never parts.

Every closed span and event also lands in a bounded in-memory ring
(`MPLC_TORCH_FLIGHT_RECORDER_SIZE` records, default 512), sink or not; the
flight recorder (`obs/flight.py`) dumps it with a metrics snapshot.

The JSONL sink is flushed and closed by an `atexit` hook, so a normal exit
never tears the last line (a hard kill can; `obs/chrome_trace.py` tolerates
it). The same hook converts the trace to Chrome trace-event JSON when
`MPLC_TORCH_CHROME_TRACE_FILE` names an output path.

The JAX package also stamps each record with a fleet run and shard id; the
port has no fleet yet (ROADMAP.md, queue 1 item 10).
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import threading
import time

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


# Every literal name passed to span()/start_span()/event() in the port and
# in chip_smoke.py, and no other (tests/test_torch_obs.py scans for both).
# Each key is also a key of the JAX package's registry, so one
# `obs.report.sweep_report` reads either package's records.
SPAN_REGISTRY = {
    "engine.evaluate": "one evaluate() call of the engine or of the "
                       "reconstruction evaluator (attrs: requested/missing, "
                       "method; mode=reconstruct for the evaluator)",
    "engine.prep": "whole-call host-side batch construction",
    "engine.dispatch": "the work of one coalition batch up to its first "
                       "host read",
    "engine.harvest": "the host read of one batch's results (the batch's "
                      "one sync)",
    "engine.batch": "per-batch accounting event (dispatch start to "
                    "harvest end; attrs: ordinal/width/slot_count/"
                    "coalitions/padding/epochs/samples/partner_passes)",
    "engine.hbm": "per-evaluate device-memory snapshot (attrs: "
                  "param_bytes/slot_count/per_coalition_bytes/"
                  "fixed_bytes/caps/hbm_bytes_limit/peak_in_use_bytes)",
    "engine.retry": "transient failure retried (attrs: site/attempt/"
                    "ordinal/backoff_sec/error)",
    "engine.degrade": "OOM ladder rung taken (action=halve_cap/"
                      "cpu_fallback/ladder_exhausted, halvings)",
    "engine.fault": "injected fault fired (MPLC_TORCH_FAULT_PLAN; attrs: "
                    "kind/site/ordinal)",
    "engine.device_fence": "sampled device fence: a batch's device seconds "
                           "between CUDA events recorded before its "
                           "dispatch and after its last queued work (attrs: "
                           "ordinal/width/slot_count/coalitions/interval)",
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
    "flight.dump": "flight-recorder postmortem written (attrs: reason/"
                   "path/records)",
}


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
                 "_closed")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        st = _stack()
        self.parent = st[-1].id if st else None
        st.append(self)
        self.ts = time.time()
        self.duration = None
        self._closed = False
        self._t0 = time.perf_counter()

    def _pop(self) -> None:
        st = _stack()
        # pop up to and including self: a caller that leaked an inner span
        # must not corrupt the nesting of what follows
        while st:
            if st.pop() is self:
                break

    def end(self) -> "Span":
        if self._closed:
            return self
        self.duration = time.perf_counter() - self._t0
        self._closed = True
        self._pop()
        _emit({"name": self.name, "id": self.id, "parent": self.parent,
               "ts": self.ts, "dur": self.duration,
               "thread": threading.get_ident(), "attrs": self.attrs})
        return self

    def cancel(self) -> None:
        """Close without emitting (the duration is still recorded)."""
        if self._closed:
            return
        self.duration = time.perf_counter() - self._t0
        self._closed = True
        self._pop()

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
    span's does: events are emitted after the work they time."""
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
        with _lock:
            try:
                _collectors.remove(self.records)
            except ValueError:
                pass
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
