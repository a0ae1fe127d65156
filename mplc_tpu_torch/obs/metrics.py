"""Process-global metrics registry: counters, gauges, histograms (port of
`mplc_tpu/obs/metrics.py`).

`obs/trace.py` says when; this module says how much: build seconds,
coalitions evaluated, memo hits and misses, padding waste, epochs trained,
the device-memory high water. All of it is host-side arithmetic:
incrementing a counter never syncs the device.

A metric may carry labels (`counter("service.queue_wait_sec",
tenant="t0")`): each distinct (name, labels) pair is its own metric,
keyed `name{k=v,...}` with sorted label keys; an unlabelled metric keeps
its plain `name` key.

Histograms keep count/sum/min/max and fixed log2 bucket counts
(`LOG_BUCKET_BOUNDS`, ~1e-6 .. 4096), so p50/p95/p99 come at read time
(`Histogram.quantile`) and two histograms always merge; a quantile is at
worst one bucket width (2x) off.

Metric names the port's instrumented paths use (the JAX package's names):

    trainer.compiles_total            counter  nvcc builds of a CUDA source
    trainer.compile_seconds_total     counter  seconds nvcc took
    trainer.compiles[<fn>]            counter  builds of one source
    trainer.compile_seconds[<fn>]     counter  seconds of one source
    engine.memo_hits                  counter  v(S) served from the memo
    engine.memo_misses                counter  v(S) needing device work
    engine.memo_hits[<method>]        counter  the same, for one estimator
    engine.memo_misses[<method>]      counter
    engine.coalitions_evaluated       counter  coalitions trained
    engine.null_coalitions            counter  coalitions valued 0 with no
                                               training (every member
                                               dropped from epoch 1)
    engine.reconstructions            counter  coalitions reconstructed
    engine.epochs_trained             counter  coalition-epochs trained
    engine.samples_trained            counter  training samples consumed
    engine.partner_passes             counter  partner passes (epochs x
                                               minibatches x slots or P)
    engine.batches                    counter  device batches harvested
    engine.pad_waste_fraction         histogram per-batch padding share
    engine.device_mem_high_water_bytes gauge   peak bytes allocated on the
                                               engine's CUDA device
    engine.device_step_sec            histogram a fenced batch's device
                                               seconds (obs/devcost.py)
    numerics.ledger_records           counter  v(S) written to the value
                                               ledger
    numerics.audits                   counter  reduction audits run
    numerics.drift_events             counter  audits whose executed
                                               reduction diverged
    obs.memory_sample_errors          counter  sample_device_memory failures
                                               (warned once)
    obs.flight_dumps                  counter  flight-recorder postmortems

and the port's own set-up seconds, each fed by its spans when they end
(`obs/trace.py` `SECONDS_COUNTERS`; absent until such a span ran):

    scenario.prepare_seconds_total    counter  `data.prepare` and
                                               `scenario.prepare` spans
    engine.stage_seconds_total        counter  `engine.stage` spans
    kernels.load_seconds_total        counter  `kernels.load` spans
    recon.record_seconds_total        counter  `recon.record` spans

`snapshot()` exports the registry as a plain dict (JSON-ready); `reset()`
clears it (tests and per-run boundaries); `merge_snapshots()` merges
snapshots of several processes; `export_view()` gives structured rows
(name, labels, kind, values) for a Prometheus renderer.
"""

from __future__ import annotations

import bisect
import math
import threading

_lock = threading.Lock()
_registry: dict = {}

# Fixed log2 bucket upper bounds shared by every histogram: 2^-20
# (~0.95 us) .. 2^12 (4096). Seconds-scale latencies, fractions in [0,1]
# and small counts all land inside; anything larger goes to +Inf.
LOG_BUCKET_BOUNDS = tuple(2.0 ** e for e in range(-20, 13))


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with _lock:
            self.value += v


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = None

    def set(self, v: float) -> None:
        with _lock:
            self.value = v

    def set_max(self, v: float) -> None:
        """High-water-mark update (device_mem_high_water)."""
        with _lock:
            if self.value is None or v > self.value:
                self.value = v


class Histogram:
    """Streaming count/sum/min/max plus fixed log2 bucket counts — enough
    for padding-waste and latency distributions with exportable
    p50/p95/p99, without per-metric bucket-boundary bikeshedding."""

    __slots__ = ("name", "labels", "count", "total", "min", "max",
                 "bucket_counts")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        # one count per LOG_BUCKET_BOUNDS entry, plus the +Inf bucket
        self.bucket_counts = [0] * (len(LOG_BUCKET_BOUNDS) + 1)

    def observe(self, v: float) -> None:
        with _lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            # le-inclusive, Prometheus-style: bucket i counts v <= bound_i
            self.bucket_counts[bisect.bisect_left(LOG_BUCKET_BOUNDS, v)] += 1

    def quantile(self, q: float) -> float | None:
        """Log-bucket quantile estimate: the upper bound of the bucket
        holding the q-th ranked observation, clamped to the observed
        [min, max] (so tight distributions report exact-ish values and
        the +Inf bucket degrades to the observed max). None when empty."""
        with _lock:
            return _locked_quantile(self, q)


def _get(name: str, cls, labels: dict | None = None):
    labels = dict(labels or {})
    key = _key(name, labels)
    m = _registry.get(key)
    if m is None:
        with _lock:
            m = _registry.get(key)
            if m is None:
                m = _registry[key] = cls(name, labels)
    if not isinstance(m, cls):
        raise TypeError(f"metric {key!r} is a {type(m).__name__}, "
                        f"not a {cls.__name__}")
    return m


def counter(name: str, **labels) -> Counter:
    return _get(name, Counter, labels)


def gauge(name: str, **labels) -> Gauge:
    return _get(name, Gauge, labels)


def histogram(name: str, **labels) -> Histogram:
    return _get(name, Histogram, labels)


def snapshot() -> dict:
    """The whole registry as {counters, gauges, histograms} of plain
    numbers — JSON-serializable, suitable for the sweep-report sidecar.
    Labeled metrics appear under their `name{k=v,...}` registry keys;
    histogram entries carry log-bucket p50/p95/p99 estimates."""
    with _lock:
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, m in sorted(_registry.items()):
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = {
                    "count": m.count, "sum": m.total,
                    "min": m.min if m.count else None,
                    "max": m.max if m.count else None,
                    "mean": m.total / m.count if m.count else None,
                    "p50": _locked_quantile(m, 0.50),
                    "p95": _locked_quantile(m, 0.95),
                    "p99": _locked_quantile(m, 0.99),
                    # raw log2 bucket counts (+Inf last): bounds are the
                    # process-wide LOG_BUCKET_BOUNDS constant, so two
                    # snapshots from different processes merge exactly
                    # (merge_snapshots), which needs this field in every
                    # snapshot.
                    "bucket_counts": list(m.bucket_counts),
                }
        return out


def _locked_quantile(m: Histogram, q: float) -> float | None:
    """Histogram.quantile body for callers already holding `_lock`."""
    if not m.count:
        return None
    return bucket_quantile(m.bucket_counts, m.count, m.min, m.max, q)


def bucket_quantile(bucket_counts, count, mn, mx, q: float) -> float | None:
    """Nearest-rank quantile over shared-log2-bucket counts: the upper
    bound of the bucket holding the q-th ranked observation, clamped to
    the observed [min, max]. Pure arithmetic on plain values so merged
    (cross-process) histograms use the EXACT same estimator as live
    Histogram objects — that identity is what makes merged quantiles
    equal pooled-sample quantiles at bucket granularity."""
    if not count:
        return None
    rank = max(1, math.ceil(q * count))
    cum = 0
    for i, c in enumerate(bucket_counts):
        cum += c
        if cum >= rank:
            bound = (LOG_BUCKET_BOUNDS[i]
                     if i < len(LOG_BUCKET_BOUNDS) else mx)
            return min(max(bound, mn), mx)
    return mx


def merge_snapshots(snaps) -> dict:
    """Merge `snapshot()` dicts from multiple processes into one
    snapshot. Semantics per kind:

      counters    summed — totals over the processes.
      gauges      max of non-None values — every exported gauge is a
                  high-water mark (device_mem_high_water_bytes), so the
                  merged value is the worst process's.
      histograms  exact merge: counts/sums/bucket_counts summed,
                  min/max combined. Because every histogram shares
                  LOG_BUCKET_BOUNDS, the merged buckets are identical to
                  a histogram fed the pooled raw samples, so merged
                  p50/p95/p99 EQUAL pooled-sample quantiles (not an
                  approximation on top of an approximation).

    Snapshots missing `bucket_counts` (pre-merge-era producers) degrade
    gracefully: their counts/sums still aggregate, quantiles come from
    whatever buckets are present. Non-dict entries are skipped."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    merged_h: dict = {}
    for snap in snaps or ():
        if not isinstance(snap, dict):
            continue
        for k, v in (snap.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                out["counters"][k] = out["counters"].get(k, 0.0) + v
        for k, v in (snap.get("gauges") or {}).items():
            cur = out["gauges"].get(k)
            if v is None:
                out["gauges"].setdefault(k, None)
            else:
                out["gauges"][k] = v if cur is None else max(cur, v)
        for k, h in (snap.get("histograms") or {}).items():
            if not isinstance(h, dict) or not h.get("count"):
                merged_h.setdefault(
                    k, {"count": 0, "sum": 0.0, "min": math.inf,
                        "max": -math.inf,
                        "bucket_counts": [0] * (len(LOG_BUCKET_BOUNDS) + 1)})
                continue
            acc = merged_h.setdefault(
                k, {"count": 0, "sum": 0.0, "min": math.inf,
                    "max": -math.inf,
                    "bucket_counts": [0] * (len(LOG_BUCKET_BOUNDS) + 1)})
            acc["count"] += int(h.get("count") or 0)
            acc["sum"] += float(h.get("sum") or 0.0)
            if h.get("min") is not None:
                acc["min"] = min(acc["min"], float(h["min"]))
            if h.get("max") is not None:
                acc["max"] = max(acc["max"], float(h["max"]))
            bc = h.get("bucket_counts")
            if isinstance(bc, (list, tuple)):
                for i, c in enumerate(bc[:len(acc["bucket_counts"])]):
                    acc["bucket_counts"][i] += int(c or 0)
    for k, acc in merged_h.items():
        n = acc["count"]
        out["histograms"][k] = {
            "count": n, "sum": acc["sum"],
            "min": acc["min"] if n else None,
            "max": acc["max"] if n else None,
            "mean": acc["sum"] / n if n else None,
            "p50": bucket_quantile(acc["bucket_counts"], n,
                                   acc["min"], acc["max"], 0.50),
            "p95": bucket_quantile(acc["bucket_counts"], n,
                                   acc["min"], acc["max"], 0.95),
            "p99": bucket_quantile(acc["bucket_counts"], n,
                                   acc["min"], acc["max"], 0.99),
            "bucket_counts": acc["bucket_counts"],
        }
    return out


def export_view() -> list:
    """Structured registry rows for a Prometheus renderer (the JAX
    package's obs/export.py): `[{name, labels, kind, ...}]` with histogram rows
    carrying the shared bucket bounds and per-bucket counts."""
    with _lock:
        rows = []
        for key, m in sorted(_registry.items()):
            row = {"name": m.name, "labels": dict(m.labels)}
            if isinstance(m, Counter):
                row.update(kind="counter", value=m.value)
            elif isinstance(m, Gauge):
                row.update(kind="gauge", value=m.value)
            else:
                row.update(kind="histogram", count=m.count, sum=m.total,
                           bounds=LOG_BUCKET_BOUNDS,
                           bucket_counts=list(m.bucket_counts))
            rows.append(row)
        return rows


def reset() -> None:
    with _lock:
        _registry.clear()


_mem_sample_warned = False


def sample_device_memory(gauge_name: str = "engine.device_mem_high_water_bytes",
                         device=None) -> None:
    """Record the peak bytes allocated on `device` (a CUDA device) with
    `torch.cuda.max_memory_allocated`, the caching allocator's own count:
    a host query, no sync. On a CPU device, or with no device, it is a
    silent no-op. A real failure is counted in `obs.memory_sample_errors`
    and warned once a process: memory telemetry that stopped without a
    word leaves an out-of-memory postmortem with no memory data."""
    global _mem_sample_warned
    try:
        import torch
        if device is None or torch.device(device).type != "cuda":
            return
        gauge(gauge_name).set_max(int(torch.cuda.max_memory_allocated(device)))
    except Exception as e:
        counter("obs.memory_sample_errors").inc()
        if not _mem_sample_warned:
            _mem_sample_warned = True
            import warnings
            warnings.warn(
                f"sample_device_memory failed ({e}); further failures are "
                "counted in obs.memory_sample_errors without warning",
                stacklevel=2)
