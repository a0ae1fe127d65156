"""Device cost: sampled device fences, FLOP counts and the device-seconds
meter (port of `mplc_tpu/obs/devcost.py`).

The spans of the rest of the observability plane time the host: a dispatch
span times the enqueue, an `engine.batch` event dispatch start to harvest
end. This module gives the engine three device-side measures:

  1. **Sampled device fences**: `fence_interval()` reads
     `MPLC_TORCH_DEVICE_FENCE_RATE` (default 1/16; 0 is off) into a
     batch-ordinal stride, and `should_fence(ordinal, interval)` decides
     from the ordinal alone, so a replayed run fences the same batches. The
     engine times a fenced batch with CUDA events recorded before its
     dispatch and after its harvest (`engine.device_step_sec`,
     `engine.device_fence`). A fence never changes v(S): it only records
     two events on the stream.

  2. **FLOP counts**: XLA's `cost_analysis` has no torch counterpart. A
     batch's trainer logs the shape of each gradient and forward call it
     makes (`MplTrainer.call_log`), and each distinct shape is counted
     once a process by `torch.utils.flop_counter.FlopCounterMode`
     (`count_flops`) on meta tensors, one model's call times the models
     (`mpl/engine.py` `call_flops`). Counting adds no device work and no
     operation to the batch, so it changes no value and needs no fence of
     its own; every retraining batch carries its count. Without a counter
     (a torch without `torch.utils.flop_counter`) the count is None and
     the report keeps its analytic proxy.

  3. **Device-seconds metering**: `DeviceMeter` sums an engine's batches
     (coalitions, host span, fenced seconds, FLOPs), and
     `estimate_device_seconds(delta, peak)` turns a snapshot or a delta
     of it into device seconds with a basis, in the JAX package's trust
     order: "fenced", "cost_model", "host_span", "none".

The peak tables hold the H100 SXM's published figures (`PERF.md` section
3): bf16 989, TF32 494.7 and fp32 67 TFLOP/s on dense operands, 3.35 TB/s.
Any other device, the CPU included, has None, and every figure derived from
a peak is then "n/a".
"""

from __future__ import annotations

import threading

from .. import constants

# about one batch in 16: one extra pair of events a 16 batches, and a
# short sweep still gets a sample (ordinal 1 is always fenced when on)
DEFAULT_FENCE_RATE = 1.0 / 16.0

# Published dense peaks of the cards the port measures on, by a substring
# of `torch.cuda.get_device_name`: FLOP/s by operand type, memory bytes/s.
# The H100 SXM is named "NVIDIA H100 80GB HBM3" (or "... SXM"); its PCIe
# and NVL parts have other peaks and are not listed.
_PEAK_FLOPS = {
    "H100 80GB HBM3": {"bf16": 989e12, "tf32": 494.7e12, "fp32": 67e12},
    "H100 SXM": {"bf16": 989e12, "tf32": 494.7e12, "fp32": 67e12},
}
_MEMORY_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12, "H100 SXM": 3.35e12}


# -- sampled device fences ----------------------------------------------------

def fence_interval(rate: "float | None" = None) -> int:
    """The batch-ordinal stride of the fence sampler: 0 is off, else every
    `interval`-th batch (ordinal 1 included) runs fenced. `rate` defaults
    to MPLC_TORCH_DEVICE_FENCE_RATE (a malformed value warns and falls
    back); rates above 1 fence every batch."""
    if rate is None:
        rate = constants._env_nonneg_float(constants.DEVICE_FENCE_RATE_ENV,
                                           DEFAULT_FENCE_RATE)
    if rate <= 0:
        return 0
    return max(1, int(round(1.0 / min(rate, 1.0))))


def should_fence(ordinal: int, interval: int) -> bool:
    """Whether 1-based batch `ordinal` is a fence sample: a function of
    (ordinal, interval) alone, so retries and recoveries fence the same
    ordinals; ordinal 1 is a sample whenever fencing is on."""
    return bool(interval) and ordinal % interval == 1 % interval


# -- FLOP counts --------------------------------------------------------------

def count_flops(fn):
    """(fn(), the FLOPs `fn` ran, or None where this torch has no
    `torch.utils.flop_counter`): `fn` run under `FlopCounterMode`, which
    counts the matrix products and convolutions (forward and backward) it
    dispatches and runs each as it is. An error of `fn` propagates."""
    try:
        from torch.utils.flop_counter import FlopCounterMode
    except ImportError:
        return fn(), None
    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, float(counter.get_total_flops())


# -- peak tables --------------------------------------------------------------

def _lookup(table: dict, device_kind: str):
    kind = device_kind or ""
    for k, v in table.items():
        if k in kind:
            return v
    return None


def peak_flops_per_chip(device_kind: str, dtype: str = "bf16") -> "float | None":
    """The dense peak FLOP/s of one card named `device_kind` for operands
    of `dtype` ("bf16", "tf32" or "fp32"); None for a card not in the table
    and for the CPU (no peak, no utilization)."""
    peaks = _lookup(_PEAK_FLOPS, device_kind)
    return None if peaks is None else peaks.get(dtype)


def hbm_bytes_per_s_per_chip(device_kind: str) -> "float | None":
    """The device-memory bandwidth (bytes/s) of one card, or None."""
    return _lookup(_MEMORY_BYTES_PER_S, device_kind)


# -- the device-seconds meter -------------------------------------------------

_METER_FIELDS = ("batches", "coalitions", "span_sec", "fenced_batches",
                 "fenced_coalitions", "fenced_sec", "flops",
                 "bytes_accessed", "costed_coalitions",
                 "eval_coalitions", "eval_span_sec",
                 "degraded_coalitions", "degraded_span_sec")
_FLOAT_FIELDS = ("span_sec", "fenced_sec", "flops", "bytes_accessed",
                 "eval_span_sec", "degraded_span_sec")

# the bases, most trusted first
_BASIS_RANK = ("fenced", "cost_model", "host_span", "none")


class DeviceMeter:
    """An engine's device-time accounting: every harvested batch notes its
    coalitions and host span, a fenced batch its measured device seconds,
    a counted one its FLOPs. Thread-safe."""

    __slots__ = ("interval", "_lock") + _METER_FIELDS

    def __init__(self, interval: int = 0):
        self.interval = interval
        self._lock = threading.Lock()
        for f in _METER_FIELDS:
            setattr(self, f, 0.0 if f in _FLOAT_FIELDS else 0)

    def note(self, coalitions: int, span_sec: float = 0.0,
             device_sec: "float | None" = None,
             flops: "float | None" = None,
             bytes_accessed: "float | None" = None,
             eval_only: bool = False, degraded: bool = False) -> None:
        """One harvested batch (padding rows not counted). `eval_only`
        marks reconstruction batches and `degraded` a CPU rung's: each
        class bills at its own host span and never enters the fenced
        training rate."""
        with self._lock:
            self.batches += 1
            self.coalitions += int(coalitions)
            self.span_sec += float(span_sec)
            if eval_only:
                self.eval_coalitions += int(coalitions)
                self.eval_span_sec += float(span_sec)
            elif degraded:
                self.degraded_coalitions += int(coalitions)
                self.degraded_span_sec += float(span_sec)
            if device_sec is not None:
                self.fenced_batches += 1
                self.fenced_coalitions += int(coalitions)
                self.fenced_sec += float(device_sec)
            if flops:
                self.flops += float(flops)
                self.bytes_accessed += float(bytes_accessed or 0.0)
                self.costed_coalitions += int(coalitions)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in _METER_FIELDS}

    def device_seconds(self, peak_flops: "float | None" = None
                       ) -> "tuple[float, str]":
        """Lifetime (seconds, basis): `estimate_device_seconds`."""
        return estimate_device_seconds(self.snapshot(), peak_flops)


def meter_delta(before: dict, after: dict) -> dict:
    """Field by field `after - before` of two meter snapshots."""
    return {f: after.get(f, 0) - before.get(f, 0) for f in _METER_FIELDS}


def estimate_device_seconds(totals: dict,
                            peak_flops: "float | None" = None
                            ) -> "tuple[float, str]":
    """(device seconds, basis) of a meter snapshot or delta. The bases,
    most trusted first:

      "fenced":     the fenced seconds a coalition times the training
                    coalitions; eval-only and CPU-degraded coalitions are
                    billed at their own host span;
      "cost_model": the counted FLOPs (scaled to the uncounted training
                    coalitions) over `peak_flops`, a lower bound, where
                    nothing was fenced and a peak is known;
      "host_span":  the batches' summed host spans;
      "none":       no signal, 0.0 seconds.
    """
    coalitions = totals.get("coalitions", 0)
    eval_c = totals.get("eval_coalitions", 0)
    deg_c = totals.get("degraded_coalitions", 0)
    extra = (totals.get("eval_span_sec", 0.0)
             + totals.get("degraded_span_sec", 0.0))
    train_c = coalitions - eval_c - deg_c
    fenced_c = totals.get("fenced_coalitions", 0)
    if fenced_c > 0 and train_c > 0:
        per = totals.get("fenced_sec", 0.0) / fenced_c
        return per * train_c + extra, "fenced"
    flops = totals.get("flops", 0.0)
    costed_c = totals.get("costed_coalitions", 0)
    if flops > 0 and peak_flops:
        scale = (train_c / costed_c) if costed_c and train_c > 0 else 1.0
        return flops * scale / peak_flops + extra, "cost_model"
    span = totals.get("span_sec", 0.0)
    if span > 0:
        return span, "host_span"
    return 0.0, "none"


def merge_basis(a: "str | None", b: "str | None") -> "str | None":
    """The more trusted of two bases (None stands for no basis)."""
    if a is None:
        return b
    if b is None:
        return a
    return a if _BASIS_RANK.index(a) <= _BASIS_RANK.index(b) else b
