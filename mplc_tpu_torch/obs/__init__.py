"""Observability of the port: structured tracing (`trace`), a process-global
metrics registry (`metrics`), sweep reports (`report`), Chrome-trace
conversion (`chrome_trace`), the crash flight recorder (`flight`) and a
summary of `torch.profiler` device traces (`analyze_trace`); beside them
device cost (`devcost`: fences, FLOP counts, the device-seconds meter),
the numerics plane (`numerics`: the value ledger, drift diffs, the
reduction audit) and the measurement scripts.

`trace`, `metrics`, `report`, `chrome_trace` and `flight` need nothing
beyond the stdlib and add no device sync to the paths they instrument.
Tracing writes JSONL when `MPLC_TORCH_TRACE_FILE` is set (a bounded
in-memory ring for the flight recorder is always on); `report.sweep_report`
turns collected records into the prep/dispatch/harvest split, the memo hit
rate, padding waste and per-bucket throughput. The JAX package's live
endpoints (`obs/export.py`) come with the port's fleet (ROADMAP.md).
"""

from . import chrome_trace, flight, metrics, report, trace
from .report import format_report, sweep_report, write_report
from .trace import collect, event, span, start_span

__all__ = ["chrome_trace", "flight", "metrics", "report", "trace", "span",
           "start_span", "event", "collect", "sweep_report",
           "format_report", "write_report"]
