"""Summarize a `torch.profiler` trace: the device's busy share and its top
kernels (the counterpart of the JAX package's scripts/analyze_trace.py,
which reads XLA xplane files).

    python3 -m mplc_tpu_torch.obs.analyze_trace <profile_dir_or_trace.json> [--top N]

Reads the newest `*.pt.trace.json` under the directory (what
`utils.profile_trace` writes) and reports, for each device stream and for
the whole device:
  - the trace's window (first event start to last event end, any event),
  - the busy time: the union of the stream's event intervals, so kernels
    that overlap are not counted twice,
  - the busy share of the window,
  - the top kernels by accumulated time, with their launch counts.

A trace with CUDA activity counts its kernels, copies and memsets (Kineto's
"kernel", "gpu_memcpy" and "gpu_memset" events; `pid` the device, `tid` the
stream). A CPU-only trace, which has none, counts its `cpu_op` events, a
thread each: there the CPU is the device.

This reads device traces only. For the span-level view (the engine's own
prep/dispatch/harvest records, `MPLC_TORCH_TRACE_FILE`) use
`python3 -m mplc_tpu_torch.obs.chrome_trace`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_SUFFIX = ".pt.trace.json"


def newest_trace(path: str) -> str:
    """`path` itself when it is a file, else the newest `*.pt.trace.json`
    under it; raises FileNotFoundError when there is none."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", f"*{TRACE_SUFFIX}"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {path}")
    return hits[-1]


def _union_us(intervals: list) -> float:
    """Total length of the union of [start, end) intervals."""
    total = 0.0
    cur_start = cur_end = None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def summarize(trace_path: str) -> dict:
    """The trace's summary: {trace, kind ("cuda" or "cpu"), window_us,
    streams: [{stream, events, busy_us, busy_share}], device: {events,
    busy_us, busy_share}, kernels: {name: {us, count}} by time, descending}.
    Times in microseconds, the trace's unit."""
    with open(trace_path) as f:
        doc = json.load(f)
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    kind = "cuda" if device else "cpu"
    if not device:
        device = [e for e in events if e.get("cat") == "cpu_op"]
    if events:
        t0 = min(float(e["ts"]) for e in events)
        t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in events)
        window = t1 - t0
    else:
        window = 0.0

    def share(busy):
        return busy / window if window > 0 else None

    by_stream: dict = {}
    per_name: dict = {}
    for e in device:
        start = float(e["ts"])
        dur = float(e.get("dur", 0.0))
        by_stream.setdefault(f"{e.get('pid')}/{e.get('tid')}", []).append(
            (start, start + dur))
        k = per_name.setdefault(e.get("name", "?"), {"us": 0.0, "count": 0})
        k["us"] += dur
        k["count"] += 1
    streams = []
    for stream, iv in sorted(by_stream.items()):
        busy = _union_us(iv)
        streams.append({"stream": stream, "events": len(iv), "busy_us": busy,
                        "busy_share": share(busy)})
    busy = _union_us([iv for ivs in by_stream.values() for iv in ivs])
    return {
        "trace": trace_path, "kind": kind, "window_us": window,
        "streams": streams,
        "device": {"events": len(device), "busy_us": busy,
                   "busy_share": share(busy)},
        "kernels": dict(sorted(per_name.items(), key=lambda kv: -kv[1]["us"])),
    }


def format_summary(s: dict, top: int = 10) -> str:
    def pct(v):
        return "n/a" if v is None else f"{100 * v:.1f}%"

    lines = [f"trace: {s['trace']} ({s['kind']} activity), window "
             f"{s['window_us'] / 1e3:.3f} ms"]
    for st in s["streams"]:
        lines.append(f"  stream {st['stream']}: {st['events']} events, busy "
                     f"{st['busy_us'] / 1e3:.3f} ms ({pct(st['busy_share'])} "
                     "of the window)")
    d = s["device"]
    lines.append(f"  device: {d['events']} events, busy {d['busy_us'] / 1e3:.3f}"
                 f" ms ({pct(d['busy_share'])} of the window)")
    total = sum(k["us"] for k in s["kernels"].values())
    for name, k in list(s["kernels"].items())[:top]:
        lines.append(f"  {k['us'] / 1e3:10.3f} ms {100 * k['us'] / total:5.1f}% "
                     f"x{k['count']:<5d} {name[:90]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m mplc_tpu_torch.obs.analyze_trace",
        description="device busy share and top kernels of a torch.profiler trace")
    ap.add_argument("path", nargs="?", default=".",
                    help=f"a *{TRACE_SUFFIX} file or a directory holding one")
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    try:
        path = newest_trace(args.path)
    except FileNotFoundError as e:
        ap.error(str(e))
    print(format_summary(summarize(path), args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
