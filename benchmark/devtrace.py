"""The device trace of a traced run's steady sub-window.

`DeviceTrace` wraps `torch.profiler` with CUDA activity only (no CPU ops,
so a sub-window of whole batches stays tens of MB). The sub-window opens
and closes on a synchronized device with a marker op launched at a known
host time; the first and last device events of the trace are those
markers, which put the device's clock and the host's on one line, so an
idle gap can be named by the host span open at the time (the program's
own `engine.*` spans, collected in memory, and the harness's).

The arithmetic (the union of device intervals, the gaps between them, the
time by operation) is the benchmark's own copy of what the port's
`obs/analyze_trace.py` does with a trace file.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals: list) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self.host = (None, None)     # host time (s) of the two markers
        self.summary = None

    def _marker(self):
        import torch
        torch.cuda.synchronize()
        t = time.time()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        return t

    def start(self) -> None:
        import torch
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.host = (self._marker(), None)

    def stop(self) -> None:
        self.host = (self.host[0], self._marker())
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        events = [e for e in doc.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
        self.summary = summarize(events, self.host)

    @property
    def active(self) -> bool:
        return self._prof is not None


def summarize(events: list, host: tuple) -> dict:
    """From device events (Chrome trace "X" events, microseconds) whose
    first and last are the window's markers: the window, busy and idle
    seconds, device time by op name, and the idle gaps as host-clock
    intervals [(start s, end s)], longest first."""
    events = sorted(events, key=lambda e: float(e["ts"]))
    if len(events) < 2:
        return None
    first, last = events[0], events[-1]
    t0 = float(first["ts"])
    t1 = float(last["ts"])
    offset = host[0] - t0 / 1e6        # host seconds = trace us / 1e6 + offset
    body = events[1:-1]
    iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in body]
    merged = union([(max(s, t0), min(e, t1)) for s, e in iv if e > t0 and s < t1])
    busy_us = sum(e - s for s, e in merged)
    gaps, prev = [], t0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    by_name: dict = {}
    for e in body:
        k = by_name.setdefault(e.get("name", "?"), [0.0, 0])
        k[0] += float(e.get("dur", 0.0)) / 1e6
        k[1] += 1
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy_us / 1e6,
            "host_window_s": host[1] - host[0],
            "ops": sorted(((n, v[0], v[1]) for n, v in by_name.items()),
                          key=lambda t: -t[1]),
            "gaps": [(s / 1e6 + offset, e / 1e6 + offset) for s, e in gaps]}


def name_gaps(gaps: list, spans: list, limit: int = 10) -> list:
    """[[name, seconds], ...] of the longest gaps, each named by the
    innermost host span (name, start s, end s) open at its midpoint, else
    "host"; at most `limit`, longest first."""
    out = []
    for s, e in gaps[:limit]:
        mid = (s + e) / 2
        open_ = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = max(open_, key=lambda sp: sp[1])[0] if open_ else "host"
        out.append([name, e - s])
    return out
