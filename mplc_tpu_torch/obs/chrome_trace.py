"""Chrome trace-event export: span JSONL to JSON that Perfetto loads (port of
`mplc_tpu/obs/chrome_trace.py`).

The span JSONL sink (`MPLC_TORCH_TRACE_FILE`) records the engine's
prep/dispatch/harvest timeline as flat lines. This module converts it into
the Chrome trace-event format (the JSON object form, `{"traceEvents":
[...]}`) that https://ui.perfetto.dev and chrome://tracing load:

  - every record becomes a complete ("X") slice on a per-thread track
    (`pid` 1, `tid` = the recording thread id, named with "M" metadata
    events); zero-duration events are widened to 1 us so they render and
    can anchor flows. Sampled device fences (`engine.device_fence`,
    obs/devcost.py: a point event at the batch's harvest carrying the
    batch's device seconds between CUDA events as `device_sec`) go to a
    "device" process track (pid 2) as a slice of `device_sec` ending at
    the harvest (the JAX package's fence, whose `ts` and `dur` are the
    device interval, as it is), so measured device time stands apart from
    the host spans and never sits on a host track;
  - timestamps are rebased to the trace's first record, in microseconds;
  - FLOW events (ph "s"/"f") link the recovery records to the work they
    recovered: `engine.retry` / `engine.fault` to the next `engine.batch`
    of the same ordinal on the same thread, `engine.degrade` to the next
    batch on the thread, `service.job_fault` to the job's next
    `service.slice`. The port emits all four (`service.job_fault` from
    the sweep service's scheduler); the converter keeps the JAX package's
    rules so that it reads either package's trace the same way.

`read_jsonl` tolerates torn lines (a process killed mid-append), counting
and reporting them.

Command line (the counterpart of the JAX package's
scripts/trace_to_perfetto.py):

    python3 -m mplc_tpu_torch.obs.chrome_trace <trace.jsonl> [-o out.json]

Setting `MPLC_TORCH_CHROME_TRACE_FILE` beside the trace file converts it at
interpreter exit (the hook in obs/trace.py).
"""

from __future__ import annotations

import json
import os
import warnings

# record-name -> flow-arrow label for the recovery links drawn below
_FLOW_SOURCES = {"engine.retry": "retry", "engine.fault": "fault",
                 "engine.degrade": "degrade",
                 "service.job_fault": "requeue"}

# records that represent MEASURED DEVICE time (the sampled fences,
# the JAX package's obs/devcost.py) rather than host-side spans: drawn on their own
# "device" process track (pid 2) so the enqueue-vs-device-vs-harvest
# split the report totals is visually inspectable on the timeline
_DEVICE_ROWS = {"engine.device_fence"}


def read_jsonl(path: str) -> tuple[list, int]:
    """(records, torn_lines): every parseable record of a span JSONL
    trace, in file order. Unparseable or schema-less lines (torn tail
    from a hard kill, truncated flush) are counted, not fatal."""
    records = []
    torn = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict) or "name" not in rec:
                    raise ValueError("not a span record")
            except ValueError:
                torn += 1
                continue
            records.append(rec)
    return records, torn


def _attrs(rec: dict) -> dict:
    return rec.get("attrs") or {}


def _device_lead(rec: dict) -> float:
    """The device seconds a port fence (a point event at its harvest)
    carries, drawn before its `ts`; 0 for any other record, and for the
    JAX package's fence, whose `ts` and `dur` are the device interval."""
    if rec.get("name") not in _DEVICE_ROWS:
        return 0.0
    return float(_attrs(rec).get("device_sec") or 0.0)


def to_chrome(records: list) -> dict:
    """Chrome trace-event JSON (object form) from span records."""
    events = []
    if records:
        t0 = min(float(r.get("ts") or 0.0) - _device_lead(r) for r in records)
    else:
        t0 = 0.0

    tids = []  # (pid, tid) in file-discovery order
    slices = []  # (rec, ts_us, dur_us) in file order, for flow targets
    for rec in records:
        tid = int(rec.get("thread") or 0)
        name = rec.get("name", "?")
        pid = 2 if name in _DEVICE_ROWS else 1
        if (pid, tid) not in tids:
            tids.append((pid, tid))
        ts_us = (float(rec.get("ts") or 0.0) - t0) * 1e6
        dur_us = max(float(rec.get("dur") or 0.0) * 1e6, 1.0)
        if _device_lead(rec):
            # the port's fence: its device seconds end at its harvest
            dur_us = max(_device_lead(rec) * 1e6, 1.0)
            ts_us -= dur_us
        events.append({
            "name": name,
            "cat": name.split(".", 1)[0],
            "ph": "X",
            "ts": ts_us,
            "dur": dur_us,
            "pid": pid,
            "tid": tid,
            "args": {**_attrs(rec), "span_id": rec.get("id"),
                     "parent_span": rec.get("parent")},
        })
        slices.append((rec, ts_us, dur_us))

    # thread tracks: name them, keep file-discovery order stable
    for i, (pid, tid) in enumerate(tids):
        prefix = "device" if pid == 2 else "thread"
        events.append({"name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
                       "tid": tid, "args": {"name": f"{prefix}-{tid}"}})
        events.append({"name": "thread_sort_index", "ph": "M", "ts": 0,
                       "pid": pid, "tid": tid, "args": {"sort_index": i}})
    if any(pid == 2 for pid, _ in tids):
        events.append({"name": "process_name", "ph": "M", "ts": 0, "pid": 1,
                       "tid": 0, "args": {"name": "host"}})
        events.append({"name": "process_name", "ph": "M", "ts": 0, "pid": 2,
                       "tid": 0, "args": {"name": "device (fenced samples)"}})

    flows = _flow_events(slices)
    events.extend(flows)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"source": "mplc_tpu span JSONL",
                      "records": len(records), "flows": len(flows) // 2},
    }


def _flow_events(slices: list) -> list:
    """ph "s"/"f" pairs for the recovery links (module docstring). Flow
    binding rule: the start event sits just inside the source slice, the
    finish (`bp: "e"`) just inside the target slice — both slices exist
    because zero-duration records were widened to 1 us.

    Targets are pre-indexed by key so a fault-heavy trace converts in one
    forward pass (a per-source rescan of all later records is quadratic
    in record count): "the NEXT matching record after position i" is a
    `bisect` into that key's position list."""
    import bisect

    # key -> ([file positions], [slice tuples]), positions ascending
    batch_by_tid_ord: dict = {}   # (tid, ordinal) — retry/fault targets
    batch_by_tid: dict = {}       # tid             — degrade targets
    slice_by_job: dict = {}       # job             — requeue targets
    for i, entry in enumerate(slices):
        rec = entry[0]
        a = _attrs(rec)
        if rec.get("name") == "engine.batch":
            tid = int(rec.get("thread") or 0)
            for key, idx in (((tid, a.get("ordinal")), batch_by_tid_ord),
                             ((tid,), batch_by_tid)):
                pos, items = idx.setdefault(key, ([], []))
                pos.append(i)
                items.append(entry)
        elif rec.get("name") == "service.slice":
            pos, items = slice_by_job.setdefault(a.get("job"), ([], []))
            pos.append(i)
            items.append(entry)

    def next_after(index: dict, key, i):
        hit = index.get(key)
        if hit is None:
            return None
        pos, items = hit
        j = bisect.bisect_right(pos, i)
        return items[j] if j < len(items) else None

    out = []
    flow_id = 0
    for i, (rec, ts_us, _dur) in enumerate(slices):
        label = _FLOW_SOURCES.get(rec.get("name"))
        if label is None:
            continue
        a = _attrs(rec)
        tid = int(rec.get("thread") or 0)
        if rec.get("name") == "service.job_fault":
            # the requeue link: this job's next scheduling quantum
            target = next_after(slice_by_job, a.get("job"), i)
        elif a.get("ordinal") is not None:
            # retry/fault carry the batch ordinal
            target = next_after(batch_by_tid_ord, (tid, a["ordinal"]), i)
        else:
            # degrade (an OOM re-bucket) links to whatever batch
            # dispatches next on the thread
            target = next_after(batch_by_tid, (tid,), i)
        if target is None:
            continue
        nrec, nts, ndur = target
        flow_id += 1
        out.append({"name": label, "cat": "flow", "ph": "s", "id": flow_id,
                    "ts": ts_us + 0.5, "pid": 1, "tid": tid})
        out.append({"name": label, "cat": "flow", "ph": "f", "bp": "e",
                    "id": flow_id, "ts": nts + min(0.5, ndur / 2),
                    "pid": 1, "tid": int(nrec.get("thread") or 0)})
    return out


def convert(in_path: str, out_path: str | None = None) -> dict:
    """Read a span JSONL trace, write Chrome trace-event JSON (atomic
    temp + rename), return a summary dict: {out, records, events, flows,
    torn_lines}."""
    records, torn = read_jsonl(in_path)
    doc = to_chrome(records)
    if torn:
        doc["otherData"]["torn_lines"] = torn
        warnings.warn(
            f"{in_path}: {torn} unparseable line(s) skipped (torn tail "
            "from a hard kill, or a non-span line); the converted trace "
            "covers every intact record", stacklevel=2)
    if out_path is None:
        base = in_path[:-6] if in_path.endswith(".jsonl") else in_path
        out_path = base + ".chrome.json"
    d = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{out_path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)
    return {"out": out_path, "records": len(records),
            "events": len(doc["traceEvents"]),
            "flows": doc["otherData"]["flows"], "torn_lines": torn}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python3 -m mplc_tpu_torch.obs.chrome_trace",
        description="span JSONL -> Chrome trace-event JSON (Perfetto)")
    ap.add_argument("trace", help="span JSONL file (MPLC_TORCH_TRACE_FILE)")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: <trace>.chrome.json)")
    args = ap.parse_args(argv)
    if not os.path.exists(args.trace):
        ap.error(f"trace file not found: {args.trace}")
    summary = convert(args.trace, args.out)
    line = (f"{summary['out']}: {summary['events']} trace events from "
            f"{summary['records']} records, {summary['flows']} flow links")
    if summary["torn_lines"]:
        line += f", {summary['torn_lines']} torn line(s) skipped"
    print(line)
    print("load it at https://ui.perfetto.dev (or chrome://tracing)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
