"""Merge a fleet run's per-shard span traces into ONE Perfetto timeline
(port of `scripts/fleet_trace_merge.py`).

A W-shard fleet run (`mplc_tpu_torch.parallel.fleet.run_fleet`, or its
selfcheck) leaves in its output folder:

    trace_coordinator.jsonl      the coordinator's span stream
    trace_shardI.jsonl           each worker's span stream (W files)
    result_shardI.json           the workers' results, with the clock echo
    fleet_trace_manifest.json    the coordinator's spawn and done-seen times

This script rebases every shard's stream onto the coordinator's clock (the
midpoint rule, `obs/fleet_view._clock_offset`) and writes one Chrome
trace-event JSON: one process a shard, flow arrows from each `fleet.shard`
dispatch to that shard's `fleet.shard_run` root span. Load it at
https://ui.perfetto.dev.

Usage, from the checkout's root:

    python3 -m mplc_tpu_torch.fleet_trace_merge OUT_DIR [-o fleet_trace.json]

Exits non-zero when the folder holds no shard stream.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .obs import fleet_view


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge per-shard fleet traces into one Perfetto timeline")
    ap.add_argument("out_dir", help="the fleet run's output folder (trace_shardI.jsonl "
                                    "and the rest)")
    ap.add_argument("-o", "--output", default=None,
                    help="the merged trace's path (default: OUT_DIR/fleet_trace.json)")
    args = ap.parse_args(argv)
    merged = fleet_view.merge_fleet_traces(args.out_dir)
    if merged["shard_tracks"] == 0:
        print(f"[fleet-trace] no trace_shardI.jsonl streams found in {args.out_dir}",
              file=sys.stderr)
        return 1
    out_path = args.output or os.path.join(args.out_dir, "fleet_trace.json")
    tmp = f"{out_path}.tmp"
    with open(tmp, "w") as f:
        json.dump(merged["trace"], f)
    os.replace(tmp, out_path)
    print(json.dumps({
        "out": out_path,
        "shard_tracks": merged["shard_tracks"],
        "flow_links": merged["flow_links"],
        "records": merged["records"],
        "clock_offsets_s": {k: round(v, 6) for k, v in merged["offsets"].items()},
        "torn_lines": merged["torn_lines"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
