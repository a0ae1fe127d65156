"""Cost of the JSONL trace sink on cell 1's path: one set-up, then
windows of `--seconds` alternating the sink off and on (MPLC_TORCH_TRACE_FILE
unset / set), each window's rate from the engine's progress hook.

    python3 benchmark/tools/trace_cost.py --seed 7 --seconds 20 --pairs 3 --out build/trace_cost
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from benchmark import game, harness, traffic  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--seed", type=int, default=7)
ap.add_argument("--seconds", type=float, default=20)
ap.add_argument("--pairs", type=int, default=3)
ap.add_argument("--out", default="build/trace_cost")
a = ap.parse_args()
os.makedirs(a.out, exist_ok=True)
man, cell, cfg, mix = harness.load_cell("mnist_cnn-p10.retrain")
harness.prepare_environment(man.root, cfg)
import torch  # noqa: E402
from mplc_tpu_torch.obs import trace  # noqa: E402
raw = game.make_inputs(cfg, a.seed)
win = harness.Window(a.seconds)
entry, reqs = harness.build_entry(cfg, mix, raw, a.seed, "cuda", win.progress)
win.probe = entry.scenario.dataset.model.optimizer
entry.warm(traffic.warmup_requests(mix, reqs))
torch.cuda.synchronize()
queue = iter(reqs)
rows = []
for i in range(2 * a.pairs):
    on = i % 2 == 1
    path = os.path.join(a.out, f"trace{i}.jsonl")
    if on:
        os.environ[trace.TRACE_FILE_ENV] = path
    else:
        os.environ.pop(trace.TRACE_FILE_ENV, None)
    w = harness.Window(a.seconds)
    w.probe = win.probe
    entry.progress = w.progress
    w.probe.arm()
    w.t0 = time.perf_counter()
    for req in queue:
        try:
            entry.serve(req)
        except harness.WindowClosed:
            break
    rate = w.coalitions / w.length
    lines = sum(1 for _ in open(path)) if on and os.path.exists(path) else 0
    rows.append({"sink": on, "coalitions": w.coalitions, "window_s": w.length,
                 "rate": rate, "records": lines})
    print(json.dumps(rows[-1]), flush=True)
os.environ.pop(trace.TRACE_FILE_ENV, None)
off = [r["rate"] for r in rows if not r["sink"]]
on = [r["rate"] for r in rows if r["sink"]]
print(json.dumps({"off": off, "on": on, "on_over_off": sum(on) / sum(off)}))
