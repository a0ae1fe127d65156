"""Set-up of one cell as the harness does it, timed by phase, with the
program's spans collected: where the "scenario and entry" seconds go.

    python3 benchmark/tools/setup_split.py <workload> <seed> <out.json>
"""
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path[0] = str(Path(__file__).resolve().parents[2])
from benchmark import game, harness  # noqa: E402

w, seed, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
man, cell, cfg, mix = harness.load_cell(w)
harness.prepare_environment(man.root, cfg)
import torch  # noqa: E402
import mplc_tpu_torch  # noqa: E402,F401
from mplc_tpu_torch.obs import metrics, trace  # noqa: E402
t = {"to_inputs": time.perf_counter() - T0}
raw = game.make_inputs(cfg, seed)
t["inputs"] = time.perf_counter() - T0 - t["to_inputs"]
with trace.collect() as recs:
    a = time.perf_counter()
    from mplc_tpu_torch.data.datasets import Dataset, with_held_out_test  # noqa: F401
    from mplc_tpu_torch.models.zoo import MODELS  # noqa: F401
    from mplc_tpu_torch.scenario import Scenario  # noqa: F401
    t["program_scenario_imports"] = time.perf_counter() - a
    a = time.perf_counter()
    entry, reqs = harness.build_entry(cfg, mix, raw, seed, "cuda", lambda done: None)
    t["build_entry"] = time.perf_counter() - a
    t["scenario_and_entry"] = t["program_scenario_imports"] + t["build_entry"]
    a = time.perf_counter()
    from benchmark import traffic
    entry.warm(traffic.warmup_requests(mix, reqs))
    torch.cuda.synchronize()
    t["warmup"] = time.perf_counter() - a
spans = [(r["name"], r["attrs"].get("step") or r["attrs"].get("source") or r["attrs"].get("phase"),
          r["dur"], r["ts"]) for r in recs if r["name"] in trace.SECONDS_COUNTERS
         or r["name"] == "trainer.compile"]
doc = {"phases": t, "spans": spans,
       "counters": {k: v for k, v in metrics.snapshot()["counters"].items() if "seconds_total" in k}}
Path(out).write_text(json.dumps(doc, indent=1))
print(json.dumps(doc))
