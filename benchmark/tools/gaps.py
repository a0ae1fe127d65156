"""A traced run of one cell with every idle gap named (not only the ten
longest): the gaps' seconds and counts by name, in size classes.

    python3 benchmark/tools/gaps.py <workload> <seed> <out.json>
"""
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path[0] = str(Path(__file__).resolve().parents[2])
from benchmark import harness  # noqa: E402

w, seed, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
full = {}
orig = harness.name_gaps


def name_all(gaps, spans, limit=10):
    named = orig(gaps, spans, limit=len(gaps))
    by = {}
    for name, sec in named:
        k = "ge5ms" if sec >= 5e-3 else "1to5ms" if sec >= 1e-3 else "lt1ms"
        e = by.setdefault(name, {"ge5ms": [0, 0.0], "1to5ms": [0, 0.0], "lt1ms": [0, 0.0]})
        e[k][0] += 1
        e[k][1] += sec
    full["by_name"] = by
    full["idle_s"] = sum(sec for _, sec in named)
    w0 = min(g[0] for g in gaps) if gaps else 0.0

    def open_at(t):
        return [n for n, a, b in sorted(spans, key=lambda sp: sp[1]) if a <= t <= b]
    full["wide"] = [{"at_s": g0 - w0, "sec": g1 - g0, "start": open_at(g0),
                     "mid": open_at((g0 + g1) / 2), "end": open_at(g1)}
                    for g0, g1 in gaps if g1 - g0 >= 1e-3]
    return named[:limit]


harness.name_gaps = name_all
r = harness.run_cell(w, seed, 20.0, True, t_start=T0)
full["metrics"] = {k: v["value"] for k, v in r["metrics"].items()}
full["device"] = r["device"]
full["correct"] = r["correct"]
full["idle_gaps"] = r["breakdown"]["idle_gaps"]
Path(out).write_text(json.dumps(full, indent=1))
print(json.dumps(full))
