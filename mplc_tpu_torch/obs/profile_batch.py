"""Profile one retraining-sweep batch on the card, masked and at each slot
width: wall seconds, device busy seconds and share, kernel launches and
the kernels that take the most device time.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mplc_tpu_torch.obs.profile_batch --partners 5

The scenario is `chip_smoke.py`'s MNIST CNN at full width (synthetic
MNIST at scale 0.2, noise 0.75, bench config 1's training, partner i
holding (i+1)/sum of the data). Masked, then at the size's slot width
(merged buckets), it trains one batch of 16 coalitions of one size
(`--size`, default 2) once to warm up and once under `torch.profiler`,
and reads the kernels from the profile's Chrome trace. Prints one JSON
line a mode. The profile of a batch (some 150,000 kernels) takes minutes
to write out.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import constants
from ..contrib.engine import CharacteristicEngine
from ..contrib.shapley import powerset_order
from ..data.datasets import load_mnist
from ..scenario import Scenario


def _scenario(partners: int) -> Scenario:
    total = sum(range(1, partners + 1))
    sc = Scenario(partners, [(i + 1) / total for i in range(partners)], is_dry_run=True,
                  dataset=load_mnist(scale=0.2, noise=0.75),
                  aggregation_weighting="data-volume", epoch_count=2,
                  minibatch_count=10, gradient_updates_per_pass_count=8,
                  is_early_stopping=False, seed=0, device="cuda")
    sc.instantiate_scenario_partners()
    sc.split_data()
    return sc


def _batch(eng: CharacteristicEngine, group: list, slot_count):
    pipe = eng.multi_pipe if slot_count is None else eng._slot_pipe(slot_count)
    coal = torch.from_numpy(eng._coalition_arrays(group, slot_count)).to(eng.device)
    gens, init, streams = eng._batch_start(group, False)
    pipe.scores(coal, gens, eng.stacked, eng.val, eng.test, init, streams)


def kernel_summary(trace_path: str, top: int) -> dict:
    """Kernel launches, device busy seconds (the union of the kernels'
    intervals) and the kernels with the most device time, from a Chrome
    trace of `torch.profiler`."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    by_name: dict[str, list] = {}
    for e in events:
        entry = by_name.setdefault(e["name"][:80], [0.0, 0])
        entry[0] += e["dur"]
        entry[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernel_launches": len(events), "device_busy_s": busy_us / 1e6,
            "top_kernels": [{"name": n, "device_s": t / 1e6, "launches": c}
                            for n, (t, c) in ranked]}


def profile_mode(eng: CharacteristicEngine, group: list, slot_count, top: int) -> dict:
    _batch(eng, group, slot_count)                      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _batch(eng, group, slot_count)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = kernel_summary(path, top)
    return {"mode": "masked" if slot_count is None else f"{slot_count} slots",
            "coalitions": len(group), "wall_s": wall,
            "device_busy_share": summary["device_busy_s"] / wall, **summary}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--partners", type=int, default=5)
    ap.add_argument("--size", type=int, default=2, help="coalition size")
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    os.environ.pop(constants.NO_SLOTS_ENV, None)
    sc = _scenario(args.partners)
    eng = CharacteristicEngine(sc)
    group = [s for s in powerset_order(args.partners) if len(s) == args.size]
    group = (group * constants.MAX_COALITIONS_PER_DEVICE_BATCH)[
        :constants.MAX_COALITIONS_PER_DEVICE_BATCH]
    print(json.dumps({"card": torch.cuda.get_device_name(0), "partners": args.partners,
                      "size": args.size}))
    for slot_count in (None, eng._slot_width(args.size)):
        print(json.dumps(profile_mode(eng, group, slot_count, args.top)), flush=True)


if __name__ == "__main__":
    main()
