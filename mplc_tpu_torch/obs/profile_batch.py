"""Profile one retraining-sweep batch on the card, masked and at each slot
width: wall seconds, device busy seconds and share, kernel launches and
the kernels that take the most device time.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mplc_tpu_torch.obs.profile_batch --partners 5

The scenario is `chip_smoke.py`'s MNIST CNN at full width (synthetic
MNIST at scale 0.2, noise 0.75, bench config 1's training, partner i
holding (i+1)/sum of the data). Masked, then at the size's slot width
(merged buckets), it trains one batch of 16 coalitions of one size
(`--size`, default 2) once to warm up and once under `torch.profiler`
(`utils.profile_trace`), and reads the device's kernels and copies from
the profile's Chrome trace (`obs/analyze_trace.py`). Prints one JSON line
a mode. The profile of a batch (some 150,000 kernels) takes minutes
to write out.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from .. import constants
from ..contrib.engine import CharacteristicEngine
from ..contrib.shapley import powerset_order
from ..data.datasets import load_mnist
from ..scenario import Scenario
from ..utils import profile_trace
from . import analyze_trace


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


def profile_mode(eng: CharacteristicEngine, group: list, slot_count, top: int) -> dict:
    _batch(eng, group, slot_count)                      # warm-up
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp, device=eng.device) as prof:
            t0 = time.perf_counter()
            _batch(eng, group, slot_count)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summary = analyze_trace.summarize(prof.path)
    busy_s = summary["device"]["busy_us"] / 1e6
    return {"mode": "masked" if slot_count is None else f"{slot_count} slots",
            "coalitions": len(group), "wall_s": wall, "device_busy_share": busy_s / wall,
            "kernel_launches": summary["device"]["events"], "device_busy_s": busy_s,
            "top_kernels": [{"name": n[:80], "device_s": k["us"] / 1e6, "launches": k["count"]}
                            for n, k in list(summary["kernels"].items())[:top]]}


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
