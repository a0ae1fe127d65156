"""The readings that the limits of `correct` are set from, the control and
the planted faults.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \
        [--modes fp32,control,bf16,fault-frozen] [--requests 1] [--start]

For each seed, in one process: the cell's inputs and the plain
reference's view of them, then for each mode one reading of the check's
numbers at the cell's own size, against the reference (whose work is
shared by the modes of a seed):

- `fp32`, `bf16`: the program in that precision (`MPLC_TORCH_PRECISION`;
  the configurations state fp32) serving the mix's first `--requests`
  requests through the harness's own serve loop (`harness.serve`);
- `control`: the reference in TF32, the nearest precision below the
  configurations' float32 with TF32 off, put in the program's place for
  the first request's sampled coalitions (the program has no TF32 path);
  for the reconstruction cell, their replay from the `fp32` mode's
  recording (so list `fp32` first) and its own recorded run;
- `fault-<name>`: the program in fp32 with `faults.py`'s fault planted
  from its set-up on (the reconstruction entry records there).

`--start` reads the retraining entries' start alone: the reference trains
each sampled coalition's first pass, not its whole training, so
`v_gap_max` is not read. `--requests 0` serves nothing: for the
reconstruction entry, the recording alone is read (no `v_gap_max`). One JSON line a seed and mode. The benchmark's
runs never run this; the CPU tests run it at a small size.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

# the checkout's root in place of this folder, whose module names would
# shadow the standard library's for everything the run imports
sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import check, faults, game, harness, traffic  # noqa: E402


def readings(workload: str, seeds: list, modes: list, n_requests: int,
             overrides: dict | None = None, device: str = "cuda", full: bool = True):
    """Yield one dict a (seed, mode): its readings and its first answers.
    `overrides` of the configuration and the mix are the tests' small
    sizes."""
    man, cell, cfg, mix = harness.load_cell(workload, overrides)
    harness.prepare_environment(man.root, cfg)
    epochs = harness.epochs_of(cfg, mix)
    for seed in seeds:
        raw = game.make_inputs(cfg, seed)
        ref_game = game.reference_game(cfg, raw, seed, device)
        cache, recorded_fp32 = {}, None
        for mode in modes:
            os.environ["MPLC_TORCH_PRECISION"] = "bf16" if mode == "bf16" else cfg["precision"]
            t0 = time.perf_counter()
            if mode == "control":
                first = traffic.requests(mix, len(cfg["partner_weights"]))[0]
                if mix["entry"] == "reconstruction_fresh":
                    r = check.control_recon(cfg, mix, first, ref_game, recorded_fp32,
                                            device, cache)
                else:
                    r = check.control_retrain(cfg, mix, first, ref_game, epochs, device,
                                              cache, full)
                yield {"workload": workload, "seed": seed, "mode": mode, "readings": r,
                       "check_s": time.perf_counter() - t0}
                continue
            plant = (faults.FAULTS[mode[len("fault-"):]]()
                     if mode.startswith("fault-") else contextlib.nullcontext())
            window = harness.Window(float("inf"), requests=n_requests)
            with plant:
                entry, reqs = harness.build_entry(cfg, mix, raw, seed, device,
                                                  window.progress)
                window.probe = entry.scenario.dataset.model.optimizer
                if n_requests:
                    harness.serve(entry, reqs, window)
            answers, steps = entry.answers(), window.probe.rows()
            recorded = getattr(entry, "recorded", None)
            if mode == "fp32":
                recorded_fp32 = recorded
            t_prog = time.perf_counter() - t0
            del entry
            t1 = time.perf_counter()
            r = harness.readings_of(cfg, mix, answers, recorded, ref_game, device, cache,
                                    steps, full)
            yield {"workload": workload, "seed": seed, "mode": mode, "readings": r,
                   "window_s": window.length if n_requests else 0.0, "program_s": t_prog,
                   "check_s": time.perf_counter() - t1,
                   "answers": [[list(c), v] for _, c, v in answers[:32]]}
        os.environ["MPLC_TORCH_PRECISION"] = cfg["precision"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="fp32,control")
    ap.add_argument("--requests", type=int, default=1)
    ap.add_argument("--start", action="store_true")
    args = ap.parse_args(argv)
    print("[readings] card:", harness.card_description(), file=sys.stderr, flush=True)
    for line in readings(args.workload, [int(s) for s in args.seeds.split(",")],
                         args.modes.split(","), args.requests, full=not args.start):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
