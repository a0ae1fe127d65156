"""Time a block of same-size coalitions at several batch caps (port of
`scripts/tune_coalition_cap.py`).

    python3 -m mplc_tpu_torch.tune_coalition_cap [--size 5] [--block 64]
        [--caps 16,32,64] [--partners 10] [--epochs 8] [--dataset mnist]
        [--dtype bfloat16] [--minibatch-count 10] [--gradient-updates 8]
        [--device cpu]

The sweep's trainers are bound by the host's enqueueing and by narrow
batches (PERF.md section 5), so a wider coalition batch should raise
throughput until the card's memory or arithmetic saturates; the engine's
autotuned cap reads memory only. For each cap in `--caps` this sets
`MPLC_TORCH_COALITIONS_PER_DEVICE`, evaluates the block once on a warm
engine (the first run: the card's and cuDNN's warm-up), then times a fresh
engine that shares the first one's staged data (`share_data_from`),
synced, and prints its seconds a coalition; then the best cap.

The block is rounded up to a multiple of the caps' lcm, so that no cap
pays for padding (the engine pads a batch to its width, and padded rows
train). The ambient engine knobs that would change what is timed
(`MPLC_TORCH_PARTNER_SHARDS`, `NO_SLOTS`, `SLOT_POW2`, `SLOT_MERGE`,
`BATCH_CAP_CEILING`) are cleared, each named on stderr; the JAX script's
sixth, its batch pipelining knob, has no counterpart (the port harvests
each batch before it dispatches the next). `MPLC_TORCH_SYNTH_NOISE`
defaults to 0.75. The environment is restored on return.

The scenario is bench.py's `_make_scenario` (fedavg, data-volume weights,
partner i holding (i+1)/sum of the data, 3 partners [0.4, 0.3, 0.3]),
with bench's minibatch count 10 and 8 gradient updates a pass unless
`--minibatch-count` and `--gradient-updates` say otherwise. `--dtype` is
the Scenario's `compute_dtype`. The JAX script points XLA's compilation
cache at the checkout; the port compiles no program a coalition (its
kernels are built by ops/cuda_build.py, and the sweep launches none), so
there is nothing to point. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import tempfile
import time
from itertools import combinations, islice

from . import constants

# the ambient knobs that would change the engine path being timed
AMBIENT_KNOBS = (constants.PARTNER_SHARDS_ENV, constants.NO_SLOTS_ENV,
                 constants.SLOT_POW2_ENV, constants.SLOT_MERGE_ENV,
                 constants.BATCH_CAP_CEILING_ENV)


def amounts(n_partners: int) -> list:
    """bench.py's split: 3 partners [0.4, 0.3, 0.3], else partner i holding
    (i+1)/sum, so that coalition values differ between partners."""
    a = [0.4, 0.3, 0.3] if n_partners == 3 else [float(i + 1) for i in range(n_partners)]
    return [x / sum(a) for x in a]


def make_scenario(dataset: str, n_partners: int, epochs: int, dtype: str,
                  minibatch_count: int = 10, gradient_updates: int = 8, seed: int = 0,
                  device=None):
    """bench.py's `_make_scenario`, prepared, on `device` (None: the card)."""
    from .scenario import Scenario
    sc = Scenario(partners_count=n_partners, amounts_per_partner=amounts(n_partners),
                  dataset_name=dataset, multi_partner_learning_approach="fedavg",
                  aggregation_weighting="data-volume", epoch_count=epochs,
                  minibatch_count=minibatch_count,
                  gradient_updates_per_pass_count=gradient_updates,
                  is_early_stopping=False, compute_dtype=dtype,
                  experiment_path=os.path.join(tempfile.gettempdir(), "mplc_bench"),
                  is_dry_run=True, seed=seed, device=device)
    sc.instantiate_scenario_partners()
    sc.split_data(is_logging_enabled=False)
    sc.compute_batch_sizes()
    sc.data_corruption()
    return sc


@contextlib.contextmanager
def _restored_env(keys):
    saved = {k: os.environ.get(k) for k in keys}
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 -m mplc_tpu_torch.tune_coalition_cap",
                                 description="time a padding-free block of coalitions "
                                             "at several batch caps")
    ap.add_argument("--size", type=int, default=5)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--caps", default="16,32,64")
    ap.add_argument("--partners", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--dtype", default="bfloat16", choices=constants.COMPUTE_DTYPES)
    ap.add_argument("--minibatch-count", type=int, default=10)
    ap.add_argument("--gradient-updates", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="the device (default: the card; 'cpu' to run on the CPU)")
    return ap


def run(argv=None) -> dict:
    """The sweep of `argv`: {"block", "caps", "subsets", "s_per_coalition"
    {cap: s}, "values" {cap: v(S) of the timed engine}, "best"}."""
    ap = _parser()
    args = ap.parse_args(argv)
    caps = [int(c) for c in args.caps.split(",")]
    if args.size > args.partners:
        ap.error(f"--size {args.size} exceeds --partners {args.partners}")
    lcm = math.lcm(*caps)
    block = -(-args.block // lcm) * lcm
    if block != args.block:
        print(f"block {args.block} -> {block} (multiple of lcm{tuple(caps)}={lcm}, so no "
              "cap pays padding)", flush=True)
    subsets = list(islice(combinations(range(args.partners), args.size), block))
    if len(subsets) < block:
        ap.error(f"only {len(subsets)} size-{args.size} coalitions exist for "
                 f"{args.partners} partners; need {block} for a padding-free "
                 "comparison — lower --block or --caps")
    with _restored_env((*AMBIENT_KNOBS, constants.SYNTH_NOISE_ENV,
                        constants.COALITIONS_PER_DEVICE_ENV)):
        for knob in AMBIENT_KNOBS:
            if os.environ.pop(knob, None) is not None:
                print(f"[tune] ignoring ambient {knob}", file=sys.stderr)
        os.environ.setdefault(constants.SYNTH_NOISE_ENV, "0.75")
        import numpy as np
        import torch

        from .contrib.engine import CharacteristicEngine
        sc = make_scenario(args.dataset, args.partners, args.epochs, args.dtype,
                           args.minibatch_count, args.gradient_updates, device=args.device)
        cuda = torch.device(sc.device).type == "cuda"
        per, values = {}, {}
        shared = None
        for cap in caps:
            os.environ[constants.COALITIONS_PER_DEVICE_ENV] = str(cap)
            warm = CharacteristicEngine(sc, share_data_from=shared)
            shared = shared or warm
            t0 = time.perf_counter()
            warm.evaluate(subsets)                 # the warm-up and first run
            first = time.perf_counter() - t0
            timed = CharacteristicEngine(sc, share_data_from=shared)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            accs = timed.evaluate(subsets)         # steady state
            if cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if not np.isfinite(accs).all():
                raise RuntimeError(f"cap {cap}: non-finite v(S)")
            widths = sorted({b["width"] for b in timed.batch_log})
            per[cap] = dt / len(subsets)
            values[cap] = accs
            print(f"cap={cap:3d}: {dt:6.1f} s for {len(subsets)} size-{args.size} "
                  f"coalitions = {per[cap]:.3f} s/coalition (first run: {first:.0f} s; "
                  f"batch widths {widths})", flush=True)
    best = min(per, key=per.get)
    print(f"best cap: {best} ({per[best]:.3f} s/coalition)")
    return {"block": block, "caps": caps, "subsets": subsets, "s_per_coalition": per,
            "values": values, "best": best}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
