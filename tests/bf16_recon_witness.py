"""How far bf16 moves the retrain-free path's v(S) from fp32, in the JAX
package and in the port, on the CPU: a witness for the bf16 value gates
of `chip_smoke.py` ([precision], [devcost] (c)).

    JAX_PLATFORMS=cpu python3 tests/bf16_recon_witness.py [--partners 10] [--scale 0.02]

Both packages build the main path's game (bench config 1's training: 2
epochs, 10 minibatches, 8 gradient updates a pass, data-volume weights,
partner i holding (i+1)/sum of the data, seed 0) on synthetic MNIST at
`scale` x 60,000 train and x 10,000 test samples (noise 0.75), record the
grand coalition once under each precision and reconstruct every
coalition (`Contributivity.exact_reconstructed`). For each package it
prints one JSON line: max and median |v_bf16(S) - v_fp32(S)|, |dv(N)|,
how many coalitions part by more than 0.05 (the JAX package's bf16 bound
for a retrained game, `tests/test_precision.py`) and the worst eight.
The CNN's compile makes the JAX half take minutes.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]   # the repo root, tests/helpers.py

BOUND = 0.05


def _game(partners: int) -> dict:
    total = sum(range(1, partners + 1))
    return dict(amounts=[(i + 1) / total for i in range(partners)], epoch_count=2,
                minibatch_count=10, gradient_updates_per_pass_count=8,
                aggregation_weighting="data-volume", is_early_stopping=False, seed=0)


def jax_values(partners: int, mode: str) -> np.ndarray:
    os.environ["MPLC_TPU_PRECISION"] = mode
    from helpers import build_scenario
    from mplc_tpu.contrib.contributivity import Contributivity
    from mplc_tpu.contrib.shapley import powerset_order
    g = _game(partners)
    sc = build_scenario(partners_count=partners, amounts_per_partner=g.pop("amounts"),
                        dataset_name="mnist", **g)
    c = Contributivity(sc)
    c.exact_reconstructed()
    r = c._reconstructor()
    return np.array([float(r.values[s]) for s in powerset_order(partners)])


def port_values(partners: int, scale: float, mode: str) -> np.ndarray:
    os.environ["MPLC_TORCH_PRECISION"] = mode
    import torch
    from mplc_tpu_torch.contrib.contributivity import Contributivity
    from mplc_tpu_torch.contrib.shapley import powerset_order
    from mplc_tpu_torch.data.datasets import load_mnist
    from mplc_tpu_torch.scenario import Scenario
    torch.set_num_threads(4)
    g = _game(partners)
    sc = Scenario(partners, g.pop("amounts"), is_dry_run=True,
                  dataset=load_mnist(scale=scale, noise=0.75), device="cpu", **g)
    sc.instantiate_scenario_partners()
    sc.split_data()
    c = Contributivity(sc)
    c.exact_reconstructed()
    r = c._reconstructor()
    return np.array([float(r.values[s]) for s in powerset_order(partners)])


def summary(package: str, partners: int, fp32: np.ndarray, bf16: np.ndarray,
            seconds: float) -> dict:
    from mplc_tpu_torch.contrib.shapley import powerset_order
    subsets = powerset_order(partners)
    dv = np.abs(bf16 - fp32)
    return {"package": package, "partners": partners, "max_abs_dv": float(dv.max()),
            "median_abs_dv": float(np.median(dv)), "abs_dv_grand": float(dv[-1]),
            "past_bound": int((dv > BOUND).sum()), "coalitions": len(dv),
            "worst": [[list(subsets[i]), float(fp32[i]), float(bf16[i])]
                      for i in np.argsort(-dv)[:8]],
            "seconds": seconds}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--partners", type=int, default=10)
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--packages", default="port,jax")
    args = ap.parse_args()
    os.environ["MPLC_TPU_SYNTH_SCALE"] = str(args.scale)
    os.environ["MPLC_TPU_SYNTH_NOISE"] = "0.75"
    for package in args.packages.split(","):
        t0 = time.perf_counter()
        if package == "jax":
            vals = [jax_values(args.partners, m) for m in ("fp32", "bf16")]
        else:
            vals = [port_values(args.partners, args.scale, m) for m in ("fp32", "bf16")]
        print(json.dumps(summary(package, args.partners, *vals,
                                 time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
