"""Slot against masked training of one retraining-sweep batch on the card,
under the default and the deterministic reduce: which coalitions come out
bit-equal, and how far the others are.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mplc_tpu_torch.obs.slot_parity --partners 5

The scenario is `chip_smoke.py`'s MNIST CNN at full width (synthetic
MNIST at scale 0.2, noise 0.75, bench config 1's training, partner i
holding (i+1)/sum of the data). For each approach (`--approaches`,
default seqavg and fedavg) and each reduce, it trains the first 16
coalitions of the 3-slot bucket (the pairs, then triples) twice on 3
slots and once masked, each coalition from its own stream, and prints one
JSON line: per comparison the coalitions whose test accuracy is bit-equal,
the largest accuracy difference and each coalition's largest parameter
difference.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..contrib.engine import CharacteristicEngine
from ..contrib.shapley import powerset_order
from ..data.datasets import load_mnist
from ..mpl.engine import MplTrainer
from ..scenario import Scenario


def _engine(partners: int, approach: str) -> CharacteristicEngine:
    total = sum(range(1, partners + 1))
    sc = Scenario(partners, [(i + 1) / total for i in range(partners)], is_dry_run=True,
                  dataset=load_mnist(scale=0.2, noise=0.75),
                  multi_partner_learning_approach=approach,
                  aggregation_weighting="data-volume", epoch_count=2,
                  minibatch_count=10, gradient_updates_per_pass_count=8,
                  is_early_stopping=False, seed=0, device="cuda")
    sc.instantiate_scenario_partners()
    sc.split_data()
    return CharacteristicEngine(sc)


def _train(eng, cfg, group, slot_count):
    """(params, test accuracies) of the batch trained on `slot_count`
    slots, or masked when None."""
    tr = MplTrainer(eng.model, dataclasses.replace(cfg, slot_count=slot_count))
    gens = [eng.coalition_generator(s) for s in group]
    state = tr.init_state(gens, eng.partners_count, eng.device)
    coal = torch.from_numpy(eng._coalition_arrays(group, slot_count)).to(eng.device)
    tr.epoch_chunk(state, eng.stacked, eng.val, coal, gens, cfg.epoch_count)
    return state.params, tr.finalize(state, eng.test)[1].cpu().numpy()


def _compare(group, a, b) -> dict:
    (pa, va), (pb, vb) = a, b
    return {"bit_equal": int((va == vb).sum()), "of": len(group),
            "max_abs_dv": float(np.abs(va - vb).max()),
            "param_max_abs_diff": {",".join(map(str, s)): max(
                (pa[g][k][i] - pb[g][k][i]).abs().max().item() for g in pa for k in pa[g])
                for i, s in enumerate(group)}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--partners", type=int, default=5)
    ap.add_argument("--approaches", default="seqavg,fedavg")
    args = ap.parse_args()
    print(f"device: {torch.cuda.get_device_name(0)}")
    for approach in args.approaches.split(","):
        eng = _engine(args.partners, approach)
        group = [s for s in powerset_order(args.partners)
                 if len(s) > 1 and eng._slot_width(len(s)) == 3][:16]
        for deterministic in (False, True):
            cfg = dataclasses.replace(eng._multi_cfg, deterministic_reduce=deterministic)
            t0 = time.perf_counter()
            slots, again, masked = (_train(eng, cfg, group, k) for k in (3, 3, None))
            print(json.dumps({"approach": approach, "deterministic_reduce": deterministic,
                              "slots_twice": _compare(group, slots, again),
                              "slots_vs_masked": _compare(group, slots, masked),
                              "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
