"""One retraining-sweep batch's coalitions trained at two batch widths on
the card: which values come out bit-equal, and which of the trainer's
operations part first.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mplc_tpu_torch.obs.width_parity --partners 5

The scenario is `chip_smoke.py`'s MNIST CNN sweep (synthetic MNIST at
scale 0.2, noise 0.75, bench config 1's training, partner i holding
(i+1)/sum of the data). The last 4 coalitions of the 3-slot bucket (the
batch the ladder re-runs after an OOM at its harvest) are trained alone
(width 4) and padded to width 16 as the sweep pads them, each from its own
stream, once with every step's gradients in one call of all the batch's
models and once with the width-4 batch's calls padded to 16 coalitions,
as the engine pads a batch re-run narrower than its call's first width.
Then, for the MNIST and CIFAR10 CNNs, one gradient call of N models (the
first ones shared) is held against a call of 6: which parameters'
gradients differ. It prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..contrib.engine import CharacteristicEngine
from ..contrib.shapley import powerset_order
from ..data.datasets import load_mnist
from ..models import zoo
from ..mpl.engine import MplTrainer, TrainConfig
from ..scenario import Scenario


def _engine(partners: int) -> CharacteristicEngine:
    total = sum(range(1, partners + 1))
    sc = Scenario(partners, [(i + 1) / total for i in range(partners)], is_dry_run=True,
                  dataset=load_mnist(scale=0.2, noise=0.75),
                  aggregation_weighting="data-volume", epoch_count=2,
                  minibatch_count=10, gradient_updates_per_pass_count=8,
                  is_early_stopping=False, seed=0, device="cuda")
    sc.instantiate_scenario_partners()
    sc.split_data()
    return CharacteristicEngine(sc)


def _train(eng, tr, rows):
    """The test accuracies of the coalitions `rows` trained as one batch."""
    gens = [eng.coalition_generator(s) for s in rows]
    state = tr.init_state(gens, eng.partners_count, eng.device)
    coal = torch.from_numpy(eng._coalition_arrays(rows, 3)).to(eng.device)
    tr.epoch_chunk(state, eng.stacked, eng.val, coal, gens, tr.cfg.epoch_count)
    return tr.finalize(state, eng.test)[1].cpu().numpy()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--partners", type=int, default=5)
    args = ap.parse_args()
    eng = _engine(args.partners)
    group = [s for s in powerset_order(args.partners)
             if len(s) > 1 and eng._slot_width(len(s)) == 3][16:20]
    out = {"device": torch.cuda.get_device_name(0), "coalitions": [list(s) for s in group]}
    # one call of all models against the re-run's calls, padded to 16
    for runs in (None, 16):
        tr = MplTrainer(eng.model, dataclasses.replace(eng._multi_cfg, slot_count=3,
                                                       grad_runs=runs))
        seconds = []
        vals = []
        for rows in (group, group + [group[0]] * 12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals.append(_train(eng, tr, rows)[:4])
            seconds.append(time.perf_counter() - t0)
        out[f"grad_runs={runs}"] = {
            "bit_equal": int((vals[0] == vals[1]).sum()), "width_4": vals[0].tolist(),
            "width_16": vals[1].tolist(), "seconds_width_4": seconds[0],
            "seconds_width_16": seconds[1]}
    out["gradient_calls"] = {name: _call_classes(model, shape, eng.device)
                             for name, model, shape in (("mnist_cnn", zoo.MNIST_CNN, (28, 28, 1)),
                                                        ("cifar10_cnn", zoo.CIFAR10_CNN, (32, 32, 3)))}
    print(json.dumps(out))


CALL_MODELS = (1, 2, 3, 6, 8, 12, 16, 20, 24, 32, 48, 64, 96, 160)


def _call_classes(model, shape, device) -> dict:
    """{N: the leaves whose gradients differ from a call of 6 models}, for
    one gradient call of N models (the first min(N, 6) shared) on 50 rows
    of random inputs."""
    tr = MplTrainer(model, TrainConfig(epoch_count=1, minibatch_count=1,
                                       gradient_updates_per_pass=1))
    g = torch.Generator().manual_seed(1)
    inits = [model.init(g) for _ in range(8)]
    L = model.num_outputs
    x = torch.rand((50,) + shape, generator=g).to(device)
    y = torch.nn.functional.one_hot(torch.randint(0, L, (50,), generator=g), L).float().to(device)
    m = torch.ones(50, device=device)

    def grads(n):
        trees = [inits[i % 8] for i in range(n)]
        p = {k: {q: torch.stack([t[k][q] for t in trees]).to(device) for q in inits[0][k]}
             for k in inits[0]}
        drop = tuple(torch.ones((n, 50) + s, dtype=torch.bool, device=device)
                     for _, s in model.dropout)
        return tr._grads(p, x.expand((n,) + x.shape), y.expand(n, 50, L), m.expand(n, 50),
                         drop)[0]
    ref = grads(6)
    out = {}
    for n in CALL_MODELS:
        got, k = grads(n), min(n, 6)
        out[n] = [f"{a}.{b}" for a in ref for b in ref[a]
                  if not torch.equal(ref[a][b][:k], got[a][b][:k])]
    return out


if __name__ == "__main__":
    main()
