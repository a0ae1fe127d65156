"""Digests of default-mode runs on the CPU, to show that a change keeps
their bits: the Titanic 3-partner sweep's v(S), and for the MNIST CNN and
the CIFAR10 CNN (synthetic, scale 0.01, 3 partners, one epoch of 2
minibatches of 2 steps) the recording's final params and the exact
reconstructed v(S) (which run the evaluation's chunking).

Run it from the root of two checkouts and compare the lines:

    python3 -m mplc_tpu_torch.obs.cpu_digests
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from ..contrib.contributivity import Contributivity
from ..contrib.shapley import powerset_order
from ..data.datasets import load_cifar10, load_mnist, load_titanic
from ..scenario import Scenario

GAME = dict(is_dry_run=True, minibatch_count=2, gradient_updates_per_pass_count=2,
            is_early_stopping=False, seed=0, device="cpu")


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    torch.set_num_threads(4)
    out = {}
    sc = Scenario(3, [0.2, 0.3, 0.5], dataset=load_titanic(), epoch_count=2,
                  methods=["Shapley values"], **GAME)
    sc.run()
    out["titanic sweep"] = digest([sc._charac_engine.charac_fct_values[s]
                                   for s in powerset_order(3)])
    for name, ds in (("mnist", load_mnist(scale=0.01)), ("cifar10", load_cifar10(scale=0.01))):
        sc = Scenario(3, [0.2, 0.3, 0.5], dataset=ds, epoch_count=1, **GAME)
        sc.instantiate_scenario_partners()
        sc.split_data()
        c = Contributivity(sc)
        c.exact_reconstructed()
        recon = c._reconstructor()
        p = recon.recorded.final_params
        out[f"{name} recording"] = digest(*[p[g][k].numpy() for g in p for k in p[g]])
        out[f"{name} exact recon values"] = digest([recon.values[s] for s in powerset_order(3)])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
