"""The grand coalition's learning curve: how far a fit of bench's training
gets in a given number of epochs on a synthetic dataset. `chip_smoke.py`
chose its CIFAR10 noise and the v(N) thresholds of `[cifar10]`, `[imdb]`
and `[esc50]` from these curves.

Run from the root of a checkout (on the CPU for a small scale):

    python3 -m mplc_tpu_torch.obs.learning_curve --device cpu --scale 0.05 \\
        --test-rows 500 --noise 0.45 --epochs 8
    python3 -m mplc_tpu_torch.obs.learning_curve --dataset imdb --device cpu \\
        --scale 0.1 --partners 4
    python3 -m mplc_tpu_torch.obs.learning_curve --dataset esc50 --device cpu \\
        --scale 1.0 --amounts 0.4,0.3,0.3

CIFAR10 (the default) is synthetic CIFAR10 (`load_cifar10`) whose test set
is held-out training rows (`with_held_out_test`: the loader's own test set
is drawn from other class prototypes); IMDB and ESC50 keep their loaders'
test sets, which follow the training rows' classes. The training is
bench's (fedavg, data-volume, minibatch 10, gup 8, early stopping off),
partner i holding (i+1)/sum of the data unless `--amounts` says otherwise,
seed 0. It prints one JSON line: the global model's val accuracy at the
start of each epoch's last round, the test accuracy after the fit and the
fit's seconds.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..data.datasets import load_cifar10, load_esc50, load_imdb, with_held_out_test
from ..scenario import Scenario


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="cifar10", choices=("cifar10", "imdb", "esc50"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--test-rows", type=int, default=2000, help="CIFAR10 only")
    ap.add_argument("--noise", type=float, default=0.45, help="CIFAR10 only")
    ap.add_argument("--amounts", default=None,
                    help="comma-separated partner shares (default (i+1)/sum)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--partners", type=int, default=5)
    ap.add_argument("--threads", type=int, default=4, help="CPU threads")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.dataset == "cifar10":
        dataset = with_held_out_test(load_cifar10(scale=args.scale, noise=args.noise),
                                     args.test_rows)
    else:
        dataset = (load_imdb if args.dataset == "imdb" else load_esc50)(scale=args.scale)
    if args.amounts:
        amounts = [float(a) for a in args.amounts.split(",")]
    else:
        total = sum(range(1, args.partners + 1))
        amounts = [(i + 1) / total for i in range(args.partners)]
    sc = Scenario(len(amounts), amounts, is_dry_run=True, dataset=dataset, epoch_count=args.epochs,
                  minibatch_count=10, gradient_updates_per_pass_count=8,
                  is_early_stopping=False, seed=0, device=args.device)
    sc.instantiate_scenario_partners()
    sc.split_data()
    mpl = sc.multi_partner_learning_approach(sc)
    t0 = time.perf_counter()
    score = mpl.fit()
    val = np.asarray(mpl.history.history["mpl_model"]["val_accuracy"])
    print(json.dumps({
        "dataset": args.dataset, "noise": args.noise if args.dataset == "cifar10" else None,
        "scale": args.scale, "epochs": args.epochs, "amounts": amounts,
        "train_rows": len(dataset.x_train), "test_rows": len(dataset.x_test),
        "val_accuracy_by_epoch": [round(float(v), 4) for v in val[:, -1]],
        "test_accuracy": float(score), "seconds": round(time.perf_counter() - t0, 2),
        "device": args.device}))


if __name__ == "__main__":
    main()
