"""Which gradient-call widths give a model the same gradient bits on the
card, and what a call of each width costs: the measurement behind each
model's `grad_call_width`.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m mplc_tpu_torch.obs.width_parity [--models mnist_cnn,...] [--cost-only]

The trainer computes a step's gradients of N models (coalitions x partner
slots) in vmapped calls, and on the card cuDNN picks a convolution's
backward algorithm by how many models a call holds, so a model's gradient
bits can depend on the call's width; the coalition engine's calls all
hold one width a model for that reason. The classes show where widths
part, and `position_dependent` checks what that rule rests on. For each model of the BASELINE
configs (the MNIST, CIFAR10 and ESC50 CNNs, the IMDB Conv1D model and
Titanic's logistic regression), on real rows of the scenario that
`chip_smoke.py` trains it on and at that scenario's step rows (the multi
trainer's and the single trainer's), one gradient call of N models is made
for every N in PROBE_WIDTHS (1-160), model j starting from the
(j mod 8)-th of 8 initial parameter sets, under the card's deterministic
mode (`utils.resolve_device`). Two widths agree when every model they
share has bit-equal gradients in every leaf; the widths fall into classes
of agreement (printed as runs [lo, hi]). Within one call, models that share an initial parameter set
must get equal gradients (`position_dependent` lists the widths where
they do not). The test accuracy of a call's first model through
`evaluate_models` at each batch width 1-16 is compared too
(`eval_classes`).

The cost (`cost`): a gradient call of N models at the multi trainer's
rows, for every N in COST_WIDTHS, timed as REPEATS calls queued back to
back between CUDA events (the engine queues a batch's calls the same
way), so a call takes whichever is longer, its host enqueue or its card
work. `call_width` is the M whose worst step costs least against the
step's own one call: over every N in COST_WIDTHS, a step of N models in
ceil(N / M) calls of M takes ceil(N / M) * t(M) against t(N), and M
minimizes the largest of those ratios (narrow steps pay for padding,
wide ones for extra calls). It prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import torch

from .. import constants
from ..data.datasets import load_cifar10, load_esc50, load_imdb, load_mnist, load_titanic
from ..mpl.approaches import stage_eval_set
from ..mpl.engine import MplTrainer, TrainConfig
from ..scenario import Scenario
from ..utils import resolve_device

# every call width the engine makes at up to 10 partners (16 coalitions x
# 10 slots) and the batch widths an evaluation sees
PROBE_WIDTHS = tuple(range(1, 161))
EVAL_WIDTHS = tuple(range(1, 17))
# distinct initial parameter sets a call cycles through
INITS = 8
# the call widths the cost is timed at, and the calls timed a width
COST_WIDTHS = (1, 2, 4, 6, 8, 12, 16, 20, 24, 32, 40, 48, 64, 96, 128, 160)
REPEATS = 5


def _games() -> dict:
    """{model name: (dataset loader, partner amounts, minibatch count,
    gradient updates a pass)}: `chip_smoke.py`'s scenario of each model."""
    def split(p):
        total = sum(range(1, p + 1))
        return [(i + 1) / total for i in range(p)]
    return {
        "mnist_cnn": (lambda: load_mnist(scale=0.2, noise=0.75), split(5), 10, 8),
        "cifar10_cnn": (lambda: load_cifar10(scale=0.2, noise=0.1), split(5), 10, 8),
        "imdb_conv1d": (lambda: load_imdb(scale=1.0), split(4), 10, 8),
        "esc50_cnn": (lambda: load_esc50(scale=1.0), [0.4, 0.3, 0.3], 10, 8),
        "titanic_logreg": (load_titanic, split(5), 2, 2),
    }


def step_rows(sizes, minibatch_count: int, gup: int) -> dict:
    """{"multi": rows of a multi-partner step, "single": rows of a single
    trainer's step}, from the partners' training sizes (the trainer's
    `sb_cap`s at step width 1)."""
    n_max = max(sizes)
    mb_cap = max(n_max // minibatch_count, 1)
    return {"multi": -(-mb_cap // gup),
            "single": max(-(-n_max // (minibatch_count * gup)), 1)}


def _digest(grads: dict, j: int) -> str:
    h = hashlib.sha1()
    for g in sorted(grads):
        for k in sorted(grads[g]):
            h.update(grads[g][k][j].detach().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def _classes(sig: dict) -> list:
    """The widths grouped by agreement: widths n1 and n2 agree when the
    models they share (the first min(n1, n2, INITS)) have equal digests."""
    out: list[list] = []
    for n in sorted(sig):
        for cls in out:
            m = cls[0]
            k = min(n, m, INITS)
            if sig[n][:k] == sig[m][:k]:
                cls.append(n)
                break
        else:
            out.append([n])
    return out


def spans(widths: list) -> list:
    """Sorted widths as [lo, hi] runs of consecutive ones."""
    out: list[list] = []
    for n in sorted(widths):
        if out and n == out[-1][1] + 1:
            out[-1][1] = n
        else:
            out.append([n, n])
    return out


def _setup(name: str, device):
    """(model, its scenario's largest partner, {trainer: step rows}, the
    test set, stacked(n): n models' params cycling through INITS sets)."""
    loader, amounts, mbc, gup = _games()[name]
    t0 = time.perf_counter()
    sc = Scenario(len(amounts), amounts, is_dry_run=True, dataset=loader(),
                  epoch_count=1, minibatch_count=mbc,
                  gradient_updates_per_pass_count=gup, is_early_stopping=False,
                  seed=0, device=device)
    sc.instantiate_scenario_partners()
    sc.split_data()
    model = sc.dataset.model
    tr = MplTrainer(model, TrainConfig(epoch_count=1, minibatch_count=1,
                                       gradient_updates_per_pass=1))
    g = torch.Generator().manual_seed(1)
    inits = [model.init(g) for _ in range(INITS)]
    label_dim = model.label_dim()
    largest = max(sc.partners_list, key=lambda p: len(p.x_train))
    rows_by_trainer = step_rows([len(p.x_train) for p in sc.partners_list], mbc, gup)
    test = stage_eval_set(sc.dataset.x_test, sc.dataset.y_test, label_dim, device)

    def stacked(n):
        trees = [inits[i % INITS] for i in range(n)]
        return {k: {q: torch.stack([t[k][q] for t in trees]).to(device)
                    for q in inits[0][k]} for k in inits[0]}
    return tr, largest, rows_by_trainer, test, stacked


def _call_args(tr, largest, rows: int, stacked, n: int, device) -> tuple:
    """A gradient call's arguments: n models on the partner's first rows."""
    model = tr.model
    x = torch.as_tensor(largest.x_train[:rows]).to(device)
    if not torch.is_floating_point(x):
        x = x.to(torch.int32)
    y = torch.as_tensor(largest.y_train[:rows], dtype=torch.float32).to(device)
    y = y.reshape(rows, model.label_dim())
    m = torch.ones(rows, device=device)
    drop = tuple(torch.ones((n, rows) + s, dtype=torch.bool, device=device)
                 for _, s in model.dropout)
    return (stacked(n), x.expand((n,) + x.shape), y.expand((n,) + y.shape),
            m.expand(n, rows), drop)


def probe(name: str, device, widths=PROBE_WIDTHS) -> dict:
    """One model's gradient and evaluation classes at its scenario's rows."""
    t0 = time.perf_counter()
    tr, largest, rows_by_trainer, test, stacked = _setup(name, device)
    out = {"model": name, "rows": rows_by_trainer}
    for trainer, rows in sorted(rows_by_trainer.items()):
        sig, pos = {}, []
        for n in widths:
            grads = tr._grads(*_call_args(tr, largest, rows, stacked, n, device))[0]
            d = [_digest(grads, j) for j in range(min(n, 2 * INITS))]
            sig[n] = d[:INITS]
            if any(d[j] != d[j - INITS] for j in range(INITS, len(d))):
                pos.append(n)
        classes = _classes(sig)
        out[trainer] = {"classes": [spans(c) for c in classes], "position_dependent": pos}
    accs = {}
    for n in EVAL_WIDTHS:
        accs[n] = [float(tr.evaluate_models(stacked(n), test)[1][0])]
    out["eval_classes"] = [spans(c) for c in _classes(accs)]
    out["seconds"] = time.perf_counter() - t0
    return out


def cost(name: str, device, widths=COST_WIDTHS) -> dict:
    """One model's gradient-call time at each width (ms, at the multi
    trainer's rows) and the `call_width` it gives."""
    tr, largest, rows_by_trainer, _, stacked = _setup(name, device)
    rows = rows_by_trainer["multi"]
    ms = {}
    for n in widths:
        args = _call_args(tr, largest, rows, stacked, n, device)
        tr._grads(*args)                       # warm-up: cuDNN plans, caches
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPEATS):
            tr._grads(*args)
        stop.record()
        stop.synchronize()
        ms[n] = start.elapsed_time(stop) / REPEATS
    return {"model": name, "rows": rows, "ms": ms, "call_width": call_width(ms)}


def call_width(ms: dict) -> int:
    """The call width M whose worst step, ceil(N / M) calls of M against
    one call of N, is least slowed (`ms`: a call's time by width)."""
    def worst(M):
        return max(-(-n // M) * ms[M] / ms[n] for n in ms)
    return min(ms, key=lambda M: (worst(M), M))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default=",".join(_games()),
                    help="comma-separated model names")
    ap.add_argument("--cost-only", action="store_true",
                    help="time the calls only, without the classes")
    args = ap.parse_args()
    device = resolve_device("cuda")
    names = args.models.split(",")
    result = {"device": torch.cuda.get_device_name(0),
              "eval_rows_in_flight": constants.eval_rows_in_flight(0),
              "cost": [cost(name, device) for name in names]}
    if not args.cost_only:
        result["models"] = [probe(name, device) for name in names]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
