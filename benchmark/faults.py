"""Faults planted in the program underneath a run, to show that the check
fails them (`readings.py --modes fault-...` on the card, `tests/` on the
CPU). Each is a context manager that patches the program's classes for
as long as it is open; none is used by the benchmark's own runs.

- `frozen`: every optimizer step returns its state unchanged;
- `halfbatch`: each training step leaves out the second half of its rows
  and takes the mean over the rest;
- `answer`: every coalition's value is altered where it is produced
  (0.3 below the computed accuracy);
- `uniform`: every aggregation weighs its members alike, not by data
  volume;
- `lr`: every optimizer step moves the parameters 1.25 times as far;
- `stale`: the recording keeps, in each round after the first, the
  previous round's deltas.

The cells run on one card, so the fault of a dropped exchange between
cards has no place here.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def frozen():
    from mplc_tpu_torch.models import core
    saved = {cls: cls.step for cls in (core.Adam, core.RMSprop)}

    def unchanged(step):
        def step_(self, params, grads, state):
            return params, step(self, params, grads, state)[1]
        return step_
    for cls, step in saved.items():
        cls.step = unchanged(step)
    try:
        yield
    finally:
        for cls, step in saved.items():
            cls.step = step


@contextlib.contextmanager
def halfbatch():
    from mplc_tpu_torch.mpl import engine
    orig = engine.MplTrainer._subbatch

    def subbatch(self, perms, sizes, mb_i, g, sb_cap):
        idx, valid = orig(self, perms, sizes, mb_i, g, sb_cap)
        kept = valid.cumsum(-1) <= (valid.sum(-1, keepdim=True) + 1) // 2
        return idx, valid * kept
    engine.MplTrainer._subbatch = subbatch
    try:
        yield
    finally:
        engine.MplTrainer._subbatch = orig


@contextlib.contextmanager
def answer():
    from mplc_tpu_torch.contrib import engine, reconstruct
    orig_d = engine.BatchedTrainerPipeline.dispatch_async
    orig_a = reconstruct.ReconstructionEvaluator._apply

    def dispatch_async(self, *a, **k):
        fetch = orig_d(self, *a, **k)

        def altered():
            accs, epochs = fetch()
            return accs - 0.3, epochs
        return altered

    def apply(self, masks):
        return orig_a(self, masks) - 0.3
    engine.BatchedTrainerPipeline.dispatch_async = dispatch_async
    reconstruct.ReconstructionEvaluator._apply = apply
    try:
        yield
    finally:
        engine.BatchedTrainerPipeline.dispatch_async = orig_d
        reconstruct.ReconstructionEvaluator._apply = orig_a


@contextlib.contextmanager
def uniform():
    from mplc_tpu_torch.mpl import engine
    orig = engine.aggregation_weights

    def weights(kind, *a, **k):
        return orig("uniform", *a, **k)
    engine.aggregation_weights = weights
    try:
        yield
    finally:
        engine.aggregation_weights = orig


@contextlib.contextmanager
def lr():
    from mplc_tpu_torch.models import core
    saved = {cls: cls.step for cls in (core.Adam, core.RMSprop)}

    def farther(step):
        def step_(self, params, grads, state):
            new, st = step(self, params, grads, state)
            return {g: {k: p + 1.25 * (new[g][k] - p) for k, p in d.items()}
                    for g, d in params.items()}, st
        return step_
    for cls, step in saved.items():
        cls.step = farther(step)
    try:
        yield
    finally:
        for cls, step in saved.items():
            cls.step = step


@contextlib.contextmanager
def stale():
    import dataclasses

    import torch
    from mplc_tpu_torch.contrib import reconstruct
    orig = reconstruct.record_updates

    def record(engine):
        rec = orig(engine)
        shifted = {g: {k: torch.cat([t[:1], t[:-1]]) for k, t in d.items()}
                   for g, d in rec.deltas.items()}
        return dataclasses.replace(rec, deltas=shifted)
    reconstruct.record_updates = record
    try:
        yield
    finally:
        reconstruct.record_updates = orig


FAULTS = {"frozen": frozen, "halfbatch": halfbatch, "answer": answer, "uniform": uniform,
          "lr": lr, "stale": stale}
