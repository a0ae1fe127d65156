"""Retrain-free coalition reconstruction (GTG-Shapley, arXiv:2109.02053;
port of `mplc_tpu/contrib/reconstruct.py`).

During ONE grand-coalition FedAvg run, every aggregation round's
per-partner parameter delta and weight are recorded; any coalition S's
model is then rebuilt by replaying the recorded rounds restricted to S,

    M_S^r = M_S^{r-1} + sum_{p in S} w~_p^r delta_p^r,
    w~ = the recorded weights renormalized over S,

which the fused contraction K1 (ops/recon_kernel.py) does for a whole batch
of coalitions in one pass. v(S) then costs an evaluation, not a training
run. Reconstructed values live in the evaluator's own memo.

Observability (the JAX package's names, `obs/trace.py`): the recording is
a `recon.record` span holding one `engine.dispatch` (recording=True) and
followed by its `engine.batch` event; `ReconstructionEvaluator.evaluate` is
an `engine.evaluate` span (mode=reconstruct) holding, for each batch, an
`engine.prep`, an `engine.dispatch` (where K1 launches) and an
`engine.harvest` (the host read of the accuracies, the batch's one sync),
then an eval-only `engine.batch` event.

Precision: the evaluator answers for the engine's frozen mode. Under fp32
and mixed it reconstructs in fp32 (K1); under bf16 it keeps the flattened
stream in bf16 only and reconstructs through K1-bf16 (fp32 accumulation),
casting the models to bf16. Models are evaluated in the trainer's
`cfg.dtype`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import constants
from ..mpl.engine import MplTrainer
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..ops import recon_kernel
from .engine import _bucket_size, _memo_counters


@dataclasses.dataclass
class RecordedRun:
    """One grand-coalition training's recorded update stream."""
    init_params: dict        # the run's initial global params
    deltas: dict             # leaves [R, P, ...]: per-round deltas
    weights: torch.Tensor    # [R, P] normalized aggregation weights
    rounds: int              # R = epoch_count x minibatch_count
    partners_count: int
    epochs_done: int | None      # epochs trained (None: foreign recording)
    training_passes: int | None  # partner passes paid (None: likewise)
    memory_bytes: int        # recorded-update memory footprint
    final_params: dict | None = None   # the run's final global params

    def describe(self) -> dict:
        return {"rounds": self.rounds, "partners": self.partners_count,
                "epochs": self.epochs_done,
                "training_passes": self.training_passes,
                "memory_bytes": self.memory_bytes}


def record_updates(engine) -> RecordedRun:
    """Train the grand coalition once with update recording on, through
    the engine's coalition-training config (its partner faults included:
    a dropped partner records exact-zero deltas and weights) and the grand
    coalition's own random stream (that of its effective membership), and
    return the recorded stream."""
    cfg = dataclasses.replace(engine._multi_cfg, record_updates=True)
    trainer = MplTrainer(engine.model, cfg)
    P = engine.partners_count
    full = tuple(range(P))
    eff = engine._effective_subset(full)
    if not eff:
        raise ValueError("every partner is dropped from epoch 1: there is no "
                         "grand-coalition run to record")
    generators = [engine.coalition_generator(eff)]
    mask = torch.from_numpy(engine._coalition_arrays([full])).to(engine.device)
    engine._batch_ordinal += 1
    rounds = cfg.epoch_count * cfg.minibatch_count
    span = obs_trace.start_span("recon.record", partners=P, rounds=rounds)
    t0 = time.perf_counter()
    try:
        with obs_trace.span("engine.dispatch", width=1, slot_count=None,
                            coalitions=1, padding=0, recording=True):
            state = trainer.init_state(generators, P, engine.device)
            init_params = {g: {k: t[0].clone() for k, t in d.items()}
                           for g, d in state.params.items()}
            trainer.epoch_chunk(state, engine.stacked, engine.val, mask, generators,
                                cfg.epoch_count)
    except BaseException:
        # dropped without emitting, so the caller's nesting stays intact
        span.cancel()
        raise
    run = state.row(0)
    epochs = run.nb_epochs_done
    mem = sum(t.numel() * t.element_size()
              for d in run.upd_h.values() for t in d.values())
    mem += run.w_h.numel() * run.w_h.element_size()
    rec = RecordedRun(init_params=init_params, deltas=run.upd_h,
                      weights=run.w_h, rounds=rounds,
                      partners_count=P, epochs_done=epochs,
                      training_passes=epochs * cfg.minibatch_count * P,
                      memory_bytes=mem, final_params=run.params)
    # the recording is training work: it owns every training counter of
    # the retrain-free path
    samples = epochs * int(engine._epoch_samples_multi[list(eff)].sum())
    engine._account_batch(time.perf_counter() - t0,
                          {"width": 1, "slot_count": None, "coalitions": 1, "padding": 0},
                          epochs, samples, rec.training_passes, recording=True)
    span.attrs.update(rec.describe())
    span.end()
    return rec


class ReconstructionEvaluator:
    """Memoizing, batching v(S) over reconstructed coalition models.

    The recorded stream is flattened once to K1's layout (init [Dp],
    deltas [K = R*P, Dp], rows zero-padded to a multiple of 8 values, in
    the precision's stream dtype); each batch of up
    to RECON_BATCH coalitions is one kernel launch followed by a vmapped
    evaluation of the batch's models on the test set. Values are
    row-independent, so the batch width never changes them."""

    def __init__(self, engine, recorded: RecordedRun | None = None):
        self.engine = engine
        # the engine's frozen precision: every memoized value answers for it
        self.precision = engine._multi_cfg.precision
        self.recorded = recorded if recorded is not None else record_updates(engine)
        self.values: dict[tuple, float] = {(): 0.0}
        self.reconstructions = 0
        rec = self.recorded
        R, P = rec.weights.shape
        self._init, self._d2, self._layout = recon_kernel.flatten_stream(
            rec.init_params, rec.deltas, R * P,
            recon_kernel.stream_dtype(self.precision))
        self._weights = rec.weights.float()

    def reconstruct(self, masks: torch.Tensor) -> torch.Tensor:
        """[B, Dp] flat parameters of the coalitions `masks` [B, P], in the
        evaluator's precision (the tail past the layout's D is zeros)."""
        return recon_kernel.reconstruct_flat(masks, self._init, self._d2,
                                             self._weights, self.precision)

    def _apply(self, masks: torch.Tensor) -> torch.Tensor:
        """Test accuracy of each reconstructed coalition model ([B])."""
        params = recon_kernel.unflatten(self.reconstruct(masks), self._layout)
        with torch.no_grad():
            return self.engine.trainer.evaluate_models(params, self.engine.test)[1]

    def evaluate(self, subsets) -> np.ndarray:
        """Batched memoized reconstructed v(S); values in input order. A
        coalition whose every member is dropped from epoch 1 is worth 0,
        as in the engine (the JAX evaluator's rule): its recorded weights
        are all zero, so a replay would score the untrained model."""
        eng = self.engine
        keys = [tuple(sorted(int(i) for i in s)) for s in subsets]
        unique = dict.fromkeys(keys)
        missing = [k for k in unique if k not in self.values]
        n_requested_missing = len(missing)
        if eng._forever_dropped:
            for k in [k for k in missing if not eng._effective_subset(k)]:
                self.values[k] = 0.0
            missing = [k for k in missing if eng._effective_subset(k)]
            obs_metrics.counter("engine.null_coalitions").inc(
                n_requested_missing - len(missing))
        method = _memo_counters(len(unique) - n_requested_missing, len(missing))
        with obs_trace.span("engine.evaluate", requested=len(unique),
                            missing=len(missing), mode="reconstruct",
                            method=method):
            for i in range(0, len(missing), constants.RECON_BATCH):
                self._run_batch(missing[i:i + constants.RECON_BATCH])
        return np.array([self.values[k] for k in keys])

    def _run_batch(self, group: list[tuple]) -> None:
        """One batch, padded to a power-of-two width with copies of its
        first coalition (so kernel shapes repeat across batches)."""
        eng = self.engine
        n = len(group)
        b = _bucket_size(n, 1, constants.RECON_BATCH)
        with obs_trace.span("engine.prep", coalitions=n, width=b, slot_count=None):
            masks = eng._coalition_arrays(group)
            sel = np.zeros(b, np.intp)
            sel[:n] = np.arange(n)
        eng._batch_ordinal += 1
        attrs = {"width": b, "slot_count": None, "coalitions": n, "padding": b - n}
        t0 = time.perf_counter()
        with obs_trace.span("engine.dispatch", **attrs, eval_only=True):
            accs = self._apply(torch.from_numpy(masks[sel]).to(eng.device))
        with obs_trace.span("engine.harvest", width=b, slot_count=None, coalitions=n):
            accs = accs[:n].tolist()
        for s, acc in zip(group, accs):
            self.values[s] = float(acc)
        self.reconstructions += n
        obs_metrics.counter("engine.batches").inc()
        obs_metrics.counter("engine.reconstructions").inc(n)
        obs_metrics.histogram("engine.pad_waste_fraction").observe((b - n) / b)
        # eval-only: no epochs, samples or partner passes
        obs_trace.event("engine.batch", dur=time.perf_counter() - t0,
                        ordinal=eng._batch_ordinal, **attrs, epochs=0, samples=0,
                        partner_passes=0, eval_only=True)
