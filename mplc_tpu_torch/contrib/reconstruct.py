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

Precision: the evaluator answers for the engine's frozen mode. Under fp32
and mixed it reconstructs in fp32 (K1); under bf16 it keeps the flattened
stream in bf16 only and reconstructs through K1-bf16 (fp32 accumulation),
casting the models to bf16. Models are evaluated in the trainer's
`cfg.dtype`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants
from ..mpl.engine import MplTrainer
from ..ops import recon_kernel
from .engine import _bucket_size


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
    state = trainer.init_state(generators, P, engine.device)
    init_params = {g: {k: t[0].clone() for k, t in d.items()}
                   for g, d in state.params.items()}
    trainer.epoch_chunk(state, engine.stacked, engine.val, mask, generators,
                        cfg.epoch_count)
    run = state.row(0)
    epochs = run.nb_epochs_done
    mem = sum(t.numel() * t.element_size()
              for d in run.upd_h.values() for t in d.values())
    mem += run.w_h.numel() * run.w_h.element_size()
    return RecordedRun(init_params=init_params, deltas=run.upd_h,
                       weights=run.w_h,
                       rounds=cfg.epoch_count * cfg.minibatch_count,
                       partners_count=P, epochs_done=epochs,
                       training_passes=epochs * cfg.minibatch_count * P,
                       memory_bytes=mem, final_params=run.params)


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
        """Batched memoized reconstructed v(S); values in input order."""
        keys = [tuple(sorted(int(i) for i in s)) for s in subsets]
        missing = [k for k in dict.fromkeys(keys) if k not in self.values]
        for i in range(0, len(missing), constants.RECON_BATCH):
            self._run_batch(missing[i:i + constants.RECON_BATCH])
        return np.array([self.values[k] for k in keys])

    def _run_batch(self, group: list[tuple]) -> None:
        """One batch, padded to a power-of-two width with copies of its
        first coalition (so kernel shapes repeat across batches)."""
        b = _bucket_size(len(group), 1, constants.RECON_BATCH)
        masks = self.engine._coalition_arrays(group)
        sel = np.zeros(b, np.intp)
        sel[:len(group)] = np.arange(len(group))
        accs = self._apply(torch.from_numpy(masks[sel]).to(self.engine.device))
        for s, acc in zip(group, accs[:len(group)].tolist()):
            self.values[s] = float(acc)
        self.reconstructions += len(group)
