"""Host-side multi-partner learning classes (port of
`mplc_tpu/mpl/approaches.py`): fedavg, the seq family and lflip.

`Cls(scenario).fit()` stages the scenario's data on its device, trains the
grand coalition through `MplTrainer` and fills the `History` (for lflip,
its per-epoch theta too).
"""

from __future__ import annotations

import time

import torch

from .. import constants
from ..data.partition import StackedPartners, stack_eval_set
from .engine import EvalSet, MplTrainer, TrainConfig
from .history import History


def _eval_chunk_size(n: int) -> int:
    return int(min(constants.EVAL_CHUNK_SIZE, max(128, 1 << (max(n - 1, 1)).bit_length())))


def stage_eval_set(x, y, label_dim: int, device) -> EvalSet:
    """An eval set chunked as the JAX package chunks it."""
    return EvalSet(*stack_eval_set(x, y, label_dim, _eval_chunk_size(len(x)), device))


class MultiPartnerLearning:
    """Base class: owns data staging, the trainer and `fit()`."""

    approach_key = "fedavg"

    def __init__(self, scenario, **cfg):
        self.dataset = scenario.dataset
        self.partners_list = sorted(scenario.partners_list, key=lambda p: p.id)
        self.device = scenario.device
        self.epoch_count = scenario.epoch_count
        self.minibatch_count = scenario.minibatch_count
        self.seed = scenario.seed
        self.model = self.dataset.model
        self.cfg = TrainConfig(
            approach=self.approach_key,
            aggregator=scenario.aggregation_name,
            epoch_count=self.epoch_count,
            minibatch_count=self.minibatch_count,
            gradient_updates_per_pass=scenario.gradient_updates_per_pass_count,
            is_early_stopping=scenario.is_early_stopping,
            **cfg,
        )
        self.trainer = MplTrainer(self.model, self.cfg)
        self.history = History([p.id for p in self.partners_list],
                               self.epoch_count, self.minibatch_count)
        self.model_params = None
        self.learning_computation_time = 0.0

    @property
    def partners_count(self) -> int:
        return len(self.partners_list)

    def _stage(self):
        label_dim = self.model.label_dim()
        stacked = StackedPartners.build(self.partners_list, label_dim, self.device)
        val = stage_eval_set(self.dataset.x_val, self.dataset.y_val, label_dim,
                             self.device)
        test = stage_eval_set(self.dataset.x_test, self.dataset.y_test,
                              label_dim, self.device)
        return stacked, val, test

    def fit(self):
        t0 = time.perf_counter()
        stacked, val, test = self._stage()
        generators = [torch.Generator().manual_seed(self.seed)]
        state = self.trainer.init_state(generators, self.partners_count, self.device)
        coal_mask = torch.ones(1, self.partners_count, device=self.device)
        self.trainer.epoch_chunk(state, stacked, val, coal_mask, generators,
                                 self.epoch_count)
        _, test_acc = self.trainer.finalize(state, test)
        run = state.row(0)
        self.model_params = run.params
        self.history.fill_from_state(
            [p.id for p in self.partners_list], run.val_loss_h,
            run.val_acc_h, run.partner_h, run.nb_epochs_done,
            float(test_acc[0]))
        if run.theta_h is not None:
            self.history.fill_theta(run.theta_h, run.nb_epochs_done)
        self.learning_computation_time = time.perf_counter() - t0
        return self.history.score


class FederatedAverageLearning(MultiPartnerLearning):
    approach_key = "fedavg"

    def __init__(self, scenario, **cfg):
        super().__init__(scenario, **cfg)
        if self.partners_count == 1:
            raise ValueError("Only one partner is provided. Please use the "
                             "dedicated SinglePartnerLearning class")


class SequentialLearning(MultiPartnerLearning):
    approach_key = "seq-pure"

    def __init__(self, scenario, **cfg):
        super().__init__(scenario, **cfg)
        if self.partners_count == 1:
            raise ValueError("Only one partner is provided. Please use the "
                             "dedicated SinglePartnerLearning class")


class SequentialWithFinalAggLearning(SequentialLearning):
    approach_key = "seq-with-final-agg"


class SequentialAverageLearning(SequentialLearning):
    approach_key = "seqavg"


class MplLabelFlip(MultiPartnerLearning):
    approach_key = "lflip"

    def __init__(self, scenario, epsilon: float = 0.01):
        super().__init__(scenario, lflip_epsilon=epsilon)
        if self.model.loss_kind != "categorical":
            raise ValueError("LFlip requires a categorical model")
        self.epsilon = epsilon


MULTI_PARTNER_LEARNING_APPROACHES = {
    "fedavg": FederatedAverageLearning,
    "seq-pure": SequentialLearning,
    "seq-with-final-agg": SequentialWithFinalAggLearning,
    "seqavg": SequentialAverageLearning,
    "lflip": MplLabelFlip,
}
