"""Host-side multi-partner learning classes (port of
`mplc_tpu/mpl/approaches.py`): fedavg, the seq family, lflip and the
single-partner class.

`Cls(scenario, **kwargs).fit()` stages the scenario's data on its device,
trains the grand coalition through `MplTrainer` and fills the `History`
(for lflip, its per-epoch theta too). The kwargs are those of the JAX
package's whitelist (`ALLOWED_PARAMETERS`); others are ignored, as there.
With `is_save_data` the fit writes the final weights to
`<save_folder>/model/<dataset>_final_weights.npz` and the history's pickle
and graphs beside them. With saved weights (`init_model_from` a weights
file, `use_saved_weights`) the fit starts from that file.

Weights files have the JAX package's format (`save_params_npz`): a
`treedef` entry naming the tree, then `leaf_<i>` in JAX's flattening
order, dict keys sorted at every level. The port's parameter dicts have the
JAX package's keys, so a file saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .. import constants
from ..data.partition import StackedPartners, stack_eval_set
from ..obs import trace as obs_trace
from .engine import EvalSet, MplTrainer, TrainConfig
from .history import History

ALLOWED_PARAMETERS = ("partners_list",
                      "epoch_count",
                      "minibatch_count",
                      "dataset",
                      "aggregation_method",
                      "is_early_stopping",
                      "is_save_data",
                      "save_folder",
                      "init_model_from",
                      "use_saved_weights")


def _eval_chunk_size(n: int) -> int:
    return int(min(constants.EVAL_CHUNK_SIZE, max(128, 1 << (max(n - 1, 1)).bit_length())))


def stage_eval_set(x, y, label_dim: int, device) -> EvalSet:
    """An eval set chunked as the JAX package chunks it."""
    return EvalSet(*stack_eval_set(x, y, label_dim, _eval_chunk_size(len(x)), device))


def _flatten(tree: dict) -> list:
    """The leaves of a nested dict in JAX's `tree_flatten` order."""
    return [leaf for k in sorted(tree)
            for leaf in (_flatten(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _treedef(tree: dict) -> str:
    """`str(jax.tree_util.tree_structure(tree))` of a nested dict."""
    def spell(t):
        return "{" + ", ".join(f"{k!r}: {spell(t[k]) if isinstance(t[k], dict) else '*'}"
                               for k in sorted(t)) + "}"
    return f"PyTreeDef({spell(tree)})"


def save_params_npz(path, params: dict) -> None:
    """`params` (a nested dict of tensors) as the JAX package's weights file."""
    leaves = [t.detach().cpu().numpy() for t in _flatten(params)]
    np.savez(path, treedef=np.array(_treedef(params)),
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})


def load_params_npz(path, like_params: dict, device) -> dict:
    """A weights file of either package in the structure of `like_params`:
    float32 tensors on `device`. Read without pickle; a file whose leaves
    do not match `like_params` in number or shape raises ValueError."""
    with np.load(str(path)) as f:
        leaves = [f[f"leaf_{i}"] for i in range(len(f.files) - 1)]
    like = _flatten(like_params)
    if [tuple(a.shape) for a in leaves] != [tuple(t.shape) for t in like]:
        raise ValueError(f"the weights in {path} do not fit the model: leaves "
                         f"{[a.shape for a in leaves]}, expected "
                         f"{[tuple(t.shape) for t in like]}")
    it = iter(leaves)

    def fill(tree):
        return {k: fill(tree[k]) if isinstance(tree[k], dict)
                else torch.from_numpy(next(it)).to(device, torch.float32)
                for k in sorted(tree)}
    return fill(like_params)


class MultiPartnerLearning:
    """Base class: owns data staging, the trainer and `fit()`."""

    approach_key = "fedavg"

    def __init__(self, scenario, **kwargs):
        self.dataset = scenario.dataset
        self.partners_list = scenario.partners_list
        self.init_model_from = scenario.init_model_from
        self.use_saved_weights = scenario.use_saved_weights
        self.epoch_count = scenario.epoch_count
        self.minibatch_count = scenario.minibatch_count
        self.gradient_updates_per_pass_count = scenario.gradient_updates_per_pass_count
        self.is_early_stopping = scenario.is_early_stopping
        self.aggregation_method = scenario.aggregation_name
        self.is_save_data = False
        self.save_folder = scenario.save_folder
        self.compute_dtype = scenario.compute_dtype
        self.seed = scenario.seed
        self.__dict__.update((k, v) for k, v in kwargs.items() if k in ALLOWED_PARAMETERS)

        self.partners_list = sorted(self.partners_list, key=lambda p: p.id)
        self.device = scenario.device
        self.val_data = (self.dataset.x_val, self.dataset.y_val)
        self.test_data = (self.dataset.x_test, self.dataset.y_test)
        self.dataset_name = self.dataset.name
        self.model = self.dataset.model
        # the epochs the fit ran (early stopping included) and the
        # reference's minibatch counter, which no approach advances
        self.epoch_index = 0
        self.minibatch_index = 0
        self.cfg = TrainConfig(
            approach=self.approach_key,
            aggregator=self.aggregation_method,
            epoch_count=self.epoch_count,
            minibatch_count=self.minibatch_count,
            gradient_updates_per_pass=self.gradient_updates_per_pass_count,
            is_early_stopping=self.is_early_stopping,
            compute_dtype=self.compute_dtype,
        )
        self.trainer = MplTrainer(self.model, self.cfg)
        self.history = History([p.id for p in self.partners_list],
                               self.epoch_count, self.minibatch_count,
                               save_folder=self.save_folder)
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

    def _fit_start(self):
        """(generators, initial params, streams) of the fit: one generator
        seeded `seed` draws the initial params and every epoch's streams
        (None, None). The parity tests substitute the JAX package's initial
        params and streams ([1, E, ...]) here."""
        return [torch.Generator().manual_seed(int(self.seed))], None, None

    def _saved_weights(self, generator) -> dict:
        """The weights file `init_model_from`, leaves [1, ...] on the
        device. The generator draws (and drops) the initial params a fit
        from random weights would, so the epochs' streams are that fit's."""
        template = self.model.init(generator)
        params = load_params_npz(self.init_model_from, template, self.device)
        return {g: {k: t[None] for k, t in d.items()} for g, d in params.items()}

    def fit(self):
        # the fit span is the timer: learning_computation_time is its
        # duration, and the span lands in the trace and the sweep report
        with obs_trace.span("mpl.fit", approach=self.approach_key,
                            partners=self.partners_count,
                            epochs=self.epoch_count) as sp:
            self._fit()
        self.learning_computation_time = sp.duration
        return self.history.score

    def _fit(self):
        stacked, val, test = self._stage()
        generators, init_params, streams = self._fit_start()
        if self.use_saved_weights:
            init_params = self._saved_weights(generators[0])
        state = self.trainer.init_state(generators, self.partners_count, self.device,
                                        init_params=init_params)
        coal_mask = torch.ones(1, self.partners_count, device=self.device)
        self.trainer.epoch_chunk(state, stacked, val, coal_mask, generators,
                                 self.epoch_count, streams_all=streams)
        _, test_acc = self.trainer.finalize(state, test)
        run = state.row(0)
        self.model_params = run.params
        self.epoch_index = state.epoch
        self.history.fill_from_state(
            [p.id for p in self.partners_list], run.val_loss_h,
            run.val_acc_h, run.partner_h, run.nb_epochs_done,
            float(test_acc[0]))
        if run.theta_h is not None:
            self.history.fill_theta(run.theta_h, run.nb_epochs_done)
        if self.is_save_data:
            self.save_final_model()
            self.history.save_data()

    def save_final_model(self):
        if self.save_folder is None or self.model_params is None:
            return
        model_folder = Path(self.save_folder) / "model"
        model_folder.mkdir(parents=True, exist_ok=True)
        save_params_npz(model_folder / f"{self.dataset_name}_final_weights.npz",
                        self.model_params)

    def eval_and_log_final_model__test_perf(self):
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

    def __init__(self, scenario, epsilon: float = 0.01, **kwargs):
        super().__init__(scenario, **kwargs)
        if self.model.loss_kind != "categorical":
            raise ValueError("LFlip requires a categorical model")
        self.epsilon = epsilon
        self.cfg = dataclasses.replace(self.cfg, lflip_epsilon=epsilon)
        self.trainer = MplTrainer(self.model, self.cfg)


class SinglePartnerLearning(MultiPartnerLearning):
    """One partner's fit on the single-partner trainer. `partners_list` is
    pinned to `[partner]` before staging, so only this partner's rows are
    staged ([1, n_own, ...]), never the scenario's partners padded to the
    largest."""

    approach_key = "single"

    def __init__(self, scenario, partner=None, **kwargs):
        if partner is not None:
            if isinstance(partner, (list, np.ndarray)):
                raise ValueError("More than one partner is provided")
            kwargs["partners_list"] = [partner]
        super().__init__(scenario, **kwargs)
        if self.partners_count != 1:
            raise ValueError("SinglePartnerLearning requires exactly one partner")
        self.partner = self.partners_list[0]


MULTI_PARTNER_LEARNING_APPROACHES = {
    "fedavg": FederatedAverageLearning,
    "seq-pure": SequentialLearning,
    "seq-with-final-agg": SequentialWithFinalAggLearning,
    "seqavg": SequentialAverageLearning,
    "lflip": MplLabelFlip,
}
