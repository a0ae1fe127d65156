"""The characteristic-function engine, slim (port of the staging and
coalition helpers of `mplc_tpu/contrib/engine.py`).

It stages the scenario's data once on the scenario's device (stacked
partners, val and test sets), derives the coalition-training config, and
gives each coalition its mask and its own random stream. The retraining
coalition sweep (`evaluate`) is not ported yet; the retrain-free path
(contrib/reconstruct.py) runs on the staged data.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..data.partition import StackedPartners
from ..mpl.approaches import stage_eval_set
from ..mpl.engine import MplTrainer, TrainConfig


def _bucket_size(n: int, n_dev: int, cap_per_dev: int) -> int:
    """Smallest power-of-two multiple of n_dev that fits n, capped."""
    cap = n_dev * cap_per_dev
    b = n_dev
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


class CharacteristicEngine:
    """Staged data + coalition helpers shared by a scenario's estimators."""

    def __init__(self, scenario):
        self.scenario = scenario
        self.partners_list = sorted(scenario.partners_list, key=lambda p: p.id)
        self.partners_count = len(self.partners_list)
        self.model = scenario.dataset.model
        self.seed = scenario.seed
        self.device = scenario.device
        # partner fault plans are not ported: no partner is ever dropped
        self._forever_dropped = frozenset()

        label_dim = self.model.label_dim()
        ds = scenario.dataset
        self.stacked = StackedPartners.build(self.partners_list, label_dim, self.device)
        self.val = stage_eval_set(ds.x_val, ds.y_val, label_dim, self.device)
        self.test = stage_eval_set(ds.x_test, ds.y_test, label_dim, self.device)

        self._multi_cfg = TrainConfig(
            approach=scenario.multi_partner_learning_approach_key,
            aggregator=scenario.aggregation_name,
            epoch_count=scenario.epoch_count,
            minibatch_count=scenario.minibatch_count,
            gradient_updates_per_pass=scenario.gradient_updates_per_pass_count,
            # with epoch_count <= patience the stop rule can never fire
            is_early_stopping=scenario.epoch_count > constants.PATIENCE,
            record_partner_val=False,
            record_val_history=False,
        )
        self.trainer = MplTrainer(self.model, self._multi_cfg)

    def evaluate(self, subsets):
        raise NotImplementedError(
            "retrained coalition values are not ported yet (ROADMAP.md "
            "queue 1, the retraining exact-Shapley sweep); the retrain-free "
            "estimators (GTG-Shapley, exact_reconstructed) run")

    def coalition_generator(self, subset: tuple) -> torch.Generator:
        """The coalition's own CPU random stream, independent of batch
        composition: seeded from (seed, the membership bitmask's 32-bit
        words). The JAX package's threefry streams are not reproduced."""
        bits = 0
        for i in subset:
            bits |= 1 << int(i)
        words = []
        while True:
            words.append(bits & 0xFFFFFFFF)
            bits >>= 32
            if not bits:
                break
        ss = np.random.SeedSequence([int(self.seed), *words])
        return torch.Generator().manual_seed(int(ss.generate_state(1, np.uint64)[0]))

    def _coalition_arrays(self, subsets: list[tuple]) -> np.ndarray:
        """[N, P] float32 membership masks of every subset (one scatter)."""
        n = len(subsets)
        lens = np.fromiter((len(s) for s in subsets), np.intp, n)
        rows = np.repeat(np.arange(n), lens)
        members = np.fromiter((int(i) for s in subsets for i in s), np.int64,
                              int(lens.sum()))
        coal = np.zeros((n, self.partners_count), np.float32)
        coal[rows, members] = 1.0
        return coal

    def _effective_subset(self, subset: tuple) -> tuple:
        """The coalition's membership minus forever-dropped partners."""
        return tuple(i for i in subset if i not in self._forever_dropped)
