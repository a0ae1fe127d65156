"""The characteristic-function engine (port of `mplc_tpu/contrib/engine.py`:
staging, the coalition helpers and the masked retraining sweep).

It stages the scenario's data once on the scenario's device (stacked
partners, val and test sets), derives the coalition-training configs, and
gives each coalition its mask and its own random stream. `evaluate` is the
batched, memoized v(S) = the test accuracy of a model trained on S alone:
single-partner coalitions train through the single trainer, the others
through masked FedAvg, up to MAX_COALITIONS_PER_DEVICE_BATCH coalitions a
batch. The retrain-free path (contrib/reconstruct.py) runs on the same
staged data. Slot execution, the coalition cache, the fault ladder, the
program bank and batch pipelining are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import time

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


class BatchedTrainerPipeline:
    """init -> epoch chunk -> finalize over a batch of coalitions, one
    trainer (the JAX package's vmapped pipeline, synchronous)."""

    def __init__(self, trainer: MplTrainer, partners_count: int):
        self.trainer = trainer
        self.partners_count = partners_count

    def scores(self, masks: torch.Tensor, generators, stacked, val, test,
               init_params: dict | None = None,
               streams_all: torch.Tensor | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(test accuracies, epochs trained) of the coalitions `masks`
        [B, P], each trained from its generator's stream, or from injected
        initial params ([B, ...] leaves) and permutations ([B, E, ...])."""
        tr = self.trainer
        state = tr.init_state(generators, self.partners_count, masks.device,
                              init_params)
        tr.epoch_chunk(state, stacked, val, masks, generators,
                       tr.cfg.epoch_count, streams_all)
        _, accs = tr.finalize(state, test)
        return accs.cpu().numpy(), state.nb_epochs_done.cpu().numpy()


class CharacteristicEngine:
    """Staged data, coalition helpers and the memoized retraining sweep
    shared by a scenario's estimators."""

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
            # the reference trains coalitions with early stopping on, but
            # with epoch_count <= patience the stop rule can never fire
            is_early_stopping=scenario.epoch_count > constants.PATIENCE,
            record_partner_val=False,
            record_val_history=False,
        )
        self.trainer = MplTrainer(self.model, self._multi_cfg)
        self.multi_pipe = BatchedTrainerPipeline(self.trainer, self.partners_count)
        self.single_pipe = BatchedTrainerPipeline(
            MplTrainer(self.model, dataclasses.replace(self._multi_cfg, approach="single")),
            self.partners_count)

        self.charac_fct_values: dict[tuple, float] = {(): 0.0}
        self.increments_values = [dict() for _ in range(self.partners_count)]
        self.first_charac_fct_calls_count = 0
        # one entry per trained batch: kind, width, coalitions, seconds
        self.batch_log: list[dict] = []

    # ------------------------------------------------------------------
    # coalition helpers
    # ------------------------------------------------------------------

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

    def _batch_start(self, subsets: list[tuple], single: bool):
        """(generators, initial params, permutations) of a batch's
        coalitions: each coalition's own stream, from which the trainer
        draws both (None, None). The parity tests substitute the JAX
        package's initial params and permutations here."""
        return [self.coalition_generator(s) for s in subsets], None, None

    # ------------------------------------------------------------------
    # the memoized sweep
    # ------------------------------------------------------------------

    def _incomplete(self, subset: tuple) -> bool:
        """True when the subset still needs device work (no value yet)."""
        return subset not in self.charac_fct_values

    def _store(self, subset: tuple, value: float) -> None:
        self.charac_fct_values[subset] = value
        self.first_charac_fct_calls_count += 1
        # marginal-increment bookkeeping (reference contributivity.py:116-134)
        sset = set(subset)
        for i in range(self.partners_count):
            if i in sset:
                without = tuple(sorted(sset - {i}))
                if without in self.charac_fct_values:
                    self.increments_values[i][without] = \
                        value - self.charac_fct_values[without]
            else:
                with_i = tuple(sorted(sset | {i}))
                if with_i in self.charac_fct_values:
                    self.increments_values[i][subset] = \
                        self.charac_fct_values[with_i] - value

    def _run_batch(self, subsets: list[tuple], pipe: BatchedTrainerPipeline) -> None:
        """Train and value `subsets` on `pipe`, in batches of one width for
        the whole call: the tail is padded with copies of its batch's first
        coalition, whose results are dropped."""
        cap = constants.MAX_COALITIONS_PER_DEVICE_BATCH
        b = _bucket_size(min(len(subsets), cap), 1, cap)
        coal_all = self._coalition_arrays(subsets)
        kind = "single" if pipe is self.single_pipe else "multi"
        for i in range(0, len(subsets), b):
            group = subsets[i:i + b]
            sel = np.full(b, i, np.intp)
            sel[:len(group)] = np.arange(i, i + len(group))
            t0 = time.perf_counter()
            generators, init_params, streams = self._batch_start(
                [subsets[j] for j in sel], kind == "single")
            masks = torch.from_numpy(coal_all[sel]).to(self.device)
            accs, _ = pipe.scores(masks, generators, self.stacked, self.val,
                                  self.test, init_params, streams)
            self.batch_log.append({"kind": kind, "width": b, "coalitions": len(group),
                                   "seconds": time.perf_counter() - t0})
            for s, acc in zip(group, accs[:len(group)]):
                self._store(s, float(acc))

    def evaluate(self, subsets) -> np.ndarray:
        """Batched memoized v(S) for a list of subsets (any iterables of
        partner indices). Returns values in input order."""
        keys = [tuple(sorted(int(i) for i in s)) for s in subsets]
        missing = [k for k in dict.fromkeys(keys) if self._incomplete(k)]
        singles = [k for k in missing if len(k) == 1]
        multis = [k for k in missing if len(k) > 1]
        if singles:
            self._run_batch(singles, self.single_pipe)
        if multis:
            self._run_batch(multis, self.multi_pipe)
        return np.array([self.charac_fct_values[k] for k in keys])

    def not_twice_characteristic(self, subset) -> float:
        """Reference-API single-subset entry (contributivity.py:92-136)."""
        return float(self.evaluate([np.atleast_1d(np.asarray(subset, int))])[0])
