"""Scenario: the orchestrator (port of `mplc_tpu/scenario.py`: the basic
split, the five learning approaches, the contributivity methods).

Same parameter names and `run()` sequence as the JAX package: dataset
selection, partner instantiation, basic data split, batch sizes, the
grand-coalition training, then the configured contributivity methods.
It runs on CUDA unless `device=` names another device (the tests pass
`device="cpu"`); see `utils.resolve_device`. Options of the JAX package
that are not ported yet raise NotImplementedError.

`corrupted_datasets` takes every corruption of `data.partner.CORRUPTION_KINDS`,
validated at construction; `data_corruption` then applies the partner
fault plan's noisy and glabel entries (MPLC_TORCH_PARTNER_FAULT_PLAN) and
keeps the parsed plan for the CharacteristicEngine.

Unless `is_dry_run`, the scenario writes into its own folder under
`experiment_path`: the coalition cache `coalition_cache.json`, saved after
every trained batch of a method and once after the methods. A sweep
resumes from a cache named by `contributivity_cache_from`.
"""

from __future__ import annotations

import datetime
import logging
import uuid
from pathlib import Path

from . import constants, faults
from .contrib.contributivity import Contributivity
from .data import datasets as dataset_module
from .data.partition import compute_batch_sizes, split_basic
from .data.partner import CORRUPTION_KINDS, Partner
from .mpl.approaches import MULTI_PARTNER_LEARNING_APPROACHES
from .ops.aggregation import AGGREGATOR_NAMES
from .utils import resolve_device

logger = logging.getLogger("mplc_tpu_torch")

_AGGREGATION_ALIASES = {
    "uniform": "uniform",
    "data-volume": "data-volume",
    "data_volume": "data-volume",
    "local-score": "local-score",
    "local_score": "local-score",
}


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1)")


class Scenario:
    def __init__(self,
                 partners_count,
                 amounts_per_partner,
                 dataset=None,
                 dataset_name=constants.MNIST,
                 samples_split_option=None,
                 corrupted_datasets=None,
                 multi_partner_learning_approach="fedavg",
                 aggregation_weighting=None,
                 gradient_updates_per_pass_count=constants.DEFAULT_GRADIENT_UPDATES_PER_PASS_COUNT,
                 minibatch_count=constants.DEFAULT_BATCH_COUNT,
                 epoch_count=constants.DEFAULT_EPOCH_COUNT,
                 is_early_stopping=True,
                 methods=None,
                 experiment_path=Path("./experiments"),
                 is_dry_run=False,
                 seed=42,
                 contributivity_cache_from=None,
                 aggregation=None,
                 device=None):
        self.device = resolve_device(device)
        # a coalition cache saved by an earlier run of the same game
        self.contributivity_cache_from = contributivity_cache_from

        if isinstance(dataset, dataset_module.Dataset):
            self.dataset = dataset
        else:
            self.dataset = dataset_module.load_dataset(dataset_name)

        self.partners_list: list[Partner] = []
        self.partners_count = partners_count
        self.amounts_per_partner = amounts_per_partner
        self.samples_split_type, self.samples_split_description = (
            samples_split_option or ("basic", "random"))
        if self.samples_split_type != "basic":
            raise _not_ported(f"the '{self.samples_split_type}' split")
        # an empty list is a list of no specs (and fails the count check),
        # not the default
        self.corrupted_datasets = (corrupted_datasets if corrupted_datasets is not None
                                   else ["not_corrupted"] * partners_count)
        if len(self.corrupted_datasets) != partners_count:
            raise ValueError(f"corrupted_datasets has {len(self.corrupted_datasets)} "
                             f"entries for {partners_count} partners: one spec per partner")
        # a typo'd spec must not run an uncorrupted partner through a
        # robustness experiment
        for idx, spec in enumerate(self.corrupted_datasets):
            kind = spec[0] if isinstance(spec, (list, tuple)) else spec
            if kind not in CORRUPTION_KINDS:
                raise ValueError(f"corrupted_datasets[{idx}] = {kind!r} is not a valid "
                                 f"corruption; valid names: {', '.join(CORRUPTION_KINDS)}")
        # set by data_corruption(): the engine warns when the partner fault
        # plan has data faults that never ran
        self._data_faults_applied = False

        if multi_partner_learning_approach not in MULTI_PARTNER_LEARNING_APPROACHES:
            raise KeyError(
                f"Multi-partner learning approach '{multi_partner_learning_approach}' "
                f"is not a valid approach. List of supported approaches: "
                f"{', '.join(MULTI_PARTNER_LEARNING_APPROACHES)}")
        self.multi_partner_learning_approach = \
            MULTI_PARTNER_LEARNING_APPROACHES[multi_partner_learning_approach]
        self.multi_partner_learning_approach_key = multi_partner_learning_approach
        # `aggregation` is the JAX package's alias of `aggregation_weighting`;
        # a conflicting pair is an error, neither unset is "data-volume"
        if aggregation is not None:
            if aggregation_weighting is not None and \
                    _AGGREGATION_ALIASES.get(aggregation_weighting) != \
                    _AGGREGATION_ALIASES.get(aggregation):
                raise ValueError(
                    f"Conflicting aggregation settings: aggregation="
                    f"{aggregation!r} vs aggregation_weighting="
                    f"{aggregation_weighting!r}; set only one")
            aggregation_weighting = aggregation
        if aggregation_weighting is None:
            aggregation_weighting = "data-volume"
        try:
            self.aggregation_name = _AGGREGATION_ALIASES[aggregation_weighting]
        except KeyError:
            raise ValueError(
                f"aggregation approach '{aggregation_weighting}' is not a valid "
                f"approach. Supported: {AGGREGATOR_NAMES}") from None

        self.epoch_count = epoch_count
        self.minibatch_count = minibatch_count
        self.gradient_updates_per_pass_count = gradient_updates_per_pass_count
        if min(epoch_count, minibatch_count, gradient_updates_per_pass_count) <= 0:
            raise ValueError("epoch_count, minibatch_count and "
                             "gradient_updates_per_pass_count must be > 0")
        self.is_early_stopping = is_early_stopping
        self.seed = seed

        self.mpl = None
        self._charac_engine = None
        self.contributivity_list: list[Contributivity] = []
        self.methods = list(methods or [])
        for method in self.methods:
            if method not in constants.CONTRIBUTIVITY_METHODS:
                raise ValueError(f"Contributivity method '{method}' is not in "
                                 "methods list.")

        # the JAX package's folder name, at its default scenario_id and
        # repeats_count (both 1), which the port does not take
        now_str = datetime.datetime.now().strftime("%Y-%m-%d_%Hh%M")
        self.scenario_name = f"scenario_1_repeat_1_{now_str}_{uuid.uuid4().hex[:3]}"
        self.save_folder = Path(experiment_path) / self.scenario_name
        self.is_dry_run = is_dry_run
        if not is_dry_run:
            self.save_folder.mkdir(parents=True, exist_ok=True)

    def instantiate_scenario_partners(self):
        if self.partners_list:
            raise RuntimeError("self.partners_list should be []")
        self.partners_list = [Partner(i, seed=self.seed * 1000 + i)
                              for i in range(self.partners_count)]

    def split_data(self):
        split_basic(self.dataset, self.partners_list, self.amounts_per_partner,
                    self.samples_split_description, self.minibatch_count)
        self.nb_samples_used = sum(len(p.x_train) for p in self.partners_list)
        self.final_relative_nb_samples = [
            p.final_nb_samples / self.nb_samples_used for p in self.partners_list]

    def compute_batch_sizes(self):
        compute_batch_sizes(self.partners_list, self.minibatch_count,
                            self.gradient_updates_per_pass_count,
                            constants.MAX_BATCH_SIZE)

    def data_corruption(self):
        """Each partner's corruption (the JAX package's dispatch: a spec is
        a kind, or (kind, parameter) with the proportion 1.0 or, for
        'noisy', the sigma 0.1 by default), then the partner fault plan's
        noisy and glabel entries through the same seeded operators. The
        clipped plan is kept as `_partner_fault_plan`, so the engine's
        trainers and fingerprint follow the plan whose data faults ran."""
        for partner, spec in zip(self.partners_list, self.corrupted_datasets):
            kind, param = (spec[0], spec[1]) if isinstance(spec, (list, tuple)) else (spec, None)
            label_ops = {"corrupted": partner.corrupt_labels,
                         "shuffled": partner.shuffle_labels,
                         "permuted": partner.permute_labels,
                         "random": partner.random_labels,
                         "glabel": partner.flip_to_global_label}
            if kind == "noisy":
                # the parameter is the noise sigma, not a proportion
                partner.noisy_features(0.1 if param is None else param)
            elif kind in label_ops:
                label_ops[kind](1.0 if param is None else param)
        plan = faults.clip_partner_plan(faults.partner_fault_plan_from_env(),
                                        self.partners_count)
        self._partner_fault_plan = plan
        for pid, specs in faults.data_fault_specs(plan).items():
            for kind, value in specs:
                if kind == "noisy":
                    self.partners_list[pid].noisy_features(value)
                else:
                    self.partners_list[pid].flip_to_global_label(value)
        self._data_faults_applied = True

    def run(self):
        self.instantiate_scenario_partners()
        self.split_data()
        self.compute_batch_sizes()
        self.data_corruption()

        self.mpl = self.multi_partner_learning_approach(self)
        self.mpl.fit()

        cache = self.save_folder / "coalition_cache.json"
        for method in self.methods:
            contrib = Contributivity(scenario=self)
            if self.contributivity_cache_from and \
                    not self._charac_engine.first_charac_fct_calls_count:
                self._resume_coalition_cache()
            if not self.is_dry_run:
                # every trained batch is saved at once, so a killed sweep
                # resumes where it stopped
                self._charac_engine.autosave_path = cache
            contrib.compute_contributivity(method)
            self.contributivity_list.append(contrib)
            logger.info(f"## Evaluating contributivity with {method}: {contrib}")
        if self.methods and not self.is_dry_run:
            self._charac_engine.save_cache(cache)
        return 0

    def _resume_coalition_cache(self):
        """Load `contributivity_cache_from` into the engine. A corrupt or
        truncated file is renamed to `<name>.corrupt` and the sweep starts
        cold; a valid cache of another game still raises ValueError."""
        from .contrib.engine import CacheIntegrityError

        path = Path(self.contributivity_cache_from)
        try:
            self._charac_engine.load_cache(path)
        except CacheIntegrityError as e:
            quarantine = path.with_name(path.name + ".corrupt")
            try:
                path.replace(quarantine)
                where = f"quarantined to {quarantine}"
            except OSError as rename_err:
                where = f"left in place (quarantine rename failed: {rename_err})"
            logger.warning(f"coalition cache {path} is unusable ({e}); {where}; "
                           "starting the sweep cold")
            return
        logger.info(f"Resumed coalition cache from {path} "
                    f"({len(self._charac_engine.charac_fct_values)} entries)")
