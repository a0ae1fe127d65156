"""Scenario: the orchestrator (port of `mplc_tpu/scenario.py`).

The JAX package's constructor, parameter for parameter, with its checks
(the same exceptions and messages for unknown keyword arguments,
`dataset_proportion`, `is_quick_demo` and conflicting `aggregation=` /
`aggregation_weighting` settings), and its `run()`
sequence: dataset selection, partner instantiation, the basic or advanced
data split, batch sizes, data corruption, the grand-coalition training,
then the configured contributivity methods; `to_dataframe()` gives the JAX
package's rows and columns. It runs on CUDA unless `device=` names another
device (the tests pass `device="cpu"`); see `utils.resolve_device`.
`partner_shards` above 1 (the coalition x partner layout over several
cards) is not ported and raises.

`corrupted_datasets` takes every corruption of `data.partner.CORRUPTION_KINDS`;
`data_corruption` then applies the partner fault plan's noisy and glabel
entries (MPLC_TORCH_PARTNER_FAULT_PLAN) and keeps the parsed plan for the
CharacteristicEngine.

Unless `is_dry_run`, the scenario writes into its own folder under
`experiment_path`: the data distribution graph, the final weights
(`model/<dataset>_final_weights.npz`), the history's pickle and graphs,
and the coalition cache `coalition_cache.json`, saved after every trained
batch of a method and once after the methods. A sweep resumes from a cache
named by `contributivity_cache_from`; the grand coalition's fit starts
from a weights file named by `init_model_from`. Without matplotlib the
graphs are skipped, with one warning a scenario; every other file and
number is written.
"""

from __future__ import annotations

import datetime
import logging
import uuid
from pathlib import Path

import numpy as np
import pandas as pd

from . import constants, faults
from .contrib.contributivity import Contributivity
from .data import datasets as dataset_module
from .data.partition import _encode_labels, compute_batch_sizes, split_advanced, split_basic
from .data.partner import CORRUPTION_KINDS, Partner
from .mpl.approaches import MULTI_PARTNER_LEARNING_APPROACHES
from .ops.aggregation import AGGREGATOR_NAMES
from .utils import pyplot, resolve_device

logger = logging.getLogger("mplc_tpu_torch")

_AGGREGATION_ALIASES = {
    "uniform": "uniform",
    "data-volume": "data-volume",
    "data_volume": "data-volume",
    "local-score": "local-score",
    "local_score": "local-score",
}

_PARAMS_KNOWN = [
    "dataset", "dataset_name", "dataset_proportion",
    "methods", "multi_partner_learning_approach", "aggregation",
    "aggregation_weighting",
    "partners_count", "amounts_per_partner", "corrupted_datasets",
    "samples_split_option",
    "gradient_updates_per_pass_count", "epoch_count", "minibatch_count",
    "is_early_stopping",
    "init_model_from", "is_quick_demo",
    "seed", "compute_dtype", "contributivity_cache_from",
    "partner_shards",
]


class Scenario:
    def __init__(self,
                 partners_count,
                 amounts_per_partner,
                 dataset=None,
                 dataset_name=constants.MNIST,
                 dataset_proportion=1,
                 samples_split_option=None,
                 corrupted_datasets=None,
                 init_model_from="random_initialization",
                 multi_partner_learning_approach="fedavg",
                 aggregation_weighting=None,
                 gradient_updates_per_pass_count=constants.DEFAULT_GRADIENT_UPDATES_PER_PASS_COUNT,
                 minibatch_count=constants.DEFAULT_BATCH_COUNT,
                 epoch_count=constants.DEFAULT_EPOCH_COUNT,
                 is_early_stopping=True,
                 methods=None,
                 is_quick_demo=False,
                 experiment_path=Path("./experiments"),
                 scenario_id=1,
                 repeats_count=1,
                 is_dry_run=False,
                 seed=42,
                 compute_dtype="float32",
                 contributivity_cache_from=None,
                 partner_shards=None,
                 device=None,
                 **kwargs):
        unrecognised = [k for k in kwargs if k not in _PARAMS_KNOWN]
        if unrecognised:
            raise Exception(
                f"Unrecognised parameters {unrecognised}, check your configuration")
        self.device = resolve_device(device)

        # `aggregation` is the JAX package's alias of `aggregation_weighting`;
        # a conflicting pair is an error, neither set is "data-volume"
        aggregation_alias = kwargs.get("aggregation")
        if aggregation_alias is not None:
            if aggregation_weighting is not None and \
                    _AGGREGATION_ALIASES.get(aggregation_weighting) != \
                    _AGGREGATION_ALIASES.get(aggregation_alias):
                raise ValueError(
                    f"Conflicting aggregation settings: aggregation="
                    f"{aggregation_alias!r} vs aggregation_weighting="
                    f"{aggregation_weighting!r}; set only one")
            aggregation_weighting = aggregation_alias
        if aggregation_weighting is None:
            aggregation_weighting = "data-volume"

        if isinstance(dataset, dataset_module.Dataset):
            self.dataset = dataset
        else:
            self.dataset = dataset_module.load_dataset(dataset_name)
            logger.debug(f"Dataset selected: {dataset_name}")

        self.dataset_proportion = dataset_proportion
        # the JAX package's assertions, raised so that they hold under -O
        if not self.dataset_proportion > 0:
            raise AssertionError("Error in the config file, dataset_proportion should be > 0")
        if not self.dataset_proportion <= 1:
            raise AssertionError("Error in the config file, dataset_proportion should be <= 1")
        if self.dataset_proportion < 1:
            self.dataset.shorten_dataset_proportion(self.dataset_proportion)
        self.nb_samples_used = len(self.dataset.x_train)
        self.final_relative_nb_samples = []

        self.partners_list: list[Partner] = []
        self.partners_count = partners_count
        self.amounts_per_partner = amounts_per_partner
        self.samples_split_type, self.samples_split_description = (
            samples_split_option or ("basic", "random"))
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
        try:
            self.aggregation_name = _AGGREGATION_ALIASES[aggregation_weighting]
        except KeyError:
            raise ValueError(
                f"aggregation approach '{aggregation_weighting}' is not a valid "
                f"approach. Supported: {AGGREGATOR_NAMES}") from None
        # the reference stores a class here, the JAX package the name
        self.aggregation = self.aggregation_name

        self.epoch_count = epoch_count
        self.minibatch_count = minibatch_count
        self.gradient_updates_per_pass_count = gradient_updates_per_pass_count
        if min(epoch_count, minibatch_count, gradient_updates_per_pass_count) <= 0:
            raise ValueError("epoch_count, minibatch_count and "
                             "gradient_updates_per_pass_count must be > 0")
        self.is_early_stopping = is_early_stopping

        self.init_model_from = init_model_from
        self.use_saved_weights = init_model_from != "random_initialization"
        self.seed = seed
        if compute_dtype not in constants.COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {constants.COMPUTE_DTYPES}, "
                             f"got {compute_dtype!r}")
        self.compute_dtype = compute_dtype
        # a coalition cache saved by an earlier run of the same game
        self.contributivity_cache_from = contributivity_cache_from
        # the coalition x partner layout over several cards (ROADMAP.md
        # queue 1 item 10) is not ported: a value above 1 must not run on
        # one card in silence
        self.partner_shards = 1 if partner_shards is None else int(partner_shards)
        if self.partner_shards < 1:
            raise ValueError(f"partner_shards must be >= 1, got {partner_shards}")
        if self.partner_shards > 1:
            raise NotImplementedError(
                f"partner_shards={self.partner_shards}: sharding the partner axis over "
                "several cards is not ported yet (ROADMAP.md queue 1 item 10)")
        # set by the CharacteristicEngine once it picks its execution mode
        self.slot_bucketing = None

        self.mpl = None
        self._charac_engine = None
        self.contributivity_list: list[Contributivity] = []
        self.methods = list(methods or [])
        for method in self.methods:
            if method not in constants.CONTRIBUTIVITY_METHODS:
                raise ValueError(f"Contributivity method '{method}' is not in "
                                 "methods list.")

        self.scenario_id = scenario_id
        self.n_repeat = repeats_count
        self.is_quick_demo = is_quick_demo
        if self.is_quick_demo and self.dataset_proportion < 1:
            raise Exception("Don't start a quick_demo without the full dataset")
        if self.is_quick_demo:
            logger.info("Quick demo: limit number of data and number of epochs.")
            self._quick_demo_subsample()
            self.epoch_count = 3
            self.minibatch_count = 2

        now_str = datetime.datetime.now().strftime("%Y-%m-%d_%Hh%M")
        self.scenario_name = (f"scenario_{self.scenario_id}_repeat_{self.n_repeat}"
                              f"_{now_str}_{uuid.uuid4().hex[:3]}")
        self.short_scenario_name = f"{self.partners_count} {self.amounts_per_partner}"
        self.save_folder = Path(experiment_path) / self.scenario_name
        self.is_dry_run = is_dry_run
        if not is_dry_run:
            self.save_folder.mkdir(parents=True, exist_ok=True)
            logger.info("### Description of data scenario configured:")
            logger.info(f"   Number of partners defined: {self.partners_count}")
            logger.info(f"   Data distribution scenario chosen: {self.samples_split_description}")
            logger.info(f"   Multi-partner learning approach: {self.multi_partner_learning_approach_key}")
            logger.info(f"   Weighting option: {self.aggregation_name}")
            logger.info(f"   Dataset: {self.dataset.name} ({self.dataset.provenance}); "
                        f"{len(self.dataset.x_train)} train / "
                        f"{len(self.dataset.x_val)} val / "
                        f"{len(self.dataset.x_test)} test samples")

    def _quick_demo_subsample(self):
        """At most TRAIN/VAL/TEST_SET_MAX_SIZE_QUICK_DEMO rows of each split,
        drawn without replacement by one `RandomState(seed)` (train, val,
        test), when the training set is larger than its cap."""
        ds = self.dataset
        if len(ds.x_train) <= constants.TRAIN_SET_MAX_SIZE_QUICK_DEMO:
            return
        rng = np.random.RandomState(self.seed)
        idx_tr = rng.choice(len(ds.x_train), constants.TRAIN_SET_MAX_SIZE_QUICK_DEMO,
                            replace=False)
        idx_v = rng.choice(len(ds.x_val), min(constants.VAL_SET_MAX_SIZE_QUICK_DEMO,
                                              len(ds.x_val)), replace=False)
        idx_te = rng.choice(len(ds.x_test), min(constants.TEST_SET_MAX_SIZE_QUICK_DEMO,
                                                len(ds.x_test)), replace=False)
        ds.x_train, ds.y_train = ds.x_train[idx_tr], ds.y_train[idx_tr]
        ds.x_val, ds.y_val = ds.x_val[idx_v], ds.y_val[idx_v]
        ds.x_test, ds.y_test = ds.x_test[idx_te], ds.y_test[idx_te]

    def instantiate_scenario_partners(self):
        if self.partners_list:
            raise RuntimeError("self.partners_list should be []")
        self.partners_list = [Partner(i, seed=self.seed * 1000 + i)
                              for i in range(self.partners_count)]

    def split_data(self, is_logging_enabled=True):
        split_basic(self.dataset, self.partners_list, self.amounts_per_partner,
                    self.samples_split_description, self.minibatch_count)
        self.nb_samples_used = sum(len(p.x_train) for p in self.partners_list)
        self.final_relative_nb_samples = [
            p.final_nb_samples / self.nb_samples_used for p in self.partners_list]
        if is_logging_enabled:
            logger.info("### Splitting data among partners: basic split done.")
        return 0

    def split_data_advanced(self, is_logging_enabled=True):
        self.nb_samples_used, self.final_relative_nb_samples = split_advanced(
            self.dataset, self.partners_list, self.amounts_per_partner,
            self.samples_split_description, self.minibatch_count)
        if is_logging_enabled:
            logger.info("### Splitting data among partners: advanced split done.")
        return 0

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

    def plot_data_distribution(self):
        """`graphs/data_distribution.png`: each partner's training rows per
        class, one bar chart a partner (nothing without matplotlib)."""
        plt = pyplot()
        if plt is None:
            return
        # one encoding of the dataset's labels and the partners' (a subset of
        # them): each partner's codes are the dataset's
        ys = [self.dataset.y_train] + [p.y_train for p in self.partners_list]
        codes = np.split(_encode_labels(np.concatenate(ys)), np.cumsum([len(y) for y in ys])[:-1])
        for i, (partner, partner_codes) in enumerate(zip(self.partners_list, codes[1:])):
            plt.subplot(self.partners_count, 1, i + 1)
            data_count = np.bincount(partner_codes, minlength=self.dataset.num_classes)
            plt.bar(np.arange(0, self.dataset.num_classes), data_count)
            plt.ylabel("partner " + str(partner.id))
        plt.suptitle("Data distribution")
        plt.xlabel("Classes")
        graphs = self.save_folder / "graphs"
        graphs.mkdir(parents=True, exist_ok=True)
        plt.savefig(graphs / "data_distribution.png")
        plt.close()

    def append_contributivity(self, contributivity):
        self.contributivity_list.append(contributivity)

    def run(self):
        self.instantiate_scenario_partners()
        if self.samples_split_type == "basic":
            self.split_data()
        elif self.samples_split_type == "advanced":
            self.split_data_advanced()
        if not self.is_dry_run:
            if pyplot() is None:
                logger.warning(f"matplotlib is not installed: the graphs of "
                               f"{self.scenario_name} are not drawn")
            self.plot_data_distribution()
        self.compute_batch_sizes()
        self.data_corruption()

        # the JAX package saves here in a dry run too (into a folder the dry
        # run never made); the port's dry runs write nothing
        self.mpl = self.multi_partner_learning_approach(self, is_save_data=not self.is_dry_run)
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
            self.append_contributivity(contrib)
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

    def to_dataframe(self) -> pd.DataFrame:
        """The JAX package's rows and columns: one row without a method,
        else one a method and partner."""
        rows = []
        base = {
            "scenario_name": self.scenario_name,
            "short_scenario_name": self.short_scenario_name,
            "dataset_name": self.dataset.name,
            "train_data_samples_count": len(self.dataset.x_train),
            "test_data_samples_count": len(self.dataset.x_test),
            "partners_count": self.partners_count,
            "dataset_fraction_per_partner": str(self.amounts_per_partner),
            "samples_split_description": str(self.samples_split_description),
            "nb_samples_used": self.nb_samples_used,
            "final_relative_nb_samples": str(self.final_relative_nb_samples),
            "multi_partner_learning_approach": self.multi_partner_learning_approach_key,
            "aggregation": self.aggregation_name,
            "partner_shards": self.partner_shards,
            "slot_bucketing": self.slot_bucketing,
            "epoch_count": self.epoch_count,
            "minibatch_count": self.minibatch_count,
            "gradient_updates_per_pass_count": self.gradient_updates_per_pass_count,
            "is_early_stopping": self.is_early_stopping,
            "mpl_test_score": self.mpl.history.score if self.mpl else None,
            "mpl_nb_epochs_done": self.mpl.history.nb_epochs_done if self.mpl else None,
            "learning_computation_time_sec":
                self.mpl.learning_computation_time if self.mpl else None,
        }
        if not self.contributivity_list:
            rows.append(dict(base))
        for contrib in self.contributivity_list:
            extra = {
                "contributivity_method": contrib.name,
                "contributivity_scores": str(list(contrib.contributivity_scores)),
                "contributivity_stds": str(list(contrib.scores_std)),
                "computation_time_sec": contrib.computation_time_sec,
                "first_characteristic_calls_count": contrib.first_charac_fct_calls_count,
            }
            for i in range(self.partners_count):
                row = dict(base)
                row.update(extra)
                row["partner_id"] = i
                row["dataset_fraction_of_partner"] = self.amounts_per_partner[i]
                row["contributivity_score"] = contrib.contributivity_scores[i]
                row["contributivity_std"] = contrib.scores_std[i]
                rows.append(row)
        return pd.DataFrame(rows)
