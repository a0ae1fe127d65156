"""The port's CLI: a YAML grid -> scenarios -> repeats -> results.csv.

    python3 -m mplc_tpu_torch.main -f config.yml [-v] [--grid-shard I/N] [--device cpu]

Expands every list-valued parameter of the config into a scenario grid
(`utils.get_scenario_params_list`), validates every scenario with a dry run
before any training, then runs n_repeats x scenarios and appends each
scenario's `to_dataframe()` rows, with the `random_state` (repeat) and
`scenario_id` columns, to `./experiments/<name>_<date>/results.csv`. With
`--grid-shard I/N` it runs scenarios I::N only, into the shared
`./experiments/<name>_shardedN/results_shardI.csv`, and leaves the
`.shardI.done` marker when it finishes (join the shards with
`python3 -m mplc_tpu_torch.merge_shards`). It runs on CUDA unless
`--device` names another device; where there is no CUDA it fails rather
than run on the CPU unasked.

Under a launcher (`torchrun --nproc-per-node N -m mplc_tpu_torch.main ...`,
which sets WORLD_SIZE and the rest), every rank joins the world first
(`parallel.mesh.init_world`: NCCL on the cards, one card a rank) and runs
the same grid; the coalition sweeps spread over the ranks (the 2-D
[coal, part] mode with MPLC_TORCH_PARTNER_SHARDS or `partner_shards`), and
every rank ends with the same value table. Only rank 0 writes: the
experiment folder, results.csv, the scenarios' files and coalition caches,
the value ledger and the trace files (the other ranks run their scenarios
as dry runs, with those knobs cleared).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

from . import constants, utils
from .obs import trace as obs_trace
from .parallel import mesh
from .scenario import Scenario

# the knobs naming files a run writes, cleared on ranks other than 0
_RANK0_FILE_KNOBS = (constants.NUMERICS_LEDGER_ENV, obs_trace.TRACE_FILE_ENV,
                     obs_trace.CHROME_TRACE_FILE_ENV, constants.PROFILE_DIR_ENV)

DEFAULT_CONFIG_FILE = "./config.yml"


def validate_scenario_list(scenario_params_list, experiment_path, device=None):
    """Dry-run every scenario: construction, partners and the data split."""
    logger = utils.logger
    logger.debug("Starting to validate scenarios")
    for scenario_params in scenario_params_list:
        current_scenario = Scenario(**scenario_params,
                                    experiment_path=experiment_path,
                                    is_dry_run=True, device=device)
        current_scenario.instantiate_scenario_partners()
        if current_scenario.samples_split_type == "basic":
            current_scenario.split_data(is_logging_enabled=False)
        elif current_scenario.samples_split_type == "advanced":
            current_scenario.split_data_advanced(is_logging_enabled=False)
    logger.debug("All scenarios have been validated")


def main(argv=None):
    """Run the CLI; a crash is logged with its traceback (to the console
    and, once the experiment folder is set, to its log files) and returns
    1. The log files are closed on return."""
    try:
        return _main(argv)
    except Exception:
        utils.logger.exception("Experiment run crashed:")
        return 1
    finally:
        utils.close_log_files()


def _main(argv=None):
    args = utils.parse_command_line_arguments(argv)
    logger = utils.init_logger(debug=args.verbose)
    # a launcher's rank joins its world before anything else; then fail
    # before any file is written where the device is missing
    mesh.init_world(args.device)
    device = utils.resolve_device(args.device)
    writer = mesh.world_rank() == 0
    if not writer:
        for knob in _RANK0_FILE_KNOBS:
            os.environ.pop(knob, None)

    config_file = args.file or DEFAULT_CONFIG_FILE
    logger.info(f"Using config file: {config_file}")
    shard = args.grid_shard
    if writer:
        config = utils.get_config_from_file(config_file, shard=shard)
    else:
        config = utils.load_cfg(config_file)
        config["experiment_path"] = Path.cwd() / constants.EXPERIMENTS_FOLDER_NAME / "rank"

    scenario_params_list = utils.get_scenario_params_list(
        config["scenario_params_list"])
    experiment_path = config["experiment_path"]
    n_repeats = config["n_repeats"]

    indexed_scenarios = list(enumerate(scenario_params_list))
    results_name = "results.csv"
    if shard is not None:
        shard_i, shard_n = shard
        indexed_scenarios = indexed_scenarios[shard_i::shard_n]
        results_name = f"results_shard{shard_i}.csv"
        logger.info(f"Grid shard {shard_i}/{shard_n}: running "
                    f"{len(indexed_scenarios)} of {len(scenario_params_list)} "
                    "scenarios")
        # a re-run reuses the sharded folder: a stale done marker must not
        # let the merge take this run's partial csv, and the previous run's
        # csv must not be appended to
        if writer:
            (experiment_path / f".shard{shard_i}.done").unlink(missing_ok=True)
            (experiment_path / results_name).unlink(missing_ok=True)

    validate_scenario_list([p for _, p in indexed_scenarios], experiment_path, device)

    for scenario_id, scenario_params in indexed_scenarios:
        logger.info(f"Scenario {scenario_id + 1}/{len(scenario_params_list)}: "
                    f"{scenario_params}")

    if writer:
        utils.set_log_file(experiment_path)

    for i in range(n_repeats):
        logger.info(f"Repeat {i + 1}/{n_repeats}")
        for scenario_id, scenario_params in indexed_scenarios:
            logger.info(f"Scenario {scenario_id + 1}/{len(scenario_params_list)}")
            current_scenario = Scenario(**scenario_params,
                                        experiment_path=experiment_path,
                                        scenario_id=scenario_id + 1,
                                        repeats_count=i + 1, device=device,
                                        is_dry_run=not writer)
            current_scenario.run()
            if not writer:
                continue

            df_results = current_scenario.to_dataframe()
            df_results["random_state"] = i
            df_results["scenario_id"] = scenario_id

            results_path = experiment_path / results_name
            with open(results_path, "a") as f:
                df_results.to_csv(f, header=f.tell() == 0, index=False)
            logger.info(f"Results saved to {os.path.relpath(results_path)}")
    if shard is not None and writer:
        # the merge's completion marker: a csv appears after the first
        # scenario, and a shard whose slice is empty writes none
        (experiment_path / f".shard{shard[0]}.done").touch()
    return 0


if __name__ == "__main__":
    sys.exit(main())
