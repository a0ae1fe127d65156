"""Device selection for the port's entry points, the kernel build folder
(`enable_compile_cache_from_env`, `compile_cache_entries`), a
`torch.profiler` trace of a region (`profile_trace`), and the CLI's helpers
(`python3 -m mplc_tpu_torch.main`): YAML experiment files of the shape
{experiment_name, n_repeats, scenario_params_list}, whose list-valued
parameters are expanded into one scenario a combination, experiment
folders, and logging to the console and to an experiment's `info.log` and
`debug.log`.
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import logging
import os
import sys
from itertools import product
from pathlib import Path
from shutil import copyfile

import torch
import yaml

from . import constants


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one (the CPU tests pass `device="cpu"`).

    Asking for CUDA where there is none raises: the port never drops
    quietly to the CPU. On CUDA, float32 means float32 and one seed gives
    one result, process-wide: TF32 is switched off for cuDNN convolutions
    and cuBLAS matrix products, cuDNN runs deterministic algorithms with
    benchmarking off, `torch.use_deterministic_algorithms(True)` makes an
    op without a deterministic CUDA implementation raise, and cuBLAS gets
    the fixed workspace (`CUBLAS_WORKSPACE_CONFIG=:4096:8`) its
    deterministic mode needs, which must be set before the process's first
    cuBLAS call.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (the CLI: --device cpu) "
                "to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True)
        # every op of the port writes the whole of what it allocates, so
        # filling new tensors with NaN (what deterministic mode does by
        # default) buys nothing and costs a write of each, the kernels'
        # outputs included
        torch.utils.deterministic.fill_uninitialized_memory = False
    return dev


def enable_compile_cache_from_env() -> str | None:
    """The folder `MPLC_TORCH_COMPILE_CACHE_DIR` names, made if missing:
    the kernel build folder (ops/cuda_build.py) and the program bank's
    manifest folder (contrib/bank.py), which several checkouts and
    processes may share, since each library is named by a digest of its
    source and flags. None when the knob is unset, or when the folder
    cannot be made (a warning; the kernels then build into the default
    folder)."""
    path = os.environ.get(constants.COMPILE_CACHE_DIR_ENV)
    if not path:
        return None
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        import warnings
        warnings.warn(f"{constants.COMPILE_CACHE_DIR_ENV}={path!r} could not be made "
                      f"({e}); the kernels build into the default folder", stacklevel=2)
        return None
    return path


def compile_cache_entries(path: str | None) -> int | None:
    """Files under a kernel build folder (None when the path is unset or
    missing): a run whose count did not grow built nothing."""
    if not path or not os.path.isdir(path):
        return None
    return sum(len(files) for _, _, files in os.walk(path))


PROFILE_DIR_ENV = "MPLC_TORCH_PROFILE_DIR"
_profile_seq = itertools.count(1)


class profile_trace:
    """A `torch.profiler` device trace of a region (port of
    `mplc_tpu/utils.py` `profile_trace`, there a `jax.profiler` trace):

        with utils.profile_trace("/tmp/mplc_trace"):
            scenario.run()

    A no-op unless a directory is given or MPLC_TORCH_PROFILE_DIR is set,
    so it can stay in production paths. On a `device` of type cuda (the
    default: the port runs on the card unless asked otherwise) it records
    CPU and CUDA activity, on a CPU device CPU activity only, and writes
    one Chrome trace `<dir>/mplc_torch_<pid>_<n>.pt.trace.json` (`path`
    after the block), which `python3 -m mplc_tpu_torch.obs.analyze_trace`
    summarizes. A CUDA run whose trace holds no device event (CUPTI gave
    none) raises instead of writing a CPU-only trace. The profiler adds
    its own cost: time nothing gated inside it."""

    def __init__(self, trace_dir: str | None = None, device=None):
        self.trace_dir = trace_dir or os.environ.get(PROFILE_DIR_ENV)
        self.cuda = torch.device(device or "cuda").type == "cuda"
        self.path = None
        self._prof = None

    def __enter__(self):
        if self.trace_dir:
            from torch.profiler import ProfilerActivity, profile

            if self.cuda and not torch.cuda.is_available():
                raise RuntimeError("profile_trace: a CUDA trace was asked for and "
                                   "no CUDA device is available; pass device='cpu'")
            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        from .obs import analyze_trace

        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, f"mplc_torch_{os.getpid()}_"
                            f"{next(_profile_seq)}{analyze_trace.TRACE_SUFFIX}")
        self._prof.export_chrome_trace(path)
        if self.cuda and analyze_trace.summarize(path)["kind"] != "cuda":
            os.remove(path)
            raise RuntimeError("profile_trace: the CUDA trace holds no device "
                               "activity (CUPTI recorded none); no trace written")
        self.path = path
        return False


# ---------------------------------------------------------------------------
# The CLI's helpers (port of `mplc_tpu/utils.py`): config loading, the
# experiment grid, result folders, logging
# ---------------------------------------------------------------------------

logger = logging.getLogger("mplc_tpu_torch")


def load_cfg(yaml_filepath):
    logger.info("Loading experiment yaml file")
    with open(yaml_filepath, "r") as stream:
        cfg = yaml.safe_load(stream)
    logger.info(str(cfg))
    return cfg


def _expand_dataset_dict(block):
    """Yield one grid block per dataset when `dataset_name` uses the dict
    sub-syntax `{mnist: [path, ...], cifar10: ~}`: each dataset becomes its
    own block whose `init_model_from` axis is the mapped value (or
    `random_initialization` for null)."""
    names = block.get("dataset_name")
    if not isinstance(names, dict):
        yield block
        return
    for name, warm_starts in names.items():
        sub = dict(block)
        sub["dataset_name"] = [name]
        sub["init_model_from"] = (["random_initialization"]
                                  if warm_starts is None else warm_starts)
        yield sub


def _check_per_partner_lengths(scenario):
    """Every per-partner list must have exactly `partners_count` entries."""
    n = scenario["partners_count"]
    amounts = scenario["amounts_per_partner"]
    if len(amounts) != n:
        raise Exception(
            f"amounts_per_partner has {len(amounts)} entries but the "
            f"scenario declares {n} partners.")
    split = scenario.get("samples_split_option")
    if split is not None and split[0] == "advanced" and len(split[1]) != n:
        raise Exception(
            f"advanced samples_split_option describes {len(split[1])} "
            f"partners but the scenario declares {n}.")
    if "corrupted_datasets" in scenario and \
            len(scenario["corrupted_datasets"]) != n:
        raise Exception(
            f"corrupted_datasets has {len(scenario['corrupted_datasets'])} "
            f"entries but the scenario declares {n} partners.")


def get_scenario_params_list(config):
    """Flatten the YAML `scenario_params_list` into one dict per scenario:
    every field of a block is a grid axis (its list of values crossed with
    all the others by `itertools.product`), and the `dataset_name` dict
    sub-syntax fans out into per-dataset blocks first."""
    scenarios = []
    for block in config:
        for sub in _expand_dataset_dict(block):
            axes = list(sub.keys())
            for combo in product(*sub.values()):
                scenario = dict(zip(axes, combo))
                _check_per_partner_lengths(scenario)
                scenarios.append(scenario)
    logger.info(f"Number of scenario(s) configured: {len(scenarios)}")
    return scenarios


def init_result_folder(yaml_filepath, cfg, shard=None):
    """Create the experiment folder under `./experiments`. An unsharded run
    gets `<name>_<date>_<hour>h<minute>` (with `_bis` appended while the
    name is taken) and a copy of its config. The N runs of a sharded grid
    (`--grid-shard I/N`) share the deterministic `<name>_shardedN`, created
    if missing, each with its own `config_shardI.yml`."""
    logger.info("Init result folder")
    root = Path.cwd() / constants.EXPERIMENTS_FOLDER_NAME
    if shard is not None:
        shard_i, shard_n = shard
        experiment_path = root / f"{cfg['experiment_name']}_sharded{shard_n}"
        experiment_path.mkdir(parents=True, exist_ok=True)
        copyfile(yaml_filepath, experiment_path / f"config_shard{shard_i}.yml")
    else:
        now_str = datetime.datetime.now().strftime("%Y-%m-%d_%Hh%M")
        experiment_path = root / (cfg["experiment_name"] + "_" + now_str)
        while experiment_path.exists():
            logger.warning(f"Experiment folder {experiment_path} already exists")
            experiment_path = Path(str(experiment_path) + "_bis")
        experiment_path.mkdir(parents=True, exist_ok=False)
        copyfile(yaml_filepath, experiment_path / Path(yaml_filepath).name)
    cfg["experiment_path"] = experiment_path
    logger.info(f"Experiment folder {experiment_path} created.")
    return cfg


def get_config_from_file(config_filepath, shard=None):
    config = load_cfg(config_filepath)
    config = init_result_folder(config_filepath, config, shard=shard)
    return config


def parse_command_line_arguments(argv=None):
    parser = argparse.ArgumentParser(prog="python3 -m mplc_tpu_torch.main")
    parser.add_argument("-f", "--file", help="input config file")
    parser.add_argument("-v", "--verbose", help="verbose output",
                        action="store_true")
    parser.add_argument(
        "--grid-shard", metavar="I/N", default=None, type=parse_grid_shard,
        help="run only scenarios I::N of the expanded grid (0-based): launch N "
             "processes or hosts with I=0..N-1; they share one experiment folder "
             "(<name>_shardedN) and each writes its own results_shardI.csv; join "
             "them with `python3 -m mplc_tpu_torch.merge_shards` when all finish")
    parser.add_argument(
        "--device", default=None,
        help="the device to run on (default: cuda; a machine without CUDA "
             "must ask for cpu)")
    return parser.parse_args(argv)


def parse_grid_shard(spec):
    """'I/N' -> (i, n) with 0 <= i < n. As argparse's `type`, a malformed
    spec is a usage error before any file is written."""
    try:
        i, n = (int(part) for part in spec.split("/"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--grid-shard must look like I/N, got {spec!r}")
    if not 0 <= i < n:
        raise argparse.ArgumentTypeError(
            f"--grid-shard needs 0 <= I < N, got {spec!r}")
    return i, n


class ConsoleLevelFilter(logging.Filter):
    """The console's verbosity, switchable after the handler is installed
    (`set_console_level`): the handler passes everything, this filter
    decides."""

    def __init__(self, level=logging.INFO):
        super().__init__()
        self.level = level

    def filter(self, record):
        return record.levelno >= self.level


_console_filter = ConsoleLevelFilter()


def set_console_level(level):
    """Change the console verbosity ('DEBUG', 'INFO', ... or a logging
    level number)."""
    if isinstance(level, str):
        level = logging.getLevelName(level.upper())
        if not isinstance(level, int):  # getLevelName echoes unknown names
            raise ValueError(f"unknown log level {level!r}")
    _console_filter.level = level


def init_logger(debug=False):
    """The `mplc_tpu_torch` logger with one console handler on standard
    output (DEBUG with `debug`, else INFO), replacing its handlers."""
    root = logging.getLogger("mplc_tpu_torch")
    root.setLevel(logging.DEBUG)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    console = logging.StreamHandler(sys.stdout)
    console.setLevel(logging.DEBUG)
    _console_filter.level = logging.DEBUG if debug else logging.INFO
    console.addFilter(_console_filter)
    console.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s"))
    root.addHandler(console)
    return root


def set_log_file(path: Path):
    """Add `info.log` (INFO and above) and `debug.log` (everything) under
    `path` to the `mplc_tpu_torch` logger."""
    root = logging.getLogger("mplc_tpu_torch")
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
    for name, level in ((constants.INFO_LOGGING_FILE_NAME, logging.INFO),
                        (constants.DEBUG_LOGGING_FILE_NAME, logging.DEBUG)):
        handler = logging.FileHandler(Path(path) / name)
        handler.setLevel(level)
        handler.setFormatter(fmt)
        root.addHandler(handler)


def close_log_files():
    """Remove and close the `mplc_tpu_torch` logger's file handlers."""
    root = logging.getLogger("mplc_tpu_torch")
    for h in list(root.handlers):
        if isinstance(h, logging.FileHandler):
            root.removeHandler(h)
            h.close()


def pyplot():
    """matplotlib's pyplot drawing to files (the Agg backend), or None
    where matplotlib is not installed (the machine with the card lacks
    it): the graphs are then not drawn, and nothing else changes."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt
