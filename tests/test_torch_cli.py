"""The port's CLI (`python3 -m mplc_tpu_torch.main`) against the JAX
package's (`main.py`), on the CPU:

(a) the grid: `get_scenario_params_list` equal to the JAX function's on both
    files of `configs/` and on the dataset-dict cases, the same errors for
    per-partner lists of the wrong length, and `parse_grid_shard` accepting
    and refusing the same specs;
(b) CLI against CLI: a Titanic grid of three scenarios (one per
    aggregation, "Independent scores") through both `main.main` in-process,
    each from its own working directory, the port fed the JAX package's
    initial params and permutations: the two `results.csv` have the same
    columns, rows and row order, and every value but the scenario name and
    the times is equal, the test score and the contributivity scores within
    one test sample; the same for `Scenario.to_dataframe()` of one scenario;
(c) the sharded grid (`--grid-shard 0/2`, `1/2`) and the port's
    `merge_shards`, to the JAX package's layout (tests/test_e2e.py);
(d) `chip_smoke.py`'s results columns are the JAX `to_dataframe()`'s, the
    dry runs write no scenario folder, and without `--device` a machine
    without CUDA fails before writing anything.
"""

import ast
import logging
import re
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import main as jmain
from mplc_tpu import utils as jutils
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.models import zoo as jzoo
from mplc_tpu.mpl.engine import MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.scenario import Scenario as JScenario
from mplc_tpu_torch import main as tmain
from mplc_tpu_torch import merge_shards, utils
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.convert import params_from_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.mpl.approaches import MultiPartnerLearning
from mplc_tpu_torch.scenario import Scenario
from test_torch_sweep import _jax_single_perms, _stacked_np

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _restore_loggers():
    """The CLIs replace their loggers' handlers (a console on the test's
    captured stdout, log files): put the old ones back after each test."""
    loggers = [logging.getLogger(name) for name in ("mplc_tpu", "mplc_tpu_torch")]
    saved = [(lg, list(lg.handlers), lg.level) for lg in loggers]
    yield
    for lg, handlers, level in saved:
        for h in list(lg.handlers):
            if h not in handlers:
                lg.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in lg.handlers:
                lg.addHandler(h)
        lg.setLevel(level)

# ---------------------------------------------------------------------------
# (a) the grid
# ---------------------------------------------------------------------------

GRIDS = {
    "product": [{"dataset_name": ["mnist"], "partners_count": [3],
                 "amounts_per_partner": [[0.2, 0.3, 0.5]], "epoch_count": [2, 4],
                 "minibatch_count": [2, 3]}],
    "dataset dict": [{"dataset_name": {"mnist": None, "titanic": ["a.npz", "b.npz"]},
                      "partners_count": [2], "amounts_per_partner": [[0.5, 0.5]]}],
    "amounts mismatch": [{"dataset_name": ["mnist"], "partners_count": [3],
                          "amounts_per_partner": [[0.5, 0.5]]}],
    "advanced mismatch": [{"dataset_name": ["mnist"], "partners_count": [2],
                           "amounts_per_partner": [[0.5, 0.5]],
                           "samples_split_option": [["advanced", [[2, "shared"]]]]}],
    "corruption mismatch": [{"dataset_name": ["mnist"], "partners_count": [2],
                             "amounts_per_partner": [[0.5, 0.5]],
                             "corrupted_datasets": [["not_corrupted"]]}],
}


def _expand(fn, grid):
    try:
        return fn(grid)
    except Exception as e:  # noqa: BLE001 - the outcome compared
        return type(e), str(e)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_expansion_matches_jax(name):
    out = _expand(utils.get_scenario_params_list, GRIDS[name])
    assert out == _expand(jutils.get_scenario_params_list, GRIDS[name])
    if name == "dataset dict":
        assert [(p["dataset_name"], p["init_model_from"]) for p in out] == [
            ("mnist", "random_initialization"), ("titanic", "a.npz"), ("titanic", "b.npz")]
    elif "mismatch" in name:
        assert out[0] is Exception and "partners" in out[1]


@pytest.mark.parametrize("config", ["config.yml", "config_quick_debug.yml"])
def test_config_files_expand_like_jax(config):
    cfg = utils.load_cfg(REPO / "configs" / config)
    assert cfg == jutils.load_cfg(REPO / "configs" / config)
    params = utils.get_scenario_params_list(cfg["scenario_params_list"])
    assert params == jutils.get_scenario_params_list(cfg["scenario_params_list"])
    assert len(params) == {"config.yml": 2 * 3 * 4 * 2 + 2, "config_quick_debug.yml": 3}[config]


@pytest.mark.parametrize("spec", ["0/2", "1/2", "3/10", "2/2", "-1/2", "0/0", "1", "a/b",
                                  "1/2/3", ""])
def test_parse_grid_shard_matches_jax(spec):
    assert _expand(utils.parse_grid_shard, spec) == _expand(jutils.parse_grid_shard, spec)


# ---------------------------------------------------------------------------
# (b) CLI against CLI, with the JAX package's random streams
# ---------------------------------------------------------------------------

JMODELS = {"titanic": jzoo.TITANIC_LOGREG}

TITANIC_GRID = (
    "experiment_name: {name}\n"
    "n_repeats: 1\n"
    "scenario_params_list:\n"
    "  - dataset_name:\n"
    "      titanic: null\n"
    "    partners_count: [2]\n"
    "    amounts_per_partner: [[0.4, 0.6]]\n"
    "    samples_split_option: [['basic', 'random']]\n"
    "    multi_partner_learning_approach: ['fedavg']\n"
    "    aggregation_weighting: ['uniform', 'data-volume', 'local-score']\n"
    "    epoch_count: [2]\n"
    "    minibatch_count: [2]\n"
    "    gradient_updates_per_pass_count: [2]\n"
    "    is_early_stopping: [False]\n"
    "    methods: [['Independent scores']]\n")


def _jax_mask(partners):
    """The JAX package's stacked validity mask [P, Nmax] of `partners`."""
    sizes = np.array([len(p.x_train) for p in partners])
    return jnp.asarray((np.arange(sizes.max())[None] < sizes[:, None]).astype(np.float32))


def _coalition_rng(seed, subset):
    """The JAX engine's per-coalition key (fewer than 32 partners)."""
    return jax.random.fold_in(jax.random.PRNGKey(seed), sum(1 << int(i) for i in subset))


def _jax_fit_start(self):
    """The JAX fit's initial params and permutations (one chunk of all
    epochs: early stopping off, or epoch_count <= patience)."""
    jmodel = JMODELS[self.dataset_name]
    rng = jax.random.PRNGKey(self.seed)
    mask = _jax_mask(self.partners_list)
    E = self.epoch_count
    if self.approach_key == "single":
        perms = _jax_single_perms(rng, mask[0], E)
    else:
        jtrainer = JTrainer(jmodel, JConfig(
            approach=self.approach_key, aggregator=self.aggregation_method, epoch_count=E,
            minibatch_count=self.minibatch_count,
            gradient_updates_per_pass=self.cfg.gradient_updates_per_pass))
        perms = np.asarray(jtrainer.gen_epoch_streams(rng, mask, 0, E)[0])
    return ([torch.Generator().manual_seed(self.seed)],
            params_from_numpy(_stacked_np([jmodel.init(rng)])), torch.from_numpy(np.array(perms))[None])


def _jax_batch_start(self, subsets, single, replicas=None):
    """The JAX engine's initial params and permutations of singles."""
    assert single, "only singles are fed the JAX package's streams"
    jmodel = JMODELS[self.scenario.dataset.name]
    rngs = [_coalition_rng(self.seed, s) for s in subsets]
    mask = _jax_mask(self.partners_list)
    perms = np.stack([_jax_single_perms(r, mask[s[0]], self.scenario.epoch_count)
                      for s, r in zip(subsets, rngs)])
    return ([self.coalition_generator(s) for s in subsets],
            params_from_numpy(_stacked_np([jmodel.init(r) for r in rngs])),
            torch.from_numpy(perms))


@pytest.fixture
def jax_streams(monkeypatch, tmp_path):
    """The port's fits and engines drawing the JAX package's streams; no
    cached data in either package."""
    monkeypatch.setattr(MultiPartnerLearning, "_fit_start", _jax_fit_start)
    monkeypatch.setattr(CharacteristicEngine, "_batch_start", _jax_batch_start)
    for knob in ("MPLC_TPU_DATA_DIR", "MPLC_TORCH_DATA_DIR", "MPLC_TPU_PARTNER_SHARDS",
                 "MPLC_TPU_PRECISION", "MPLC_TORCH_PRECISION"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))


def _run_cli(monkeypatch, main, folder: Path, grid: str, *args) -> int:
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "cfg.yml").write_text(grid)
    monkeypatch.chdir(folder)
    return main(["-f", "cfg.yml", *args])


N_TEST = 90     # Titanic's test rows: one sample is 1/90
SKIPPED = ("scenario_name", "learning_computation_time_sec", "computation_time_sec")
SCORES = ("mpl_test_score", "contributivity_score", "contributivity_scores")


def _numbers(text: str) -> list:
    return [float(x) for x in re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?",
                                         re.sub(r"np\.float\d+", "", text))]


def _assert_frames_match(df: pd.DataFrame, jdf: pd.DataFrame):
    assert list(df.columns) == list(jdf.columns)
    assert len(df) == len(jdf)
    for col in df.columns:
        if col in SKIPPED:
            continue
        if col in SCORES:
            for a, b in zip(df[col], jdf[col]):
                a, b = (_numbers(v) if isinstance(v, str) else [v] for v in (a, b))
                np.testing.assert_allclose(a, b, rtol=0, atol=1.0 / N_TEST + 1e-6, err_msg=col)
        else:
            pd.testing.assert_series_equal(df[col], jdf[col], check_dtype=False, obj=col)


def test_titanic_grid_writes_the_jax_results(monkeypatch, tmp_path, jax_streams):
    grid = TITANIC_GRID.format(name="cli_test")
    assert _run_cli(monkeypatch, jmain.main, tmp_path / "jax", grid) == 0
    assert _run_cli(monkeypatch, tmain.main, tmp_path / "port", grid, "--device", "cpu") == 0
    (jexp,) = (tmp_path / "jax" / "experiments").glob("cli_test_*")
    (exp,) = (tmp_path / "port" / "experiments").glob("cli_test_*")
    jdf, df = pd.read_csv(jexp / "results.csv"), pd.read_csv(exp / "results.csv")
    _assert_frames_match(df, jdf)
    assert len(df) == 3 * 2 and list(df["scenario_id"]) == [0, 0, 1, 1, 2, 2]
    assert (df["contributivity_method"] == "Independent scores raw").all()
    assert list(df["aggregation"]) == ["uniform"] * 2 + ["data-volume"] * 2 + ["local-score"] * 2
    # the same folder layout: the config copy, the logs, one folder a scenario
    # with its final weights, history and coalition cache
    names = lambda p: sorted(f.name for f in p.iterdir() if not f.name.startswith("scenario_"))  # noqa: E731
    assert names(exp) == names(jexp) == ["cfg.yml", "debug.log", "info.log", "results.csv"]
    folders = sorted(exp.glob("scenario_*"))
    assert [f.name[:21] for f in folders] == [f"scenario_{i}_repeat_1_2" for i in (1, 2, 3)]
    for f in folders:
        for part in ("model/titanic_final_weights.npz", "history_data.p", "coalition_cache.json",
                     "graphs/data_distribution.png"):
            assert (f / part).exists(), part
    assert "Results saved to" in (exp / "info.log").read_text()


def test_to_dataframe_matches_jax(tmp_path, jax_streams):
    kw = dict(partners_count=3, amounts_per_partner=[0.2, 0.3, 0.5],
              aggregation_weighting="local-score", epoch_count=2, minibatch_count=2,
              gradient_updates_per_pass_count=2, is_early_stopping=False,
              methods=["Independent scores"], seed=4, is_dry_run=True)
    jsc = JScenario(dataset=jdatasets.load_titanic(), **kw)
    sc = Scenario(dataset=tdatasets.load_titanic(), device="cpu", **kw)
    jsc.run()
    sc.run()
    _assert_frames_match(sc.to_dataframe(), jsc.to_dataframe())


# ---------------------------------------------------------------------------
# (c) the sharded grid and the merge
# ---------------------------------------------------------------------------

def test_grid_shards_and_merge(monkeypatch, tmp_path, capsys):
    grid = TITANIC_GRID.format(name="shard_test")
    for shard in ("0/2", "1/2"):
        assert _run_cli(monkeypatch, tmain.main, tmp_path, grid, "--grid-shard", shard,
                        "--device", "cpu") == 0
    shared = tmp_path / "experiments" / "shard_test_sharded2"
    assert shared.is_dir()
    assert not list((tmp_path / "experiments").glob("shard_test_2*"))
    ids = {}
    for i in (0, 1):
        assert (shared / f"config_shard{i}.yml").exists()
        assert (shared / f".shard{i}.done").exists()
        ids[i] = set(pd.read_csv(shared / f"results_shard{i}.csv")["scenario_id"])
    assert ids == {0: {0, 2}, 1: {1}}
    marker = shared / ".shard1.done"
    marker.unlink()
    with pytest.raises(SystemExit):
        merge_shards.main([str(shared)])
    assert "no done markers" in capsys.readouterr().err
    marker.touch()
    assert merge_shards.main([str(shared)]) == 0
    merged = pd.read_csv(shared / "results.csv")
    assert list(merged["scenario_id"]) == [0, 0, 1, 1, 2, 2]
    assert not list(shared.glob("results_shard*.csv"))
    assert len(list(shared.glob("results_shard*.csv.merged"))) == 2
    assert not list(shared.glob(".shard*.done"))
    # a re-run of shard 0 into the folder starts its csv and marker anew
    (shared / ".shard0.done").touch()
    assert _run_cli(monkeypatch, tmain.main, tmp_path, grid, "--grid-shard", "0/2",
                    "--device", "cpu") == 0
    assert set(pd.read_csv(shared / "results_shard0.csv")["scenario_id"]) == {0, 2}
    assert len(pd.read_csv(shared / "results_shard0.csv")) == 4


# ---------------------------------------------------------------------------
# (d) chip_smoke's columns, dry runs, the device
# ---------------------------------------------------------------------------

def _chip_smoke_constant(name: str):
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"chip_smoke.py has no constant {name}")


def test_chip_smoke_results_columns_are_the_jax_columns():
    """The card's machine has no JAX: this holds chip_smoke.py's constant to
    the JAX `to_dataframe()` of a Titanic scenario with a method, plus the
    two columns the CLI adds."""
    jsc = JScenario(2, [0.4, 0.6], dataset=jdatasets.load_titanic(), epoch_count=1,
                    minibatch_count=1, gradient_updates_per_pass_count=1,
                    methods=["Independent scores"], is_dry_run=True)
    jsc.run()
    columns = list(jsc.to_dataframe().columns) + ["random_state", "scenario_id"]
    assert _chip_smoke_constant("RESULTS_COLUMNS") == columns


def test_dry_runs_write_no_scenario_folder(tmp_path):
    grid = utils.get_scenario_params_list(ast.literal_eval(
        "[{'dataset_name': ['titanic'], 'partners_count': [2], "
        "'amounts_per_partner': [[0.4, 0.6]], 'samples_split_option': "
        "[['basic', 'random'], ['advanced', [[1, 'specific'], [1, 'specific']]]]}]"))
    tmain.validate_scenario_list(grid, tmp_path / "exp", device="cpu")
    assert not (tmp_path / "exp").exists()
    grid[1]["samples_split_option"] = ["advanced", [[2, "specific"], [1, "specific"]]]
    with pytest.raises(AssertionError, match="exceed the number of labels"):
        tmain.validate_scenario_list(grid, tmp_path / "exp", device="cpu")


def test_without_cuda_the_cli_fails_before_writing(monkeypatch, tmp_path, caplog):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    caplog.set_level(logging.ERROR, logger="mplc_tpu_torch")
    assert _run_cli(monkeypatch, tmain.main, tmp_path, TITANIC_GRID.format(name="x")) == 1
    assert "no CUDA device is available" in caplog.text
    assert not (tmp_path / "experiments").exists()


def test_without_matplotlib_only_the_graphs_are_skipped(monkeypatch, tmp_path, caplog):
    """The machine with the card has no matplotlib: a scenario then writes
    its weights, history pickle and coalition cache, draws no graph and
    warns once, naming the package."""
    import mplc_tpu_torch.mpl.history as history
    import mplc_tpu_torch.scenario as scenario
    monkeypatch.setattr(scenario, "pyplot", lambda: None)
    monkeypatch.setattr(history, "pyplot", lambda: None)
    caplog.set_level(logging.WARNING, logger="mplc_tpu_torch")
    sc = Scenario(2, [0.4, 0.6], dataset=tdatasets.load_titanic(), epoch_count=1,
                  minibatch_count=1, gradient_updates_per_pass_count=1,
                  methods=["Independent scores"], experiment_path=tmp_path, device="cpu")
    sc.run()
    for part in ("model/titanic_final_weights.npz", "history_data.p", "coalition_cache.json"):
        assert (sc.save_folder / part).exists(), part
    assert not (sc.save_folder / "graphs").exists()
    warnings = [r for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(warnings) == 1 and sc.scenario_name in warnings[0].getMessage()
    assert np.isfinite(sc.to_dataframe()["contributivity_score"]).all()
