"""The port's public API against the JAX package's, on the CPU, one torch
thread:

- every subpackage's `__all__` equals the JAX package's, less the names
  that have no counterpart by design (the optax helpers
  `adam_like_keras` and `rmsprop_like_keras`, `ops.aggregation.broadcast`);
  every listed name imports; `service` exports `FleetRouter` and
  `RoutedJobFailed`, and the router's, the fleet collector's and the
  fleet sweep's modules (`service.router`, `obs.fleet_view`,
  `parallel.fleet`) have the JAX modules' public names; `parallel`
  exports the JAX package's mesh names and `PartnerShardedTrainer`, and
  reaches the fleet as `parallel.fleet`;
- `import mplc_tpu_torch` loads `constants` and `obs`, as `import
  mplc_tpu` does, and no torch;
- after a 2-partner Titanic Shapley run in both packages (the port fed
  the JAX package's initial params and permutations, early stopping
  firing in the fit), the Scenario's and the learner's public attributes
  have the same names (the port adds `device`) and the same values,
  `epoch_index` included; the Contributivity passthroughs, `power_set` and
  `bitmask_to_subset` agree; `str(contributivity)` equals the JAX
  package's but for its time line.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import mplc_tpu
from mplc_tpu.contrib import contributivity as jcontrib, shapley as jshapley
from mplc_tpu.mpl.engine import MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.scenario import Scenario as JScenario
import mplc_tpu_torch
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib import contributivity as tcontrib, shapley as tshapley
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.convert import params_from_numpy
from mplc_tpu_torch.mpl.approaches import MultiPartnerLearning
from mplc_tpu_torch.scenario import Scenario
from test_torch_sweep import _jax_single_perms, _stacked_np, _titanic

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# names of the JAX package's `__all__` the port leaves out, and why
NOT_PORTED = {
    "models": {"adam_like_keras", "rmsprop_like_keras"},   # optax helpers
    "ops": {"broadcast"},          # aggregate reshapes its weights itself
}
SUBPACKAGES = ("contrib", "data", "models", "mpl", "ops", "obs", "live", "service")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_jax(sub):
    jmod = importlib.import_module(f"mplc_tpu.{sub}")
    tmod = importlib.import_module(f"mplc_tpu_torch.{sub}")
    assert set(tmod.__all__) == set(jmod.__all__) - NOT_PORTED.get(sub, set())
    assert len(tmod.__all__) == len(set(tmod.__all__))
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name
    # every left-out name exists on the JAX side (the list stays honest)
    assert NOT_PORTED.get(sub, set()) <= set(jmod.__all__)


# public names of the JAX modules a port module leaves out, and why
MODULE_NOT_PORTED = {
    "obs.fleet_view": set(),
    "service.router": set(),
    "parallel.fleet": set(),
}


def _module_api(mod) -> set:
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", None) == mod.__name__}


@pytest.mark.parametrize("name", sorted(MODULE_NOT_PORTED))
def test_router_and_fleet_view_modules_match_jax(name):
    jmod = importlib.import_module(f"mplc_tpu.{name}")
    tmod = importlib.import_module(f"mplc_tpu_torch.{name}")
    assert _module_api(tmod) == _module_api(jmod) - MODULE_NOT_PORTED[name]
    assert MODULE_NOT_PORTED[name] <= _module_api(jmod)
    from mplc_tpu_torch import service
    assert service.FleetRouter is importlib.import_module(
        "mplc_tpu_torch.service.router").FleetRouter
    assert issubclass(service.RoutedJobFailed, service.ServiceError)


def test_parallel_exports_wait_for_the_mesh():
    """`mplc_tpu.parallel` exports the mesh and the partner-sharded
    trainer; the port's `parallel` exports the same names, each its own
    module's, and reaches the fleet as `parallel.fleet`, as the JAX package
    does."""
    from mplc_tpu_torch import parallel
    jmod = importlib.import_module("mplc_tpu.parallel")
    assert parallel.__all__ == jmod.__all__ and "fleet" not in jmod.__all__
    assert set(jmod.__all__) == {"CoalitionSharding", "coalition_sharding", "make_mesh",
                                 "make_2d_mesh", "make_multihost_mesh",
                                 "PartnerShardedTrainer"}
    for name in parallel.__all__:
        module = ("partner_shard" if name == "PartnerShardedTrainer" else "mesh")
        assert getattr(parallel, name) is getattr(
            importlib.import_module(f"mplc_tpu_torch.parallel.{module}"), name)
        assert callable(getattr(parallel, name))
    assert importlib.import_module("mplc_tpu_torch.parallel.fleet").run_fleet


def test_engine_signature_matches_jax():
    """`CharacteristicEngine(scenario, share_data_from=None,
    seed_ensemble=None)`: the JAX engine's parameters, in its order, with
    its defaults."""
    import inspect
    from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
    jsig = inspect.signature(JEngine.__init__).parameters
    tsig = inspect.signature(CharacteristicEngine.__init__).parameters
    assert list(tsig) == list(jsig) == ["self", "scenario", "share_data_from",
                                        "seed_ensemble"]
    assert [p.default for p in tsig.values()] == [p.default for p in jsig.values()]


def test_package_import_loads_constants_and_obs():
    code = ("import sys, mplc_tpu_torch; "
            "print('mplc_tpu_torch.constants' in sys.modules, "
            "'mplc_tpu_torch.obs' in sys.modules, 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True, env={"PYTHONPATH": str(ROOT), "PATH": ""})
    assert out.stdout.split() == ["True", "True", "False"]
    assert mplc_tpu_torch.constants is constants and hasattr(mplc_tpu, "constants")


def test_powerset_and_bitmask_helpers_match_jax():
    assert tcontrib.power_set([0, 1, 2, 3]) == jcontrib.power_set([0, 1, 2, 3])
    assert tcontrib.power_set(["a", "b"]) == jcontrib.power_set(["a", "b"])
    for mask in range(64):
        assert tshapley.bitmask_to_subset(mask) == jshapley.bitmask_to_subset(mask)
        assert tshapley.subset_to_bitmask(tshapley.bitmask_to_subset(mask)) == mask


GAME = dict(epoch_count=constants.PATIENCE + 2, minibatch_count=1,
            gradient_updates_per_pass_count=1, is_early_stopping=True,
            methods=["Shapley values"], seed=3)


@pytest.fixture
def runs(monkeypatch, tmp_path):
    """(JAX scenario, port scenario) after `run()` on the same 2-partner
    Titanic game (val labels partly flipped, so the fit stops early),
    both writing to `tmp_path`, both engines masked, the port fed the JAX
    package's streams."""
    for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
        for knob in ("SLOT_MERGE", "SLOT_POW2", "DETERMINISTIC_REDUCE", "PRECISION"):
            monkeypatch.delenv(pkg + knob, raising=False)
        monkeypatch.setenv(pkg + "NO_SLOTS", "1")
    jd, td = _titanic(0.7)
    jsc = JScenario(2, [0.4, 0.6], dataset=jd, experiment_path=str(tmp_path / "jax"), **GAME)
    jsc.run()
    jeng = jsc._charac_engine
    E = GAME["epoch_count"]

    def batch_start(self, subsets, single, replicas=None):
        rngs = [jeng._coalition_rng(s) for s in subsets]
        init = params_from_numpy(_stacked_np([jd.model.init(r) for r in rngs]))
        jtr = jeng.multi_pipe.trainer
        perms = torch.from_numpy(np.stack([
            _jax_single_perms(r, jeng.stacked.mask[s[0]], E) if single
            else np.asarray(jtr.gen_epoch_streams(r, jeng.stacked.mask, 0, E)[0])
            for s, r in zip(subsets, rngs)]))
        return [self.coalition_generator(s) for s in subsets], init, perms

    # the JAX fit's initial params and permutations, chunk by chunk as its
    # early-stopping fit runs them (chunks of `patience` epochs, each
    # folding the rng by its position and by the absolute epoch)
    jmask = jsc.mpl._stage()[0].mask
    jfit = JTrainer(jd.model, JConfig(
        approach="fedavg", aggregator=jsc.aggregation_name, epoch_count=E,
        minibatch_count=GAME["minibatch_count"],
        gradient_updates_per_pass=GAME["gradient_updates_per_pass_count"]))

    def fit_start(self):
        rng = jax.random.PRNGKey(self.seed)
        chunk = constants.PATIENCE
        perms = np.concatenate([np.asarray(jfit.gen_epoch_streams(
            rng, jmask, s, min(chunk, E - s))[0]) for s in range(0, E, chunk)])
        return ([torch.Generator().manual_seed(self.seed)],
                params_from_numpy(_stacked_np([jd.model.init(rng)])),
                torch.from_numpy(perms)[None])

    monkeypatch.setattr(CharacteristicEngine, "_batch_start", batch_start)
    monkeypatch.setattr(MultiPartnerLearning, "_fit_start", fit_start)
    sc = Scenario(2, [0.4, 0.6], dataset=td, experiment_path=str(tmp_path / "port"),
                  device="cpu", **GAME)
    sc.run()
    return jsc, sc


def _public(obj) -> dict:
    return {k: v for k, v in vars(obj).items() if not k.startswith("_")}


def _same(a, b) -> bool:
    """Value equality for the attribute kinds a scenario and a learner
    hold: scalars, strings, paths, arrays and (nested) lists or tuples of
    them; objects of either package (models, partners, trainers, datasets)
    are compared by their class name."""
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (bool, int, float, str, type(None))):
        return a == b
    if isinstance(a, Path) or isinstance(b, Path):
        return Path(a).name == Path(b).name
    return type(a).__name__ == type(b).__name__


# attributes whose values differ by nature: wall-clock times, names made
# from the clock, the folders under each package's own experiment path,
# the timestamped scenario name and what holds it
PER_RUN = {"learning_computation_time", "scenario_name", "save_folder",
           "experiment_path", "short_scenario_name"}


def test_scenario_and_learner_attributes_match_jax(runs):
    jsc, sc = runs
    js, ts = _public(jsc), _public(sc)
    assert set(ts) - set(js) == {"device"} and set(js) <= set(ts)
    jl, tl = _public(jsc.mpl), _public(sc.mpl)
    assert set(tl) - set(jl) == {"device"} and set(jl) <= set(tl)
    for name, (j, t) in (("scenario", (js, ts)), ("learner", (jl, tl))):
        for k in sorted(set(j) - PER_RUN):
            if k in ("contributivity_list", "partners_list", "mpl", "dataset",
                     "history", "model", "trainer", "cfg", "model_params"):
                continue   # objects of each package, compared below or in their own tests
            assert _same(j[k], t[k]), (name, k, j[k], t[k])
    assert sc.aggregation == jsc.aggregation == "data-volume"
    # the fit stopped early, in both packages at the same epoch
    assert sc.mpl.epoch_index == jsc.mpl.epoch_index < GAME["epoch_count"]
    assert (sc.mpl.minibatch_index, sc.mpl.gradient_updates_per_pass_count,
            sc.mpl.compute_dtype) == (jsc.mpl.minibatch_index,
                                      jsc.mpl.gradient_updates_per_pass_count,
                                      jsc.mpl.compute_dtype)
    for t, j in zip(sc.mpl.val_data + sc.mpl.test_data, jsc.mpl.val_data + jsc.mpl.test_data):
        np.testing.assert_array_equal(t, j)


def test_contributivity_passthroughs_and_str_match_jax(runs):
    jsc, sc = runs
    jc, tc = jsc.contributivity_list[0], sc.contributivity_list[0]
    assert tc.charac_fct_values is sc._charac_engine.charac_fct_values
    assert tc.increments_values is sc._charac_engine.increments_values
    assert sorted(tc.charac_fct_values) == sorted(jc.charac_fct_values)
    n_test = len(sc.dataset.x_test)
    for s, v in jc.charac_fct_values.items():
        assert abs(tc.charac_fct_values[s] - v) <= 1.0 / n_test + 1e-6, s
    assert tc.first_charac_fct_calls_count == jc.first_charac_fct_calls_count == 3
    assert tc.not_twice_characteristic([1, 0]) == tc.charac_fct_values[(0, 1)]
    assert tc.first_charac_fct_calls_count == 3      # memoized: nothing trained

    def lines(c):
        return [ln for ln in str(c).splitlines() if not ln.startswith("Computation time")]
    assert lines(tc) == lines(jc)
    assert "Number of characteristic function computed: 3" in str(tc)
