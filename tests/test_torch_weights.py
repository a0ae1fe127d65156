"""Saved weights and the single-partner class of the PyTorch port against
the JAX package:

(a) a weights file saved by the port loads in the JAX `load_params_npz`
    bit-equal, with JAX's `treedef` entry, and a JAX file loads in the port
    bit-equal (no pickle); a file of another model is refused;
(b) a Titanic fedavg fit started from a JAX weights file (`init_model_from`)
    matches the JAX fit from it, the port fed the JAX fit's permutations:
    params within 1e-4, the test score within one test sample; with
    `is_save_data` it writes `model/titanic_final_weights.npz`, which the
    JAX package reads back as the fit's final params;
(c) `SinglePartnerLearning` on Titanic against JAX's, fed its initial
    params and permutations, staging its partner's rows only.
"""

import numpy as np
import pytest
import torch

import jax

from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.mpl import approaches as japproaches
from mplc_tpu.models import zoo as jzoo
from mplc_tpu.scenario import Scenario as JScenario
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.mpl import approaches
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.scenario import Scenario
from test_torch_sweep import _jax_single_perms

torch.set_num_threads(1)

AMOUNTS = [0.2, 0.3, 0.5]
GAME = dict(epoch_count=3, minibatch_count=2, gradient_updates_per_pass_count=2,
            is_early_stopping=False, seed=11)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("model", ["TITANIC_LOGREG", "MNIST_CNN"])
def test_weights_files_load_bit_equal_both_ways(tmp_path, model):
    jmodel, tmodel = getattr(jzoo, model), getattr(tzoo, model)
    params = tmodel.init(torch.Generator().manual_seed(3))
    approaches.save_params_npz(tmp_path / "port.npz", params)
    jtemplate = jmodel.init(jax.random.PRNGKey(0))
    loaded = japproaches.load_params_npz(tmp_path / "port.npz", jtemplate)
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(jtemplate)
    for a, b in zip(_leaves(loaded), _leaves(params_to_numpy(params))):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)

    japproaches.save_params_npz(tmp_path / "jax.npz", jtemplate)
    with np.load(tmp_path / "jax.npz") as f, np.load(tmp_path / "port.npz") as g:
        assert sorted(f.files) == sorted(g.files)
        assert str(f["treedef"]) == str(g["treedef"])
    back = approaches.load_params_npz(tmp_path / "jax.npz", params, "cpu")
    for a, b in zip(_leaves(params_to_numpy(back)), _leaves(jtemplate)):
        assert np.array_equal(a, b)


def test_weights_of_another_model_are_refused(tmp_path):
    approaches.save_params_npz(tmp_path / "w.npz", tzoo.TITANIC_LOGREG.init(torch.Generator()))
    with pytest.raises(ValueError, match="do not fit the model"):
        approaches.load_params_npz(tmp_path / "w.npz",
                                   tzoo.MNIST_CNN.init(torch.Generator()), "cpu")


def _scenarios(tmp_path, **kw):
    """The same Titanic scenario in both packages, split and ready to fit."""
    out = []
    for build in (lambda: JScenario(3, AMOUNTS, dataset=jdatasets.load_titanic(),
                                    experiment_path=tmp_path / "jax", **GAME, **kw),
                  lambda: Scenario(3, AMOUNTS, dataset=tdatasets.load_titanic(),
                                   experiment_path=tmp_path / "port", device="cpu",
                                   **GAME, **kw)):
        sc = build()
        sc.instantiate_scenario_partners()
        sc.split_data(is_logging_enabled=False)
        sc.compute_batch_sizes()
        sc.data_corruption()
        out.append(sc)
    return out


def _assert_fits_match(jmpl, mpl, n_test):
    for a, b in zip(_leaves(jmpl.model_params), _leaves(params_to_numpy(mpl.model_params))):
        # rounding accumulated over 6 rounds of aggregation
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    assert abs(mpl.history.score - jmpl.history.score) <= 1.0 / n_test + 1e-6


def test_warm_start_fit_matches_jax(tmp_path, monkeypatch):
    weights = tmp_path / "start.npz"
    japproaches.save_params_npz(
        weights, jzoo.TITANIC_LOGREG.init(jax.random.PRNGKey(99)))
    jsc, sc = _scenarios(tmp_path, init_model_from=str(weights))
    assert jsc.use_saved_weights and sc.use_saved_weights
    jmpl = japproaches.FederatedAverageLearning(jsc, is_save_data=True)
    jmpl.fit()
    mpl = approaches.FederatedAverageLearning(sc, is_save_data=True)
    jstacked = jmpl._stage()[0]
    perms = jmpl.trainer.gen_epoch_streams(jax.random.PRNGKey(GAME["seed"]), jstacked.mask,
                                           0, GAME["epoch_count"])[0]
    gens, _, _ = mpl._fit_start()
    monkeypatch.setattr(mpl, "_fit_start", lambda: (
        gens, None, torch.from_numpy(np.asarray(perms))[None]))
    mpl.fit()
    _assert_fits_match(jmpl, mpl, len(sc.dataset.x_test))

    saved = sc.save_folder / "model" / "titanic_final_weights.npz"
    final = japproaches.load_params_npz(saved, jzoo.TITANIC_LOGREG.init(jax.random.PRNGKey(0)))
    for a, b in zip(_leaves(final), _leaves(params_to_numpy(mpl.model_params))):
        assert np.array_equal(a, b)
    assert (sc.save_folder / "history_data.p").exists()


def test_warm_start_draws_the_cold_start_streams(tmp_path):
    """Only the initial params differ: a fit from a weights file holding a
    cold fit's initial params trains that fit's trajectory bit for bit."""
    _, cold = _scenarios(tmp_path)
    init = tzoo.TITANIC_LOGREG.init(torch.Generator().manual_seed(GAME["seed"]))
    approaches.save_params_npz(tmp_path / "init.npz", init)
    _, warm = _scenarios(tmp_path, init_model_from=str(tmp_path / "init.npz"))
    fits = [approaches.FederatedAverageLearning(sc) for sc in (cold, warm)]
    for mpl in fits:
        mpl.fit()
    for a, b in zip(*(_leaves(params_to_numpy(m.model_params)) for m in fits)):
        assert np.array_equal(a, b)


def test_single_partner_learning_matches_jax(tmp_path, monkeypatch):
    jsc, sc = _scenarios(tmp_path)
    jmpl = japproaches.SinglePartnerLearning(jsc, partner=jsc.partners_list[1])
    jmpl.fit()
    mpl = approaches.SinglePartnerLearning(sc, partner=sc.partners_list[1])
    stacked = mpl._stage()[0]
    assert tuple(stacked.x.shape[:2]) == (1, len(sc.partners_list[1].x_train))
    rng = jax.random.PRNGKey(GAME["seed"])
    jinit = jax.tree_util.tree_map(lambda a: np.asarray(a)[None], jzoo.TITANIC_LOGREG.init(rng))
    perms = _jax_single_perms(rng, jmpl._stage()[0].mask[0], GAME["epoch_count"])
    gens, _, _ = mpl._fit_start()
    monkeypatch.setattr(mpl, "_fit_start", lambda: (
        gens, params_from_numpy(jinit), torch.from_numpy(perms)[None]))
    mpl.fit()
    assert mpl.history.nb_epochs_done == jmpl.history.nb_epochs_done == GAME["epoch_count"]
    _assert_fits_match(jmpl, mpl, len(sc.dataset.x_test))
    with pytest.raises(ValueError, match="More than one partner"):
        approaches.SinglePartnerLearning(sc, partner=sc.partners_list)
