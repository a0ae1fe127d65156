"""The retrain-free slice of the PyTorch port against the JAX package:

(a) the recording trajectory of masked FedAvg on Titanic, fed JAX's
    initial parameters and JAX's epoch permutations;
(b) a JAX `RecordedRun` reconstructed and evaluated by the port's
    ReconstructionEvaluator: every v(S) and the exact Shapley values;
(c) the port on its own: a tiny MNIST CNN `Scenario.run()` with GTG-Shapley;
    the methods of the last slice each dispatching.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import build_scenario
from mplc_tpu.contrib.contributivity import Contributivity as JContributivity
from mplc_tpu.contrib.shapley import shapley_from_characteristic as jshapley
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.data.partition import StackedPartners as JStacked, stack_eval_set as jstack_eval
from mplc_tpu.data.partner import Partner as JPartner
from mplc_tpu.data.partition import split_basic as jsplit
from mplc_tpu.mpl.engine import EvalSet as JEvalSet, MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.models import zoo as jzoo
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.reconstruct import ReconstructionEvaluator
from mplc_tpu_torch.contrib.shapley import powerset_order, shapley_from_characteristic
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy, recorded_run_from_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data.datasets import Dataset, to_categorical
from mplc_tpu_torch.data.partition import StackedPartners, split_basic
from mplc_tpu_torch.data.partner import Partner
from mplc_tpu_torch.mpl.approaches import stage_eval_set
from mplc_tpu_torch.mpl.engine import MplTrainer, TrainConfig
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.ops import recon_kernel
from mplc_tpu_torch.scenario import Scenario

torch.set_num_threads(1)

AMOUNTS = [0.2, 0.3, 0.5]
GAME = dict(epoch_count=2, minibatch_count=2, gradient_updates_per_pass_count=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_titanic_recording_trajectory_matches_jax():
    jd, td = jdatasets.load_titanic(), tdatasets.load_titanic()
    jp = [JPartner(i) for i in range(3)]
    tp = [Partner(i) for i in range(3)]
    jsplit(jd, jp, AMOUNTS, "random", 2)
    split_basic(td, tp, AMOUNTS, "random", 2)
    cfg = dict(approach="fedavg", aggregator="data-volume", epoch_count=2,
               minibatch_count=2, gradient_updates_per_pass=2,
               is_early_stopping=False, record_partner_val=False,
               record_val_history=False, record_updates=True)

    jtrainer = JTrainer(jzoo.TITANIC_LOGREG, JConfig(**cfg))
    rng = jax.random.PRNGKey(5)
    jstacked = JStacked.build(jp, 1)
    jval = JEvalSet(*jstack_eval(jd.x_val, jd.y_val, 1, 128))
    mask = jnp.ones((3,), jnp.float32)
    jstate = jtrainer.init_state(rng, 3)
    init_np = _np(jstate.params)
    jstate = jax.jit(jtrainer.epoch_chunk, static_argnames=("n_epochs",))(
        jstate, jstacked, jval, mask, rng, n_epochs=2)
    # the exact per-epoch permutations the JAX run trained on
    perms, _ = jtrainer.gen_epoch_streams(rng, jstacked.mask, 0, 2)

    trainer = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(**cfg))
    state = trainer.init_state(None, 3, "cpu", init_params=params_from_numpy(
        jax.tree_util.tree_map(lambda a: a[None], init_np)))
    trainer.epoch_chunk(state, StackedPartners.build(tp, 1, "cpu"),
                        stage_eval_set(td.x_val, td.y_val, 1, "cpu"),
                        torch.ones(1, 3), None, 2,
                        streams_all=torch.from_numpy(np.array(perms))[None])
    state = state.row(0)
    assert state.done and state.nb_epochs_done == 2

    # data-volume weights are ratios of integer sizes
    np.testing.assert_allclose(state.w_h.numpy(), np.asarray(jstate.w_h), rtol=1e-6)
    for g, d in params_to_numpy(state.upd_h).items():
        for k, v in d.items():
            # per-round deltas of a few Adam steps, fp32 rounding
            np.testing.assert_allclose(v, np.asarray(jstate.upd_h[g][k]), rtol=0, atol=1e-5)
    for g, d in params_to_numpy(state.params).items():
        for k, v in d.items():
            # rounding accumulated over 4 rounds of aggregation
            np.testing.assert_allclose(v, np.asarray(jstate.params[g][k]), rtol=0, atol=1e-4)


def test_jax_recording_reconstructed_by_the_port():
    jsc = build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True, **GAME)
    jrecon = JContributivity(jsc)._reconstructor()
    coalitions = powerset_order(3)
    jvalues = jrecon.evaluate(coalitions)
    rec = jrecon.recorded

    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), seed=3,
                  is_early_stopping=False, device="cpu", **GAME)
    sc.instantiate_scenario_partners()
    sc.split_data()
    recon = ReconstructionEvaluator(CharacteristicEngine(sc), recorded_run_from_numpy(
        _np(rec.init_params), _np(rec.deltas), np.asarray(rec.weights)))
    values = recon.evaluate(coalitions)

    n_test = len(sc.dataset.x_test)
    # at most one test sample may flip at a decision boundary
    np.testing.assert_allclose(values, jvalues, rtol=0, atol=1.0 / n_test + 1e-6)
    sv = shapley_from_characteristic(3, recon.values)
    jsv = jshapley(3, jrecon.values)
    np.testing.assert_allclose(sv, jsv, rtol=0, atol=2.0 / n_test)
    assert list(np.argsort(sv)) == list(np.argsort(jsv))


def _tiny_mnist(seed=7):
    """The JAX suite's `tiny_image_dataset` recipe, as a port Dataset."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 1, (10, 28, 28, 1)).astype(np.float32)

    def make(n):
        y = rng.integers(0, 10, n)
        x = np.clip(protos[y] + rng.normal(0, 0.25, (n, 28, 28, 1)), 0, 1).astype(np.float32)
        return x, to_categorical(y, 10)
    x, y = make(700)
    xt, yt = make(150)
    return Dataset("mnist", (28, 28, 1), 10, x, y, xt, yt, model=tzoo.MNIST_CNN)


def test_port_scenario_gtg_on_mnist_cnn():
    launches = recon_kernel.launches
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=_tiny_mnist(), epoch_count=1,
                  minibatch_count=2, gradient_updates_per_pass_count=1,
                  is_early_stopping=False, methods=["GTG-Shapley"], device="cpu")
    sc.run()
    assert np.isfinite(sc.mpl.history.score)
    gtg = sc.contributivity_list[0]
    assert gtg.name == "GTG-Shapley"
    assert np.isfinite(gtg.contributivity_scores).all()
    assert gtg.trust["source"] == "mc_blocks"

    recon = sc._charac_engine._reconstruction
    rec = recon.recorded
    grand = recon_kernel.reconstruct_batch(torch.ones(1, 3), rec.init_params,
                                           rec.deltas, rec.weights)
    for g, d in rec.final_params.items():
        for k, v in d.items():
            # aggregation weights sum to 1: replay == training up to rounding
            np.testing.assert_allclose(grand[g][k][0].numpy(), v.numpy(), rtol=0, atol=1e-5)
    # GTG values come from the same memo exact_reconstructed fills
    c = Contributivity(sc)
    c.exact_reconstructed()
    assert len(recon.values) == 2 ** 3
    assert np.isfinite(c.contributivity_scores).all()
    assert recon_kernel.launches == launches       # no kernel on the CPU


def test_scenario_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic())


@pytest.mark.parametrize("method", ["Federated SBS linear", "Federated SBS quadratic",
                                    "Federated SBS constant", "LFlip", "PVRL"])
def test_unported_methods_raise(method):
    """The five methods the earlier slices left unported (they raised
    NotImplementedError) now dispatch through `Scenario.run()` and give
    finite scores; LFlip needs a categorical model, the tiny MNIST CNN."""
    lflip = method == "LFlip"
    sc = Scenario(3, AMOUNTS, is_dry_run=True, device="cpu", methods=[method],
                  dataset=_tiny_mnist() if lflip else tdatasets.load_titanic(),
                  **{**GAME, **({"epoch_count": 1, "gradient_updates_per_pass_count": 1}
                                if lflip else {})})
    sc.run()
    (c,) = sc.contributivity_list
    assert c.name and np.isfinite(c.contributivity_scores).all()
    assert c.contributivity_scores.shape == (3,) and c.contributivity_scores.any()
