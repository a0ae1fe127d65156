"""The label-flip trainer of the PyTorch port (lflip) and its LFlip score
against the JAX package, on the CPU:

(a) the port's EM step and label draw against the JAX package's
    `_lflip_flip`, on the same predictions, labels, theta and uniforms
    (a window with invalid rows; a theta with a zero row, which stays
    zero): new theta within 1e-6, drawn labels equal;
(b) 2 epochs of a 3-epoch lflip run on the tiny MNIST CNN against the JAX
    package's jitted `run_epoch`, each epoch from JAX's state at its start,
    fed JAX's permutations and label-draw uniforms: theta and `theta_h`
    within 1e-5, the third epoch's `theta_h` NaN in both; params within
    1e-4 but for the few weights Adam moves by whole steps (see
    MAX_STEP_SHARE); the History's theta None for the epoch not run;
(c) `MplLabelFlip` refusing a binary model in both packages;
(d) the LFlip scores of both packages on the same thetas, bit-equal.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import build_scenario
from mplc_tpu.contrib.contributivity import Contributivity as JContributivity
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.data.partition import StackedPartners as JStacked, split_basic as jsplit
from mplc_tpu.data.partition import stack_eval_set as jstack_eval
from mplc_tpu.data.partner import Partner as JPartner
from mplc_tpu.mpl import approaches as japproaches
from mplc_tpu.mpl.engine import EvalSet as JEvalSet, MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.models import zoo as jzoo
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy, theta_from_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data.partition import StackedPartners, split_basic
from mplc_tpu_torch.data.partner import Partner
from mplc_tpu_torch.mpl import approaches
from mplc_tpu_torch.mpl.approaches import stage_eval_set
from mplc_tpu_torch.mpl.engine import EpochStreams, MplTrainer, TrainConfig, epoch_streams
from mplc_tpu_torch.mpl.history import History
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.scenario import Scenario
from test_torch_slice import _tiny_mnist
from test_torch_sweep import AMOUNTS, _np, _stacked_np

torch.set_num_threads(1)

CFG = dict(approach="lflip", aggregator="uniform", epoch_count=3, minibatch_count=2,
           gradient_updates_per_pass=1, is_early_stopping=False, record_partner_val=False)


def _jax_tiny_mnist(seed=7):
    """`_tiny_mnist`'s dataset (the JAX suite's `tiny_image_dataset`
    recipe) as a JAX package Dataset."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 1, (10, 28, 28, 1)).astype(np.float32)

    def make(n):
        y = rng.integers(0, 10, n)
        x = np.clip(protos[y] + rng.normal(0, 0.25, (n, 28, 28, 1)), 0, 1).astype(np.float32)
        return x, jdatasets.to_categorical(y, 10)
    x, y = make(700)
    xt, yt = make(150)
    return jdatasets.Dataset("mnist", (28, 28, 1), 10, x, y, xt, yt, model=jzoo.MNIST_CNN)


def _problem():
    """The tiny MNIST CNN's 3-partner split staged in both packages."""
    td, jd = _tiny_mnist(), _jax_tiny_mnist()
    jp = [JPartner(i) for i in range(3)]
    tp = [Partner(i) for i in range(3)]
    jsplit(jd, jp, AMOUNTS, "random", 2)
    split_basic(td, tp, AMOUNTS, "random", 2)
    jax_side = (JStacked.build(jp, 10), JEvalSet(*jstack_eval(jd.x_val, jd.y_val, 10, 128)))
    port_side = (StackedPartners.build(tp, 10, "cpu"),
                 stage_eval_set(td.x_val, td.y_val, 10, "cpu"))
    np.testing.assert_array_equal(port_side[0].x.numpy(), np.asarray(jax_side[0].x))
    return jax_side, port_side


# ---------------------------------------------------------------------------
# (a) the EM step and the label draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead_row", [False, True], ids=["", "dead_row"])
def test_flip_matches_jax(dead_row):
    """With `dead_row`, row 3 of theta is zero: the posterior's column 3 is
    then zero, the row normalisation divides 0 by its 1e-12 clamp, and the
    row stays zero in both packages (a row the model's softmax underflows
    to 0 on a whole window dies this way, and stays dead)."""
    (jstacked, _), _ = _problem()
    jtr = JTrainer(jzoo.MNIST_CNN, JConfig(**CFG))
    params = jzoo.MNIST_CNN.init(jax.random.PRNGKey(2))
    perms = jtr.gen_epoch_streams(jax.random.PRNGKey(1), jstacked.mask, 0, 1)[0][0]
    mb_cap = jstacked.x.shape[1] // 2
    g = np.random.default_rng(0)
    theta = np.eye(10) + g.uniform(0, 0.3, (10, 10))
    theta = (theta / theta.sum(1, keepdims=True)).astype(np.float32)
    if dead_row:
        theta[3] = 0.0
    rng = jax.random.PRNGKey(3)
    # partner 0, the smallest: its minibatch window has invalid rows
    new_theta, y_flip, idx, valid = jtr._lflip_flip(
        params, jnp.asarray(theta), jstacked.x[0], jstacked.y[0], perms[0],
        jstacked.sizes[0], 1, mb_cap, rng)
    assert 0 < float(valid.sum()) < mb_cap
    preds = jax.nn.softmax(jzoo.MNIST_CNN.apply(params, jnp.take(jstacked.x[0], idx, axis=0),
                                                train=False), axis=-1)
    u = jax.random.uniform(rng, (mb_cap, 1))[:, 0]
    t = lambda a: torch.from_numpy(np.array(a))[None]  # noqa: E731
    got_theta, got_y = MplTrainer(tzoo.MNIST_CNN, TrainConfig(**CFG)).lflip_flip(
        t(preds), t(jnp.take(jstacked.y[0], idx, axis=0)), t(valid), t(theta), t(u))
    np.testing.assert_allclose(got_theta[0].numpy(), np.asarray(new_theta), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_y[0].numpy(), np.asarray(y_flip))
    # L1 rows, but for a dead row
    sums = got_theta[0].sum(1).numpy()
    np.testing.assert_allclose(np.delete(sums, 3) if dead_row else sums, 1.0, rtol=0, atol=1e-6)
    assert (sums[3] == 0.0) == dead_row


# ---------------------------------------------------------------------------
# (b) a 2-epoch run against the JAX package's
# ---------------------------------------------------------------------------

def _jax_lflip_streams(jtr, rng, mask_pn, epochs: int) -> EpochStreams:
    """One JAX run's permutations and label-draw uniforms, per (epoch,
    minibatch, partner) `uniform(fold_in(fold_in(fold_in(re, 1), mb), p),
    [mb_cap])` (`mplc_tpu/mpl/engine.py:938-943, 801`), where the epoch key
    re = fold_in(fold_in(rng, e), e)."""
    P, n_max = mask_pn.shape
    mb_cap = max(n_max // jtr.cfg.minibatch_count, 1)
    perms = np.array(jtr.gen_epoch_streams(rng, mask_pn, 0, epochs)[0])
    u = []
    for e in range(epochs):
        re = jax.random.fold_in(jax.random.fold_in(rng, e), e)
        u.append([[np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(re, 1), mb), p), (mb_cap, 1)))[:, 0] for p in range(P)]
            for mb in range(jtr.cfg.minibatch_count)])
    return EpochStreams(torch.from_numpy(perms)[None], flip_u=torch.from_numpy(np.array(u))[None])


# Adam (eps 1e-7) normalises each weight's step by its own gradient's size,
# so a weight whose gradient is near zero moves by up to a whole learning
# rate (1e-3) on a gradient difference of rounding size: an epoch of the
# MNIST CNN, fedavg's as well as lflip's, leaves a few weights of the
# 1,199,882 that far from the JAX package's. A weight may differ by at
# most one such step per optimizer step of the epoch (2 here: 2 minibatches
# of 1 step), and at most this share of the weights by more than 1e-4
MAX_STEP_SHARE = 1e-4


def test_lflip_run_matches_jax():
    """Each epoch of the port starts from the JAX package's state at the
    epoch's start (params, theta, theta history): a label drawn at a class
    boundary flips when the predictions move by the weights above, and a
    free-running pair of models then parts within an epoch."""
    (jstacked, jval), (stacked, val) = _problem()
    jtr = JTrainer(jzoo.MNIST_CNN, JConfig(**CFG))
    rng = jax.random.PRNGKey(5)
    mask = jnp.array([1., 0., 1.])
    # epoch e of one chunk folds rng with its position and with e
    jrun = jax.jit(jtr.run_epoch)
    jstates = [jtr.init_state(rng, 3)]
    for e in range(2):
        jstates.append(jrun(jstates[-1], jstacked, jval, mask, jax.random.fold_in(rng, e)))
    streams = _jax_lflip_streams(jtr, rng, jstacked.mask, 2)

    tr = MplTrainer(tzoo.MNIST_CNN, TrainConfig(**CFG))
    init_np = _np(jstates[0].params)
    theta0 = np.asarray(jstates[0].theta)
    # the port's own initial theta is JAX's to within rounding
    own = tr.init_state(None, 3, "cpu", init_params=params_from_numpy(_stacked_np([init_np])))
    np.testing.assert_allclose(own.theta[0].numpy(), theta0, rtol=0, atol=1e-7)
    for e in range(2):
        before, after = jstates[e], jstates[e + 1]
        state = tr.init_state(None, 3, "cpu",
                              init_params=params_from_numpy(_stacked_np([_np(before.params)])),
                              init_theta=theta_from_numpy(np.asarray(before.theta)[None]))
        state.theta_h[0] = torch.from_numpy(np.array(before.theta_h))
        state.epoch = e
        tr.run_epoch(state, stacked, val, torch.tensor([[1., 0., 1.]]), None,
                     epoch_streams(streams, e))
        run = state.row(0)
        n_far = n_all = 0
        for g, d in params_to_numpy(run.params).items():
            for k, v in d.items():
                diff = np.abs(v - np.asarray(after.params[g][k]))
                assert diff.max() <= 2 * 1e-3, (e, g, k, diff.max())
                n_far += int((diff > 1e-4).sum())
                n_all += diff.size
        assert n_far <= MAX_STEP_SHARE * n_all, (e, n_far, n_all)
        np.testing.assert_allclose(run.theta.numpy(), np.asarray(after.theta), rtol=0, atol=1e-5)
        th, jth = run.theta_h.numpy(), np.asarray(after.theta_h)
        np.testing.assert_array_equal(np.isnan(th), np.isnan(jth))
        np.testing.assert_allclose(th, jth, rtol=0, atol=1e-5)
    assert run.nb_epochs_done == 1 and state.epoch == 2 and not run.done
    # the epoch not run stays NaN; the non-member keeps its initial theta
    assert np.isnan(th[2]).all() and not np.isnan(th[:2]).any()
    np.testing.assert_array_equal(th[:2, 1], np.broadcast_to(theta0[1], (2, 10, 10)))

    hist = History([0, 1, 2], 3, 2)
    hist.fill_theta(run.theta_h, 2)
    assert hist.theta[2] == [None] * 3
    np.testing.assert_array_equal(hist.theta[1][2], th[1, 2])


# ---------------------------------------------------------------------------
# (c) a categorical model only; (d) the LFlip score
# ---------------------------------------------------------------------------

def test_label_flip_refuses_a_binary_model():
    jsc = build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True)
    with pytest.raises(ValueError, match="categorical"):
        japproaches.MplLabelFlip(jsc)
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), device="cpu")
    sc.instantiate_scenario_partners()
    sc.split_data()
    with pytest.raises(ValueError, match="categorical"):
        approaches.MplLabelFlip(sc)


def test_lflip_score_matches_jax_on_the_same_thetas(monkeypatch):
    g = np.random.default_rng(1)
    thetas = [[g.dirichlet(np.ones(10), 10).astype(np.float32) for _ in range(3)]
              for _ in range(2)]

    def fake_fit(self):
        self.history.theta = thetas
        self.history.score = 0.5
    for cls in (japproaches.MplLabelFlip, approaches.MplLabelFlip):
        monkeypatch.setattr(cls, "fit", fake_fit)
    # no engine: LFlip trains outside the coalition sweep
    engine = types.SimpleNamespace(batch_log=[])
    shadow = lambda sc: setattr(sc, "_charac_engine", engine) or sc  # noqa: E731
    jsc = build_scenario(dataset=_jax_tiny_mnist(), is_dry_run=True)
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=_tiny_mnist(), device="cpu")
    sc.instantiate_scenario_partners()
    sc.split_data()
    jc, c = JContributivity(shadow(jsc)), Contributivity(shadow(sc))
    jc.compute_contributivity("LFlip")
    c.compute_contributivity("LFlip")
    assert c.name == jc.name == "Label Flip"
    assert c.thetas_history is thetas and c.score == 0.5
    assert [x.hex() for x in c.contributivity_scores] == \
        [x.hex() for x in jc.contributivity_scores]
    expected = np.exp(-np.array([np.linalg.norm(t - np.eye(10)) for t in thetas[-1]]))
    np.testing.assert_array_equal(c.contributivity_scores, expected)
