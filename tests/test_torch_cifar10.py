"""CIFAR10 in the PyTorch port against the JAX package, on the CPU:

(a) `load_cifar10` byte-equal to the JAX package's synthetic loader (no
    `cifar10.npz` cache in reach of either);
(b) the CIFAR10 CNN's training forward pass, loss and gradients under the
    JAX package's own dropout masks (`_cifar_apply`'s draw: split the step
    key in 3, one `bernoulli(keep, shape)` a layer): logits within 1e-5,
    gradients within rtol 1e-4 / atol 1e-6 (the MNIST CNN's,
    tests/test_torch_models.py); under bf16 compute, the weight gradients
    within one bf16 ulp of the JAX package's, the bias gradients no farther
    from its bf16 ones than those are from the fp32 gradient;
(c) RMSprop against `optax.rmsprop(1e-4, decay=0.9, eps=1e-7)`, five steps
    on the same gradients, near-zero and zero ones included: params within
    1e-8, the second moment within rtol 1e-6;
(d) one fedavg epoch and one single-trainer epoch of a tiny CIFAR10 game
    from the JAX package's initial state, its permutations and its masks
    (derived by its key chains, `mplc_tpu/mpl/engine.py:938-942, 760,
    1397`) injected, held to the MNIST CNN's kind of allowance
    (tests/test_torch_lflip.py) at RMSprop's step: each weight within one
    largest RMSprop step (lr / sqrt(1 - decay)) a step, at most
    MAX_STEP_SHARE of the weights beyond 1e-4; the val history within
    1e-4. The allowance is needed: the JAX trainer against itself, its
    initial params moved by 2e-8, parts by 1.6e-4 after the single
    trainer's 4 steps (14 weights beyond 1e-4);
(e) the seq family and fedavg on slots against masks, under the
    deterministic reduce bit for bit: a slot draws its partner's (fedavg)
    or its visit position's (seq) masks;
(f) the port's own masks: one seed, one set of masks; other partners,
    steps, minibatches and layers draw other masks; the keep share and the
    share kept by two streams within 6 binomial standard deviations of
    keep and keep^2; a row's bits do not depend on the window's width; a
    model without dropout draws no key; injected streams of a dropout
    model without masks or key raise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.data.partition import StackedPartners as JStacked, split_basic as jsplit
from mplc_tpu.data.partition import stack_eval_set as jstack_eval
from mplc_tpu.data.partner import Partner as JPartner
from mplc_tpu.mpl.engine import EvalSet as JEvalSet, MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.models import zoo as jzoo
from mplc_tpu.ops import metrics as jmetrics
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data.partition import StackedPartners, split_basic
from mplc_tpu_torch.data.partner import Partner
from mplc_tpu_torch.mpl import dropout as tdropout
from mplc_tpu_torch.mpl.approaches import stage_eval_set
from mplc_tpu_torch.mpl.engine import EpochStreams, MplTrainer, TrainConfig
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.ops import metrics as tmetrics
from test_torch_lflip import MAX_STEP_SHARE
from test_torch_sweep import _jax_single_perms, _np, _stacked_np

torch.set_num_threads(1)

SCALE = 0.004      # 200 train rows (180 after the val split), 40 test
AMOUNTS = [0.2, 0.3, 0.5]
LAYERS = tzoo.CIFAR10_DROPOUT


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(JAX, port) CIFAR10 at SCALE: the JAX loader reads its scale and
    noise from the environment and looks for a `cifar10.npz` cache under
    MPLC_TPU_DATA_DIR and ~/.keras/datasets, both pointed at an empty
    directory."""
    empty = tmp_path_factory.mktemp("no_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPLC_TPU_SYNTH_SCALE", str(SCALE))
        mp.delenv("MPLC_TPU_SYNTH_NOISE", raising=False)
        mp.setenv("MPLC_TPU_DATA_DIR", str(empty))
        mp.setenv("HOME", str(empty))
        jd = jdatasets.load_cifar10()
    return jd, tdatasets.load_cifar10(scale=SCALE)


def test_loader_is_byte_equal(datasets):
    jd, td = datasets
    assert jd.provenance == td.provenance == "synthetic:prototype-noise"
    assert td.name == "cifar10" and td.input_shape == (32, 32, 3) and td.num_classes == 10
    assert td.model is tzoo.CIFAR10_CNN
    for name in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"):
        a, b = getattr(jd, name), getattr(td, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(td.x_train) == 180 and len(td.x_val) == 20 and len(td.x_test) == 40
    assert tdatasets.load_dataset("cifar10").name == "cifar10"


# ---------------------------------------------------------------------------
# (b) the training forward pass under the JAX package's masks
# ---------------------------------------------------------------------------

def jax_keep_masks(key, rows: int) -> list:
    """The keep masks `_cifar_apply` draws from one step key, as numpy."""
    return [np.array(jax.random.bernoulli(k, 1.0 - rate, (rows,) + shape))
            for k, (rate, shape) in zip(jax.random.split(key, 3), LAYERS)]


def _batch(n=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    m = (rng.random(n) < 0.7).astype(np.float32)
    m[0] = 1.0
    return x, y, m


def test_training_forward_and_gradients_match_jax():
    jm, tm = jzoo.CIFAR10_CNN, tzoo.CIFAR10_CNN
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    x, y, m = _batch()
    rng = jax.random.PRNGKey(3)
    masks = tuple(torch.from_numpy(a) for a in jax_keep_masks(rng, len(x)))
    assert all(0.3 < float(t.float().mean()) < 0.9 for t in masks)

    ref = np.asarray(jm.apply(jp, jnp.asarray(x), train=True, rng=rng))
    got = tm.apply(tp, torch.from_numpy(x), dropout=masks).numpy()
    # fp32 convolutions and products summed in another order
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the masks matter: evaluation differs
    assert np.abs(tm.apply(tp, torch.from_numpy(x)).numpy() - ref).max() > 1e-2

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x), train=True, rng=rng)
        return jmetrics.masked_loss_and_metrics("categorical", logits, jnp.asarray(y),
                                                jnp.asarray(m))[0]

    def tloss(p):
        logits = tm.apply(p, torch.from_numpy(x), dropout=masks)
        return tmetrics.masked_loss_and_metrics("categorical", logits, torch.from_numpy(y),
                                                torch.from_numpy(m))[0]
    np.testing.assert_allclose(float(tloss(tp)), float(jloss(jp)), rtol=1e-6, atol=1e-6)
    jg, tg = jax.grad(jloss)(jp), torch.func.grad(tloss)(tp)
    for g, d in params_to_numpy(tg).items():
        for k, v in d.items():
            # backward sums over rows and channels in another order than XLA's
            np.testing.assert_allclose(v, np.asarray(jg[g][k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{g}.{k}")


def test_bf16_gradients_match_jax():
    """Under bf16 compute (evaluation mode) the weight gradients round where
    the JAX package's do (within one bf16 ulp of the largest); a bias
    gradient, the sum of bf16 cotangents over the rows and positions (XLA
    sums them in bf16, the port in fp32), lies no farther from the JAX
    package's bf16 one than that one lies from the fp32 gradient."""
    from test_torch_models import _setup
    from test_torch_precision import BF16_ULP, _jax_loss
    jm, tm, jp, tp, x, y, mask = _setup("cifar10_cnn")
    j16 = jax.grad(_jax_loss(jm, x, y, mask, jnp.bfloat16))(jp)
    j32 = jax.grad(_jax_loss(jm, x, y, mask, jnp.float32))(jp)

    def loss(p):
        logits = tm.apply(p, torch.from_numpy(x), torch.bfloat16)
        return tmetrics.masked_loss_and_metrics("categorical", logits, torch.from_numpy(y),
                                                torch.from_numpy(mask))[0]
    for g, d in torch.func.grad(loss)(tp).items():
        for k, t in d.items():
            assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
            got, ref16, ref32 = t.numpy(), np.asarray(j16[g][k]), np.asarray(j32[g][k])
            if k == "w":
                np.testing.assert_allclose(got, ref16, rtol=0,
                                           atol=BF16_ULP * np.abs(ref32).max())
            else:
                assert np.abs(got - ref16).max() <= np.abs(ref16 - ref32).max(), (g, k)


# ---------------------------------------------------------------------------
# (c) RMSprop
# ---------------------------------------------------------------------------

def test_rmsprop_matches_optax():
    jm, tm = jzoo.CIFAR10_CNN, tzoo.CIFAR10_CNN
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    opt = jm.make_optimizer()
    jstate, tstate = opt.init(jp), tm.optimizer.init(tp)
    g = np.random.default_rng(2)
    for step in range(5):
        # gradients of three magnitudes, exact zeros among them: a
        # near-zero gradient moves its weight by about lr * g / sqrt(eps)
        grads = {k: {n: (g.standard_normal(v.shape) * g.choice([1e-2, 1e-5, 1e-9, 0.0],
                                                                  v.shape)).astype(np.float32)
                     for n, v in d.items()} for k, d in _np(jp).items()}
        updates, jstate = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, updates)
        tp, tstate = tm.optimizer.step(tp, params_from_numpy(grads), tstate)
    assert tstate["count"] == 5 and set(tstate) == {"nu", "count"}
    for k, d in params_to_numpy(tp).items():
        for n, v in d.items():
            np.testing.assert_allclose(v, np.asarray(jp[k][n]), rtol=0, atol=1e-8)
            np.testing.assert_allclose(tstate["nu"][k][n].numpy(),
                                       np.asarray(jstate[0].nu[k][n]), rtol=1e-6, atol=0)


def test_rmsprop_is_not_torch_rmsprop():
    """torch.optim.RMSprop adds eps outside the square root: on a gradient
    near zero it steps orders of magnitude farther."""
    p = {"w": {"w": torch.zeros(3)}}
    grad = {"w": {"w": torch.tensor([1e-6, 1e-3, 1.0])}}
    ours, _ = tzoo.CIFAR10_CNN.optimizer.step(p, grad, tzoo.CIFAR10_CNN.optimizer.init(p))
    w = torch.zeros(3, requires_grad=True)
    theirs = torch.optim.RMSprop([w], lr=1e-4, alpha=0.9, eps=1e-7)
    w.grad = grad["w"]["w"].clone()
    theirs.step()
    w = w.detach()
    assert abs(float(ours["w"]["w"][0])) < 1e-2 * abs(float(w[0]))
    np.testing.assert_allclose(ours["w"]["w"][2].item(), w[2].item(), rtol=1e-5)


# ---------------------------------------------------------------------------
# (d) the trainers against the JAX package's, masks injected
# ---------------------------------------------------------------------------

CFG = dict(aggregator="data-volume", epoch_count=1, minibatch_count=2,
           gradient_updates_per_pass=2, is_early_stopping=False, record_partner_val=False)


@pytest.fixture(scope="module")
def problem(datasets):
    """The tiny CIFAR10 game's 3-partner split staged in both packages."""
    jd, td = datasets
    jp = [JPartner(i) for i in range(3)]
    tp = [Partner(i) for i in range(3)]
    jsplit(jd, jp, AMOUNTS, "random", 2)
    split_basic(td, tp, AMOUNTS, "random", 2)
    jax_side = (JStacked.build(jp, 10), JEvalSet(*jstack_eval(jd.x_val, jd.y_val, 10, 128)))
    port_side = (StackedPartners.build(tp, 10, "cpu"),
                 stage_eval_set(td.x_val, td.y_val, 10, "cpu"))
    np.testing.assert_array_equal(port_side[0].x.numpy(), np.asarray(jax_side[0].x))
    return jax_side, port_side


def _fold(key, *coords):
    for c in coords:
        key = jax.random.fold_in(key, c)
    return key


def jax_fedavg_masks(epoch_key, P: int, cfg, rows: int) -> tuple:
    """One fedavg epoch's masks [1, MB, P, S, rows, ...] a layer: step g of
    partner p in minibatch mb draws from
    fold_in(fold_in(fold_in(fold_in(epoch_key, 1), mb), p), g)."""
    layers = [[[jax_keep_masks(_fold(epoch_key, 1, mb, p, g), rows)
                for g in range(cfg.pass_steps)] for p in range(P)]
              for mb in range(cfg.minibatch_count)]
    return tuple(torch.from_numpy(np.array([[[[s[layer] for s in ps] for ps in mbs]
                                             for mbs in layers]]))
                 for layer in range(len(LAYERS)))


# RMSprop's largest step: |g| rsqrt((1 - decay) g^2 + ...) <= 1 / sqrt(1 - decay)
RMSPROP_STEP = 1e-4 / np.sqrt(1 - 0.9)


def _assert_epoch_close(state, jstate, steps: int):
    """Each weight within `steps` RMSprop steps, at most MAX_STEP_SHARE of
    them beyond 1e-4; the val loss history within 1e-4."""
    n_far = n_all = 0
    for g, d in params_to_numpy(state.row(0).params).items():
        for k, v in d.items():
            diff = np.abs(v - np.asarray(jstate.params[g][k]))
            assert diff.max() <= steps * RMSPROP_STEP, (g, k, diff.max())
            n_far += int((diff > 1e-4).sum())
            n_all += diff.size
    assert n_far <= MAX_STEP_SHARE * n_all, (n_far, n_all)
    got, ref = state.row(0).val_loss_h.numpy(), np.asarray(jstate.val_loss_h)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_fedavg_epoch_matches_jax(problem):
    (jstacked, jval), (stacked, val) = problem
    cfg = TrainConfig(approach="fedavg", **CFG)
    jtr = JTrainer(jzoo.CIFAR10_CNN, JConfig(approach="fedavg", **CFG))
    rng = jax.random.PRNGKey(5)
    mask = jnp.array([1., 0., 1.])
    jinit = jtr.init_state(rng, 3)
    # chunk position 0, epoch 0
    jstate = jax.jit(jtr.run_epoch)(jinit, jstacked, jval, mask, jax.random.fold_in(rng, 0))
    perms = np.array(jtr.gen_epoch_streams(rng, jstacked.mask, 0, 1)[0])
    mb_cap = stacked.x.shape[1] // cfg.minibatch_count
    rows = -(-mb_cap // cfg.gradient_updates_per_pass)
    masks = jax_fedavg_masks(_fold(rng, 0, 0), 3, cfg, rows)

    tr = MplTrainer(tzoo.CIFAR10_CNN, cfg)
    state = tr.init_state(None, 3, "cpu",
                          init_params=params_from_numpy(_stacked_np([_np(jinit.params)])))
    tr.run_epoch(state, stacked, val, torch.tensor([[1., 0., 1.]]), None,
                 EpochStreams(torch.from_numpy(perms), dropout_masks=masks))
    # two passes of 2 steps from fresh optimizers, aggregated after each
    _assert_epoch_close(state, jstate, steps=4)


def test_single_epoch_matches_jax(problem):
    (jstacked, jval), (stacked, val) = problem
    cfg = TrainConfig(approach="single", **CFG)
    jtr = JTrainer(jzoo.CIFAR10_CNN, JConfig(approach="single", **CFG))
    rng = jax.random.PRNGKey(6)
    jinit = jtr.init_state(rng, 3)
    jstate = jax.jit(jtr.run_epoch)(jinit, jstacked, jval, jnp.array([0., 0., 1.]),
                                    jax.random.fold_in(rng, 0))
    perms = torch.from_numpy(_jax_single_perms(rng, jstacked.mask[2], 1))
    steps = cfg.minibatch_count * cfg.gradient_updates_per_pass
    rows = -(-stacked.x.shape[1] // steps)
    epoch_key = _fold(rng, 0, 0)
    drawn = [jax_keep_masks(jax.random.fold_in(epoch_key, g + 1), rows) for g in range(steps)]
    masks = tuple(torch.from_numpy(np.array([[d[layer] for d in drawn]]))
                  for layer in range(len(LAYERS)))

    tr = MplTrainer(tzoo.CIFAR10_CNN, cfg)
    state = tr.init_state(None, 3, "cpu",
                          init_params=params_from_numpy(_stacked_np([_np(jinit.params)])))
    tr.run_epoch(state, stacked, val, torch.tensor([[0., 0., 1.]]), None,
                 EpochStreams(perms, dropout_masks=masks))
    # 4 steps of one persistent RMSprop
    _assert_epoch_close(state, jstate, steps=steps)
    # the persistent state is RMSprop's: the second moment (its arithmetic
    # is held to optax's above) and the step count
    assert set(state.opt_state) == {"nu", "count"} and state.opt_state["count"] == steps
    assert all(bool((t > 0).any()) for d in state.opt_state["nu"].values() for t in d.values())


# ---------------------------------------------------------------------------
# (e) slots against masks, the port's own masks
# ---------------------------------------------------------------------------

COALITIONS = [(0, 1), (1, 2), (0, 2), (0, 1, 2)]


def _run(problem, approach, coal, slot_count, **extra):
    _, (stacked, val) = problem
    cfg = TrainConfig(approach=approach, **{**CFG, "epoch_count": 1, **extra},
                      slot_count=slot_count, deterministic_reduce=True)
    tr = MplTrainer(tzoo.CIFAR10_CNN, cfg)
    gens = [torch.Generator().manual_seed(11 + i) for i in range(len(coal))]
    init = [tzoo.CIFAR10_CNN.init(torch.Generator().manual_seed(3))] * len(coal)
    state = tr.init_state(None, 3, "cpu", init_params={
        g: {k: torch.stack([p[g][k] for p in init]) for k in d} for g, d in init[0].items()})
    return tr.epoch_chunk(state, stacked, val, torch.tensor(coal), gens, 1)


@pytest.mark.parametrize("approach", ["fedavg", "seqavg"])
def test_slots_match_masks_bit_for_bit(problem, approach):
    masks = [[float(i in s) for i in range(3)] for s in COALITIONS]
    slots = [list(s) + [-1] * (3 - len(s)) for s in COALITIONS]
    a = _run(problem, approach, masks, None)
    b = _run(problem, approach, slots, 3)
    for g, d in a.params.items():
        for k, t in d.items():
            assert torch.equal(t, b.params[g][k]), (g, k)


# ---------------------------------------------------------------------------
# (f) the port's masks
# ---------------------------------------------------------------------------

def _keys(seed, n=1):
    g = torch.Generator().manual_seed(seed)
    return torch.stack([tdropout.draw_key(g) for _ in range(n)])


def test_masks_are_a_function_of_seed_and_coordinates():
    key = _keys(0)
    rows = 8
    base = tdropout.step_masks(key, rows, LAYERS, 1, 0, torch.tensor([[0]]), 0)
    again = tdropout.step_masks(_keys(0), rows, LAYERS, 1, 0, torch.tensor([[0]]), 0)
    assert all(torch.equal(a, b) for a, b in zip(base, again))
    assert [tuple(m.shape) for m in base] == [(1, 1, rows) + s for _, s in LAYERS]
    assert all(m.dtype == torch.bool for m in base)
    others = [tdropout.step_masks(_keys(1), rows, LAYERS, 1, 0, torch.tensor([[0]]), 0),
              tdropout.step_masks(key, rows, LAYERS, 1, 0, torch.tensor([[1]]), 0),
              tdropout.step_masks(key, rows, LAYERS, 1, 0, torch.tensor([[0]]), 1),
              tdropout.step_masks(key, rows, LAYERS, 1, 1, torch.tensor([[0]]), 0),
              tdropout.step_masks(key, rows, LAYERS, 1, 0, torch.tensor([[0]]), 7, 0)]
    for other in others:
        for a, b in zip(base, other):
            assert not torch.equal(a, b)
    # the two 0.25 layers of one step draw other bits where their shapes meet
    assert not torch.equal(base[0].reshape(-1)[:2304], base[1].reshape(-1))
    # a row's bits do not depend on how many rows the window has
    wide = tdropout.step_masks(key, 2 * rows, LAYERS, 1, 0, torch.tensor([[0]]), 0)
    assert all(torch.equal(a, b[:, :, :rows]) for a, b in zip(base, wide))


def test_keep_share_is_binomial():
    """Each layer's keep share over 64 streams within 6 binomial standard
    deviations of keep, and the share two independent streams both keep
    within 6 of keep^2."""
    keys = _keys(4, 64)
    masks = tdropout.step_masks(keys, 16, LAYERS, 1, 0, torch.arange(2)[None], 0)
    for (rate, _), m in zip(LAYERS, masks):
        keep = 1.0 - rate
        n = m[:, 0].numel()
        share = m[:, 0].double().mean().item()
        assert abs(share - keep) <= 6 * np.sqrt(keep * (1 - keep) / n), (rate, share)
        both = (m[:, 0] & m[:, 1]).double().mean().item()
        k2 = keep * keep
        assert abs(both - k2) <= 6 * np.sqrt(k2 * (1 - k2) / n), (rate, both)


def test_the_trainer_draws_a_key_only_for_dropout():
    mask = torch.ones(1, 3, 40)
    for model, has_key in ((tzoo.MNIST_CNN, False), (tzoo.TITANIC_LOGREG, False),
                           (tzoo.CIFAR10_CNN, True)):
        tr = MplTrainer(model, TrainConfig(approach="fedavg", **CFG))
        g = torch.Generator().manual_seed(9)
        draws = tr._draws([g], mask, None)
        assert (draws.dropout_key is not None) == has_key
        # the key is drawn after the permutations, which stay as they were
        ref = MplTrainer.epoch_perms(torch.Generator().manual_seed(9), mask[0])
        assert torch.equal(draws.perms[0], ref)
        nxt = torch.rand(1, generator=g)
        plain = torch.Generator().manual_seed(9)
        MplTrainer.epoch_perms(plain, mask[0])
        assert torch.equal(nxt, torch.rand(1, generator=plain)) == (not has_key)
    tr = MplTrainer(tzoo.CIFAR10_CNN, TrainConfig(approach="fedavg", **CFG))
    with pytest.raises(ValueError, match="dropout"):
        tr._draws(None, mask, torch.zeros(1, 3, 40, dtype=torch.int64))


def test_the_fit_is_reproducible_and_evaluation_never_drops(datasets):
    """One seed, one fit; evaluation is the model without dropout."""
    from mplc_tpu_torch.scenario import Scenario
    _, td = datasets
    scores = []
    for _ in range(2):
        sc = Scenario(3, AMOUNTS, dataset=td, is_dry_run=True, device="cpu", seed=0,
                      epoch_count=1, minibatch_count=2, gradient_updates_per_pass_count=1,
                      is_early_stopping=False)
        sc.instantiate_scenario_partners()
        sc.split_data()
        mpl = sc.multi_partner_learning_approach(sc)
        mpl.fit()
        scores.append(mpl)
    a, b = (m.model_params for m in scores)
    assert all(torch.equal(a[g][k], b[g][k]) for g in a for k in a[g])
    assert scores[0].history.score == scores[1].history.score
    tr = scores[0].trainer
    ev = stage_eval_set(td.x_val, td.y_val, 10, "cpu")
    params = {g: {k: t[None] for k, t in d.items()} for g, d in a.items()}
    loss, _ = tr.evaluate_models(params, ev)
    logits = tzoo.CIFAR10_CNN.apply(a, torch.from_numpy(td.x_val))
    ref = tmetrics.masked_loss_and_metrics("categorical", logits, torch.from_numpy(td.y_val),
                                           torch.ones(len(td.x_val)))[0]
    np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-6)
