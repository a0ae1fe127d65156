"""Models, losses, gradients, the optimizer step and aggregation of the
PyTorch port against the JAX package, on the JAX package's own initial
parameters (carried across with `mplc_tpu_torch.convert`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mplc_tpu.models import zoo as jzoo
from mplc_tpu.ops import aggregation as jagg
from mplc_tpu.ops import metrics as jmetrics
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.ops import aggregation as tagg
from mplc_tpu_torch.ops import metrics as tmetrics

torch.set_num_threads(1)

MODELS = ["mnist_cnn", "cifar10_cnn", "imdb_conv1d", "esc50_cnn", "titanic_logreg"]


def _setup(name, n=6, seed=0):
    """(jax model, port model, jax params, port params, x, y, mask)."""
    jm, tm = jzoo.MODELS[name], tzoo.MODELS[name]
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    if name in ("mnist_cnn", "cifar10_cnn", "esc50_cnn"):
        shape = {"mnist_cnn": (28, 28, 1), "cifar10_cnn": (32, 32, 3),
                 "esc50_cnn": (40, 431, 1)}[name]
        x = rng.random((n,) + shape).astype(np.float32)
        y = np.eye(tm.num_outputs, dtype=np.float32)[rng.integers(0, tm.num_outputs, n)]
    elif name == "imdb_conv1d":
        # int32 token ids over the whole vocabulary, most above bf16's
        # exact integers (256)
        x = rng.integers(1, tzoo.IMDB_NUM_WORDS, (n, tzoo.IMDB_SEQ_LEN)).astype(np.int32)
        y = rng.integers(0, 2, (n, 1)).astype(np.float32)
    else:
        x = rng.standard_normal((n, 27)).astype(np.float32)
        y = rng.integers(0, 2, (n, 1)).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    mask[0] = 1.0
    return jm, tm, jp, tp, x, y, mask


def _close_trees(jtree, ttree, **tol):
    for g, d in params_to_numpy(ttree).items():
        for k, v in d.items():
            np.testing.assert_allclose(v, np.asarray(jtree[g][k]), **tol)


@pytest.mark.parametrize("name", MODELS)
def test_logits_match(name):
    jm, tm, jp, tp, x, _, _ = _setup(name)
    ref = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    # fp32 convolutions and products summed in another order
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_params_round_trip_and_flops(name):
    _, tm, jp, tp, _, _, _ = _setup(name)
    _close_trees(jp, tp, rtol=0, atol=0)
    assert tzoo.fwd_flops_per_sample(name) == jzoo.fwd_flops_per_sample(name)
    # the port's own initializer: same leaves, shapes and dtype
    own = tm.init(torch.Generator().manual_seed(0))
    assert {g: {k: tuple(t.shape) for k, t in d.items()} for g, d in own.items()} == \
        {g: {k: tuple(v.shape) for k, v in d.items()} for g, d in jp.items()}


@pytest.mark.parametrize("kind", ["categorical", "binary"])
def test_masked_loss_and_metrics_match(kind):
    rng = np.random.default_rng(3)
    n = 9
    if kind == "categorical":
        logits = rng.standard_normal((n, 4)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    else:
        logits = rng.standard_normal((n, 1)).astype(np.float32)
        y = rng.integers(0, 2, (n, 1)).astype(np.float32)
    for mask in (rng.integers(0, 2, n).astype(np.float32), np.zeros(n, np.float32)):
        ref = jmetrics.masked_loss_and_metrics(kind, jnp.asarray(logits),
                                               jnp.asarray(y), jnp.asarray(mask))
        got = tmetrics.masked_loss_and_metrics(kind, torch.from_numpy(logits),
                                               torch.from_numpy(y), torch.from_numpy(mask))
        for r, g in zip(ref, got):
            assert np.isfinite(g.item())
            np.testing.assert_allclose(g.item(), float(r), rtol=1e-6, atol=1e-7)
        if not mask.any():
            # an all-masked batch gives 0, never NaN
            assert [g.item() for g in got] == [0.0, 0.0, 0.0]


def _jax_grads(jm, jp, x, y, mask):
    def loss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return jmetrics.masked_loss_and_metrics(jm.loss_kind, logits, jnp.asarray(y),
                                                jnp.asarray(mask))[0]
    return jax.grad(loss)(jp)


def _torch_grads(tm, tp, x, y, mask):
    def loss(p):
        logits = tm.apply(p, torch.from_numpy(x))
        return tmetrics.masked_loss_and_metrics(tm.loss_kind, logits, torch.from_numpy(y),
                                                torch.from_numpy(mask))[0]
    return torch.func.grad(loss)(tp)


@pytest.mark.parametrize("name", MODELS)
def test_masked_loss_gradients_match(name):
    jm, tm, jp, tp, x, y, mask = _setup(name)
    # backward sums over rows and channels in another order than XLA's
    _close_trees(_jax_grads(jm, jp, x, y, mask), _torch_grads(tm, tp, x, y, mask),
                 rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_fresh_adam_step_matches_optax(name):
    jm, tm, jp, tp, x, y, mask = _setup(name)
    jg = _jax_grads(jm, jp, x, y, mask)
    # both steps take the same (JAX) gradients: the test isolates the update
    opt = jm.make_optimizer()
    updates, _ = opt.update(jg, opt.init(jp), jp)
    ref = optax.apply_updates(jp, updates)
    tg = params_from_numpy(jax.tree_util.tree_map(np.asarray, jg))
    got, state = tm.optimizer.step(tp, tg, tm.optimizer.init(tp))
    assert state["count"] == 1
    # a fresh Adam step moves each weight by ~lr; fp32 rounding of m/sqrt(v)
    _close_trees(ref, got, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["uniform", "data-volume", "local-score"])
def test_aggregation_matches(kind):
    rng = np.random.default_rng(5)
    P = 4
    mask = np.array([1, 0, 1, 1], np.float32)
    sizes = np.array([10, 20, 30, 45], np.int32)
    scores = rng.random(P).astype(np.float32)
    stacked = {"d1": {"w": rng.standard_normal((P, 3, 2)).astype(np.float32),
                      "b": rng.standard_normal((P, 2)).astype(np.float32)}}
    jw = jagg.aggregation_weights(kind, jnp.asarray(mask), jnp.asarray(sizes),
                                  jnp.asarray(scores))
    tw = tagg.aggregation_weights(kind, torch.from_numpy(mask),
                                  torch.from_numpy(sizes.astype(np.int64)),
                                  torch.from_numpy(scores))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    ref = jagg.aggregate(jax.tree_util.tree_map(jnp.asarray, stacked), jw)
    got = tagg.aggregate(params_from_numpy(stacked), tw)
    _close_trees(ref, got, rtol=1e-6, atol=1e-7)
