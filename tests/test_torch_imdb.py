"""IMDB in the PyTorch port against the JAX package, on the CPU:

(a) `load_imdb` byte-equal to the JAX package's synthetic loader (no
    `imdb.npz` cache in reach of either), int32 tokens whose labels follow
    the marker bands;
(b) the layers: `conv1d` (SAME and VALID), `max_pool_1d` on an odd length
    and `embedding` (forward, and the table's gradient over repeated
    tokens) against the JAX package's, within 1e-6 (products and sums in
    another order; the pooling and the gather are exact); the gradient
    vmapped over a batch of tables runs without a fallback warning;
(c) the IMDB model's training forward pass, loss and gradients under the
    JAX package's dropout masks (`_imdb_apply` splits the step key in 2,
    one `bernoulli(keep, shape)` a layer): logits within 1e-5, loss within
    1e-6, gradients within rtol 1e-4 / atol 1e-6 (the MNIST CNN's,
    tests/test_torch_models.py); under bf16 compute the logits within one
    bf16 ulp of the largest of the JAX package's, on tokens above 256, and
    the same model fed its tokens through bf16 outside that bound;
(d) one fedavg epoch from the JAX package's initial state, its
    permutations and its masks injected, within the MNIST CNN's step
    allowance (tests/test_torch_lflip.py): each weight within one Adam
    step (lr 1e-3) a step, at most MAX_STEP_SHARE beyond 1e-4; the val
    history within 1e-4;
(e) stacking: int32 when every partner's features are integer, float32
    when one partner's are not, the eval set's tokens kept int32, each
    byte-equal to the JAX package's; 'noisy' on tokens raises the JAX
    package's ValueError, partner and scenario alike;
(f) a tiny IMDB game: the exact sweep of both engines (masked, the port
    fed the JAX engine's per-coalition initial params, permutations and
    dropout masks) within one test sample a v(S); SMCS of the port's
    scenario bit-equal to the JAX package's SMCS over the same v(S) table.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import build_scenario
from mplc_tpu.contrib.contributivity import Contributivity as JContributivity
from mplc_tpu.contrib.engine import CharacteristicEngine as JEngine
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.data.partition import StackedPartners as JStacked, split_basic as jsplit
from mplc_tpu.data.partition import stack_eval_set as jstack_eval
from mplc_tpu.data.partner import Partner as JPartner
from mplc_tpu.models import layers as JL
from mplc_tpu.models import zoo as jzoo
from mplc_tpu.mpl.engine import EvalSet as JEvalSet, MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.ops import metrics as jmetrics
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data.partition import StackedPartners, split_basic, stack_eval_set
from mplc_tpu_torch.data.partner import Partner
from mplc_tpu_torch.models import layers as TL
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.mpl.approaches import stage_eval_set
from mplc_tpu_torch.mpl.engine import EpochStreams, MplTrainer, TrainConfig
from mplc_tpu_torch.ops import metrics as tmetrics
from mplc_tpu_torch.scenario import Scenario
from test_torch_estimators import assert_same_result, jax_scenario
from test_torch_lflip import MAX_STEP_SHARE
from test_torch_precision import BF16_ULP
from test_torch_sweep import _jax_single_perms, _np, _stacked_np

torch.set_num_threads(1)

SCALE = 0.004      # 100 train rows (90 after the val split), 100 test
AMOUNTS = [0.2, 0.3, 0.5]
LAYERS = tzoo.IMDB_DROPOUT


def _no_cache_env(mp, empty, scale):
    """The JAX loaders read their scale from the environment and look for
    caches under MPLC_TPU_DATA_DIR and ~/.keras/datasets: both pointed at
    an empty directory."""
    mp.setenv("MPLC_TPU_SYNTH_SCALE", str(scale))
    mp.delenv("MPLC_TPU_SYNTH_NOISE", raising=False)
    mp.setenv("MPLC_TPU_DATA_DIR", str(empty))
    mp.setenv("HOME", str(empty))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(JAX, port) IMDB at SCALE."""
    with pytest.MonkeyPatch.context() as mp:
        _no_cache_env(mp, tmp_path_factory.mktemp("no_cache"), SCALE)
        jd = jdatasets.load_imdb()
    return jd, tdatasets.load_imdb(scale=SCALE)


def test_loader_is_byte_equal(datasets, monkeypatch):
    jd, td = datasets
    assert jd.provenance == td.provenance == "synthetic:token-band"
    assert td.name == "imdb" and td.input_shape == (500,) and td.num_classes == 2
    assert td.model is tzoo.IMDB_CONV1D
    for name in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"):
        a, b = getattr(jd, name), getattr(td, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(td.x_train) == 90 and len(td.x_val) == 10 and len(td.x_test) == 100
    assert td.x_train.dtype == np.int32
    assert td.x_train.min() >= 1 and td.x_train.max() < tzoo.IMDB_NUM_WORDS
    # the labels follow the marker bands: a row of label 1 holds tokens of
    # [300, 400), which a row of label 0 holds only by the uniform draw
    band1 = ((td.x_test >= 300) & (td.x_test < 400)).sum(1)
    assert band1[td.y_test == 1].min() > band1[td.y_test == 0].max() - 40
    assert band1[td.y_test == 1].mean() > band1[td.y_test == 0].mean() + 20
    monkeypatch.setenv(constants.SYNTH_SCALE_ENV, str(SCALE))
    assert np.array_equal(tdatasets.load_dataset("imdb").x_test, td.x_test)


# ---------------------------------------------------------------------------
# (b) the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv1d_matches_jax(padding):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 9, 4)).astype(np.float32)
    jp = JL.conv1d_init(jax.random.PRNGKey(2), 3, 4, 5)
    jp = {"w": jp["w"], "b": jnp.asarray(rng.standard_normal(5).astype(np.float32))}
    tp = params_from_numpy({"c": jp})["c"]
    ref = np.asarray(JL.conv1d(jp, jnp.asarray(x), padding=padding))
    got = TL.conv1d(tp, torch.from_numpy(x), padding=padding).numpy()
    assert got.shape == ref.shape == ((3, 9, 5) if padding == "SAME" else (3, 7, 5))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # the port's own initializer draws the JAX package's shapes and bound
    own = TL.conv1d_init(torch.Generator().manual_seed(0), 3, 4, 5)
    assert own["w"].shape == (3, 4, 5) and float(own["w"].abs().max()) <= np.sqrt(6 / 27)


def test_max_pool_1d_on_an_odd_length_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 7, 3)).astype(np.float32)
    ref = np.asarray(JL.max_pool_1d(jnp.asarray(x)))
    got = TL.max_pool_1d(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 3, 3)    # VALID: position 6 dropped
    np.testing.assert_array_equal(got, ref)


def test_embedding_forward_and_table_gradient_match_jax():
    """Repeated tokens gather one row several times, and the table's
    gradient sums their cotangents."""
    rng = np.random.default_rng(4)
    tokens = np.array([[1, 5, 5, 9, 1, 5], [9, 9, 0, 2, 5, 7]], np.int32)
    cot = rng.standard_normal(tokens.shape + (4,)).astype(np.float32)
    table = rng.uniform(-0.05, 0.05, (12, 4)).astype(np.float32)
    ref = np.asarray(JL.embedding({"table": jnp.asarray(table)}, jnp.asarray(tokens)))
    got = TL.embedding({"table": torch.from_numpy(table)}, torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.numpy(), ref)
    jg = jax.grad(lambda t: jnp.sum(JL.embedding({"table": t}, jnp.asarray(tokens)) * cot))(
        jnp.asarray(table))
    tg = torch.func.grad(lambda t: (TL.embedding({"table": t}, torch.from_numpy(tokens))
                                    * torch.from_numpy(cot)).sum())(torch.from_numpy(table))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    # token 5 appears 4 times: its row sums 4 cotangents; token 3 never
    assert np.abs(tg.numpy()[3]).max() == 0.0
    np.testing.assert_allclose(tg.numpy()[5], cot[tokens == 5].sum(0), rtol=1e-6)
    # the embedding initializer: uniform(-0.05, 0.05)
    own = TL.embedding_init(torch.Generator().manual_seed(0), 5000, 32)["table"]
    assert own.shape == (5000, 32) and float(own.abs().max()) <= 0.05
    assert float(own.abs().max()) > 0.049


def test_vmapped_embedding_gradient_needs_no_fallback():
    """The trainer's `vmap(grad(...))` over a stacked table: no batching
    rule missing (torch warns on such a fallback)."""
    model = tzoo.IMDB_CONV1D
    p = model.init(torch.Generator().manual_seed(0))
    stacked = {g: {k: torch.stack([t, t + 1e-3]) for k, t in d.items()} for g, d in p.items()}
    x = torch.randint(0, 5000, (2, 3, 500), generator=torch.Generator().manual_seed(1),
                      dtype=torch.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        grads = torch.func.vmap(torch.func.grad(lambda q, xb: model.apply(q, xb).sum()))(
            stacked, x)
    one = torch.func.grad(lambda q: model.apply(q, x[1]).sum())(
        {g: {k: t[1] for k, t in d.items()} for g, d in stacked.items()})
    torch.testing.assert_close(grads["emb"]["table"][1], one["emb"]["table"], rtol=1e-6,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# (c) the model under the JAX package's masks, and under bf16
# ---------------------------------------------------------------------------

def jax_step_masks(key, rows: int, layers) -> list:
    """The keep masks a JAX model with the dropout table `layers` draws
    from one step key (split in len(layers), one bernoulli a layer)."""
    return [np.array(jax.random.bernoulli(k, 1.0 - rate, (rows,) + tuple(shape)))
            for k, (rate, shape) in zip(jax.random.split(key, len(layers)), layers)]


def _tokens(n=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, tzoo.IMDB_NUM_WORDS, (n, tzoo.IMDB_SEQ_LEN)).astype(np.int32)
    y = rng.integers(0, 2, (n, 1)).astype(np.float32)
    m = (rng.random(n) < 0.7).astype(np.float32)
    m[0] = 1.0
    return x, y, m


def _params(seed=0):
    jp = jzoo.IMDB_CONV1D.init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(_np(jp))


def test_training_forward_and_gradients_match_jax():
    jm, tm = jzoo.IMDB_CONV1D, tzoo.IMDB_CONV1D
    jp, tp = _params()
    x, y, m = _tokens()
    rng = jax.random.PRNGKey(3)
    masks = tuple(torch.from_numpy(a) for a in jax_step_masks(rng, len(x), LAYERS))
    assert [tuple(t.shape) for t in masks] == [(6, 256), (6, 64)]
    assert all(0.3 < float(t.float().mean()) < 0.7 for t in masks)

    ref = np.asarray(jm.apply(jp, jnp.asarray(x), train=True, rng=rng))
    got = tm.apply(tp, torch.from_numpy(x), dropout=masks).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert np.abs(tm.apply(tp, torch.from_numpy(x)).numpy() - ref).max() > 1e-4

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x), train=True, rng=rng)
        return jmetrics.masked_loss_and_metrics("binary", logits, jnp.asarray(y),
                                                jnp.asarray(m))[0]

    def tloss(p):
        logits = tm.apply(p, torch.from_numpy(x), dropout=masks)
        return tmetrics.masked_loss_and_metrics("binary", logits, torch.from_numpy(y),
                                                torch.from_numpy(m))[0]
    np.testing.assert_allclose(float(tloss(tp)), float(jloss(jp)), rtol=1e-6, atol=1e-6)
    jg, tg = jax.grad(jloss)(jp), torch.func.grad(tloss)(tp)
    for g, d in params_to_numpy(tg).items():
        for k, v in d.items():
            np.testing.assert_allclose(v, np.asarray(jg[g][k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{g}.{k}")


def test_bf16_logits_match_jax_and_keep_the_tokens():
    """Both packages compute in bf16 and index the table with the int32
    tokens; a model that put its tokens through bf16 (4999 -> 4992, 257 ->
    256) lands outside the bound."""
    jm, tm = jzoo.IMDB_CONV1D, tzoo.IMDB_CONV1D
    jp, tp = _params(1)
    x, _, _ = _tokens(8, seed=5)
    assert (x > 256).mean() > 0.9
    ref = np.asarray(jm.apply(jp, jnp.asarray(x), compute_dtype=jnp.bfloat16))
    got = tm.apply(tp, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.float32
    bound = BF16_ULP * np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=bound)
    cast = torch.from_numpy(x).to(torch.bfloat16).to(torch.int64)
    assert int((cast != torch.from_numpy(x)).sum()) > 0
    moved = tm.apply(tp, cast, torch.bfloat16).numpy()
    assert np.abs(moved - ref).max() > bound


# ---------------------------------------------------------------------------
# (d) a fedavg epoch from the JAX package's state
# ---------------------------------------------------------------------------

CFG = dict(aggregator="data-volume", epoch_count=1, minibatch_count=2,
           gradient_updates_per_pass=2, is_early_stopping=False, record_partner_val=False)


@pytest.fixture(scope="module")
def problem(datasets):
    """The tiny IMDB game's 3-partner split staged in both packages."""
    jd, td = datasets
    jp = [JPartner(i) for i in range(3)]
    tp = [Partner(i) for i in range(3)]
    jsplit(jd, jp, AMOUNTS, "random", 2)
    split_basic(td, tp, AMOUNTS, "random", 2)
    jax_side = (JStacked.build(jp, 1), JEvalSet(*jstack_eval(jd.x_val, jd.y_val, 1, 128)))
    port_side = (StackedPartners.build(tp, 1, "cpu"), stage_eval_set(td.x_val, td.y_val, 1, "cpu"))
    return jax_side, port_side


def _fold(key, *coords):
    for c in coords:
        key = jax.random.fold_in(key, c)
    return key


def jax_fedavg_masks(epoch_key, P: int, cfg, rows: int, layers) -> list:
    """One fedavg epoch's masks [MB, P, S, rows, ...] a layer: step g of
    partner p in minibatch mb draws from the epoch key folded with
    (1, mb, p, g) (`mplc_tpu/mpl/engine.py`)."""
    drawn = [[[jax_step_masks(_fold(epoch_key, 1, mb, p, g), rows, layers)
               for g in range(cfg.pass_steps)] for p in range(P)]
             for mb in range(cfg.minibatch_count)]
    return [np.array([[[s[i] for s in ps] for ps in mbs] for mbs in drawn])
            for i in range(len(layers))]


def jax_single_masks(epoch_key, steps: int, rows: int, layers) -> list:
    """One single-trainer epoch's masks [S, rows, ...] a layer: step g
    draws from the epoch key folded with g + 1."""
    drawn = [jax_step_masks(jax.random.fold_in(epoch_key, g + 1), rows, layers)
             for g in range(steps)]
    return [np.array([d[i] for d in drawn]) for i in range(len(layers))]


# Adam's largest step: a learning rate (|m_hat| / sqrt(v_hat) <= 1)
ADAM_STEP = 1e-3


def assert_epoch_close(state, jstate, steps: int, step_size: float = ADAM_STEP):
    """Each weight within `steps` optimizer steps, at most MAX_STEP_SHARE
    of them beyond 1e-4; the val loss history within 1e-4."""
    n_far = n_all = 0
    for g, d in params_to_numpy(state.row(0).params).items():
        for k, v in d.items():
            diff = np.abs(v - np.asarray(jstate.params[g][k]))
            assert diff.max() <= steps * step_size, (g, k, diff.max())
            n_far += int((diff > 1e-4).sum())
            n_all += diff.size
    assert n_far <= MAX_STEP_SHARE * n_all, (n_far, n_all)
    got, ref = state.row(0).val_loss_h.numpy(), np.asarray(jstate.val_loss_h)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def fedavg_epoch_against_jax(problem, jmodel, tmodel, layers, seed: int, nudge: float = 0.0):
    """One masked fedavg epoch of coalition {0, 2} in both packages from the
    JAX package's initial state, its permutations and masks injected:
    (port state, JAX state), and with `nudge` also the JAX package's epoch
    from its initial params moved by `nudge` (its own rounding
    sensitivity)."""
    (jstacked, jval), (stacked, val) = problem
    cfg = TrainConfig(approach="fedavg", **CFG)
    jtr = JTrainer(jmodel, JConfig(approach="fedavg", **CFG))
    rng = jax.random.PRNGKey(seed)
    jinit = jtr.init_state(rng, 3)
    jrun = jax.jit(jtr.run_epoch)
    jstate = jrun(jinit, jstacked, jval, jnp.array([1., 0., 1.]), jax.random.fold_in(rng, 0))
    jnudged = None
    if nudge:
        moved = jinit._replace(params=jax.tree_util.tree_map(lambda t: t + nudge, jinit.params))
        jnudged = jrun(moved, jstacked, jval, jnp.array([1., 0., 1.]), jax.random.fold_in(rng, 0))
    perms = np.array(jtr.gen_epoch_streams(rng, jstacked.mask, 0, 1)[0])
    mb_cap = stacked.x.shape[1] // cfg.minibatch_count
    rows = -(-mb_cap // cfg.gradient_updates_per_pass)
    masks = tuple(torch.from_numpy(m[None]) for m in
                  jax_fedavg_masks(_fold(rng, 0, 0), 3, cfg, rows, layers))
    tr = MplTrainer(tmodel, cfg)
    state = tr.init_state(None, 3, "cpu",
                          init_params=params_from_numpy(_stacked_np([_np(jinit.params)])))
    tr.run_epoch(state, stacked, val, torch.tensor([[1., 0., 1.]]), None,
                 EpochStreams(torch.from_numpy(perms), dropout_masks=masks))
    return (state, jstate, jnudged) if nudge else (state, jstate)


def test_fedavg_epoch_matches_jax(problem):
    state, jstate = fedavg_epoch_against_jax(problem, jzoo.IMDB_CONV1D, tzoo.IMDB_CONV1D,
                                             LAYERS, seed=5)
    assert state.row(0).params["emb"]["table"].dtype == torch.float32
    # two passes of 2 steps from fresh optimizers, aggregated after each
    assert_epoch_close(state, jstate, steps=4)


# ---------------------------------------------------------------------------
# (e) stacking the tokens
# ---------------------------------------------------------------------------

def _split_both(datasets):
    jd, td = datasets
    jp = [JPartner(i, seed=42000 + i) for i in range(3)]
    tp = [Partner(i, seed=42000 + i) for i in range(3)]
    jsplit(jd, jp, AMOUNTS, "random", 2)
    split_basic(td, tp, AMOUNTS, "random", 2)
    return jp, tp


def _same_stack(jp, tp):
    js, ts = JStacked.build(jp, 1), StackedPartners.build(tp, 1, "cpu")
    for field in ("x", "y", "mask"):
        a, b = np.asarray(getattr(js, field)), getattr(ts, field).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    return ts


def test_tokens_stack_as_int32(datasets):
    jd, td = datasets
    ts = _same_stack(*_split_both(datasets))
    assert ts.x.dtype == torch.int32 and ts.y.dtype == torch.float32
    for a, b in zip(jstack_eval(jd.x_test, jd.y_test, 1, 128),
                    stack_eval_set(td.x_test, td.y_test, 1, 128, "cpu")):
        assert np.asarray(a).dtype == b.numpy().dtype and np.array_equal(np.asarray(a), b.numpy())
    assert stage_eval_set(td.x_test, td.y_test, 1, "cpu").x.dtype == torch.int32


def test_one_float_partner_stacks_float32(datasets):
    """A partner whose features are floats floats the whole stack (no
    silent truncation of its values back to integers)."""
    jp, tp = _split_both(datasets)
    for p in (jp[1], tp[1]):
        p.x_train = p.x_train.astype(np.float32) + 0.25
    ts = _same_stack(jp, tp)
    assert ts.x.dtype == torch.float32
    assert float(ts.x[1, 0, 0]) == float(tp[1].x_train[0, 0])


def test_noisy_corruption_of_tokens_raises_like_jax(datasets):
    jp, tp = _split_both(datasets)
    with pytest.raises(ValueError) as jerr:
        jp[0].noisy_features(0.1)
    with pytest.raises(ValueError) as terr:
        tp[0].noisy_features(0.1)
    assert str(terr.value) == str(jerr.value)
    assert "requires float features" in str(terr.value)
    # through the Scenario's corruption step, as a user configures it
    _, td = datasets
    sc = Scenario(3, AMOUNTS, dataset=td, is_dry_run=True, device="cpu", minibatch_count=2,
                  corrupted_datasets=["noisy", "not_corrupted", "not_corrupted"])
    sc.instantiate_scenario_partners()
    sc.split_data()
    with pytest.raises(ValueError, match="requires float features"):
        sc.data_corruption()


# ---------------------------------------------------------------------------
# (f) a tiny IMDB game against the JAX engine
# ---------------------------------------------------------------------------

GAME = dict(epoch_count=1, minibatch_count=2, gradient_updates_per_pass_count=2)


def jax_engine_streams(jeng, subsets, single: bool, layers, epochs: int) -> EpochStreams:
    """The JAX engine's permutations and dropout masks of each coalition
    ([B, E, ...] fields), from its coalition rng: the multi-partner
    trainer's epoch keys fold_in(fold_in(rng, e), e), the masks by
    (1, mb, p, g); the single trainer's by step + 1."""
    jstacked = jeng.stacked
    P, n_max = jstacked.mask.shape
    perms, masks = [], []
    for s in subsets:
        rng = jeng._coalition_rng(s)
        if single:
            tr = jeng.single_pipe.trainer
            cfg = tr.cfg
            steps = cfg.minibatch_count * cfg.gradient_updates_per_pass
            rows = max(-(-n_max // steps), 1)
            perms.append(_jax_single_perms(rng, jstacked.mask[s[0]], epochs))
            drawn = [jax_single_masks(_fold(rng, e, e), steps, rows, layers)
                     for e in range(epochs)]
        else:
            tr = jeng.multi_pipe.trainer
            cfg = TrainConfig(approach="fedavg", minibatch_count=tr.cfg.minibatch_count,
                              gradient_updates_per_pass=tr.cfg.gradient_updates_per_pass)
            mb_cap = max(n_max // cfg.minibatch_count, 1)
            rows = -(-mb_cap // cfg.gradient_updates_per_pass)
            perms.append(np.asarray(tr.gen_epoch_streams(rng, jstacked.mask, 0, epochs)[0]))
            drawn = [jax_fedavg_masks(_fold(rng, e, e), P, cfg, rows, layers)
                     for e in range(epochs)]
        masks.append([np.array([d[i] for d in drawn]) for i in range(len(layers))])
    return EpochStreams(torch.from_numpy(np.stack(perms)), dropout_masks=tuple(
        torch.from_numpy(np.stack([m[i] for m in masks])) for i in range(len(layers))))


def jax_values_by_coalition(jeng, subsets) -> np.ndarray:
    """The JAX engine's v(S) computed as its batched pipeline computes each
    coalition (init_state, one epoch chunk of every epoch, finalize, from
    the coalition's rng), one coalition at a time: the same programs
    without the vmap over coalitions, whose CPU compile is the costly
    part."""
    P = jeng.partners_count
    E = jeng.multi_pipe.trainer.cfg.epoch_count
    jits, out = {}, []
    for s in subsets:
        tr = (jeng.single_pipe if len(s) == 1 else jeng.multi_pipe).trainer
        if tr not in jits:
            jits[tr] = (jax.jit(tr.epoch_chunk, static_argnames=("n_epochs",)),
                        jax.jit(tr.finalize))
        run, fin = jits[tr]
        rng = jeng._coalition_rng(s)
        mask = jnp.zeros(P).at[jnp.asarray(s)].set(1.0)
        state = run(tr.init_state(rng, P), jeng.stacked, jeng.val, mask, rng, n_epochs=E)
        out.append(float(fin(state, jeng.test)[1]))
    return np.array(out)


def tiny_game_against_jax(monkeypatch, jd, td, layers, by_coalition: bool = False):
    """(port scenario, port engine, v(S)) of a 3-partner game, both
    engines masked, the port fed the JAX engine's initial params and
    streams: its exact sweep's v(S) against the JAX engine's (with
    `by_coalition`, against `jax_values_by_coalition`)."""
    for knob in ("NO_SLOTS", "SLOT_MERGE", "SLOT_POW2", "DETERMINISTIC_REDUCE"):
        for pkg in ("MPLC_TPU_", "MPLC_TORCH_"):
            monkeypatch.delenv(pkg + knob, raising=False)
    monkeypatch.setenv("MPLC_TPU_NO_SLOTS", "1")
    monkeypatch.setenv("MPLC_TORCH_NO_SLOTS", "1")
    jsc = build_scenario(dataset=jd, is_dry_run=True, **GAME)
    jeng = JEngine(jsc)
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=td, seed=3, device="cpu",
                  is_early_stopping=False, **GAME)
    sc.instantiate_scenario_partners()
    sc.split_data()
    eng = CharacteristicEngine(sc)
    sc._charac_engine = eng

    def batch_start(subsets, single, replicas=None):
        init = params_from_numpy(_stacked_np(
            [jsc.dataset.model.init(jeng._coalition_rng(s)) for s in subsets]))
        streams = jax_engine_streams(jeng, subsets, single, layers, GAME["epoch_count"])
        return [eng.coalition_generator(s) for s in subsets], init, streams

    monkeypatch.setattr(eng, "_batch_start", batch_start)
    subsets = powerset_order(3)
    jv = (jax_values_by_coalition(jeng, subsets) if by_coalition
          else np.asarray(jeng.evaluate(subsets)))
    v = eng.evaluate(subsets)
    # at most one test sample may flip at a decision boundary
    np.testing.assert_allclose(v, jv, rtol=0, atol=1.0 / len(td.x_test) + 1e-6)
    return sc, eng, v


def smcs_against_jax(sc, eng):
    """SMCS through the port's scenario (its sweep memoized) and the JAX
    package's SMCS over the same v(S) table: bit-equal scores, std and
    call counts, and no coalition trained again."""
    batches = len(eng.batch_log)
    c = Contributivity(sc)
    c.compute_contributivity("SMCS")
    table = dict(eng.charac_fct_values)
    sizes = [len(p.y_train) for p in sorted(sc.partners_list, key=lambda p: p.id)]
    jc = JContributivity(jax_scenario(3, lambda s: table[tuple(s)], sizes=sizes,
                                      seed=sc.seed))
    jc.compute_contributivity("SMCS")
    assert_same_result(c, jc)
    assert len(eng.batch_log) == batches
    assert np.isfinite(c.contributivity_scores).all()


def test_tiny_game_matches_jax_engine_and_smcs(monkeypatch, datasets):
    jd, td = datasets
    sc, eng, v = tiny_game_against_jax(monkeypatch, jd, td, LAYERS)
    assert eng.stacked.x.dtype == eng.test.x.dtype == torch.int32
    assert [b["kind"] for b in eng.batch_log] == ["single", "multi"]
    smcs_against_jax(sc, eng)
