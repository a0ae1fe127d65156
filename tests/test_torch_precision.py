"""The PyTorch port's precision modes (MPLC_TORCH_PRECISION) against the
JAX package's (MPLC_TPU_PRECISION), on the CPU:

1. resolution: the knob's warn-and-fallback contract, `TrainConfig`
   freezing and validating its precision, `dtype` routing;
2. fp32 is not a deviation: explicit fp32 is bit-identical to the default;
3. the model layer: MNIST CNN and Titanic logits and gradients under
   bf16 compute against the JAX package's `compute_dtype=jnp.bfloat16`;
4. the slice: a Titanic recording under mixed and bf16 on the JAX
   package's permutations, its reconstructed v(S) against the JAX
   package's, and the recorded stream staying float32;
5. the ledger: the ported `obs/numerics` against the JAX module.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import build_scenario
from mplc_tpu.contrib.contributivity import Contributivity as JContributivity
from mplc_tpu.contrib.reconstruct import RecordedRun as JRecordedRun
from mplc_tpu.contrib.reconstruct import ReconstructionEvaluator as JEvaluator
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.data.partition import StackedPartners as JStacked, split_basic as jsplit
from mplc_tpu.data.partition import stack_eval_set as jstack_eval
from mplc_tpu.data.partner import Partner as JPartner
from mplc_tpu.mpl.engine import EvalSet as JEvalSet, MplTrainer as JTrainer, TrainConfig as JConfig
from mplc_tpu.models import zoo as jzoo
from mplc_tpu.obs import numerics as jnum
from mplc_tpu.ops import metrics as jmetrics
from mplc_tpu_torch import constants
from mplc_tpu_torch.contrib.contributivity import Contributivity
from mplc_tpu_torch.contrib.engine import CharacteristicEngine
from mplc_tpu_torch.contrib.reconstruct import RecordedRun, ReconstructionEvaluator
from mplc_tpu_torch.contrib.shapley import powerset_order
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy, recorded_run_from_numpy
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data.partition import StackedPartners, split_basic
from mplc_tpu_torch.data.partner import Partner
from mplc_tpu_torch.mpl.approaches import stage_eval_set
from mplc_tpu_torch.mpl.engine import MplTrainer, TrainConfig
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.obs import numerics as tnum
from mplc_tpu_torch.ops import metrics as tmetrics
from mplc_tpu_torch.ops import recon_kernel
from mplc_tpu_torch.scenario import Scenario
from test_torch_models import MODELS, _setup

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -8          # spacing of bf16 values in [1, 2)
# the JAX package's bf16 value bound (tests/test_precision.py)
VALUE_BOUND = 0.05
AMOUNTS = [0.2, 0.3, 0.5]
EPOCHS = 4     # at 2 epochs bf16 leaves Titanic test samples on the boundary
GAME = dict(epoch_count=EPOCHS, minibatch_count=2, gradient_updates_per_pass_count=2)


# ---------------------------------------------------------------------------
# 1. resolution
# ---------------------------------------------------------------------------

def test_precision_mode_env_resolution(monkeypatch):
    monkeypatch.delenv(constants.PRECISION_ENV, raising=False)
    assert constants.precision_mode() == "fp32"
    for mode in ("fp32", "mixed", "bf16"):
        monkeypatch.setenv(constants.PRECISION_ENV, mode)
        assert constants.precision_mode() == mode
    monkeypatch.setenv(constants.PRECISION_ENV, "fp64")
    with pytest.warns(UserWarning):
        assert constants.precision_mode() == "fp32"


def test_train_config_freezes_and_validates(monkeypatch):
    monkeypatch.setenv(constants.PRECISION_ENV, "mixed")
    cfg = TrainConfig()
    assert cfg.precision == "mixed"
    # frozen at construction: a later env flip does not move the config
    monkeypatch.setenv(constants.PRECISION_ENV, "fp32")
    assert cfg.precision == "mixed"
    with pytest.raises(ValueError, match="precision"):
        TrainConfig(precision="fp64")


def test_dtype_routes_compute():
    assert TrainConfig(precision="fp32").dtype == torch.float32
    assert TrainConfig(precision="mixed").dtype == torch.bfloat16
    assert TrainConfig(precision="bf16").dtype == torch.bfloat16
    # the JAX package routes the same
    for mode in ("fp32", "mixed", "bf16"):
        assert (TrainConfig(precision=mode).dtype == torch.bfloat16) == \
            (JConfig(precision=mode).dtype == jnp.bfloat16)


# ---------------------------------------------------------------------------
# 2. explicit fp32 is bit-identical to the default
# ---------------------------------------------------------------------------

def _titanic_game(monkeypatch, mode, methods=()):
    """A Titanic 3-partner scenario run under `mode` (None: knob unset)."""
    if mode is None:
        monkeypatch.delenv(constants.PRECISION_ENV, raising=False)
    else:
        monkeypatch.setenv(constants.PRECISION_ENV, mode)
    sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), seed=0,
                  is_early_stopping=False, methods=list(methods),
                  device="cpu", **GAME)
    sc.run()
    c = Contributivity(sc)
    c.exact_reconstructed()
    return sc, c._reconstructor()


def test_explicit_fp32_is_bit_identical_to_default(monkeypatch):
    _, default = _titanic_game(monkeypatch, None)
    _, explicit = _titanic_game(monkeypatch, "fp32")
    assert default.precision == explicit.precision == "fp32"
    assert explicit.values == default.values          # no tolerance
    a, b = default.recorded, explicit.recorded
    assert torch.equal(a.weights, b.weights)
    for g, d in a.deltas.items():
        for k, t in d.items():
            assert torch.equal(t, b.deltas[g][k])


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_scenario_runs_every_mode_with_fp32_state(monkeypatch, mode):
    """The user entry points under mixed and bf16: finite scores, float32
    master parameters and recorded stream, the evaluator in the mode, and
    bf16 stream only under bf16."""
    sc, recon = _titanic_game(monkeypatch, mode, methods=["GTG-Shapley"])
    assert recon.precision == mode and sc.mpl.cfg.precision == mode
    assert np.isfinite(sc.contributivity_list[0].contributivity_scores).all()
    assert all(t.dtype == torch.float32 for d in sc.mpl.model_params.values()
               for t in d.values())
    rec = recon.recorded
    assert rec.weights.dtype == torch.float32
    assert all(t.dtype == torch.float32 for d in rec.deltas.values() for t in d.values())
    assert recon._d2.dtype == (torch.bfloat16 if mode == "bf16" else torch.float32)
    assert recon._init.dtype == torch.float32


# ---------------------------------------------------------------------------
# 3. the model layer under bf16 compute
# ---------------------------------------------------------------------------

def _jax_loss(jm, x, y, mask, dtype):
    def loss(p):
        logits = jm.apply(p, jnp.asarray(x), compute_dtype=dtype)
        return jmetrics.masked_loss_and_metrics(jm.loss_kind, logits, jnp.asarray(y),
                                                jnp.asarray(mask))[0]
    return loss


@pytest.mark.parametrize("name", MODELS)
def test_bf16_logits_match_jax(name):
    jm, tm, jp, tp, x, _, _ = _setup(name)
    ref = np.asarray(jm.apply(jp, jnp.asarray(x), compute_dtype=jnp.bfloat16))
    got = tm.apply(tp, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # both round each layer's output to bf16; a sum that lands on another
    # side of a rounding boundary moves a logit by one bf16 ulp
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=BF16_ULP * np.abs(ref).max())
    # and bf16 is really in use: the fp32 logits differ
    assert not np.array_equal(got.numpy(), tm.apply(tp, torch.from_numpy(x)).numpy())


# the models the bias bound below was measured on; the CIFAR10 CNN's bf16
# gradients are held in tests/test_torch_cifar10.py (its first convolution
# sums 6,144 bf16 cotangents into each bias, and the fp32 sum of the
# rounded cotangents lands farther from the fp32 gradient than XLA's bf16
# sum on the shared input: 0.0106 against 0.0092)
GRAD_MODELS = ["mnist_cnn", "titanic_logreg"]


@pytest.mark.parametrize("name", GRAD_MODELS)
def test_bf16_gradients_match_jax(name):
    """Gradients through bf16 compute come back float32 and finite. Weight
    gradients round where the JAX package's do (one bf16 ulp of the
    largest). Bias gradients are sums over the batch (and the spatial
    positions): XLA sums the bf16 cotangent in bf16, the port in fp32, so
    they are held to the fp32 gradient instead: no farther from it than
    the JAX package's bf16 gradient, plus one bf16 ulp."""
    jm, tm, jp, tp, x, y, mask = _setup(name)
    j16 = jax.grad(_jax_loss(jm, x, y, mask, jnp.bfloat16))(jp)
    j32 = jax.grad(_jax_loss(jm, x, y, mask, jnp.float32))(jp)

    def loss(p):
        logits = tm.apply(p, torch.from_numpy(x), torch.bfloat16)
        return tmetrics.masked_loss_and_metrics(tm.loss_kind, logits, torch.from_numpy(y),
                                                torch.from_numpy(mask))[0]
    grads = torch.func.grad(loss)(tp)
    for g, d in grads.items():
        for k, t in d.items():
            assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
            got, ref16, ref32 = t.numpy(), np.asarray(j16[g][k]), np.asarray(j32[g][k])
            ulp = BF16_ULP * np.abs(ref32).max()
            if k == "w":
                np.testing.assert_allclose(got, ref16, rtol=0, atol=ulp)
            else:
                assert np.abs(got - ref32).max() <= np.abs(ref16 - ref32).max() + ulp


# ---------------------------------------------------------------------------
# 4. the slice: Titanic recordings on the JAX package's permutations
# ---------------------------------------------------------------------------

_TRAIN = dict(approach="fedavg", aggregator="data-volume", epoch_count=EPOCHS,
              minibatch_count=2, gradient_updates_per_pass=2,
              is_early_stopping=False, record_partner_val=False,
              record_val_history=False, record_updates=True)


def _recordings(mode):
    """(JAX final state, port final state, initial params as numpy) of one
    Titanic recording under `mode` in both packages, the port fed the JAX
    package's initial parameters and epoch permutations."""
    jd, td = jdatasets.load_titanic(), tdatasets.load_titanic()
    jp = [JPartner(i) for i in range(3)]
    tp = [Partner(i) for i in range(3)]
    jsplit(jd, jp, AMOUNTS, "random", 2)
    split_basic(td, tp, AMOUNTS, "random", 2)

    jtrainer = JTrainer(jzoo.TITANIC_LOGREG, JConfig(precision=mode, **_TRAIN))
    rng = jax.random.PRNGKey(5)
    jstacked = JStacked.build(jp, 1)
    jstate = jtrainer.init_state(rng, 3)
    init_np = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstate = jax.jit(jtrainer.epoch_chunk, static_argnames=("n_epochs",))(
        jstate, jstacked, JEvalSet(*jstack_eval(jd.x_val, jd.y_val, 1, 128)),
        jnp.ones((3,), jnp.float32), rng, n_epochs=EPOCHS)
    perms, _ = jtrainer.gen_epoch_streams(rng, jstacked.mask, 0, EPOCHS)

    trainer = MplTrainer(tzoo.TITANIC_LOGREG, TrainConfig(precision=mode, **_TRAIN))
    state = trainer.init_state(None, 3, "cpu", init_params=params_from_numpy(
        jax.tree_util.tree_map(lambda a: a[None], init_np)))
    trainer.epoch_chunk(state, StackedPartners.build(tp, 1, "cpu"),
                        stage_eval_set(td.x_val, td.y_val, 1, "cpu"),
                        torch.ones(1, 3), None, EPOCHS,
                        streams_all=torch.from_numpy(np.array(perms))[None])
    return jstate, state.row(0), init_np


@pytest.fixture(scope="module")
def recordings():
    return {mode: _recordings(mode) for mode in ("fp32", "mixed", "bf16")}


def _values(mode, jstate, state, init_np):
    """v(S) of every coalition, each package reconstructing and evaluating
    its own recording under `mode` (the JAX package through its scan)."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("MPLC_TPU_PRECISION", mode)
        mp.setenv(constants.PRECISION_ENV, mode)
        jsc = build_scenario(dataset=jdatasets.load_titanic(), is_dry_run=True, **GAME)
        jrecon = JEvaluator(JContributivity(jsc).engine, JRecordedRun(
            init_params=jax.tree_util.tree_map(jnp.asarray, init_np),
            deltas=jstate.upd_h, weights=jstate.w_h, rounds=2 * EPOCHS,
            partners_count=3, epochs_done=EPOCHS, training_passes=0, memory_bytes=0))
        sc = Scenario(3, AMOUNTS, is_dry_run=True, dataset=tdatasets.load_titanic(), seed=3,
                      is_early_stopping=False, device="cpu", **GAME)
        sc.instantiate_scenario_partners()
        sc.split_data()
        recon = ReconstructionEvaluator(CharacteristicEngine(sc), RecordedRun(
            init_params=params_from_numpy(init_np), deltas=state.upd_h,
            weights=state.w_h, rounds=2 * EPOCHS, partners_count=3,
            epochs_done=EPOCHS, training_passes=None, memory_bytes=0))
    finally:
        mp.undo()
    assert recon.precision == jrecon.precision == mode
    coalitions = powerset_order(3)
    return recon.evaluate(coalitions), np.asarray(jrecon.evaluate(coalitions))


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_titanic_recording_matches_jax_under_precision(mode, recordings):
    jstate, state, init_np = recordings[mode]
    np.testing.assert_allclose(state.w_h.numpy(), np.asarray(jstate.w_h), rtol=1e-6)
    gup, lr = _TRAIN["gradient_updates_per_pass"], tzoo.TITANIC_LOGREG.optimizer.learning_rate
    for g, d in params_to_numpy(state.upd_h).items():
        for k, v in d.items():
            assert v.dtype == np.float32          # the stream stays fp32
            dev = np.abs(v - np.asarray(jstate.upd_h[g][k]))
            # a near-zero bias gradient summed in bf16 (XLA) and in fp32
            # (the port) may take opposite signs, and Adam turns a sign into
            # a whole step: a round's delta (gup steps of at most lr per
            # lane) can differ by two opposite passes, 2 * gup * lr; most
            # lanes stay within 1e-3
            assert dev.max() <= 2 * gup * lr
            assert np.median(dev) <= 1e-3
    values, jvalues = _values(mode, jstate, state, init_np)
    # the JAX package's bf16 value bound
    np.testing.assert_allclose(values, jvalues, rtol=0, atol=VALUE_BOUND)


@pytest.mark.parametrize("mode", ["mixed", "bf16"])
def test_bf16_compute_moves_the_recorded_stream(mode, recordings):
    """The deviation is real at the compute layer: bf16 model compute
    changes the recorded deltas against fp32 on the same permutations, as
    in the JAX package (tests/test_precision.py)."""
    moved = max(np.abs(a - b).max() for a, b in zip(
        (t.numpy() for d in recordings[mode][1].upd_h.values() for t in d.values()),
        (t.numpy() for d in recordings["fp32"][1].upd_h.values() for t in d.values())))
    assert moved > 1e-3


@pytest.mark.parametrize("mode", ["fp32", "mixed", "bf16"])
def test_recordings_convert_as_fp32_in_every_mode(mode, recordings):
    """convert.py needs no precision handling: a recording is float32 in
    every mode, in both packages, and carries across unchanged."""
    jstate, _, init_np = recordings[mode]
    leaves = jax.tree_util.tree_leaves(jstate.upd_h)
    assert all(np.asarray(a).dtype == np.float32 for a in leaves)
    run = recorded_run_from_numpy(init_np, jax.tree_util.tree_map(np.asarray, jstate.upd_h),
                                  np.asarray(jstate.w_h))
    assert run.weights.dtype == torch.float32
    for g, d in run.deltas.items():
        for k, t in d.items():
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(jstate.upd_h[g][k]))


# ---------------------------------------------------------------------------
# 5. the ledger: the ported obs/numerics against the JAX module
# ---------------------------------------------------------------------------

FLOATS = [0.0, -0.0, 1.0, 1.0 + 2 ** -52, -1.0, 0.5, 1e-310, -1e-310, math.inf,
          -math.inf, math.nan, 0.1, 0.30000000000000004]


def test_float_forensics_match():
    for a in FLOATS:
        assert tnum.float_bits(a) == jnum.float_bits(a)
        for b in FLOATS:
            assert tnum.ulp_distance(a, b) == jnum.ulp_distance(a, b), (a, b)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64).astype(np.float32)
    y = np.nextafter(x, np.float32(np.inf)) * (rng.random(64) < 0.5) + x * (rng.random(64) < 0.5)
    y[:3] = [-0.0, np.nan, x[2]]
    np.testing.assert_array_equal(tnum.ulp_distance_f32(x, y), jnum.ulp_distance_f32(x, y))


@pytest.mark.parametrize("case", ["ties", "random", "constant", "short"])
def test_kendall_tau_b_matches(case):
    rng = np.random.default_rng(1)
    if case == "ties":
        a = rng.integers(0, 4, 40).astype(float)
        b = a + rng.integers(0, 3, 40)
    elif case == "random":
        a, b = rng.random(300), rng.random(300)
    elif case == "constant":
        a, b = np.ones(10), rng.random(10)
    else:
        a, b = [1.0], [2.0]
    assert tnum.kendall_tau_b(a, b) == jnum.kendall_tau_b(a, b)


def _value_pair(case):
    """Two runs' values of a 4-partner game's 15 coalitions."""
    rng = np.random.default_rng(2)
    va = np.round(rng.random(15), 2)               # rounded: ties
    vb = va.copy()
    if case == "drift":                            # a 1-ulp and a large move, a NaN
        vb[3] = np.nextafter(vb[3], 2.0)
        vb[5] = vb[5] + 0.25
        va[7] = vb[7] = math.nan
    elif case == "signed_zero":                    # +0.0 and -0.0 are 0 ulp apart
        va[0], vb[0] = 0.0, -0.0
    elif case == "constant":                       # tau-b undefined: None
        va[:] = vb[:] = 0.5
    return va, vb


@pytest.mark.parametrize("case", ["drift", "identical", "signed_zero", "constant"])
def test_value_diff_matches_jax_ledger_diff(case):
    """`diff_values` over two value arrays gives the JAX module's
    `diff_ledgers` over two ledgers of the same values."""
    va, vb = _value_pair(case)
    ja, jb = jnum.ValueLedger("game"), jnum.ValueLedger("game")
    for s, x, y in zip(powerset_order(4), va, vb):
        ja.record(s, x)
        jb.record(s, y)
    jdiff = jnum.diff_ledgers(ja, jb)
    tdiff = tnum.diff_values(va, vb)
    # compared as JSON text: a NaN is never == to itself
    assert json.dumps(tdiff, sort_keys=True) == json.dumps(
        {k: jdiff[k] for k in tdiff}, sort_keys=True)
    assert tdiff["drift"] == (case == "drift")
    with pytest.raises(ValueError):
        tnum.diff_values(va, vb[:-1])


def test_reconstruction_stays_fp32_outside_bf16():
    """The stream dtype each mode reconstructs in."""
    assert recon_kernel.stream_dtype("fp32") == torch.float32
    assert recon_kernel.stream_dtype("mixed") == torch.float32
    assert recon_kernel.stream_dtype("bf16") == torch.bfloat16
