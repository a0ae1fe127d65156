"""ESC50 in the PyTorch port against the JAX package, on the CPU:

(a) `load_esc50` byte-equal to the JAX package's synthetic loader at its
    floor of 500 clips (no `esc50.npz` cache or raw checkout in reach);
(b) `global_avg_pool_2d` against the JAX package's within 1e-7 (a mean in
    another order);
(c) the ESC50 CNN's training forward pass, loss and gradients under the
    JAX package's dropout masks (`_esc50_apply` splits the step key in 4):
    logits within 1e-5, loss within 1e-6, gradients within rtol 1e-4 /
    atol 1e-6 (the MNIST CNN's, tests/test_torch_models.py);
(d) one fedavg epoch from the JAX package's state with its permutations
    and masks: each weight within one Adam step a step and the val history
    within 1e-4 (tests/test_torch_imdb.py), and no more weights beyond 1e-4
    than 1.5 times as many as the JAX trainer parts from itself when its
    initial params move by 2e-8 (905 of 49,762 here: the ESC50 CNN near
    chance leaves many weights with gradients near zero, which Adam steps
    by up to a learning rate on rounding);
(e) the port's dropout at ESC50's keep rate 0.8: the threshold rounds
    0.8 * 2^24 up to 13421773, and each layer's keep share and the share
    two streams both keep lie within 6 binomial standard deviations of 0.8
    and 0.64;
(f) the evaluation's rows in flight: ESC50's bounded by its bytes a row,
    the MNIST CNN's, the CIFAR10 CNN's and Titanic's still the row bound,
    and `evaluate_models` never forwarding more;
(g) the audio front end (`data/audio.py`) against the JAX package's on a
    seeded signal, bit for bit (the same numpy arithmetic), and
    `load_esc50_raw` on two WAV files and a CSV written here;
(h) a tiny ESC50 game: the port's exact sweep (masked, fed the JAX
    engine's initial params, permutations and masks) within one test
    sample a v(S) of the JAX engine's programs run a coalition at a time;
    SMCS bit-equal to the JAX package's over the same v(S) table.
"""

import csv

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mplc_tpu.data import audio as jaudio
from mplc_tpu.data import datasets as jdatasets
from mplc_tpu.data.partition import StackedPartners as JStacked, split_basic as jsplit
from mplc_tpu.data.partition import stack_eval_set as jstack_eval
from mplc_tpu.data.partner import Partner as JPartner
from mplc_tpu.models import layers as JL
from mplc_tpu.models import zoo as jzoo
from mplc_tpu.mpl.engine import EvalSet as JEvalSet
from mplc_tpu.ops import metrics as jmetrics
from mplc_tpu_torch import constants
from mplc_tpu_torch.convert import params_from_numpy, params_to_numpy
from mplc_tpu_torch.data import audio as taudio
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data.partition import StackedPartners, split_basic
from mplc_tpu_torch.data.partner import Partner
from mplc_tpu_torch.models import layers as TL
from mplc_tpu_torch.models import zoo as tzoo
from mplc_tpu_torch.mpl import dropout as tdropout
from mplc_tpu_torch.mpl.approaches import stage_eval_set
from mplc_tpu_torch.mpl.engine import MplTrainer, TrainConfig
from mplc_tpu_torch.ops import metrics as tmetrics
from test_torch_imdb import (ADAM_STEP, _no_cache_env, fedavg_epoch_against_jax,
                             jax_step_masks, smcs_against_jax, tiny_game_against_jax)
from test_torch_sweep import _np

torch.set_num_threads(1)

SCALE = 0.004      # below the loader's floor of 0.25: 500 clips
AMOUNTS = [0.2, 0.3, 0.5]
LAYERS = tzoo.ESC50_DROPOUT


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(JAX, port) ESC50 at the loader's floor."""
    with pytest.MonkeyPatch.context() as mp:
        _no_cache_env(mp, tmp_path_factory.mktemp("no_cache"), SCALE)
        jd = jdatasets.load_esc50()
    return jd, tdatasets.load_esc50(scale=SCALE)


def test_loader_is_byte_equal(datasets, monkeypatch):
    jd, td = datasets
    assert jd.provenance == td.provenance == "synthetic:prototype-noise"
    assert td.name == "esc50" and td.input_shape == (40, 431, 1) and td.num_classes == 50
    assert td.model is tzoo.ESC50_CNN
    for name in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"):
        a, b = getattr(jd, name), getattr(td, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    # 500 clips: 50 test rows, then the 90/10 train/val split of 450
    assert len(td.x_train) == 405 and len(td.x_val) == 45 and len(td.x_test) == 50
    monkeypatch.setenv(constants.SYNTH_SCALE_ENV, str(SCALE))
    assert np.array_equal(tdatasets.load_dataset("esc50").y_test, td.y_test)


def test_global_avg_pool_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 7, 4)).astype(np.float32)
    ref = np.asarray(JL.global_avg_pool_2d(jnp.asarray(x)))
    got = TL.global_avg_pool_2d(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# (c) the model under the JAX package's masks
# ---------------------------------------------------------------------------

def test_training_forward_and_gradients_match_jax():
    jm, tm = jzoo.ESC50_CNN, tzoo.ESC50_CNN
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(_np(jp))
    rng = np.random.default_rng(0)
    n = 4
    x = rng.random((n, 40, 431, 1)).astype(np.float32)
    y = np.eye(50, dtype=np.float32)[rng.integers(0, 50, n)]
    m = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    key = jax.random.PRNGKey(3)
    masks = tuple(torch.from_numpy(a) for a in jax_step_masks(key, n, LAYERS))
    assert [tuple(t.shape)[1:] for t in masks] == [s for _, s in LAYERS]
    assert all(0.7 < float(t.float().mean()) < 0.9 for t in masks)

    ref = np.asarray(jm.apply(jp, jnp.asarray(x), train=True, rng=key))
    got = tm.apply(tp, torch.from_numpy(x), dropout=masks).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert np.abs(tm.apply(tp, torch.from_numpy(x)).numpy() - ref).max() > 1e-4

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x), train=True, rng=key)
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
            np.testing.assert_allclose(v, np.asarray(jg[g][k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{g}.{k}")


# ---------------------------------------------------------------------------
# (d) a fedavg epoch from the JAX package's state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem(datasets):
    jd, td = datasets
    jp = [JPartner(i) for i in range(3)]
    tp = [Partner(i) for i in range(3)]
    jsplit(jd, jp, AMOUNTS, "random", 2)
    split_basic(td, tp, AMOUNTS, "random", 2)
    return ((JStacked.build(jp, 50), JEvalSet(*jstack_eval(jd.x_val, jd.y_val, 50, 128))),
            (StackedPartners.build(tp, 50, "cpu"), stage_eval_set(td.x_val, td.y_val, 50, "cpu")))


def _far(a: dict, b: dict) -> tuple[int, float]:
    """(weights farther apart than 1e-4, the largest distance)."""
    diffs = [np.abs(np.asarray(a[g][k]) - np.asarray(b[g][k])) for g in b for k in b[g]]
    return sum(int((d > 1e-4).sum()) for d in diffs), max(float(d.max()) for d in diffs)


def test_fedavg_epoch_matches_jax(problem):
    state, jstate, jnudged = fedavg_epoch_against_jax(
        problem, jzoo.ESC50_CNN, tzoo.ESC50_CNN, LAYERS, seed=7, nudge=2e-8)
    far, worst = _far(params_to_numpy(state.row(0).params), _np(jstate.params))
    jfar, jworst = _far(_np(jnudged.params), _np(jstate.params))
    assert jfar > 100                  # the reference's own sensitivity
    assert far <= 1.5 * jfar, (far, jfar)
    # two passes of 2 steps: every weight within 4 Adam steps (the JAX
    # trainer's nudged run too), the val history within 1e-4
    assert max(worst, jworst) <= 4 * ADAM_STEP
    got, ref = state.row(0).val_loss_h.numpy(), np.asarray(jstate.val_loss_h)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# (e) dropout at keep 0.8
# ---------------------------------------------------------------------------

def test_keep_rate_0_8_rounds_its_threshold_up():
    rate = LAYERS[0][0]
    assert rate == 0.2 and round((1.0 - rate) * (1 << 24)) == 13421773
    assert 13421773 / 2 ** 24 - 0.8 == pytest.approx(1.19e-8, rel=1e-2)


def test_keep_share_at_0_8_is_binomial():
    """Each ESC50 layer's keep share over 8 streams within 6 binomial
    standard deviations of 0.8, and the share two streams both keep within
    6 of 0.64."""
    g = torch.Generator().manual_seed(4)
    keys = torch.stack([tdropout.draw_key(g) for _ in range(8)])
    masks = tdropout.step_masks(keys, 2, LAYERS, 1, 0, torch.arange(2)[None], 0)
    for (rate, _), m in zip(LAYERS, masks):
        keep = 1.0 - rate
        n = m[:, 0].numel()
        share = m[:, 0].double().mean().item()
        assert abs(share - keep) <= 6 * np.sqrt(keep * (1 - keep) / n), (rate, share)
        both = (m[:, 0] & m[:, 1]).double().mean().item()
        k2 = keep * keep
        assert abs(both - k2) <= 6 * np.sqrt(k2 * (1 - k2) / n), (rate, both)


# ---------------------------------------------------------------------------
# (f) the evaluation's rows in flight
# ---------------------------------------------------------------------------

def test_rows_in_flight_follow_the_bytes_a_row():
    rows = {name: constants.eval_rows_in_flight(m.eval_row_bytes)
            for name, m in tzoo.MODELS.items()}
    # the MNIST CNN set the bound; the CIFAR10 CNN, IMDB and Titanic are no
    # wider a row, so they keep the row bound and their chunking
    assert rows == {"mnist_cnn": 16384, "cifar10_cnn": 16384, "imdb_conv1d": 16384,
                    "esc50_cnn": 2250, "titanic_logreg": 16384}
    assert tzoo.ESC50_CNN.eval_row_bytes == 1_073_280
    assert 2250 * 1_073_280 <= constants.EVAL_BYTES_IN_FLIGHT < 2251 * 1_073_280
    assert constants.eval_rows_in_flight(0) == constants.EVAL_ROWS_IN_FLIGHT


def test_evaluation_forwards_no_more_rows_than_the_bound(monkeypatch, datasets):
    _, td = datasets
    tr = MplTrainer(tzoo.ESC50_CNN, TrainConfig(approach="fedavg"))
    ev = stage_eval_set(td.x_test, td.y_test, 50, "cpu")
    p = tzoo.ESC50_CNN.init(torch.Generator().manual_seed(0))
    params = {g: {k: torch.stack([t] * 3) for k, t in d.items()} for g, d in p.items()}
    seen = []
    sums = tr._model_sums

    def spy(pb, x, y, m):
        seen.append(x.shape[0])
        return sums(pb, x, y, m)
    monkeypatch.setattr(tr, "_model_sums", spy)
    monkeypatch.setattr(constants, "EVAL_BYTES_IN_FLIGHT", 40 * 1_073_280)
    loss, acc = tr.evaluate_models(params, ev)
    # 40 rows in flight over 3 models: 13 rows a call, over the 50 rows
    assert max(seen) == 13 and sum(seen) == ev.x.shape[0] * ev.x.shape[1]
    logits = tzoo.ESC50_CNN.apply(p, torch.from_numpy(td.x_test))
    ref = tmetrics.masked_loss_and_metrics("categorical", logits, torch.from_numpy(td.y_test),
                                           torch.ones(len(td.x_test)))
    np.testing.assert_allclose(loss.numpy(), [ref[0].item()] * 3, rtol=1e-5)
    np.testing.assert_allclose(acc.numpy(), [ref[1].item()] * 3, rtol=1e-6)


# ---------------------------------------------------------------------------
# (g) the audio front end
# ---------------------------------------------------------------------------

def _signal(seconds=1.0, sr=22050, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * rng.standard_normal(len(t))), sr


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_audio_functions_are_bit_equal_to_jax():
    y, sr = _signal()
    _same(taudio.hann_window(2048), jaudio.hann_window(2048))
    _same(taudio.stft_power(y), jaudio.stft_power(y))
    freqs = np.array([0.0, 440.0, 999.9, 1000.0, 8000.0, sr / 2])
    _same(taudio.hz_to_mel(freqs), jaudio.hz_to_mel(freqs))
    _same(taudio.mel_to_hz(taudio.hz_to_mel(freqs)), jaudio.mel_to_hz(jaudio.hz_to_mel(freqs)))
    _same(taudio.mel_filterbank(sr, 2048), jaudio.mel_filterbank(sr, 2048))
    S = taudio.stft_power(y)
    _same(taudio.power_to_db(S), jaudio.power_to_db(S))
    _same(taudio.dct_ortho(S[:128], 40), jaudio.dct_ortho(S[:128], 40))
    m = taudio.mfcc(y, sr, n_mfcc=40)
    _same(m, jaudio.mfcc(y, sr, n_mfcc=40))
    assert m.shape == (40, 1 + len(y) // 512) and np.isfinite(m).all()
    # the orthonormal DCT keeps the norm of a full transform
    x = np.random.default_rng(1).standard_normal((16, 3))
    np.testing.assert_allclose(np.linalg.norm(taudio.dct_ortho(x, 16), axis=0),
                               np.linalg.norm(x, axis=0), rtol=1e-12)


@pytest.fixture
def raw_esc50(tmp_path):
    """A raw ESC-50 checkout of two clips: a 5 s mono int16 clip at
    44.1 kHz (431 frames) and a 1 s stereo uint8 clip (padded to 431)."""
    from scipy.io import wavfile
    (tmp_path / "audio").mkdir()
    rng = np.random.default_rng(2)
    clips = {"1-100-A-0.wav": (44100, (rng.standard_normal(5 * 44100) * 3000).astype(np.int16), 7),
             "2-200-B-1.wav": (44100, rng.integers(0, 256, (44100, 2)).astype(np.uint8), 41)}
    for name, (sr, data, _) in clips.items():
        wavfile.write(tmp_path / "audio" / name, sr, data)
    with open(tmp_path / "esc50.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "fold", "target", "category"])
        for name, (_, _, target) in clips.items():
            w.writerow([name, 1, target, "dog"])
    return tmp_path


def test_wav_and_raw_checkout_load_like_jax(raw_esc50):
    """The mono int16 clip (ESC-50's format) loads bit-equal to the JAX
    package's. The stereo uint8 clip shows the JAX package's fault: it
    averages the channels first, which makes the samples floats, and then
    skips their scaling (samples up to 255); the port scales each channel
    to [-1, 1] first."""
    from scipy.io import wavfile
    a, sa = taudio.load_wav(raw_esc50 / "audio" / "1-100-A-0.wav")
    b, sb = jaudio.load_wav(raw_esc50 / "audio" / "1-100-A-0.wav")
    assert sa == sb == 44100
    _same(a, b)
    assert a.ndim == 1 and np.abs(a).max() <= 1.0
    stereo, _ = taudio.load_wav(raw_esc50 / "audio" / "2-200-B-1.wav")
    jstereo, _ = jaudio.load_wav(raw_esc50 / "audio" / "2-200-B-1.wav")
    raw = wavfile.read(raw_esc50 / "audio" / "2-200-B-1.wav")[1]
    assert stereo.shape == (44100,) and np.abs(stereo).max() <= 1.0
    _same(stereo, ((raw.astype(np.float64) - 128.0) / 128.0).mean(axis=1))
    assert np.abs(jstereo).max() > 1.0
    _same(jstereo, raw.mean(axis=1))
    x, y = tdatasets.load_esc50_raw(raw_esc50)
    jx, jy = jdatasets.load_esc50_raw(raw_esc50)
    _same(x[0], jx[0])
    _same(y, jy)
    assert x.shape == jx.shape == (2, 40, 431, 1) and y.tolist() == [7, 41]
    _same(x[1, :, :, 0], np.pad(taudio.mfcc(stereo, 44100, n_mfcc=40), ((0, 0), (0, 431 - 87)))
          .astype(np.float32))
    # the short clip's frames past its end are zeros
    assert np.all(x[1, :, 87:] == 0) and np.abs(x[0, :, 430]).max() > 0


# ---------------------------------------------------------------------------
# (h) a tiny ESC50 game against the JAX engine
# ---------------------------------------------------------------------------

def test_tiny_game_matches_jax_engine_and_smcs(monkeypatch, datasets):
    """On 120 of the loader's training rows and 30 of its test rows, the
    JAX side coalition by coalition: the JAX engine's vmapped ESC50
    programs took 7 minutes and 11.6 GB to compile and run on the CPU at
    this size (over 30 GB at the loader's 500 clips)."""
    jd, td = datasets
    rows = (jd.x_train[:120], jd.y_train[:120], jd.x_test[:30], jd.y_test[:30])
    jd = jdatasets.Dataset("esc50", (40, 431, 1), 50, *rows, model=jzoo.ESC50_CNN)
    td = tdatasets.Dataset("esc50", (40, 431, 1), 50, *rows, model=tzoo.ESC50_CNN)
    sc, eng, v = tiny_game_against_jax(monkeypatch, jd, td, LAYERS, by_coalition=True)
    assert [b["kind"] for b in eng.batch_log] == ["single", "multi"]
    assert np.isfinite(v).all() and (v >= 0).all() and (v <= 1).all()
    smcs_against_jax(sc, eng)
