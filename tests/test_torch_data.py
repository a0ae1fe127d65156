"""Data layer of the PyTorch port against the JAX package: the synthetic
loaders, the basic split, batch sizes and the stacked layouts must give
byte-equal arrays for the same seeds and scale."""

import numpy as np
import pytest
import torch

import mplc_tpu.data.datasets as jdatasets
import mplc_tpu.data.partition as jpartition
from mplc_tpu.data.partner import Partner as JPartner
from mplc_tpu_torch.data import datasets as tdatasets
from mplc_tpu_torch.data import partition as tpartition
from mplc_tpu_torch.data.partner import Partner as TPartner

torch.set_num_threads(1)

SCALE = 0.02
_SPLITS = ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test")


@pytest.fixture
def synthetic_env(monkeypatch, tmp_path):
    """The JAX loaders read their scale and noise from the environment and
    prefer cached real data: pin the synthetic path at SCALE."""
    monkeypatch.setenv("MPLC_TPU_SYNTH_SCALE", str(SCALE))
    monkeypatch.delenv("MPLC_TPU_SYNTH_NOISE", raising=False)
    monkeypatch.delenv("MPLC_TPU_DATA_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))


def _loaders(name):
    if name == "mnist":
        return jdatasets.load_mnist(), tdatasets.load_mnist(scale=SCALE)
    return jdatasets.load_titanic(), tdatasets.load_titanic()


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_digits_prototypes_match_jax():
    _assert_same(jdatasets._digits_prototypes(),
                 np.load(tdatasets._PROTOTYPES))


@pytest.mark.parametrize("n,test_size", [(891, 0.1), (720, 0.1), (17, 0.25), (10, 0.1)])
def test_train_test_split_matches_sklearn(n, test_size):
    from sklearn.model_selection import train_test_split
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    y = rng.integers(0, 4, n)
    for a, b in zip(train_test_split(x, y, test_size=test_size, random_state=42),
                    tdatasets.train_test_split(x, y, test_size, 42)):
        _assert_same(a, b)


@pytest.mark.parametrize("name", ["mnist", "titanic"])
def test_loaders_byte_equal(synthetic_env, name):
    jd, td = _loaders(name)
    assert jd.provenance == td.provenance
    assert (jd.name, jd.input_shape, jd.num_classes) == \
        (td.name, td.input_shape, td.num_classes)
    for split in _SPLITS:
        _assert_same(getattr(jd, split), getattr(td, split))


@pytest.mark.parametrize("name", ["mnist", "titanic"])
@pytest.mark.parametrize("description", ["random", "stratified"])
def test_split_batch_sizes_and_stacking_byte_equal(synthetic_env, name, description):
    jd, td = _loaders(name)
    amounts = [0.2, 0.3, 0.5]
    jp = [JPartner(i, seed=42000 + i) for i in range(3)]
    tp = [TPartner(i, seed=42000 + i) for i in range(3)]
    jpartition.split_basic(jd, jp, amounts, description, 2)
    tpartition.split_basic(td, tp, amounts, description, 2)
    jpartition.compute_batch_sizes(jp, 2, 4, 2 ** 20)
    tpartition.compute_batch_sizes(tp, 2, 4, 2 ** 20)
    for a, b in zip(jp, tp):
        for split in _SPLITS:
            _assert_same(getattr(a, split), getattr(b, split))
        assert a.clusters_list == b.clusters_list
        assert (a.final_nb_samples, a.batch_size) == (b.final_nb_samples, b.batch_size)

    label_dim = jd.model.label_dim()
    assert label_dim == td.model.label_dim()
    js = jpartition.StackedPartners.build(jp, label_dim)
    ts = tpartition.StackedPartners.build(tp, label_dim, "cpu")
    for field in ("x", "y", "mask"):
        _assert_same(np.asarray(getattr(js, field)), getattr(ts, field).numpy())
    assert np.array_equal(np.asarray(js.sizes), ts.sizes.numpy())

    for a, b in zip(jpartition.stack_eval_set(jd.x_test, jd.y_test, label_dim, 128),
                    tpartition.stack_eval_set(td.x_test, td.y_test, label_dim, 128, "cpu")):
        _assert_same(np.asarray(a), b.numpy())


def test_synth_noise_knob(synthetic_env, monkeypatch):
    """MPLC_TORCH_SYNTH_NOISE, the port's MPLC_TPU_SYNTH_NOISE: read by
    `load_mnist` and `load_cifar10` only when no `noise` is passed;
    unset, each keeps its default (0.45). The port at the knob's noise is
    byte-equal to the JAX package at its knob's."""
    from mplc_tpu_torch import constants
    scale = 0.002
    monkeypatch.delenv(constants.SYNTH_NOISE_ENV, raising=False)
    default = {}
    for name in ("mnist", "cifar10"):
        load = getattr(tdatasets, f"load_{name}")
        default[name] = load(scale).x_train
        _assert_same(default[name], load(scale, noise=0.45).x_train)
    monkeypatch.setenv(constants.SYNTH_NOISE_ENV, "0.3")
    monkeypatch.setenv("MPLC_TPU_SYNTH_NOISE", "0.3")
    monkeypatch.setenv("MPLC_TPU_SYNTH_SCALE", str(scale))
    for name in ("mnist", "cifar10"):
        load = getattr(tdatasets, f"load_{name}")
        got = load(scale)
        _assert_same(got.x_train, load(scale, noise=0.3).x_train)
        assert not np.array_equal(got.x_train, default[name])
        # an explicit noise wins over the knob
        _assert_same(load(scale, noise=0.45).x_train, default[name])
        jd = getattr(jdatasets, f"load_{name}")()
        for split in _SPLITS:
            _assert_same(getattr(jd, split), getattr(got, split))
