"""Datasets: the L1 layer (port of `mplc_tpu/data/datasets.py`).

Same `Dataset` contract as the JAX package: `x_train/y_train/x_val/
y_val/x_test/y_test`, `input_shape`, `num_classes`, a global 90/10
train/val split at construction (random_state=42) and the local split
hooks the basic partitioner calls. The synthetic loaders draw the same
numpy streams as the JAX package's, so their arrays are byte-equal for the
same `scale`.

Only the synthetic paths are ported (no `mnist.npz` / `cifar10.npz` /
`imdb.npz` / `esc50.npz` / Titanic CSV cache lookup yet: ROADMAP.md queue
1); `load_esc50_raw` featurizes a raw ESC-50 checkout given its folder. The
port does not depend on scikit-learn: `train_test_split`
below reproduces scikit-learn's shuffle split (one `RandomState`
permutation, the first ceil(test_size * n) indices are the test rows), and
the MNIST prototypes are the JAX package's sklearn-digits prototypes,
stored in `digits_prototypes.npy` beside this file.
"""

from __future__ import annotations

import csv
from math import ceil
from pathlib import Path

import numpy as np

from .. import constants
from ..models import zoo as model_zoo
from ..models.core import Model

_PROTOTYPES = Path(__file__).with_name("digits_prototypes.npy")


def to_categorical(y: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((len(y), num_classes), np.float32)
    out[np.arange(len(y)), y.astype(int)] = 1.0
    return out


def train_test_split(x, y, test_size: float, random_state: int):
    """scikit-learn's `train_test_split(x, y, test_size=..., random_state=...)`
    for a float `test_size`: (x_train, x_test, y_train, y_test)."""
    n = len(x)
    n_test = ceil(test_size * n)
    perm = np.random.RandomState(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return x[train], x[test], y[train], y[test]


class Dataset:
    """Container for one dataset + its model family."""

    def __init__(self, dataset_name: str, input_shape: tuple, num_classes: int,
                 x_train: np.ndarray, y_train: np.ndarray,
                 x_test: np.ndarray, y_test: np.ndarray,
                 model: Model | None = None, provenance: str = "user"):
        self.name = dataset_name
        self.input_shape = tuple(input_shape)
        self.num_classes = num_classes
        self.x_test = x_test
        self.y_test = y_test
        self.model = model
        self.provenance = provenance
        self.x_train, self.x_val, self.y_train, self.y_val = train_test_split(
            x_train, y_train, test_size=0.1, random_state=42)

    @staticmethod
    def train_test_split_local(x, y):
        return x, np.array([]), y, np.array([])

    @staticmethod
    def train_val_split_local(x, y):
        return x, np.array([]), y, np.array([])


class TitanicDataset(Dataset):
    """Titanic keeps its local 10% test/val split hooks."""

    @staticmethod
    def train_test_split_local(x, y):
        return train_test_split(x, y, test_size=0.1, random_state=42)

    @staticmethod
    def train_val_split_local(x, y):
        return train_test_split(x, y, test_size=0.1, random_state=42)


def load_mnist(scale: float | None = None, noise: float | None = None) -> Dataset:
    """Synthetic MNIST: sklearn-digits prototypes (upsampled to 28x28) plus
    Gaussian noise (`noise`, else MPLC_TORCH_SYNTH_NOISE, else 0.45),
    `scale` x 60000 train and x 10000 test samples."""
    scale = constants.synth_scale() if scale is None else scale
    noise = constants.synth_noise(0.45) if noise is None else noise
    rng = np.random.default_rng(42)
    n_train = int(60000 * scale)
    n_test = int(10000 * scale)
    protos = np.load(_PROTOTYPES)
    y_train = rng.integers(0, 10, size=n_train)
    y_test = rng.integers(0, 10, size=n_test)

    def make(y):
        x = protos[y][..., None] + rng.normal(0, noise,
                                              size=(len(y), 28, 28, 1))
        return np.clip(x, 0, 1).astype(np.float32)

    x_train, x_test = make(y_train), make(y_test)
    return Dataset(constants.MNIST, (28, 28, 1), 10,
                   x_train, to_categorical(y_train, 10),
                   x_test, to_categorical(y_test, 10),
                   model=model_zoo.MNIST_CNN,
                   provenance="synthetic:sklearn-digits-prototypes")


def synthetic_image_classification(rng: np.random.Generator, n: int,
                                   shape: tuple, num_classes: int,
                                   signal: float = 1.0, noise: float = 0.35
                                   ) -> tuple[np.ndarray, np.ndarray]:
    """Class-prototype images plus Gaussian noise, drawn from `rng` as the
    JAX package draws them: new prototypes every call (smoothed by a roll
    along each spatial axis), then the labels, then the noise."""
    protos = rng.uniform(0.0, 1.0, size=(num_classes,) + tuple(shape)).astype(np.float32)
    if len(shape) == 3:
        protos = 0.5 * protos + 0.25 * np.roll(protos, 1, axis=1) + 0.25 * np.roll(protos, 1, axis=2)
    y = rng.integers(0, num_classes, size=n)
    x = protos[y] * signal + rng.normal(0.0, noise, size=(n,) + tuple(shape)).astype(np.float32)
    return np.clip(x, 0.0, 1.0).astype(np.float32), y.astype(np.int64)


def load_cifar10(scale: float | None = None, noise: float | None = None) -> Dataset:
    """Synthetic CIFAR10 (the JAX package's route without a `cifar10.npz`
    cache, the only one ported so far): `scale` x 50000 train and x 10000
    test 32x32x3 images, two `synthetic_image_classification` calls on one
    generator (seed 43, signal 0.8, `noise`, else MPLC_TORCH_SYNTH_NOISE,
    else 0.45).

    The second call draws prototypes of its own, so the test set's classes
    are not the training set's: a classifier fitted on the training rows
    scores chance on it, whatever it learns (ROADMAP.md, reference
    caveats). The validation rows come from the training set."""
    scale = constants.synth_scale() if scale is None else scale
    noise = constants.synth_noise(0.45) if noise is None else noise
    rng = np.random.default_rng(43)
    n_train = int(50000 * scale)
    n_test = int(10000 * scale)
    x_train, y_train = synthetic_image_classification(rng, n_train, (32, 32, 3), 10,
                                                      signal=0.8, noise=noise)
    x_test, y_test = synthetic_image_classification(rng, n_test, (32, 32, 3), 10,
                                                    signal=0.8, noise=noise)
    return Dataset(constants.CIFAR10, (32, 32, 3), 10,
                   x_train, to_categorical(y_train, 10),
                   x_test, to_categorical(y_test, 10),
                   model=model_zoo.CIFAR10_CNN, provenance="synthetic:prototype-noise")


def with_held_out_test(dataset: Dataset, rows: int) -> Dataset:
    """A Dataset whose test set is the first `rows` of `dataset`'s training
    rows (already shuffled by its train/val split) and whose training
    rows are the rest, split 90/10 into train and val anew. For a loader
    whose own test set scores nothing, as `load_cifar10`'s."""
    return Dataset(dataset.name, dataset.input_shape, dataset.num_classes,
                   dataset.x_train[rows:], dataset.y_train[rows:],
                   dataset.x_train[:rows], dataset.y_train[:rows], model=dataset.model,
                   provenance=f"{dataset.provenance}, test = {rows} training rows")


def load_titanic() -> Dataset:
    """Synthetic 27-feature Titanic with a planted logistic rule."""
    rng = np.random.default_rng(44)
    n = 891
    x = rng.normal(0, 1, size=(n, model_zoo.TITANIC_NUM_FEATURES)).astype(np.float32)
    w = rng.normal(0, 1.5, size=(model_zoo.TITANIC_NUM_FEATURES,))
    p = 1.0 / (1.0 + np.exp(-(x @ w)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    x_tr, x_te, y_tr, y_te = train_test_split(x, y, test_size=0.1, random_state=42)
    return TitanicDataset(constants.TITANIC, (model_zoo.TITANIC_NUM_FEATURES,), 2,
                          x_tr, y_tr, x_te, y_te,
                          model=model_zoo.TITANIC_LOGREG,
                          provenance="synthetic:planted-logistic")


def load_imdb(scale: float | None = None) -> Dataset:
    """Synthetic IMDB sentiment (the JAX package's route without an
    `imdb.npz` cache): `scale` x 25000 train and x 25000 test reviews of
    500 int32 token ids in [1, 5000), binary labels. Each row carries 40
    class-marker tokens at random positions, from [100, 200) for label 0
    and [300, 400) for label 1, so the test set (drawn by the second of two
    calls on one generator, seed 45) follows the training set's rule."""
    scale = constants.synth_scale() if scale is None else scale
    rng = np.random.default_rng(45)
    seq_len = model_zoo.IMDB_SEQ_LEN

    def make(n):
        y = rng.integers(0, 2, size=n).astype(np.float32)
        x = rng.integers(1, model_zoo.IMDB_NUM_WORDS, size=(n, seq_len)).astype(np.int32)
        marker_count = 40
        for cls, band in ((0, (100, 200)), (1, (300, 400))):
            idx = np.where(y == cls)[0]
            pos = rng.integers(0, seq_len, size=(len(idx), marker_count))
            tok = rng.integers(band[0], band[1], size=(len(idx), marker_count))
            x[idx[:, None], pos] = tok
        return x, y

    x_train, y_train = make(int(25000 * scale))
    x_test, y_test = make(int(25000 * scale))
    return Dataset(constants.IMDB, (seq_len,), 2, x_train, y_train, x_test, y_test,
                   model=model_zoo.IMDB_CONV1D, provenance="synthetic:token-band")


def load_esc50_raw(folder) -> tuple[np.ndarray, np.ndarray]:
    """MFCC features of a raw ESC-50 checkout: `<folder>/esc50.csv` (its
    `filename` and `target` columns) and `<folder>/audio/*.wav`. Each clip
    becomes a [40, 431, 1] MFCC image (data/audio.py, librosa's defaults;
    the frame axis zero-padded or cut to 431, a 5 s clip at 44.1 kHz)."""
    from .audio import load_wav, mfcc

    folder = Path(folder)
    with open(folder / "esc50.csv", newline="") as f:
        rows = [(r["filename"], int(r["target"])) for r in csv.DictReader(f)]
    feats, ys = [], []
    for fname, target in rows:
        samples, sr = load_wav(folder / "audio" / fname)
        m = mfcc(samples, sr, n_mfcc=40)
        if m.shape[1] < 431:
            m = np.pad(m, ((0, 0), (0, 431 - m.shape[1])))
        feats.append(m[:, :431])
        ys.append(target)
    x = np.stack(feats).astype(np.float32)[..., None]
    return x, np.asarray(ys, np.int64)


def load_esc50(scale: float | None = None) -> Dataset:
    """Synthetic ESC50 (the JAX package's route without an `esc50.npz`
    cache or a raw checkout): 2000 x max(scale, 0.25) [40, 431, 1] MFCC-like
    images of 50 classes, one `synthetic_image_classification` call (seed
    46, signal 1.0, noise 0.30), then a 90/10 train/test split, so the test
    rows share the training rows' class prototypes."""
    scale = constants.synth_scale() if scale is None else scale
    rng = np.random.default_rng(46)
    n = int(2000 * max(scale, 0.25))
    x, y = synthetic_image_classification(rng, n, (40, 431, 1), 50, signal=1.0, noise=0.30)
    x_tr, x_te, y_tr, y_te = train_test_split(x, y, test_size=0.1, random_state=42)
    return Dataset(constants.ESC50, (40, 431, 1), 50,
                   x_tr, to_categorical(y_tr, 50), x_te, to_categorical(y_te, 50),
                   model=model_zoo.ESC50_CNN, provenance="synthetic:prototype-noise")


DATASET_LOADERS = {
    constants.MNIST: load_mnist,
    constants.CIFAR10: load_cifar10,
    constants.TITANIC: load_titanic,
    constants.ESC50: load_esc50,
    constants.IMDB: load_imdb,
}


def load_dataset(name: str) -> Dataset:
    if name in DATASET_LOADERS:
        return DATASET_LOADERS[name]()
    raise ValueError(f"Dataset named '{name}' is not supported. You can "
                     "construct your own Dataset object.")
