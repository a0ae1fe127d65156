"""Datasets: the L1 layer (port of `mplc_tpu/data/datasets.py`).

Same `Dataset` contract as the JAX package: `x_train/y_train/x_val/
y_val/x_test/y_test`, `input_shape`, `num_classes`, a global 90/10
train/val split at construction (random_state=42), the local split hooks
the basic partitioner calls, `shorten_dataset_proportion` and
`generate_new_model`.

Each loader first looks for the dataset on disk, in `MPLC_TORCH_DATA_DIR`
and then `~/.keras/datasets`: `mnist.npz`, `cifar10.npz` (uint8 images
scaled to [0, 1]), `titanic.npz` or a raw `titanic.csv` /
`titanic/titanic.csv` (`featurize_titanic_csv`), `imdb.npz` (ragged token
lists padded or cut to 500 tokens), `esc50.npz` or a raw `esc50/` checkout
(`load_esc50_raw`). `provenance` then reads `cache:<path>` or `raw:<path>`
and the synthetic `scale` and `noise` are ignored. Without a file the
loader synthesizes the dataset, drawing the same numpy streams as the JAX
package's, so its arrays are byte-equal for the same `scale`. Every route
gives the JAX loader's arrays, but for one repair: an empty review of an
`imdb.npz` is a row of zeros (the JAX loader raises on it).

The port does not depend on scikit-learn: `train_test_split` below
reproduces scikit-learn's shuffle split (one `RandomState` permutation, the
first ceil(test_size * n) indices are the test rows), and the MNIST
prototypes are the JAX package's sklearn-digits prototypes, stored in
`digits_prototypes.npy` beside this file.
"""

from __future__ import annotations

import csv
import os
from math import ceil
from pathlib import Path

import numpy as np

from .. import constants
from ..models import zoo as model_zoo
from ..models.core import Model
from ..obs import trace as obs_trace

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
        self.x_train = x_train
        self.x_val = None
        self.x_test = x_test
        self.y_train = y_train
        self.y_val = None
        self.y_test = y_test
        self.model = model
        self.provenance = provenance
        with obs_trace.span("data.prepare", dataset=dataset_name):
            self.train_val_split_global()

    def train_val_split_global(self):
        if self.x_val is not None or self.y_val is not None:
            raise Exception("x_val and y_val should be of NoneType")
        self.x_train, self.x_val, self.y_train, self.y_val = train_test_split(
            self.x_train, self.y_train, test_size=0.1, random_state=42)

    @staticmethod
    def train_test_split_local(x, y):
        return x, np.array([]), y, np.array([])

    @staticmethod
    def train_val_split_local(x, y):
        return x, np.array([]), y, np.array([])

    def shorten_dataset_proportion(self, dataset_proportion: float):
        """Keep round(proportion x n) train and val rows, picked by one
        seed-42 `RandomState` shuffling the train indices, then the val
        indices."""
        if dataset_proportion == 1:
            return
        if not 0 < dataset_proportion < 1:
            raise ValueError("The dataset proportion should be strictly between 0 and 1")
        keep_train = int(round(len(self.x_train) * dataset_proportion))
        keep_val = int(round(len(self.x_val) * dataset_proportion))
        train_idx = np.arange(len(self.x_train))
        val_idx = np.arange(len(self.x_val))
        rng = np.random.RandomState(42)
        rng.shuffle(train_idx)
        rng.shuffle(val_idx)
        self.x_train = self.x_train[train_idx[:keep_train]]
        self.y_train = self.y_train[train_idx[:keep_train]]
        self.x_val = self.x_val[val_idx[:keep_val]]
        self.y_val = self.y_val[val_idx[:keep_val]]

    def generate_new_model(self) -> Model:
        """The dataset's model family (its parameters come from
        `model.init(generator)`)."""
        return self.model


class TitanicDataset(Dataset):
    """Titanic keeps its local 10% test/val split hooks."""

    @staticmethod
    def train_test_split_local(x, y):
        return train_test_split(x, y, test_size=0.1, random_state=42)

    @staticmethod
    def train_val_split_local(x, y):
        return train_test_split(x, y, test_size=0.1, random_state=42)


def _cache_dirs() -> list[Path]:
    """Where the loaders look for files: MPLC_TORCH_DATA_DIR, then
    `~/.keras/datasets`."""
    dirs = []
    env = os.environ.get(constants.DATA_DIR_ENV)
    if env:
        dirs.append(Path(env))
    dirs.append(Path.home() / ".keras" / "datasets")
    return dirs


def _find_cache(*names: str) -> Path | None:
    """The first of `names` found in the first folder that holds one."""
    for d in _cache_dirs():
        for n in names:
            p = d / n
            if p.exists():
                return p
    return None


def load_mnist(scale: float | None = None, noise: float | None = None) -> Dataset:
    """MNIST from `mnist.npz` (uint8 images / 255), else synthetic:
    sklearn-digits prototypes (upsampled to 28x28) plus Gaussian noise
    (`noise`, else MPLC_TORCH_SYNTH_NOISE, else 0.45), `scale` x 60000
    train and x 10000 test samples."""
    cache = _find_cache("mnist.npz")
    if cache is not None:
        with np.load(cache) as f:
            x_train, y_train = f["x_train"], f["y_train"]
            x_test, y_test = f["x_test"], f["y_test"]
        x_train = (x_train / 255.0).astype(np.float32).reshape(-1, 28, 28, 1)
        x_test = (x_test / 255.0).astype(np.float32).reshape(-1, 28, 28, 1)
        prov = f"cache:{cache}"
    else:
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
        prov = "synthetic:sklearn-digits-prototypes"
    return Dataset(constants.MNIST, (28, 28, 1), 10,
                   x_train, to_categorical(y_train, 10),
                   x_test, to_categorical(y_test, 10),
                   model=model_zoo.MNIST_CNN, provenance=prov)


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
    """CIFAR10 from `cifar10.npz` (uint8 images / 255), else synthetic:
    `scale` x 50000 train and x 10000 test 32x32x3 images, two
    `synthetic_image_classification` calls on one generator (seed 43,
    signal 0.8, `noise`, else MPLC_TORCH_SYNTH_NOISE, else 0.45).

    The second call draws prototypes of its own, so the synthetic test
    set's classes are not the training set's: a classifier fitted on the
    training rows scores chance on it, whatever it learns (ROADMAP.md,
    reference caveats). The validation rows come from the training set."""
    cache = _find_cache("cifar10.npz")
    if cache is not None:
        with np.load(cache) as f:
            x_train, y_train = f["x_train"], f["y_train"].reshape(-1)
            x_test, y_test = f["x_test"], f["y_test"].reshape(-1)
        x_train = (x_train / 255.0).astype(np.float32)
        x_test = (x_test / 255.0).astype(np.float32)
        prov = f"cache:{cache}"
    else:
        scale = constants.synth_scale() if scale is None else scale
        noise = constants.synth_noise(0.45) if noise is None else noise
        rng = np.random.default_rng(43)
        n_train = int(50000 * scale)
        n_test = int(10000 * scale)
        x_train, y_train = synthetic_image_classification(rng, n_train, (32, 32, 3), 10,
                                                          signal=0.8, noise=noise)
        x_test, y_test = synthetic_image_classification(rng, n_test, (32, 32, 3), 10,
                                                        signal=0.8, noise=noise)
        prov = "synthetic:prototype-noise"
    return Dataset(constants.CIFAR10, (32, 32, 3), 10,
                   x_train, to_categorical(y_train, 10),
                   x_test, to_categorical(y_test, 10),
                   model=model_zoo.CIFAR10_CNN, provenance=prov)


def with_held_out_test(dataset: Dataset, rows: int) -> Dataset:
    """A Dataset whose test set is the first `rows` of `dataset`'s training
    rows (already shuffled by its train/val split) and whose training
    rows are the rest, split 90/10 into train and val anew. For a loader
    whose own test set scores nothing, as `load_cifar10`'s."""
    with obs_trace.span("data.prepare", dataset=dataset.name, held_out_test=rows):
        return Dataset(dataset.name, dataset.input_shape, dataset.num_classes,
                       dataset.x_train[rows:], dataset.y_train[rows:],
                       dataset.x_train[:rows], dataset.y_train[:rows], model=dataset.model,
                       provenance=f"{dataset.provenance}, test = {rows} training rows")


def featurize_titanic_csv(csv_path) -> tuple[np.ndarray, np.ndarray]:
    """The 27 model features of a raw Stanford-CS109-format Titanic CSV
    (columns Survived, Pclass, Name, Sex, Age, Siblings/Spouses Aboard,
    Parents/Children Aboard, Fare; a leading `Unnamed` index column is
    dropped): sex (case-insensitive "male"), age, fare, family size, name
    length, is-alone, the passenger class one-hot, then the honorific (the
    name's first word) one-hot over the 18 most frequent titles, sorted,
    zero columns making up the width when there are fewer. NaNs become 0."""
    import pandas as pd
    df = pd.read_csv(csv_path, index_col=False)
    if df.columns[0].startswith("Unnamed"):
        df = df.drop(columns=df.columns[0])
    y = df["Survived"].to_numpy(np.float32)

    sibs = df["Siblings/Spouses Aboard"].to_numpy(np.float32)
    parch = df["Parents/Children Aboard"].to_numpy(np.float32)
    fam_size = sibs + parch
    cols = [
        df["Sex"].str.lower().eq("male").to_numpy(np.float32),
        df["Age"].to_numpy(np.float32),
        df["Fare"].to_numpy(np.float32),
        fam_size,
        df["Name"].str.len().to_numpy(np.float32),
        (fam_size == 0).astype(np.float32),
    ]
    for pclass in (1, 2, 3):
        cols.append(df["Pclass"].eq(pclass).to_numpy(np.float32))

    titles = df["Name"].str.split().str[0]
    n_title_cols = model_zoo.TITANIC_NUM_FEATURES - len(cols)
    counts = titles.value_counts()
    kept = sorted(counts.index[:n_title_cols])
    for t in kept:
        cols.append(titles.eq(t).to_numpy(np.float32))
    while len(cols) < model_zoo.TITANIC_NUM_FEATURES:
        cols.append(np.zeros(len(df), np.float32))

    x = np.stack(cols, axis=1).astype(np.float32)
    return np.nan_to_num(x), y


def load_titanic() -> Dataset:
    """Titanic from `titanic.npz` (`x`, `y`), else a raw `titanic.csv` or
    `titanic/titanic.csv` (`featurize_titanic_csv`), else synthetic 27
    features with a planted logistic rule; then a 90/10 train/test split."""
    cache = _find_cache("titanic.npz")
    raw = _find_cache("titanic.csv", "titanic/titanic.csv")
    if cache is not None:
        with np.load(cache) as f:
            x, y = f["x"].astype(np.float32), f["y"].astype(np.float32)
        prov = f"cache:{cache}"
    elif raw is not None:
        x, y = featurize_titanic_csv(raw)
        prov = f"raw:{raw}"
    else:
        rng = np.random.default_rng(44)
        n = 891
        x = rng.normal(0, 1, size=(n, model_zoo.TITANIC_NUM_FEATURES)).astype(np.float32)
        w = rng.normal(0, 1.5, size=(model_zoo.TITANIC_NUM_FEATURES,))
        p = 1.0 / (1.0 + np.exp(-(x @ w)))
        y = (rng.uniform(size=n) < p).astype(np.float32)
        prov = "synthetic:planted-logistic"
    x_tr, x_te, y_tr, y_te = train_test_split(x, y, test_size=0.1, random_state=42)
    return TitanicDataset(constants.TITANIC, (model_zoo.TITANIC_NUM_FEATURES,), 2,
                          x_tr, y_tr, x_te, y_te,
                          model=model_zoo.TITANIC_LOGREG, provenance=prov)


def pad_token_lists(seqs, seq_len: int) -> np.ndarray:
    """Ragged token lists as an int32 [n, seq_len] array: each list cut to
    its first `seq_len` tokens and right-aligned, zeros before it. An empty
    list is a row of zeros, as in Keras' `pad_sequences`."""
    out = np.zeros((len(seqs), seq_len), np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s[:seq_len], np.int32)
        if len(s):
            out[i, -len(s):] = s
    return out


def load_imdb(scale: float | None = None) -> Dataset:
    """IMDB sentiment from `imdb.npz` (ragged token lists, stored as object
    arrays, so read with pickle: the file must be one you trust;
    `pad_token_lists` to 500 tokens), else synthetic: `scale` x
    25000 train and x 25000 test reviews of 500 int32 token ids in [1,
    5000), binary labels. Each synthetic row carries 40 class-marker tokens
    at random positions, from [100, 200) for label 0 and [300, 400) for
    label 1, so the test set (drawn by the second of two calls on one
    generator, seed 45) follows the training set's rule."""
    seq_len = model_zoo.IMDB_SEQ_LEN
    cache = _find_cache("imdb.npz")
    if cache is not None:
        with np.load(cache, allow_pickle=True) as f:
            x_train, y_train = f["x_train"], f["y_train"]
            x_test, y_test = f["x_test"], f["y_test"]
        x_train, x_test = pad_token_lists(x_train, seq_len), pad_token_lists(x_test, seq_len)
        prov = f"cache:{cache}"
    else:
        scale = constants.synth_scale() if scale is None else scale
        rng = np.random.default_rng(45)

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
        prov = "synthetic:token-band"
    return Dataset(constants.IMDB, (seq_len,), 2,
                   x_train, y_train.astype(np.float32), x_test, y_test.astype(np.float32),
                   model=model_zoo.IMDB_CONV1D, provenance=prov)


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
    """ESC50 from `esc50.npz` (`x`, `y`), else a raw `esc50/` checkout
    (`esc50.csv` and `audio/`, `load_esc50_raw`), else synthetic: 2000 x
    max(scale, 0.25) [40, 431, 1] MFCC-like images of 50 classes, one
    `synthetic_image_classification` call (seed 46, signal 1.0, noise
    0.30). Then a 90/10 train/test split, so the synthetic test rows share
    the training rows' class prototypes."""
    cache = _find_cache("esc50.npz")
    raw = next((d / "esc50" for d in _cache_dirs()
                if (d / "esc50" / "esc50.csv").exists() and (d / "esc50" / "audio").is_dir()),
               None)
    if cache is not None:
        with np.load(cache) as f:
            x, y = f["x"].astype(np.float32), f["y"]
        prov = f"cache:{cache}"
    elif raw is not None:
        x, y = load_esc50_raw(raw)
        prov = f"raw:{raw}"
    else:
        scale = constants.synth_scale() if scale is None else scale
        rng = np.random.default_rng(46)
        n = int(2000 * max(scale, 0.25))
        x, y = synthetic_image_classification(rng, n, (40, 431, 1), 50, signal=1.0, noise=0.30)
        prov = "synthetic:prototype-noise"
    x_tr, x_te, y_tr, y_te = train_test_split(x, y, test_size=0.1, random_state=42)
    return Dataset(constants.ESC50, (40, 431, 1), 50,
                   x_tr, to_categorical(y_tr, 50), x_te, to_categorical(y_te, 50),
                   model=model_zoo.ESC50_CNN, provenance=prov)


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
