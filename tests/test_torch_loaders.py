"""The loaders' cache and raw-file routes of the PyTorch port against the
JAX package's, on files the tests write: with `MPLC_TPU_DATA_DIR` and
`MPLC_TORCH_DATA_DIR` naming the same folder (or both unset and the files
under `~/.keras/datasets`), every route gives byte-equal arrays and the
same provenance; the synthetic `scale` is ignored on a cache route. An
empty review in `imdb.npz` makes the JAX loader raise, and the port pad it
to a row of zeros, as Keras' `pad_sequences` does."""

import wave

import numpy as np
import pandas as pd
import pytest
import torch

from mplc_tpu.data import datasets as jdatasets
from mplc_tpu_torch.data import datasets as tdatasets

torch.set_num_threads(1)

ARRAYS = ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test")


@pytest.fixture
def data_dir(monkeypatch, tmp_path):
    """An empty folder that both packages' data-folder knobs name; HOME is
    another empty folder, so `~/.keras/datasets` holds nothing."""
    folder = tmp_path / "data"
    folder.mkdir()
    monkeypatch.setenv("MPLC_TPU_DATA_DIR", str(folder))
    monkeypatch.setenv("MPLC_TORCH_DATA_DIR", str(folder))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("MPLC_TPU_SYNTH_SCALE", "0.02")
    return folder


def _same(jd, td, provenance):
    assert jd.provenance == td.provenance == provenance
    assert (jd.name, jd.input_shape, jd.num_classes) == (td.name, td.input_shape, td.num_classes)
    for name in ARRAYS:
        a, b = getattr(jd, name), getattr(td, name)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


def _images(path, shape, n_train, n_test, y_column=False, seed=0):
    rng = np.random.default_rng(seed)
    y = lambda n: rng.integers(0, 10, (n, 1) if y_column else n, dtype=np.uint8)  # noqa: E731
    np.savez(path, x_train=rng.integers(0, 256, (n_train,) + shape, dtype=np.uint8),
             y_train=y(n_train), x_test=rng.integers(0, 256, (n_test,) + shape, dtype=np.uint8),
             y_test=y(n_test))


def test_mnist_cache(data_dir):
    _images(data_dir / "mnist.npz", (28, 28), 60, 20)
    td = tdatasets.load_mnist(scale=0.5, noise=0.1)
    _same(jdatasets.load_mnist(), td, f"cache:{data_dir / 'mnist.npz'}")
    assert td.x_train.shape == (54, 28, 28, 1) and td.x_test.shape == (20, 28, 28, 1)
    assert td.x_train.max() <= 1.0 and td.y_train.shape == (54, 10)


def test_cifar10_cache(data_dir):
    _images(data_dir / "cifar10.npz", (32, 32, 3), 40, 10, y_column=True)
    td = tdatasets.load_cifar10(scale=0.5)
    _same(jdatasets.load_cifar10(), td, f"cache:{data_dir / 'cifar10.npz'}")
    assert td.x_test.shape == (10, 32, 32, 3) and td.y_test.shape == (10, 10)


def test_titanic_cache_wins_over_the_csv(data_dir):
    rng = np.random.default_rng(1)
    np.savez(data_dir / "titanic.npz", x=rng.normal(size=(50, 27)),
             y=rng.integers(0, 2, 50))
    _titanic_csv(data_dir / "titanic.csv")
    _same(jdatasets.load_titanic(), tdatasets.load_titanic(),
          f"cache:{data_dir / 'titanic.npz'}")


TITLES = ["Mr.", "Mrs.", "Miss.", "Master.", "Rev.", "Dr.", "Col.", "Major.", "Mlle.",
          "Ms.", "Mme.", "Capt.", "Don.", "Lady.", "Sir.", "Countess.", "Jonkheer.",
          "Dona.", "Prof.", "Herr.", "Fr.", "Sgt."]


def _titanic_csv(path, n=120):
    """A Stanford-CS109-format CSV with a leading `Unnamed` index column,
    mixed-case `Sex`, missing ages and 22 titles (more than the 18 kept)."""
    rng = np.random.default_rng(2)
    titles = [TITLES[min(int(rng.exponential(4)), len(TITLES) - 1)] for _ in range(n)]
    titles[:len(TITLES)] = TITLES
    age = rng.uniform(1, 80, n).round(1)
    age[::7] = np.nan
    pd.DataFrame({
        "Survived": rng.integers(0, 2, n), "Pclass": rng.integers(1, 4, n),
        "Name": [f"{t} Jo{'h' * (i % 5)}n Smith" for i, t in enumerate(titles)],
        "Sex": rng.choice(["male", "Male", "female", "FEMALE"], n), "Age": age,
        "Siblings/Spouses Aboard": rng.integers(0, 4, n),
        "Parents/Children Aboard": rng.integers(0, 3, n),
        "Fare": rng.uniform(5, 300, n).round(2),
    }).to_csv(path)


@pytest.mark.parametrize("where", ["titanic.csv", "titanic/titanic.csv"])
def test_titanic_raw_csv(data_dir, where):
    path = data_dir / where
    path.parent.mkdir(exist_ok=True)
    _titanic_csv(path)
    assert pd.read_csv(path).columns[0].startswith("Unnamed")
    td = tdatasets.load_titanic()
    _same(jdatasets.load_titanic(), td, f"raw:{path}")
    x = np.concatenate([td.x_train, td.x_val, td.x_test])
    assert x.shape[1] == 27 and np.isfinite(x).all()
    # sex matched case-insensitively; 18 title columns, each one-hot
    assert 0 < x[:, 0].sum() < len(x)
    assert (x[:, 9:].sum(axis=1) <= 1).all() and (x[:, 9:].sum(axis=0) > 0).all()


def test_titanic_under_keras_datasets(monkeypatch, tmp_path):
    """No knob set: `~/.keras/datasets` is where both packages look."""
    for knob in ("MPLC_TPU_DATA_DIR", "MPLC_TORCH_DATA_DIR"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    folder = tmp_path / ".keras" / "datasets"
    folder.mkdir(parents=True)
    _titanic_csv(folder / "titanic.csv")
    _same(jdatasets.load_titanic(), tdatasets.load_titanic(), f"raw:{folder / 'titanic.csv'}")


def _reviews(n, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 700, n)
    lengths[0] = 500
    out = np.empty(n, dtype=object)
    for i, k in enumerate(lengths):
        out[i] = [int(t) for t in rng.integers(1, 5000, k)]
    return out


def _imdb_npz(path, empty_train_row=None):
    x_train, x_test = _reviews(30, 3), _reviews(12, 4)
    if empty_train_row is not None:
        x_train[empty_train_row] = []
    np.savez(path, x_train=x_train, y_train=np.arange(30) % 2,
             x_test=x_test, y_test=np.arange(12) % 2)


def test_imdb_cache(data_dir):
    _imdb_npz(data_dir / "imdb.npz")
    td = tdatasets.load_imdb(scale=1.0)
    _same(jdatasets.load_imdb(), td, f"cache:{data_dir / 'imdb.npz'}")
    assert td.x_train.dtype == np.int32 and td.x_train.shape[1] == 500
    # right-aligned: a short review's zeros lead
    assert (td.x_test[:, 0] == 0).any() and (td.x_test[:, -1] != 0).all()


def test_imdb_empty_review_is_a_row_of_zeros(data_dir):
    """The JAX loader's `out[i, -len(s):] = s` is the whole row for an empty
    review, and numpy refuses to broadcast (0,) into (500,); the port pads
    it to zeros. The other rows are the JAX loader's on the file without
    the empty review."""
    _imdb_npz(data_dir / "imdb.npz")
    jd = jdatasets.load_imdb()
    _imdb_npz(data_dir / "imdb.npz", empty_train_row=5)
    with pytest.raises(ValueError, match="could not broadcast"):
        jdatasets.load_imdb()
    td = tdatasets.load_imdb()
    assert td.provenance == f"cache:{data_dir / 'imdb.npz'}"
    # the train/val split permutes the 30 rows: find where row 5 went
    perm = np.random.RandomState(42).permutation(30)
    val_rows, train_rows = perm[:3], perm[3:]
    for x, jx, rows in ((td.x_train, jd.x_train, train_rows), (td.x_val, jd.x_val, val_rows)):
        empty = rows == 5
        assert (x[empty] == 0).all()
        assert np.array_equal(x[~empty], jx[~empty])
    for name in ("y_train", "y_val", "x_test", "y_test"):
        assert np.array_equal(getattr(td, name), getattr(jd, name))


def test_pad_token_lists():
    out = tdatasets.pad_token_lists([[], [1, 2, 3], list(range(1, 8))], 5)
    assert out.dtype == np.int32
    assert out.tolist() == [[0] * 5, [0, 0, 1, 2, 3], [1, 2, 3, 4, 5]]


def test_esc50_cache(data_dir):
    rng = np.random.default_rng(5)
    np.savez(data_dir / "esc50.npz", x=rng.normal(size=(20, 40, 431, 1)),
             y=rng.integers(0, 50, 20))
    _same(jdatasets.load_esc50(), tdatasets.load_esc50(scale=1.0),
          f"cache:{data_dir / 'esc50.npz'}")


def _wav(path, seconds, freq, sr=44100):
    t = np.arange(int(sr * seconds)) / sr
    samples = (np.sin(2 * np.pi * freq * t) * 12000).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(samples.tobytes())


def test_esc50_raw_checkout(data_dir):
    """A raw checkout (mono int16 clips, ESC-50's format) goes through
    each package's MFCC front end; a checkout without `audio/` is not
    one."""
    folder = data_dir / "esc50"
    (folder / "audio").mkdir(parents=True)
    rows = ["filename,fold,target,category"]
    for i in range(10):
        name = f"1-{i}-A-{i}.wav"
        _wav(folder / "audio" / name, 0.1 + 0.02 * i, 200 + 90 * i)
        rows.append(f"{name},1,{i * 5},c{i}")
    (folder / "esc50.csv").write_text("\n".join(rows) + "\n")
    td = tdatasets.load_esc50(scale=1.0)
    _same(jdatasets.load_esc50(), td, f"raw:{folder}")
    assert td.x_train.shape[1:] == (40, 431, 1)


def test_esc50_without_audio_is_synthetic(data_dir):
    (data_dir / "esc50").mkdir()
    (data_dir / "esc50" / "esc50.csv").write_text("filename,fold,target,category\n")
    td = tdatasets.load_esc50(scale=0.02)
    _same(jdatasets.load_esc50(), td, "synthetic:prototype-noise")


def test_data_dir_comes_before_keras_datasets(data_dir, tmp_path):
    home = tmp_path / "home" / ".keras" / "datasets"
    home.mkdir(parents=True)
    _titanic_csv(home / "titanic.csv")
    _titanic_csv(data_dir / "titanic.csv", n=60)
    td = tdatasets.load_titanic()
    _same(jdatasets.load_titanic(), td, f"raw:{data_dir / 'titanic.csv'}")
    assert len(td.x_train) + len(td.x_val) + len(td.x_test) == 60


def test_dataset_methods_match_jax(data_dir):
    """The global split refuses to run twice, with the JAX message;
    `shorten_dataset_proportion` refuses a proportion outside (0, 1]."""
    jd, td = jdatasets.load_titanic(), tdatasets.load_titanic()
    outcomes = []
    for d in (jd, td):
        with pytest.raises(Exception) as e:
            d.train_val_split_global()
        outcomes.append((type(e.value), str(e.value)))
        with pytest.raises(ValueError, match="strictly between 0 and 1"):
            d.shorten_dataset_proportion(1.5)
    assert outcomes[0] == outcomes[1] == (Exception, "x_val and y_val should be of NoneType")
    assert td.generate_new_model() is td.model
