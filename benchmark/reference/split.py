"""Frozen copies of the splits that share a data set out, in plain NumPy.

The harness makes a configuration's raw arrays once (`datasets/<kind>.py`)
and hands the same arrays to the program (through its `Dataset`) and to
the reference, which splits them itself with the copies below:

- `train_val_split`: scikit-learn's shuffle split with random_state 42, as
  the port's `Dataset` splits its training rows 90/10 into train and val;
- `held_out_test`: the port's `with_held_out_test` (the first rows of the
  training split become the test set, the rest is split 90/10 anew);
- `partner_split`: the port's basic random split (one seed-42 shuffle of the
  training rows, cut at the cumulative amounts).

The MNIST prototypes are the sklearn-digits prototypes the port stores
beside its loader, copied here as `digits_prototypes.npy`.
"""

from __future__ import annotations

from math import ceil
from pathlib import Path

import numpy as np

PROTOTYPES = Path(__file__).with_name("digits_prototypes.npy")


def one_hot(y: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((len(y), num_classes), np.float32)
    out[np.arange(len(y)), y.astype(int)] = 1.0
    return out


def shuffle_split(n: int, test_size: float, random_state: int = 42):
    """(train indices, test indices) of scikit-learn's `train_test_split`
    for a float `test_size`: one permutation, the first ceil(test_size * n)
    indices are the test rows."""
    n_test = ceil(test_size * n)
    perm = np.random.RandomState(random_state).permutation(n)
    return perm[n_test:], perm[:n_test]


def train_val_split(x, y):
    """(x_train, y_train, x_val, y_val): the 90/10 split of a data set's
    training rows."""
    tr, va = shuffle_split(len(x), 0.1)
    return x[tr], y[tr], x[va], y[va]


def held_out_test(x_train, y_train, rows: int):
    """(x_train, y_train, x_val, y_val, x_test, y_test) of a data set whose
    test set is the first `rows` training rows after its 90/10 split, the
    rest split 90/10 anew."""
    x_tr, y_tr, _, _ = train_val_split(x_train, y_train)
    x_te, y_te = x_tr[:rows], y_tr[:rows]
    x2, y2, x_va, y_va = train_val_split(x_tr[rows:], y_tr[rows:])
    return x2, y2, x_va, y_va, x_te, y_te


def partner_split(n: int, amounts) -> list:
    """Each partner's row indices into the training rows: one seed-42
    shuffle, cut at the cumulative amounts."""
    idx = np.arange(n)
    np.random.RandomState(42).shuffle(idx)
    cuts = (np.cumsum(amounts)[:-1] * n).astype(int)
    return np.split(idx, cuts)
