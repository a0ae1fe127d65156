"""Synthetic CIFAR10: the port's `load_cifar10` training rows (32x32x3
class prototypes, smoothed by a roll along each spatial axis, times the
signal 0.8, plus Gaussian noise, clipped to [0, 1]), seeded by the run's
seed where the port fixes 43. At seed 43 and the same size they are the
port's training rows byte for byte. The port draws its test set from
prototypes of its own, which score chance; this data set has no test set,
and a configuration holds training rows out as its test set instead."""

import numpy as np

from ..split import one_hot


def make(seed: int, n_train: int, noise: float, signal: float = 0.8) -> dict:
    rng = np.random.default_rng(seed)
    shape = (32, 32, 3)
    protos = rng.uniform(0.0, 1.0, size=(10,) + shape).astype(np.float32)
    protos = 0.5 * protos + 0.25 * np.roll(protos, 1, axis=1) + 0.25 * np.roll(protos, 1, axis=2)
    y = rng.integers(0, 10, size=n_train)
    x = protos[y] * signal + rng.normal(0.0, noise, size=(n_train,) + shape).astype(np.float32)
    return {"x_train": np.clip(x, 0.0, 1.0).astype(np.float32), "y_train": one_hot(y, 10)}
