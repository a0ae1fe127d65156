"""Partner: one data-providing silo, plus its label-corruption operators.

A copy of `mplc_tpu/data/partner.py` (pure numpy): the reference mplc
`Partner` with its corruption families (offset "corrupted", permutation,
Dirichlet "random", per-row shuffle, feature noise, global-label flip).
All randomness is drawn from an explicit, per-partner seeded numpy
Generator, so scenarios are reproducible end to end.
"""

from __future__ import annotations

import numpy as np

from .. import constants
from .datasets import to_categorical

# The corruption vocabulary (`Scenario.corrupted_datasets` entries).
# Scenario validates specs against this list at CONSTRUCTION — an unknown
# name raises immediately with the valid options instead of silently
# running an uncorrupted partner through a "corrupted" scenario.
#   not_corrupted  leave the partner alone
#   corrupted      offset labels by one class (deterministic attack)
#   shuffled       per-row shuffle of the one-hot vector
#   permuted       a random fixed K x K class permutation
#   random         resample labels from a per-class Dirichlet row
#   noisy          seeded Gaussian noise on the FEATURES (sigma = spec
#                  parameter) — the feature-skew / sensor-degradation silo
#   glabel         flip a fraction of labels to ONE seeded global target
#                  class — the targeted label-poisoning attack
CORRUPTION_KINDS = ("not_corrupted", "corrupted", "shuffled", "permuted",
                    "random", "noisy", "glabel")


def _ensure_categorical(y: np.ndarray) -> tuple[np.ndarray, bool]:
    """Reference `_Decorator.categorical_needed`: promote 1-D integer
    labels to one-hot for the transform, remember to demote after."""
    if y.ndim == 1:
        return to_categorical(y.astype(int), int(y.max()) + 1 if len(y) else 2), True
    return y, False


class Partner:
    def __init__(self, partner_id: int, seed: int | None = None):
        self.id = partner_id
        self.batch_size = constants.DEFAULT_BATCH_SIZE

        self.cluster_count: int = 0
        self.cluster_split_option: str = ""
        self.clusters_list: list = []
        self.final_nb_samples: int = 0
        self.final_nb_samples_p_cluster: int = 0

        self.x_train = None
        self.x_val = None
        self.x_test = None
        self.y_train = None
        self.y_val = None
        self.y_test = None

        self.corruption_matrix = None
        self._rng = np.random.default_rng(0xC0A1 + partner_id if seed is None else seed)

    @property
    def num_labels(self) -> int:
        return self.y_train.shape[1]

    @property
    def data_volume(self) -> int:
        return len(self.y_train)

    def _check_proportion(self, proportion: float):
        if not 0 <= proportion <= 1:
            raise ValueError(
                f"The proportion of labels to corrupt was {proportion} "
                f"but it must be between 0 and 1.")

    def corrupt_labels(self, proportion_corrupted: float):
        """Offset corruption: argmax label c -> c-1."""
        self._check_proportion(proportion_corrupted)
        y, demote = _ensure_categorical(self.y_train)
        n = int(len(y) * proportion_corrupted)
        idx = self._rng.choice(len(y), size=n, replace=False)
        hot = np.argmax(y[idx], axis=1)
        y[idx] = 0.0
        y[idx, hot - 1] = 1.0
        self.y_train = np.argmax(y, axis=1) if demote else y

    def permute_labels(self, proportion_corrupted: float = 1):
        """Apply a random K x K permutation matrix."""
        self._check_proportion(proportion_corrupted)
        y, demote = _ensure_categorical(self.y_train)
        n = int(len(y) * proportion_corrupted)
        idx = self._rng.choice(len(y), size=n, replace=False)
        k = y.shape[1]
        self.corruption_matrix = np.zeros((k, k))
        self.corruption_matrix[np.arange(k), self._rng.permutation(k)] = 1
        y[idx] = y[idx] @ self.corruption_matrix.T
        self.y_train = np.argmax(y, axis=1) if demote else y

    def random_labels(self, proportion_corrupted: float = 1):
        """Resample labels from a per-class Dirichlet row."""
        self._check_proportion(proportion_corrupted)
        y, demote = _ensure_categorical(self.y_train)
        n = int(len(y) * proportion_corrupted)
        idx = self._rng.choice(len(y), size=n, replace=False)
        k = y.shape[1]
        self.corruption_matrix = self._rng.dirichlet(np.ones(k), k)
        rows = self.corruption_matrix[np.argmax(y[idx], axis=1)]
        # vectorized categorical draw per row via inverse-CDF
        u = self._rng.uniform(size=(n, 1))
        draw = (u < np.cumsum(rows, axis=1)).argmax(axis=1)
        y[idx] = 0.0
        y[idx, draw] = 1.0
        self.y_train = np.argmax(y, axis=1) if demote else y

    def shuffle_labels(self, proportion_shuffled: float):
        """Shuffle each selected row's one-hot vector."""
        self._check_proportion(proportion_shuffled)
        y, demote = _ensure_categorical(self.y_train)
        n = int(len(y) * proportion_shuffled)
        idx = self._rng.choice(len(y), size=n, replace=False)
        for i in idx:
            self._rng.shuffle(y[i])
        self.y_train = np.argmax(y, axis=1) if demote else y

    def noisy_features(self, sigma: float = 0.1):
        """Seeded Gaussian noise on the train FEATURES: x += N(0, sigma).
        The feature-plane corruption family ('noisy') — degraded sensors,
        preprocessing drift — as opposed to the label attacks above.
        Integer feature spaces (token ids) cannot absorb additive noise."""
        if sigma < 0:
            raise ValueError(f"noise sigma must be >= 0, got {sigma}")
        x = np.asarray(self.x_train)
        if np.issubdtype(x.dtype, np.integer):
            raise ValueError(
                "'noisy' corruption requires float features; partner "
                f"{self.id}'s features are {x.dtype} (token ids?)")
        self.x_train = (x + self._rng.normal(0.0, sigma, x.shape)
                        ).astype(x.dtype, copy=False)

    def flip_to_global_label(self, proportion_corrupted: float = 1.0):
        """'glabel': flip a fraction of rows to ONE seeded target class —
        the targeted poisoning attack (every corrupted sample claims the
        same label), strictly harder to down-rank than uniform noise
        because the corrupted silo is self-consistent."""
        self._check_proportion(proportion_corrupted)
        y, demote = _ensure_categorical(self.y_train)
        n = int(len(y) * proportion_corrupted)
        idx = self._rng.choice(len(y), size=n, replace=False)
        target = int(self._rng.integers(y.shape[1]))
        y[idx] = 0.0
        y[idx, target] = 1.0
        self.corruption_matrix = np.zeros((y.shape[1], y.shape[1]))
        self.corruption_matrix[:, target] = 1.0
        self.y_train = np.argmax(y, axis=1) if demote else y
