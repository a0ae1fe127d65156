"""Data partitioning among partners, and the stacked device layout (port of
`mplc_tpu/data/partition.py`: the basic and advanced splits, batch sizes,
stacking).

`split_basic`, `split_advanced` and `compute_batch_sizes` are numpy and
reproduce the JAX package's splits byte for byte (same seed-42 shuffles,
same label order, the same `random.Random(42)` draws).
`StackedPartners` pads every partner's train data to a common length and
stacks it on a leading partner axis `[P, Nmax, ...]` with a validity mask,
on the requested device: every multi-partner strategy is then a batch
dimension over axis 0 and every coalition a length-P mask.
"""

from __future__ import annotations

import random
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .datasets import Dataset, train_test_split
from .partner import Partner


def _encode_labels(y) -> np.ndarray:
    """scikit-learn's `LabelEncoder().fit_transform([str(v) for v in y])`:
    each label's index among the sorted distinct label strings."""
    return np.unique([str(v) for v in y], return_inverse=True)[1]


def split_basic(dataset: Dataset, partners_list: Sequence[Partner],
                amounts_per_partner: Sequence[float], description: str,
                minibatch_count: int) -> None:
    partners_count = len(partners_list)
    y_train_enc = _encode_labels(dataset.y_train)

    if len(amounts_per_partner) != partners_count:
        raise ValueError("amounts_per_partner list should have a size equal "
                         "to partners_count")
    if abs(np.sum(amounts_per_partner) - 1.0) >= 1e-9:
        raise ValueError("the sum of the amounts_per_partner proportions "
                         "isn't equal to 1")

    if partners_count == 1:
        train_idx_list = [np.arange(len(y_train_enc))]
    else:
        cum = np.cumsum(amounts_per_partner)[:-1]
        splitting_indices_train = (cum * len(y_train_enc)).astype(int)
        if description == "stratified":
            train_idx = np.asarray(y_train_enc).argsort()
        elif description == "random":
            train_idx = np.arange(len(y_train_enc))
            np.random.RandomState(42).shuffle(train_idx)
        else:
            raise NameError(f"This samples_split option [{description}] is not recognized.")
        train_idx_list = np.split(train_idx, splitting_indices_train)

    for p, idx in zip(partners_list, train_idx_list):
        p.x_train = np.asarray(dataset.x_train)[idx]
        p.y_train = np.asarray(dataset.y_train)[idx]
        p.x_train, p.x_test, p.y_train, p.y_test = dataset.train_test_split_local(
            p.x_train, p.y_train)
        p.x_train, p.x_val, p.y_train, p.y_val = dataset.train_val_split_local(
            p.x_train, p.y_train)
        p.final_nb_samples = len(p.x_train)
        p.clusters_list = sorted(set(np.asarray(y_train_enc)[idx].tolist()))

    if minibatch_count > min(amounts_per_partner) * len(y_train_enc):
        raise ValueError("a partner doesn't have enough data samples to "
                         "create the minibatches")


def split_advanced(dataset: Dataset, partners_list: Sequence[Partner],
                   amounts_per_partner: Sequence[float],
                   description: Sequence, minibatch_count: int) -> tuple[int, list[float]]:
    """The cluster split: partner i takes `description[i]` = (count,
    "specific" | "shared") label clusters. The labels are shuffled by
    `random.Random(42)`; the "specific" partners, largest count first, take
    consecutive runs of them; the next max(shared counts) labels are the
    shared clusters, from which each "shared" partner, largest count first,
    draws its own with the same generator. Every partner's amount is then
    scaled by one factor so that no cluster is overdrawn, split evenly over
    its clusters (shared clusters handed out in partner order), and its rows
    split 90/10 into train and val, then train and test.

    Returns (nb_samples_used, final_relative_nb_samples)."""
    y_train = _encode_labels(dataset.y_train)
    x_full = np.asarray(dataset.x_train)
    y_full = np.asarray(dataset.y_train)

    for p in partners_list:
        p.cluster_count = int(description[p.id][0])
        p.cluster_split_option = description[p.id][1]
    shared_ps = [p for p in partners_list if p.cluster_split_option == "shared"]
    specific_ps = [p for p in partners_list if p.cluster_split_option == "specific"]
    shared_ps.sort(key=lambda p: p.cluster_count, reverse=True)
    specific_ps.sort(key=lambda p: p.cluster_count, reverse=True)

    labels = sorted(set(y_train.tolist()))
    rnd = random.Random(42)
    rnd.shuffle(labels)

    specific_clusters_count = sum(p.cluster_count for p in specific_ps)
    shared_clusters_count = max((p.cluster_count for p in shared_ps), default=0)
    if specific_clusters_count + shared_clusters_count > len(labels):
        raise AssertionError(
            "Incompatibility between the advanced split arguments and the dataset's "
            "label count: total requested clusters exceed the number of labels")

    x_c, y_c, n_c = {}, {}, {}
    for label in labels:
        idx = np.where(y_train == label)[0]
        x_c[label] = x_full[idx]
        y_c[label] = y_full[idx]
        n_c[label] = len(idx)

    index = 0
    for p in specific_ps:
        p.clusters_list = labels[index:index + p.cluster_count]
        index += p.cluster_count
    shared_clusters = labels[index:index + shared_clusters_count]
    for p in shared_ps:
        p.clusters_list = rnd.sample(shared_clusters, k=p.cluster_count)

    resize_specific = 1.0
    for p in specific_ps:
        available = sum(n_c[cl] for cl in p.clusters_list)
        requested = int(amounts_per_partner[p.id] * len(y_train))
        resize_specific = min(resize_specific, available / requested)

    resize_shared = 1.0
    needed = dict.fromkeys(shared_clusters, 0)
    for p in shared_ps:
        amount = int(amounts_per_partner[p.id] * len(y_train) * resize_specific)
        per_cluster = int(amount / p.cluster_count)
        for cl in p.clusters_list:
            needed[cl] += per_cluster
    for cl in needed:
        if needed[cl] > 0:
            resize_shared = min(resize_shared, n_c[cl] / needed[cl])

    final_resize = resize_specific * resize_shared
    for p in partners_list:
        p.final_nb_samples = int(amounts_per_partner[p.id] * len(y_train) * final_resize)
        p.final_nb_samples_p_cluster = int(p.final_nb_samples / p.cluster_count)
    nb_samples_used = sum(p.final_nb_samples for p in partners_list)
    final_relative = [p.final_nb_samples / nb_samples_used for p in partners_list]

    shared_index = dict.fromkeys(shared_clusters, 0)
    for p in partners_list:
        xs, ys = [], []
        for cl in p.clusters_list:
            i0 = shared_index[cl] if p.cluster_split_option == "shared" else 0
            xs.append(x_c[cl][i0:i0 + p.final_nb_samples_p_cluster])
            ys.append(y_c[cl][i0:i0 + p.final_nb_samples_p_cluster])
            if p.cluster_split_option == "shared":
                shared_index[cl] += p.final_nb_samples_p_cluster
        p.x_train, p.x_val, p.y_train, p.y_val = train_test_split(
            np.concatenate(xs), np.concatenate(ys), test_size=0.1, random_state=42)
        p.x_train, p.x_test, p.y_train, p.y_test = train_test_split(
            p.x_train, p.y_train, test_size=0.1, random_state=42)

    if minibatch_count > min(len(p.x_train) for p in partners_list):
        raise AssertionError("Error: a partner doesn't have enough data samples to "
                             "create the minibatches")
    return nb_samples_used, final_relative


def compute_batch_sizes(partners_list: Sequence[Partner], minibatch_count: int,
                        gradient_updates_per_pass_count: int,
                        max_batch_size: int) -> None:
    if len(partners_list) == 1:
        p = partners_list[0]
        p.batch_size = int(np.clip(len(p.x_train) // gradient_updates_per_pass_count,
                                   1, max_batch_size))
    else:
        for p in partners_list:
            bs = len(p.x_train) // (minibatch_count * gradient_updates_per_pass_count)
            p.batch_size = int(np.clip(bs, 1, max_batch_size))


class StackedPartners(NamedTuple):
    """All partners' train data as padded stacked tensors.

    x:     [P, Nmax, ...]   float32 (int32 token ids when every partner's
                            features are integer)
    y:     [P, Nmax, L]     float32 (one-hot, or [.,1] binary)
    mask:  [P, Nmax]        float32 validity
    sizes: [P]              int64 true sample counts
    mask_host: [P, Nmax]    the validity mask's copy on the CPU, from which
                            the trainer draws each epoch's permutations
                            without reading the device (None: `mask` is
                            read when needed)
    """

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor
    sizes: torch.Tensor
    mask_host: torch.Tensor | None = None

    @property
    def partners_count(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_max(self) -> int:
        return int(self.x.shape[1])

    @staticmethod
    def build(partners_list: Sequence[Partner], label_dim: int,
              device) -> "StackedPartners":
        P = len(partners_list)
        n_max = max(len(p.x_train) for p in partners_list)
        x0 = np.asarray(partners_list[0].x_train)
        # int32 only when EVERY partner's features are integer: a partner
        # whose features were floated (feature noise) must not be
        # truncated back to integers
        x_dtype = (np.int32 if all(np.issubdtype(np.asarray(p.x_train).dtype, np.integer)
                                   for p in partners_list) else np.float32)
        x = np.zeros((P, n_max) + x0.shape[1:], x_dtype)
        y = np.zeros((P, n_max, label_dim), np.float32)
        mask = np.zeros((P, n_max), np.float32)
        sizes = np.zeros((P,), np.int64)
        for i, p in enumerate(partners_list):
            n = len(p.x_train)
            x[i, :n] = p.x_train
            yi = np.asarray(p.y_train, np.float32)
            if yi.ndim == 1:
                yi = yi[:, None]
            y[i, :n] = yi
            mask[i, :n] = 1.0
            sizes[i] = n
        return StackedPartners(*(torch.from_numpy(a).to(device)
                                 for a in (x, y, mask, sizes)),
                               mask_host=torch.from_numpy(mask))


def stack_eval_set(x: np.ndarray, y: np.ndarray, label_dim: int,
                   chunk: int, device) -> tuple[torch.Tensor, ...]:
    """Pad an eval set to a multiple of `chunk` and reshape it to
    [n_chunks, chunk, ...]: (x, y, mask) tensors on `device`; x int32 for
    integer features, else float32."""
    n = len(x)
    n_pad = (-n) % chunk
    x = np.asarray(x)
    x = x.astype(np.int32 if np.issubdtype(x.dtype, np.integer) else np.float32)
    y = np.asarray(y, np.float32)
    if y.ndim == 1:
        y = y[:, None]
    xp = np.concatenate([x, np.zeros((n_pad,) + x.shape[1:], x.dtype)])
    yp = np.concatenate([y, np.zeros((n_pad, y.shape[1]), np.float32)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(n_pad, np.float32)])
    n_chunks = (n + n_pad) // chunk
    return tuple(torch.from_numpy(a).to(device) for a in (
        xp.reshape((n_chunks, chunk) + x.shape[1:]),
        yp.reshape(n_chunks, chunk, y.shape[1]),
        mask.reshape(n_chunks, chunk)))
