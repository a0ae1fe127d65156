"""Datasets, partners and partitioning."""

from .datasets import DATASET_LOADERS, Dataset, load_dataset, to_categorical
from .partner import Partner
from .partition import (StackedPartners, compute_batch_sizes, split_advanced, split_basic,
                        stack_eval_set)

__all__ = [
    "Dataset", "load_dataset", "DATASET_LOADERS", "to_categorical", "Partner",
    "StackedPartners", "split_basic", "split_advanced", "compute_batch_sizes",
    "stack_eval_set",
]
