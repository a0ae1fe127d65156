"""Aggregation, metrics and the reconstruction kernel.

The JAX package's `aggregation.broadcast` has no counterpart: `aggregate`
reshapes its weights against each leaf itself (`ops/aggregation.py`)."""

from .aggregation import AGGREGATOR_NAMES, aggregate, aggregation_weights
from .metrics import (masked_loss_and_metrics, sigmoid_binary_cross_entropy,
                      softmax_cross_entropy)

__all__ = [
    "aggregation_weights", "aggregate", "AGGREGATOR_NAMES",
    "masked_loss_and_metrics", "softmax_cross_entropy",
    "sigmoid_binary_cross_entropy",
]
