"""Contributivity: staging, reconstruction and the estimators."""

from .contributivity import Contributivity, KrigingModel, power_set
from .engine import CharacteristicEngine
from .shapley import (bitmask_to_subset, powerset_order, shapley_from_characteristic,
                      subset_to_bitmask)

__all__ = [
    "Contributivity", "KrigingModel", "power_set", "CharacteristicEngine",
    "shapley_from_characteristic", "powerset_order", "subset_to_bitmask",
    "bitmask_to_subset",
]
