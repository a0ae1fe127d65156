"""The masked FedAvg trainer, approaches and history."""

from .approaches import (MULTI_PARTNER_LEARNING_APPROACHES, FederatedAverageLearning,
                         MplLabelFlip, MultiPartnerLearning, SequentialAverageLearning,
                         SequentialLearning, SequentialWithFinalAggLearning,
                         SinglePartnerLearning, load_params_npz, save_params_npz)
from .engine import APPROACH_NAMES, EvalSet, MplTrainer, TrainConfig, TrainState
from .history import History

__all__ = [
    "MplTrainer", "TrainConfig", "TrainState", "EvalSet", "APPROACH_NAMES",
    "History", "MULTI_PARTNER_LEARNING_APPROACHES", "MultiPartnerLearning",
    "FederatedAverageLearning", "SequentialLearning",
    "SequentialWithFinalAggLearning", "SequentialAverageLearning",
    "MplLabelFlip", "SinglePartnerLearning", "save_params_npz", "load_params_npz",
]
