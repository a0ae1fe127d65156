"""Masked losses and metrics (port of `mplc_tpu/ops/metrics.py`).

Partner data is stored as padded stacked tensors, so every function takes
an explicit `mask`: padded rows contribute exactly zero loss and zero
gradient.
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """Per-example categorical cross-entropy from logits. [N, C] -> [N]."""
    return -torch.sum(y_onehot * torch.log_softmax(logits, dim=-1), dim=-1)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-example binary cross-entropy from a single logit. [N, 1] -> [N]."""
    logits = logits.reshape(logits.shape[0])
    y = y.reshape(y.shape[0])
    return (torch.clamp(logits, min=0.0) - logits * y
            + torch.log1p(torch.exp(-torch.abs(logits))))


def categorical_correct(logits: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == torch.argmax(y_onehot, dim=-1)).float()


def binary_correct(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logits = logits.reshape(logits.shape[0])
    y = y.reshape(y.shape[0])
    return ((logits > 0.0) == (y > 0.5)).float()


def masked_loss_and_metrics(loss_kind: str, logits: torch.Tensor, y: torch.Tensor,
                            mask: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Return (mean_loss, accuracy, valid_count) under `mask`.

    A batch with no valid row (an inactive partner's slot) returns loss 0
    and accuracy 0, never NaN.
    """
    if loss_kind == "binary":
        per_ex_loss = sigmoid_binary_cross_entropy(logits, y)
        per_ex_correct = binary_correct(logits, y)
    else:
        per_ex_loss = softmax_cross_entropy(logits, y)
        per_ex_correct = categorical_correct(logits, y)
    mask = mask.float()
    count = torch.sum(mask)
    denom = torch.clamp(count, min=1.0)
    return (torch.sum(per_ex_loss * mask) / denom,
            torch.sum(per_ex_correct * mask) / denom, count)
