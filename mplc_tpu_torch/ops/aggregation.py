"""Weight aggregation, the "communication backend" (port of
`mplc_tpu/ops/aggregation.py`, non-deterministic reduction path).

Partner models are one parameter dict with a stacked leading axis `[P, ...]`,
so aggregation is one weighted sum over that axis per tensor. Coalition
membership enters here: the coalition mask multiplies the weight vector
before normalization, so inactive partners get weight 0.
"""

from __future__ import annotations

import torch

AGGREGATOR_NAMES = ("uniform", "data-volume", "local-score")


def aggregation_weights(kind: str, coalition_mask: torch.Tensor,
                        sizes: torch.Tensor, last_scores: torch.Tensor) -> torch.Tensor:
    """The normalized weight vector w[P] for one aggregation step.

    kind: 'uniform' | 'data-volume' | 'local-score'
    coalition_mask: [P] float 0/1; sizes: [P] sample counts (data-volume);
    last_scores: [P] last-round val accuracy (local-score).
    """
    if kind == "uniform":
        raw = coalition_mask
    elif kind == "data-volume":
        raw = coalition_mask * sizes.float()
    elif kind == "local-score":
        raw = coalition_mask * last_scores
    else:
        raise KeyError(f"aggregation approach '{kind}' is not a valid approach. "
                       f"Supported: {AGGREGATOR_NAMES}")
    return raw / torch.clamp(torch.sum(raw), min=1e-12)


def aggregate(stacked_params: dict, weights: torch.Tensor) -> dict:
    """Weighted sum over the partner axis of every tensor of a stacked
    parameter dict ([P, ...] leaves, weights [P])."""
    def reduce(leaf):
        return torch.sum(leaf * weights.reshape((-1,) + (1,) * (leaf.ndim - 1)), dim=0)
    return {g: {k: reduce(t) for k, t in d.items()}
            for g, d in stacked_params.items()}


def broadcast(params: dict, partners_count: int) -> dict:
    """One parameter dict replicated along a new leading partner axis (an
    expanded view: nothing is copied)."""
    return {g: {k: t.unsqueeze(0).expand((partners_count,) + t.shape)
                for k, t in d.items()} for g, d in params.items()}
