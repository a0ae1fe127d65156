"""Weight aggregation, the "communication backend" (port of
`mplc_tpu/ops/aggregation.py`, non-deterministic reduction path).

Partner models are one parameter dict with a stacked partner axis `[P, ...]`
(`[B, P, ...]` for a batch of coalitions), so aggregation is one weighted
sum over that axis per tensor. Coalition membership enters here: the
coalition mask multiplies the weight vector before normalization, so
inactive partners get weight 0.
"""

from __future__ import annotations

import torch

AGGREGATOR_NAMES = ("uniform", "data-volume", "local-score")


def aggregation_weights(kind: str, coalition_mask: torch.Tensor,
                        sizes: torch.Tensor, last_scores: torch.Tensor) -> torch.Tensor:
    """The normalized weight vector w[P] for one aggregation step (one row
    per coalition for masks [B, P]).

    kind: 'uniform' | 'data-volume' | 'local-score'
    coalition_mask: [P] or [B, P] float 0/1; sizes: [P] sample counts
    (data-volume); last_scores: like the mask, last-round val accuracy
    (local-score).
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
    return raw / torch.clamp(torch.sum(raw, dim=-1, keepdim=True), min=1e-12)


def aggregate(stacked_params: dict, weights: torch.Tensor) -> dict:
    """Weighted sum over the partner axis of every tensor of a stacked
    parameter dict ([P, ...] leaves with weights [P], or [B, P, ...] with
    weights [B, P])."""
    def reduce(leaf):
        w = weights.reshape(weights.shape + (1,) * (leaf.ndim - weights.ndim))
        return torch.sum(leaf * w, dim=weights.ndim - 1)
    return {g: {k: reduce(t) for k, t in d.items()}
            for g, d in stacked_params.items()}

