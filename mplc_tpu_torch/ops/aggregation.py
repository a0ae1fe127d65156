"""Weight aggregation, the "communication backend" (port of
`mplc_tpu/ops/aggregation.py`).

Partner models are one parameter dict with a stacked partner axis `[P, ...]`
(`[B, P, ...]` for a batch of coalitions), so aggregation is one weighted
sum over that axis per tensor. Coalition membership enters here: the
coalition mask multiplies the weight vector before normalization, so
inactive partners get weight 0.

Two reductions, as in the JAX package. The default sums each axis with
`torch.sum`, whose order depends on the length of the axis. The
deterministic one (`deterministic=True`, MPLC_TORCH_DETERMINISTIC_REDUCE)
folds it strictly left to right (`ordered_fold`), which is insensitive to
exactly-zero terms (x + 0.0 == x), so a coalition trained on k compact
slots and the same coalition trained masked over P rows aggregate to the
same bits. The JAX package's `fusion_fence` has no counterpart here: it
stops XLA from fusing the weighting multiply into the fold's adds, and
eager PyTorch materializes every product before the next add anyway.
"""

from __future__ import annotations

import torch

AGGREGATOR_NAMES = ("uniform", "data-volume", "local-score")


def ordered_fold(terms: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Strict left-to-right sum over `dim`: ((t0 + t1) + t2) + ... A left
    fold, not a tree, on purpose: partial sums ignore exactly-zero terms
    riding along, wherever they sit."""
    out = terms.select(dim, 0)
    for i in range(1, terms.shape[dim]):
        out = out + terms.select(dim, i)
    return out


def aggregation_weights(kind: str, coalition_mask: torch.Tensor,
                        sizes: torch.Tensor, last_scores: torch.Tensor,
                        deterministic: bool = False) -> torch.Tensor:
    """The normalized weight vector w[P] for one aggregation step (one row
    per coalition for masks [B, P]).

    kind: 'uniform' | 'data-volume' | 'local-score'
    coalition_mask: [P] or [B, P] float 0/1 (a slot batch's activity
    [B, K]); sizes: like the mask, or [P], sample counts (data-volume);
    last_scores: like the mask, last-round val accuracy (local-score).
    deterministic: the normalizer is the raw weights' `ordered_fold`.
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
    if deterministic:
        total = ordered_fold(raw, dim=-1).unsqueeze(-1)
    else:
        total = torch.sum(raw, dim=-1, keepdim=True)
    return raw / torch.clamp(total, min=1e-12)


def aggregate(stacked_params: dict, weights: torch.Tensor,
              deterministic: bool = False) -> dict:
    """Weighted sum over the partner axis of every tensor of a stacked
    parameter dict ([P, ...] leaves with weights [P], or [B, P, ...] with
    weights [B, P]); `deterministic` folds each leaf's weighted terms with
    `ordered_fold`."""
    axis = weights.ndim - 1

    def reduce(leaf):
        terms = leaf * weights.reshape(weights.shape + (1,) * (leaf.ndim - weights.ndim))
        return ordered_fold(terms, axis) if deterministic else torch.sum(terms, dim=axis)
    return {g: {k: reduce(t) for k, t in d.items()}
            for g, d in stacked_params.items()}
