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

Partner-sharded (`group`, an `AxisGroup` of parallel/mesh.py, the JAX
package's `axis_name`): the partner axis of the weights and parameters is
this rank's block of a mesh row, and the reduction spans the row. The
default reduce sums locally, then all-reduces the partial sums (all
leaves in one buffer). The deterministic one all-gathers the raw weights,
and every leaf's weighted terms (again one buffer), into global partner
order and folds them: the collective moves bytes and does no arithmetic,
so the result is bit-equal to the unsharded fold. A group of one rank
with no world formed returns its input, the unsharded computation.
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
                        deterministic: bool = False, group=None) -> torch.Tensor:
    """The normalized weight vector w[P] for one aggregation step (one row
    per coalition for masks [B, P]).

    kind: 'uniform' | 'data-volume' | 'local-score'
    coalition_mask: [P] or [B, P] float 0/1 (a slot batch's activity
    [B, K]); sizes: like the mask, or [P], sample counts (data-volume);
    last_scores: like the mask, last-round val accuracy (local-score).
    deterministic: the normalizer is the raw weights' `ordered_fold`.
    group: the partner axis's mesh row when it is sharded (the normalizer
    then spans the row's partners; the returned weights are this rank's).
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
        full = raw if group is None else group.all_gather(raw, dim=-1)
        total = ordered_fold(full, dim=-1).unsqueeze(-1)
    else:
        total = torch.sum(raw, dim=-1, keepdim=True)
        if group is not None:
            total = group.all_reduce(total)
    return raw / torch.clamp(total, min=1e-12)


def aggregate(stacked_params: dict, weights: torch.Tensor,
              deterministic: bool = False, group=None) -> dict:
    """Weighted sum over the partner axis of every tensor of a stacked
    parameter dict ([P, ...] leaves with weights [P], or [B, P, ...] with
    weights [B, P]); `deterministic` folds each leaf's weighted terms with
    `ordered_fold`. With `group` the partner axis is this rank's block of
    the row's partners, and one collective a call reduces every leaf over
    the row (the module docstring)."""
    axis = weights.ndim - 1

    def terms(leaf):
        return leaf * weights.reshape(weights.shape + (1,) * (leaf.ndim - weights.ndim))
    if group is None:
        return {g: {k: ordered_fold(terms(t), axis) if deterministic
                    else torch.sum(terms(t), dim=axis) for k, t in d.items()}
                for g, d in stacked_params.items()}
    leaves = [(g, k, t) for g, d in stacked_params.items() for k, t in d.items()]
    lead = weights.shape
    if deterministic:
        # every leaf's terms flattened into one [..., P_local, n] buffer,
        # gathered into [..., P, n] and folded element by element: the
        # same adds in the same order as each leaf's own fold
        flat = torch.cat([terms(t).reshape(lead + (-1,)) for _, _, t in leaves], -1)
        summed = ordered_fold(group.all_gather(flat, dim=axis), axis)
    else:
        flat = torch.cat([torch.sum(terms(t), dim=axis).reshape(lead[:-1] + (-1,))
                          for _, _, t in leaves], -1)
        summed = group.all_reduce(flat)
    out: dict = {}
    start = 0
    for g, k, t in leaves:
        shape = lead[:-1] + t.shape[len(lead):]
        n = int(torch.Size(t.shape[len(lead):]).numel())
        out.setdefault(g, {})[k] = summed[..., start:start + n].reshape(shape)
        start += n
    return out
