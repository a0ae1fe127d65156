"""The benchmark's own arithmetic of useful work: FLOPs of a coalition's
training and evaluation, and the operations and bytes of the
reconstruction kernel. Nothing here is read from the program, which a
later change may alter; the shapes come from the configuration and the
reference models (`reference/models/<model>.py`, each model's
`FORWARD_FLOPS`, 2 FLOPs a multiply-add).

Useful model FLOPs count only what a coalition's own members do: 3x the
forward FLOPs for each training row a member passes through the model
(forward and backward), 1x for each evaluated row. Models that pad a
gradient call to its width, unused slots and padded batch rows count
nothing.
"""

from __future__ import annotations


def train_rows(cfg: dict, sizes: list, subset, epochs: int) -> int:
    """Training rows the coalition's members pass through the model:
    a FedAvg member passes n // mbc rows a round, mbc rounds an epoch (the
    remainder of n mod mbc is dropped each epoch); a lone partner passes
    its n rows an epoch."""
    mbc = cfg["minibatch_count"]
    if len(subset) == 1:
        return epochs * sizes[subset[0]]
    return epochs * sum(sizes[p] // mbc * mbc for p in subset)


def retrain_flops(cfg: dict, forward: int, sizes: list, subset, epochs: int,
                  eval_rows: int) -> int:
    """A retrained coalition's useful FLOPs: its training and its test
    evaluation."""
    return 3 * forward * train_rows(cfg, sizes, subset, epochs) + forward * eval_rows


def recon_kernel_flops(b: int, k: int, dp: int) -> int:
    """K1, out[B, Dp] = init + wn[B, K] @ d[K, Dp]: 2 FLOPs a multiply-add."""
    return 2 * b * k * dp


def recon_kernel_bytes(b: int, k: int, dp: int, itemsize: int = 4) -> int:
    """K1's bytes, each counted once: the stream d [K, Dp], the weights
    wn [B, K], init [Dp] and the output [B, Dp]."""
    return itemsize * (k * dp + b * k + dp + b * dp)


def recon_flops(forward: int, eval_rows: int, coalitions: int, k: int, dp: int) -> int:
    """Reconstructed coalitions' useful FLOPs: each one's share of K1 and
    its test evaluation."""
    return coalitions * (recon_kernel_flops(1, k, dp) + forward * eval_rows)
