"""Carry parameters, label-flip thetas and recorded runs across from the
JAX package.

Both packages keep the same layouts (dense `[in, out]`, conv HWIO), so a
JAX parameter tree converts leaf by leaf. The JAX side is passed as numpy
arrays (`np.asarray` of each leaf); this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .contrib.reconstruct import RecordedRun


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """{layer: {name: array}} -> the same dict of float32 tensors."""
    return {g: {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
                for k, v in d.items()} for g, d in tree.items()}


def params_to_numpy(params: dict) -> dict:
    """The inverse of `params_from_numpy`: host numpy arrays."""
    return {g: {k: t.detach().cpu().numpy() for k, t in d.items()}
            for g, d in params.items()}


def theta_from_numpy(theta, device="cpu") -> torch.Tensor:
    """A JAX package's label-flip theta ([P, K, K], or [B, P, K, K] for a
    batch of runs) as a float32 tensor, for `MplTrainer.init_state`'s
    `init_theta`."""
    return torch.tensor(np.asarray(theta), dtype=torch.float32, device=device)


def recorded_run_from_numpy(init_params: dict, deltas: dict, weights,
                            device="cpu") -> RecordedRun:
    """A `RecordedRun` from a JAX package's recording (init params, the
    [R, P, ...] delta leaves and the [R, P] weights, as numpy)."""
    init_t = params_from_numpy(init_params, device)
    deltas_t = params_from_numpy(deltas, device)
    w = torch.tensor(np.asarray(weights), dtype=torch.float32, device=device)
    R, P = w.shape
    mem = sum(t.numel() * 4 for d in deltas_t.values() for t in d.values()) + w.numel() * 4
    return RecordedRun(init_params=init_t, deltas=deltas_t, weights=w,
                       rounds=R, partners_count=P,
                       epochs_done=None, training_passes=None, memory_bytes=mem)
