"""The Model contract and the optimizer (port of `mplc_tpu/models/core.py`).

A model is a frozen bundle of pure functions over a parameter dict:
`init(generator)` builds the parameters on the CPU, `apply(params, x,
compute_dtype=torch.float32)` maps a batch to float32 logits, computing in
`compute_dtype`. Because parameters are plain dicts of
tensors, a stack of per-partner or per-coalition replicas is the same dict
with a leading axis, driven by `torch.func.vmap`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam as a plain function on tensors, following optax's `adam`:
    `p - lr * m_hat / (sqrt(v_hat) + eps)`, with the bias corrections
    computed in float32 as optax does. Keras's eps of 1e-7 (optax's default
    is 1e-8). The update is elementwise, so it applies unchanged to
    parameters stacked over partners."""

    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-7

    def init(self, params: dict) -> dict:
        zeros = lambda tree: {g: {k: torch.zeros_like(t) for k, t in d.items()}  # noqa: E731
                              for g, d in tree.items()}
        return {"mu": zeros(params), "nu": zeros(params), "count": 0}

    def step(self, params: dict, grads: dict, state: dict) -> tuple[dict, dict]:
        count = state["count"] + 1
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        # float32 values held as Python floats: no device transfer per step
        bc1 = float(1.0 - f32(self.b1) ** count)
        bc2 = float(1.0 - f32(self.b2) ** count)
        new_p, mu, nu = {}, {}, {}
        for g, d in params.items():
            new_p[g], mu[g], nu[g] = {}, {}, {}
            for k, p in d.items():
                grad = grads[g][k]
                m = (1 - self.b1) * grad + self.b1 * state["mu"][g][k]
                v = (1 - self.b2) * grad * grad + self.b2 * state["nu"][g][k]
                upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                new_p[g][k] = p + (-self.learning_rate) * upd
                mu[g][k], nu[g][k] = m, v
        return new_p, {"mu": mu, "nu": nu, "count": count}


@dataclasses.dataclass(frozen=True)
class Model:
    """A pure-functional model family.

    Attributes:
        name: model family tag.
        init: torch.Generator -> params dict (float32, on the CPU).
        apply: (params, x, compute_dtype) -> logits (float32).
        loss_kind: "categorical" (softmax CE over one-hot labels) or
            "binary" (sigmoid CE over a single logit).
        num_outputs: logits dimensionality (1 for binary).
        optimizer: the Adam settings every partner pass starts afresh.
    """

    name: str
    init: Callable[[torch.Generator], dict]
    apply: Callable[..., torch.Tensor]
    loss_kind: str
    num_outputs: int
    optimizer: Adam

    def label_dim(self) -> int:
        """Width of the label array fed to the loss (one-hot width, or 1)."""
        return 1 if self.loss_kind == "binary" else self.num_outputs
