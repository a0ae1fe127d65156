"""The Model contract and the optimizers (port of `mplc_tpu/models/core.py`).

A model is a frozen bundle of pure functions over a parameter dict:
`init(generator)` builds the parameters on the CPU, `apply(params, x,
compute_dtype=torch.float32, dropout=None)` maps a batch to float32
logits, computing in `compute_dtype`. Because parameters are plain dicts of
tensors, a stack of per-partner or per-coalition replicas is the same dict
with a leading axis, driven by `torch.func.vmap`.

An optimizer is a frozen dataclass with `init(params) -> state` and
`step(params, grads, state) -> (params, state)`; its state is a dict of
parameter-shaped trees plus the step `count` (an int), so a trainer can
freeze or reset every tree entry alike.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol

import torch


def _zeros(tree: dict) -> dict:
    return {g: {k: torch.zeros_like(t) for k, t in d.items()} for g, d in tree.items()}


class Optimizer(Protocol):
    def init(self, params: dict) -> dict: ...

    def step(self, params: dict, grads: dict, state: dict) -> tuple[dict, dict]: ...


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
        return {"mu": _zeros(params), "nu": _zeros(params), "count": 0}

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
class RMSprop:
    """RMSprop as optax 0.2.6's `rmsprop(lr, decay, eps)` computes it (eps
    inside the square root, no bias correction, no momentum):
    `nu = (1 - decay) g^2 + decay nu`, `p - lr * g * rsqrt(nu + eps)`.
    Not `torch.optim.RMSprop`, which adds eps outside the square root.
    `count` counts steps and changes nothing."""

    learning_rate: float = 1e-4
    decay: float = 0.9
    eps: float = 1e-7

    def init(self, params: dict) -> dict:
        return {"nu": _zeros(params), "count": 0}

    def step(self, params: dict, grads: dict, state: dict) -> tuple[dict, dict]:
        new_p, nu = {}, {}
        for g, d in params.items():
            new_p[g], nu[g] = {}, {}
            for k, p in d.items():
                grad = grads[g][k]
                v = (1 - self.decay) * (grad * grad) + self.decay * state["nu"][g][k]
                upd = torch.rsqrt(v + self.eps) * grad
                new_p[g][k] = p + (-self.learning_rate) * upd
                nu[g][k] = v
        return new_p, {"nu": nu, "count": state["count"] + 1}


@dataclasses.dataclass(frozen=True)
class Model:
    """A pure-functional model family.

    Attributes:
        name: model family tag.
        init: torch.Generator -> params dict (float32, on the CPU).
        apply: (params, x, compute_dtype, dropout) -> logits (float32);
            `dropout` is None (evaluation) or one keep mask a dropout layer.
        loss_kind: "categorical" (softmax CE over one-hot labels) or
            "binary" (sigmoid CE over a single logit).
        num_outputs: logits dimensionality (1 for binary).
        optimizer: the optimizer every partner pass starts afresh.
        grad_call_width: the models every gradient call of the coalition
            engine's trainers holds (`MplTrainer._model_grads`): a step's
            models are split into calls of exactly this many, the last
            padded. On the card cuDNN picks a convolution's algorithms by
            a call's shape, so one call width keeps a coalition's bits
            whatever the width of the batch that trains it. Chosen by
            cost (`obs/width_parity.py`).
        dropout: (rate, per-sample shape) of each dropout layer, in the
            order `apply` takes their masks; () for a model without.
        eval_row_bytes: float32 bytes of the largest activation one row
            holds in the forward pass; evaluation bounds its rows in
            flight by it (`constants.eval_rows_in_flight`). 0: unknown,
            the row bound alone.
    """

    name: str
    init: Callable[[torch.Generator], dict]
    apply: Callable[..., torch.Tensor]
    loss_kind: str
    num_outputs: int
    optimizer: Optimizer
    grad_call_width: int
    dropout: tuple = ()
    eval_row_bytes: int = 0

    def label_dim(self) -> int:
        """Width of the label array fed to the loss (one-hot width, or 1)."""
        return 1 if self.loss_kind == "binary" else self.num_outputs
