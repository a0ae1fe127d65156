"""Plain float32 layers and optimizers shared by the reference models.

Parameters are dicts in the published Keras layouts: dense weights
[in, out], convolution kernels HWIO; activations are NHWC. Kernels are
glorot-uniform and biases zero, drawn from the coalition's generator in
layer order (`streams.glorot`). Each `*_flops` counts 2 FLOPs a
multiply-add of one sample's forward pass.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .streams import glorot


def conv_init(g, kh, kw, cin, cout):
    return {"w": glorot(g, (kh, kw, cin, cout), kh * kw * cin, kh * kw * cout),
            "b": torch.zeros(cout)}


def dense_init(g, n_in, n_out):
    return {"w": glorot(g, (n_in, n_out), n_in, n_out), "b": torch.zeros(n_out)}


def conv(p, x, same=False):
    """NHWC x, HWIO kernel, stride 1; "same" pads an odd kernel evenly."""
    pad = (p["w"].shape[0] - 1) // 2 if same else 0
    out = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1), p["b"], padding=pad)
    return out.permute(0, 2, 3, 1)


def pool(x):
    """2x2 max-pool, VALID, of an NHWC tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def dense(p, x):
    return x @ p["w"] + p["b"]


def drop(x, keep_mask, rate):
    """Inverted dropout under a given keep mask; None is evaluation."""
    if keep_mask is None:
        return x
    return torch.where(keep_mask, x / (1.0 - rate), 0.0)


def conv_flops(h_out, w_out, kh, kw, cin, cout) -> int:
    return 2 * h_out * w_out * kh * kw * cin * cout


def dense_flops(n_in, n_out) -> int:
    return 2 * n_in * n_out


@dataclasses.dataclass(frozen=True)
class Adam:
    """p - lr * m_hat / (sqrt(v_hat) + eps), the bias corrections formed in
    float32 (optax's `adam`), Keras's eps."""
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-7

    def init(self, params):
        zeros = lambda: {g: {k: torch.zeros_like(t) for k, t in d.items()}  # noqa: E731
                         for g, d in params.items()}
        return {"m": zeros(), "v": zeros(), "t": 0}

    def step(self, params, grads, state):
        t = state["t"] + 1
        bc1 = float(1.0 - torch.tensor(self.b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** t)
        new, m_all, v_all = {}, {}, {}
        for g, d in params.items():
            new[g], m_all[g], v_all[g] = {}, {}, {}
            for k, p in d.items():
                gr = grads[g][k]
                m = (1 - self.b1) * gr + self.b1 * state["m"][g][k]
                v = (1 - self.b2) * gr * gr + self.b2 * state["v"][g][k]
                new[g][k] = p + (-self.lr) * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
                m_all[g][k], v_all[g][k] = m, v
        return new, {"m": m_all, "v": v_all, "t": t}


@dataclasses.dataclass(frozen=True)
class RMSprop:
    """v = (1 - rho) g^2 + rho v; p - lr g / sqrt(v + eps): eps inside the
    square root and no momentum (optax's `rmsprop`)."""
    lr: float = 1e-4
    rho: float = 0.9
    eps: float = 1e-7

    def init(self, params):
        return {"v": {g: {k: torch.zeros_like(t) for k, t in d.items()}
                      for g, d in params.items()}}

    def step(self, params, grads, state):
        new, v_all = {}, {}
        for g, d in params.items():
            new[g], v_all[g] = {}, {}
            for k, p in d.items():
                gr = grads[g][k]
                v = (1 - self.rho) * (gr * gr) + self.rho * state["v"][g][k]
                new[g][k] = p + (-self.lr) * (torch.rsqrt(v + self.eps) * gr)
                v_all[g][k] = v
        return new, {"v": v_all}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A reference model: `init(generator)`, `forward(params, x, masks)`
    (float32 logits), its optimizer, its dropout layers ((rate, per-sample
    shape) in forward order), one sample's forward FLOPs and `tie_free`:
    the parameter groups after its last max-pool, whose gradients do not
    pass back through a max-pool window (where two inputs tie to rounding,
    the gradient of the layers before it takes either route)."""
    name: str
    init: object
    forward: object
    optimizer: object
    forward_flops: int
    dropout: tuple = ()
    tie_free: tuple = ()
