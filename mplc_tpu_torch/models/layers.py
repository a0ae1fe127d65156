"""Pure-functional layers (port of `mplc_tpu/models/layers.py`).

Parameters are plain dicts of tensors in the JAX package's layouts: dense
weights `[in, out]`, convolution kernels HWIO, activations NHWC, so
parameters converted from the JAX package compute the same function.
`conv2d` and `max_pool_2d` take NHWC and view it as NCHW for
`F.conv2d`/`F.max_pool2d` (a permuted view: an NHWC tensor is channels-last
NCHW memory); `conv1d` and `max_pool_1d` take NWC (WIO kernels) and view
it as NCW likewise. Initializers match Keras defaults (glorot-uniform
kernels, zero biases, uniform(-0.05, 0.05) embeddings) and draw from an
explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _glorot_uniform(generator: torch.Generator, shape: tuple[int, ...],
                    fan_in: int, fan_out: int) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=generator)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int) -> dict:
    return {"w": _glorot_uniform(generator, (in_dim, out_dim), in_dim, out_dim),
            "b": torch.zeros((out_dim,), dtype=torch.float32)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def conv2d_init(generator: torch.Generator, kh: int, kw: int, cin: int,
                cout: int) -> dict:
    return {"w": _glorot_uniform(generator, (kh, kw, cin, cout),
                                 kh * kw * cin, kh * kw * cout),
            "b": torch.zeros((cout,), dtype=torch.float32)}


def conv2d(params: dict, x: torch.Tensor, padding: str = "VALID") -> torch.Tensor:
    """Stride-1 convolution: NHWC input, HWIO kernel, NHWC output. "SAME"
    of an odd kernel (the ported models' only kind) pads (k - 1) / 2 on
    each side of each spatial axis, as `lax.conv_general_dilated` does."""
    kh, kw = params["w"].shape[:2]
    pad = ((kh - 1) // 2, (kw - 1) // 2) if padding == "SAME" else 0
    out = F.conv2d(x.permute(0, 3, 1, 2), params["w"].permute(3, 2, 0, 1),
                   params["b"], padding=pad)
    return out.permute(0, 2, 3, 1)


def conv1d_init(generator: torch.Generator, k: int, cin: int, cout: int) -> dict:
    return {"w": _glorot_uniform(generator, (k, cin, cout), k * cin, k * cout),
            "b": torch.zeros((cout,), dtype=torch.float32)}


def conv1d(params: dict, x: torch.Tensor, padding: str = "SAME") -> torch.Tensor:
    """Stride-1 convolution: NWC input, WIO kernel, NWC output. "SAME" of
    an odd kernel pads (k - 1) / 2 on each side, as
    `lax.conv_general_dilated` does."""
    k = params["w"].shape[0]
    pad = (k - 1) // 2 if padding == "SAME" else 0
    out = F.conv1d(x.permute(0, 2, 1), params["w"].permute(2, 1, 0), params["b"],
                   padding=pad)
    return out.permute(0, 2, 1)


def max_pool_2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """VALID max-pool over the spatial axes of an NHWC tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)


def max_pool_1d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """VALID max-pool over the length of an NWC tensor (an odd length
    drops its last position)."""
    return F.max_pool1d(x.permute(0, 2, 1), window).permute(0, 2, 1)


def global_avg_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """The mean over the spatial axes of an NHWC tensor: [N, C]. A plain
    mean, not `nn.AdaptiveAvgPool2d`, whose CUDA backward has no
    deterministic implementation (it raises under the card's mode)."""
    return x.mean(dim=(1, 2))


def embedding_init(generator: torch.Generator, vocab: int, dim: int) -> dict:
    return {"table": torch.empty((vocab, dim), dtype=torch.float32).uniform_(
        -0.05, 0.05, generator=generator)}


def embedding(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows of integer `tokens` (never cast to a float type:
    bf16 holds integers exactly only up to 256)."""
    return F.embedding(tokens.long(), params["table"])


def dropout(x: torch.Tensor, keep_mask: torch.Tensor | None, rate: float) -> torch.Tensor:
    """Inverted dropout under a given keep mask (bool, x's shape), as the
    JAX package's `jnp.where(mask, x / keep, 0)`; no mask (evaluation) is
    the identity. The mask is an argument, never drawn here, so a vmapped
    forward takes one mask a model."""
    if keep_mask is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(keep_mask, x / keep, 0.0)
