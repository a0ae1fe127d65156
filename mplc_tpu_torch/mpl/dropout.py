"""Dropout keep masks, drawn on the run's device from a counter-based hash.

The JAX package keys each training step's dropout by folding the step's
coordinates into its threefry key (`mplc_tpu/mpl/engine.py`: fedavg by
minibatch, global partner id and step; the seq family by minibatch, visit
position and step; the single trainer by step; lflip's pass folds in 7).
The port cannot draw threefry streams, so it follows the same coordinates
with its own function: every keep bit is a pure function of

    (the run's epoch key, the step's coordinates, the layer,
     the row within the step window, the element's (h, w, c) index)

computed in plain int64 tensor arithmetic on whatever device the run is
on. The arithmetic never overflows (every value stays below 2^32 and every
product below 2^59), so the CPU and a CUDA card give the same bits for the
same key. A bit depends on its row and element coordinates, never on a
flat index over a padded batch, so a slot window and a masked window of
the same partner and step draw the same masks. Nothing is drawn on the
host past the key: each run draws one 64-bit key an epoch from its CPU
generator (`MplTrainer._draws`).

The hash is a 32-bit integer finalizer (two multiply-xorshift rounds with
the odd constant 0x45d9f3b); a coordinate v is mixed in as
`fmix(h ^ fmix(v + 0x9e3779b9))`. A bit keeps its element when the top 24
bits of `fmix(layer seed ^ fmix(counter + 0x9e3779b9))` fall below
round(keep * 2^24). The threshold is exact for the keep rates 0.75 and 0.5
(the CIFAR10 CNN's, IMDB's). For ESC50's 0.8, keep * 2^24 = 13421772.8
rounds up to 13421773: a bit keeps with probability 0.8 + 1.2e-8.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B      # < 2^27: a product of two 32-bit values stays < 2^59
_GOLDEN = 0x9E3779B9


def _fmix(x):
    x = x ^ (x >> 16)
    x = (x * _MUL) & _M32
    x = x ^ (x >> 16)
    x = (x * _MUL) & _M32
    return x ^ (x >> 16)


def _mix(h, v):
    return _fmix(h ^ _fmix((v + _GOLDEN) & _M32))


def draw_key(generator: torch.Generator) -> torch.Tensor:
    """One run's epoch key: two 32-bit words [2] (int64) from `generator`."""
    return torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64)


def stream_seeds(keys: torch.Tensor, *coords) -> torch.Tensor:
    """The 32-bit stream seeds of steps: the runs' keys [B, 2] with each
    coordinate mixed in, in order. A coordinate is an int or an int64
    tensor broadcasting against [B, ...]; the result has the broadcast
    shape (leading B)."""
    h = _mix(_fmix(keys[:, 0]), keys[:, 1])
    for c in coords:
        if isinstance(c, int):
            # mixed as a Python int: the same low 32 bits as an int64
            # tensor's, and nothing to copy to the device
            h = _mix(h, c)
            continue
        c = torch.as_tensor(c, dtype=torch.int64, device=keys.device)
        if h.ndim < c.ndim:
            h = h.reshape(h.shape + (1,) * (c.ndim - h.ndim))
        h = _mix(h, c)
    return h


def step_masks(keys: torch.Tensor, rows: int, layers: tuple, *coords) -> tuple:
    """The keep masks of the steps at `coords` (`stream_seeds`) of windows
    of `rows` rows: one bool tensor [*seeds' shape, rows, *shape] for each
    (rate, per-sample shape) of `layers` (a model's `dropout` table)."""
    seeds = stream_seeds(keys, *coords)
    out = []
    for layer, (rate, shape) in enumerate(layers):
        s = _mix(seeds, layer)
        s = s.reshape(s.shape + (1,) * (1 + len(shape)))
        counters = torch.arange(rows * math.prod(shape), dtype=torch.int64, device=keys.device)
        counters = _fmix((counters + _GOLDEN) & _M32).reshape((rows,) + tuple(shape))
        out.append((_fmix(s ^ counters) >> 8) < round((1.0 - rate) * (1 << 24)))
    return tuple(out)
