"""Frozen copies of the port's random protocol, so that the reference
trains each coalition from the same draws as the program: the same initial
weights, the same row orders and the same dropout masks. What is left to
differ is the rounding of the arithmetic.

- `coalition_generator`: a coalition's own CPU `torch.Generator`, seeded
  from `SeedSequence([seed, *words])`, the words being its membership
  bitmask's 32-bit words (the port's `CharacteristicEngine.coalition_generator`).
- Draw order, per run: the model's initial weights (glorot-uniform kernels
  in layer order, zero biases), then each epoch the permutations of every
  partner's rows, then, for a model with dropout, one 64-bit epoch key.
- `epoch_perms`: uniform keys, +1e9 on padding rows, stable argsort.
- `step_masks`: the port's counter-based dropout hash (`mpl/dropout.py`):
  two multiply-xorshift rounds with the odd constant 0x45d9f3b, each
  coordinate mixed in as fmix(h ^ fmix(v + 0x9e3779b9)); a bit keeps its
  element when the top 24 bits of its hash fall below round(keep * 2^24).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B
_GOLDEN = 0x9E3779B9


def coalition_generator(seed: int, subset) -> torch.Generator:
    bits = 0
    for i in subset:
        bits |= 1 << int(i)
    words = []
    while True:
        words.append(bits & _M32)
        bits >>= 32
        if not bits:
            break
    ss = np.random.SeedSequence([int(seed), *words])
    return torch.Generator().manual_seed(int(ss.generate_state(1, np.uint64)[0]))


def glorot(generator: torch.Generator, shape: tuple, fan_in: int, fan_out: int):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(-limit, limit,
                                                             generator=generator)


def epoch_perms(generator: torch.Generator, mask: torch.Tensor) -> torch.Tensor:
    """Row orders of a (CPU) validity mask's last axis: valid rows first."""
    keys = torch.rand(mask.shape, generator=generator) + (1.0 - mask) * 1e9
    return torch.argsort(keys, dim=-1, stable=True)


def draw_key(generator: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64)


def _fmix(x):
    x = x ^ (x >> 16)
    x = (x * _MUL) & _M32
    x = x ^ (x >> 16)
    x = (x * _MUL) & _M32
    return x ^ (x >> 16)


def _mix(h, v):
    return _fmix(h ^ _fmix((v + _GOLDEN) & _M32))


def step_masks(key: torch.Tensor, rows: int, layers: tuple, *coords) -> tuple:
    """The keep masks of one step of one run: key [2] int64, integer
    coordinates; one bool tensor [rows, *shape] per (rate, shape) layer."""
    h = _mix(_fmix(key[0]), key[1])
    for c in coords:
        h = _mix(h, int(c))
    out = []
    for layer, (rate, shape) in enumerate(layers):
        s = _mix(h, layer)
        counters = torch.arange(rows * math.prod(shape), dtype=torch.int64,
                                device=key.device)
        counters = _fmix((counters + _GOLDEN) & _M32).reshape((rows,) + tuple(shape))
        out.append((_fmix(s ^ counters) >> 8) < round((1.0 - rate) * (1 << 24)))
    return tuple(out)
