"""The model families of this slice (port of `mplc_tpu/models/zoo.py`):
the MNIST CNN at its published width and the Titanic logistic regression.
CIFAR10, IMDB and ESC50 come with a later slice (ROADMAP.md).

Every `apply` takes `compute_dtype`: the parameters and the input are cast
to it inside `apply` and the logits come back float32, so the carried
parameters never leave float32 and their gradient through the cast is
float32. Under float32 the casts are no-ops and the function is unchanged.
"""

from __future__ import annotations

import torch

from . import layers as L
from .core import Adam, Model


# ---------------------------------------------------------------------------
# MNIST CNN: conv3x3x32 -> conv3x3x64 -> maxpool2 -> dense128 -> dense10
# ---------------------------------------------------------------------------

def _mnist_init(generator: torch.Generator) -> dict:
    return {
        "c1": L.conv2d_init(generator, 3, 3, 1, 32),
        "c2": L.conv2d_init(generator, 3, 3, 32, 64),
        "d1": L.dense_init(generator, 12 * 12 * 64, 128),
        "d2": L.dense_init(generator, 128, 10),
    }


def _cast(params: dict, dtype: torch.dtype) -> dict:
    return {g: {k: t.to(dtype) for k, t in d.items()} for g, d in params.items()}


def _mnist_apply(params, x, compute_dtype=torch.float32):
    p = _cast(params, compute_dtype)
    h = torch.relu(L.conv2d(p["c1"], x.to(compute_dtype)))
    h = torch.relu(L.conv2d(p["c2"], h))
    h = L.max_pool_2d(h)
    # NHWC flatten, as the JAX model: d1's input rows are (h, w, c)-ordered
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(L.dense(p["d1"], h))
    return L.dense(p["d2"], h).float()


# ---------------------------------------------------------------------------
# Titanic: logistic regression over 27 features
# ---------------------------------------------------------------------------

TITANIC_NUM_FEATURES = 27


def _titanic_init(generator: torch.Generator) -> dict:
    return {"d1": L.dense_init(generator, TITANIC_NUM_FEATURES, 1)}


def _titanic_apply(params, x, compute_dtype=torch.float32):
    p = _cast(params, compute_dtype)
    return L.dense(p["d1"], x.to(compute_dtype)).float()


MNIST_CNN = Model("mnist_cnn", _mnist_init, _mnist_apply, "categorical", 10,
                  Adam(1e-3))
TITANIC_LOGREG = Model("titanic_logreg", _titanic_init, _titanic_apply,
                       "binary", 1, Adam(5e-2))

MODELS = {"mnist_cnn": MNIST_CNN, "titanic_logreg": TITANIC_LOGREG}


def _conv2d_flops(h_out: int, w_out: int, kh: int, kw: int,
                  cin: int, cout: int) -> int:
    """2 FLOPs (multiply + add) per MAC of a 2-D convolution."""
    return 2 * h_out * w_out * kh * kw * cin * cout


def _dense_flops(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def fwd_flops_per_sample(model_name: str) -> int | None:
    """Analytic forward-pass FLOPs for one sample of a ported family
    (matmul/conv MACs x 2); None for any other name."""
    if model_name == "mnist_cnn":
        # 28x28x1: conv3x3->26x26x32, conv3x3->24x24x64, pool -> 12x12x64
        return (_conv2d_flops(26, 26, 3, 3, 1, 32)
                + _conv2d_flops(24, 24, 3, 3, 32, 64)
                + _dense_flops(12 * 12 * 64, 128)
                + _dense_flops(128, 10))
    if model_name == "titanic_logreg":
        return _dense_flops(TITANIC_NUM_FEATURES, 1)
    return None
