"""The model families (port of `mplc_tpu/models/zoo.py`): the MNIST CNN,
the CIFAR10 CNN, the IMDB embedding + Conv1D model and the ESC50 CNN at
their published widths, and the Titanic logistic regression.

Every `apply` takes `compute_dtype`: the parameters and the input are cast
to it inside `apply` and the logits come back float32, so the carried
parameters never leave float32 and their gradient through the cast is
float32. Under float32 the casts are no-ops and the function is unchanged.
The IMDB model's input is integer token ids, which `apply` never casts:
they index the embedding table, and bf16 would round the ids above 256.
Every `apply` also takes `dropout`: None in evaluation, else one keep mask
a layer of the model's `dropout` table (the CIFAR10 CNN's three, IMDB's
two, ESC50's four; the others have none and ignore it).
"""

from __future__ import annotations

import torch

from . import layers as L
from .core import Adam, Model, RMSprop


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


def _mnist_apply(params, x, compute_dtype=torch.float32, dropout=None):
    p = _cast(params, compute_dtype)
    h = torch.relu(L.conv2d(p["c1"], x.to(compute_dtype)))
    h = torch.relu(L.conv2d(p["c2"], h))
    h = L.max_pool_2d(h)
    # NHWC flatten, as the JAX model: d1's input rows are (h, w, c)-ordered
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(L.dense(p["d1"], h))
    return L.dense(p["d2"], h).float()


# ---------------------------------------------------------------------------
# CIFAR10 CNN: [conv32 same, conv32, pool, drop.25] x2 (64), dense512, drop.5
# ---------------------------------------------------------------------------

# (rate, per-sample NHWC shape) of each dropout layer, in the order of
# `_cifar_apply`'s masks
CIFAR10_DROPOUT = ((0.25, (15, 15, 32)), (0.25, (6, 6, 64)), (0.5, (512,)))


def _cifar_init(generator: torch.Generator) -> dict:
    return {
        "c1": L.conv2d_init(generator, 3, 3, 3, 32),
        "c2": L.conv2d_init(generator, 3, 3, 32, 32),
        "c3": L.conv2d_init(generator, 3, 3, 32, 64),
        "c4": L.conv2d_init(generator, 3, 3, 64, 64),
        "d1": L.dense_init(generator, 6 * 6 * 64, 512),
        "d2": L.dense_init(generator, 512, 10),
    }


def _cifar_apply(params, x, compute_dtype=torch.float32, dropout=None):
    p = _cast(params, compute_dtype)
    m1, m2, m3 = dropout if dropout is not None else (None, None, None)
    (r1, _), (r2, _), (r3, _) = CIFAR10_DROPOUT
    h = torch.relu(L.conv2d(p["c1"], x.to(compute_dtype), padding="SAME"))
    h = torch.relu(L.conv2d(p["c2"], h))
    h = L.dropout(L.max_pool_2d(h), m1, r1)
    h = torch.relu(L.conv2d(p["c3"], h, padding="SAME"))
    h = torch.relu(L.conv2d(p["c4"], h))
    h = L.dropout(L.max_pool_2d(h), m2, r2)
    h = h.reshape(h.shape[0], -1)
    h = L.dropout(torch.relu(L.dense(p["d1"], h)), m3, r3)
    return L.dense(p["d2"], h).float()


# ---------------------------------------------------------------------------
# IMDB: embed(5000,32) -> conv1d(32,k3,same) -> maxpool -> dense256 -> dense64 -> 1
# ---------------------------------------------------------------------------

IMDB_NUM_WORDS = 5000
IMDB_SEQ_LEN = 500
IMDB_DROPOUT = ((0.5, (256,)), (0.5, (64,)))


def _imdb_init(generator: torch.Generator) -> dict:
    return {
        "emb": L.embedding_init(generator, IMDB_NUM_WORDS, 32),
        "c1": L.conv1d_init(generator, 3, 32, 32),
        "d1": L.dense_init(generator, (IMDB_SEQ_LEN // 2) * 32, 256),
        "d2": L.dense_init(generator, 256, 64),
        "d3": L.dense_init(generator, 64, 1),
    }


def _imdb_apply(params, x, compute_dtype=torch.float32, dropout=None):
    p = _cast(params, compute_dtype)
    m1, m2 = dropout if dropout is not None else (None, None)
    (r1, _), (r2, _) = IMDB_DROPOUT
    h = L.embedding(p["emb"], x)
    h = torch.relu(L.conv1d(p["c1"], h, padding="SAME"))
    h = L.max_pool_1d(h)
    h = h.reshape(h.shape[0], -1)
    h = L.dropout(torch.relu(L.dense(p["d1"], h)), m1, r1)
    h = L.dropout(torch.relu(L.dense(p["d2"], h)), m2, r2)
    return L.dense(p["d3"], h).float()


# ---------------------------------------------------------------------------
# ESC50: 4x [conv k2, pool2, drop .2] (16/32/64/128) -> GAP -> dense50
# ---------------------------------------------------------------------------

ESC50_DROPOUT = ((0.2, (19, 215, 16)), (0.2, (9, 107, 32)), (0.2, (4, 53, 64)),
                 (0.2, (1, 26, 128)))


def _esc50_init(generator: torch.Generator) -> dict:
    return {
        "c1": L.conv2d_init(generator, 2, 2, 1, 16),
        "c2": L.conv2d_init(generator, 2, 2, 16, 32),
        "c3": L.conv2d_init(generator, 2, 2, 32, 64),
        "c4": L.conv2d_init(generator, 2, 2, 64, 128),
        "d1": L.dense_init(generator, 128, 50),
    }


def _esc50_apply(params, x, compute_dtype=torch.float32, dropout=None):
    p = _cast(params, compute_dtype)
    masks = dropout if dropout is not None else (None,) * len(ESC50_DROPOUT)
    h = x.to(compute_dtype)
    for name, m, (rate, _) in zip(("c1", "c2", "c3", "c4"), masks, ESC50_DROPOUT):
        h = L.dropout(L.max_pool_2d(torch.relu(L.conv2d(p[name], h))), m, rate)
    return L.dense(p["d1"], L.global_avg_pool_2d(h)).float()


# ---------------------------------------------------------------------------
# Titanic: logistic regression over 27 features
# ---------------------------------------------------------------------------

TITANIC_NUM_FEATURES = 27


def _titanic_init(generator: torch.Generator) -> dict:
    return {"d1": L.dense_init(generator, TITANIC_NUM_FEATURES, 1)}


def _titanic_apply(params, x, compute_dtype=torch.float32, dropout=None):
    p = _cast(params, compute_dtype)
    return L.dense(p["d1"], x.to(compute_dtype)).float()


# eval_row_bytes: each model's largest float32 activation a row (the
# MNIST CNN's second conv, the CIFAR10 CNN's first, IMDB's embedded
# sequence, ESC50's first conv, Titanic's input).
# grad_call_width: the models every gradient call of the coalition
# engine holds (`Model`). Any width keeps the bits; each model's is the
# one whose worst step (1-160 models) is least slowed against the step's
# own one call, by the calls' times on an NVIDIA H100 80GB HBM3 at 700 W
# (`python3 -m mplc_tpu_torch.obs.width_parity --cost-only`): Titanic's
# calls cost the same at any width, so it takes the widest.
MNIST_CNN = Model("mnist_cnn", _mnist_init, _mnist_apply, "categorical", 10,
                  Adam(1e-3), eval_row_bytes=24 * 24 * 64 * 4, grad_call_width=20)
# the reference compiles RMSprop(lr=1e-4, decay=1e-6), whose Keras decay is
# a learning-rate schedule; the JAX package drops it, as does the port
CIFAR10_CNN = Model("cifar10_cnn", _cifar_init, _cifar_apply, "categorical", 10,
                    RMSprop(1e-4, decay=0.9, eps=1e-7), dropout=CIFAR10_DROPOUT,
                    eval_row_bytes=32 * 32 * 32 * 4, grad_call_width=20)
IMDB_CONV1D = Model("imdb_conv1d", _imdb_init, _imdb_apply, "binary", 1, Adam(1e-3),
                    dropout=IMDB_DROPOUT, eval_row_bytes=IMDB_SEQ_LEN * 32 * 4,
                    grad_call_width=12)
ESC50_CNN = Model("esc50_cnn", _esc50_init, _esc50_apply, "categorical", 50, Adam(1e-3),
                  dropout=ESC50_DROPOUT, eval_row_bytes=39 * 430 * 16 * 4,
                  grad_call_width=8)
TITANIC_LOGREG = Model("titanic_logreg", _titanic_init, _titanic_apply,
                       "binary", 1, Adam(5e-2), eval_row_bytes=TITANIC_NUM_FEATURES * 4,
                       grad_call_width=160)

MODELS = {"mnist_cnn": MNIST_CNN, "cifar10_cnn": CIFAR10_CNN,
          "imdb_conv1d": IMDB_CONV1D, "esc50_cnn": ESC50_CNN,
          "titanic_logreg": TITANIC_LOGREG}


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
    if model_name == "cifar10_cnn":
        # 32x32x3: conv same 32x32x32, conv 30x30x32, pool 15x15;
        # conv same 15x15x64, conv 13x13x64, pool 6x6
        return (_conv2d_flops(32, 32, 3, 3, 3, 32)
                + _conv2d_flops(30, 30, 3, 3, 32, 32)
                + _conv2d_flops(15, 15, 3, 3, 32, 64)
                + _conv2d_flops(13, 13, 3, 3, 64, 64)
                + _dense_flops(6 * 6 * 64, 512)
                + _dense_flops(512, 10))
    if model_name == "imdb_conv1d":
        # embed gather (no MACs) -> conv1d k3 same over [500, 32] -> pool 250
        return (2 * IMDB_SEQ_LEN * 3 * 32 * 32
                + _dense_flops((IMDB_SEQ_LEN // 2) * 32, 256)
                + _dense_flops(256, 64)
                + _dense_flops(64, 1))
    if model_name == "esc50_cnn":
        # 40x431x1: conv k2 valid + pool2, four stages
        return (_conv2d_flops(39, 430, 2, 2, 1, 16)
                + _conv2d_flops(18, 214, 2, 2, 16, 32)
                + _conv2d_flops(8, 106, 2, 2, 32, 64)
                + _conv2d_flops(3, 52, 2, 2, 64, 128)
                + _dense_flops(128, 50))
    if model_name == "titanic_logreg":
        return _dense_flops(TITANIC_NUM_FEATURES, 1)
    return None
