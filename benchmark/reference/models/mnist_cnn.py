"""MPLC's MNIST CNN (`mplc/dataset.py`, the `mnist` model): conv 3x3x32,
conv 3x3x64, max-pool 2, dense 128, dense 10, ReLU between; 1,199,882
parameters; Adam(1e-3). Published widths, no dropout."""

import torch

from ..layers import (Adam, ModelSpec, conv, conv_flops, conv_init, dense, dense_flops,
                      dense_init, pool)


def init(g):
    return {"c1": conv_init(g, 3, 3, 1, 32), "c2": conv_init(g, 3, 3, 32, 64),
            "d1": dense_init(g, 12 * 12 * 64, 128), "d2": dense_init(g, 128, 10)}


def forward(p, x, masks=None):
    h = torch.relu(conv(p["c1"], x))
    h = pool(torch.relu(conv(p["c2"], h)))
    # (h, w, c)-ordered flatten, as Keras flattens NHWC
    h = torch.relu(dense(p["d1"], h.reshape(h.shape[0], -1)))
    return dense(p["d2"], h)


# 28x28x1 -> conv 26x26x32 -> conv 24x24x64 -> pool 12x12x64 -> 128 -> 10
FORWARD_FLOPS = (conv_flops(26, 26, 3, 3, 1, 32) + conv_flops(24, 24, 3, 3, 32, 64)
                 + dense_flops(12 * 12 * 64, 128) + dense_flops(128, 10))

SPEC = ModelSpec("mnist_cnn", init, forward, Adam(), FORWARD_FLOPS,
                 tie_free=("d1", "d2"))
