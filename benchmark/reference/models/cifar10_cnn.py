"""MPLC's CIFAR10 CNN (`mplc/dataset.py`, the `cifar10` model): conv
3x3x32 same, conv 3x3x32, max-pool 2, dropout .25, conv 3x3x64 same, conv
3x3x64, max-pool 2, dropout .25, dense 512, dropout .5, dense 10, ReLU
between; 1,250,858 parameters. RMSprop(1e-4, rho 0.9, eps 1e-7 inside the
square root); MPLC's Keras learning-rate decay of 1e-6 is left out, as the
port leaves it out. Published widths."""

import torch

from ..layers import (ModelSpec, RMSprop, conv, conv_flops, conv_init, dense, dense_flops,
                      dense_init, drop, pool)

# (rate, per-sample NHWC shape) of the dropout layers, in forward order
DROPOUT = ((0.25, (15, 15, 32)), (0.25, (6, 6, 64)), (0.5, (512,)))


def init(g):
    return {"c1": conv_init(g, 3, 3, 3, 32), "c2": conv_init(g, 3, 3, 32, 32),
            "c3": conv_init(g, 3, 3, 32, 64), "c4": conv_init(g, 3, 3, 64, 64),
            "d1": dense_init(g, 6 * 6 * 64, 512), "d2": dense_init(g, 512, 10)}


def forward(p, x, masks=None):
    m1, m2, m3 = masks if masks is not None else (None, None, None)
    (r1, _), (r2, _), (r3, _) = DROPOUT
    h = torch.relu(conv(p["c1"], x, same=True))
    h = drop(pool(torch.relu(conv(p["c2"], h))), m1, r1)
    h = torch.relu(conv(p["c3"], h, same=True))
    h = drop(pool(torch.relu(conv(p["c4"], h))), m2, r2)
    h = drop(torch.relu(dense(p["d1"], h.reshape(h.shape[0], -1))), m3, r3)
    return dense(p["d2"], h)


# 32x32x3 -> conv same 32x32x32 -> conv 30x30x32 -> pool 15x15 -> conv same
# 15x15x64 -> conv 13x13x64 -> pool 6x6x64 -> 512 -> 10
FORWARD_FLOPS = (conv_flops(32, 32, 3, 3, 3, 32) + conv_flops(30, 30, 3, 3, 32, 32)
                 + conv_flops(15, 15, 3, 3, 32, 64) + conv_flops(13, 13, 3, 3, 64, 64)
                 + dense_flops(6 * 6 * 64, 512) + dense_flops(512, 10))

SPEC = ModelSpec("cifar10_cnn", init, forward, RMSprop(), FORWARD_FLOPS, DROPOUT,
                 tie_free=("d1", "d2"))
