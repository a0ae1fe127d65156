"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one (the CPU tests pass `device="cpu"`).

    Asking for CUDA where there is none raises: the port never drops
    quietly to the CPU. On CUDA, float32 means float32 and one seed gives
    one result, process-wide: TF32 is switched off for cuDNN convolutions
    and cuBLAS matrix products, cuDNN runs deterministic algorithms with
    benchmarking off, `torch.use_deterministic_algorithms(True)` makes an
    op without a deterministic CUDA implementation raise, and cuBLAS gets
    the fixed workspace (`CUBLAS_WORKSPACE_CONFIG=:4096:8`) its
    deterministic mode needs, which must be set before the process's first
    cuBLAS call.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True)
        # every op of the port writes the whole of what it allocates, so
        # filling new tensors with NaN (what deterministic mode does by
        # default) buys nothing and costs a write of each, the kernels'
        # outputs included
        torch.utils.deterministic.fill_uninitialized_memory = False
    return dev
