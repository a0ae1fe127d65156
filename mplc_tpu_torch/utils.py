"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one (the CPU tests pass `device="cpu"`).

    Asking for CUDA where there is none raises: the port never drops
    quietly to the CPU. On CUDA, float32 means float32: TF32 is switched
    off for cuDNN convolutions and cuBLAS matrix products
    (`torch.backends.cudnn.allow_tf32` and
    `torch.backends.cuda.matmul.allow_tf32` are set to False, process-wide).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
