"""mplc_tpu_torch: the PyTorch/CUDA port of mplc_tpu.

A package beside the JAX package `mplc_tpu`, with the same layout and
names. It imports neither JAX nor `mplc_tpu`. Entry points run on CUDA
unless the caller passes `device="cpu"`; on the card the hot loop of the
retrain-free estimators is the hand-written kernel in `csrc/`.
"""

from . import constants  # noqa: F401
from . import obs  # noqa: F401  (no torch import at module load)

__version__ = "0.1.0"
