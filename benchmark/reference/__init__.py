"""The plain reference of the benchmark's cells: the coalition game worked
out again in plain PyTorch and NumPy, float32, from the inputs the harness
makes. It imports nothing of the program, of JAX or of the JAX package.

- `datasets/<kind>.py`: a configuration's raw arrays from the run's seed;
- `split.py`: the train/val/test and partner splits;
- `streams.py`: the random protocol (initial weights, row orders, dropout);
- `models/<model>.py`: each model's layers, optimizer and forward FLOPs;
- `train.py`: a coalition's training, its accuracy, the recorded run and
  the reconstruction.
"""

import importlib


def model(name: str):
    """The `ModelSpec` of `models/<name>.py`."""
    return importlib.import_module(f"{__name__}.models.{name}").SPEC


def dataset(kind: str):
    """The `make(seed, **params)` of `datasets/<kind>.py`."""
    return importlib.import_module(f"{__name__}.datasets.{kind}").make
