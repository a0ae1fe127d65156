"""Model families, layers and the optimizers.

The JAX package's optax helpers `adam_like_keras` and `rmsprop_like_keras`
have no counterpart: the port's optimizers are its own (`models/core.py`
`Adam`, `RMSprop`)."""

from .core import Model
from .zoo import CIFAR10_CNN, ESC50_CNN, IMDB_CONV1D, MNIST_CNN, MODELS, TITANIC_LOGREG

__all__ = [
    "Model", "MODELS", "MNIST_CNN", "CIFAR10_CNN", "IMDB_CONV1D", "ESC50_CNN",
    "TITANIC_LOGREG",
]
