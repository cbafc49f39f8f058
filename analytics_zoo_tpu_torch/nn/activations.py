"""Keras-named activation registry (the JAX package's ``nn/activations.py``
with the same names and the same variants: ``gelu`` is the tanh
approximation, as ``jax.nn.gelu`` defaults to; ``hard_sigmoid`` is Keras's
clip(0.2x + 0.5, 0, 1))."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "exp": torch.exp,
    "linear": lambda x: x,
    None: lambda x: x,
}


def get(name):
    """Resolve an activation by Keras name; callables pass through."""
    if callable(name):
        return name
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None
