"""Loss functions with Keras names — the JAX package's ``nn/objectives.py``.

Signature: ``loss(y_pred, y_true) -> per-sample loss`` (a tensor with the
batch axis first); the Estimator takes the weighted mean, so padded
batches stay exact.  Each is plain tensor math, differentiable by
autograd, with the JAX package's clipping constants.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _mean_over_features(x):
    if x.ndim <= 1:
        return x
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def _ids(y_true, y_pred):
    ids = y_true.to(torch.long)
    if ids.ndim == y_pred.ndim:
        ids = ids.squeeze(-1)
    return ids


def _take_last(x, ids):
    return torch.take_along_dim(x, ids[..., None], dim=-1)[..., 0]


def mean_squared_error(y_pred, y_true):
    return _mean_over_features((y_pred - y_true) ** 2)


def mean_absolute_error(y_pred, y_true):
    return _mean_over_features((y_pred - y_true).abs())


def mean_absolute_percentage_error(y_pred, y_true):
    diff = ((y_true - y_pred) / y_true.abs().clamp_min(_EPS)).abs()
    return 100.0 * _mean_over_features(diff)


def mean_squared_logarithmic_error(y_pred, y_true):
    a = torch.log(y_pred.clamp_min(_EPS) + 1.0)
    b = torch.log(y_true.clamp_min(_EPS) + 1.0)
    return _mean_over_features((a - b) ** 2)


def binary_crossentropy(y_pred, y_true):
    p = y_pred.clamp(_EPS, 1.0 - _EPS)
    return _mean_over_features(
        -(y_true * torch.log(p) + (1 - y_true) * torch.log1p(-p)))


def binary_crossentropy_from_logits(y_pred, y_true):
    return _mean_over_features(
        y_pred.clamp_min(0) - y_pred * y_true
        + torch.log1p(torch.exp(-y_pred.abs())))


def categorical_crossentropy(y_pred, y_true):
    """y_true one-hot over the last axis; y_pred probabilities."""
    return -(y_true * torch.log(y_pred.clamp(_EPS, 1.0))).sum(dim=-1)


def sparse_categorical_crossentropy(y_pred, y_true):
    """y_true integer class ids (0-based); y_pred probabilities over the
    last axis."""
    return -torch.log(_take_last(y_pred, _ids(y_true, y_pred)).clamp(
        _EPS, 1.0))


def class_nll(y_pred, y_true):
    """Negative log-likelihood over log-probabilities (zero-based
    labels)."""
    return -_take_last(y_pred, _ids(y_true, y_pred))


def sparse_categorical_crossentropy_from_logits(y_pred, y_true):
    logp = torch.log_softmax(y_pred, dim=-1)
    return -_take_last(logp, _ids(y_true, y_pred))


def hinge(y_pred, y_true):
    return _mean_over_features((1.0 - y_true * y_pred).clamp_min(0.0))


def squared_hinge(y_pred, y_true):
    return _mean_over_features((1.0 - y_true * y_pred).clamp_min(0.0) ** 2)


def rank_hinge(y_pred, y_true, margin=1.0):
    """Pairwise ranking hinge over [pos0, neg0, pos1, neg1, ...] batches;
    each pair's loss is charged to both of its rows, so the weighted mean
    over B rows equals the mean over B/2 pairs."""
    pos, neg = y_pred[0::2], y_pred[1::2]
    pair = (margin - pos + neg).clamp_min(0.0).reshape(
        pos.shape[0], -1).mean(dim=-1)
    return pair.repeat_interleave(2, dim=0)


def kullback_leibler_divergence(y_pred, y_true):
    t = y_true.clamp(_EPS, 1.0)
    p = y_pred.clamp(_EPS, 1.0)
    return (t * torch.log(t / p)).sum(dim=-1)


def poisson(y_pred, y_true):
    return _mean_over_features(y_pred - y_true * torch.log(y_pred + _EPS))


def cosine_proximity(y_pred, y_true):
    def l2n(x):
        return x / torch.linalg.vector_norm(
            x, dim=-1, keepdim=True).clamp_min(_EPS)
    return -(l2n(y_true) * l2n(y_pred)).sum(dim=-1)


_LOSSES = {
    "mse": mean_squared_error, "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error, "mean_absolute_error": mean_absolute_error,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "binary_crossentropy_from_logits": binary_crossentropy_from_logits,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_from_logits":
        sparse_categorical_crossentropy_from_logits,
    "class_nll": class_nll,
    "hinge": hinge, "squared_hinge": squared_hinge,
    "rank_hinge": rank_hinge,
    "kld": kullback_leibler_divergence,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
}


def get(name):
    if callable(name):
        return name
    try:
        return _LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}") from None
