"""Autograd DSL — the JAX package's ``nn/autograd.py``: symbolic math over
``SymTensor``s, custom losses and trainable ``Parameter`` / ``Constant``
nodes (pipeline/api/autograd: ``AutoGrad`` math.scala:32-376,
``CustomLoss`` CustomLoss.scala:51-66, ``Parameter`` / ``Constant``
KerasParameter.scala).

PyTorch's autograd differentiates the graph, so every function here is a
``Lambda`` node over torch ops; ``custom_loss`` turns a symbolic
expression of (y_true, y_pred) placeholders into an ordinary loss
callable for ``compile`` / the ``Estimator``.  Axes follow the JAX
module: ``dim`` / ``axis`` count the non-batch axes (0 the first, -1 the
last) unless a function says otherwise.  Each node is named after its
function with a counter (``ag_abs_0``): the graph ``Model`` refuses two
layers of one name.
"""

from __future__ import annotations

import builtins
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.nn.graph import Input, SymTensor
from analytics_zoo_tpu_torch.nn.layers.core import Lambda
from analytics_zoo_tpu_torch.nn.models import Model
from analytics_zoo_tpu_torch.nn.module import (Layer, _auto_name,
                                               initializer)


def _node(fn, name):
    return Lambda(fn, name=_auto_name(name))


def _unary(fn, name):
    def apply(x: SymTensor):
        return _node(fn, name)(x)
    return apply


abs = _unary(torch.abs, "ag_abs")  # noqa: A001 - AutoGrad.abs parity
square = _unary(torch.square, "ag_square")
sqrt = _unary(torch.sqrt, "ag_sqrt")
log = _unary(torch.log, "ag_log")
exp = _unary(torch.exp, "ag_exp")
softsign = _unary(F.softsign, "ag_softsign")
softplus = _unary(F.softplus, "ag_softplus")
erf = _unary(torch.erf, "ag_erf")
contiguous = _unary(lambda t: t, "ag_contiguous")


def _nonbatch_axis(t, axis: int) -> int:
    """A user axis over the non-batch axes as the tensor's axis; a negative
    one counts from the end and never reaches the batch axis."""
    real = axis + 1 if axis >= 0 else t.ndim + axis
    if not 1 <= real < t.ndim:
        raise ValueError(
            f"axis {axis} out of range for {t.ndim - 1} non-batch dim(s)")
    return real


def slice(x, dim: int, start_index: int, length: int):  # noqa: A001
    """``length`` entries of non-batch axis ``dim`` from ``start_index``
    (negative from the end; ``length`` -1 takes the rest)."""
    def fn(t):
        ax = _nonbatch_axis(t, dim)
        start = start_index if start_index >= 0 \
            else t.shape[ax] + start_index
        stop = None if length == -1 else start + length
        idx = [builtins.slice(None)] * t.ndim
        idx[ax] = builtins.slice(start, stop)
        return t[tuple(idx)]
    return _node(fn, "ag_slice")(x)


def index_select(x, dim: int, index):
    """Gather ``index`` (an int, which drops the axis, or a list of ints,
    negative from the end) along non-batch axis ``dim``."""
    def fn(t):
        ax = _nonbatch_axis(t, dim)
        n = t.shape[ax]
        idx = [index] if isinstance(index, int) else list(index)
        bad = [i for i in idx if not -n <= int(i) < n]
        if bad:
            raise IndexError(f"index_select indices {bad} out of range for "
                             f"axis {ax} of size {n}")
        if isinstance(index, int):
            return t.select(ax, index)
        return t.index_select(ax, torch.tensor([int(i) % n for i in idx],
                                               device=t.device))
    return _node(fn, "ag_index_select")(x)


def squeeze(x, dim: int):
    return _node(lambda t: t.squeeze(_nonbatch_axis(t, dim)),
                 "ag_squeeze")(x)


def expand(x, sizes):
    """Broadcast the non-batch axes to ``sizes`` (-1 keeps an axis)."""
    def fn(t):
        return t.expand((t.shape[0],) + tuple(
            t.shape[i + 1] if s == -1 else int(s)
            for i, s in enumerate(sizes)))
    return _node(fn, "ag_broadcast")(x)


def epsilon() -> float:
    return 1e-7


def mean(x: SymTensor, axis: int = 0, keep_dims: bool = False) -> SymTensor:
    """Mean over a non-batch axis (axis 0: the first non-batch axis)."""
    return _node(lambda t: t.mean(dim=_nonbatch_axis(t, axis),
                                  keepdim=keep_dims), "ag_mean")(x)


def sum(x: SymTensor, axis: int = 0,  # noqa: A001
        keep_dims: bool = False) -> SymTensor:
    return _node(lambda t: t.sum(dim=_nonbatch_axis(t, axis),
                                 keepdim=keep_dims), "ag_sum")(x)


def clip(x: SymTensor, min_v: float, max_v: float) -> SymTensor:
    return _node(lambda t: torch.clamp(t, min_v, max_v), "ag_clip")(x)


def maximum(x: SymTensor, y) -> SymTensor:
    if isinstance(y, SymTensor):
        return _node(lambda ts: torch.maximum(ts[0], ts[1]),
                     "ag_maximum")([x, y])
    return _node(lambda t: torch.clamp_min(t, y), "ag_maximum")(x)


def pow(x: SymTensor, a: float) -> SymTensor:  # noqa: A001
    return _node(lambda t: t ** a, "ag_pow")(x)


def neg(x: SymTensor) -> SymTensor:
    return _node(lambda t: -t, "ag_neg")(x)


def stack(xs: Sequence[SymTensor], axis: int = 1) -> SymTensor:
    """Stack along ``axis`` of the batched tensors (1: after the batch)."""
    return _node(lambda ts: torch.stack(ts, dim=axis), "ag_stack")(list(xs))


def expand_dims(x: SymTensor, axis: int) -> SymTensor:
    """A size-1 axis at ``axis`` of the batched tensor."""
    return _node(lambda t: t.unsqueeze(axis), "ag_expand")(x)


def l2_normalize(x: SymTensor, axis: int = -1) -> SymTensor:
    """``t / max(|t|, 1e-8)`` along ``axis`` of the batched tensor."""
    return _node(lambda t: t / torch.clamp_min(torch.linalg.vector_norm(
        t, dim=axis, keepdim=True), 1e-8), "ag_l2norm")(x)


def mm(x: SymTensor, y: SymTensor, axes: Optional[Sequence[int]] = None
       ) -> SymTensor:
    """Batched matmul over the non-batch axes (AutoGrad.mm); ``axes`` [1,
    1] contracts the last axes of both."""
    def go(ts):
        a, b = ts
        if axes is not None:
            return torch.einsum("b...i,b...i->b...", a, b) \
                if axes == [1, 1] else torch.matmul(a, b)
        return dtypes.matmul(a, b, dtypes.param_dtype())
    return _node(go, "ag_mm")([x, y])


def batch_dot(x: SymTensor, y: SymTensor, axes=(1, 1)) -> SymTensor:
    """Σ x·y along ``axes[0]`` of the batched tensors, kept as an axis."""
    return _node(lambda ts: (ts[0] * ts[1]).sum(dim=axes[0], keepdim=True),
                 "ag_batchdot")([x, y])


# -- CustomLoss ----------------------------------------------------------------

def custom_loss(loss_builder: Callable[[SymTensor, SymTensor], SymTensor],
                y_pred_shape, y_true_shape=None) -> Callable:
    """A loss callable from a symbolic expression (CustomLoss.scala:51-66):
    ``loss_builder(y_true, y_pred)`` -> a ``SymTensor`` of per-sample
    losses; returns ``fn(y_pred, y_true)`` -> (B,), the mean over each
    sample's entries, for ``compile`` / the ``Estimator``."""
    y_true_shape = y_true_shape or y_pred_shape
    yt = Input(shape=y_true_shape, name="ct_ytrue")
    yp = Input(shape=y_pred_shape, name="ct_ypred")
    graph = Model(input=[yt, yp], output=loss_builder(yt, yp),
                  name="custom_loss")

    def loss_fn(y_pred, y_true):
        per = graph([y_true, y_pred])
        return per.reshape(per.shape[0], -1).mean(dim=-1)

    return loss_fn


# -- Parameter / Constant ------------------------------------------------------

class Parameter(Layer):
    """A standalone trainable tensor as a graph node (KerasParameter.scala):
    called on any node, it ignores the input's values and returns its
    ``value`` (``shape``) broadcast over the input's batch."""

    def __init__(self, shape, init_weight: Optional[np.ndarray] = None,
                 init="glorot_uniform", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.shape = tuple(int(s) for s in shape)
        self.init_weight = init_weight
        self.init_name = init
        self.ensure_built(self._declared_input_shape)

    def build(self, input_shape):
        self.value = nn.Parameter(torch.empty(self.shape))

    def reset_parameters(self, gen):
        if self.init_weight is not None:
            self.value.copy_(torch.as_tensor(np.asarray(
                self.init_weight, np.float32)))
        else:
            self.value.copy_(initializer(self.init_name, gen, self.shape))

    def _tree(self):
        return {"value": self.value}

    def compute_output_shape(self, input_shape):
        return self.shape

    def forward(self, x):
        return self.value.expand((x.shape[0],) + self.shape)


class Constant(Layer):
    """A non-trainable constant node (KerasConstant): ``value`` broadcast
    over the input's batch."""

    def __init__(self, value, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.register_buffer("value", torch.as_tensor(
            np.asarray(value, np.float32)))

    def compute_output_shape(self, input_shape):
        return tuple(self.value.shape)

    def forward(self, x):
        return self.value.expand((x.shape[0],) + tuple(self.value.shape))
