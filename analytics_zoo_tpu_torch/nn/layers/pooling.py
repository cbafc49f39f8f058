"""Pooling — the JAX package's ``nn/layers/pooling.py``: 1-D, 2-D and
3-D windowed max and average pooling (``_PoolND`` :23, ``MaxPooling3D``
:76, ``AveragePooling3D`` :88) and global pooling (``_GlobalPool``,
``GlobalMaxPooling3D`` :114, ``GlobalAveragePooling3D`` :126).

Windowed pooling follows ``lax.reduce_window``: ``"same"`` pads with XLA's
SAME amounts (asymmetric at stride 2: the ResNet stem's 3×3/s2 max-pool
on 112 pads (0, 1)), explicit ``padding`` ((lo, hi) per spatial axis)
pads first; the fill is the operation's identity, -inf for max and 0 for
average, and an average always divides by the full window (padding
counted).  The pooling runs as ``F.max_pool2d`` / ``F.avg_pool2d``
(``F.max_pool3d`` / ``F.avg_pool3d`` in 3-D) on a channels-first view of
the channels-last tensor after an explicit pad; a 1-D pool as the (1, k)
pool of (B, 1, T, C).

Global pooling reduces the spatial axes: axes 1.. of (B, *spatial, C)
for ``dim_ordering`` "tf", axes 2.. of (B, C, *spatial) for "th".
"""

from __future__ import annotations

import torch.nn.functional as F

from analytics_zoo_tpu_torch.nn.layers.conv import (conv_pads, nchw_to_nhwc,
                                                    nhwc_to_nchw,
                                                    pad_spatial)
from analytics_zoo_tpu_torch.nn.module import Layer, to_shape


def _tuplize(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


class _PoolND(Layer):
    ndim = 2
    op = "max"

    def __init__(self, pool_size=2, strides=None, border_mode="valid",
                 dim_ordering="tf", padding=None, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.pool_size = _tuplize(pool_size, self.ndim)
        self.strides = _tuplize(strides, self.ndim) if strides \
            else self.pool_size
        self.border_mode = border_mode.lower()
        self.dim_ordering = dim_ordering
        # explicit (lo, hi) per spatial axis, filled with the identity
        self.padding = None if padding is None else \
            tuple((int(a), int(b)) for a, b in padding)

    def _spatial(self, shape):
        return shape[1:] if self.dim_ordering == "th" else shape[:-1]

    def _pads(self, sizes):
        """(lo, hi) per spatial axis: the explicit padding, then the
        border mode's on the padded sizes."""
        pre = self.padding or ((0, 0),) * self.ndim
        sizes = [None if s is None else s + lo + hi
                 for s, (lo, hi) in zip(sizes, pre)]
        mode = conv_pads(self.border_mode, sizes, self.pool_size,
                         self.strides, (1,) * self.ndim)
        return [(a + c, b + d) for (a, b), (c, d) in zip(pre, mode)]

    def compute_output_shape(self, input_shape):
        s = to_shape(input_shape)
        sizes = self._spatial(s)
        out = tuple(None if i is None else
                    (i + lo + hi - k) // st + 1
                    for i, k, st, (lo, hi) in zip(
                        sizes, self.pool_size, self.strides,
                        self._pads(sizes)))
        if self.dim_ordering == "th":
            return (s[0],) + out
        return out + (s[-1],)

    def forward(self, x):
        if self.dim_ordering == "th":
            x = nchw_to_nhwc(x)
        pads = self._pads(tuple(x.shape[1:-1]))
        x = pad_spatial(x, pads, float("-inf") if self.op == "max" else 0.0)
        pool = _POOL[(self.op, max(self.ndim, 2))]
        lift = (1,) if self.ndim == 1 else ()
        y = nchw_to_nhwc(pool(nhwc_to_nchw(x.reshape(
            x.shape[:1] + lift + x.shape[1:])), lift + self.pool_size,
            lift + self.strides))
        if lift:
            y = y.squeeze(1)
        return nhwc_to_nchw(y) if self.dim_ordering == "th" else y


_POOL = {("max", 2): F.max_pool2d, ("avg", 2): F.avg_pool2d,
         ("max", 3): F.max_pool3d, ("avg", 3): F.avg_pool3d}


class MaxPooling1D(_PoolND):
    ndim, op = 1, "max"


class AveragePooling1D(_PoolND):
    ndim, op = 1, "avg"


class MaxPooling2D(_PoolND):
    op = "max"


class AveragePooling2D(_PoolND):
    op = "avg"


class MaxPooling3D(_PoolND):
    ndim, op = 3, "max"


class AveragePooling3D(_PoolND):
    ndim, op = 3, "avg"


class _GlobalPool(Layer):
    ndim = 1
    op = "max"

    def __init__(self, dim_ordering="tf", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dim_ordering = dim_ordering

    def _axes(self):
        first = 2 if self.dim_ordering == "th" else 1
        return tuple(range(first, first + self.ndim))

    def forward(self, x):
        axes = self._axes()
        return x.amax(dim=axes) if self.op == "max" else x.mean(dim=axes)

    def compute_output_shape(self, input_shape):
        drop = {a - 1 for a in self._axes()}
        return tuple(d for i, d in enumerate(to_shape(input_shape))
                     if i not in drop)


class GlobalMaxPooling1D(_GlobalPool):
    ndim, op = 1, "max"


class GlobalAveragePooling1D(_GlobalPool):
    ndim, op = 1, "avg"


class GlobalMaxPooling2D(_GlobalPool):
    ndim, op = 2, "max"


class GlobalAveragePooling2D(_GlobalPool):
    ndim, op = 2, "avg"


class GlobalMaxPooling3D(_GlobalPool):
    ndim, op = 3, "max"


class GlobalAveragePooling3D(_GlobalPool):
    ndim, op = 3, "avg"
