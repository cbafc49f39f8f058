"""Advanced activations and small parametric layers — the JAX package's
``nn/layers/advanced.py``: ``LeakyReLU``, ``ELU``, ``ThresholdedReLU``,
``PReLU`` (``alpha`` (d,)), ``SReLU`` (``t_left``, ``a_left``,
``t_right``, ``a_right`` (d,)), ``MaxoutDense`` (``W`` (nb_feature, d,
output_dim), ``b`` (nb_feature, output_dim)), ``SpatialDropout1D`` /
``2D`` and ``WithinChannelLRN2D``.

The spatial dropouts drop whole channels in training mode with a seed
(``Layer.seed_dropout``), drawing their masks from the layer's generator:
they match the JAX layers in distribution, not draw by draw.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.nn.module import (Layer, generator,
                                               initializer, to_shape)


class LeakyReLU(Layer):
    def __init__(self, alpha=0.3, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.alpha = float(alpha)

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class ELU(Layer):
    def __init__(self, alpha=1.0, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.alpha = float(alpha)

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * (torch.exp(x) - 1.0))


class ThresholdedReLU(Layer):
    def __init__(self, theta=1.0, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.theta = float(theta)

    def forward(self, x):
        return torch.where(x > self.theta, x, 0.0).to(x.dtype)


class PReLU(Layer):
    """A learnable leaky slope per channel of the last axis, 0.25 at
    first."""

    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self._build_declared()

    def build(self, input_shape):
        self.alpha = nn.Parameter(torch.empty(to_shape(input_shape)[-1]))

    def reset_parameters(self, gen):
        self.alpha.fill_(0.25)

    def _tree(self) -> Dict:
        return {"alpha": self.alpha}

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class SReLU(Layer):
    """S-shaped ReLU (SReLU.scala): piecewise linear with four learnable
    parameters a channel; below ``t_left`` slope ``a_left``, above
    ``t_right`` slope ``a_right``."""

    _KEYS = ("t_left", "a_left", "t_right", "a_right")
    _INIT = (0.0, 0.0, 1.0, 1.0)

    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self._build_declared()

    def build(self, input_shape):
        d = to_shape(input_shape)[-1]
        for key in self._KEYS:
            setattr(self, key, nn.Parameter(torch.empty(d)))

    def reset_parameters(self, gen):
        for key, v in zip(self._KEYS, self._INIT):
            getattr(self, key).fill_(v)

    def _tree(self) -> Dict:
        return {key: getattr(self, key) for key in self._KEYS}

    def forward(self, x):
        tl, al, tr, ar = (getattr(self, k) for k in self._KEYS)
        y = torch.where(x < tl, tl + al * (x - tl), x)
        return torch.where(x > tr, tr + ar * (x - tr), y)


class MaxoutDense(Layer):
    """The max over ``nb_feature`` linear projections (MaxoutDense.scala)."""

    def __init__(self, output_dim, nb_feature=4, bias=True,
                 init="glorot_uniform", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = int(output_dim)
        self.nb_feature = int(nb_feature)
        self.bias = bias
        self.init_name = init
        self._build_declared()

    def build(self, input_shape):
        d = to_shape(input_shape)[-1]
        self.W = nn.Parameter(torch.empty(self.nb_feature, d,
                                          self.output_dim))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(self.nb_feature,
                                              self.output_dim))

    def reset_parameters(self, gen):
        self.W.copy_(initializer(self.init_name, gen, self.W.shape,
                                 fan_in=self.W.shape[1],
                                 fan_out=self.output_dim))
        if self.bias:
            self.b.zero_()

    def _tree(self) -> Dict:
        return {"W": self.W, "b": self.b} if self.bias else {"W": self.W}

    def compute_output_shape(self, input_shape):
        return to_shape(input_shape)[:-1] + (self.output_dim,)

    def forward(self, x):
        xw, W = dtypes.cast_compute(x, self.W)
        y = torch.einsum("bd,fdo->bfo", xw.to(torch.float32),
                         W.to(torch.float32))
        if self.bias:
            y = y + self.b
        return y.amax(dim=1)


def _channel_dropout(layer: Layer, x, shape):
    """``x / keep`` where a uniform draw of ``shape`` (broadcast over the
    spatial axes) is below ``keep``, else 0; the identity outside training
    or with no seed."""
    seed = layer.train_seed()
    if seed is None or layer.p <= 0:
        return x
    keep = 1.0 - layer.p
    draw = torch.rand(shape, generator=generator(seed, x.device),
                      device=x.device)
    return torch.where(draw < keep, x / keep, 0.0).to(x.dtype)


class SpatialDropout1D(Layer):
    """Drop whole channels of (B, T, C) (SpatialDropout1D.scala)."""

    def __init__(self, p=0.5, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.p = float(p)

    def forward(self, x):
        return _channel_dropout(self, x, (x.shape[0], 1, x.shape[2]))


class SpatialDropout2D(Layer):
    """Drop whole channels of an image batch ("tf" (B, H, W, C), "th" (B,
    C, H, W))."""

    def __init__(self, p=0.5, dim_ordering="tf", input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.p = float(p)
        self.dim_ordering = dim_ordering

    def forward(self, x):
        shape = ((x.shape[0], x.shape[1], 1, 1) if self.dim_ordering == "th"
                 else (x.shape[0], 1, 1, x.shape[3]))
        return _channel_dropout(self, x, shape)


class WithinChannelLRN2D(Layer):
    """Local response normalization within each channel of (B, H, W, C)
    (WithinChannelLRN2D.scala): ``x / (1 + alpha · mean of x² over a size
    x size window) ** beta``, the window summed with XLA's SAME padding at
    stride 1 (zeros outside)."""

    def __init__(self, size=5, alpha=1.0, beta=0.75, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.size, self.alpha, self.beta = int(size), float(alpha), \
            float(beta)

    def forward(self, x):
        n = self.size
        lo, hi = (n - 1) // 2, n - 1 - (n - 1) // 2
        sq = F.pad((x * x).permute(0, 3, 1, 2), (lo, hi, lo, hi))
        summed = F.avg_pool2d(sq, n, stride=1,
                              divisor_override=1).permute(0, 2, 3, 1)
        norm = (1.0 + self.alpha * summed / (n ** 2)) ** self.beta
        return x / norm
