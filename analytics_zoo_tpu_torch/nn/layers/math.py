"""Elementwise and structural math layers — the JAX package's
``nn/layers/math.py``: ``AddConstant``, ``MulConstant``, ``Negative``,
``Power``, ``Sqrt``, ``Square``, ``Exp``, ``Log``, ``Identity``,
``Softmax``, ``BinaryThreshold``, ``Threshold``, ``HardShrink``,
``SoftShrink``, ``HardTanh``, ``RReLU``, ``CAdd`` (``b`` of ``size``),
``CMul`` (``w``), ``Scale`` (``w``, ``b``), ``Mul`` (``w`` ()),
``Expand``, ``GetShape``, ``Max``, ``SelectTable``, ``SplitTensor`` and
``GaussianSampler``.

The table layers follow the graph's lists: ``SplitTensor`` returns a list
of tensors and its node's shape is the list of their shapes;
``SelectTable`` and ``GaussianSampler`` take a list.  ``RReLU``'s slopes
and ``GaussianSampler``'s noise are drawn, in training mode with a seed
(``Layer.seed_dropout``), from the layer's generator: they match the JAX
layers in distribution, not draw by draw.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from analytics_zoo_tpu_torch.nn.module import Layer, generator, to_shape


class AddConstant(Layer):
    """y = x + constant."""

    def __init__(self, constant=0.0, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.constant = float(constant)

    def forward(self, x):
        return x + self.constant


class MulConstant(Layer):
    """y = x · constant."""

    def __init__(self, constant=1.0, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.constant = float(constant)

    def forward(self, x):
        return x * self.constant


class Negative(Layer):
    def forward(self, x):
        return -x


class Power(Layer):
    """y = (shift + scale · x) ** power."""

    def __init__(self, power, scale=1.0, shift=0.0, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.power = float(power)
        self.scale = float(scale)
        self.shift = float(shift)

    def forward(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class Sqrt(Layer):
    def forward(self, x):
        return torch.sqrt(x)


class Square(Layer):
    def forward(self, x):
        return x * x


class Exp(Layer):
    def forward(self, x):
        return torch.exp(x)


class Log(Layer):
    def forward(self, x):
        return torch.log(x)


class Identity(Layer):
    def forward(self, x):
        return x


class Softmax(Layer):
    """Softmax over the last axis."""

    def forward(self, x):
        return torch.softmax(x, dim=-1)


class BinaryThreshold(Layer):
    """y = 1 where x > value, else 0, in x's dtype."""

    def __init__(self, value=1e-6, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.value = float(value)

    def forward(self, x):
        return (x > self.value).to(x.dtype)


class Threshold(Layer):
    """y = x where x > th, else v."""

    def __init__(self, th=1e-6, v=0.0, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.th = float(th)
        self.v = float(v)

    def forward(self, x):
        return torch.where(x > self.th, x, self.v).to(x.dtype)


class HardShrink(Layer):
    """y = x where |x| > value, else 0."""

    def __init__(self, value=0.5, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.value = float(value)

    def forward(self, x):
        return torch.where(x.abs() > self.value, x, 0.0).to(x.dtype)


class SoftShrink(Layer):
    """y = x ∓ value outside [-value, value], else 0."""

    def __init__(self, value=0.5, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.value = float(value)

    def forward(self, x):
        v = self.value
        return torch.where(x > v, x - v,
                           torch.where(x < -v, x + v, 0.0)).to(x.dtype)


class HardTanh(Layer):
    """y = clip(x, min_value, max_value)."""

    def __init__(self, min_value=-1.0, max_value=1.0, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class RReLU(Layer):
    """Randomized leaky ReLU (RReLU.scala): in training mode with a seed
    the negative slope of each element ~ U(lower, upper), else (lower +
    upper) / 2."""

    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.lower = float(lower)
        self.upper = float(upper)

    def forward(self, x):
        seed = self.train_seed()
        if seed is None:
            a = (self.lower + self.upper) / 2.0
        else:
            u = torch.rand(x.shape, generator=generator(seed, x.device),
                           device=x.device)
            a = (self.lower + (self.upper - self.lower) * u).to(x.dtype)
        return torch.where(x >= 0, x, a * x)


class _Elementwise(Layer):
    """A learnable tensor of the broadcast shape ``size``, created at
    construction (its shape follows from ``size`` alone)."""

    _LEAVES: Dict[str, float] = {}

    def __init__(self, size, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.size = tuple(int(s) for s in to_shape(size))
        self.ensure_built(self._declared_input_shape)

    def build(self, input_shape):
        for key in self._LEAVES:
            setattr(self, key, nn.Parameter(torch.empty(self.size)))

    def reset_parameters(self, gen):
        for key, v in self._LEAVES.items():
            getattr(self, key).fill_(v)

    def _tree(self) -> Dict:
        return {key: getattr(self, key) for key in self._LEAVES}


class CAdd(_Elementwise):
    """y = x + b, ``b`` of ``size`` (zeros at first)."""

    _LEAVES = {"b": 0.0}

    def forward(self, x):
        return x + self.b


class CMul(_Elementwise):
    """y = x · w, ``w`` of ``size`` (ones at first)."""

    _LEAVES = {"w": 1.0}

    def forward(self, x):
        return x * self.w


class Scale(_Elementwise):
    """y = x · w + b (CMul then CAdd)."""

    _LEAVES = {"w": 1.0, "b": 0.0}

    def forward(self, x):
        return x * self.w + self.b


class Mul(_Elementwise):
    """y = x · w, one learnable scalar."""

    _LEAVES = {"w": 1.0}

    def __init__(self, input_shape=None, name=None):
        super().__init__((), input_shape=input_shape, name=name)

    def forward(self, x):
        return x * self.w


class Expand(Layer):
    """Broadcast size-1 axes to ``tgt_sizes`` (the batch axis excluded; -1
    keeps an axis)."""

    def __init__(self, tgt_sizes, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.tgt_sizes = tuple(int(s) for s in tgt_sizes)

    def compute_output_shape(self, input_shape):
        s = to_shape(input_shape)
        return tuple(s[i] if t == -1 else t
                     for i, t in enumerate(self.tgt_sizes))

    def forward(self, x):
        return x.expand((x.shape[0],) + tuple(
            x.shape[i + 1] if t == -1 else t
            for i, t in enumerate(self.tgt_sizes)))


class GetShape(Layer):
    """The input's shape, batch axis included, as an int32 tensor.  Its
    output has no batch axis, so its node's shape is the JAX rule's
    ``(rank,)[1:]``."""

    def compute_output_shape(self, input_shape):
        return ()

    def forward(self, x):
        return torch.tensor(tuple(x.shape), dtype=torch.int32,
                            device=x.device)


class Max(Layer):
    """The max over axis ``dim`` (the batch axis is 0); ``return_value``
    False gives the int32 index of the first maximum instead."""

    def __init__(self, dim, return_value=True, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)
        self.return_value = bool(return_value)

    def compute_output_shape(self, input_shape):
        s = to_shape(input_shape)
        ax = self.dim - 1 if self.dim > 0 else len(s) + self.dim
        return s[:ax] + s[ax + 1:]

    def forward(self, x):
        if self.return_value:
            return x.amax(dim=self.dim)
        return x.argmax(dim=self.dim).to(torch.int32)


class SelectTable(Layer):
    """Entry ``index`` of a list input."""

    def __init__(self, index, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.index = int(index)

    def compute_output_shape(self, input_shape):
        return to_shape(input_shape[self.index])

    def forward(self, xs):
        return xs[self.index]


class SplitTensor(Layer):
    """Split axis ``dim`` (the batch axis is 0) into ``num_split`` equal
    parts, returned as a list (``jnp.split``)."""

    def __init__(self, dim, num_split, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)
        self.num_split = int(num_split)

    def compute_output_shape(self, input_shape):
        s = list(to_shape(input_shape))
        ax = self.dim - 1 if self.dim > 0 else len(s) + self.dim
        if s[ax] is not None:
            s[ax] //= self.num_split
        return [tuple(s)] * self.num_split

    def forward(self, x):
        n = x.shape[self.dim]
        if n % self.num_split:
            raise ValueError(f"{self.name}: axis {self.dim} of size {n} does "
                             f"not split into {self.num_split} equal parts")
        return list(x.split(n // self.num_split, dim=self.dim))


class GaussianSampler(Layer):
    """VAE reparameterization (GaussianSampler.scala): input [mean,
    log_var], output mean + exp(log_var / 2) · eps with eps ~ N(0, 1) in
    training mode with a seed, else the mean."""

    def compute_output_shape(self, input_shape):
        return to_shape(input_shape[0])

    def forward(self, xs):
        mean, log_var = xs
        seed = self.train_seed()
        if seed is None:
            return mean
        eps = torch.randn(mean.shape, generator=generator(seed, mean.device),
                          device=mean.device).to(mean.dtype)
        return mean + torch.exp(log_var * 0.5) * eps
