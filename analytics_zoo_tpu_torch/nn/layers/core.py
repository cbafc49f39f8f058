"""Core layers: Dense (float, W8A8 and W4A16), Activation, Dropout,
Flatten, Merge and BatchNormalization — the JAX package's
``nn/layers/core.py``.

``Dense`` keeps the JAX layout: ``W`` is (d_in, d_out) and applies as
``x @ W + b``.  Quantized, it holds the quantizer's leaves as buffers:

- int8 (W8A8): ``W_q`` (K, N) int8, ``s_w`` (N,) f32 per output channel,
  ``s_x`` () f32 activation scale, optional ``b``.  The activation is
  quantized as ``clamp(round(x / s_x), -127, 127)`` (``torch.round``
  rounds half to even, like ``jnp.round``) and the product runs through
  ``ops/quant_matmul.w8a8_dense`` with the scale ``s_x * s_w``.
- int4 (W4A16): ``W_q4`` (ceil(K/2), N) uint8 split-nibble packed,
  ``s_g`` (G, N) f32 group scales, optional ``b``; the activation stays
  f32 (``w4a16_dense``).

A float ``Dense`` becomes quantized when ``utils/convert.load_jax_params``
loads a quantized leaf set into it (``inference/quantize.py`` makes one).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.nn import activations
from analytics_zoo_tpu_torch.nn.module import (Layer, dropout, initializer,
                                               to_shape)
from analytics_zoo_tpu_torch.ops import quant_matmul as qm

_QUANT_DTYPES = {"W_q": torch.int8, "s_w": torch.float32,
                 "s_x": torch.float32, "W_q4": torch.uint8,
                 "s_g": torch.float32}
# a layer's weight leaves by its form: float, int8 (W8A8), int4 (W4A16)
QUANT_KEYS = {0: ("W",), 8: ("W_q", "s_w", "s_x"), 4: ("W_q4", "s_g")}


def adopt_quantized(layer: Layer, leaves: Dict, w_shape, k: int,
                    n: int) -> None:
    """Switch ``layer`` (a ``Dense`` or a convolution: float ``W`` of
    ``w_shape``, contraction K = ``k``, ``n`` outputs, its form in
    ``layer.bits``) to the form a param tree's leaf set names — float
    ``{W}``, int8 ``{W_q, s_w, s_x}`` or int4 ``{W_q4, s_g}`` (with ``b``
    when the layer has a bias) — creating empty buffers of the right
    shapes for the loader to fill."""
    bits = 4 if "W_q4" in leaves else 8 if "W_q" in leaves else 0
    if bits == layer.bits:
        return
    if bits == 0:
        raise ValueError(f"{layer.name}: a quantized {type(layer).__name__}"
                         " cannot take float weights back; rebuild the "
                         "model")
    want = {"W_q": tuple(w_shape), "s_w": (n,), "s_x": ()} if bits == 8 \
        else {"W_q4": ((k + 1) // 2, n), "s_g": None}
    dev = layer.W.device
    for key, shape in want.items():
        if key not in leaves:
            raise KeyError(f"{layer.name}: int{bits} leaves lack {key!r}")
        got = tuple(np.shape(leaves[key]))
        if key == "s_g":
            if len(got) != 2 or got[1] != n or not 1 <= got[0] <= k:
                raise ValueError(f"{layer.name}: s_g must be (G, {n}) "
                                 f"with 1 <= G <= {k}, got {got}")
            shape = got
        elif got != shape:
            raise ValueError(f"{layer.name}: {key} must be {shape}, got "
                             f"{got}")
        layer.register_buffer(key, torch.empty(
            shape, dtype=_QUANT_DTYPES[key], device=dev))
    del layer.W
    layer.bits = bits


class Dense(Layer):
    """Fully-connected layer (keras/layers/Dense)."""

    def __init__(self, output_dim: int, activation=None,
                 init="glorot_uniform", bias: bool = True,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = int(output_dim)
        self.activation = activations.get(activation)
        self.init_name = init
        self.bias = bias
        self.bits = 0            # 0 float, 8 W8A8, 4 W4A16
        # quantized: the kernels or their plain versions (ops/_impl)
        self.impl: Optional[str] = None
        self._build_declared()

    def build(self, input_shape):
        self.input_dim = to_shape(input_shape)[-1]
        self.W = nn.Parameter(torch.empty(self.input_dim, self.output_dim))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(self.output_dim))

    def reset_parameters(self, gen):
        if self.bits == 0:
            self.W.copy_(initializer(self.init_name, gen, self.W.shape))
        if self.bias:
            self.b.zero_()

    def compute_output_shape(self, input_shape):
        return to_shape(input_shape)[:-1] + (self.output_dim,)

    def _tree(self) -> Dict:
        tree = {k: getattr(self, k) for k in QUANT_KEYS[self.bits]}
        if self.bias:
            tree["b"] = self.b
        return tree

    def adopt_leaves(self, leaves: Dict) -> None:
        """Switch to the form a param tree's leaf set names
        (:func:`adopt_quantized`)."""
        adopt_quantized(self, leaves, (self.input_dim, self.output_dim),
                        self.input_dim, self.output_dim)

    def forward(self, x):
        if self.bits == 0:
            xw, W = dtypes.cast_compute(x, self.W)
            y = dtypes.matmul(xw, W, dtypes.param_dtype())
            if self.bias:
                y = y + self.b
            return self.activation(y)
        if self.bits == 4:
            y = qm.w4a16_dense(x.to(torch.float32), self.W_q4, self.s_g,
                               impl=self.impl)
        else:
            xq = torch.clamp(torch.round(x.to(torch.float32) / self.s_x),
                             -127, 127).to(torch.int8)
            y = qm.w8a8_dense(xq, self.W_q, self.s_x * self.s_w,
                              impl=self.impl)
        if self.bias:
            y = y + self.b
        return self.activation(y.to(dtypes.param_dtype()))


class Activation(Layer):
    def __init__(self, activation, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.fn = activations.get(activation)

    def forward(self, x):
        return self.fn(x)


class Dropout(Layer):
    """Inverted dropout; the identity in eval mode or with no seed
    (``Layer.seed_dropout``)."""

    def __init__(self, p: float, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.p = float(p)

    def forward(self, x):
        seed = self.train_seed()
        if seed is None or self.p <= 0.0:
            return x
        return dropout(x, self.p, seed)


class Flatten(Layer):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def compute_output_shape(self, input_shape):
        return (int(np.prod(to_shape(input_shape))),)


class Merge(Layer):
    """Multi-input merge (keras/layers/Merge): modes sum, mul, ave, sub,
    max, min, concat, dot, cos, over a list of inputs, left to right as the
    JAX package folds them.  (The JAX ``Merge``'s branch layers, which no
    graph of the zoo uses, are not ported.)"""

    def __init__(self, mode="sum", concat_axis=-1, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.mode = mode
        self.concat_axis = int(concat_axis)

    def _axis(self, rank: int) -> int:
        """``concat_axis`` of a batched tensor of ``rank`` as an index into
        a shape without the batch axis."""
        return self.concat_axis - 1 if self.concat_axis > 0 \
            else rank - 1 + self.concat_axis

    def compute_output_shape(self, input_shape):
        shapes = [to_shape(s) for s in input_shape]
        if self.mode == "concat":
            ax = self._axis(len(shapes[0]) + 1)
            out = list(shapes[0])
            out[ax] = None if any(s[ax] is None for s in shapes) \
                else sum(s[ax] for s in shapes)
            return tuple(out)
        if self.mode in ("dot", "cos"):
            return shapes[0][:-1] + (1,)
        return shapes[0]

    def _merge(self, xs):
        m = self.mode
        if m in ("sum", "ave"):
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out / float(len(xs)) if m == "ave" else out
        if m == "mul":
            out = xs[0]
            for x in xs[1:]:
                out = out * x
            return out
        if m == "sub":
            if len(xs) != 2:
                raise ValueError("sub merge requires exactly 2 inputs")
            return xs[0] - xs[1]
        if m in ("max", "min"):
            fn = torch.maximum if m == "max" else torch.minimum
            out = xs[0]
            for x in xs[1:]:
                out = fn(out, x)
            return out
        if m == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        if m == "dot":
            return (xs[0] * xs[1]).sum(-1, keepdim=True)
        if m == "cos":
            a, b = xs[0], xs[1]
            na = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
            nb = torch.linalg.vector_norm(b, dim=-1, keepdim=True)
            return (a * b).sum(-1, keepdim=True) / (na * nb + 1e-8)
        raise ValueError(f"unknown merge mode {self.mode!r}")

    def forward(self, xs):
        return self._merge(list(xs))


def merge(inputs, mode="sum", concat_axis=-1, name=None):
    """Functional-API merge over ``SymTensor``s (keras.layers.merge)."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(list(inputs))


class BatchNormalization(Layer):
    """Batch normalization with the JAX package's semantics
    (``nn/layers/core.py:285``), not ``F.batch_norm``'s:

    - training: single-pass f32 statistics (f64 for an f64 input, which
      the JAX package would round to f32) over every axis but ``axis``,
      ``mean = S / n`` and the BIASED ``var = max(Q / n - mean², 0)`` from
      ``S = Σx`` and ``Q = Σx²``; the moving statistics (buffers ``mean``,
      ``var``) become ``momentum · old + (1 - momentum) · batch`` in place,
      once per forward.  ``forward(x, stats=(S, Q, n))`` takes the sums
      precomputed — the graph ``Model``'s fused 1×1-conv route
      (``ops/fused_bn.py``) hands them over from the conv's epilogue —
      and gradients flow back through them;
    - eval: the moving statistics;
    - both: ``(mean, var, gamma, beta)`` folded into a per-channel scale
      and shift in that dtype, then one multiply and one add in ``x``'s.
    """

    def __init__(self, epsilon=1e-3, momentum=0.99, axis=-1,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        if int(axis) == 0:
            raise ValueError("BatchNormalization cannot normalise over the "
                             "batch axis (axis=0)")
        self.axis = int(axis)
        self._build_declared()

    def _dim(self, input_shape):
        shape = to_shape(input_shape)
        return shape[self.axis] if self.axis < 0 else shape[self.axis - 1]

    def build(self, input_shape):
        d = self._dim(input_shape)
        self.gamma = nn.Parameter(torch.ones(d))
        self.beta = nn.Parameter(torch.zeros(d))
        self.register_buffer("mean", torch.zeros(d))
        self.register_buffer("var", torch.ones(d))

    def reset_parameters(self, gen):
        self.gamma.fill_(1.0)
        self.beta.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def _tree(self) -> Dict:
        return {"gamma": self.gamma, "beta": self.beta}

    def _state_tree(self) -> Dict:
        return {"mean": self.mean, "var": self.var}

    def forward(self, x, stats=None):
        ax = self.axis % x.ndim
        bshape = [1] * x.ndim
        bshape[ax] = x.shape[ax]
        sdt = torch.promote_types(x.dtype, torch.float32)
        if self.training:
            if stats is None:
                red = tuple(i for i in range(x.ndim) if i != ax)
                xs = x.to(sdt)
                stats = (xs.sum(red), (xs * xs).sum(red),
                         x.numel() // x.shape[ax])
            s, ss, count = stats
            mean = s / count
            var = torch.clamp_min(ss / count - mean * mean, 0.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon)
        gamma = self.gamma.to(sdt)
        beta = self.beta.to(sdt)
        scale = (gamma * inv).to(x.dtype)
        shift = (beta - mean * gamma * inv).to(x.dtype)
        return x * scale.reshape(bshape) + shift.reshape(bshape)
