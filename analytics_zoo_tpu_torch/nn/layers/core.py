"""Core layers on the predict path: Dense (float, W8A8 and W4A16),
Activation, Dropout and Flatten — the JAX package's ``nn/layers/core.py``.

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
from analytics_zoo_tpu_torch.nn.module import Layer, initializer, to_shape
from analytics_zoo_tpu_torch.ops import quant_matmul as qm

_QUANT_DTYPES = {"W_q": torch.int8, "s_w": torch.float32,
                 "s_x": torch.float32, "W_q4": torch.uint8,
                 "s_g": torch.float32}


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
        keys = {0: ("W",), 8: ("W_q", "s_w", "s_x"),
                4: ("W_q4", "s_g")}[self.bits]
        tree = {k: getattr(self, k) for k in keys}
        if self.bias:
            tree["b"] = self.b
        return tree

    def adopt_leaves(self, leaves: Dict) -> None:
        """Switch to the form a param tree's leaf set names — float
        ``{W}``, int8 ``{W_q, s_w, s_x}`` or int4 ``{W_q4, s_g}`` (with
        ``b`` when the layer has a bias) — creating empty buffers of the
        right shapes for the loader to fill."""
        bits = 4 if "W_q4" in leaves else 8 if "W_q" in leaves else 0
        if bits == self.bits:
            return
        if bits == 0:
            raise ValueError(f"{self.name}: a quantized Dense cannot take "
                             "float weights back; rebuild the model")
        k, n = self.input_dim, self.output_dim
        want = {"W_q": (k, n), "s_w": (n,), "s_x": ()} if bits == 8 else \
            {"W_q4": ((k + 1) // 2, n), "s_g": None}
        dev = self.W.device
        for key, shape in want.items():
            if key not in leaves:
                raise KeyError(f"{self.name}: int{bits} leaves lack {key!r}")
            got = tuple(np.shape(leaves[key]))
            if key == "s_g":
                if len(got) != 2 or got[1] != n or not 1 <= got[0] <= k:
                    raise ValueError(f"{self.name}: s_g must be (G, {n}) "
                                     f"with 1 <= G <= {k}, got {got}")
                shape = got
            elif got != shape:
                raise ValueError(f"{self.name}: {key} must be {shape}, "
                                 f"got {got}")
            self.register_buffer(key, torch.empty(
                shape, dtype=_QUANT_DTYPES[key], device=dev))
        del self.W
        self.bits = bits

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
    """Inverted dropout: the identity in eval mode.  Training mode comes
    with the Estimator (the port's layers serve predict only so far)."""

    def __init__(self, p: float, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.p = float(p)

    def forward(self, x):
        if self.training and self.p > 0.0:
            raise NotImplementedError(
                "Dropout in training mode: ported with the Estimator "
                "(ROADMAP queue 1, item 6)")
        return x


class Flatten(Layer):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def compute_output_shape(self, input_shape):
        return (int(np.prod(to_shape(input_shape))),)
