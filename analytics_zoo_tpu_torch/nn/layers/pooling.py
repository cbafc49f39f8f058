"""Global pooling over the sequence axis (the JAX package's
``nn/layers/pooling.py`` ``_GlobalPool`` family, 1-D).  ``dim_ordering``
"tf" pools axis 1 of (B, T, C); "th" pools axis 2 of (B, C, T)."""

from __future__ import annotations

from analytics_zoo_tpu_torch.nn.module import Layer, to_shape


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
