"""Core layers — the JAX package's ``nn/layers/core.py``: Dense (float,
W8A8 and W4A16), Activation, Dropout, Flatten, Reshape, Permute,
RepeatVector, Squeeze, ExpandDim, Lambda, Embedding, Merge,
BatchNormalization, InputLayer, Select, Narrow, Masking, GaussianNoise and
GaussianDropout.  A ``dim`` of the shape layers counts the batch axis, as
in the JAX package; each layer's ``compute_output_shape`` is its rule for
the graph ``Model``.

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

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.nn import activations
from analytics_zoo_tpu_torch.nn.module import (Layer, dropout, generator,
                                               initializer, to_shape)
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
        # tensor-parallel form: ("column" | "row", axis, mesh, b held)
        self._tp = None
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

    def shard_leaves(self, specs, mesh):
        """Tensor-parallel form (``parallel/sharding``): ``W`` P(None, ax)
        column-parallel (each rank its output columns, gathered over the
        axis before the activation) or P(ax) row-parallel (each rank its
        input rows, summed over the axis); a float layer only."""
        from analytics_zoo_tpu_torch.parallel.sharding import (
            Layout, check_specs, column_axis, row_axis, take_shard)
        w = specs.get("W", ())
        col, row = column_axis(w), row_axis(w)
        if self.bits or (col is None and row is None):
            raise NotImplementedError(
                f"{self.name}: no parallel form of a "
                f"{'quantized ' if self.bits else ''}Dense computes on "
                f"this slice: {sorted((k, tuple(v)) for k, v in specs.items())}")
        ax = col or row
        check_specs(self, specs, {"W": {tuple(w)},
                                  "b": {(), (ax,)} if col else {()}})
        lays = {"W": Layout(1 if col else 0, ax, 1)}
        take_shard(self, "W", lays["W"], mesh)
        held_b = bool(self.bias and tuple(specs.get("b", ())))
        if held_b:
            lays["b"] = Layout(0, ax, 1)
            take_shard(self, "b", lays["b"], mesh)
        self._tp = ("column" if col else "row", ax, mesh, held_b)
        return lays

    def _parallel_forward(self, x):
        from analytics_zoo_tpu_torch.parallel import comm
        from analytics_zoo_tpu_torch.parallel.sharding import (
            Layout, held_or_sliced)
        kind, ax, mesh, held_b = self._tp
        if kind == "column":
            xw, W = dtypes.cast_compute(comm.copy_to(x, ax, mesh), self.W)
            y = dtypes.matmul(xw, W, dtypes.param_dtype())
            if self.bias:
                y = y + held_or_sliced(self.b, held_b, Layout(0, ax, 1),
                                       mesh)
            return self.activation(comm.all_gather(y, ax, -1, mesh))
        xs = held_or_sliced(x, False, Layout(x.ndim - 1, ax, 1), mesh)
        xw, W = dtypes.cast_compute(xs, self.W)
        y = comm.psum(dtypes.matmul(xw, W, dtypes.param_dtype()), ax, mesh)
        if self.bias:
            y = y + self.b
        return self.activation(y)

    def forward(self, x):
        if self._tp is not None:
            return self._parallel_forward(x)
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


def _axis(dim: int, rank: int) -> int:
    """``dim`` of a batched tensor of ``rank`` axes (negative from the
    end) as a non-negative axis; 0 is the batch axis."""
    ax = dim if dim >= 0 else rank + dim
    if not 0 <= ax < rank:
        raise ValueError(f"dim {dim} is out of range for rank {rank}")
    return ax


class Reshape(Layer):
    """``x.reshape((B,) + target_shape)``; one entry may be -1."""

    def __init__(self, target_shape, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.target_shape = tuple(int(d) for d in target_shape)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.target_shape)

    def compute_output_shape(self, input_shape):
        if -1 not in self.target_shape:
            return self.target_shape
        shape = to_shape(input_shape)
        known = int(np.prod([d for d in self.target_shape if d != -1]))
        fill = None if None in shape else int(np.prod(shape)) // known
        return tuple(fill if d == -1 else d for d in self.target_shape)


class Permute(Layer):
    """Permute the non-batch axes; ``dims`` are 1-indexed over them
    (Keras-1)."""

    def __init__(self, dims, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dims = tuple(int(d) for d in dims)

    def forward(self, x):
        return x.permute((0,) + self.dims)

    def compute_output_shape(self, input_shape):
        shape = to_shape(input_shape)
        return tuple(shape[d - 1] for d in self.dims)


class RepeatVector(Layer):
    """(B, D) -> (B, n, D)."""

    def __init__(self, n: int, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.n = int(n)

    def forward(self, x):
        return x.unsqueeze(1).repeat(1, self.n, 1)

    def compute_output_shape(self, input_shape):
        return (self.n,) + to_shape(input_shape)


class Squeeze(Layer):
    """Drop axis ``dim``, which must have size 1 (``jnp.squeeze``)."""

    def __init__(self, dim: int, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)

    def forward(self, x):
        ax = _axis(self.dim, x.ndim)
        if x.shape[ax] != 1:
            raise ValueError(f"{self.name}: cannot squeeze axis {ax} of "
                             f"size {x.shape[ax]}")
        return x.squeeze(ax)

    def compute_output_shape(self, input_shape):
        shape = to_shape(input_shape)
        ax = _axis(self.dim, len(shape) + 1) - 1
        return shape[:ax] + shape[ax + 1:]


class ExpandDim(Layer):
    """Insert a size-1 axis at ``dim`` (``jnp.expand_dims``)."""

    def __init__(self, dim: int, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dim = int(dim)

    def forward(self, x):
        return x.unsqueeze(self.dim)

    def compute_output_shape(self, input_shape):
        shape = to_shape(input_shape)
        ax = _axis(self.dim, len(shape) + 2) - 1
        return shape[:ax] + (1,) + shape[ax:]


class Lambda(Layer):
    """Wrap a tensor function (autograd Lambda, Lambda.scala:49-95): ``fn``
    takes a tensor, or a list of them for a multi-input node.  Its output
    shape is read from ``fn`` run on meta tensors of batch 1 (an unknown
    axis taken as 1), as the JAX package reads it with
    ``jax.eval_shape``."""

    def __init__(self, fn: Callable, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.fn = fn

    def forward(self, x):
        return self.fn(x)

    def compute_output_shape(self, input_shape):
        def meta(shape):
            dims = (1,) + tuple(1 if d is None else d
                                for d in to_shape(shape))
            return torch.empty(dims, device="meta")
        multi = isinstance(input_shape, list)
        y = self.fn([meta(s) for s in input_shape] if multi
                    else meta(input_shape))
        return tuple(y.shape[1:])


class Embedding(Layer):
    """Id -> vector lookup (keras/layers/Embedding.scala), with the JAX
    layer's ``jnp.take(E, x.astype(int32), axis=0)`` semantics:

    - a float id truncates toward zero (-0.5 -> 0, 3.99 -> 3), saturating
      at the int32 range, NaN -> 0;
    - an id in [-V, -1] wraps to the end of the table;
    - an id >= V or < -V gives a row of NaN, and no gradient: the lookup
      gathers a clamped id and the row is replaced after it.

    No device-side assert can fire, whatever the ids.  The table ``E``
    (input_dim, output_dim) is drawn by ``init`` (U(-0.05, 0.05) for
    "uniform")."""

    def __init__(self, input_dim: int, output_dim: int, init="uniform",
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.init_name = init
        # the table's shape follows from the hyper-parameters alone
        self.ensure_built(self._declared_input_shape)

    def build(self, input_shape):
        self.E = nn.Parameter(torch.empty(self.input_dim, self.output_dim))

    def reset_parameters(self, gen):
        self.E.copy_(initializer(self.init_name, gen, self.E.shape))

    def compute_output_shape(self, input_shape):
        return to_shape(input_shape) + (self.output_dim,)

    def _tree(self) -> Dict:
        return {"E": self.E}

    def shard_leaves(self, specs, mesh):
        """Vocab-parallel form: ``E``'s rows split over an axis, looked up
        where a rank holds them and summed over it."""
        from analytics_zoo_tpu_torch.parallel.sharding import (
            Layout, check_specs, row_axis, take_shard)
        ax = row_axis(specs.get("E", ()))
        check_specs(self, specs, {"E": {(ax,)}})
        take_shard(self, "E", Layout(0, ax, 1), mesh)
        self._tp = (ax, mesh)
        return {"E": Layout(0, ax, 1)}

    def forward(self, x):
        tp = getattr(self, "_tp", None)
        if tp is None:
            return lookup(self.E, x)
        from analytics_zoo_tpu_torch.parallel.sharding import \
            vocab_parallel_rows
        ids, valid = lookup_ids(x, self.input_dim)
        return vocab_parallel_rows(self.E, ids, valid, *tp)


def lookup_ids(x: torch.Tensor, n: int):
    """``lookup``'s ids over a table of ``n`` rows: (wrapped int64 ids,
    their validity)."""
    if x.is_floating_point():
        x = torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31)
    ids = x.to(torch.int64)
    ids = torch.where(ids < 0, ids + n, ids)
    return ids, (ids >= 0) & (ids < n)


def lookup(E: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rows of the table ``E`` (V, D) at the ids ``x`` with the JAX
    ``jnp.take(E, x.astype(int32), axis=0)`` semantics ``Embedding``
    documents: float ids truncate (NaN -> 0), ids in [-V, -1] wrap, any
    other id gives a row of NaN and no gradient."""
    ids, valid = lookup_ids(x, E.shape[0])
    rows = F.embedding(torch.where(valid, ids, 0), E)
    return torch.where(valid.unsqueeze(-1), rows, float("nan"))


class Merge(Layer):
    """Multi-input merge (keras/layers/Merge): modes sum, mul, ave, sub,
    max, min, concat, dot, cos, over a list of inputs, left to right as the
    JAX package folds them.  ``layers``: branch layers (each declaring its
    input shape), the i-th applied to the i-th input before the merge; the
    param and state trees are ``{branch name: subtree}``, as in JAX."""

    def __init__(self, layers=None, mode="sum", concat_axis=-1,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.mode = mode
        self.concat_axis = int(concat_axis)
        self.branches = nn.ModuleList(layers or [])
        if len(self.branches):
            shapes = [b._declared_input_shape for b in self.branches]
            if any(s is None for s in shapes):
                raise ValueError(f"{self.name}: every branch layer needs "
                                 "input_shape=")
            self._declared_input_shape = shapes
            for b, s in zip(self.branches, shapes):
                b.ensure_built(s)
            self.built = True

    def reset_parameters(self, gen):
        for b in self.branches:
            b.reset_parameters(gen)

    def _tree(self) -> Dict:
        return {b.name: b for b in self.branches}

    def _state_tree(self) -> Dict:
        return {b.name: b for b in self.branches}

    def _axis(self, rank: int) -> int:
        """``concat_axis`` of a batched tensor of ``rank`` as an index into
        a shape without the batch axis."""
        return self.concat_axis - 1 if self.concat_axis > 0 \
            else rank - 1 + self.concat_axis

    def compute_output_shape(self, input_shape):
        shapes = [to_shape(s) for s in input_shape]
        if len(self.branches):
            shapes = [to_shape(b.compute_output_shape(s))
                      for b, s in zip(self.branches, shapes)]
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
        xs = list(xs)
        if len(self.branches):
            xs = [b(x) for b, x in zip(self.branches, xs)]
        return self._merge(xs)


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


class InputLayer(Layer):
    """Identity placeholder for ``Sequential`` (keras InputLayer)."""

    _is_source = True

    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)

    def forward(self, x):
        return x


class Select(Layer):
    """Take index ``index`` of axis ``dim`` and drop the axis
    (zoo keras/layers/Select.scala; ``lax.index_in_dim``)."""

    def __init__(self, dim: int, index: int, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dim, self.index = int(dim), int(index)

    def forward(self, x):
        return x.select(_axis(self.dim, x.ndim), self.index)

    def compute_output_shape(self, input_shape):
        shape = to_shape(input_shape)
        ax = _axis(self.dim, len(shape) + 1) - 1
        return shape[:ax] + shape[ax + 1:]


class Narrow(Layer):
    """``length`` entries of axis ``dim`` from ``offset`` (Narrow.scala;
    ``lax.slice_in_dim``, a negative offset counted from the end)."""

    def __init__(self, dim: int, offset: int, length: int = 1,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dim, self.offset, self.length = int(dim), int(offset), \
            int(length)

    def forward(self, x):
        ax = _axis(self.dim, x.ndim)
        start = self.offset + x.shape[ax] if self.offset < 0 \
            else self.offset
        return x.narrow(ax, start, self.length)

    def compute_output_shape(self, input_shape):
        shape = list(to_shape(input_shape))
        shape[_axis(self.dim, len(shape) + 1) - 1] = self.length
        return tuple(shape)


class Masking(Layer):
    """Zero the timesteps (last-axis vectors) equal to ``mask_value``
    everywhere (keras Masking)."""

    def __init__(self, mask_value=0.0, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.mask_value = mask_value

    def forward(self, x):
        keep = (x != self.mask_value).any(dim=-1, keepdim=True)
        return torch.where(keep, x, 0.0).to(x.dtype)


class GaussianNoise(Layer):
    """``x + sigma·N(0, 1)`` in training mode with a seed
    (``Layer.seed_dropout``), else the identity.  The draws come from the
    layer's generator, so they match the JAX layer's in distribution, not
    value by value."""

    def __init__(self, sigma: float, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.sigma = float(sigma)

    def forward(self, x):
        seed = self.train_seed()
        if seed is None:
            return x
        noise = torch.randn(x.shape, generator=generator(seed, x.device),
                            device=x.device, dtype=x.dtype)
        return x + self.sigma * noise


class GaussianDropout(Layer):
    """``x·(1 + sqrt(p / (1 - p))·N(0, 1))`` in training mode with a seed,
    else the identity; drawn as ``GaussianNoise`` is."""

    def __init__(self, p: float, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.p = float(p)

    def forward(self, x):
        seed = self.train_seed()
        if seed is None or self.p <= 0:
            return x
        std = float(np.sqrt(self.p / (1.0 - self.p)))
        noise = torch.randn(x.shape, generator=generator(seed, x.device),
                            device=x.device, dtype=x.dtype)
        return x * (1.0 + std * noise)
