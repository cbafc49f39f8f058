"""Recurrent layers — the JAX package's ``nn/layers/recurrent.py``:
SimpleRNN, LSTM, GRU (both reset conventions), Bidirectional,
TimeDistributed, ConvLSTM2D / ConvLSTM3D and Highway.

Inputs are batch-first, (B, T, D) (ConvLSTM: (B, T, *spatial, C),
channels last).  The JAX package runs the recurrence under ``lax.scan``;
here it is a Python loop over the T steps.  The input projection does not
depend on the carry, so it is computed once for all B·T rows before the
loop (ConvLSTM: one input convolution over all B·T frames); the
recurrent product stays inside the loop.  The gate matmuls are
``torch.matmul`` and the ConvLSTM gates ``F.conv2d`` / ``F.conv3d`` in
f32: the JAX package leaves all of them to XLA, outside any Pallas
kernel.

Parameters keep the JAX layout and names: ``Wx`` (D, G·H), ``Wh`` (H,
G·H), ``b`` (G·H,) with the gates in the JAX order (LSTM i, f, g, o; GRU
z, r, h), plus ``br`` (G·H,) for ``GRU(reset_after=True)``;
Bidirectional ``{fwd, bwd}``; TimeDistributed ``{inner}`` (and its state
``{inner}``); ConvLSTM ``Wx`` (k…, C, 4F), ``Wh`` (k…, F, 4F), ``b``;
Highway ``{W, Wt, b, bt}``.
"""

from __future__ import annotations

import copy
import zlib
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.nn import activations
from analytics_zoo_tpu_torch.nn.module import Layer, initializer, to_shape


def matmul_f32(x, W):
    """``x @ W`` in f32 under the dtype policy (the JAX
    ``matmul(..., preferred_element_type=float32)``)."""
    xw, Ww = dtypes.cast_compute(x, W)
    return dtypes.matmul(xw, Ww, torch.float32)


class _RNNBase(Layer):
    """The recurrence shared by SimpleRNN, LSTM and GRU.  Subclasses give
    ``n_gates``, the zero carry and one step ``_step(xz_t, carry) ->
    (carry, h)`` over the hoisted input projection ``xz_t``."""

    n_gates = 1

    def __init__(self, output_dim: int, activation="tanh",
                 inner_activation="hard_sigmoid",
                 return_sequences: bool = False, go_backwards: bool = False,
                 init="glorot_uniform", inner_init="orthogonal",
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = int(output_dim)
        self.activation = activations.get(activation)
        self.inner_activation = activations.get(inner_activation)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.init_name = init
        self.inner_init_name = inner_init
        self._build_declared()

    def build(self, input_shape):
        _, d = to_shape(input_shape)
        self.input_dim = int(d)
        gh = self.n_gates * self.output_dim
        self.Wx = nn.Parameter(torch.empty(self.input_dim, gh))
        self.Wh = nn.Parameter(torch.empty(self.output_dim, gh))
        self.b = nn.Parameter(torch.zeros(gh))

    def reset_parameters(self, gen):
        h = self.output_dim
        self.Wx.copy_(initializer(self.init_name, gen, self.Wx.shape,
                                  fan_in=self.input_dim, fan_out=h))
        self.Wh.copy_(initializer(self.inner_init_name, gen, self.Wh.shape,
                                  fan_in=h, fan_out=h))
        self.b.zero_()

    def compute_output_shape(self, input_shape):
        t = to_shape(input_shape)[0]
        return (t, self.output_dim) if self.return_sequences \
            else (self.output_dim,)

    def _tree(self) -> Dict:
        return {"Wx": self.Wx, "Wh": self.Wh, "b": self.b}

    def _init_carry(self, x):
        return x.new_zeros((x.shape[0], self.output_dim),
                           dtype=torch.float32)

    def _project(self, x):
        """The input projection of every step: (B, T, G·H)."""
        return matmul_f32(x, self.Wx)

    def _step(self, xz_t, carry):
        raise NotImplementedError

    def forward(self, x):
        xz = self._project(x)
        steps = range(x.shape[1])
        if self.go_backwards:
            steps = reversed(steps)
        carry = self._init_carry(x)
        ys: List[torch.Tensor] = []
        for t in steps:
            carry, h = self._step(xz[:, t], carry)
            ys.append(h)
        if not self.return_sequences:
            return ys[-1]
        if self.go_backwards:
            ys.reverse()
        return torch.stack(ys, dim=1)


class SimpleRNN(_RNNBase):
    n_gates = 1

    def _step(self, xz_t, h):
        h_new = self.activation(xz_t + matmul_f32(h, self.Wh) + self.b)
        return h_new, h_new


class LSTM(_RNNBase):
    n_gates = 4

    def _init_carry(self, x):
        z = super()._init_carry(x)
        return (z, z)

    def _step(self, xz_t, carry):
        h, c = carry
        H = self.output_dim
        z = xz_t + matmul_f32(h, self.Wh) + self.b
        i = self.inner_activation(z[:, :H])
        f = self.inner_activation(z[:, H:2 * H])
        g = self.activation(z[:, 2 * H:3 * H])
        o = self.inner_activation(z[:, 3 * H:])
        c_new = f * c + i * g
        h_new = o * self.activation(c_new)
        return (h_new, c_new), h_new


class GRU(_RNNBase):
    """GRU in both reset conventions (the JAX layer's):

    - ``reset_after=False`` (Keras-1 / BigDL): the reset gate multiplies h
      BEFORE the candidate's recurrent matmul, ``(r·h) @ Wh[:, 2H:]``; one
      bias ``b``;
    - ``reset_after=True`` (tf.keras / CuDNN): it multiplies the candidate's
      recurrent projection AFTER the matmul, ``r·(h @ Wh[:, 2H:] + br)``,
      with the separate recurrent bias ``br``."""

    n_gates = 3

    def __init__(self, output_dim, reset_after: bool = False, **kwargs):
        self.reset_after = bool(reset_after)
        super().__init__(output_dim, **kwargs)

    def build(self, input_shape):
        super().build(input_shape)
        if self.reset_after:
            self.br = nn.Parameter(torch.zeros(3 * self.output_dim))

    def reset_parameters(self, gen):
        super().reset_parameters(gen)
        if self.reset_after:
            self.br.zero_()

    def _tree(self) -> Dict:
        tree = super()._tree()
        if self.reset_after:
            tree["br"] = self.br
        return tree

    def _project(self, x):
        return super()._project(x) + self.b

    def _step(self, xz, h):
        H = self.output_dim
        if self.reset_after:
            hz = matmul_f32(h, self.Wh) + self.br
            z = self.inner_activation(xz[:, :H] + hz[:, :H])
            r = self.inner_activation(xz[:, H:2 * H] + hz[:, H:2 * H])
            hh = self.activation(xz[:, 2 * H:] + r * hz[:, 2 * H:])
        else:
            hz = matmul_f32(h, self.Wh[:, :2 * H])
            z = self.inner_activation(xz[:, :H] + hz[:, :H])
            r = self.inner_activation(xz[:, H:2 * H] + hz[:, H:2 * H])
            hh = self.activation(xz[:, 2 * H:]
                                 + matmul_f32(r * h, self.Wh[:, 2 * H:]))
        h_new = z * h + (1 - z) * hh
        return h_new, h_new


class Bidirectional(Layer):
    """A recurrent layer run forward and, as a deep copy named
    ``<name>_bwd`` with ``go_backwards`` flipped, backward
    (Bidirectional.scala); merged by ``concat``, ``sum``, ``mul`` or
    ``ave``."""

    def __init__(self, layer: _RNNBase, merge_mode: str = "concat",
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        if merge_mode not in ("concat", "sum", "mul", "ave"):
            raise ValueError(f"unknown merge_mode {merge_mode!r}")
        self.forward_layer = layer
        self.backward_layer = copy.deepcopy(layer)
        self.backward_layer.name = layer.name + "_bwd"
        self.backward_layer.go_backwards = not layer.go_backwards
        if self.backward_layer.built:
            # a built copy would start from the forward layer's values
            with torch.no_grad():
                self.backward_layer.reset_parameters(
                    torch.Generator().manual_seed(
                        zlib.crc32(self.backward_layer.name.encode())))
        self.merge_mode = merge_mode
        self._build_declared()

    def build(self, input_shape):
        self.forward_layer.ensure_built(input_shape)
        self.backward_layer.ensure_built(input_shape)

    def reset_parameters(self, gen):
        self.forward_layer.reset_parameters(gen)
        self.backward_layer.reset_parameters(gen)

    def compute_output_shape(self, input_shape):
        out = self.forward_layer.compute_output_shape(input_shape)
        if self.merge_mode == "concat":
            return out[:-1] + (2 * out[-1],)
        return out

    def _tree(self) -> Dict:
        return {"fwd": self.forward_layer, "bwd": self.backward_layer}

    def forward(self, x):
        yf = self.forward_layer(x)
        yb = self.backward_layer(x)
        if self.merge_mode == "concat":
            return torch.cat([yf, yb], dim=-1)
        if self.merge_mode == "sum":
            return yf + yb
        if self.merge_mode == "mul":
            return yf * yb
        return (yf + yb) / 2.0


class TimeDistributed(Layer):
    """An inner layer applied to every timestep (TimeDistributed.scala):
    B·T flattened into the batch, one call of the inner layer, reshaped
    back.  The inner layer's state (BatchNormalization's moving
    statistics) is its own, updated in training mode by that one call."""

    def __init__(self, layer: Layer, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.inner = layer
        self._build_declared()

    def build(self, input_shape):
        self.inner.ensure_built(to_shape(input_shape)[1:])

    def reset_parameters(self, gen):
        self.inner.reset_parameters(gen)

    def compute_output_shape(self, input_shape):
        shape = to_shape(input_shape)
        return shape[:1] + to_shape(
            self.inner.compute_output_shape(shape[1:]))

    def _tree(self) -> Dict:
        return {"inner": self.inner}

    def _state_tree(self) -> Dict:
        return {"inner": self.inner}

    def forward(self, x):
        B, T = x.shape[0], x.shape[1]
        y = self.inner(x.reshape((B * T,) + tuple(x.shape[2:])))
        return y.reshape((B, T) + tuple(y.shape[1:]))


def _same_pads(k: int, ndim: int) -> tuple:
    """``F.pad`` widths of XLA's SAME for a stride-1 kernel of ``k``: the
    odd pad of an even kernel goes at the end."""
    lo = (k - 1) // 2
    return (lo, k - 1 - lo) * ndim


class _ConvLSTMND(Layer):
    """Convolutional LSTM core (ConvLSTM2D / ConvLSTM3D.scala): the gates
    are rank-``ndim`` convolutions over channels-last input (B, T,
    *spatial, C).  ``border_mode`` applies to the INPUT convolution (the
    spatial dims shrink under ``valid``); the recurrent convolution on the
    state is always SAME, so the state keeps its shape."""

    ndim = 2

    def __init__(self, nb_filter: int, nb_kernel: int,
                 return_sequences=False, border_mode="same",
                 inner_activation="hard_sigmoid", activation="tanh",
                 init="glorot_uniform", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter = int(nb_filter)
        self.k = int(nb_kernel)
        self.return_sequences = return_sequences
        self.border_mode = border_mode
        self.inner_activation = activations.get(inner_activation)
        self.activation = activations.get(activation)
        self.init_name = init
        self._build_declared()

    @property
    def _same(self) -> bool:
        return self.border_mode in ("same", "SAME")

    def build(self, input_shape):
        shape = to_shape(input_shape)          # (T, *spatial, C)
        self.channels = int(shape[-1])
        kk = (self.k,) * self.ndim
        F4 = 4 * self.nb_filter
        self.Wx = nn.Parameter(torch.empty(kk + (self.channels, F4)))
        self.Wh = nn.Parameter(torch.empty(kk + (self.nb_filter, F4)))
        self.b = nn.Parameter(torch.zeros(F4))

    def reset_parameters(self, gen):
        kn = self.k ** self.ndim
        F_ = self.nb_filter
        self.Wx.copy_(initializer(self.init_name, gen, self.Wx.shape,
                                  fan_in=kn * self.channels, fan_out=kn * F_))
        self.Wh.copy_(initializer(self.init_name, gen, self.Wh.shape,
                                  fan_in=kn * F_, fan_out=kn * F_))
        self.b.zero_()

    def compute_output_shape(self, input_shape):
        shape = to_shape(input_shape)
        spatial = tuple(s if self._same or s is None else s - self.k + 1
                        for s in shape[1:-1])
        out = spatial + (self.nb_filter,)
        return (shape[0],) + out if self.return_sequences else out

    def _tree(self) -> Dict:
        return {"Wx": self.Wx, "Wh": self.Wh, "b": self.b}

    def _conv(self, x, W, same: bool):
        """Channels-first ``x`` (N, C, *spatial) against a JAX-layout
        kernel (k…, C, O), summed in f32."""
        w = W.permute((self.ndim + 1, self.ndim) + tuple(range(self.ndim)))
        xw, ww = dtypes.cast_compute(x, w)
        if same:
            xw = F.pad(xw, _same_pads(self.k, self.ndim))
        conv = F.conv2d if self.ndim == 2 else F.conv3d
        return conv(xw.to(torch.float32), ww.to(torch.float32))

    def forward(self, x):
        B, T = x.shape[0], x.shape[1]
        F_ = self.nb_filter
        nd = self.ndim
        # (B, T, *spatial, C) -> (B·T, C, *spatial): one input convolution
        # over every frame
        frames = x.reshape((B * T,) + tuple(x.shape[2:])).permute(
            (0, nd + 1) + tuple(range(1, nd + 1)))
        xz = self._conv(frames, self.Wx, self._same)
        xz = xz.reshape((B, T) + tuple(xz.shape[1:]))
        bias = self.b.reshape((1, 4 * F_) + (1,) * nd)
        h = x.new_zeros((B, F_) + tuple(xz.shape[3:]), dtype=torch.float32)
        c = h
        ys = []
        for t in range(T):
            z = xz[:, t] + self._conv(h, self.Wh, True) + bias
            i = self.inner_activation(z[:, :F_])
            f = self.inner_activation(z[:, F_:2 * F_])
            g = self.activation(z[:, 2 * F_:3 * F_])
            o = self.inner_activation(z[:, 3 * F_:])
            c = f * c + i * g
            h = o * self.activation(c)
            ys.append(h)
        last = (0,) + tuple(range(2, nd + 2)) + (1,)
        if not self.return_sequences:
            return ys[-1].permute(last)
        return torch.stack(ys, dim=1).permute(
            (0, 1) + tuple(range(3, nd + 3)) + (2,))


class ConvLSTM2D(_ConvLSTMND):
    """Convolutional LSTM with 2-D convolution gates: input (B, T, H, W,
    C), channels last."""

    ndim = 2


class ConvLSTM3D(_ConvLSTMND):
    """Convolutional LSTM with 3-D convolution gates: input (B, T, D, H,
    W, C), channels last."""

    ndim = 3


class Highway(Layer):
    """Highway layer (Highway.scala): ``y = t·act(x W + b) + (1 - t)·x``
    with the transform gate ``t = sigmoid(x Wt + bt)``; ``bt`` starts at
    -2."""

    def __init__(self, activation="tanh", bias=True, init="glorot_uniform",
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.activation = activations.get(activation)
        self.bias = bias
        self.init_name = init
        self._build_declared()

    def build(self, input_shape):
        d = to_shape(input_shape)[-1]
        self.W = nn.Parameter(torch.empty(d, d))
        self.Wt = nn.Parameter(torch.empty(d, d))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(d))
            self.bt = nn.Parameter(torch.full((d,), -2.0))

    def reset_parameters(self, gen):
        self.W.copy_(initializer(self.init_name, gen, self.W.shape))
        self.Wt.copy_(initializer(self.init_name, gen, self.Wt.shape))
        if self.bias:
            self.b.zero_()
            self.bt.fill_(-2.0)

    def _tree(self) -> Dict:
        tree = {"W": self.W, "Wt": self.Wt}
        if self.bias:
            tree.update(b=self.b, bt=self.bt)
        return tree

    def forward(self, x):
        h = matmul_f32(x, self.W)
        t = matmul_f32(x, self.Wt)
        if self.bias:
            h = h + self.b
            t = t + self.bt
        t = torch.sigmoid(t)
        return t * self.activation(h) + (1.0 - t) * x
