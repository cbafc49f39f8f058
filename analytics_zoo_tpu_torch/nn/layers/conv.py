"""Convolutions and the shape layers around them — the JAX package's
``nn/layers/conv.py``: ``_ConvND`` (:44) with ``Convolution1D`` /
``2D`` / ``3D``, ``AtrousConvolution1D`` / ``2D`` and
``ShareConvolution2D``; ``Deconvolution2D`` (:167),
``SeparableConvolution2D`` (:226), ``DepthwiseConvolution2D`` (:285),
``LocallyConnected1D`` / ``2D``, ``ZeroPadding1D`` / ``2D`` / ``3D``,
``Cropping1D`` / ``2D`` / ``3D``, ``UpSampling1D`` / ``2D`` / ``3D``,
``SpaceToDepth`` with ``stem_7x7_to_s2d``, ``ResizeBilinear`` and
``LRN2D``.

Activations stay NHWC (``dim_ordering="tf"``, the JAX layout) and the
weight stays ``W`` (kh, kw, cin/groups, cout) (3-D: (kd, kh, kw, ...)),
so ``load_jax_params`` copies it as it is.  The convolution itself is
``F.conv2d`` (``F.conv3d``) on an NCHW view of the NHWC tensor — a
channels_last tensor to PyTorch, which cuDNN takes without a copy — and
the output goes back to NHWC as a view.  The JAX package runs these
convolutions through ``lax.conv_general_dilated``, outside any Pallas
kernel; the depthwise and separable convolutions are grouped convolutions
there and here, ``Deconvolution2D`` is ``F.conv_transpose2d`` cropped to
the JAX layer's fractionally-strided geometry.

Padding is explicit, as XLA computes it: ``"same"`` pads each spatial
axis by ``max((ceil(i/s) - 1)·s + (k - 1)·d + 1 - i, 0)`` split with the
smaller half first, which is asymmetric at stride 2 on even sizes (the
7×7/s2 stem on 224 pads (2, 3), a 3×3/s2 conv (0, 1)) and for an even
1-D kernel (k = 4 pads (1, 2)); ``F.conv2d``'s own ``"same"`` refuses
strides and its integer padding is symmetric.

A 1-D convolution keeps the JAX leaf shapes, ``W`` / ``W_q`` (k, cin/g,
cout) and ``W_q4`` (ceil(k·cin/g / 2), cout), and runs as the (1, k)
convolution of (B, 1, T, C): a view of its input and of its weight, so
the float path is one ``F.conv2d`` and the int8 path one ``w8a8_conv2d``
launch, at a one-row geometry.

A 1×1, stride-1 conv whose only consumer is a ``BatchNormalization`` runs,
in training, through ``fused_bn_forward``: the product and the BN
statistics in one kernel (``ops/fused_bn.py``), chosen by the graph
``Model``'s fusion plan.

Quantized, a conv holds the quantizer's leaves as buffers, as ``Dense``
does: int8 (W8A8) ``W_q`` (kh, kw, cin/groups, cout) int8, ``s_w`` (cout,)
f32, ``s_x`` () f32, optional ``b``; int4 (W4A16) ``W_q4`` (ceil(K/2),
cout) uint8 nibble-packed over K = kh·kw·cin/groups, ``s_g`` (G, cout)
f32, optional ``b``.  int8 quantizes the activation as
``clamp(round(x / s_x), -127, 127)`` and runs ``ops/quant_matmul.w8a8_conv``
with the scale ``s_x · s_w`` (a pointwise conv on the ``w8a8`` matmul
kernel, a spatial one on the ``w8a8_conv2d`` kernel); int4 runs
``w4a16_conv``; a 3-D int8 conv runs on the same ``w8a8_conv2d`` kernel,
its depth taps gathered into the channels (``quant_matmul.w8a8_conv3d``).
The bias is added after, then the activation, as in the JAX package's
``_ConvND.call``.  A spatial int8 conv on the card also keeps
``W_q``'s K-major pack for the ``w8a8_conv2d`` kernel
(``quant_matmul.pack_conv_weight``): built at its first forward (a
warm-up's), again only when ``W_q`` is replaced or written, and held beside
the leaves, not among them.  A float conv becomes quantized when
``utils/convert.load_jax_params`` loads a quantized leaf set into it.  As
in the JAX package, only the ``_ConvND`` family quantizes: the depthwise,
separable, transposed and locally connected layers stay float.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.nn import activations
from analytics_zoo_tpu_torch.nn.layers.core import QUANT_KEYS, adopt_quantized
from analytics_zoo_tpu_torch.nn.module import Layer, initializer, to_shape
from analytics_zoo_tpu_torch.ops import fused_bn as fb
from analytics_zoo_tpu_torch.ops import quant_matmul as qm


def _pair(v, n=2):
    if isinstance(v, (tuple, list)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def same_pads(size: Optional[int], k: int, s: int, d: int = 1):
    """XLA's SAME padding of one spatial axis: (lo, hi), lo = total // 2."""
    if size is None:
        raise ValueError("'same' padding needs a known spatial size")
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def conv_pads(border_mode, sizes, kernel, strides, dilation):
    """Per-spatial-axis (lo, hi) pads: ``"same"``, ``"valid"``, or
    caffe-style explicit padding (an int for every axis, or one int per
    axis), as the JAX ``_pad_str``."""
    n = len(kernel)
    if isinstance(border_mode, int):
        return [(border_mode, border_mode)] * n
    if isinstance(border_mode, (tuple, list)):
        return [(int(p), int(p)) for p in border_mode]
    if border_mode in ("same", "SAME"):
        return [same_pads(i, k, s, d) for i, k, s, d
                in zip(sizes, kernel, strides, dilation)]
    if border_mode in ("valid", "VALID"):
        return [(0, 0)] * n
    raise ValueError(f"unknown border_mode {border_mode!r}")


def _out_size(size, k, s, d, pads):
    if size is None:
        return None
    return (size + pads[0] + pads[1] - (k - 1) * d - 1) // s + 1


def pad_spatial(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Pad the spatial axes of a channels-last (B, *spatial, C) tensor by
    ``pads`` [(lo, hi), ...] with ``value``; a no-op for zero pads."""
    if not any(lo or hi for lo, hi in pads):
        return x
    flat = [0, 0]                         # channels
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, *spatial, C) -> a (B, C, *spatial) view (channels_last)."""
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, *range(2, x.ndim), 1)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """An HWIO-family weight (*k, cin, cout) as PyTorch's (cout, cin, *k)
    view."""
    n = w.ndim - 2
    return w.permute(n + 1, n, *range(n))


_CONV = {2: F.conv2d, 3: F.conv3d}


class _ConvND(Layer):
    """Shared core of the spatial convolutions, NHWC-family layouts."""

    ndim = 2

    def __init__(self, nb_filter: int, kernel_size, activation=None,
                 border_mode="valid", subsample=1, dilation=1,
                 init="glorot_uniform", bias: bool = True,
                 dim_ordering: str = "tf", groups: int = 1,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter = int(nb_filter)
        self.kernel_size = _pair(kernel_size, self.ndim)
        self.activation = activations.get(activation)
        self.linear = activation in (None, "linear")
        self.border_mode = border_mode
        self.subsample = _pair(subsample, self.ndim)
        self.dilation = _pair(dilation, self.ndim)
        self.init_name = init
        self.bias = bias
        self.dim_ordering = dim_ordering
        if groups != int(groups) or int(groups) < 1:
            raise ValueError(f"groups must be a positive integer, got "
                             f"{groups}")
        self.groups = int(groups)
        self.bits = 0            # 0 float, 8 W8A8, 4 W4A16
        # the fused 1x1-conv + BN-statistics route and the quantized convs:
        # the kernels or their plain versions (ops/_impl)
        self.impl: Optional[str] = None
        self._build_declared()

    def _split(self, input_shape):
        """(spatial sizes, channels) of a batch-less input shape."""
        s = to_shape(input_shape)
        if self.dim_ordering == "th":
            return s[1:], s[0]
        return s[:-1], s[-1]

    def build(self, input_shape):
        _, cin = self._split(input_shape)
        if cin % self.groups or self.nb_filter % self.groups:
            raise ValueError(
                f"groups={self.groups} must divide both in-channels ({cin}) "
                f"and nb_filter ({self.nb_filter})")
        # (kh, kw, cin/groups, cout): W's shape, and W_q's when quantized
        self.kshape = self.kernel_size + (cin // self.groups, self.nb_filter)
        self.W = nn.Parameter(torch.empty(self.kshape))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(self.nb_filter))

    def reset_parameters(self, gen):
        ksize = 1
        for k in self.kernel_size:
            ksize *= k
        if self.bits == 0:
            self.W.copy_(initializer(self.init_name, gen, self.W.shape,
                                     fan_in=ksize * self.W.shape[-2],
                                     fan_out=ksize * self.nb_filter))
        if self.bias:
            self.b.zero_()

    def _tree(self) -> Dict:
        tree = {k: getattr(self, k) for k in QUANT_KEYS[self.bits]}
        if self.bias:
            tree["b"] = self.b
        return tree

    def adopt_leaves(self, leaves: Dict) -> None:
        """Switch to the form a param tree's leaf set names: float ``{W}``,
        int8 ``{W_q, s_w, s_x}`` (``W_q`` shaped as ``W``) or int4
        ``{W_q4, s_g}`` over K = kh·kw·cin/groups
        (``core.adopt_quantized``)."""
        adopt_quantized(self, leaves, self.kshape,
                        int(np.prod(self.kshape[:-1])), self.nb_filter)

    def _pads(self, sizes):
        return conv_pads(self.border_mode, sizes, self.kernel_size,
                         self.subsample, self.dilation)

    def _geometry(self):
        """The weight's shape, strides and dilation of the convolution this
        layer runs: its own (2-D, 3-D), or for a 1-D layer the (1, k) 2-D
        convolution's."""
        one = (1,) if self.ndim == 1 else ()
        return one + self.kshape, one + self.subsample, one + self.dilation

    def _lifted(self, x, pads):
        """``x`` (B, *spatial, C) and ``pads`` as the convolution of
        ``_geometry`` takes them: as they are, or for a 1-D layer (B, 1,
        T, C) and the row axis unpadded."""
        if self.ndim != 1:
            return x, list(pads)
        return x.unsqueeze(1), [(0, 0)] + list(pads)

    def compute_output_shape(self, input_shape):
        sizes, _ = self._split(input_shape)
        out = tuple(_out_size(i, k, s, d, p) for i, k, s, d, p in zip(
            sizes, self.kernel_size, self.subsample, self.dilation,
            self._pads(sizes)))
        if self.dim_ordering == "th":
            return (self.nb_filter,) + out
        return out + (self.nb_filter,)

    def fusable_with_bn(self) -> bool:
        """A pointwise conv the fused route computes exactly: 1×1, stride
        1, dilation 1, one group, no padding, no bias, linear activation,
        channels last, float weights."""
        ones = (1,) * self.ndim
        pads = self._pads((1,) * self.ndim)
        return (self.bits == 0 and self.kernel_size == ones
                and self.subsample == ones
                and self.dilation == ones and self.groups == 1
                and not any(lo or hi for lo, hi in pads)
                and not self.bias and self.linear
                and self.dim_ordering == "tf")

    def fused_bn_forward(self, x):
        """Training-mode conv for a following ``BatchNormalization``: ``y``
        (NHWC) and the f32 sums ``(Σy, Σy², rows)`` over every axis but
        the channels, from one ``ops/fused_bn.fused_bn`` call on the
        (rows, cin) view of ``x``.  Only for ``fusable_with_bn()``."""
        xw, W = dtypes.cast_compute(x, self.W)
        cin = x.shape[-1]
        y, stats = fb.fused_bn(xw.reshape(-1, cin),
                               W.reshape(cin, self.nb_filter),
                               impl=self.impl)
        return (y.reshape(x.shape[:-1] + (self.nb_filter,)),
                (stats[0], stats[1], y.shape[0]))

    def _quantized(self, x, pads):
        """The W8A8 / W4A16 conv of NHWC ``x`` with ``pads`` (the
        convolution of ``_lifted``) through the fused-dequant entry points
        of ``ops/quant_matmul.py``."""
        kshape, strides, dilation = self._geometry()
        kw = dict(window_strides=strides, padding=pads,
                  rhs_dilation=dilation, feature_group_count=self.groups,
                  impl=self.impl)
        if self.bits == 4:
            y = qm.w4a16_conv(x.to(torch.float32), self.W_q4, self.s_g,
                              kshape, **kw)
        else:
            xq = torch.clamp(torch.round(x.to(torch.float32) / self.s_x),
                             -127, 127).to(torch.int8)
            y = qm.w8a8_conv(xq, self.W_q.view(kshape), self.s_x * self.s_w,
                             w_pack=self._w8_pack(xq, pads), **kw)
        if self.bias:
            y = y + self.b
        return self.activation(y.to(dtypes.param_dtype()))

    def _w8_pack(self, xq, pads):
        """``W_q``'s pack (of its 2-D view; for a 3-D conv, of its view with
        the depth taps folded into the channels) for the kernel route of a
        spatial conv (None on the plain route and for a pointwise conv),
        kept while ``W_q`` is the same tensor at the same version: a new
        ``W_q`` or an in-place write to it rebuilds the pack.  An inference
        tensor counts no versions, so its pack is made on every call.
        ``pads``: the convolution's."""
        kshape, strides, dilation = self._geometry()
        if not xq.is_cuda or self.impl == "torch" or qm._is_pointwise(
                kshape, strides, dilation, self.groups, pads):
            return None

        def pack(w):
            w = w.view(kshape)
            if self.ndim == 3:
                w = qm.fold_depth_weight(w)
            return qm.pack_conv_weight(w, self.groups)
        w = self.W_q
        if w.is_inference():
            return pack(w)
        cached = getattr(self, "_pack", None)
        if cached is None or cached[0] is not w or cached[1] != w._version:
            cached = (w, w._version, pack(w))
            self._pack = cached
        return cached[2]

    def forward(self, x):
        if self.dim_ordering == "th":
            x = nchw_to_nhwc(x)
        x2, pads = self._lifted(x, self._pads(x.shape[1:-1]))
        if self.bits:
            y = self._quantized(x2, pads)
        else:
            kshape, strides, dilation = self._geometry()
            xw, W = dtypes.cast_compute(x2, self.W)
            out_dt = dtypes.conv_out_dtype()
            xw = pad_spatial(xw.to(out_dt), pads)
            y = nchw_to_nhwc(_CONV[len(kshape) - 2](
                nhwc_to_nchw(xw), _oihw(W.to(out_dt).view(kshape)),
                stride=strides, dilation=dilation, groups=self.groups))
            if self.bias:
                y = y + self.b
            y = self.activation(y)
        if self.ndim == 1:
            y = y.squeeze(1)
        return nhwc_to_nchw(y) if self.dim_ordering == "th" else y


class Convolution1D(_ConvND):
    """1-D convolution over (B, T, C) ("tf") or (B, C, T) ("th")."""

    ndim = 1


class Convolution2D(_ConvND):
    ndim = 2


class Convolution3D(_ConvND):
    """3-D convolution over (B, D, H, W, C) ("tf") or (B, C, D, H, W)
    ("th"); ``W`` (kd, kh, kw, cin/groups, cout)."""

    ndim = 3


class AtrousConvolution1D(Convolution1D):
    """``Convolution1D`` with its taps ``atrous_rate`` apart."""

    def __init__(self, nb_filter, kernel_size, atrous_rate=1, **kwargs):
        super().__init__(nb_filter, kernel_size, dilation=atrous_rate,
                         **kwargs)


class AtrousConvolution2D(Convolution2D):
    """``Convolution2D`` with its taps ``atrous_rate`` apart."""

    def __init__(self, nb_filter, kernel_size, atrous_rate=(1, 1), **kwargs):
        super().__init__(nb_filter, kernel_size, dilation=atrous_rate,
                         **kwargs)


class ShareConvolution2D(_ConvND):
    """``Convolution2D`` with explicit symmetric ``pad_h`` / ``pad_w`` zero
    padding before a valid convolution (ShareConvolution2D.scala; its
    shared buffer is a BigDL memory detail)."""

    ndim = 2

    def __init__(self, nb_filter, kernel_size, pad_h=0, pad_w=0, **kwargs):
        self.pad_h, self.pad_w = int(pad_h), int(pad_w)
        super().__init__(nb_filter, kernel_size, border_mode="valid",
                         **kwargs)

    def _pads(self, sizes):
        return [(self.pad_h, self.pad_h), (self.pad_w, self.pad_w)]


class ZeroPadding2D(Layer):
    """Zero-pad H and W: symmetric ``(ph, pw)`` or asymmetric ``((top,
    bottom), (left, right))``."""

    def __init__(self, padding=(1, 1), dim_ordering="tf", input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        if (isinstance(padding, (tuple, list)) and padding
                and isinstance(padding[0], (tuple, list))):
            self.padding = (tuple(int(v) for v in padding[0]),
                            tuple(int(v) for v in padding[1]))
        else:
            ph, pw = _pair(padding)
            self.padding = ((ph, ph), (pw, pw))
        self.dim_ordering = dim_ordering

    def compute_output_shape(self, input_shape):
        s = list(to_shape(input_shape))
        first = 1 if self.dim_ordering == "th" else 0
        for i, (lo, hi) in enumerate(self.padding):
            if s[first + i] is not None:
                s[first + i] += lo + hi
        return tuple(s)

    def forward(self, x):
        if self.dim_ordering == "th":
            (t, b), (l, r) = self.padding
            return F.pad(x, (l, r, t, b))
        return pad_spatial(x, self.padding)


class SpaceToDepth(Layer):
    """(B, H, W, C) -> (B, H/b, W/b, b·b·C): each b×b block of pixels
    folded into the channels in (dh, dw, c) order (tf.nn.space_to_depth,
    NHWC).  With ``stem_7x7_to_s2d`` it turns the 7×7/s2 stem into an
    equivalent 4×4/s1 conv over 12 channels."""

    def __init__(self, block_size=2, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.block = int(block_size)

    def compute_output_shape(self, input_shape):
        h, w, c = to_shape(input_shape)
        b = self.block
        return (h // b, w // b, b * b * c)

    def forward(self, x):
        b = self.block
        B, H, W, C = x.shape
        if H % b or W % b:
            raise ValueError(f"SpaceToDepth({b}): spatial dims {(H, W)} "
                             "must be divisible by block_size")
        x = x.reshape(B, H // b, b, W // b, b, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // b, W // b,
                                                   b * b * C)


def stem_7x7_to_s2d(w7: torch.Tensor) -> torch.Tensor:
    """Map a (7, 7, 3, F) stride-2 SAME stem kernel to the equivalent
    (4, 4, 12, F) stride-1 kernel over ``SpaceToDepth(2)`` input: pad the
    kernel to 8×8 (tap 7 = 0) and fold each 2×2 block into the channels,
    ``Ws2d[a, b, (dh, dw, c), o] = Wpad[2a + dh, 2b + dw, c, o]``."""
    k, _, cin, cout = w7.shape
    if k != 7:
        raise ValueError("stem mapping is for the 7x7 ImageNet stem")
    wpad = F.pad(w7, (0, 0, 0, 0, 0, 1, 0, 1))
    w = wpad.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5)
    return w.reshape(4, 4, 4 * cin, cout)


def _spatial_pads(border_mode, sizes, kernel, strides):
    """(lo, hi) per spatial axis for the depthwise and separable layers:
    the JAX package pads them with ``_pad_str(border_mode)``, dilation 1."""
    return conv_pads(border_mode, sizes, kernel, strides,
                     (1,) * len(kernel))


class _Float2D(Layer):
    """Shared by the float-only 2-D convolutions (transposed, depthwise,
    separable): ``dim_ordering``, the activation and the NHWC plumbing."""

    def _channels(self, input_shape):
        s = to_shape(input_shape)
        if self.dim_ordering == "th":
            return s[1:], s[0]
        return s[:-1], s[-1]

    def _out_shape(self, sizes, cout):
        if self.dim_ordering == "th":
            return (cout,) + tuple(sizes)
        return tuple(sizes) + (cout,)

    def _run(self, x, fn):
        """``fn`` on the NHWC view of ``x``, then the bias and the
        activation, back in ``x``'s ordering."""
        if self.dim_ordering == "th":
            x = nchw_to_nhwc(x)
        y = fn(x)
        if self.bias:
            y = y + self.b
        y = self.activation(y)
        return nhwc_to_nchw(y) if self.dim_ordering == "th" else y


class Deconvolution2D(_Float2D):
    """Transposed 2-D convolution (Deconvolution2D.scala; keras
    ``Conv2DTranspose``): ``W`` (kh, kw, nb_filter, cin), the JAX layout.
    The JAX layer convolves the input dilated by the stride with the
    spatially flipped kernel at stride 1, padded per axis ``(k - 1, k -
    1)`` ("valid") or, for "same", ``(k - 1 - lo, k - 1 - (t - lo) +
    max(s - k, 0))`` with ``t = max(k - s, 0)``, ``lo = t // 2``.  Here:
    ``F.conv_transpose2d`` at stride s and no padding (that convolution
    padded ``(k - 1, k - 1)``), then cropped, or extended by rows of no
    input, to those pads."""

    def __init__(self, nb_filter, kernel_size, activation=None, subsample=1,
                 border_mode="valid", init="glorot_uniform", bias=True,
                 dim_ordering="tf", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter = int(nb_filter)
        self.kernel_size = _pair(kernel_size)
        self.activation = activations.get(activation)
        self.subsample = _pair(subsample)
        self.border_mode = border_mode
        self.init_name = init
        self.bias = bias
        self.dim_ordering = dim_ordering
        self._build_declared()

    def _pads(self):
        out = []
        for k, s in zip(self.kernel_size, self.subsample):
            if self.border_mode in ("same", "SAME"):
                t = max(k - s, 0)
                lo = t // 2
                out.append((k - 1 - lo, k - 1 - (t - lo) + max(s - k, 0)))
            else:
                out.append((k - 1, k - 1))
        return out

    def build(self, input_shape):
        _, cin = self._channels(input_shape)
        self.W = nn.Parameter(torch.empty(self.kernel_size
                                          + (self.nb_filter, cin)))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(self.nb_filter))

    def reset_parameters(self, gen):
        kk = self.kernel_size[0] * self.kernel_size[1]
        self.W.copy_(initializer(self.init_name, gen, self.W.shape,
                                 fan_in=kk * self.W.shape[-1],
                                 fan_out=kk * self.nb_filter))
        if self.bias:
            self.b.zero_()

    def _tree(self) -> Dict:
        return {"W": self.W, "b": self.b} if self.bias else {"W": self.W}

    def compute_output_shape(self, input_shape):
        sizes, _ = self._channels(input_shape)
        out = tuple(None if i is None else (i - 1) * s + lo + hi - k + 2
                    for i, k, s, (lo, hi) in zip(
                        sizes, self.kernel_size, self.subsample,
                        self._pads()))
        return self._out_shape(out, self.nb_filter)

    def _deconv(self, x):
        xw, W = dtypes.cast_compute(x, self.W)
        out_dt = dtypes.conv_out_dtype()
        # (kh, kw, out, in) -> conv_transpose2d's (in, out, kh, kw)
        full = F.conv_transpose2d(nhwc_to_nchw(xw.to(out_dt)),
                                  W.to(out_dt).permute(3, 2, 0, 1),
                                  stride=self.subsample)
        crop = []
        for i, k, s, (lo, hi) in zip(reversed(x.shape[1:3]),
                                     reversed(self.kernel_size),
                                     reversed(self.subsample),
                                     reversed(self._pads())):
            # full spans the dilated input padded (k - 1, k - 1)
            crop += [lo - (k - 1), hi - (k - 1)]
        return nchw_to_nhwc(F.pad(full, crop))

    def forward(self, x):
        return self._run(x, self._deconv)


class DepthwiseConvolution2D(_Float2D):
    """Depthwise 2-D convolution (the depthwise half of
    SeparableConvolution2D.scala), the MobileNet building block where a
    BatchNorm sits between the depthwise and pointwise convs.
    ``depthwise`` (kh, kw, 1, cin·depth_multiplier), output channel
    k = c·depth_multiplier + m; a grouped ``F.conv2d`` with one group a
    channel."""

    def __init__(self, kernel_size, depth_multiplier=1, activation=None,
                 subsample=1, border_mode="valid", init="glorot_uniform",
                 bias=True, dim_ordering="tf", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.kernel_size = _pair(kernel_size)
        self.depth_multiplier = int(depth_multiplier)
        self.activation = activations.get(activation)
        self.subsample = _pair(subsample)
        self.border_mode = border_mode
        self.init_name = init
        self.bias = bias
        self.dim_ordering = dim_ordering
        self._build_declared()

    def build(self, input_shape):
        _, cin = self._channels(input_shape)
        self.cin = cin
        self.depthwise = nn.Parameter(torch.empty(
            self.kernel_size + (1, cin * self.depth_multiplier)))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(cin * self.depth_multiplier))

    def reset_parameters(self, gen):
        kk = self.kernel_size[0] * self.kernel_size[1]
        self.depthwise.copy_(initializer(
            self.init_name, gen, self.depthwise.shape, fan_in=kk,
            fan_out=kk * self.depth_multiplier))
        if self.bias:
            self.b.zero_()

    def _tree(self) -> Dict:
        tree = {"depthwise": self.depthwise}
        if self.bias:
            tree["b"] = self.b
        return tree

    def compute_output_shape(self, input_shape):
        sizes, cin = self._channels(input_shape)
        pads = _spatial_pads(self.border_mode, sizes, self.kernel_size,
                             self.subsample)
        out = tuple(_out_size(i, k, s, 1, p) for i, k, s, p in zip(
            sizes, self.kernel_size, self.subsample, pads))
        return self._out_shape(out, cin * self.depth_multiplier)

    def _depthwise(self, x):
        pads = _spatial_pads(self.border_mode, x.shape[1:3],
                             self.kernel_size, self.subsample)
        xw, dw = dtypes.cast_compute(x, self.depthwise)
        out_dt = dtypes.conv_out_dtype()
        xw = pad_spatial(xw.to(out_dt), pads)
        return nchw_to_nhwc(F.conv2d(nhwc_to_nchw(xw), _oihw(dw.to(out_dt)),
                                     stride=self.subsample,
                                     groups=x.shape[-1]))

    def forward(self, x):
        return self._run(x, self._depthwise)


class SeparableConvolution2D(DepthwiseConvolution2D):
    """Depthwise then pointwise convolution (SeparableConvolution2D.scala):
    ``depthwise`` (kh, kw, 1, cin·depth_multiplier), ``pointwise`` (1, 1,
    cin·depth_multiplier, nb_filter), then the bias and the activation."""

    def __init__(self, nb_filter, kernel_size, depth_multiplier=1,
                 activation=None, subsample=1, border_mode="valid",
                 init="glorot_uniform", bias=True, dim_ordering="tf",
                 input_shape=None, name=None):
        self.nb_filter = int(nb_filter)
        super().__init__(kernel_size, depth_multiplier=depth_multiplier,
                         activation=activation, subsample=subsample,
                         border_mode=border_mode, init=init, bias=bias,
                         dim_ordering=dim_ordering, input_shape=input_shape,
                         name=name)

    def build(self, input_shape):
        _, cin = self._channels(input_shape)
        mid = cin * self.depth_multiplier
        self.depthwise = nn.Parameter(torch.empty(self.kernel_size
                                                  + (1, mid)))
        self.pointwise = nn.Parameter(torch.empty(1, 1, mid, self.nb_filter))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(self.nb_filter))

    def reset_parameters(self, gen):
        kk = self.kernel_size[0] * self.kernel_size[1]
        self.depthwise.copy_(initializer(
            self.init_name, gen, self.depthwise.shape, fan_in=kk,
            fan_out=kk * self.depth_multiplier))
        self.pointwise.copy_(initializer(self.init_name, gen,
                                         self.pointwise.shape))
        if self.bias:
            self.b.zero_()

    def _tree(self) -> Dict:
        tree = {"depthwise": self.depthwise, "pointwise": self.pointwise}
        if self.bias:
            tree["b"] = self.b
        return tree

    def compute_output_shape(self, input_shape):
        out = super().compute_output_shape(input_shape)
        if self.dim_ordering == "th":
            return (self.nb_filter,) + out[1:]
        return out[:-1] + (self.nb_filter,)

    def _separable(self, x):
        y = self._depthwise(x)
        yw, pw = dtypes.cast_compute(y, self.pointwise)
        out_dt = dtypes.conv_out_dtype()
        return nchw_to_nhwc(F.conv2d(nhwc_to_nchw(yw.to(out_dt)),
                                     _oihw(pw.to(out_dt))))

    def forward(self, x):
        return self._run(x, self._separable)


class ZeroPadding1D(Layer):
    """Zero-pad the steps of (B, T, C) by ``padding`` (an int: both ends;
    a pair: (left, right))."""

    def __init__(self, padding=1, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.padding = _pair(padding, 2) if isinstance(padding, (tuple, list)) \
            else (int(padding), int(padding))

    def compute_output_shape(self, input_shape):
        t, c = to_shape(input_shape)
        return (None if t is None else t + sum(self.padding), c)

    def forward(self, x):
        return pad_spatial(x, [self.padding])


class ZeroPadding3D(Layer):
    """Zero-pad the three spatial axes of (B, D1, D2, D3, C) by ``padding``
    (p1, p2, p3) at both ends (ZeroPadding3D.scala, channels last)."""

    def __init__(self, padding=(1, 1, 1), input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.padding = tuple(int(p) for p in padding)

    def compute_output_shape(self, input_shape):
        s = to_shape(input_shape)
        return tuple(None if d is None else d + 2 * p
                     for d, p in zip(s[:3], self.padding)) + s[3:]

    def forward(self, x):
        return pad_spatial(x, [(p, p) for p in self.padding])


def _crop(x, first: int, crops):
    """``x`` with axes ``first``, ``first + 1``, ... cropped by (lo, hi)
    each, as the JAX layers slice ``a:size - b``."""
    idx = [slice(None)] * x.ndim
    for i, (a, b) in enumerate(crops):
        idx[first + i] = slice(a, x.shape[first + i] - b)
    return x[tuple(idx)]


def _cropped_shape(shape, first: int, crops):
    s = list(shape)
    for i, (a, b) in enumerate(crops):
        if s[first + i] is not None:
            s[first + i] = max(s[first + i] - a - b, 0)
    return tuple(s)


class Cropping1D(Layer):
    """Crop (B, T, C) by ``cropping`` (left, right) steps."""

    def __init__(self, cropping=(1, 1), input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.cropping = _pair(cropping, 2)

    def compute_output_shape(self, input_shape):
        return _cropped_shape(to_shape(input_shape), 0, [self.cropping])

    def forward(self, x):
        return _crop(x, 1, [self.cropping])


class Cropping2D(Layer):
    """Crop H and W by ``((top, bottom), (left, right))``."""

    def __init__(self, cropping=((0, 0), (0, 0)), dim_ordering="tf",
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.cropping = tuple(tuple(int(i) for i in c) for c in cropping)
        self.dim_ordering = dim_ordering

    def _first(self):
        return 2 if self.dim_ordering == "th" else 1

    def compute_output_shape(self, input_shape):
        return _cropped_shape(to_shape(input_shape), self._first() - 1,
                              self.cropping)

    def forward(self, x):
        return _crop(x, self._first(), self.cropping)


class Cropping3D(Layer):
    """Crop the three spatial axes of (B, D1, D2, D3, C) by ((lo, hi) x 3)
    (Cropping3D.scala, channels last)."""

    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.cropping = tuple((int(a), int(b)) for a, b in cropping)

    def compute_output_shape(self, input_shape):
        return _cropped_shape(to_shape(input_shape), 0, self.cropping)

    def forward(self, x):
        return _crop(x, 1, self.cropping)


class _UpSampling(Layer):
    """Repeat each entry of the spatial axes ``size[i]`` times
    (``jnp.repeat``)."""

    ndim = 2

    def __init__(self, size, dim_ordering="tf", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.size = _pair(size, self.ndim)
        self.dim_ordering = dim_ordering

    def _first(self):
        return 2 if self.dim_ordering == "th" else 1

    def compute_output_shape(self, input_shape):
        s = list(to_shape(input_shape))
        for i, r in enumerate(self.size):
            ax = self._first() - 1 + i
            if s[ax] is not None:
                s[ax] *= r
        return tuple(s)

    def forward(self, x):
        for i, r in enumerate(self.size):
            x = torch.repeat_interleave(x, r, dim=self._first() + i)
        return x


class UpSampling1D(_UpSampling):
    """(B, T, C) -> (B, T·length, C)."""

    ndim = 1

    def __init__(self, length=2, input_shape=None, name=None):
        super().__init__(length, input_shape=input_shape, name=name)
        self.length = int(length)


class UpSampling2D(_UpSampling):
    ndim = 2

    def __init__(self, size=(2, 2), dim_ordering="tf", input_shape=None,
                 name=None):
        super().__init__(size, dim_ordering, input_shape, name)


class UpSampling3D(_UpSampling):
    ndim = 3

    def __init__(self, size=(2, 2, 2), dim_ordering="tf", input_shape=None,
                 name=None):
        super().__init__(size, dim_ordering, input_shape, name)


class LocallyConnected1D(Layer):
    """Unshared-weights 1-D convolution (LocallyConnected1D.scala): ``W``
    (out_steps, filter_length·cin, nb_filter), ``b`` (out_steps,
    nb_filter); each output step's window of filter_length steps, flattened
    in (tap, channel) order, times its own weight."""

    def __init__(self, nb_filter, filter_length, activation=None, bias=True,
                 init="glorot_uniform", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter = int(nb_filter)
        self.filter_length = int(filter_length)
        self.activation = activations.get(activation)
        self.bias = bias
        self.init_name = init
        self._build_declared()

    def build(self, input_shape):
        steps, cin = to_shape(input_shape)
        out = steps - self.filter_length + 1
        self.W = nn.Parameter(torch.empty(out, self.filter_length * cin,
                                          self.nb_filter))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(out, self.nb_filter))

    def reset_parameters(self, gen):
        self.W.copy_(initializer(self.init_name, gen, self.W.shape))
        if self.bias:
            self.b.zero_()

    def _tree(self) -> Dict:
        return {"W": self.W, "b": self.b} if self.bias else {"W": self.W}

    def compute_output_shape(self, input_shape):
        steps, _ = to_shape(input_shape)
        return (steps - self.filter_length + 1, self.nb_filter)

    def forward(self, x):
        # windows (B, out_steps, k·C): unfold gives (B, out, C, k)
        win = x.unfold(1, self.filter_length, 1).transpose(2, 3)
        win = win.reshape(x.shape[0], win.shape[1], -1)
        xw, W = dtypes.cast_compute(win, self.W)
        pdt = dtypes.param_dtype()
        y = torch.einsum("bsk,sko->bso", xw.to(pdt), W.to(pdt))
        if self.bias:
            y = y + self.b
        return self.activation(y)


class LocallyConnected2D(Layer):
    """Unshared-weights 2-D convolution (LocallyConnected2D.scala), channels
    last: ``W`` (oh·ow, kh·kw·cin, nb_filter), ``b`` (oh, ow, nb_filter);
    each output pixel's (kh, kw, cin) patch times its own weight, as one
    batched contraction."""

    def __init__(self, nb_filter, nb_row, nb_col=None, activation=None,
                 subsample=1, bias=True, init="glorot_uniform",
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter = int(nb_filter)
        self.kernel_size = (int(nb_row), int(nb_col if nb_col is not None
                                             else nb_row))
        self.activation = activations.get(activation)
        self.subsample = _pair(subsample)
        self.bias = bias
        self.init_name = init
        self._build_declared()

    def _out_hw(self, h, w):
        (kh, kw), (sh, sw) = self.kernel_size, self.subsample
        return (h - kh) // sh + 1, (w - kw) // sw + 1

    def build(self, input_shape):
        h, w, c = to_shape(input_shape)
        oh, ow = self._out_hw(h, w)
        kh, kw = self.kernel_size
        self.W = nn.Parameter(torch.empty(oh * ow, kh * kw * c,
                                          self.nb_filter))
        if self.bias:
            self.b = nn.Parameter(torch.zeros(oh, ow, self.nb_filter))

    def reset_parameters(self, gen):
        self.W.copy_(initializer(self.init_name, gen, self.W.shape,
                                 fan_in=self.W.shape[1],
                                 fan_out=self.nb_filter))
        if self.bias:
            self.b.zero_()

    def _tree(self) -> Dict:
        return {"W": self.W, "b": self.b} if self.bias else {"W": self.W}

    def compute_output_shape(self, input_shape):
        h, w, _ = to_shape(input_shape)
        return self._out_hw(h, w) + (self.nb_filter,)

    def forward(self, x):
        b, h, w, c = x.shape
        (kh, kw), (sh, sw) = self.kernel_size, self.subsample
        oh, ow = self._out_hw(h, w)
        # (B, oh, ow, C, kh, kw) -> (B, oh·ow, kh·kw·C) in (kh, kw, C) order
        patches = x.unfold(1, kh, sh).unfold(2, kw, sw)
        patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(b, oh * ow, -1)
        xw, W = dtypes.cast_compute(patches, self.W)
        pdt = dtypes.param_dtype()
        y = torch.einsum("bpk,pko->bpo", xw.to(pdt), W.to(pdt))
        y = y.reshape(b, oh, ow, self.nb_filter)
        if self.bias:
            y = y + self.b
        return self.activation(y)


class ResizeBilinear(Layer):
    """Bilinear resize of (B, H, W, C) images (ResizeBilinear.scala) on
    TF1's ``resize_bilinear`` grid, as the JAX layer computes it: source
    coordinate ``dst · in / out`` with no half-pixel offset (or ``dst ·
    (in - 1) / (out - 1)`` with ``align_corners``), in f32.
    ``F.interpolate(align_corners=False)`` takes half-pixel centres and
    does not match."""

    def __init__(self, output_height, output_width, align_corners=False,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.oh = int(output_height)
        self.ow = int(output_width)
        self.align_corners = bool(align_corners)

    def compute_output_shape(self, input_shape):
        return (self.oh, self.ow, to_shape(input_shape)[-1])

    def _grid(self, n_in, n_out, device):
        step = (n_in - 1) / (n_out - 1) if self.align_corners \
            and n_out > 1 else n_in / n_out
        src = torch.arange(n_out, dtype=torch.float32, device=device) * step
        i0 = torch.floor(src).to(torch.int64).clamp(0, n_in - 1)
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        return i0, i1, src - i0

    def forward(self, x):
        _, h, w, _ = x.shape
        y0, y1, fy = self._grid(h, self.oh, x.device)
        x0, x1, fx = self._grid(w, self.ow, x.device)
        xf = x.to(torch.float32)
        fx = fx[None, None, :, None]
        fy = fy[None, :, None, None]
        top = xf[:, y0][:, :, x0] * (1 - fx) + xf[:, y0][:, :, x1] * fx
        bot = xf[:, y1][:, :, x0] * (1 - fx) + xf[:, y1][:, :, x1] * fx
        return (top * (1 - fy) + bot * fy).to(x.dtype)


class LRN2D(Layer):
    """Cross-channel local response normalization (LRN2D.scala), the JAX
    formula ``x / (k + alpha / n · Σ_{n channels} x²) ** beta`` over a
    window of n channels centred on each (zero outside).  "tf" normalizes
    the last axis, "th" axis 1."""

    def __init__(self, alpha=1e-4, k=1.0, beta=0.75, n=5, dim_ordering="tf",
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.alpha = float(alpha)
        self.k = float(k)
        self.beta = float(beta)
        self.n = int(n)
        self.dim_ordering = dim_ordering

    def forward(self, x):
        th = self.dim_ordering == "th"
        if th:
            x = torch.movedim(x, 1, -1)
        half = self.n // 2
        c = x.shape[-1]
        sq = F.pad(x * x, (half, half))
        acc = sq[..., 0:c]
        for i in range(1, self.n):
            acc = acc + sq[..., i:i + c]
        y = x / torch.pow(self.k + self.alpha / self.n * acc, self.beta)
        return torch.movedim(y, -1, 1) if th else y
