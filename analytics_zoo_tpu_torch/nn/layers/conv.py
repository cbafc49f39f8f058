"""1-D and 2-D convolution, zero padding and space-to-depth — the JAX
package's ``nn/layers/conv.py`` (``_ConvND`` :44, ``Convolution1D`` :145,
``Convolution2D`` :149, ``AtrousConvolution1D`` :157, ``ZeroPadding2D``
:347, ``SpaceToDepth`` :461, ``stem_7x7_to_s2d`` :488).

Activations stay NHWC (``dim_ordering="tf"``, the JAX layout) and the
weight stays ``W`` (kh, kw, cin/groups, cout), so ``load_jax_params``
copies it as it is.  The convolution itself is ``F.conv2d`` on an NCHW
view of the NHWC tensor — a channels_last tensor to PyTorch, which cuDNN
takes without a copy — and the output goes back to NHWC as a view.  The
JAX package runs these convolutions through ``lax.conv_general_dilated``,
outside any Pallas kernel.

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
``w4a16_conv``.  The bias is added after, then the activation, as in the
JAX package's ``_ConvND.call``.  A spatial int8 conv on the card also keeps
``W_q``'s K-major pack for the ``w8a8_conv2d`` kernel
(``quant_matmul.pack_conv_weight``): built at its first forward (a
warm-up's), again only when ``W_q`` is replaced or written, and held beside
the leaves, not among them.  A float conv becomes quantized when
``utils/convert.load_jax_params`` loads a quantized leaf set into it.
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

    def _geometry_2d(self):
        """The weight's shape, strides and dilation of the 2-D convolution
        this layer runs: its own, or for a 1-D layer the (1, k)
        convolution's."""
        one = (1,) * (2 - self.ndim)
        return one + self.kshape, one + self.subsample, one + self.dilation

    def _as_2d(self, x, pads):
        """``x`` (B, *spatial, C) and ``pads`` as the 2-D convolution takes
        them: as they are, or for a 1-D layer (B, 1, T, C) and the row
        axis unpadded."""
        if self.ndim == 2:
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
        """The W8A8 / W4A16 conv of NHWC ``x`` with ``pads`` (the 2-D
        convolution of ``_as_2d``) through the fused-dequant entry points
        of ``ops/quant_matmul.py``."""
        kshape, strides, dilation = self._geometry_2d()
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
        """``W_q``'s pack (of its 2-D view) for the kernel route of a
        spatial conv (None on the plain route and for a pointwise conv),
        kept while ``W_q`` is the same tensor at the same version: a new
        ``W_q`` or an in-place write to it rebuilds the pack.  An inference
        tensor counts no versions, so its pack is made on every call.
        ``pads``: the 2-D convolution's."""
        kshape, strides, dilation = self._geometry_2d()
        if not xq.is_cuda or self.impl == "torch" or qm._is_pointwise(
                kshape, strides, dilation, self.groups, pads):
            return None
        w = self.W_q
        if w.is_inference():
            return qm.pack_conv_weight(w.view(kshape), self.groups)
        cached = getattr(self, "_pack", None)
        if cached is None or cached[0] is not w or cached[1] != w._version:
            cached = (w, w._version,
                      qm.pack_conv_weight(w.view(kshape), self.groups))
            self._pack = cached
        return cached[2]

    def forward(self, x):
        if self.dim_ordering == "th":
            x = nchw_to_nhwc(x)
        x2, pads = self._as_2d(x, self._pads(x.shape[1:-1]))
        if self.bits:
            y = self._quantized(x2, pads)
        else:
            kshape, strides, dilation = self._geometry_2d()
            xw, W = dtypes.cast_compute(x2, self.W)
            out_dt = dtypes.conv_out_dtype()
            xw = pad_spatial(xw.to(out_dt), pads)
            # (kh, kw, cin, cout) -> (cout, cin, kh, kw)
            w = W.to(out_dt).view(kshape).permute(3, 2, 0, 1)
            y = nchw_to_nhwc(F.conv2d(nhwc_to_nchw(xw), w, stride=strides,
                                      dilation=dilation, groups=self.groups))
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


class AtrousConvolution1D(Convolution1D):
    """``Convolution1D`` with its taps ``atrous_rate`` apart."""

    def __init__(self, nb_filter, kernel_size, atrous_rate=1, **kwargs):
        super().__init__(nb_filter, kernel_size, dilation=atrous_rate,
                         **kwargs)


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
