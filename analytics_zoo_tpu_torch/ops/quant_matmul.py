"""Fused-dequant quantized matmul — int8 and int4 weight kernels for the
quantized predict path (``Dense`` with ``W_q`` / ``W_q4`` leaves).

The JAX package's ``ops/quant_matmul.py`` keeps quantized weights compact
in device memory and dequantizes them inside its Pallas kernels.  Here the
same two functions have:

- ``w8a8_matmul_torch`` / ``w4a16_matmul_torch`` — the plain versions (the
  counterparts of ``w8a8_matmul_xla`` / ``w4a16_matmul_xla``): what a CPU
  tensor gets, and the oracle the kernels are held to.
- the CUDA kernels of ``csrc/quant_matmul.cu`` (replacing ``_w8a8_kernel``
  and ``_w4a16_kernel``), launched for CUDA tensors.  ``launches_w8a8`` /
  ``launches_w4a16`` count their launches.

``w8a8``: s8 x s8 -> s32, then one f32 multiply by ``scale`` (N,).  The
integer sum is exact, so kernel and plain version agree BITWISE.  The plain
version sums in float64, which is exact for every |sum| < 2**53 (PyTorch
has no integer matmul on CUDA), then rounds to f32 once, as the int32 ->
f32 conversion does.

``w4a16``: split-nibble packing (``pack_int4``: byte row j = weight row j
in the low nibble | row j + ceil(K/2) in the high nibble), group scales
(G, N) along K with effective group size ceil(K/G) (``expand_group_scales``).
Unlike the TPU kernel, the CUDA kernel takes every shape the quantizer
emits — odd K, ragged last group — so no shape routes to the plain version
on the card.  It runs its products on the tensor cores (TF32 for f32 x,
bf16 for bf16 x) with each group's scale factored out of a chunk's partial
sum, so its rounding order differs from the plain ``x @ (q·s)``: the two
agree within atol 1e-4, rtol 1e-5 (``chip_smoke.W4_TOL``).

The quantized convolutions (the JAX package's ``w8a8_conv`` /
``w4a16_conv``) take NHWC activations, (kh, kw, cin/groups, cout)
weights and explicit per-side pads ``[(top, bottom), (left, right)]``
(``nn/layers/conv.conv_pads``: SAME pads a strided conv (0, 1) on even
sizes).  A pointwise conv (``_is_pointwise``) is a channel matmul and
flattens onto the two kernels above.  A spatial ``w8a8_conv`` launches
``w8a8_conv2d``, the s8 implicit-GEMM kernel of ``csrc/quant_conv.cu``
(``launches_conv`` counts it); its plain version ``w8a8_conv_torch`` is a
float64 convolution of the codes, exact below 2**53, rounded to f32 once,
so the two agree BITWISE.  The kernel reads the weight K-major:
``pack_conv_weight`` makes that pack (a quantized conv layer holds one
beside its ``W_q``), and ``conv_config`` is the rule that picks the
kernel's tile and its split of K over a thread-block cluster.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops._impl import H100_SMS, launched, resolve_impl
from analytics_zoo_tpu_torch.ops._impl import sm_count as _sm_count

KERNEL = "quant_matmul"
KERNEL_CONV = "quant_conv"

# launches of the CUDA kernels issued eagerly (one per call that took the
# kernel route; a call under CUDA-graph capture adds 0: ``_impl.launched``)
launches_w8a8 = 0
launches_w4a16 = 0
launches_conv = 0

_fns = None
_conv_fn = None


# -- int4 packing (two weights per byte, split layout) -------------------------

def pack_int4(q) -> np.ndarray:
    """Pack int4 values ``q`` (K, N) in [-8, 7] into (ceil(K/2), N) uint8:
    byte row j = row j (low nibble) | row j + ceil(K/2) (high nibble).
    Odd K pads the high half's last row with zero nibbles (decoded as
    weight 0)."""
    q = np.asarray(q)
    if q.ndim != 2:
        raise ValueError(f"pack_int4 expects (K, N), got {q.shape}")
    k = q.shape[0]
    k_half = (k + 1) // 2
    lo = q[:k_half].astype(np.uint8) & 0xF
    hi = np.zeros_like(lo)
    hi[: k - k_half] = q[k_half:].astype(np.uint8) & 0xF
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_int4(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (ceil(K/2), N) uint8 -> (K, N) int8."""
    b = torch.as_tensor(packed).to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    k_half = (int(k) + 1) // 2
    return torch.cat([lo[:k_half], hi[: int(k) - k_half]]).to(torch.int8)


def expand_group_scales(s_g: torch.Tensor, k: int) -> torch.Tensor:
    """Per-group scales (G, N) -> per-row scales (K, N): group g covers
    contraction rows [g*gs, (g+1)*gs) with gs = ceil(K/G)."""
    g = int(s_g.shape[0])
    gs = -(-int(k) // g)
    return torch.repeat_interleave(s_g, gs, dim=0)[: int(k)]


# -- plain versions (CPU path + numerics oracle) -------------------------------

def w8a8_matmul_torch(x_q, w_q, scale):
    """``x_q`` (M, K) int8 @ ``w_q`` (K, N) int8, exact integer sum,
    dequantized by ``scale`` (N,) f32."""
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    return acc.to(torch.float32) * scale.to(torch.float32)


def w4a16_matmul_torch(x, w_q4, s_g):
    """Weight-only int4: unpack, dequantize with the per-group scales,
    matmul in f32.  K is taken from ``x``."""
    k = int(x.shape[-1])
    w = unpack_int4(w_q4, k).to(torch.float32) \
        * expand_group_scales(s_g.to(torch.float32), k)
    return torch.matmul(x.to(torch.float32), w)


# -- CUDA kernels --------------------------------------------------------------

def _kernel_fns():
    global _fns
    if _fns is None:
        lib = _build.load(KERNEL)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        w8 = lib.w8a8_matmul
        w8.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        w8.restype = i32
        w4 = {}
        for name in ("f32", "bf16"):
            fn = getattr(lib, f"w4a16_matmul_{name}")
            fn.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
            fn.restype = i32
            w4[name] = fn
        _fns = (w8, w4)
    return _fns


def _check_cuda(names_tensors, dev):
    for name, t in names_tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _w8a8_cuda(x_q, w_q, scale):
    global launches_w8a8
    dev = x_q.device
    _check_cuda((("x_q", x_q), ("w_q", w_q), ("scale", scale)), dev)
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"w8a8 takes int8 operands, got {x_q.dtype} / "
                        f"{w_q.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    m, k = x_q.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    w8, _ = _kernel_fns()
    err = w8(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
             out.data_ptr(), m, n, k,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a8 kernel launch failed: CUDA error {err} "
                           f"(M={m}, K={k}, N={n})")
    launches_w8a8 += launched()
    return out


def _w4a16_cuda(x, w_q4, s_g):
    global launches_w4a16
    dev = x.device
    _check_cuda((("x", x), ("w_q4", w_q4), ("s_g", s_g)), dev)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w4a16 takes f32 or bf16 x, got {x.dtype}")
    if w_q4.dtype != torch.uint8 or s_g.dtype != torch.float32:
        raise TypeError(f"w4a16 takes uint8 packed weights and f32 scales, "
                        f"got {w_q4.dtype} / {s_g.dtype}")
    m, k = x.shape
    n = w_q4.shape[1]
    groups = s_g.shape[0]
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    _, w4 = _kernel_fns()
    fn = w4["f32" if x.dtype == torch.float32 else "bf16"]
    err = fn(x.data_ptr(), w_q4.data_ptr(), s_g.data_ptr(), out.data_ptr(),
             m, n, k, groups, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w4a16 kernel launch failed: CUDA error {err} "
                           f"(M={m}, K={k}, N={n}, G={groups})")
    launches_w4a16 += launched()
    return out


# -- public entry points -------------------------------------------------------

def w8a8_matmul(x_q, w_q, scale, impl: Optional[str] = None):
    """Fused-dequant int8 matmul: (M, K) s8 @ (K, N) s8 -> (M, N) f32
    ``= (x_q @ w_q) * scale``.  ``impl``: auto | torch | cuda."""
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"w8a8 needs (M, K) @ (K, N), got "
                         f"{tuple(x_q.shape)} @ {tuple(w_q.shape)}")
    if tuple(scale.shape) != (w_q.shape[1],):
        raise ValueError(f"scale must be (N,) = ({w_q.shape[1]},), got "
                         f"{tuple(scale.shape)}")
    if resolve_impl(impl, x_q) == "torch":
        return w8a8_matmul_torch(x_q, w_q, scale)
    return _w8a8_cuda(x_q, w_q, scale)


def w4a16_matmul(x, w_q4, s_g, impl: Optional[str] = None):
    """Weight-only int4 matmul: (M, K) f32/bf16 @ nibble-packed
    (ceil(K/2), N) u8 with per-group scales (G, N) -> (M, N) f32."""
    if x.ndim != 2 or w_q4.ndim != 2 or s_g.ndim != 2:
        raise ValueError("w4a16 needs x (M, K), w_q4 (ceil(K/2), N), "
                         "s_g (G, N)")
    k = int(x.shape[1])
    if w_q4.shape[0] != (k + 1) // 2 or s_g.shape[1] != w_q4.shape[1] \
            or not 1 <= s_g.shape[0] <= max(k, 1):
        raise ValueError(f"w4a16 shapes do not fit K={k}: w_q4 "
                         f"{tuple(w_q4.shape)}, s_g {tuple(s_g.shape)}")
    if resolve_impl(impl, x) == "torch":
        return w4a16_matmul_torch(x, w_q4, s_g)
    return _w4a16_cuda(x, w_q4, s_g)


def _flatten_batch(x):
    """(..., K) -> ((M, K), unflatten) for the 2-D kernels."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    return x2, lambda y: y.reshape(lead + (y.shape[-1],))


def w8a8_dense(x_q, w_q, scale, impl: Optional[str] = None):
    """Dense-layer entry: any-rank activations (..., K) s8 against (K, N)
    s8 weights, output (..., N) f32 dequantized by ``scale``."""
    x2, unflat = _flatten_batch(x_q)
    return unflat(w8a8_matmul(x2.contiguous(), w_q, scale, impl=impl))


def w4a16_dense(x, w_q4, s_g, impl: Optional[str] = None):
    x2, unflat = _flatten_batch(x)
    return unflat(w4a16_matmul(x2.contiguous(), w_q4, s_g, impl=impl))


# -- quantized convolutions ----------------------------------------------------

def _is_pointwise(kshape: Sequence[int], strides, dilation, groups: int,
                  padding) -> bool:
    """A conv is a pure channel matmul only when its spatial geometry is
    the identity: 1x1 kernel, stride and dilation 1, dense groups and no
    spatial padding.  ``padding``: "SAME" / "VALID" (zero pads for a 1x1
    kernel at stride 1) or per-axis (lo, hi) pads; caffe-style explicit
    padding grows the output and stays on the spatial path."""
    spatial = tuple(int(s) for s in kshape[:-2])
    if isinstance(padding, str):
        pad_free = padding.upper() in ("SAME", "VALID")
    else:
        pad_free = all(int(lo) == 0 and int(hi) == 0 for lo, hi in padding)
    return (pad_free
            and all(s == 1 for s in spatial)
            and all(int(s) == 1 for s in strides)
            and all(int(d) == 1 for d in dilation)
            and int(groups) == 1)


def _conv_geometry(x, kshape, strides, pads, dilation, groups):
    """Checked (B, H, W, C), (KH, KW, cin/g, cout) and the output's
    (Ho, Wo) of an NHWC conv with explicit pads."""
    if x.ndim != 4 or len(kshape) != 4:
        raise ValueError(f"a 2-D conv takes NHWC x and (kh, kw, cin/g, "
                         f"cout) weights, got {tuple(x.shape)} and "
                         f"{tuple(kshape)}")
    sh, sw = (int(v) for v in strides)
    dh, dw = (int(v) for v in dilation)
    (pt, pb), (pl, pr) = ((int(lo), int(hi)) for lo, hi in pads)
    b, h, w, c = (int(v) for v in x.shape)
    kh, kw, cg, cout = (int(v) for v in kshape)
    g = int(groups)
    if g < 1 or c != cg * g or cout % g:
        raise ValueError(f"groups={g} does not fit cin={c}, weight "
                         f"{tuple(kshape)}")
    if min(sh, sw, dh, dw) < 1 or min(pt, pb, pl, pr) < 0:
        raise ValueError(f"strides {tuple(strides)}, dilation "
                         f"{tuple(dilation)} and pads {pads} must be "
                         f"positive / non-negative")
    ho = (h + pt + pb - (kh - 1) * dh - 1) // sh + 1
    wo = (w + pl + pr - (kw - 1) * dw - 1) // sw + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"conv of {tuple(x.shape)} by {tuple(kshape)} "
                         f"with pads {pads} has no output")
    return (b, h, w, c), (kh, kw, cg, cout), (ho, wo)


def _pad_nhwc(x, pads):
    (pt, pb), (pl, pr) = pads
    return F.pad(x, (0, 0, int(pl), int(pr), int(pt), int(pb)))


def w8a8_conv_torch(x_q, w_q, scale, strides, pads, dilation=(1, 1),
                    groups: int = 1):
    """Plain version of ``w8a8_conv2d``: a float64 convolution of the int8
    codes (every partial sum an integer below 2**53, so exact in any
    order), as int32, rounded to f32 once and multiplied by ``scale``."""
    _conv_geometry(x_q, w_q.shape, strides, pads, dilation, groups)
    xd = _pad_nhwc(x_q.to(torch.float64), pads).permute(0, 3, 1, 2)
    wd = w_q.to(torch.float64).permute(3, 2, 0, 1)
    acc = F.conv2d(xd, wd, stride=tuple(int(s) for s in strides),
                   dilation=tuple(int(d) for d in dilation),
                   groups=int(groups))
    return acc.permute(0, 2, 3, 1).to(torch.int32).to(torch.float32) \
        * scale.to(torch.float32)


# the w8a8_conv2d kernel's tiles (csrc/quant_conv.cu: kCvBM, kCvBK,
# kCvBNSmall / kCvBNLarge, kCvMaxSplit)
CONV_BM, CONV_BK = 128, 64
CONV_BNS = (64, 128)
CONV_SPLITS = (1, 2, 4, 8)
# the rule splits K only while each slice keeps this many k-tiles of
# CONV_BK (a slice's ring fill and its share of the merge stay small)
CONV_MIN_SLICE = 4
# the s32 sum is exact for K up to this (|sum| <= 128 * 128 * K < 2**31)
CONV_MAX_K = 131071


def pack_conv_weight(w_q, groups: int = 1) -> torch.Tensor:
    """The K-major pack the ``w8a8_conv2d`` kernel reads: ``w_q`` (kh, kw,
    cin/g, cout) int8 -> (g, cout/g, Kp) int8 with K = kh·kw·cin/g in
    (kh, kw, c) order and Kp = K rounded up to CONV_BK with zeros:
    ``pack[grp, n, k] = w_q.reshape(K, cout)[k, grp·cout/g + n]``.  On the
    device of ``w_q``; a derived buffer, not a parameter."""
    kh, kw, cg, cout = (int(v) for v in w_q.shape)
    g = int(groups)
    if g < 1 or cout % g:
        raise ValueError(f"groups={g} does not divide cout={cout}")
    k = kh * kw * cg
    kp = -(-k // CONV_BK) * CONV_BK
    pack = torch.zeros(g, cout // g, kp, dtype=torch.int8,
                       device=w_q.device)
    pack[:, :, :k] = w_q.reshape(k, g, cout // g).permute(1, 2, 0)
    return pack


def conv_config(m: int, ng: int, k: int, groups: int = 1,
                sms: int = H100_SMS, bn: Optional[int] = None,
                split: Optional[int] = None):
    """``(bn, split)`` of a ``w8a8_conv2d`` launch: tiles of CONV_BM
    pixels x ``bn`` channels, each on a cluster of ``split`` blocks that
    take one slice of the K tiles each.  The rule: 128 channels where a
    group has more than 64, then K split in two while the blocks of the
    doubled split still fit one a multiprocessor of ``sms`` and each slice
    keeps CONV_MIN_SLICE k-tiles.  On the H100 (``chip_smoke.py
    --kernel-timing`` times every tile and split forced) a split that
    puts a second block on some multiprocessors cost more than its
    shorter k loops saved (a cluster waits for its slowest block, and the
    merge reads (split - 1) / split of each tile from the others), and
    64-channel tiles were slower than 128 at every split.  ``bn`` /
    ``split`` force a value (tests and ``chip_smoke.py``); any split of
    CONV_SPLITS is legal, a slice may be empty."""
    if bn is None:
        bn = CONV_BNS[1] if ng > CONV_BNS[0] else CONV_BNS[0]
    if bn not in CONV_BNS:
        raise ValueError(f"bn must be one of {CONV_BNS}, got {bn}")
    if split is None:
        kt = -(-int(k) // CONV_BK)
        tiles = -(-int(m) // CONV_BM) * -(-int(ng) // bn) * int(groups)
        split = 1
        while (split < CONV_SPLITS[-1] and 2 * split * tiles <= sms
               and kt >= 2 * split * CONV_MIN_SLICE):
            split *= 2
    if split not in CONV_SPLITS:
        raise ValueError(f"split must be one of {CONV_SPLITS}, got {split}")
    return int(bn), int(split)


def _conv_kernel_fn():
    global _conv_fn
    if _conv_fn is None:
        fn = _build.load(KERNEL_CONV).w8a8_conv2d
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _conv_fn = fn
    return _conv_fn


def _w8a8_conv_cuda(x_q, w_q, scale, strides, pads, dilation, groups,
                    w_pack=None, bn: Optional[int] = None,
                    split: Optional[int] = None):
    """The kernel's launch; ``bn`` / ``split`` force the tile's channels
    and the cluster's split of K (tests and ``chip_smoke.py``), else
    ``conv_config``'s rule picks them.  Without ``w_pack`` the weight is
    packed here, on the call."""
    global launches_conv
    dev = x_q.device
    _check_cuda((("x_q", x_q), ("w_q", w_q), ("scale", scale)), dev)
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"w8a8_conv2d takes int8 operands, got {x_q.dtype} "
                        f"/ {w_q.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    (b, h, w, c), (kh, kw, cg, cout), (ho, wo) = _conv_geometry(
        x_q, w_q.shape, strides, pads, dilation, groups)
    g = int(groups)
    k = kh * kw * cg
    if k > CONV_MAX_K:
        raise ValueError(f"w8a8_conv2d sums K = {k} > {CONV_MAX_K} products "
                         f"a pixel, past the exact s32 range")
    if w_pack is None:
        w_pack = pack_conv_weight(w_q, g)
    kp = -(-k // CONV_BK) * CONV_BK
    _check_cuda((("w_pack", w_pack),), dev)
    if w_pack.dtype != torch.int8 or tuple(w_pack.shape) != \
            (g, cout // g, kp) or w_pack.data_ptr() % 16:
        raise ValueError(f"w_pack must be the int8 pack_conv_weight of w_q: "
                         f"({g}, {cout // g}, {kp}) on 16 bytes, got "
                         f"{w_pack.dtype} {tuple(w_pack.shape)}")
    out = torch.empty(b, ho, wo, cout, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    bn, split = conv_config(b * ho * wo, cout // g, k, g,
                            _sm_count(dev.index or 0), bn, split)
    err = _conv_kernel_fn()(
        x_q.data_ptr(), w_pack.data_ptr(), scale.data_ptr(), out.data_ptr(),
        b, h, w, c, kh, kw, cout, ho, wo, int(strides[0]), int(strides[1]),
        int(pads[0][0]), int(pads[1][0]), int(dilation[0]),
        int(dilation[1]), g, bn, split,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"w8a8_conv2d kernel launch failed: CUDA error {err} (x "
            f"{tuple(x_q.shape)}, w {tuple(w_q.shape)}, strides "
            f"{tuple(strides)}, pads {pads}, dilation {tuple(dilation)}, "
            f"groups {groups}, tile {bn}, split {split})")
    launches_conv += launched()
    return out


def w8a8_conv2d(x_q, w_q, scale, *, strides, pads, dilation=(1, 1),
                groups: int = 1, impl: Optional[str] = None, w_pack=None):
    """s8 x s8 -> s32 convolution, dequantized by ``scale`` (cout,) f32:
    ``x_q`` (B, H, W, cin) int8, ``w_q`` (kh, kw, cin/groups, cout) int8,
    ``pads`` [(top, bottom), (left, right)] -> (B, Ho, Wo, cout) f32.
    ``impl``: auto | torch | cuda (the kernel of ``csrc/quant_conv.cu``).
    ``w_pack``: ``pack_conv_weight(w_q, groups)`` made beforehand (a
    quantized conv layer keeps it); the kernel route packs on the call
    without it, the plain route does not read it."""
    if tuple(scale.shape) != (w_q.shape[-1],):
        raise ValueError(f"scale must be (cout,) = ({w_q.shape[-1]},), got "
                         f"{tuple(scale.shape)}")
    if resolve_impl(impl, x_q) == "torch":
        return w8a8_conv_torch(x_q, w_q, scale, strides, pads, dilation,
                               groups)
    return _w8a8_conv_cuda(x_q, w_q, scale, strides, pads, dilation, groups,
                           w_pack)


def w8a8_conv(x_q, w_q, scale, *, window_strides, padding, rhs_dilation,
              feature_group_count: int = 1, impl: Optional[str] = None,
              w_pack=None):
    """Fused-dequant int8 convolution, NHWC x (kh, kw, cin/g, cout):
    a pointwise conv is a channel matmul (``w8a8_matmul``), a spatial one
    runs ``w8a8_conv2d`` (with ``w_pack``, the weight's pack, where the
    caller holds one); ``padding`` is the explicit per-side pads."""
    kshape = tuple(int(s) for s in w_q.shape)
    if _is_pointwise(kshape, window_strides, rhs_dilation,
                     feature_group_count, padding):
        x2, unflat = _flatten_batch(x_q.contiguous())
        return unflat(w8a8_matmul(x2, w_q.reshape(kshape[-2], kshape[-1]),
                                  scale, impl=impl))
    return w8a8_conv2d(x_q.contiguous(), w_q, scale, strides=window_strides,
                       pads=padding, dilation=rhs_dilation,
                       groups=feature_group_count, impl=impl, w_pack=w_pack)


def w4a16_conv(x, w_q4, s_g, kshape: Sequence[int], *, window_strides,
               padding, rhs_dilation, feature_group_count: int = 1,
               impl: Optional[str] = None):
    """Weight-only int4 convolution: the kernel tensor lives nibble-packed
    as (ceil(K/2), cout) with K = kh·kw·cin/g.  A pointwise conv runs the
    ``w4a16_matmul`` kernel.  A spatial one unpacks and dequantizes the
    weight group-wise and convolves in f32 with ``F.conv2d`` (cuDNN, TF32
    off), on purpose: the JAX package also computes it outside any Pallas
    kernel, as an XLA convolution of the dequantized weight."""
    kshape = tuple(int(s) for s in kshape)
    k = int(np.prod(kshape[:-1]))
    if _is_pointwise(kshape, window_strides, rhs_dilation,
                     feature_group_count, padding):
        x2, unflat = _flatten_batch(x.contiguous())
        return unflat(w4a16_matmul(x2, w_q4, s_g, impl=impl))
    _conv_geometry(x, kshape, window_strides, padding, rhs_dilation,
                   feature_group_count)
    w = unpack_int4(w_q4, k).to(torch.float32) \
        * expand_group_scales(s_g.to(torch.float32), k)
    xp = _pad_nhwc(x.to(torch.float32), padding).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w.reshape(kshape).permute(3, 2, 0, 1),
                 stride=tuple(int(s) for s in window_strides),
                 dilation=tuple(int(d) for d in rhs_dilation),
                 groups=int(feature_group_count))
    return y.permute(0, 2, 3, 1)
