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
on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops._impl import resolve_impl

KERNEL = "quant_matmul"

# launches of the CUDA kernels (one per call that took the kernel route)
launches_w8a8 = 0
launches_w4a16 = 0

_fns = None


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
    launches_w8a8 += 1
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
    launches_w4a16 += 1
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
