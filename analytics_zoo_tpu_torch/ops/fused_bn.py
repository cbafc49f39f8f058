"""Fused 1×1 convolution + BatchNorm statistics: ``(y, stats) =
fused_bn(x, w)`` with ``y = x @ w`` and ``stats`` (2, N) f32 the
per-column sums of y and y² over the rows of the f32 accumulator.

The counterpart of the JAX package's probe kernel
``tools/fused_bn_probe.py::_fused_kernel``, put where a ResNet's training
step needs it: a 1×1, stride-1, bias-free convolution followed by a
``BatchNormalization`` is this product over the (rows, channels) view of
the NHWC input, and the BN's single-pass statistics come out of the
product's epilogue instead of a second read of y (the graph ``Model``'s
fusion plan, ``nn/models.py``).

- ``fused_bn_torch`` — the plain version: ``torch.matmul`` of the operands
  widened to f32 (the products of the input dtype, as
  ``common/dtypes.matmul``), then ``y.sum(0)`` and ``(y*y).sum(0)``; what a
  CPU tensor gets, and the oracle the kernel is held to.
- the CUDA kernel of ``csrc/fused_bn.cu``, launched for CUDA tensors: the
  product on the tensor cores (3xTF32 for f32, bf16 mma for bf16) with
  per-(128-row tile, column tile) partial sums, then a fixed-order reduce
  (``_launch_partials``, ``_launch_reduce``); ``launches`` counts its
  launches.
- ``fused_bn`` — the entry point; under autograd a ``torch.autograd.Function``
  whose backward is torch code (the probe has no backward kernel): with
  ``dY = gy + gΣ + 2·y·gΣ²`` broadcast over the rows, ``dx = dY @ wᵀ`` and
  ``dw = xᵀ @ dY``, plain large products that the JAX package computes
  outside any Pallas kernel.

Inputs are f32 or bf16 (both the same), y is stored in that dtype and the
sums are f32.  x may be a row-strided view (its last axis contiguous).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from analytics_zoo_tpu_torch.common import dtypes
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops._impl import launched, resolve_impl

KERNEL = "fused_bn"
# rows of x per block of the kernel: one partial-sum row per tile
TILE_M = 128

# launches of the CUDA kernel issued eagerly (one per fused_bn call that
# took it; a call under CUDA-graph capture adds 0: ``_impl.launched``)
launches = 0

_fns = None


def fused_bn_torch(x: torch.Tensor, w: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``y = x @ w`` summed in f32 (returned in x's dtype)
    and ``stats = (Σ_rows y, Σ_rows y²)`` of the f32 product."""
    y = dtypes.matmul(x, w, torch.float32)
    stats = torch.stack([y.sum(0), (y * y).sum(0)])
    return y.to(x.dtype), stats


def _kernel_fns():
    global _fns
    if _fns is None:
        lib = _build.load(KERNEL)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if lib.fused_bn_tile_m() != TILE_M:
            raise RuntimeError(f"{KERNEL}.cu tiles {lib.fused_bn_tile_m()} "
                               f"rows, ops/fused_bn.py expects {TILE_M}")
        parts = {}
        for name in ("f32", "bf16"):
            fn = getattr(lib, f"fused_bn_partials_{name}")
            fn.argtypes = [ptr, i64, ptr, ptr, ptr, i32, i32, i32, ptr]
            fn.restype = i32
            parts[name] = fn
        red = lib.fused_bn_reduce
        red.argtypes = [ptr, ptr, i32, i32, ptr]
        red.restype = i32
        _fns = (parts, red)
    return _fns


def _launch_partials(x, w):
    """y (M, N) and the per-tile partial sums (ceil(M/128), 2, N)."""
    m, k = x.shape
    n = w.shape[1]
    dev = x.device
    y = torch.empty(m, n, dtype=x.dtype, device=dev)
    part = torch.empty(-(-m // TILE_M), 2, n, dtype=torch.float32,
                       device=dev)
    parts, _ = _kernel_fns()
    fn = parts["f32" if x.dtype == torch.float32 else "bf16"]
    err = fn(x.data_ptr(), x.stride(0), w.data_ptr(), y.data_ptr(),
             part.data_ptr(), m, n, k,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_bn kernel launch failed: CUDA error {err} "
                           f"(M={m}, K={k}, N={n}, row stride "
                           f"{x.stride(0)})")
    return y, part


def _launch_reduce(part):
    """stats (2, N): the tiles' partial sums added in a fixed order."""
    tiles, _, n = part.shape
    stats = torch.empty(2, n, dtype=torch.float32, device=part.device)
    _, red = _kernel_fns()
    err = red(part.data_ptr(), stats.data_ptr(), tiles, n,
              torch.cuda.current_stream(part.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_bn reduce launch failed: CUDA error "
                           f"{err} (tiles={tiles}, N={n})")
    return stats


def _fused_bn_cuda(x, w):
    global launches
    dev = x.device
    if w.device != dev:
        raise ValueError(f"w is on {w.device}, expected {dev}")
    if x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"x must be row-major with a contiguous last axis, "
                         f"got strides {tuple(x.stride())}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:          # nothing to launch: exact zeros
        return (torch.zeros(m, n, dtype=x.dtype, device=dev),
                torch.zeros(2, n, dtype=torch.float32, device=dev))
    y, part = _launch_partials(x, w)
    stats = _launch_reduce(part)
    launches += launched()
    return y, stats


def _forward(x, w, impl):
    if resolve_impl(impl, x) == "torch":
        return fused_bn_torch(x, w)
    return _fused_bn_cuda(x, w)


class _FusedBN(torch.autograd.Function):
    """Forward through the kernel (or its plain version); backward in
    torch, from the saved x, w and y."""

    @staticmethod
    def forward(ctx, x, w, impl):
        y, stats = _forward(x, w, impl)
        ctx.save_for_backward(x, w, y)
        return y, stats

    @staticmethod
    def backward(ctx, gy, gstats):
        x, w, y = ctx.saved_tensors
        f32 = torch.float32
        dy = torch.zeros_like(y, dtype=f32) if gy is None else gy.to(f32)
        if gstats is not None:
            dy = dy + gstats[0] + 2.0 * y.to(f32) * gstats[1]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dy, w.to(f32).t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.to(f32).t(), dy).to(w.dtype)
        return dx, dw, None


def fused_bn(x: torch.Tensor, w: torch.Tensor, impl: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, stats)``: ``y = x @ w`` (M, N) in x's dtype, ``stats`` (2, N)
    f32 the column sums of the f32 product and of its square.  ``x`` (M, K)
    and ``w`` (K, N), both f32 or both bf16.  ``impl``: auto | torch |
    cuda (``ops/_impl.resolve_impl``)."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_bn needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"fused_bn takes f32 or bf16 operands of one dtype, "
                        f"got {x.dtype} / {w.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _FusedBN.apply(x, w, impl)
    return _forward(x, w, impl)
