"""Flash attention, forward — blockwise online-softmax attention without a
materialized (T, T) score matrix.

Two data paths, like the JAX package's ``ops/flash_attention.py``:

- ``flash_attention_torch`` — the plain version: the same f32 math as the
  TPU kernel (q scaled in f32 before the dot, causal mask ``k <= q``
  filled with ``-1e30``, softmax, ``lse = m + log(l)``) written with whole
  (T, T) scores.  It is what a CPU tensor gets, and the oracle.
- the CUDA kernel ``csrc/flash_attention.cu`` (replacing the Pallas
  ``_fwd_kernel``), launched for CUDA tensors.  It reads q/k/v through
  their strides, so a (B, T, heads, D) projection seen as (B, H, T, D)
  is read in place, and writes the output in (B, T, H, D) memory order.
  ``launches`` counts its launches.

Only the forward is ported: ``flash_attention`` is a
``torch.autograd.Function`` whose backward raises (the backward kernels
are the training slice's).  Any T works; the kernel masks the ragged last
tile itself, with no padded copies.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops._impl import resolve_impl

NEG_INF = -1e30
KERNEL = "flash_attention"
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# launches of the CUDA kernel (one per call that took the kernel route)
launches = 0

_fn = None


def flash_attention_torch(q, k, v, causal: bool = False,
                          scale: Optional[float] = None,
                          with_lse: bool = False, out_dtype=None):
    """Plain version over (B, H, T, D): returns ``(out, lse | None)``."""
    d = q.shape[-1]
    s = 1.0 / math.sqrt(d) if scale is None else float(scale)
    logits = torch.matmul(q.to(torch.float32) * s,
                          k.to(torch.float32).transpose(-1, -2))
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(keep, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l_sum = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = (torch.matmul(p, v.to(torch.float32)) / l_sum).to(
        out_dtype or q.dtype)
    lse = (m + torch.log(l_sum))[..., 0] if with_lse else None
    return out, lse


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = _build.load(KERNEL)
        fn = lib.flash_attention_fwd
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, i32] + [ptr] * 5 + [i32] * 4 \
            + [ptr, ctypes.c_float, i32, ptr]
        fn.restype = i32
        _fn = fn
    return _fn


def _flash_cuda(q, k, v, causal: bool, scale: float, with_lse: bool,
                out_dtype):
    """Launch the kernel on (B, H, T, D) views with any strides whose last
    one is 1; the output is (B, H, T, D) over (B, T, H, D) memory."""
    global launches
    B, H, T, D = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if tuple(t.shape) != (B, H, T, D):
            raise ValueError(f"{name} must be {(B, H, T, D)}, got "
                             f"{tuple(t.shape)}")
        if t.stride(3) != 1 or any(st % 4 for st in t.stride()[:3]):
            raise ValueError(f"{name}: head_dim must have unit stride and "
                             "the other strides be multiples of 4")
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name} must be {4 * t.element_size()}-byte "
                             "aligned")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes {KERNEL_DTYPES}, got "
                        f"{q.dtype}")
    out_dtype = out_dtype or q.dtype
    if out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"out_dtype must be one of {KERNEL_DTYPES}, got "
                        f"{out_dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernel's grid")
    out = torch.empty(B, T, H, D, dtype=out_dtype,
                      device=dev).transpose(1, 2)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=dev) \
        if with_lse else None
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    fn = _kernel_fn()
    err = fn(int(q.dtype == torch.bfloat16),
             int(out_dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if lse is not None else None, B, H, T, D,
             ctypes.cast(strides, ctypes.c_void_p), scale, int(causal),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (q={tuple(q.shape)}, {q.dtype})")
    launches += 1
    return out, lse


def _flash(q, k, v, causal, scale, with_lse, out_dtype, impl):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be matching (B, H, T, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if resolve_impl(impl, q) == "torch":
        return flash_attention_torch(q, k, v, causal, s, with_lse,
                                     out_dtype)
    return _flash_cuda(q, k, v, causal, s, with_lse, out_dtype)


class _FlashForward(torch.autograd.Function):
    """Forward through the kernel (or the plain version on the CPU); the
    backward is not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, with_lse, out_dtype, impl):
        out, lse = _flash(q, k, v, causal, scale, with_lse, out_dtype, impl)
        return (out, lse) if with_lse else out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash backward: ROADMAP queue 2, item 2")


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    impl: Optional[str] = None):
    """q/k/v: (B, H, T, D) f32 or bf16, any strides with unit head_dim
    stride.  Returns softmax(q kᵀ scale) v, (B, H, T, D) in q's dtype;
    ``scale`` defaults to 1/sqrt(D).  ``impl``: auto | torch | cuda."""
    return _FlashForward.apply(q, k, v, causal, scale, False, None, impl)


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             out_dtype=None, impl: Optional[str] = None):
    """Like :func:`flash_attention`, and also the per-row log-sum-exp
    (B, H, T) f32 in the scaled-logits domain.  ``out_dtype`` overrides the
    output dtype (e.g. f32 partials for bf16 inputs)."""
    return _FlashForward.apply(q, k, v, causal, scale, True, out_dtype,
                               impl)
