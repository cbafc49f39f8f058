"""Flash attention, forward and backward — blockwise attention without a
materialized (T, T) score matrix.

Two data paths, like the JAX package's ``ops/flash_attention.py``:

- the plain versions, written with whole (T, T) scores: the forward
  ``flash_attention_torch`` (the same f32 math as the TPU kernel: q scaled
  in f32 before the dot, causal mask ``k <= q`` filled with ``-1e30``,
  softmax, ``lse = m + log(l)``) and the backward
  ``flash_attention_bwd_torch`` (p recomputed from the LSE, then dq, dk
  and dv, the arithmetic of both TPU backward kernels).  They are what a
  CPU tensor gets, and the oracles.
- the CUDA kernels, launched for CUDA tensors: ``csrc/flash_attention.cu``
  (replacing the Pallas ``_fwd_kernel``) and ``csrc/flash_attention_bwd.cu``
  (``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``).  They read q/k/v/dO
  through their strides, so a (B, T, heads, D) projection seen as
  (B, H, T, D) is read in place, and write their outputs in (B, T, H, D)
  memory order.  ``launches``, ``dq_launches`` and ``dkv_launches`` count
  their launches.

``flash_attention`` and ``flash_attention_with_lse`` are one
``torch.autograd.Function``.  When an input needs a gradient the forward
also emits the LSE and saves ``(q, k, v, out, lse)`` (the JAX
``_fwd_rule``); the inference path skips the LSE write.  The backward
computes ``delta = rowsum(dO·O) − g_lse`` in torch, as the JAX package does
outside Pallas, then runs the dq and dk/dv kernels (CUDA tensors) or the
plain version (CPU tensors); the LSE output's cotangent enters only
through delta.  The forward and both backward kernels run every product
on the tensor cores in 3xTF32 (each f32 operand split into two TF32
parts, three products summed in f32; ``csrc/mma_tf32.cuh``), which keeps
the plain version's f32 accuracy; each gradient element is written by one
block, so the gradients repeat bitwise.  Any T works; the kernels mask ragged tiles themselves, with no
padded copies.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops._impl import launched, resolve_impl

NEG_INF = -1e30
KERNEL = "flash_attention"
KERNEL_BWD = "flash_attention_bwd"
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# launches of the CUDA kernels issued eagerly (one per call that took the
# kernel route; a call under CUDA-graph capture adds 0: ``_impl.launched``):
# the forward, and the backward's dq and dk/dv kernels
launches = 0
dq_launches = 0
dkv_launches = 0

_fn = None
_bwd_fns = None


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
    launches += launched()
    return out, lse


def _flash(q, k, v, causal, scale, with_lse, out_dtype, impl):
    if resolve_impl(impl, q) == "torch":
        return flash_attention_torch(q, k, v, causal, scale, with_lse,
                                     out_dtype)
    return _flash_cuda(q, k, v, causal, scale, with_lse, out_dtype)


# -- backward -----------------------------------------------------------------

def _delta(out, dO, g_lse):
    """delta = rowsum(dO·O) − g_lse, (B, H, T) f32 (the JAX ``_flash_bwd``
    computes it in XLA, outside the kernels)."""
    delta = (dO.to(torch.float32) * out.to(torch.float32)).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.to(torch.float32)
    return delta


def _bwd_plain(q, k, v, dO, lse, delta, causal: bool, scale: float):
    """dq, dk, dv from p = exp(q·kᵀ·scale − lse) over whole (T, T) scores,
    f32 math, each gradient in its input's dtype."""
    f32 = torch.float32
    qf, kf, vf, gf = (t.to(f32) for t in (q, k, v, dO))
    p = torch.exp(torch.matmul(qf * scale, kf.transpose(-1, -2))
                  - lse[..., None])
    if causal:
        T = q.shape[-2]
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        p = torch.where(keep, p, 0.0)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_torch(q, k, v, out, lse, dO, g_lse=None,
                              causal: bool = False,
                              scale: Optional[float] = None):
    """Plain version of both TPU backward kernels over (B, H, T, D): the
    gradients (dq, dk, dv) of ``flash_attention_with_lse`` for the output
    cotangent ``dO`` and the optional LSE cotangent ``g_lse`` (B, H, T)."""
    s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _bwd_plain(q, k, v, dO, lse, _delta(out, dO, g_lse), causal, s)


def _bwd_kernel_fns():
    global _bwd_fns
    if _bwd_fns is None:
        lib = _build.load(KERNEL_BWD)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        dq, dkv = lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv
        dq.argtypes = [i32, i32] + [ptr] * 7 + [i32] * 4 \
            + [ptr, ctypes.c_float, i32, ptr]
        dkv.argtypes = [i32, i32] + [ptr] * 8 + [i32] * 4 \
            + [ptr, ctypes.c_float, i32, ptr]
        dq.restype = dkv.restype = i32
        _bwd_fns = (dq, dkv)
    return _bwd_fns


def _check_bwd(q, k, v, dO, lse, delta):
    """Everything the backward kernels cannot take raises here, before
    anything is built or launched."""
    B, H, T, D = q.shape
    dev = q.device
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernels take {KERNEL_DTYPES}, got "
                        f"{q.dtype}")
    if dO.dtype not in (q.dtype, torch.float32):
        raise TypeError(f"dO must be {q.dtype} or float32, got {dO.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernels' grid")
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", dO)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if name in "kv" and t.dtype != q.dtype:
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
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != (B, H, T) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, H, T) float32 "
                             f"tensor on {dev}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def _bthd_empty(like):
    """A (B, H, T, D) tensor over (B, T, H, D) memory, the layout the
    forward writes and the projection's gradient wants."""
    B, H, T, D = like.shape
    return torch.empty(B, T, H, D, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _strides(*ts):
    """The (b, h, t) strides of each tensor, as the C array the kernels
    take (the caller keeps it alive across the call)."""
    flat = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_bwd_dq(q, k, v, dO, lse, delta, causal: bool, scale: float):
    """Launch the dq kernel: dq (B, H, T, D) in q's dtype over (B, T, H, D)
    memory."""
    global dq_launches
    _check_bwd(q, k, v, dO, lse, delta)
    B, H, T, D = q.shape
    dq = _bthd_empty(q)
    strides = _strides(q, k, v, dO, dq)
    err = _bwd_kernel_fns()[0](
        int(q.dtype == torch.bfloat16), int(dO.dtype == torch.bfloat16),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, T, D,
        ctypes.cast(strides, ctypes.c_void_p), scale, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash backward dq kernel launch failed: CUDA "
                           f"error {err} (q={tuple(q.shape)}, {q.dtype})")
    dq_launches += launched()
    return dq


def flash_bwd_dkv(q, k, v, dO, lse, delta, causal: bool, scale: float):
    """Launch the dk/dv kernel: (dk, dv), each (B, H, T, D) in k's dtype
    over (B, T, H, D) memory."""
    global dkv_launches
    _check_bwd(q, k, v, dO, lse, delta)
    B, H, T, D = q.shape
    dk, dv = _bthd_empty(k), _bthd_empty(v)
    strides = _strides(q, k, v, dO, dk, dv)
    err = _bwd_kernel_fns()[1](
        int(q.dtype == torch.bfloat16), int(dO.dtype == torch.bfloat16),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dO.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, T, D, ctypes.cast(strides, ctypes.c_void_p), scale,
        int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash backward dk/dv kernel launch failed: "
                           f"CUDA error {err} (q={tuple(q.shape)}, "
                           f"{q.dtype})")
    dkv_launches += launched()
    return dk, dv


def _kernel_grad(dO, dtype):
    """dO as the kernels read it: ``dtype`` (the inputs') or float32, with
    unit head_dim stride and 16-byte rows.  Autograd may hand in any
    layout (an expanded scalar's zero strides, say); a copy fixes that."""
    if dO.dtype != dtype:
        dO = dO.to(torch.float32)
    if dO.stride(3) != 1 or any(st % 4 for st in dO.stride()[:3]) \
            or dO.data_ptr() % (4 * dO.element_size()):
        dO = dO.contiguous()
    return dO


def flash_attention_bwd(q, k, v, out, lse, dO, g_lse=None,
                        causal: bool = False, scale: Optional[float] = None,
                        impl: Optional[str] = None):
    """(dq, dk, dv): the two backward kernels for CUDA tensors, the plain
    version for CPU ones (``ops/_impl.resolve_impl``)."""
    s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    delta = _delta(out, dO, g_lse)
    if resolve_impl(impl, q) == "torch":
        return _bwd_plain(q, k, v, dO, lse, delta, causal, s)
    dO = _kernel_grad(dO, q.dtype)
    lse = lse.contiguous()
    dq = flash_bwd_dq(q, k, v, dO, lse, delta, causal, s)
    dk, dv = flash_bwd_dkv(q, k, v, dO, lse, delta, causal, s)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Forward through the kernel (or the plain version on the CPU); under
    grad it also emits and saves the LSE, and the backward runs the dq and
    dk/dv kernels (or the plain backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, with_lse, out_dtype, impl,
                train):
        out, lse = _flash(q, k, v, causal, scale, with_lse or train,
                          out_dtype, impl)
        if train:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.cfg = (causal, scale, with_lse, impl)
        return (out, lse) if with_lse else out

    @staticmethod
    def backward(ctx, g_out, g_lse=None):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, with_lse, impl = ctx.cfg
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, g_out, g_lse if with_lse else None, causal,
            scale, impl)
        return dq, dk, dv, None, None, None, None, None, None


def _apply(q, k, v, causal, scale, with_lse, out_dtype, impl):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be matching (B, H, T, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    s = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _Flash.apply(q, k, v, causal, s, with_lse, out_dtype, impl,
                        train)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    impl: Optional[str] = None):
    """q/k/v: (B, H, T, D) f32 or bf16, any strides with unit head_dim
    stride.  Returns softmax(q kᵀ scale) v, (B, H, T, D) in q's dtype;
    ``scale`` defaults to 1/sqrt(D).  ``impl``: auto | torch | cuda.
    Differentiable in q, k and v."""
    return _apply(q, k, v, causal, scale, False, None, impl)


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             out_dtype=None, impl: Optional[str] = None):
    """Like :func:`flash_attention`, and also the per-row log-sum-exp
    (B, H, T) f32 in the scaled-logits domain.  ``out_dtype`` overrides the
    output dtype (e.g. f32 partials for bf16 inputs).  Differentiable in
    both outputs."""
    return _apply(q, k, v, causal, scale, True, out_dtype, impl)
