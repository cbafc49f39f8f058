"""Attention compute cores — the one dispatch every attention layer uses.

The counterpart of the JAX package's ``ops/attention.py``:

- ``_attention_torch`` / ``_attention_torch_bthd``: the plain einsum-softmax
  path (the JAX package's ``_attention_xla`` / ``_attention_xla_bthd``),
  which takes masks and attention dropout.
- the flash kernels (``ops/flash_attention.py``, hand-written CUDA on the
  card) for every call they can express.

Both routes are differentiable: the einsum path by autograd, the flash
path through its autograd Function, whose backward runs the dq and dk/dv
kernels on the card (the plain backward for CPU tensors).  Training keeps
the flash selection unchanged; attention dropout takes the einsum path,
drawing from the caller's generator.

Differences from the JAX module, on purpose:

- With ``use_flash=None`` a call takes the flash path whenever the kernel
  can express it — no mask, no dropout, a head_dim and dtype it is built
  for — at any T: the kernel for CUDA tensors, its plain version
  (``flash_attention_torch``) for CPU ones, so the CPU path and the card's
  reference are one function.  The JAX package's crossover (flash only
  from T = 1024) is a TPU measurement; the H100's crossover is measured
  by ``chip_smoke.py`` for a later threshold.
- A selected kernel that fails raises: there is no ``try``/``except`` that
  slides onto the plain path.
- No sequence-parallel (ring) path: the single-GPU port has no mesh, so
  the JAX module's ``_seq_parallel_mesh`` would always answer None; it
  comes with the multi-GPU slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops import flash_attention as _fa


def _attention_core(q, k, v, eq_qk, eq_av, mask=None, causal=False,
                    scale=None, dropout_rate=0.0, dropout_rng=None):
    """Shared einsum-softmax body; logits are always (B, H, Tq, Tk) f32."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum(eq_qk, q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        logits = torch.where(keep, logits, -1e9)
    if mask is not None:
        logits = torch.where(mask.to(torch.bool), logits, -1e9)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep_p = 1.0 - dropout_rate
        draw = torch.rand(probs.shape, generator=dropout_rng,
                          device=probs.device)
        probs = torch.where(draw < keep_p, probs / keep_p, 0.0)
    return torch.einsum(eq_av, probs.to(v.dtype).to(torch.float32),
                        v.to(torch.float32)).to(v.dtype)


def _attention_torch(q, k, v, mask=None, causal=False, scale=None,
                     dropout_rate=0.0, dropout_rng=None):
    """q, k, v: (B, H, T, D).  mask: broadcastable to (B, H, Tq, Tk),
    1 = keep."""
    return _attention_core(q, k, v, "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd",
                           mask=mask, causal=causal, scale=scale,
                           dropout_rate=dropout_rate,
                           dropout_rng=dropout_rng)


def _attention_torch_bthd(q, k, v, mask=None, causal=False, scale=None,
                          dropout_rate=0.0, dropout_rng=None):
    """The same math in (B, T, H, D) layout, contracting in place."""
    return _attention_core(q, k, v, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd",
                           mask=mask, causal=causal, scale=scale,
                           dropout_rate=dropout_rate,
                           dropout_rng=dropout_rng)


def _select_flash(use_flash, head_dim: int, dtype, mask,
                  dropping: bool) -> bool:
    """Flash eligibility, shared by both layout front-ends.  ``None`` takes
    the flash path for every call the kernel can express; an explicit True
    is honoured unless a mask or dropout makes the kernel compute
    wrongly."""
    if use_flash is None:
        return (mask is None and not dropping
                and head_dim in _fa.KERNEL_HEAD_DIMS
                and dtype in _fa.KERNEL_DTYPES)
    if use_flash and (dropping or mask is not None):
        return False
    return bool(use_flash)


def attention_bthd(q, k, v, mask=None, causal: bool = False,
                   scale: Optional[float] = None,
                   use_flash: Optional[bool] = None,
                   dropout_rate: float = 0.0, dropout_rng=None,
                   impl: Optional[str] = None):
    """(B, T, heads, D) front-end used by ``MultiHeadAttention``.  The flash
    path hands the kernel (B, H, T, D) views of the projection layout (no
    copy) and gets back a (B, T, H, D)-contiguous result.  ``impl`` picks
    the flash kernel or its plain version (``ops/_impl.resolve_impl``)."""
    dropping = dropout_rate > 0.0 and dropout_rng is not None
    if _select_flash(use_flash, q.shape[-1], q.dtype, mask, dropping):
        out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  scale=scale, impl=impl)
        return out.transpose(1, 2)
    return _attention_torch_bthd(q, k, v, mask=mask, causal=causal,
                                 scale=scale, dropout_rate=dropout_rate,
                                 dropout_rng=dropout_rng)


def dot_product_attention(q, k, v, mask=None, causal: bool = False,
                          scale: Optional[float] = None,
                          use_flash: Optional[bool] = None,
                          dropout_rate: float = 0.0, dropout_rng=None,
                          impl: Optional[str] = None):
    """Multi-head attention core over (B, H, T, D); the flash path for
    every call the kernel can express, else the einsum path.  Attention
    dropout always takes the einsum path."""
    dropping = dropout_rate > 0.0 and dropout_rng is not None
    if _select_flash(use_flash, q.shape[-1], q.dtype, mask, dropping):
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                   impl=impl)
    return _attention_torch(q, k, v, mask=mask, causal=causal, scale=scale,
                            dropout_rate=dropout_rate,
                            dropout_rng=dropout_rng)
