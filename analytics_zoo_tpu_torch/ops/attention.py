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

Sequence parallelism (``_seq_parallel_mesh``, as in JAX): inside a
forward whose token axis is sharded over the mesh's ``seq`` axis
(``parallel/ring_attention.sequence_sharded``, which the Estimator's
feed sets) every attention call rides the ring
(``parallel/ring_attention.ring_attention``), the flash kernel a hop
where the single-GPU dispatch would take it.  It warns and takes the
gathered path only where JAX does: a mask or attention dropout (k and v
gathered over ``seq``, the causal mask at absolute positions), or a
token axis the ``seq`` axis does not divide (the feed then leaves the
tokens whole, and attention runs over them on each rank).
"""

from __future__ import annotations

import math
import warnings
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


def _seq_parallel_mesh(mask, dropping: bool):
    """``(mesh, axis, total_len)`` of the sequence sharding this call
    rides, ``"gathered"`` for a sharded call the ring cannot express, or
    None."""
    from analytics_zoo_tpu_torch.parallel.ring_attention import \
        sequence_shard
    state = sequence_shard()
    if state is None:
        from analytics_zoo_tpu_torch.common import context
        ctx = context._global_ctx       # never made here as a side effect
        if ctx is not None and ctx.mesh.size(context.SEQ_AXIS) > 1:
            warnings.warn(
                "sequence-parallel mesh active but this attention call "
                "cannot ride the ring (T % seq != 0: the tokens are not "
                "sharded) - attending over the whole sequence",
                stacklevel=3)
        return None
    if mask is not None or dropping:
        warnings.warn(
            "sequence-parallel mesh active but this attention call cannot "
            "ride the ring (mask/dropout present) - falling back to the "
            "gathered path", stacklevel=3)
        return ("gathered",) + state
    return state


def _gathered(q, k, v, state, mask, causal, scale, dropout_rate,
              dropout_rng):
    """Sharded (B, H, T_local, D) q/k/v with k and v gathered over the
    sequence axis: the einsum path at absolute positions."""
    from analytics_zoo_tpu_torch.parallel import comm
    _, mesh, axis, _ = state
    tq = q.shape[-2]
    kg = comm.all_gather(k, axis, dim=-2, mesh=mesh, varying=True)
    vg = comm.all_gather(v, axis, dim=-2, mesh=mesh, varying=True)
    if causal:
        q_pos = mesh.index(axis) * tq + torch.arange(tq, device=q.device)
        keep = torch.arange(kg.shape[-2], device=q.device)[None, :] \
            <= q_pos[:, None]
        mask = keep if mask is None else mask.to(torch.bool) & keep
    return _attention_torch(q, kg, vg, mask=mask, causal=False, scale=scale,
                            dropout_rate=dropout_rate,
                            dropout_rng=dropout_rng)


def _sequence_parallel(q, k, v, mask, causal, scale, dropout_rate,
                       dropout_rng, impl):
    """(B, H, T_local, D) attention of a sequence-sharded call, or None
    where the call is not sharded."""
    dropping = dropout_rate > 0.0 and dropout_rng is not None
    state = _seq_parallel_mesh(mask, dropping)
    if state is None:
        return None
    if state[0] == "gathered":
        return _gathered(q, k, v, state, mask, causal, scale, dropout_rate,
                         dropout_rng)
    from analytics_zoo_tpu_torch.parallel.ring_attention import \
        ring_attention
    mesh, axis, _ = state
    return ring_attention(q, k, v, mesh, causal=causal, scale=scale,
                          axis_name=axis, kernel_impl=impl)


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
    sp = _sequence_parallel(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), mask, causal, scale,
                            dropout_rate, dropout_rng, impl)
    if sp is not None:
        return sp.transpose(1, 2)
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
    sp = _sequence_parallel(q, k, v, mask, causal, scale, dropout_rate,
                            dropout_rng, impl)
    if sp is not None:
        return sp
    if _select_flash(use_flash, q.shape[-1], q.dtype, mask, dropping):
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                   impl=impl)
    return _attention_torch(q, k, v, mask=mask, causal=causal, scale=scale,
                            dropout_rate=dropout_rate,
                            dropout_rng=dropout_rng)
