"""Ring attention — sequence/context parallelism over the mesh ``seq``
axis; the JAX package's ``parallel/ring_attention.py``.

Each rank holds one block of the sequence axis of q, k and v (rank r
tokens ``r·T_l`` … ``(r+1)·T_l − 1``).  Hop i attends the rank's query
block to the k/v block it holds, then passes k and v (one stacked
buffer) one place round the ring with ``comm.ppermute``; after n hops
every query block has met every key block, with O(T/n) memory a rank.
Causal masking uses absolute positions.

Two hop bodies, as in JAX:

- ``_ring_local``: einsum logits of the hop and an online softmax (the
  flash statistics m and l) in plain PyTorch;
- ``_ring_local_flash``: the flash kernel for each hop
  (``flash_attention_with_lse``, the hand-written CUDA kernel on the
  card, its plain version on the CPU), the hop partials merged through
  their log-sum-exp in f32 (``o = Σ o_i·exp(lse_i − lse)``).  The diagonal
  hop runs causal, earlier blocks run full, and a block wholly in the
  future launches nothing.  The merge is differentiable: each hop's LSE
  cotangent enters its flash backward as a shift of delta, so the dq
  and dk/dv kernels run once a hop that launched a forward.

Both bodies differentiate through ``ppermute``, whose transpose sends
each block's cotangent back the way the block came.  Every rank runs the
same collectives in the same order: a future block no kernel reads still
joins the graph (``_Keep``), so its rotation's backward runs on every
rank.

``sequence_sharded(mesh, T)`` marks a forward whose token axis the
caller sharded over ``seq`` (the Estimator's feed does):
``TransformerLayer`` then takes absolute positions and
``ops/attention.py`` sends attention round the ring.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from analytics_zoo_tpu_torch.common.context import (SEQ_AXIS, Mesh, P,
                                                    get_context)
from analytics_zoo_tpu_torch.parallel import comm

NEG = -1e30


class _Keep(torch.autograd.Function):
    """``anchor`` passed through, with ``other`` made part of the graph:
    its gradient is zeros.  A ring block no kernel reads still has its
    rotation's backward run, on every rank alike."""

    @staticmethod
    def forward(ctx, anchor, other):
        ctx.shape = (other.shape, other.dtype, other.device)
        return anchor.view_as(anchor)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.shape
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _ring_local(q, k, v, *, mesh: Mesh, axis_name: str, causal: bool,
                scale: Optional[float], kernel_impl=None):
    """Per-shard einsum body.  q/k/v: (B, H, T_local, D)."""
    n, idx = mesh.size(axis_name), mesh.index(axis_name)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    f32 = torch.float32
    q32 = q.to(f32)
    q_pos = idx * Tq + torch.arange(Tq, device=q.device)
    o = torch.zeros(B, H, Tq, D, dtype=f32, device=q.device)
    l_sum = torch.zeros(B, H, Tq, dtype=f32, device=q.device)
    m = torch.full((B, H, Tq), NEG, dtype=f32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        src = (idx - i) % n
        logits = torch.einsum("bhqd,bhkd->bhqk", q32, kv[0].to(f32)) * s
        if causal:
            k_pos = src * Tk + torch.arange(Tk, device=q.device)
            keep = k_pos[None, :] <= q_pos[:, None]
            logits = torch.where(keep, logits, -1e9)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                               kv[1].to(f32))
        m = m_new
        if i < n - 1:
            kv = comm.ppermute(kv, axis_name, 1, mesh)
    return (o / torch.clamp_min(l_sum, 1e-30)[..., None]).to(q.dtype)


def _ring_local_flash(q, k, v, *, mesh: Mesh, axis_name: str, causal: bool,
                      scale: Optional[float], kernel_impl=None):
    """Per-shard body with the flash kernel computing each hop (f32 hop
    partials, merged through their LSE, rounded once at the end)."""
    from analytics_zoo_tpu_torch.ops.flash_attention import \
        flash_attention_with_lse
    n, idx = mesh.size(axis_name), mesh.index(axis_name)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    f32 = torch.float32
    o_run = torch.zeros(q.shape, dtype=f32, device=q.device)
    lse_run = torch.full(q.shape[:-1], NEG, dtype=f32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        src = (idx - i) % n
        if causal and src > idx:
            # a block wholly in the future: no kernel, no merge term
            o_run = _Keep.apply(o_run, kv)
        else:
            o_h, lse_h = flash_attention_with_lse(
                q, kv[0], kv[1], causal and src == idx, s, out_dtype=f32,
                impl=kernel_impl)
            lse_new = torch.logaddexp(lse_run, lse_h)
            w_old = torch.exp(lse_run - lse_new)[..., None]
            w_new = torch.exp(lse_h - lse_new)[..., None]
            o_run = o_run * w_old + o_h * w_new
            lse_run = lse_new
        if i < n - 1:
            kv = comm.ppermute(kv, axis_name, 1, mesh)
    return o_run.to(q.dtype)


def ring_attention(q, k, v, mesh: Optional[Mesh] = None, *,
                   causal: bool = False, scale: Optional[float] = None,
                   axis_name: str = SEQ_AXIS, impl: str = "auto",
                   kernel_impl: Optional[str] = None):
    """q/k/v: this rank's (B, H, T_local, D) block of a sequence sharded
    over ``axis_name``; returns its block of the attention output.
    Equivalent to full softmax attention over all n·T_local tokens.

    impl: "xla" (the einsum body, (T_local, T_local) logits a hop),
    "flash" (the flash kernel a hop) or "auto": the flash body wherever
    the single-GPU dispatch (``ops/attention._select_flash``) would take
    the flash path, else the einsum body.  ``kernel_impl`` picks the flash
    kernel or its plain version (``ops/_impl.resolve_impl``)."""
    mesh = mesh if mesh is not None else get_context().mesh
    if impl == "auto":
        from analytics_zoo_tpu_torch.ops.attention import _select_flash
        impl = ("flash" if _select_flash(None, q.shape[-1], q.dtype, None,
                                         False) else "xla")
    if impl not in ("flash", "xla"):
        raise ValueError(f"unknown ring attention impl {impl!r} "
                         "(expected 'auto', 'flash', or 'xla')")
    body = _ring_local_flash if impl == "flash" else _ring_local
    return body(q, k, v, mesh=mesh, axis_name=axis_name, causal=causal,
                scale=scale, kernel_impl=kernel_impl)


def sequence_sharded_spec(mesh: Optional[Mesh] = None,
                          axis_name: str = SEQ_AXIS):
    return P(None, None, axis_name, None)


_shard = threading.local()


@contextlib.contextmanager
def sequence_sharded(mesh: Mesh, total_len: int,
                     axis_name: str = SEQ_AXIS):
    """Inside the block (on this thread) the model's token axis is
    sharded over ``axis_name``: each rank holds ``total_len / n``
    consecutive tokens, block ``mesh.index(axis_name)``."""
    prev = getattr(_shard, "state", None)
    _shard.state = (mesh, axis_name, int(total_len))
    try:
        yield
    finally:
        _shard.state = prev


def sequence_shard():
    """``(mesh, axis_name, total_len)`` inside ``sequence_sharded``, else
    None."""
    return getattr(_shard, "state", None)
