"""Collectives over a mesh axis — the port's ``lax.psum``, ``ppermute``,
``all_gather`` and ``process_allgather``.

Each differentiable collective is a ``torch.autograd.Function`` whose
backward is its transpose under the port's SPMD convention: every rank
runs the same program on its own shard, and along the ``model``, ``pipe``
and ``expert`` axes the ranks compute ONE objective (their loss is
replicated), while along ``data`` and ``seq`` each rank's loss is its
share of the global one (the Estimator sums those shares' gradients).
So:

- ``psum`` (all-reduce out, copy back): the sum of a varying value whose
  result feeds the replicated objective; its cotangent is replicated, so
  the transpose copies it (Megatron's row-parallel output).
- ``copy_to`` (copy in, all-reduce back): a replicated value entering a
  varying computation; the transpose sums the ranks' partial cotangents
  (Megatron's column-parallel input).
- ``ppermute``: the block moves ``shift`` places along the axis; the
  transpose moves the cotangent back (the inverse rotation).
- ``all_gather``: the axis' shards concatenated along a dimension; the
  transpose takes this rank's slice of a replicated cotangent, or with
  ``varying=True`` sums the ranks' cotangents first (a reduce-scatter).

A CUDA tensor under a ``gloo`` group goes through a pinned host buffer,
because that is the group's backend (gloo takes CUDA tensors for few of
its collectives and for no point-to-point transfer); nothing is retried
on another backend.  Over an axis of one rank outside a world of one
each collective is the identity and communicates nothing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from analytics_zoo_tpu_torch.common.context import Mesh, get_context


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    return mesh if mesh is not None else get_context().mesh


def staged(t: torch.Tensor, group) -> bool:
    """True when ``t`` must travel through host memory: a CUDA tensor
    under a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``t`` (a new tensor)."""
    if staged(t, group):
        h = _host(t)
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_(t: torch.Tensor, axes: Sequence[str],
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum ``t`` in place over each axis of ``axes`` in turn (no
    autograd: gradients, weight sums)."""
    m = _mesh(mesh)
    for ax in axes:
        g = m.group(ax)
        if g is None:
            continue
        if staged(t, g):
            h = _host(t)
            dist.all_reduce(h, group=g)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=g)
    return t


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), ctx.group), None


def psum(x: torch.Tensor, axis: str, mesh: Optional[Mesh] = None):
    """Sum over ``axis`` of a varying value feeding the replicated
    objective; the backward passes the replicated cotangent through."""
    g = _mesh(mesh).group(axis)
    return x if g is None else _Psum.apply(x, g)


def copy_to(x: torch.Tensor, axis: str, mesh: Optional[Mesh] = None):
    """Identity forward; the backward sums the ranks' cotangents over
    ``axis`` (a replicated value entering a varying computation)."""
    g = _mesh(mesh).group(axis)
    return x if g is None else _CopyTo.apply(x, g)


def _shift(x: torch.Tensor, m: Mesh, axis: str, shift: int):
    """Send ``x`` ``shift`` places along ``axis``, receive from
    ``-shift`` places; a new tensor."""
    line, i = m.ranks(axis), m.index(axis)
    n = len(line)
    g = m.group(axis)
    dst, src = line[(i + shift) % n], line[(i - shift) % n]
    x = x.contiguous()
    send = _host(x) if staged(x, g) else x
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, g),
        dist.P2POp(dist.irecv, recv, src, g)])
    for r in reqs:
        r.wait()
    return recv.to(x.device) if recv.device != x.device else recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.cfg = (mesh, axis, shift)
        return _shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.cfg
        return _shift(g, mesh, axis, -shift), None, None, None


def ppermute(x: torch.Tensor, axis: str, shift: int = 1,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``lax.ppermute`` with the ring permutation ``j -> j + shift``:
    returns the block of the rank ``shift`` places before this one."""
    m = _mesh(mesh)
    if m.size(axis) == 1 or shift % m.size(axis) == 0:
        return x
    return _PPermute.apply(x, m, axis, shift)


def _gather(x: torch.Tensor, m: Mesh, axis: str, dim: int):
    g = m.group(axis)
    x = x.contiguous()
    src = _host(x) if staged(x, g) else x
    parts = [torch.empty_like(src) for _ in range(m.size(axis))]
    dist.all_gather(parts, src, group=g)
    return torch.cat(parts, dim=dim).to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, varying):
        ctx.cfg = (mesh, axis, dim, varying, x.shape[dim])
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, varying, n = ctx.cfg
        if varying:
            g = _reduce(g.contiguous(), mesh.group(axis))
        return (g.narrow(dim, mesh.index(axis) * n, n), None, None, None,
                None)


def all_gather(x: torch.Tensor, axis: str, dim: int = 0,
               mesh: Optional[Mesh] = None,
               varying: bool = False) -> torch.Tensor:
    """The shards of ``axis`` concatenated along ``dim`` in axis order.
    The backward takes this rank's slice of the cotangent; with
    ``varying=True`` (each rank's cotangent its own objective's) it sums
    the cotangents first."""
    m = _mesh(mesh)
    if m.size(axis) == 1:
        return x
    return _AllGather.apply(x, m, axis, dim % x.ndim, varying)


def all_gather_object(obj, mesh: Optional[Mesh] = None) -> List:
    """Every rank's ``obj`` over the mesh, in mesh order; a mesh of one
    rank returns ``[obj]``."""
    m = _mesh(mesh)
    ranks = [int(r) for r in m.devices.reshape(-1)]
    if len(ranks) == 1:
        return [obj]
    from analytics_zoo_tpu_torch.common.context import _group
    g = None if ranks == list(range(dist.get_world_size())) \
        else _group(tuple(ranks))
    out = [None] * len(ranks)
    dist.all_gather_object(out, obj, group=g)
    return out


def process_allgather(a, mesh: Optional[Mesh] = None) -> np.ndarray:
    """The JAX ``multihost_utils.process_allgather`` of a host array:
    every rank's ``a`` stacked in mesh order, (processes, ...)."""
    return np.stack([np.asarray(x) for x in
                     all_gather_object(np.asarray(a), mesh=mesh)])
