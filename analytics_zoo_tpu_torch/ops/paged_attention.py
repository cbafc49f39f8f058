"""Paged decode attention — one query token per row over a block-pool KV
cache addressed through per-row block tables (the vLLM paged layout).

Two data paths, like the JAX package's ``ops/paged_attention.py``:

- ``paged_attention_torch`` — the plain version: gather the table's blocks,
  dequantize (int8 pools), re-linearize to the monolithic cache layout and
  run the einsum + ``-1e30`` mask + softmax that decode runs over a
  monolithic cache.  It mirrors the JAX package's ``paged_attention_xla``
  and is what a CPU tensor gets.
- the CUDA kernel ``csrc/paged_attention.cu`` (replacing the Pallas
  ``_paged_kernel``), launched for CUDA tensors: the walk over a row's
  valid positions is split into ``partitions(n_table)`` partitions, each a
  block of one thread-block cluster per (row, head); its warps take chunks
  of positions with an online softmax in registers (int8 pools
  dequantized in registers), and the partitions' partials merge through
  the cluster's shared memory.  ``launches`` counts its launches.

Quantization contract: ``inference/quantize.kv_pack_int8`` /
``kv_unpack_int8`` (symmetric, scale = per-(block, head) absmax / 127).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.inference.quantize import kv_unpack_int8
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops._impl import (H100_SMS, launched,
                                               resolve_impl)
from analytics_zoo_tpu_torch.ops._impl import sm_count as _sm_count

NEG_INF = -1e30
KERNEL = "paged_attention"
KERNEL_HEAD_DIMS = (4, 8, 16, 32, 64, 128)
# the kernel's split of a row's table: partitions of at least this many
# entries (two a warp of the block), at most MAX_PARTS of them (a portable
# thread-block cluster), and no more blocks than the card runs at once
# (BLOCKS_PER_SM a streaming multiprocessor: __launch_bounds__(256, 2))
PART_ENTRIES = 16
MAX_PARTS = 8
BLOCKS_PER_SM = 2

# launches of the CUDA kernel issued eagerly (one per call that took the
# kernel route; a call under CUDA-graph capture adds 0: ``_impl.launched``)
launches = 0

_fns = None


def _check(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale):
    if q.ndim != 3:
        raise ValueError(f"q must be (rows, heads, head_dim), got "
                         f"{tuple(q.shape)}")
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pools must be matching (n_blocks, block_len, heads, "
            f"head_dim), got {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError(
            f"block_tables must be (rows, n_table), got "
            f"{tuple(block_tables.shape)} for {q.shape[0]} rows")
    if tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(
            f"lengths must be (rows,), got {tuple(lengths.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale/v_scale must be given together")
    if k_scale is not None and tuple(k_scale.shape) != (
            k_pool.shape[0], k_pool.shape[2]):
        raise ValueError(
            f"scales must be (n_blocks, heads), got {tuple(k_scale.shape)} "
            f"for pool {tuple(k_pool.shape)}")


def _gather_dequant(pool, scale, block_tables):
    """(A, n_table, block_len, heads, head_dim) f32 — the table's blocks in
    logical order, dequantized when the pool is int8."""
    blocks = pool[block_tables.long()]
    if scale is not None:
        blocks = kv_unpack_int8(blocks, scale[block_tables.long()])
    return blocks.to(torch.float32)


def paged_attention_torch(q, k_pool, v_pool, block_tables, lengths,
                          k_scale=None, v_scale=None):
    """Plain version: gather -> dequant -> the decode attention over a
    monolithic cache holding the same values."""
    kc = _gather_dequant(k_pool, k_scale, block_tables)
    vc = _gather_dequant(v_pool, v_scale, block_tables)
    A, T, bl, nh, hd = kc.shape
    kc = kc.reshape(A, T * bl, nh, hd)
    vc = vc.reshape(A, T * bl, nh, hd)
    att = torch.einsum("bhd,bkhd->bhk", q.to(torch.float32), kc) \
        * (1.0 / math.sqrt(hd))
    valid = torch.arange(T * bl, device=q.device)[None] \
        < lengths.to(q.device)[:, None]                       # (A, T*bl)
    att = torch.where(valid[:, None], att, NEG_INF)
    att = torch.softmax(att, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", att, vc)


def partitions(n_table: int, parts: Optional[int] = None, pairs: int = 1,
               sms: int = H100_SMS):
    """``(parts, per_part)``: the kernel walks a row's table in ``parts``
    partitions of ``per_part`` entries (the last may hold fewer).  The rule:
    one partition a PART_ENTRIES entries, so decode-time tables of up to 16
    entries take a plain launch, at most MAX_PARTS, and at most as many as
    keep the blocks of the call's ``pairs`` (row, head) pairs within one
    wave of BLOCKS_PER_SM on each of ``sms`` multiprocessors (a second,
    partial wave costs more than the split saves).  ``parts`` forces a count
    (clamped to 1..min(MAX_PARTS, n_table); the count returned is the one
    that covers the table)."""
    n_table = int(n_table)
    if parts is None:
        parts = min(-(-n_table // PART_ENTRIES),
                    BLOCKS_PER_SM * int(sms) // max(1, int(pairs)))
    parts = max(1, min(int(parts), MAX_PARTS, n_table))
    per_part = -(-n_table // parts)
    return -(-n_table // per_part), per_part


def _kernel_fns():
    global _fns
    if _fns is None:
        lib = _build.load(KERNEL)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        f32 = lib.paged_attention_f32
        f32.argtypes = [ptr] * 6 + [i32] * 7 + [ctypes.c_float, ptr]
        f32.restype = i32
        i8 = lib.paged_attention_int8
        i8.argtypes = [ptr] * 8 + [i32] * 7 + [ctypes.c_float, ptr]
        i8.restype = i32
        _fns = (f32, i8)
    return _fns


def _paged_cuda(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale,
                parts: Optional[int] = None):
    """The kernel's launch; ``parts`` forces the partition count (tests and
    ``chip_smoke.py``), else ``partitions``' rule picks it."""
    global launches
    dev = q.device
    quant = k_scale is not None
    operands = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
                "block_tables": block_tables, "lengths": lengths}
    if quant:
        operands.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in operands.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    want_pool = torch.int8 if quant else torch.float32
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k_pool.dtype != want_pool or v_pool.dtype != want_pool:
        raise TypeError(f"pools must be {want_pool} "
                        f"({'with' if quant else 'without'} scales), got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise TypeError("scales must be float32")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    A, nh, hd = q.shape
    n_blocks, bl, pnh, phd = k_pool.shape
    if (pnh, phd) != (nh, hd):
        raise ValueError(f"pool heads/head_dim {(pnh, phd)} != q's "
                         f"{(nh, hd)}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    # a lane reads 16 bytes of a head vector at a time (all of it when it
    # is shorter): q as float4, int8 pools up to 16 elements
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        align = 16 if t is q else min(16, hd * t.element_size())
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    out = torch.empty_like(q)
    f32_fn, i8_fn = _kernel_fns()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_table = int(block_tables.shape[1])
    dims = (A, nh, hd, bl, n_table,
            *partitions(n_table, parts, A * nh, _sm_count(dev.index or 0)),
            1.0 / math.sqrt(hd), stream)
    if quant:
        err = i8_fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    k_scale.data_ptr(), v_scale.data_ptr(),
                    block_tables.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), *dims)
    else:
        err = f32_fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                     block_tables.data_ptr(), lengths.data_ptr(),
                     out.data_ptr(), *dims)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err} (shapes q={tuple(q.shape)}, "
                           f"pool={tuple(k_pool.shape)})")
    launches += launched()
    return out


def paged_attention(q, k_pool, v_pool, block_tables, lengths,
                    k_scale=None, v_scale=None,
                    impl: Optional[str] = None):
    """One decode token per row over a paged KV pool.

    - ``q`` (rows, heads, head_dim) f32 — the current token's queries.
    - ``k_pool``/``v_pool`` (n_blocks, block_len, heads, head_dim) — f32,
      or int8 with ``k_scale``/``v_scale`` (n_blocks, heads) f32.
    - ``block_tables`` (rows, n_table) int32 — logical block j of row a
      lives in pool block ``block_tables[a, j]``; every entry must name a
      pool block (the kernel cannot check device-resident entries without
      a host sync).  Entries past a row's allocation conventionally point
      at block 0, the batcher's trash block: their positions are masked by
      ``lengths``.
    - ``lengths`` (rows,) int32 — valid cache positions per row.

    Returns (rows, heads, head_dim) f32.  ``impl``: auto | torch | cuda
    (see ``ops/_impl.resolve_impl``)."""
    _check(q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale)
    if resolve_impl(impl, q) == "torch":
        return paged_attention_torch(q, k_pool, v_pool, block_tables,
                                     lengths, k_scale, v_scale)
    return _paged_cuda(q, k_pool, v_pool, block_tables, lengths,
                       k_scale, v_scale)
