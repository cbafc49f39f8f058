"""Continuous batching for autoregressive serving.

The token-level scheduler of the JAX package's ``serving/generate.py``
(the Orca / vLLM continuous-batching shape), in its two KV modes:

- **slot map** — decode runs over ``max_active_slots`` rows a lane.
  Requests claim a free slot at a decode-step boundary, generate, and free
  it the moment they hit EOS, their token budget or their deadline; the
  freed slot refills at the next boundary, so one slow request never gates
  its neighbours.
- **monolithic lanes** (``paged=False``, the default) — one lane per
  usable capacity bucket, each holding fixed ``(max_active, bucket)``
  per-slot caches; a request lands in the smallest lane that holds prompt
  + budget, is prefilled through ``init_decode`` and copied into its slot,
  and decodes through ``decode_step``.
- **bare-state lanes** — a model whose ``init_decode`` takes no
  ``cache_len`` (``models/seq2seq.Seq2seq``: an LSTM stack's per-layer
  ``(h, c)``, no KV cache) has no length axis, so every request takes the
  first lane, its budget is not clipped by the lane's capacity, and every
  prompt bucket is served whatever the lane.  Prefill is
  ``init_decode(prompt, lengths)`` and yields no logits: a row's first
  decode step is fed ``start_id``, and its first token comes from the
  first quantum.  Such a model rebuilds nothing from tokens, so it takes
  no checkpoint and a resume restarts from token 0, loudly
  (``resume_failed``).
- **paged lane** (``paged=True``) — KV lives in a fixed pool of
  ``block_len``-token blocks (``serving/kvpool.BlockPool``); each slot
  holds a block table.  Admission is bounded by free blocks as well as
  free slots, and prompts that share a registered full-block prefix share
  its resident pages (``PrefixIndex``): a prefix hit prefills only the
  suffix.  Decode goes through ``TransformerLM.decode_paged``, whose
  attention is the hand-written CUDA kernel on the card.
- **decode quanta as CUDA graphs** — a boundary runs ``decode_quantum``
  greedy steps with ONE host sync.  The quantum reads static device
  buffers (tokens, and in paged mode block tables and positions), filled
  from pinned host arrays at the boundary, and writes a static (K, A)
  token block.  ``warm()`` captures each lane's quantum as a CUDA graph
  (``inference/aot.capture``), the counterpart of the JAX package's
  compiled ``lax.scan`` program; a lane without one runs the same quantum
  eagerly (``eager_quanta``).  Admission prefills run eagerly: their
  commit indexes by a boolean mask, which syncs the host.
- **events, not policy** — ``step()`` returns ``GenEvent``s
  (first_token / partial / finish / shed / quarantine / resume_failed);
  the engine turns them into result writes, acks, quarantines and
  metrics.  A poisoned request quarantines ITS SLOT only.
- **continuity** — with ``checkpoint_interval`` set, every active slot is
  snapshotted (prompt and tokens so far, from the host lists the boundary
  already holds: no device sync) each time it accrues that many tokens;
  the engine drains and spools the snapshots.  With ``resume`` set, a
  request carrying ``resume_tokens`` (a dead owner's checkpoint) is
  prefilled over prompt + those tokens and decodes on from that exact
  position: greedy decode makes the continuation the uninterrupted one's,
  and its streamed partials stay prefixes of the terminal.  In int8
  lanes the KV a run leaves depends on its path (decode attends over int8
  K/V, prefill over exact K/V), so there a resume prefills its prompt and
  replays the prefix through the decode quanta, each output forced to the
  prefix's next token (the ``force`` buffer), and leaves the uninterrupted
  run's codes and scales; its first token comes after the replay.  The
  JAX package prefills over the prefix in int8 lanes too.  A prefix that
  cannot be replayed restarts the request from token 0, loudly
  (``resume_failed``).

Every prompt is validated on the host before any of its tokens reaches
the device: an out-of-range embedding index on CUDA is a device-side
assert, which ends the process.

``paged=True`` needs the paged decode API (``TransformerLM``); asking for
it with another model raises ``NotImplementedError``.
"""

from __future__ import annotations

import inspect
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.observability import get_recorder
from analytics_zoo_tpu_torch.inference import aot
from analytics_zoo_tpu_torch.inference.quantize import (kv_pack_int8,
                                                        kv_unpack_int8)
from analytics_zoo_tpu_torch.serving.kvpool import BlockPool, PrefixIndex

logger = logging.getLogger(__name__)


def _pow2_ceil(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def _pow2_ladder(lo: int, hi: int) -> List[int]:
    """Pow-2 values in [lo, hi] (hi rounded up), smallest first."""
    out = []
    b = _pow2_ceil(lo)
    hi = _pow2_ceil(hi)
    while b <= hi:
        out.append(b)
        b *= 2
    return out


@dataclass
class GenerationParams:
    """``ServingParams.generation`` surface (config.yaml ``generation:``).

    - ``max_active_slots`` — decode rows: the in-flight batch width.
    - ``max_tokens`` — per-request generation budget (records may lower
      it via ``{"gen": {"max_tokens": n}}``, never raise it).
    - ``eos_id`` — stop token (None = budget-only stopping).
    - ``max_prompt_len`` — longest accepted prompt; longer quarantines.
    - ``bucket_lens`` — capacity ladder (default ``pow2(max_prompt_len +
      max_tokens)``): one monolithic lane per usable value; paged mode
      serves one lane at the largest, so a slot's block table has
      ``bucket / block_len`` entries.
    - ``prefill_buckets`` — pow-2 prompt padding ladder (default 8 ..
      pow2(max_prompt_len)).
    - ``stream_interval`` — tokens between partial-result flushes
      (0 disables streaming).
    - ``decode_quantum`` — decode steps per scheduler boundary: one host
      sync per quantum.  Requests join/leave at boundaries; a request
      finishing mid-quantum wastes at most ``decode_quantum - 1``
      row-steps.
    - ``paged`` — paged KV mode (block pool); False = monolithic
      per-slot lanes.
    - ``block_len`` — tokens per pool block (pow-2).
    - ``pool_blocks`` — usable pool blocks (default: every slot at full
      lane capacity).
    - ``kv_quant`` — ``off`` | ``int8``: int8 pool blocks with
      per-(block, head) scales, dequantized in the kernel at decode.
    - ``prefix_cache`` — share resident full-block prompt prefixes.
    - ``checkpoint_interval`` — snapshot every active slot's resume state
      each time it accrues this many new tokens (0 = off); collected at
      step boundaries, spooled by the engine.
    - ``resume`` — admit reclaimed records carrying a valid snapshot as
      RESUMES: prefill over prompt + generated-so-far (int8 lanes: over
      the prompt, then a replay of the rest through decode), then decode
      on at the exact token position.  The prefill ladder extends to
      ``pow2(max_prompt_len + max_tokens)`` so that prefill has a bucket.
    - ``start_id`` — the first decoder token of a bare-state model
      (``Seq2seq``), whose prefill yields no logits.
    """

    max_active_slots: int = 8
    max_tokens: int = 32
    eos_id: Optional[int] = None
    start_id: int = 1
    max_prompt_len: int = 64
    bucket_lens: Optional[List[int]] = None
    prefill_buckets: Optional[List[int]] = None
    stream_interval: int = 8
    decode_quantum: int = 4
    paged: bool = False
    block_len: int = 16
    pool_blocks: Optional[int] = None
    kv_quant: str = "off"
    prefix_cache: bool = True
    checkpoint_interval: int = 0
    resume: bool = False

    def __post_init__(self):
        self.max_active_slots = max(1, int(self.max_active_slots))
        self.max_tokens = max(1, int(self.max_tokens))
        self.start_id = int(self.start_id)
        self.max_prompt_len = max(1, int(self.max_prompt_len))
        self.stream_interval = max(0, int(self.stream_interval))
        self.decode_quantum = max(1, int(self.decode_quantum))
        self.paged = bool(self.paged)
        self.prefix_cache = bool(self.prefix_cache)
        self.block_len = _pow2_ceil(self.block_len)
        if self.kv_quant not in ("off", "int8"):
            raise ValueError(
                f"kv_quant must be 'off' or 'int8', got {self.kv_quant!r}")
        if self.pool_blocks is not None:
            self.pool_blocks = max(1, int(self.pool_blocks))
        if self.eos_id is not None:
            self.eos_id = int(self.eos_id)
        if self.bucket_lens is None:
            self.bucket_lens = [
                _pow2_ceil(self.max_prompt_len + self.max_tokens)]
        self.bucket_lens = sorted({_pow2_ceil(b) for b in self.bucket_lens})
        if self.prefill_buckets is None:
            self.prefill_buckets = _pow2_ladder(
                min(8, _pow2_ceil(self.max_prompt_len)),
                self.max_prompt_len)
        self.prefill_buckets = sorted(
            {_pow2_ceil(b) for b in self.prefill_buckets})
        # a user-supplied ladder must still cover every ADMISSIBLE prompt
        cap = _pow2_ceil(self.max_prompt_len)
        if self.prefill_buckets[-1] < cap:
            self.prefill_buckets.append(cap)
        self.checkpoint_interval = max(0, int(self.checkpoint_interval))
        self.resume = bool(self.resume)
        if self.resume:
            # a resume prefills over prompt + generated-so-far, which can
            # reach max_prompt_len + max_tokens: extend the ladder so the
            # resume prefill has a warmed bucket (the manifest drops the
            # buckets a lane cannot hold)
            rcap = _pow2_ceil(self.max_prompt_len + self.max_tokens)
            last = self.prefill_buckets[-1]
            while last < rcap:
                last *= 2
                self.prefill_buckets.append(last)

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> "GenerationParams":
        if not isinstance(d, dict):
            return cls()
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


class GenRequest:
    """One admitted generation request (engine-internal)."""

    __slots__ = ("rid", "prompt", "deadline_ns", "trace_id", "t_read",
                 "max_tokens", "t_submit", "tenant", "resume_tokens",
                 "epoch")

    def __init__(self, rid: str, prompt: np.ndarray,
                 deadline_ns: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 t_read: Optional[float] = None,
                 max_tokens: Optional[int] = None,
                 tenant: Optional[str] = None,
                 resume_tokens: Optional[List[int]] = None,
                 epoch: int = 0):
        self.rid = rid
        self.prompt = prompt            # ORIGINAL prompt, resume or not
        self.deadline_ns = deadline_ns
        self.trace_id = trace_id
        self.t_read = t_read
        self.max_tokens = max_tokens
        self.tenant = tenant
        # tokens a dead owner already produced: admission pre-seeds the
        # slot with them and rebuilds their KV; epoch counts ownership
        # handoffs
        self.resume_tokens = resume_tokens
        self.epoch = int(epoch)
        self.t_submit = time.monotonic()


@dataclass
class GenEvent:
    """One scheduler outcome the engine must act on.

    ``kind``: ``first_token`` (TTFT stamp), ``partial`` (stream
    tokens-so-far), ``finish`` (terminal result), ``shed``
    (deadline-exceeded at a step boundary), ``quarantine`` (poisoned
    request isolated), ``resume_failed`` (a resume prefix could not be
    replayed: the request restarts from token 0; ``tokens`` carries the
    wasted prefix, ``error`` the reason)."""

    kind: str
    rid: str
    trace_id: Optional[str] = None
    tokens: Optional[List[int]] = None
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    ttft_s: Optional[float] = None
    t_read: Optional[float] = None
    wall_s: Optional[float] = None
    tenant: Optional[str] = None


class _Slot:
    __slots__ = ("req", "generated", "t_first", "last_stream", "budget",
                 "ckpt_mark", "forced")

    def __init__(self, req: GenRequest, budget: int):
        self.req = req
        self.generated: List[int] = []
        self.t_first: Optional[float] = None
        self.last_stream = 0
        self.budget = budget
        # tokens-generated count at the last checkpoint
        self.ckpt_mark = 0
        # an int8 resume replaying its prefix through decode: the decode
        # outputs still to be forced to the prefix's tokens
        self.forced: List[int] = []


class _QuantumBuffers:
    """Static tensors of one lane's decode quantum: the int32 inputs it
    reads (``dev``), the pinned host tensors they are filled from at each
    boundary (``host``), and the (quantum, max_active) token block it
    writes (``out``).  The eager quantum and its CUDA graph run on the same
    tensors."""

    def __init__(self, shapes: Dict[str, tuple], quantum: int, rows: int,
                 device: torch.device):
        pin = device.type == "cuda"
        with torch.inference_mode():
            self.host = {n: torch.zeros(sh, dtype=torch.int32,
                                        pin_memory=pin)
                         for n, sh in shapes.items()}
            self.dev = {n: torch.zeros(sh, dtype=torch.int32, device=device)
                        for n, sh in shapes.items()}
            self.out = torch.zeros((quantum, rows), dtype=torch.int32,
                                   device=device)

    def load(self, **arrays: np.ndarray) -> None:
        """Host arrays -> static inputs, one asynchronous copy each (every
        quantum ends with a read of ``out`` that syncs, before the host
        arrays are written again)."""
        for name, a in arrays.items():
            self.host[name].numpy()[...] = a
            self.dev[name].copy_(self.host[name], non_blocking=True)


class _Lane:
    """One capacity bucket: fixed (max_active, bucket) per-slot state, the
    host-side slot map, the quantum's static buffers and, once warmed on
    the card, the quantum's CUDA graph."""

    def __init__(self, bucket: int, max_active: int):
        self.bucket = int(bucket)
        self.max_active = int(max_active)
        self.slots: List[Optional[_Slot]] = [None] * self.max_active
        self.free: deque = deque(range(self.max_active))
        self.state = None
        self.tokens = np.zeros((self.max_active,), np.int32)
        self.buf: Optional[_QuantumBuffers] = None
        self.program: Optional[aot.CapturedProgram] = None
        # paged int8 lanes: the (quantum, max_active) tokens a quantum
        # feeds on instead of its argmax (-1 = the argmax), for resumes
        # that replay their prefix through decode
        self.force: Optional[np.ndarray] = None

    @property
    def active(self) -> int:
        return self.max_active - len(self.free)


class _PagedLane(_Lane):
    """The paged lane: ``state`` holds the POOL dict (device tensors), and
    the per-slot cache geometry lives in host-side block tables.  Inactive
    slots keep their table row zeroed (every entry -> the trash block), so
    their decode writes land harmlessly."""

    def __init__(self, bucket: int, max_active: int, block_len: int):
        super().__init__(bucket, max_active)
        self.ntab = bucket // block_len
        self.tables = np.zeros((max_active, self.ntab), np.int32)
        self.pos = np.zeros((max_active,), np.int32)
        # per-slot owned block ids (shared-prefix refs + private), for
        # release on free
        self.blocks: List[Optional[List[int]]] = [None] * max_active


def _copy_into(dst, src) -> None:
    """Copy every tensor of the state tree ``src`` into the same place of
    ``dst``, in place, where the two are not the same tensor already."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif dst is not src:
        dst.copy_(src)


def _insert(state, sub, row: int, slot: int) -> None:
    """One admitted request: row ``row`` of the prefilled batch state
    ``sub`` copied into slot ``slot`` of the lane state, in place."""
    if isinstance(state, dict):
        for k in state:
            _insert(state[k], sub[k], row, slot)
    elif isinstance(state, (list, tuple)):
        for d, s in zip(state, sub):
            _insert(d, s, row, slot)
    else:
        state[slot].copy_(sub[row])


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _zeros_like_rows(sub, rows: int):
    """Zeroed state tree with ``rows`` rows, each leaf shaped as one row of
    ``sub``'s."""
    if isinstance(sub, dict):
        return {k: _zeros_like_rows(v, rows) for k, v in sub.items()}
    if isinstance(sub, (list, tuple)):
        return [_zeros_like_rows(v, rows) for v in sub]
    return torch.zeros((rows,) + tuple(sub.shape[1:]), dtype=sub.dtype,
                       device=sub.device)


def commit(pools, ks, vs, lengths, dest, slots, *, block_len: int,
           kv_quant: str) -> None:
    """Scatter an admission group's (length-masked) K/V into pool blocks,
    in place: row j's block t lands at pool id ``dest[j, t]`` (0 = trash,
    for padding rows and blocks past the row's fill).  int8 mode quantizes
    per block and parks each row's partial TAIL block in its slot's f32
    staging buffer (``slots``; the sentinel ``max_active`` drops padding
    rows), so decode appends re-quantize from exact values."""
    bl = int(block_len)
    npb = dest.shape[1]
    bb, pb, nh, hd = ks[0].shape
    dev = ks[0].device
    pad = npb * bl
    valid = (torch.arange(pb, device=dev)[None, :]
             < lengths[:, None])[..., None, None]
    dest = dest.long()
    if kv_quant == "int8":
        keep = slots < pools["stk"][0].shape[0]
        tsel = torch.clamp_max(lengths.long() // bl, npb - 1)
        rows = torch.arange(bb, device=dev)
    for li in range(len(ks)):
        k = torch.where(valid, ks[li], 0.0)
        v = torch.where(valid, vs[li], 0.0)
        if pad > pb:
            z = torch.zeros((bb, pad - pb, nh, hd), device=dev)
            k = torch.cat([k, z], dim=1)
            v = torch.cat([v, z], dim=1)
        kb = k.reshape(bb, npb, bl, nh, hd)
        vb = v.reshape(bb, npb, bl, nh, hd)
        if kv_quant == "int8":
            qk, sk = kv_pack_int8(kb)
            qv, sv = kv_pack_int8(vb)
            pools["k"][li][dest] = qk
            pools["v"][li][dest] = qv
            pools["ks"][li][dest] = sk
            pools["vs"][li][dest] = sv
            pools["stk"][li][slots[keep].long()] = kb[rows, tsel][keep]
            pools["stv"][li][slots[keep].long()] = vb[rows, tsel][keep]
        else:
            pools["k"][li][dest] = kb
            pools["v"][li][dest] = vb


def gather_prefix(pools, ptab, *, block_len: int, kv_quant: str):
    """Per-layer (B, n_prefix_blocks * block_len, heads, head_dim) f32 K/V
    of the shared prefix blocks named by ``ptab`` (dequantized in int8
    mode) — the keys a prefix-hit prefill attends over."""
    bb, npb = ptab.shape
    idx = ptab.long()
    pk, pv = [], []
    for li in range(len(pools["k"])):
        k = pools["k"][li][idx]
        v = pools["v"][li][idx]
        if kv_quant == "int8":
            k = kv_unpack_int8(k, pools["ks"][li][idx])
            v = kv_unpack_int8(v, pools["vs"][li][idx])
        sh = k.shape
        pk.append(k.to(torch.float32).reshape(bb, npb * block_len, *sh[3:]))
        pv.append(v.to(torch.float32).reshape(bb, npb * block_len, *sh[3:]))
    return pk, pv


class ContinuousBatcher:
    """Token-level decode scheduler over an ``InferenceModel`` whose
    module exposes ``init_decode``/``decode_step`` (monolithic lanes: a
    cache model, ``TransformerLM``, or a bare-state one, ``Seq2seq``) and,
    for ``paged=True``, the paged decode API (``TransformerLM``).

    ``impl`` selects the attention route handed to ``decode_paged``
    (``None``/``"auto"`` = the CUDA kernel for CUDA tensors; ``"torch"`` =
    the plain version, for cross-checks).

    Thread contract: ``submit`` may be called from any thread (bounded
    waiting deque); ``step`` runs on ONE thread (the engine's
    ``serving-generate`` worker); ``warm`` may run on another: each of its
    entries holds the lock ``step`` holds, so a warm-up never runs device
    work beside a boundary."""

    MAX_WAITING = 1024
    PAGED_API = ("prefill_kv", "prefill_shared", "decode_paged",
                 "init_paged_pools")

    def __init__(self, model, gen: GenerationParams,
                 impl: Optional[str] = None):
        inner = getattr(model, "_model", None)
        if inner is None:
            raise ValueError("generation needs a loaded InferenceModel")
        missing = [m for m in self.PAGED_API if not hasattr(inner, m)]
        if gen.paged and missing:
            raise NotImplementedError(
                "generation.paged=true needs the paged decode API "
                f"(models/textmodels.TransformerLM); missing: {missing}")
        init = getattr(inner, "init_decode", None)
        if init is None or not hasattr(inner, "decode_step"):
            raise ValueError(
                "generation needs a model whose module implements "
                "init_decode/decode_step (models/seq2seq.Seq2seq, "
                "models/textmodels.TransformerLM)")
        # cache models (fixed-length KV caches) take cache_len and their
        # prefill yields first-token logits; bare-state models take
        # neither and start from gen.start_id
        self._cache_model = "cache_len" in inspect.signature(init).parameters
        self.model = model
        self.inner = inner
        self.gen = gen
        self.impl = impl
        self.device = model.device
        self._vocab = int(getattr(inner, "vocab_size", 0) or 0)
        model_cap = int(getattr(inner, "max_len", 0) or 0)
        # a cache lane must fit under the model's max_len AND hold at
        # least the smallest prefill bucket; a bare-state lane has no
        # length axis
        usable = [b for b in gen.bucket_lens
                  if not (self._cache_model
                          and ((model_cap and b > model_cap)
                               or b < gen.prefill_buckets[0]))]
        if not usable:
            raise ValueError(
                f"no usable decode lane: bucket_lens={gen.bucket_lens} "
                f"all exceed the model's max_len={model_cap} or fall "
                f"below the smallest prefill bucket "
                f"{gen.prefill_buckets[0]}")
        if len(usable) < len(gen.bucket_lens):
            logger.warning(
                "generate: dropped %d unusable decode lane(s) from "
                "bucket_lens=%s (model max_len=%s, smallest prefill "
                "bucket %d)", len(gen.bucket_lens) - len(usable),
                gen.bucket_lens, model_cap or "n/a",
                gen.prefill_buckets[0])
        self._pool = None
        self._prefix = None
        # int8 KV is path-dependent: decode attends over int8 K/V, prefill
        # over exact K/V, so an int8 resume replays its prefix through
        # decode (forced tokens) instead of prefilling over it
        self._replay = gen.paged and gen.kv_quant == "int8"
        self.pool_exhausted = 0
        self._exhausted_boundary = False
        if gen.paged:
            bucket = max(usable)
            if gen.block_len > bucket:
                raise ValueError(
                    f"block_len={gen.block_len} > lane capacity {bucket}")
            # ONE paged lane at the largest capacity: block tables make
            # per-request capacity a table-width concern, not a lane
            # concern
            lane = _PagedLane(bucket, gen.max_active_slots, gen.block_len)
            self._lanes: List[_Lane] = [lane]
            n_pool = gen.pool_blocks if gen.pool_blocks is not None \
                else gen.max_active_slots * lane.ntab
            self._pool = BlockPool(n_pool, gen.block_len)
            if gen.prefix_cache:
                self._prefix = PrefixIndex(self._pool)
        else:
            self._lanes = [_Lane(b, gen.max_active_slots) for b in usable]
        self._waiting: deque = deque()
        self._waiting_lock = threading.Lock()
        # held by step() and by each warm-up entry: device work of the
        # two never interleaves
        self._device_lock = threading.Lock()
        # per-boundary decode accounting: after each step(), (rid,
        # trace_id, tokens_emitted_this_boundary, tenant) for every slot
        # that ran a decode step
        self.last_boundary: List[Tuple] = []
        self.last_admitted = 0
        # warmed programs, keyed as the JAX package keys its compiled
        # ones: decode keys hold the lane's CUDA graph (None on the CPU),
        # prefill and insert keys None (they run eagerly)
        self._programs: Dict[tuple, Optional[aot.CapturedProgram]] = {}
        self._exec_counts: Dict[str, int] = {}
        self.eager_quanta = 0
        self.decode_steps = 0
        self.generated_tokens = 0
        self.admitted = 0
        self.finished = 0
        self.quarantined = 0
        self.shed = 0
        # continuity: resume admissions, loud downgrades to restart-from-0,
        # and checkpoints collected at step boundaries (the engine drains
        # and spools them); snapshot_bytes mirrors the spool's size
        self.resumed = 0
        self.resume_failed = 0
        self.checkpoints = 0
        self.snapshot_bytes = 0
        self.pending_checkpoints: List[Dict] = []
        for lane in self._lanes:
            self._ensure_lane_state(lane)

    # -- device state ---------------------------------------------------------
    def _ensure_lane_state(self, lane: _Lane) -> None:
        """Lane state and the quantum's static buffers, allocated eagerly:
        the warm-up thread and the generate worker both touch them."""
        gen = self.gen
        A = lane.max_active
        shapes = {"tokens": (A,)}
        with torch.inference_mode():
            if isinstance(lane, _PagedLane):
                # pool tensors: +1 block for the reserved trash row
                lane.state = self.inner.init_paged_pools(
                    self._pool.n_blocks + 1, gen.block_len, A,
                    gen.kv_quant)
                shapes.update(tables=(A, lane.ntab), pos=(A,))
                if self._replay:
                    shapes["force"] = (gen.decode_quantum, A)
                    lane.force = np.full(shapes["force"], -1, np.int32)
            else:
                # the state tree of one prefilled row, zeroed at A rows
                pb = gen.prefill_buckets[0]
                sub, _ = self._prefill(lane, np.zeros((1, pb), np.int32),
                                       np.ones((1,), np.int32))
                lane.state = _zeros_like_rows(sub, A)
        lane.buf = _QuantumBuffers(shapes, gen.decode_quantum, A,
                                   self.device)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _pprefill(self, prompt, lengths, dest, slots) -> torch.Tensor:
        """Full prefill of a prefix-miss group + commit; returns the
        first-token logits."""
        lengths = self._dev(lengths)
        ks, vs, logits0 = self.inner.prefill_kv(self._dev(prompt), lengths)
        commit(self._lanes[0].state, ks, vs, lengths, self._dev(dest),
               self._dev(slots), block_len=self.gen.block_len,
               kv_quant=self.gen.kv_quant)
        return logits0

    def _pshared(self, suffix, slens, prefix_len, ptab, dest,
                 slots) -> torch.Tensor:
        """Suffix-only prefill of a prefix-hit group over its pool-resident
        prefix blocks + commit; returns the first-token logits."""
        gen = self.gen
        pools = self._lanes[0].state
        pk, pv = gather_prefix(pools, self._dev(ptab),
                               block_len=gen.block_len,
                               kv_quant=gen.kv_quant)
        slens = self._dev(slens)
        ks, vs, logits0 = self.inner.prefill_shared(
            self._dev(suffix), slens, self._dev(prefix_len), pk, pv)
        commit(pools, ks, vs, slens, self._dev(dest), self._dev(slots),
               block_len=gen.block_len, kv_quant=gen.kv_quant)
        return logits0

    def _prefill(self, lane: _Lane, prompt, lengths):
        """Monolithic prefill of an admission group: ``(state tree,
        first-token logits)``, into lane-capacity caches for a cache
        model; a bare-state model's state and no logits (None)."""
        if not self._cache_model:
            return self.inner.init_decode(self._dev(prompt),
                                          self._dev(lengths)), None
        return self.inner.init_decode(self._dev(prompt), self._dev(lengths),
                                      cache_len=lane.bucket)

    def _quantum(self, lane: _Lane) -> torch.Tensor:
        """``decode_quantum`` greedy steps over the lane's static buffers,
        writing the (quantum, max_active) token block ``buf.out``.  Only
        device work on tensors that outlive the call, so the same function
        runs eagerly and under CUDA-graph capture: positions advance as
        temporaries inside the quantum (paged) or are copied back into the
        lane state in place (monolithic)."""
        gen = self.gen
        buf = lane.buf
        tok = buf.dev["tokens"]
        if isinstance(lane, _PagedLane):
            pos = buf.dev["pos"]
            force = buf.dev.get("force")
            for k in range(gen.decode_quantum):
                logits, _ = self.inner.decode_paged(
                    lane.state, buf.dev["tables"], pos, tok,
                    block_len=gen.block_len, kv_quant=gen.kv_quant,
                    impl=self.impl)
                nxt = logits.argmax(dim=-1)
                if force is not None:
                    nxt = torch.where(force[k] >= 0, force[k], nxt)
                buf.out[k].copy_(nxt)
                tok = buf.out[k]
                pos = pos + 1
            return buf.out
        state = lane.state
        for k in range(gen.decode_quantum):
            logits, state = self.inner.decode_step(state, tok)
            buf.out[k].copy_(logits.argmax(dim=-1))
            tok = buf.out[k]
        _copy_into(lane.state, state)
        return buf.out

    def _decode(self, lane: _Lane, dry_run: bool = False) -> np.ndarray:
        """One boundary's quantum: the host cursors into the static
        buffers, the lane's graph replayed (or the quantum run eagerly
        when it has none), and one device-to-host copy of the token block:
        the quantum's one host sync."""
        arrays = {"tokens": lane.tokens}
        if isinstance(lane, _PagedLane):
            arrays.update(tables=lane.tables, pos=lane.pos)
        if lane.force is not None:
            arrays["force"] = lane.force
        lane.buf.load(**arrays)
        if lane.program is not None and not dry_run:
            out = lane.program.replay()
        else:
            out = self._quantum(lane)
            self.eager_quanta += not dry_run
        return out.cpu().numpy()

    # -- admission ------------------------------------------------------------
    def submit(self, req: GenRequest) -> bool:
        """Queue one request for the next step boundary.  False = waiting
        room full (caller should leave the record staged / backpressure)."""
        with self._waiting_lock:
            if len(self._waiting) >= self.MAX_WAITING:
                return False
            self._waiting.append(req)
            return True

    @property
    def waiting(self) -> int:
        with self._waiting_lock:
            return len(self._waiting)

    @property
    def active(self) -> int:
        return sum(lane.active for lane in self._lanes)

    @property
    def slots_total(self) -> int:
        return sum(lane.max_active for lane in self._lanes)

    @property
    def idle(self) -> bool:
        return self.active == 0 and self.waiting == 0

    def _req_budget(self, req: GenRequest) -> int:
        """Per-request token budget: the deployment cap, lowerable (never
        raisable) by the record's own max_tokens."""
        budget = self.gen.max_tokens
        if req.max_tokens is not None:
            budget = max(1, min(int(req.max_tokens), budget))
        return budget

    def _budget_for(self, req: GenRequest, lane: _Lane) -> int:
        budget = self._req_budget(req)
        if self._cache_model:
            budget = min(budget, lane.bucket - len(req.prompt))
        return max(1, budget)

    def _pick_lane(self, req: GenRequest) -> Optional[_Lane]:
        """Smallest lane whose capacity holds prompt + budget AND the
        prefill bucket (prefill allocates the cache at the lane capacity).
        A resume prefills over prompt + resume prefix (except where it
        replays), so its prefill bucket is the concatenation's; its
        occupancy is still prompt + budget (the prefix counts against the
        budget).  A bare-state model (no length axis) takes the first
        lane."""
        if not self._cache_model:
            return self._lanes[0]
        want = len(req.prompt) + self._req_budget(req)
        pb = self._prefill_bucket(len(self._prefill_prompt(req)))
        if pb is not None:
            want = max(want, pb)
        for lane in self._lanes:
            if lane.bucket >= want:
                return lane
        return None

    # -- resume admission -----------------------------------------------------
    @staticmethod
    def _concat_prompt(req: GenRequest) -> np.ndarray:
        """Prefill input: the original prompt, plus, for a resume, the
        tokens the dead owner already produced (replaying them through
        prefill rebuilds the cache a continuous decode would hold)."""
        p = np.asarray(req.prompt).astype(np.int32).reshape(-1)
        if not req.resume_tokens:
            return p
        return np.concatenate([p, np.asarray(req.resume_tokens, np.int32)])

    def _prefill_prompt(self, req: GenRequest) -> np.ndarray:
        """What admission prefills: the concatenation, or, in a lane that
        replays resumes through decode, the original prompt."""
        p = self._concat_prompt(req)
        return p[:np.size(req.prompt)] if self._replay else p

    def _downgrade_resume(self, req: GenRequest, reason: str,
                          events: List[GenEvent]) -> None:
        """Fall back LOUDLY to restart-from-0: the wasted prefix rides the
        event so the engine can meter it."""
        toks = [int(t) for t in req.resume_tokens or ()
                if isinstance(t, (int, float, np.integer))]
        req.resume_tokens = None
        self.resume_failed += 1
        events.append(GenEvent(
            "resume_failed", req.rid, trace_id=req.trace_id, tokens=toks,
            error=reason, t_read=req.t_read, tenant=req.tenant))

    def _take_resume(self, req: GenRequest,
                     events: List[GenEvent]) -> None:
        """Normalize a reclaimed request's resume prefix, downgrading to
        restart-from-0 when it cannot be replayed: a bare-state model
        rebuilds no state from tokens at prefill (continuing would not be
        a prefix of an uninterrupted run), and a malformed or out-of-vocab
        prefix would poison the decode state (an out-of-range id is a
        device-side assert on CUDA)."""
        rt = req.resume_tokens
        if not rt:
            req.resume_tokens = None
            return
        try:
            toks = [int(t) for t in rt]
        except (TypeError, ValueError):
            self._downgrade_resume(req, "malformed resume prefix", events)
            return
        if not self._cache_model:
            self._downgrade_resume(
                req, "bare-state model cannot replay decode state", events)
            return
        if self._vocab and toks and (min(toks) < 0
                                     or max(toks) >= self._vocab):
            self._downgrade_resume(
                req, "resume token id out of vocab range", events)
            return
        cap = self._req_budget(req) - 1
        if cap < 1:
            self._downgrade_resume(req, "token budget already consumed",
                                   events)
            return
        # a prefix at or over budget should have finished at the old
        # owner; keep budget - 1 so the resumed slot still decodes a token
        req.resume_tokens = toks[:cap]

    def _seed_resume(self, info: _Slot) -> None:
        """Pre-seed a just-admitted slot with its resume prefix: the
        terminal token list stays the full generation (partials remain a
        prefix of it), while ``last_stream`` / ``ckpt_mark`` start past the
        prefix, so the streaming and checkpoint cadences resume where the
        dead owner left off.  The boundary accounting reports only the
        tokens decoded after admission."""
        rt = info.req.resume_tokens
        if not rt:
            return
        info.generated = [int(t) for t in rt]
        info.last_stream = len(info.generated)
        info.ckpt_mark = len(info.generated)
        self.resumed += 1

    def _validate(self, req: GenRequest) -> Optional[str]:
        p = np.asarray(req.prompt)
        if p.ndim != 1 or p.size == 0:
            return f"prompt must be a non-empty 1-D token sequence, got " \
                   f"shape {p.shape}"
        if p.size > self.gen.max_prompt_len:
            return f"prompt length {p.size} > max_prompt_len " \
                   f"{self.gen.max_prompt_len}"
        if not np.all(np.isfinite(p)):
            return "prompt contains non-finite token ids"
        ids = p.astype(np.int64)
        if self._vocab and (ids.min() < 0 or ids.max() >= self._vocab):
            return f"token id out of range [0, {self._vocab})"
        return None

    def _prefill_bucket(self, n: int) -> Optional[int]:
        for b in self.gen.prefill_buckets:
            if b >= n:
                return b
        return None

    def _batch_bucket(self, n: int) -> int:
        """Admission-batch bucket: smallest pow-2 >= n, capped at the
        slot-count bucket."""
        return min(_pow2_ceil(n), _pow2_ceil(self.gen.max_active_slots))

    def _quarantine(self, req: GenRequest, error: str,
                    events: List[GenEvent]) -> None:
        self.quarantined += 1
        events.append(GenEvent("quarantine", req.rid, trace_id=req.trace_id,
                               error=error, t_read=req.t_read,
                               tenant=req.tenant))

    def _first_token(self, lane: _Lane, slot: int, info: _Slot, tok: int,
                     events: List[GenEvent]) -> None:
        """The first token comes from the prefill: TTFT stops here, and the
        token feeds the slot's first decode step."""
        self._stamp_first(info, events)
        lane.tokens[slot] = tok
        self._account_token(lane, slot, info, tok, events)

    @staticmethod
    def _stamp_first(info: _Slot, events: List[GenEvent]) -> None:
        info.t_first = time.monotonic()
        events.append(GenEvent(
            "first_token", info.req.rid, trace_id=info.req.trace_id,
            ttft_s=info.t_first - info.req.t_submit, t_read=info.req.t_read,
            tenant=info.req.tenant))

    def _count_exec(self, key: tuple) -> None:
        label = self._program_name(key)
        self._exec_counts[label] = self._exec_counts.get(label, 0) + 1

    @staticmethod
    def _program_name(key: tuple) -> str:
        """Manifest-style label of one scheduler program."""
        if key[0] == "prefill":
            return f"prefill:b{key[1]}xp{key[2]}@{key[3]}"
        if key[0] == "insert":
            return f"insert:b{key[1]}@{key[2]}"
        if key[0] == "decode_step":
            return f"decode_step@{key[1]}"
        if key[0] == "pprefill":
            return f"paged_prefill:b{key[1]}xp{key[2]}"
        if key[0] == "pshared":
            return f"paged_shared:b{key[1]}xs{key[2]}xn{key[3]}"
        if key[0] == "pdecode":
            return f"paged_decode@{key[1]}"
        return ":".join(str(k) for k in key)

    def _admit(self, events: List[GenEvent]) -> int:
        """Claim free slots for waiting requests and admit them in batched
        prefill groups, one per (lane, prompt bucket).  Stops at the first
        head-of-line request whose lane is full (FIFO; retried next
        boundary)."""
        if self._pool is not None:
            return self._admit_paged(events)
        grabbed: List[tuple] = []        # (req, lane, slot)
        while True:
            with self._waiting_lock:
                req = self._waiting.popleft() if self._waiting else None
            if req is None:
                break
            if self._expired(req.deadline_ns):
                self.shed += 1
                events.append(GenEvent(
                    "shed", req.rid, trace_id=req.trace_id,
                    t_read=req.t_read, tenant=req.tenant))
                continue
            err = self._validate(req)
            if err is not None:
                self._quarantine(req, f"ValueError: {err}", events)
                continue
            if req.resume_tokens:
                self._take_resume(req, events)
            lane = self._pick_lane(req)
            if lane is None and req.resume_tokens:
                # the concatenation pushed the prefill bucket past every
                # lane: a VALID request must not quarantine — restart it
                self._downgrade_resume(
                    req, "resume prefix exceeds lane capacity", events)
                lane = self._pick_lane(req)
            if lane is None:
                self._quarantine(
                    req, "ValueError: no decode lane holds prompt + "
                         f"max_tokens (buckets {self.gen.bucket_lens})",
                    events)
                continue
            if not lane.free:
                with self._waiting_lock:
                    self._waiting.appendleft(req)
                break
            grabbed.append((req, lane, lane.free.popleft()))
        groups: Dict[tuple, tuple] = {}
        for req, lane, slot in grabbed:
            pb = self._prefill_bucket(len(req.prompt)
                                      + len(req.resume_tokens or ()))
            if pb is None and req.resume_tokens:
                self._downgrade_resume(
                    req, "no prefill bucket holds resume prefix", events)
                pb = self._prefill_bucket(len(req.prompt))
            # _validate bounds the prompt by max_prompt_len, which the
            # prefill ladder always covers
            groups.setdefault((lane.bucket, pb), (lane, pb, []))[2] \
                .append((req, slot))
        return sum(self._admit_batch(lane, pb, members, events)
                   for lane, pb, members in groups.values())

    def _admit_batch(self, lane: _Lane, pb: int, members, events) -> int:
        """Prefill a same-(lane, prompt-bucket) admission group in one
        pass, then copy each member's row into its slot.  Padding rows
        replicate row 0's prompt; their rows are never inserted.  A failing
        group falls back to singleton admission, so a poisoned request
        that slipped past validation quarantines alone."""
        n = len(members)
        bb = self._batch_bucket(n)
        padded = np.zeros((bb, pb), np.int32)
        lengths = np.ones((bb,), np.int32)
        for j, (req, _) in enumerate(members):
            prompt = self._concat_prompt(req)
            padded[j, :prompt.size] = prompt
            lengths[j] = prompt.size
        for j in range(n, bb):
            padded[j] = padded[0]
            lengths[j] = lengths[0]
        try:
            with torch.inference_mode():
                sub, logits0 = self._prefill(lane, padded, lengths)
                toks0 = None if logits0 is None \
                    else logits0.argmax(dim=-1).cpu().numpy()
            self._count_exec(("prefill", bb, pb, lane.bucket))
        except Exception as e:  # noqa: BLE001 — group-level failure
            if n == 1:
                req, slot = members[0]
                self._quarantine(req, f"{type(e).__name__}: {e}", events)
                lane.free.append(slot)
                return 0
            return sum(self._admit_batch(lane, pb, [m], events)
                       for m in members)
        admitted = 0
        for j, (req, slot) in enumerate(members):
            try:
                with torch.inference_mode():
                    _insert(lane.state, sub, j, slot)
                self._count_exec(("insert", bb, lane.bucket))
            except Exception as e:  # noqa: BLE001 — per-row failure
                self._quarantine(req, f"{type(e).__name__}: {e}", events)
                lane.free.append(slot)
                continue
            info = _Slot(req, budget=self._budget_for(req, lane))
            self._seed_resume(info)
            lane.slots[slot] = info
            self.admitted += 1
            admitted += 1
            if toks0 is None:
                # bare state: the first decode step is fed start_id, and
                # the first token comes from the first quantum
                lane.tokens[slot] = self.gen.start_id
            else:
                self._first_token(lane, slot, info, int(toks0[j]), events)
        return admitted

    def _reserve(self, lane: _PagedLane, req: GenRequest):
        """Claim pool blocks for one request: the longest registered prompt
        prefix rides shared (referenced) pages, the rest allocates private
        blocks — evicting LRU prefix-cache entries if the pool runs dry.
        Returns ``(k_shared, shared_ids, private_ids, plen)`` or None (pool
        exhausted: the caller requeues, and a typed ``kv_pool_exhausted``
        flight-recorder event explains the stall)."""
        prompt = self._prefill_prompt(req)
        plen = int(prompt.size)
        bl = self.gen.block_len
        # a resume's prefix counts against the budget: blocks for the
        # original prompt + budget
        need = min((len(req.prompt) + self._budget_for(req, lane)
                    + bl - 1) // bl, lane.ntab)
        ksh, shared = 0, []
        if self._prefix is not None:
            # cap leaves >= 1 suffix token: first-token logits need at
            # least one position to actually prefill
            ksh, shared = self._prefix.lookup(
                prompt, max_blocks=(plen - 1) // bl)
        priv = self._pool.alloc(need - ksh)
        if priv is None and self._prefix is not None:
            self._prefix.evict_for(need - ksh)
            priv = self._pool.alloc(need - ksh)
        if priv is None:
            if shared:
                self._pool.release(shared)
            if not self._exhausted_boundary:
                self._exhausted_boundary = True
                self.pool_exhausted += 1
                get_recorder().record(
                    "kv_pool_exhausted", rid=req.rid,
                    need_blocks=int(need - ksh),
                    free_blocks=int(self._pool.free_blocks),
                    active_slots=int(self.active),
                    waiting=int(self.waiting))
            return None
        return ksh, shared, priv, plen

    def _release_resv(self, resv) -> None:
        _, shared, priv, _ = resv
        if shared:
            self._pool.release(shared)
        if priv:
            self._pool.release(priv)

    def _admit_paged(self, events: List[GenEvent]) -> int:
        """Admission gated on free slots AND pool blocks, grouped into
        prefix-MISS batches (full prefill, one group per prompt bucket) and
        prefix-HIT batches (suffix-only prefill, one group per (suffix
        bucket, prefix-table bucket))."""
        lane = self._lanes[0]
        bl = self.gen.block_len
        grabbed: List[tuple] = []        # (req, slot, resv)
        while True:
            with self._waiting_lock:
                req = self._waiting.popleft() if self._waiting else None
            if req is None:
                break
            if self._expired(req.deadline_ns):
                self.shed += 1
                events.append(GenEvent(
                    "shed", req.rid, trace_id=req.trace_id,
                    t_read=req.t_read, tenant=req.tenant))
                continue
            err = self._validate(req)
            if err is not None:
                self._quarantine(req, f"ValueError: {err}", events)
                continue
            if req.resume_tokens:
                self._take_resume(req, events)
            if self._pick_lane(req) is None and req.resume_tokens:
                self._downgrade_resume(
                    req, "resume prefix exceeds lane capacity", events)
            if self._pick_lane(req) is None:
                self._quarantine(
                    req, "ValueError: no decode lane holds prompt + "
                         f"max_tokens (buckets {self.gen.bucket_lens})",
                    events)
                continue
            if not lane.free:
                with self._waiting_lock:
                    self._waiting.appendleft(req)
                break
            resv = self._reserve(lane, req)
            if resv is None:
                with self._waiting_lock:
                    self._waiting.appendleft(req)
                break
            grabbed.append((req, lane.free.popleft(), resv))
        if not grabbed:
            return 0
        miss: Dict[int, list] = {}
        hit: Dict[tuple, list] = {}
        for req, slot, resv in grabbed:
            ksh, _, _, plen = resv
            pb = self._prefill_bucket(plen - ksh * bl)
            if pb is None:
                # a resume prefix past the ladder (a ladder not extended
                # for resume): the request quarantines with its claim
                # released, as in the JAX package
                self._release_resv(resv)
                self._quarantine(
                    req, f"ValueError: no prefill bucket holds prompt "
                         f"length {plen} (buckets "
                         f"{self.gen.prefill_buckets})", events)
                lane.free.append(slot)
                continue
            if ksh:
                hit.setdefault((pb, _pow2_ceil(ksh)), []).append(
                    (req, slot, resv))
            else:
                miss.setdefault(pb, []).append((req, slot, resv))
        return sum(self._admit_paged_batch(lane, pb, members, events)
                   for pb, members in miss.items()) \
            + sum(self._admit_paged_batch(lane, sb, members, events,
                                          shared=npb)
                  for (sb, npb), members in hit.items())

    def _admit_paged_batch(self, lane: _PagedLane, pb: int, members, events,
                           shared: Optional[int] = None) -> int:
        """Prefill + commit one same-bucket admission group in one pass.
        ``shared`` = prefix-table bucket for prefix-HIT groups (None = full
        prefill).  A failing group falls back to singleton admission, so a
        poisoned request that slipped past validation quarantines alone."""
        bl = self.gen.block_len
        n = len(members)
        bb = self._batch_bucket(n)
        padded = np.zeros((bb, pb), np.int32)
        lengths = np.ones((bb,), np.int32)
        dest = np.zeros((bb, (pb + bl - 1) // bl), np.int32)
        slots_arr = np.full((bb,), lane.max_active, np.int32)  # drop
        if shared is not None:
            ptab = np.zeros((bb, shared), np.int32)
            plens = np.zeros((bb,), np.int32)
        for j, (req, slot, resv) in enumerate(members):
            ksh, shared_ids, priv, plen = resv
            prompt = self._prefill_prompt(req)
            table = list(shared_ids) + list(priv)
            if shared is not None:
                suffix = prompt[ksh * bl:]
                padded[j, :suffix.size] = suffix
                lengths[j] = suffix.size
                ptab[j, :ksh] = shared_ids
                plens[j] = ksh * bl
                nfill = (suffix.size + bl - 1) // bl
                dest[j, :nfill] = table[ksh:ksh + nfill]
            else:
                padded[j, :plen] = prompt
                lengths[j] = plen
                nfill = (plen + bl - 1) // bl
                dest[j, :nfill] = table[:nfill]
            slots_arr[j] = slot
        for j in range(n, bb):
            # padding rows replicate row 0's prompt; their dest stays at
            # the trash block and their slot at the drop sentinel, so
            # nothing they compute is ever committed
            padded[j] = padded[0]
            lengths[j] = lengths[0]
            if shared is not None:
                ptab[j] = ptab[0]
                plens[j] = plens[0]
        try:
            with torch.inference_mode():
                if shared is None:
                    logits0 = self._pprefill(padded, lengths, dest,
                                             slots_arr)
                    key = ("pprefill", bb, pb)
                else:
                    logits0 = self._pshared(padded, lengths, plens, ptab,
                                            dest, slots_arr)
                    key = ("pshared", bb, pb, shared)
                toks0 = logits0.argmax(dim=-1).cpu().numpy()
            self._count_exec(key)
        except Exception as e:  # noqa: BLE001 — group-level failure
            if n == 1:
                req, slot, resv = members[0]
                self._release_resv(resv)
                self._quarantine(req, f"{type(e).__name__}: {e}", events)
                lane.free.append(slot)
                return 0
            return sum(self._admit_paged_batch(lane, pb, [m], events,
                                               shared=shared)
                       for m in members)
        for j, (req, slot, resv) in enumerate(members):
            ksh, shared_ids, priv, plen = resv
            table = list(shared_ids) + list(priv)
            lane.tables[slot, :] = 0
            lane.tables[slot, :len(table)] = table
            lane.pos[slot] = plen
            lane.blocks[slot] = table
            info = _Slot(req, budget=self._budget_for(req, lane))
            self._seed_resume(info)
            lane.slots[slot] = info
            self.admitted += 1
            if self._prefix is not None and ksh == 0:
                # park the prompt's FULL blocks for future sharers (the
                # partial tail block keeps being written by decode, so it
                # can never be shared); a resume registers what it
                # prefilled, which is what its blocks hold
                full = plen // bl
                if full:
                    self._prefix.register(
                        self._prefill_prompt(req)[:full * bl], table[:full])
            if self._replay and req.resume_tokens:
                # replay: decode feeds on the prefix from the prompt's end;
                # the first token comes once the replay is through
                lane.tokens[slot] = req.resume_tokens[0]
                info.forced = list(req.resume_tokens[1:])
            else:
                self._first_token(lane, slot, info, int(toks0[j]), events)
        return n

    # -- step boundary --------------------------------------------------------
    @staticmethod
    def _expired(deadline_ns) -> bool:
        if deadline_ns is None:
            return False
        try:
            return time.time_ns() > int(deadline_ns)
        except (TypeError, ValueError, OverflowError):
            return False      # the engine validated upstream

    def _free(self, lane: _Lane, slot: int) -> None:
        if isinstance(lane, _PagedLane):
            if lane.blocks[slot]:
                self._pool.release(lane.blocks[slot])
                lane.blocks[slot] = None
            # zero the table row: the freed slot's decode writes land in
            # the trash block until the next admission
            lane.tables[slot, :] = 0
            lane.pos[slot] = 0
        lane.slots[slot] = None
        lane.free.append(slot)

    def _finish(self, lane: _Lane, slot: int, info: _Slot, reason: str,
                events: List[GenEvent]) -> None:
        self.finished += 1
        now = time.monotonic()
        events.append(GenEvent(
            "finish", info.req.rid, trace_id=info.req.trace_id,
            tokens=list(info.generated), finish_reason=reason,
            ttft_s=(info.t_first - info.req.t_submit
                    if info.t_first is not None else None),
            t_read=info.req.t_read, wall_s=now - info.req.t_submit,
            tenant=info.req.tenant))
        self._free(lane, slot)

    def _account_token(self, lane: _Lane, slot: int, info: _Slot, tok: int,
                       events: List[GenEvent]) -> None:
        """Fold one emitted token into the slot: EOS / budget finish the
        request immediately (slot freed THIS boundary), stream_interval
        flushes partials."""
        eos = self.gen.eos_id
        if eos is not None and tok == eos:
            self._finish(lane, slot, info, "eos", events)
            return
        info.generated.append(int(tok))
        self.generated_tokens += 1
        if len(info.generated) >= info.budget:
            self._finish(lane, slot, info, "length", events)
            return
        si = self.gen.stream_interval
        if si and len(info.generated) - info.last_stream >= si:
            info.last_stream = len(info.generated)
            events.append(GenEvent(
                "partial", info.req.rid, trace_id=info.req.trace_id,
                tokens=list(info.generated), t_read=info.req.t_read,
                tenant=info.req.tenant))

    def _shed_active(self, events: List[GenEvent]) -> None:
        for lane in self._lanes:
            for slot, info in enumerate(lane.slots):
                if info is None or not self._expired(info.req.deadline_ns):
                    continue
                self.shed += 1
                events.append(GenEvent(
                    "shed", info.req.rid, trace_id=info.req.trace_id,
                    tokens=list(info.generated), t_read=info.req.t_read,
                    tenant=info.req.tenant))
                self._free(lane, slot)

    def step(self) -> List[GenEvent]:
        """One decode-step boundary: shed expired, admit into free slots,
        run ``decode_quantum`` token steps per non-empty lane, fold the
        emitted tokens.  Returns the events the engine must act on; an
        idle scheduler returns [] without touching the device."""
        with self._device_lock:
            events: List[GenEvent] = []
            self.last_boundary = []
            self._exhausted_boundary = False
            self._shed_active(events)
            self.last_admitted = self._admit(events)
            for lane in self._lanes:
                if lane.active:
                    self._step_lane(lane, events)
            if self.gen.checkpoint_interval > 0 and self._cache_model:
                self._collect_checkpoints()
            return events

    def _collect_checkpoints(self) -> None:
        """Queue resume-state snapshots for the slots that crossed the
        checkpoint interval since their last mark.  Host-side list work
        only (the tokens are the host lists the boundary already folded):
        the engine drains ``pending_checkpoints`` and spools them."""
        interval = self.gen.checkpoint_interval
        now = time.monotonic()
        for lane in self._lanes:
            for info in lane.slots:
                if info is None:
                    continue
                n = len(info.generated)
                if n - info.ckpt_mark < interval:
                    continue
                req = info.req
                prompt = np.asarray(req.prompt).reshape(-1)
                self.pending_checkpoints.append({
                    "rid": req.rid,
                    "epoch": req.epoch,
                    "prompt": [int(t) for t in prompt],
                    "tokens": list(info.generated),
                    "n": n,
                    "tenant": req.tenant,
                    "trace_id": req.trace_id,
                    "deadline_ns": req.deadline_ns,
                    "max_tokens": req.max_tokens,
                    # greedy argmax decode: recorded so a future sampling
                    # decode can refuse to resume across a sampler change
                    "sampler": "greedy",
                    "ts": now,
                })
                info.ckpt_mark = n
                self.checkpoints += 1

    def drain_checkpoints(self) -> List[Dict]:
        """Hand the queued snapshots to the engine (scheduler thread only,
        like ``step``)."""
        out, self.pending_checkpoints = self.pending_checkpoints, []
        return out

    def _step_lane(self, lane: _Lane, events: List[GenEvent]) -> None:
        K = self.gen.decode_quantum
        if lane.force is not None:
            lane.force.fill(-1)
            for slot, info in enumerate(lane.slots):
                forced = info.forced[:K] if info is not None else ()
                lane.force[:len(forced), slot] = forced
        with torch.inference_mode():
            block = self._decode(lane)
        self._count_exec(self._decode_key(lane))
        if isinstance(lane, _PagedLane):
            # host cursors advance with the decode loop; idle rows clamp at
            # lane capacity (their writes target the trash block
            # regardless).  MUST run before the token fold — _free zeroes a
            # finishing row's cursor.
            lane.pos = np.minimum(lane.pos + np.int32(block.shape[0]),
                                  np.int32(lane.bucket)).astype(np.int32)
        self.decode_steps += int(block.shape[0])
        for slot, info in enumerate(lane.slots):
            if info is None:
                continue
            n0 = len(info.generated)
            # a replaying resume's forced outputs are its prefix, which
            # `generated` already holds
            skip = min(len(info.forced), K)
            del info.forced[:skip]
            for k in range(skip, K):
                if info.t_first is None:
                    self._stamp_first(info, events)
                self._account_token(lane, slot, info, int(block[k, slot]),
                                    events)
                if lane.slots[slot] is not info:
                    break      # finished mid-quantum: discard the rest
            self.last_boundary.append(
                (info.req.rid, info.req.trace_id,
                 len(info.generated) - n0, info.req.tenant))
        lane.tokens = np.array(block[-1])

    # -- warm-up --------------------------------------------------------------
    @staticmethod
    def _decode_key(lane: _Lane) -> tuple:
        return ("pdecode" if isinstance(lane, _PagedLane)
                else "decode_step", lane.bucket)

    def warmup_manifest(self):
        """The program set of this deployment, from
        ``aot.generation_manifest`` as in the JAX package (the prefix-block
        ladder included)."""
        prefix_blocks: Sequence[int] = ()
        if self._prefix is not None:
            max_sh = (self.gen.max_prompt_len - 1) // self.gen.block_len
            if max_sh >= 1:
                prefix_blocks = _pow2_ladder(1, max_sh)
        return aot.generation_manifest(
            self.gen.prefill_buckets,
            [lane.bucket for lane in self._lanes],
            prefill_batches=_pow2_ladder(1, self.gen.max_active_slots),
            cache_model=self._cache_model,
            paged=self._pool is not None,
            prefix_blocks=prefix_blocks)

    def warm(self, manifest=None, progress: Optional[Callable] = None,
             stop: Optional[Callable[[], bool]] = None) -> Dict:
        """Warm every scheduler program ahead of traffic: a decode entry
        captures its lane's quantum as a CUDA graph on the card (on the
        CPU, where there is none, it runs the quantum once); prefill,
        shared-prefill and insert entries run once eagerly, to the trash
        block, the drop sentinel or a free slot.  The entries are walked
        by ``aot.warm_up``, whose stats document this returns."""
        if manifest is None:
            manifest = self.warmup_manifest()
        lanes = {lane.bucket: lane for lane in self._lanes}

        def warm_entry(entry) -> bool:
            with self._device_lock, torch.inference_mode():
                return self._warm_entry(entry, lanes)
        return aot.warm_up(None, manifest, progress=progress, stop=stop,
                           warm_entry=warm_entry)

    def _warm_entry(self, entry, lanes: Dict[int, _Lane]) -> bool:
        lane = lanes.get(entry.lane_bucket)
        if lane is None:
            raise ValueError(f"no lane with bucket {entry.lane_bucket}")
        if entry.kind in ("paged_decode", "decode_step"):
            if (entry.kind == "paged_decode") != isinstance(lane,
                                                            _PagedLane):
                raise ValueError(f"entry kind {entry.kind!r} does not "
                                 "match the lane")
            return self._warm_decode(lane)
        bb = int(entry.prefill_batch or 1)
        if entry.kind == "insert":
            key = ("insert", bb, lane.bucket)
        else:
            pb = int(entry.prefill_bucket)
            key = {"prefill": ("prefill", bb, pb, lane.bucket),
                   "paged_prefill": ("pprefill", bb, pb),
                   "paged_shared": ("pshared", bb, pb,
                                    int(entry.prefix_blocks or 1))
                   }.get(entry.kind)
        if key is None:
            raise ValueError(f"unknown warm-up entry kind {entry.kind!r}")
        if key in self._programs:
            return False
        self._dry_run(lane, key)
        self._programs[key] = None
        return True

    def _dry_run(self, lane: _Lane, key: tuple) -> None:
        """One eager run of a prefill-side program at its shapes, with
        effects that no active slot can see: paged prefills commit to the
        trash block and the drop sentinel; a monolithic insert copies into
        a free slot, which admission overwrites whole."""
        kind, bb = key[0], key[1]
        if kind == "insert":
            pb = self.gen.prefill_buckets[0]
        else:
            pb = key[2]
        prompt = np.zeros((bb, pb), np.int32)
        lengths = np.ones((bb,), np.int32)
        if kind in ("prefill", "insert"):
            sub, logits0 = self._prefill(lane, prompt, lengths)
            if kind == "insert" and lane.free:
                _insert(lane.state, sub, 0, lane.free[0])
        else:
            bl = self.gen.block_len
            dest = np.zeros((bb, (pb + bl - 1) // bl), np.int32)
            slots = np.full((bb,), lane.max_active, np.int32)
            if kind == "pprefill":
                logits0 = self._pprefill(prompt, lengths, dest, slots)
            else:
                logits0 = self._pshared(
                    prompt, lengths, np.zeros((bb,), np.int32),
                    np.zeros((bb, key[3]), np.int32), dest, slots)
        if logits0 is not None:
            logits0.argmax(dim=-1).cpu()

    def _warm_decode(self, lane: _Lane) -> bool:
        """Capture the lane's quantum.  An idle lane first runs it once
        eagerly (first-call setup; every row's writes land in the trash
        block or a free slot).  A lane with active slots ran its quantum
        eagerly at the last boundary, and a dry run would write ahead of
        its slots' cursors, so it is captured as it stands (a capture
        records and does not execute), after one prefill of a padding row
        that commits nowhere: the calling thread may not have run the
        quantum, and a capture cannot create the per-thread library
        handles (cuBLAS) that a thread's first call creates."""
        key = self._decode_key(lane)
        if key in self._programs:
            return False
        if lane.active == 0:
            self._decode(lane, dry_run=True)
        else:
            pb = self.gen.prefill_buckets[0]
            self._dry_run(lane, ("pprefill", 1, pb)
                          if isinstance(lane, _PagedLane)
                          else ("prefill", 1, pb, lane.bucket))
        if self.device.type == "cuda":
            lane.program = self.model.capture(
                lambda *_: self._quantum(lane), tuple(lane.buf.dev.values()))
        self._programs[key] = lane.program
        return True

    # -- observability --------------------------------------------------------
    @property
    def captures(self) -> int:
        """Decode lanes holding a captured graph."""
        return sum(lane.program is not None for lane in self._lanes)

    @property
    def replays(self) -> int:
        """Decode quanta replayed from the lanes' graphs."""
        return sum(lane.program.replays for lane in self._lanes
                   if lane.program is not None)

    def state_bytes_doc(self) -> Dict:
        """Bytes pinned by decode state, decomposed: ``lanes`` (monolithic
        per-slot caches and int8 per-slot staging buffers), ``paged_pool``
        (the shared KV block pool), ``scales`` (int8 per-block scale
        planes) and ``aux`` (host-side token cursors, block tables,
        position cursors and the snapshot spool's bytes)."""
        lanes_b = pool_b = scales_b = aux_b = 0
        for lane in self._lanes:
            aux_b += int(lane.tokens.nbytes)
            if isinstance(lane, _PagedLane):
                aux_b += int(lane.tables.nbytes + lane.pos.nbytes)
                for part, tensors in lane.state.items():
                    nb = sum(t.numel() * t.element_size() for t in tensors)
                    if part in ("k", "v"):
                        pool_b += nb
                    elif part in ("ks", "vs"):
                        scales_b += nb
                    else:
                        lanes_b += nb
            else:
                lanes_b += _tree_bytes(lane.state)
        # the snapshot spool's bytes (host and disk side, but pinned by the
        # generation plane; the engine mirrors the spool's size here)
        aux_b += int(self.snapshot_bytes)
        return {"lanes": lanes_b, "paged_pool": pool_b, "scales": scales_b,
                "aux": aux_b, "total": lanes_b + pool_b + scales_b + aux_b}

    def state_bytes(self) -> int:
        return int(self.state_bytes_doc()["total"])

    def program_stats(self) -> Dict:
        """Warmed scheduler programs and per-program execution counts,
        keyed like the ``aot.generation_manifest`` entries
        (``prefill:b<batch>xp<bucket>@<lane>`` etc.)."""
        return {"count": len(self._programs),
                "programs": dict(self._exec_counts)}

    def stats(self) -> Dict:
        d = {"slots_total": self.slots_total,
             "active_slots": self.active,
             "waiting": self.waiting,
             "decode_steps": self.decode_steps,
             "generated_tokens": self.generated_tokens,
             "admitted": self.admitted,
             "finished": self.finished,
             "quarantined": self.quarantined,
             "shed": self.shed,
             "resumed": self.resumed,
             "resume_failed": self.resume_failed,
             "checkpoints": self.checkpoints,
             "snapshot_bytes": self.snapshot_bytes,
             "can_resume": self._cache_model,
             "captures": self.captures,
             "replays": self.replays,
             "eager_quanta": self.eager_quanta,
             "lanes": [{"bucket": lane.bucket,
                        "max_active": lane.max_active,
                        "active": lane.active}
                       for lane in self._lanes]}
        if self._pool is not None:
            pool = {"blocks": self._pool.n_blocks,
                    "block_len": self._pool.block_len,
                    "free_blocks": self._pool.free_blocks,
                    "used_blocks": self._pool.used_blocks,
                    "occupancy": round(self._pool.used_blocks
                                       / max(1, self._pool.n_blocks), 4),
                    "kv_quant": self.gen.kv_quant,
                    "exhausted": self.pool_exhausted}
            if self._prefix is not None:
                ps = self._prefix.stats()
                pool.update({"prefix_entries": ps["entries"],
                             "prefix_hits": ps["hits"],
                             "prefix_misses": ps["misses"],
                             "prefix_evictions": ps["evictions"]})
            d["pool"] = pool
        return d
