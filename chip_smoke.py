#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``analytics_zoo_tpu_torch``).

Runs the port's two serving paths on one NVIDIA GPU and checks them, phase
by phase, each phase printing its own lines:

1. card — the card's name and power limit (``nvidia-smi``) and the build of
   every CUDA kernel (one ``nvcc`` per source, started together).
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, then timed on the device (CUDA graph
   replay between CUDA events) beside its plain version and, where one
   PyTorch call computes the same function, that call:
   - paged decode attention (8 rows, 12 heads, head_dim 64, 16-token
     blocks, 16-entry tables; f32 and int8 pools);
   - flash attention forward (f32 and bf16, causal and not, T = 77, 1000
     and 1024, with and without LSE, q/k/v read in place from a fused
     (B, T, 3·H·D) projection); timed at (8, 12, 1024, 64) f32 causal and
     at T = 128 and 512 (the H100's crossover against the plain path and
     SDPA);
   - w8a8 (bitwise) and w4a16 at the predict head (M = 8, K = 768,
     N = 50257) and at ragged shapes.
3. generation — ``TransformerLM`` at GPT-2-small geometry served by
   ``ClusterServing`` in generation mode (16 prompts, two waves, f32 and
   int8 KV); paged-kernel launches = decode steps x 12; token sequences
   cross-checked against the plain-attention batcher.
4. predict — ``Sequential([TransformerLayer(GPT-2 small, T = 1024),
   GlobalAveragePooling1D, Dense(50257, softmax)])`` from ``--seed``,
   loaded by ``InferenceModel.do_load_model`` and served by
   ``ClusterServing`` in predict mode over ``InProcQueue`` (32 records of
   1024 token ids, batch 8, pipelined workers): f32, then int8 and int4
   heads (``ServingParams.quantize``).  Flash launches = 12 x forwards,
   w8a8 / w4a16 launches = forwards; served top-5 probabilities checked
   against the same model with every kernel's plain version.

The last two lines are the per-kernel JSON record and the contract line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
contract line.  Run from the repository root::

    python3 chip_smoke.py [--seed 0] [--profile]
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.inference.quantize import (_quantize_w4,
                                                        kv_pack_int8,
                                                        weight_bytes)
from analytics_zoo_tpu_torch.models.textmodels import TransformerLM
from analytics_zoo_tpu_torch.nn.layers.attention import TransformerLayer
from analytics_zoo_tpu_torch.nn.layers.core import Dense
from analytics_zoo_tpu_torch.nn.layers.pooling import GlobalAveragePooling1D
from analytics_zoo_tpu_torch.nn.models import Sequential
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from analytics_zoo_tpu_torch.ops import paged_attention as pa
from analytics_zoo_tpu_torch.ops import quant_matmul as qm
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
from analytics_zoo_tpu_torch.serving.engine import ClusterServing, ServingParams
from analytics_zoo_tpu_torch.serving.generate import (ContinuousBatcher,
                                                      GenerationParams,
                                                      GenRequest, commit)
from analytics_zoo_tpu_torch.serving.queues import InProcQueue

# OpenAI's 124M ``gpt2`` config
GPT2_SMALL = dict(vocab_size=50257, hidden=768, n_head=12, n_layers=12,
                  max_len=1024)
GENERATION = dict(paged=True, block_len=16, max_active_slots=8,
                  max_prompt_len=128, max_tokens=64, decode_quantum=4,
                  prefix_cache=True, stream_interval=8)
N_REQUESTS = 16
PREFIX_LEN = 32
# the paged lane's capacity: pow2(max_prompt_len + max_tokens) tokens
LANE = 256
# kernel vs plain: both compute the same f32 convex combination of the
# same values; only the summation order differs
ATOL, RTOL = 2e-5, 1e-5
TIE_MARGIN = 1e-3
# H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor cores,
# dense int8 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12

# the predict path: OpenAI's 124M ``gpt2`` widths at the full context
PREDICT = dict(vocab=50257, hidden_size=768, n_block=12, n_head=12,
               seq_len=1024)
N_RECORDS = 32
PREDICT_BATCH = 8
# flash kernel vs plain: the same f32 math in another summation order
# (f32 out); bf16 outputs round the same f32 values once, so they may
# differ by one bf16 step: at most 2**-7 of |x| (rtol), with atol one
# bf16 step of values below 1 (2**-8)
FLASH_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (4e-3, 8e-3)}
LSE_TOL = (2e-5, 1e-5)
# w4a16 kernel vs plain: f32 sums of K <= 768 products in another order
W4_TOL = (1e-4, 1e-5)
# served predict vs the same model through every kernel's plain version:
# log-probabilities, f32 noise through 12 blocks, read at 2e-7..5e-7 on
# the H100 (PERF.md section 6), so 20x margin (int8 adds the steps of
# activation codes that land on the other side of a rounding edge)
LOGP_TOL = 1e-5
# a planted flash fault (softmax scale off by this factor) that the path
# shape's parity check must reject
PLANTED_SCALE_ERR = 1e-3


def say(*parts) -> None:
    print(*parts, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- phase 1: card + build ----------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


KERNEL_SOURCES = (pa.KERNEL, fa.KERNEL, qm.KERNEL)


def build_kernels() -> dict:
    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES)
    wall = time.perf_counter() - t0
    # load + bind now, not inside a timing
    pa._kernel_fns()
    fa._kernel_fn()
    qm._kernel_fns()
    return {"wall_s": wall, "nvcc_s": dict(_build.BUILD_SECONDS),
            "ptxas": {k: _build.BUILD_LOG.get(k, "")
                      for k in KERNEL_SOURCES}}


# -- phase 2: kernel vs plain -------------------------------------------------

def paged_case(seed: int, lengths, *, rows=8, heads=12, head_dim=64,
               block_len=16, n_table=16, device="cuda"):
    """One paged-attention input set: a random pool with garbage in the
    trash block and every unreferenced block, tables whose entries past a
    row's length point at block 0, and rows 6 and 7 sharing their first
    two blocks."""
    g = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    n_blocks = 1 + rows * n_table
    perm = g.permutation(np.arange(1, n_blocks)).reshape(rows, n_table)
    tables = np.zeros((rows, n_table), np.int32)
    for a in range(rows):
        used = -(-int(lengths[a]) // block_len)
        tables[a, :used] = perm[a, :used]
    tables[7, :2] = tables[6, :2]
    shape = (n_blocks, block_len, heads, head_dim)
    t = {"q": g.normal(size=(rows, heads, head_dim)),
         "k": g.normal(size=shape), "v": g.normal(size=shape)}
    t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
         for k, v in t.items()}
    t["tables"] = torch.from_numpy(tables).to(device)
    t["lengths"] = torch.from_numpy(lengths).to(device)
    return t


def quantize_case(case):
    qk, ks = kv_pack_int8(case["k"])
    qv, vs = kv_pack_int8(case["v"])
    return dict(case, k=qk, v=qv, ks=ks, vs=vs)


def run_paged(case, impl):
    return pa.paged_attention(case["q"], case["k"], case["v"],
                              case["tables"], case["lengths"],
                              case.get("ks"), case.get("vs"), impl=impl)


def cuda_ms(fn, iters: int = 240, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` in ms: ``iters`` calls are
    captured into one CUDA graph, which is replayed once to warm up and
    once between two CUDA events.  Replaying a graph keeps the host's
    per-call cost (Python, argument checks, the launch itself) out of the
    measurement, so back-to-back kernels leave no idle gaps between them
    on the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def cycled(fns):
    """One callable that calls ``fns`` in turn (one per layer)."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()
    return call


def paged_bound(case) -> dict:
    """Least time for one call at these inputs: each input byte the
    function needs read once (K/V rows below each row's length, their
    scales, the table entries it walks, q, lengths), the output written
    once, at the HBM rate; against ~4 flops per K/V element at the f32
    rate.  The larger of the two bounds it."""
    q = case["q"]
    rows, heads, head_dim = q.shape
    bl = case["k"].shape[1]
    lens = case["lengths"].cpu().numpy().astype(np.int64)
    entries = int(np.sum(-(-lens // bl)))
    kv_elems = int(lens.sum()) * heads * head_dim
    nbytes = 2 * kv_elems * case["k"].element_size() \
        + 2 * q.numel() * 4 + entries * 4 + rows * 4
    if "ks" in case:
        nbytes += 2 * entries * heads * 4
    flops = 4 * kv_elems
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def sdpa_yardstick(case):
    """SDPA over the table's blocks gathered into a contiguous, dequantized
    (A, heads, n_table * block_len, head_dim) cache with a length mask.
    The gather is done once, outside the timing: this is a yardstick for
    the attention itself, not the same function as the paged kernel."""
    kc = pa._gather_dequant(case["k"], case.get("ks"), case["tables"])
    vc = pa._gather_dequant(case["v"], case.get("vs"), case["tables"])
    A, T, bl, nh, hd = kc.shape
    kc = kc.reshape(A, T * bl, nh, hd).transpose(1, 2).contiguous()
    vc = vc.reshape(A, T * bl, nh, hd).transpose(1, 2).contiguous()
    mask = (torch.arange(T * bl, device=kc.device)[None]
            < case["lengths"][:, None])[:, None, None, :]
    q = case["q"][:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)


def kernel_phase(seed: int, n_layers: int) -> dict:
    """Parity on the card for both pool types, then timing.  Returns the
    per-variant record (without launches, which the main path fills)."""
    parity_lengths = {
        "ragged": [1, 16, 17, 256, 100, 33, 255, 64],
        "edges": [16, 32, 48, 256, 1, 2, 128, 240],
    }
    g = np.random.default_rng(seed + 1)
    # decode-time lengths of the main path: prompt 16..128 + 1..64 tokens
    timing_lengths = g.integers(17, 193, 8)
    out = {}
    for variant in ("f32", "int8"):
        worst = 0.0
        for i, (tag, lens) in enumerate(parity_lengths.items()):
            case = paged_case(seed + 10 * i, lens)
            if variant == "int8":
                case = quantize_case(case)
            got = run_paged(case, "cuda")
            torch.cuda.synchronize()
            ref = run_paged(case, "torch")
            err = (got - ref).abs()
            worst = max(worst, float(err.max()))
            ok = bool((err <= ATOL + RTOL * ref.abs()).all())
            check(bool(torch.isfinite(got).all()),
                  f"kernel[{variant}/{tag}]: non-finite output")
            check(ok, f"kernel[{variant}/{tag}]: max abs err "
                      f"{float(err.max()):.3e} outside atol {ATOL} rtol "
                      f"{RTOL}")
            say(f"kernel[{variant}] parity {tag} lengths={lens}: max abs "
                f"err {float(err.max()):.3e} (atol {ATOL}, rtol {RTOL})")
        # timing: one pool set per layer, cycled like a decode step does,
        # so the caches are not all resident in L2
        cases = [paged_case(seed + 100 + li, timing_lengths)
                 for li in range(n_layers)]
        if variant == "int8":
            cases = [quantize_case(c) for c in cases]
        sdpa = [sdpa_yardstick(c) for c in cases]
        ms = cuda_ms(cycled([lambda c=c: run_paged(c, "cuda")
                             for c in cases]))
        plain_ms = cuda_ms(cycled([lambda c=c: run_paged(c, "torch")
                                   for c in cases]))
        lib_ms = cuda_ms(cycled(sdpa))
        b = paged_bound(cases[0])
        say(f"kernel[{variant}] timing lengths={timing_lengths.tolist()}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA over "
            f"pre-gathered cache (yardstick) {lib_ms:.4f} ms, bound "
            f"{b['bound_ms']:.5f} ms ({b['bound_by']}: {b['bytes']} B, "
            f"{b['flops']} flop)")
        out[variant] = {
            "name": f"paged_attention[{variant}]", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/paged_attention.cu",
            "replaces": "analytics_zoo_tpu/ops/paged_attention.py:105",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": lib_ms}
    return out


# -- phase 3: the served main path --------------------------------------------

def make_requests(seed: int, vocab: int):
    """16 prompts of 16..128 tokens; the even ones share a 32-token prefix.
    Wave 1 holds one sharer whose length (40) registers exactly the two
    prefix blocks, and 7 unique prompts; wave 2 the 7 other sharers (prefix
    hits: ``pshared``) and 1 unique prompt."""
    g = np.random.default_rng(seed + 7)
    prefix = g.integers(0, vocab, PREFIX_LEN)
    reqs = []
    for i in range(N_REQUESTS):
        if i % 2 == 0:
            n = 40 if i == 0 else int(g.integers(PREFIX_LEN + 1, 129))
            p = np.concatenate([prefix, g.integers(0, vocab, n - PREFIX_LEN)])
        else:
            p = g.integers(0, vocab, int(g.integers(16, 129)))
        reqs.append((f"req-{i:02d}", p.astype(np.int32)))
    first = [0, 1, 3, 5, 7, 9, 11, 13]
    return [[reqs[i] for i in first],
            [r for i, r in enumerate(reqs) if i not in first]]


def serve(im, waves, kv_quant: str, timeout_s: float = 600.0) -> dict:
    """Drive ClusterServing over InProcQueue; returns the terminal results
    and the run's counters."""
    q = InProcQueue()
    params = ServingParams(max_batch=N_REQUESTS, max_wait_ms=2.0,
                           generation=dict(GENERATION, kv_quant=kv_quant))
    serving = ClusterServing(im, q, params)
    iq, oq = InputQueue(q), OutputQueue(q)
    results = {}
    pa.launches = 0
    try:
        serving.start()
        t0 = time.perf_counter()
        for wave in waves:
            for rid, prompt in wave:
                iq.enqueue_tensor(rid, prompt.astype(np.float32))
            got = oq.query_many([rid for rid, _ in wave],
                                timeout_s=timeout_s)
            results.update(got)
        wall = time.perf_counter() - t0
    finally:
        serving.shutdown(drain_s=5.0)
    torch.cuda.synchronize()
    launches = pa.launches
    b = serving._batcher
    stats = b.stats()
    ttft = serving._m_ttft.percentiles((50,))["p50"]
    return {"results": results, "wall_s": wall, "launches": launches,
            "stats": stats, "ttft_p50_s": ttft,
            "layers": im._model.n_layers}


def check_served(run: dict, waves, vocab: int, kv_quant: str) -> dict:
    tokens = {}
    for wave in waves:
        for rid, prompt in wave:
            r = run["results"].get(rid)
            check(r is not None and "value" in r
                  and not OutputQueue.is_partial(r),
                  f"[{kv_quant}] {rid}: no terminal result ({r})")
            toks = r["value"]["tokens"]
            want = min(GENERATION["max_tokens"], LANE - len(prompt))
            check(len(toks) == want and r["value"]["length"] == want,
                  f"[{kv_quant}] {rid}: {len(toks)} tokens, want {want}")
            check(all(0 <= t < vocab for t in toks),
                  f"[{kv_quant}] {rid}: token out of range")
            tokens[rid] = list(toks)
    st = run["stats"]
    steps = st["decode_steps"]
    check(st["finished"] == N_REQUESTS and st["quarantined"] == 0
          and st["shed"] == 0, f"[{kv_quant}] scheduler stats {st}")
    check(st["pool"]["prefix_hits"] > 0,
          f"[{kv_quant}] no prefix hit: pshared never ran ({st['pool']})")
    check(run["launches"] > 0
          and run["launches"] == steps * run["layers"],
          f"[{kv_quant}] paged kernel launches {run['launches']} != decode "
          f"steps {steps} x {run['layers']} layers")
    n_tok = sum(len(t) for t in tokens.values())
    say(f"main[{kv_quant}]: {len(tokens)}/{N_REQUESTS} terminal results, "
        f"{n_tok} tokens in {run['wall_s']:.3f} s = "
        f"{n_tok / run['wall_s']:.1f} tokens/s, TTFT p50 "
        f"{run['ttft_p50_s'] * 1e3:.2f} ms, decode steps {steps}, paged "
        f"kernel launches {run['launches']} (= {steps} x "
        f"{run['layers']}), prefix hits {st['pool']['prefix_hits']}")
    return tokens


# -- phase 4: cross-check against the plain attention -------------------------

def batcher_tokens(im, waves, kv_quant: str, impl: str) -> dict:
    b = ContinuousBatcher(im, GenerationParams(**dict(GENERATION,
                                                      kv_quant=kv_quant)),
                          impl=impl)
    done = {}
    for wave in waves:
        for rid, prompt in wave:
            check(b.submit(GenRequest(rid, prompt)), "waiting room full")
        want = len(done) + len(wave)
        while len(done) < want:
            for ev in b.step():
                check(ev.kind not in ("shed", "quarantine"),
                      f"cross-check {ev.kind} on {ev.rid}: {ev.error}")
                if ev.kind == "finish":
                    done[ev.rid] = list(ev.tokens)
    return done


@torch.inference_mode()
def replay_margin(lm, prompt, tokens, d: int, kv_quant: str):
    """``(top-2 logit margin, argmax)`` of the logits that pick
    ``tokens[d]``: one row replayed through the paged path (plain
    attention) with the first ``d`` tokens fed back."""
    bl = GENERATION["block_len"]
    ntab = LANE // bl
    dev = lm.device
    pools = lm.init_paged_pools(1 + ntab, bl, 1, kv_quant)
    tables = torch.arange(1, ntab + 1, dtype=torch.int32,
                          device=dev)[None]
    plen = len(prompt)
    lengths = torch.tensor([plen], dtype=torch.int32, device=dev)
    ks, vs, logits = lm.prefill_kv(torch.as_tensor(prompt)[None], lengths)
    commit(pools, ks, vs, lengths, tables[:, :-(-plen // bl)],
           torch.zeros(1, dtype=torch.int32, device=dev), block_len=bl,
           kv_quant=kv_quant)
    for i in range(d):
        logits, _ = lm.decode_paged(pools, tables, [plen + i], [tokens[i]],
                                    block_len=bl, kv_quant=kv_quant,
                                    impl="torch")
    top = torch.topk(logits[0], 2)
    return float(top.values[0] - top.values[1]), int(top.indices[0])


def cross_check(im, waves, served: dict, kv_quant: str) -> None:
    plain = batcher_tokens(im, waves, kv_quant, "torch")
    prompts = {rid: p for wave in waves for rid, p in wave}
    diverged = 0
    for rid, toks in served.items():
        ref = plain[rid]
        if ref == toks:
            continue
        d = next(i for i, (a, b) in enumerate(zip(toks, ref)) if a != b)
        margin, top = replay_margin(im._model, prompts[rid], toks, d,
                                    kv_quant)
        say(f"cross[{kv_quant}] {rid}: diverges at token {d} "
            f"(kernel {toks[d]}, plain {ref[d]}, replay {top}), top-2 "
            f"logit margin {margin:.3e}")
        check(top in (toks[d], ref[d]),
              f"cross[{kv_quant}] {rid}: the replay picks neither token")
        check(margin < TIE_MARGIN,
              f"cross[{kv_quant}] {rid}: divergence at token {d} is not a "
              f"near tie (margin {margin:.3e} >= {TIE_MARGIN})")
        diverged += 1
    say(f"cross[{kv_quant}]: {len(served) - diverged}/{len(served)} token "
        f"sequences identical to the plain-attention batcher, {diverged} "
        f"diverged at a near tie")


# -- phase 2b: flash attention, w8a8 and w4a16 against their plain versions ---

def bound(nbytes: int, ops: int, op_rate: float) -> dict:
    """The least time for the work: bytes at the HBM rate against
    operations at ``op_rate``; the larger of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def flash_bound(B, H, T, D, causal, in_bytes=4, out_bytes=4, lse=False):
    """q, k, v read once, the output (and LSE) written once; 4·D flop per
    (query, key) pair the mask keeps: T(T+1)/2 pairs causal, T² not."""
    pairs = T * (T + 1) // 2 if causal else T * T
    nbytes = B * H * T * D * (3 * in_bytes + out_bytes) \
        + (B * H * T * 4 if lse else 0)
    return bound(nbytes, 4 * B * H * pairs * D, F32_FLOP_PER_S)


def w8a8_bound(M, K, N):
    return bound(M * K + K * N + 4 * N + 4 * M * N, 2 * M * K * N,
                 INT8_OP_PER_S)


def w4a16_bound(M, K, N, G, x_bytes=4):
    """x, the packed weight, its group scales and the output once; 2 flop
    per product plus one dequantizing multiply per weight."""
    return bound(M * K * x_bytes + (K + 1) // 2 * N + 4 * G * N + 4 * M * N,
                 2 * M * K * N + K * N, F32_FLOP_PER_S)


def qkv_views(g, B, T, H, D, dtype, device="cuda"):
    """q, k, v as (B, H, T, D) views of one (B, T, 3·H·D) projection — the
    layout ``MultiHeadAttention`` hands the kernel."""
    qkv = torch.from_numpy(
        g.standard_normal((B, T, 3 * H * D), dtype=np.float32)).to(
            device, dtype)
    return [t.unflatten(-1, (H, D)).transpose(1, 2)
            for t in qkv.split(H * D, dim=-1)]


def run_flash(q, k, v, causal, lse, impl, out_dtype=None):
    if lse:
        return fa.flash_attention_with_lse(q, k, v, causal=causal,
                                           out_dtype=out_dtype, impl=impl)
    return fa.flash_attention(q, k, v, causal=causal, impl=impl), None


def check_close(tag, got, ref, atol, rtol) -> float:
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    worst = float(err.max())
    check(ok, f"{tag}: max abs err {worst:.3e} outside atol {atol} rtol "
              f"{rtol}")
    return worst


def flash_parity(seed: int) -> dict:
    """Kernel vs plain version over dtypes, masks, ragged T, LSE, head_dim
    and layouts.  Returns the worst abs error per output dtype."""
    g = np.random.default_rng(seed + 20)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(dt, causal, T, lse, 64, None)
             for dt in (torch.float32, torch.bfloat16)
             for causal in (False, True) for T in (77, 1000, 1024)
             for lse in (False, True)]
    # other head_dims, and bf16 inputs with f32 outputs (out_dtype)
    cases += [(torch.float32, True, 77, True, 32, None),
              (torch.float32, False, 200, False, 128, None),
              (torch.bfloat16, True, 1000, True, 64, torch.float32)]
    for dt, causal, T, lse, D, out_dt in cases:
        q, k, v = qkv_views(g, 2, T, 4, D, dt)
        got, glse = run_flash(q, k, v, causal, lse, "cuda", out_dt)
        torch.cuda.synchronize()
        ref, rlse = run_flash(q, k, v, causal, lse, "torch", out_dt)
        o_dt = out_dt or dt
        tag = (f"flash[{str(dt)[6:]}->{str(o_dt)[6:]} causal={causal} "
               f"T={T} D={D} lse={lse}]")
        err = check_close(tag, got, ref, *FLASH_TOL[o_dt])
        worst[o_dt] = max(worst[o_dt], err)
        if lse:
            worst[torch.float32] = max(worst[torch.float32], check_close(
                tag + " lse", glse, rlse, *LSE_TOL))
    # contiguous (B, H, T, D) inputs, as a direct caller may pass them
    q, k, v = (t.contiguous() for t in qkv_views(g, 2, 333, 4, 64,
                                                  torch.float32))
    got, _ = run_flash(q, k, v, True, False, "cuda")
    ref, _ = run_flash(q, k, v, True, False, "torch")
    worst[torch.float32] = max(worst[torch.float32], check_close(
        "flash[contiguous]", got, ref, *FLASH_TOL[torch.float32]))
    say(f"flash parity: {len(cases) + 1} cases, max abs err f32 "
        f"{worst[torch.float32]:.3e} (atol {FLASH_TOL[torch.float32][0]}, "
        f"rtol {FLASH_TOL[torch.float32][1]}), bf16 "
        f"{worst[torch.bfloat16]:.3e} (atol {FLASH_TOL[torch.bfloat16][0]},"
        f" rtol {FLASH_TOL[torch.bfloat16][1]})")
    return worst


def flash_path_parity(q, k, v, D) -> float:
    """Kernel vs plain at the path shape, output and LSE; and a planted
    fault (the scale off by ``PLANTED_SCALE_ERR``) that the check must
    reject.  Returns the worst abs error."""
    scale = 1.0 / math.sqrt(D)
    got, glse = run_flash(q, k, v, True, True, "cuda")
    ref, rlse = run_flash(q, k, v, True, True, "torch")
    tag = f"flash[path {tuple(q.shape)} f32 causal]"
    worst = max(check_close(tag, got, ref, *FLASH_TOL[torch.float32]),
                check_close(tag + " lse", glse, rlse, *LSE_TOL))
    # the same path with lse=False, as MultiHeadAttention calls it
    worst = max(worst, check_close(
        tag, fa.flash_attention(q, k, v, True, impl="cuda"), ref,
        *FLASH_TOL[torch.float32]))
    bad, _ = fa.flash_attention_torch(q, k, v, True,
                                      scale * (1 + PLANTED_SCALE_ERR))
    try:
        planted = check_close("planted", got, bad, *FLASH_TOL[torch.float32])
    except SmokeFailure:
        planted = float((got - bad).abs().max())
    else:
        raise SmokeFailure(f"{tag}: a scale off by {PLANTED_SCALE_ERR} "
                           f"passes the parity check (err {planted:.3e})")
    say(f"{tag} parity: max abs err {worst:.3e} (out and lse; atol "
        f"{FLASH_TOL[torch.float32][0]}, rtol {FLASH_TOL[torch.float32][1]})"
        f"; planted fault (scale x {1 + PLANTED_SCALE_ERR}) err "
        f"{planted:.3e}, rejected")
    return worst


def flash_timing(seed: int, B=8, H=12, T=1024, D=64, iters=40,
                 parity=False) -> dict:
    g = np.random.default_rng(seed + 21 + T)
    q, k, v = qkv_views(g, B, T, H, D, torch.float32)
    err = flash_path_parity(q, k, v, D) if parity else None
    scale = 1.0 / math.sqrt(D)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, True, impl="cuda"),
                 iters=iters)
    plain_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, True,
                                                  impl="torch"), iters=iters)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), iters=iters)
    b = flash_bound(B, H, T, D, True)
    say(f"flash timing (B={B}, H={H}, T={T}, D={D}, f32, causal): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
        f"{b['ops']} flop)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "max_abs_err": err, **b}


def w8a8_case(g, M, K, N):
    x = torch.from_numpy(g.integers(-127, 128, (M, K), dtype=np.int8))
    w = torch.from_numpy(g.integers(-127, 128, (K, N), dtype=np.int8))
    s = torch.from_numpy(g.uniform(1e-4, 1e-2, N).astype(np.float32))
    return x.cuda(), w.cuda(), s.cuda()


def w8a8_phase(seed: int, M=8, K=768, N=50257) -> dict:
    g = np.random.default_rng(seed + 30)
    for m, k, n in ((1, K, N), (M, K, N), (33, K, N), (37, 100, 61)):
        x, w, s = w8a8_case(g, m, k, n)
        got = qm.w8a8_matmul(x, w, s, impl="cuda")
        torch.cuda.synchronize()
        ref = qm.w8a8_matmul(x, w, s, impl="torch")
        check(torch.equal(got, ref),
              f"w8a8 ({m}, {k}, {n}): not bitwise equal to the plain "
              f"version (max abs err {float((got - ref).abs().max()):.3e})")
    say("w8a8 parity: bitwise equal at (M, K, N) = (1|8|33, 768, 50257) "
        "and (37, 100, 61)")
    x, w, s = w8a8_case(g, M, K, N)
    # _int_mm needs M > 16 and K, N multiples of 8: pad M to 32, N to 8
    n8 = -(-N // 8) * 8
    xp = torch.zeros(32, K, dtype=torch.int8, device="cuda")
    xp[:M] = x
    wp = torch.zeros(K, n8, dtype=torch.int8, device="cuda")
    wp[:, :N] = w
    ms = cuda_ms(lambda: qm.w8a8_matmul(x, w, s, impl="cuda"))
    plain_ms = cuda_ms(lambda: qm.w8a8_matmul(x, w, s, impl="torch"))
    lib_ms = cuda_ms(lambda: torch._int_mm(xp, wp)[:M, :N].float() * s)
    b = w8a8_bound(M, K, N)
    say(f"w8a8 timing (M={M}, K={K}, N={N}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch._int_mm (M padded to 32, N to {n8}) + "
        f"scale {lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}: {b['bytes']} B)")
    return {"name": "w8a8_matmul", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "analytics_zoo_tpu/ops/quant_matmul.py:144",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": lib_ms}


def w4a16_case(g, M, K, N, group, dtype=torch.float32):
    W = (g.standard_normal((K, N)) * 0.05).astype(np.float32)
    leaves = _quantize_w4(W, group)
    x = torch.from_numpy(g.standard_normal((M, K), dtype=np.float32))
    return (x.to("cuda", dtype), torch.from_numpy(leaves["W_q4"]).cuda(),
            torch.from_numpy(leaves["s_g"]).cuda())


def w4a16_phase(seed: int, M=8, K=768, N=50257) -> dict:
    g = np.random.default_rng(seed + 40)
    worst = 0.0
    cases = [(M, K, N, 64, torch.float32), (M, K, N, 64, torch.bfloat16),
             (33, K, 1000, 64, torch.float32),
             (5, 100, 61, 34, torch.float32),     # G = 3, last group 32
             (3, 101, 61, 26, torch.float32)]     # odd K, G = 4
    for m, k, n, group, dt in cases:
        x, wq, sg = w4a16_case(g, m, k, n, group, dt)
        got = qm.w4a16_matmul(x, wq, sg, impl="cuda")
        torch.cuda.synchronize()
        ref = qm.w4a16_matmul(x, wq, sg, impl="torch")
        worst = max(worst, check_close(
            f"w4a16 ({m}, {k}, {n}, G={sg.shape[0]}, {str(dt)[6:]})",
            got, ref, *W4_TOL))
    say(f"w4a16 parity: {len(cases)} cases (head shape f32 and bf16, M=33,"
        f" ragged K=100 G=3, odd K=101 G=4), max abs err {worst:.3e} "
        f"(atol {W4_TOL[0]}, rtol {W4_TOL[1]})")
    x, wq, sg = w4a16_case(g, M, K, N, 64)
    ms = cuda_ms(lambda: qm.w4a16_matmul(x, wq, sg, impl="cuda"))
    plain_ms = cuda_ms(lambda: qm.w4a16_matmul(x, wq, sg, impl="torch"))
    b = w4a16_bound(M, K, N, sg.shape[0])
    say(f"w4a16 timing (M={M}, K={K}, N={N}, G={sg.shape[0]}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, no single PyTorch call, "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
        f"{b['ops']} flop)")
    return {"name": "w4a16_matmul", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "analytics_zoo_tpu/ops/quant_matmul.py:187",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None}


def predict_kernel_phase(seed: int) -> dict:
    """Parity and timing of the predict path's three kernels.  Returns
    their records (launches filled by the predict phase)."""
    worst = flash_parity(seed)
    t = flash_timing(seed, parity=True)
    for short in (128, 512):
        flash_timing(seed, T=short, iters=200)
    flash = {"name": "flash_attention_fwd[f32]", "route": "cuda",
             "source": "analytics_zoo_tpu_torch/csrc/flash_attention.cu",
             "replaces": "analytics_zoo_tpu/ops/flash_attention.py:52",
             "launches": None,
             "max_abs_err": max(worst[torch.float32], t["max_abs_err"]),
             "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t["library_ms"]}
    return {"flash": flash, "w8a8": w8a8_phase(seed),
            "w4a16": w4a16_phase(seed)}


# -- phase 4: the served predict path ------------------------------------------

def build_predict_model(seed: int) -> Sequential:
    T = PREDICT["seq_len"]
    return Sequential([
        TransformerLayer(**PREDICT, input_shape=(T,)),
        GlobalAveragePooling1D(),
        Dense(PREDICT["vocab"], activation="softmax")]).init_weights(seed)


def predict_records(seed: int, n: int = N_RECORDS) -> np.ndarray:
    g = np.random.default_rng(seed + 50)
    return g.integers(0, PREDICT["vocab"],
                      (n, PREDICT["seq_len"])).astype(np.float32)


def set_impl(model, impl) -> None:
    """Every kernel of the model (flash, w8a8, w4a16) or its plain
    version."""
    for m in model.modules():
        if hasattr(m, "impl"):
            m.impl = impl


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_launches() -> None:
    fa.launches = qm.launches_w8a8 = qm.launches_w4a16 = 0


def serve_predict(im, X, params) -> dict:
    """ClusterServing in predict mode over InProcQueue: all records
    enqueued, then the pipelined workers started; counts and forwards are
    read over exactly that run."""
    q = InProcQueue()
    serving = ClusterServing(im, q, params)     # quantizes here
    iq, oq = InputQueue(q), OutputQueue(q)
    rids = [f"rec-{i:02d}" for i in range(len(X))]
    for rid, x in zip(rids, X):
        iq.enqueue_tensor(rid, x)
    forwards = [0]
    hook = im._model.layers_list[0].register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sync(im.device)
    reset_launches()
    try:
        t0 = time.perf_counter()
        serving.start()
        results = oq.query_many(rids, timeout_s=600.0)
        wall = time.perf_counter() - t0
    finally:
        serving.shutdown(drain_s=5.0)
        hook.remove()
    sync(im.device)
    return {"rids": rids, "results": results, "wall_s": wall,
            "forwards": forwards[0], "flash": fa.launches,
            "w8a8": qm.launches_w8a8, "w4a16": qm.launches_w4a16,
            "e2e_p50_s": serving._e2e.percentiles((50,))["p50"],
            "dead_lettered": serving.dead_lettered}


@torch.inference_mode()
def head_inputs(im, X, impl):
    """Probabilities of the whole model with ``impl`` and the inputs the
    head saw."""
    seen = []
    head = im._model.layers_list[-1]
    hook = head.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].clone()))
    set_impl(im._model, impl)
    try:
        probs = im.do_predict(X, batch_size=PREDICT_BATCH)
    finally:
        set_impl(im._model, None)
        hook.remove()
    return probs, torch.cat(seen)


def logp_tolerance(im, x_kernel, x_plain) -> np.ndarray:
    """Per-row log-probability tolerance of the served path against the
    plain one: ``LOGP_TOL``, plus for an int8 head twice the largest logit
    step that the activation codes which differ between the two paths can
    make (each code step moves a logit by at most s_x·max|W|)."""
    head = im._model.layers_list[-1]
    tol = np.full(len(x_kernel), LOGP_TOL)
    if head.bits == 8:
        def codes(x):
            return torch.clamp(torch.round(x / head.s_x), -127, 127)
        steps = (codes(x_kernel) - codes(x_plain)).abs().sum(-1)
        w_max = float((head.W_q.float().abs() * head.s_w).max())
        tol += (2 * steps * float(head.s_x) * w_max).cpu().numpy()
    return tol


def check_predict(tag: str, run: dict, ref_probs, tol, quant) -> dict:
    """Every record answered with a top-5 whose probabilities match the
    plain path's; top-1 equal where the plain top-2 margin exceeds the
    tolerance; launches = 12 x forwards (flash) and = forwards (quant)."""
    n = len(run["rids"])
    check(run["dead_lettered"] == 0, f"predict[{tag}]: records quarantined")
    ref_logp = np.log(ref_probs.astype(np.float64))
    top1, worst, compared = [], 0.0, 0
    for i, rid in enumerate(run["rids"]):
        r = run["results"].get(rid)
        check(r is not None and "value" in r,
              f"predict[{tag}] {rid}: no result ({r})")
        top = r["value"]
        check(len(top) == 5, f"predict[{tag}] {rid}: top-{len(top)}")
        cls = [int(c) for c, _ in top]
        lp = np.log(np.asarray([p for _, p in top], np.float64))
        check(bool(np.isfinite(lp).all()) and all(
            0 <= c < PREDICT["vocab"] for c in cls),
              f"predict[{tag}] {rid}: malformed top-5 {top}")
        err = float(np.abs(lp - ref_logp[i, cls]).max())
        worst = max(worst, err)
        check(err <= tol[i], f"predict[{tag}] {rid}: log-prob error "
                             f"{err:.3e} > {tol[i]:.3e}")
        order = np.sort(ref_logp[i])
        if order[-1] - order[-2] > 2 * tol[i]:
            compared += 1
            check(cls[0] == int(np.argmax(ref_logp[i])),
                  f"predict[{tag}] {rid}: top-1 {cls[0]} != plain "
                  f"{int(np.argmax(ref_logp[i]))}")
        top1.append(cls[0])
    fw = run["forwards"]
    check(fw > 0 and run["flash"] == fw * PREDICT["n_block"],
          f"predict[{tag}]: flash launches {run['flash']} != {fw} forwards "
          f"x {PREDICT['n_block']} blocks")
    if quant:
        check(run[quant] == fw, f"predict[{tag}]: {quant} launches "
                                f"{run[quant]} != {fw} forwards")
    say(f"predict[{tag}]: {len(run['results'])}/{n} records served in "
        f"{run['wall_s']:.3f} s = {n / run['wall_s']:.2f} records/s, e2e "
        f"p50 {run['e2e_p50_s'] * 1e3:.1f} ms; {fw} forwards, flash "
        f"launches {run['flash']}" + (f", {quant} launches {run[quant]}"
                                      if quant else "")
        + f"; top-5 log-prob max err vs plain {worst:.3e}, top-1 checked "
        f"on {compared}/{n} (plain top-2 margin > 2 x tolerance)")
    return {"top1": top1, "run": run}


def predict_phase(seed: int, float_model, records: dict) -> None:
    """f32, int8 and int4 served in turn (each quantized variant on a copy
    of the float model); fills the kernels' launch counts."""
    dev = next(float_model.parameters()).device
    X = predict_records(seed)
    params = dict(batch_size=PREDICT_BATCH, max_wait_ms=2.0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        calib = os.path.join(tmp, "calib.npy")
        np.save(calib, predict_records(seed + 1, PREDICT_BATCH))
        for tag, quant, spec in (("f32", None, None),
                                 ("int8", "w8a8", {"bits": 8,
                                                   "calib": calib}),
                                 ("int4", "w4a16", "int4")):
            model = float_model if spec is None \
                else copy.deepcopy(float_model)
            im = InferenceModel(device=dev).do_load_model(model)
            run = serve_predict(im, X, ServingParams(quantize=spec,
                                                     **params))
            ref, x_plain = head_inputs(im, X, "torch")
            _, x_kernel = head_inputs(im, X, None)
            tol = logp_tolerance(im, x_kernel, x_plain)
            out[tag] = check_predict(tag, run, ref, tol, quant)
            out[tag]["bytes"] = weight_bytes(im._params)
            if tag != "f32":
                agree = np.mean(np.asarray(out[tag]["top1"])
                                == np.asarray(out["f32"]["top1"]))
                say(f"predict[{tag}]: weight_bytes {out[tag]['bytes']} vs "
                    f"f32 {out['f32']['bytes']} "
                    f"({out['f32']['bytes'] / out[tag]['bytes']:.2f}x "
                    f"smaller), head {im._model.layers_list[-1].bits}-bit; "
                    f"top-1 agreement with the f32 path {agree:.3f}")
            del im, model
    records["flash"]["launches"] = out["f32"]["run"]["flash"]
    records["w8a8"]["launches"] = out["int8"]["run"]["w8a8"]
    records["w4a16"]["launches"] = out["int4"]["run"]["w4a16"]


# -- optional: where the decode time goes -------------------------------------

def kernel_rows(prof):
    """(name, calls, ms) of every kernel in a profile, slowest first, and
    their summed device seconds.  Kernel rows only: an operator's row
    repeats its kernels' time."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return rows, sum(r[2] for r in rows) / 1e3


def profile_predict(im, X) -> None:
    """One predict batch under ``torch.profiler``: the device's busy share
    of the wall time and the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        im.do_predict(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, busy = kernel_rows(prof)
    say(f"profile[predict]: one batch of {len(X)} x {X.shape[1]} tokens in "
        f"{wall * 1e3:.2f} ms under the profiler, kernels {busy * 1e3:.2f} "
        f"ms ({100 * busy / wall:.1f}% of the wall)")
    for name, count, ms in rows[:12]:
        say(f"profile[predict]   {ms:9.3f} ms  {count:4d} calls  "
            f"{name[:90]}")


def profile_decode(im, waves, kv_quant: str, boundaries: int = 4) -> None:
    """Wall time per decode step over ``boundaries`` decode boundaries of
    a full batch (8 active rows, no admissions), then ``torch.profiler``
    over as many more: the device's busy share (summed kernel time over
    the profiled wall time) and the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    b = ContinuousBatcher(im, GenerationParams(**dict(GENERATION,
                                                      kv_quant=kv_quant)))
    for rid, prompt in waves[0]:
        b.submit(GenRequest(rid, prompt))
    b.step()                              # admission + first quantum
    b.step()
    torch.cuda.synchronize()
    steps0 = b.decode_steps
    t0 = time.perf_counter()
    for _ in range(boundaries):
        b.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_steps = b.decode_steps - steps0
    steps0 = b.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(boundaries):
            b.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = b.decode_steps - steps0
    rows, busy = kernel_rows(prof)
    say(f"profile[{kv_quant}]: {plain_steps} decode steps (8 rows) in "
        f"{plain_wall * 1e3:.2f} ms = {plain_wall * 1e3 / plain_steps:.3f} "
        f"ms/step; under the profiler {wall * 1e3 / steps:.3f} ms/step, "
        f"kernels {busy * 1e3 / steps:.3f} ms/step ({100 * busy / wall:.1f}% "
        f"of the profiled wall)")
    for name, count, ms in rows[:10]:
        say(f"profile[{kv_quant}]   {ms / steps:8.4f} ms/step  "
            f"{count // steps:4d} calls/step  {name[:90]}")


# -- main ---------------------------------------------------------------------

def ptxas_summary(log: str) -> str:
    """``kernel<template args>: N regs[, spills]`` for every compiled entry
    point (names taken from the mangled symbol)."""
    out, entry = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.strip()
            # the symbol's <length><name> piece that names a *_kernel (a
            # length may follow digits of the namespace's hash)
            for m in re.finditer(r"\d+(?=[A-Za-z_])", ln):
                names = [ln[m.end():m.end() + int(m.group(0)[i:])]
                         for i in range(len(m.group(0)))]
                name = next((n for n in names if n.endswith("_kernel")),
                            None)
                if name:
                    args = re.match(r"I(.*?)E", ln[m.end() + len(name):])
                    entry = name + (f"<{args.group(1)}>" if args else "")
                    break
        elif "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{entry}: {regs} regs")
        elif "spill" in ln and not re.search(r"\b0 bytes spill stores", ln):
            out.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
    return "; ".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile a decode step and a predict batch "
                         "(torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    say(f"card: {card_line()}")
    b = build_kernels()
    say(f"build: {b['wall_s']:.2f} s (nvcc {b['nvcc_s']})")
    for name, log in b["ptxas"].items():
        say(f"ptxas[{name}]: {ptxas_summary(log)}")

    records = kernel_phase(args.seed, GPT2_SMALL["n_layers"])
    records.update(predict_kernel_phase(args.seed))

    t0 = time.perf_counter()
    lm = TransformerLM(**GPT2_SMALL, seed=args.seed, device=dev)
    im = InferenceModel(device=dev).do_load_model(lm)
    say(f"model: TransformerLM {GPT2_SMALL} ({lm.param_count()} params) built and "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    waves = make_requests(args.seed, GPT2_SMALL["vocab_size"])
    lm.generate(waves[0][0][1][None, :16], max_tokens=2)   # CUDA warm-up
    torch.cuda.synchronize()
    served = {}
    for kv_quant, variant in (("off", "f32"), ("int8", "int8")):
        run = serve(im, waves, kv_quant)
        served[kv_quant] = check_served(run, waves, GPT2_SMALL["vocab_size"],
                                        kv_quant)
        records[variant]["launches"] = run["launches"]
    for kv_quant in ("off", "int8"):
        cross_check(im, waves, served[kv_quant], kv_quant)
    if args.profile:
        for kv_quant in ("off", "int8"):
            profile_decode(im, waves, kv_quant)
    del lm, im
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = build_predict_model(args.seed)
    pim = InferenceModel(device=dev).do_load_model(model)
    X = predict_records(args.seed)
    pim.do_predict(X[:PREDICT_BATCH])                    # CUDA warm-up
    torch.cuda.synchronize()
    say(f"model: Sequential[TransformerLayer {PREDICT}, "
        f"GlobalAveragePooling1D, Dense({PREDICT['vocab']}, softmax)] "
        f"({model.param_count()} params) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    if args.profile:
        profile_predict(pim, X[:PREDICT_BATCH])
    predict_phase(args.seed, model, records)

    say(json.dumps({"kernels": [records[k] for k in (
        "f32", "int8", "flash", "w8a8", "w4a16")]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
