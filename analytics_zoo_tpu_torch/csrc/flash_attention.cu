// Flash attention forward for NVIDIA Hopper (sm_90a), on the tensor cores.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py::_fwd_kernel (:52), the
// Pallas TPU kernel that _flash_fwd (:107) hands to pl.pallas_call (:137):
// out = softmax(q·kᵀ·scale)·v per (batch, head), with the online softmax
// over key tiles, an optional causal mask (key ≤ query), and optionally the
// per-row log-sum-exp m + log(l) (scaled-logits domain, stored (B, H, T)).
// q/k/v are f32 or bf16 and the output f32 or bf16; all arithmetic keeps
// f32 accuracy.  scale is applied to q in f32 before the dot, as the TPU
// kernel does.
//
// What bounds it on the card: operations.  At the paths' shape (B·H = 96,
// T = 1024, D = 64, causal) it does 4·D flop per kept (query, key) pair,
// 12.9 GFLOP, on 0.1 GB of q, k, v and out; an f32-accurate product on the
// tensor cores costs three TF32 products, so the bound is 12.9 GFLOP at
// 495 / 3 TFLOP/s, about 0.078 ms.  The design is the backward's
// (flash_attention_bwd.cu, whose building blocks are in mma_tf32.cuh):
//  - one block of four warps per (b·h, 64-query tile), each warp owning 16
//    query rows; the query tiles nearest the causal diagonal carry the most
//    keys and are issued first.  q·scale is split once into the A layout in
//    shared memory, its fragments one 16-byte load per part and lane.
//  - k and v stream in 32-row tiles: the next tile's raw cp.async copies
//    (zero-filled past T by src-size) fly into a raw stage while the
//    products read the split stage; a landed tile is split once into the
//    swizzled row layout.
//  - s = q·kᵀ is 3xTF32 mma.sync.m16n8k8 with two k-steps over d summed
//    into a zeroed partial (the tensor core truncates an mma's sum against
//    its C operand); the loop over d is unrolled, so the D/16 partials'
//    chains of 6 dependent mmas run side by side.  The online softmax runs
//    on the accumulator registers: a row's values lie in one lane quad, so
//    its max takes two shuffles; exp is ex2.approx of an FMA; the row sums
//    stay per lane until the end.
//    p feeds p·v from the registers (accumulator columns 2t and 2t + 1 are
//    the contraction slots t and t + 4), split in place, and v's B
//    fragments are read along tokens, one k-step (3 mmas) per partial.
//  - masks: keys at or past T and, causal, keys past the query; tiles the
//    mask keeps whole skip it, and the causal loop stops at the diagonal
//    tile.  The TPU kernel walks every key block and relies on masked
//    blocks adding exact zeros, so stopping changes only the bytes read.
//  - bf16 k and v are exact TF32 values, so their small parts and the
//    products with them are skipped; q·scale is split in full.
//  - q/k/v are read through their strides, so the projection layout
//    (B, T, heads, D) is read in place; the output is written through its
//    own strides.
//  Shared memory at D = 64: 80 KiB a block in f32 (two blocks an SM),
//  72 KiB in bf16.  Registers (ptxas -v, sm_90a), with no spill in any
//  instantiation, at D = 32 / 64 / 128: f32 q/k/v 91 / 146 / 193-200, bf16
//  q/k/v 91 / 140 / 194-196.  chip_smoke.py prints the report on every run.
//
// C interface, loaded with ctypes (analytics_zoo_tpu_torch/ops/_build.py):
// launches on the given stream, allocates nothing, returns the CUDA error
// of the launch (0 = launched).  head_dim must be 32, 64 or 128; every row
// (the D elements of one position) must be 16-byte aligned for f32 and
// 8-byte aligned for bf16, with unit stride along D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows a block
constexpr int kBK = 32;            // keys a streamed tile
constexpr unsigned kFull = 0xffffffffu;

template <typename TI, int D>
__host__ __device__ constexpr int smem_bytes() {
  // q split (A layout), k and v split (row layout), raw staging: q's 64
  // rows or k's and v's 32 each
  return 4 * 2 * D * (kBQ + 2 * kBK) + kBQ * D * (int)sizeof(TI);
}

template <typename TI, typename TO, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                 const TI* __restrict__ v, TO* __restrict__ out,
                 float* __restrict__ lse, int H, int T,
                 long long sqb, long long sqh, long long sqt,
                 long long skb, long long skh, long long skt,
                 long long svb, long long svh, long long svt,
                 long long sob, long long soh, long long sot,
                 float scale, int causal) {
  constexpr int NJ = kBK / 8, NT = D / 8;
  constexpr bool XI = Elt<TI>::exact;
  extern __shared__ uint4 smem4[];
  uint32_t* Qs = reinterpret_cast<uint32_t*>(smem4);   // split, A layout
  uint32_t* Ks = Qs + kBQ * 2 * D;                     // split, row layout
  uint32_t* Vs = Ks + kBK * 2 * D;
  TI* raw = reinterpret_cast<TI*>(Vs + kBK * 2 * D);   // cp.async staging
  TI* rk = raw;
  TI* rv = raw + kBK * D;

  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;   // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * kBQ;
  const int r0 = 16 * (threadIdx.x >> 5);   // the warp's rows in the tile
  const Lane<D> L;
  const int afrag = (r0 >> 4) * (D / 8) * 256 + (threadIdx.x & 31) * 4;
  const TI* kp = k + b * skb + h * skh;
  const TI* vp = v + b * svb + h * svh;

  // q·scale stays for the whole loop: staged raw and split once
  load_raw<kThreads, TI, D, kBQ>(raw, q + b * sqb + h * sqh, sqt, q0, T);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  split_frags<kThreads, TI, D, kBQ, false>(Qs, raw, scale);   // q·scale is not exact
  __syncthreads();
  load_raw<kThreads, TI, D, kBK>(rk, kp, skt, 0, T);
  load_raw<kThreads, TI, D, kBK>(rv, vp, svt, 0, T);
  cp_commit();

  // rows g and g + 8 of the warp: running max (scaled logits), this lane's
  // share of the running sum, the output accumulator
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int n_kt = (T + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  const int q_g = q0 + r0 + L.g;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait_all();
    __syncthreads();   // tile kt has landed; the last tile's readers are done
    split_rows<kThreads, TI, D, kBK>(Ks, rk);
    split_rows<kThreads, TI, D, kBK>(Vs, rv);
    __syncthreads();
    if (kt + 1 < n_kt) {   // the next tile flies while this one is used
      load_raw<kThreads, TI, D, kBK>(rk, kp, skt, (kt + 1) * kBK, T);
      load_raw<kThreads, TI, D, kBK>(rv, vp, svt, (kt + 1) * kBK, T);
    }
    cp_commit();

    float s[NJ][4];
    product_over_d<D, NJ, false, XI, D / 16>(s, Qs + afrag, Ks + L.g * 2 * D,
                                             L);

    const int k0 = kt * kBK;
    if (!(k0 + kBK <= T && (!causal || k0 + kBK - 1 <= q0 + r0))) {
      const int k_t = k0 + 2 * L.t;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k_t + 8 * j + (e & 1);
          if (kpos >= T || (causal && kpos > q_g + 8 * (e >> 1)))
            s[j][e] = -INFINITY;
        }
    }

    // online softmax: a row's 32 keys lie in one lane quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float mb[2], alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      // a row with no valid key yet keeps (m, l, acc) = (-inf, 0, 0)
      mb[i] = (mx[i] == -INFINITY ? 0.f : mx[i]) * kLog2e;
      alpha[i] = exp2_approx(fmaf(m[i], kLog2e, -mb[i]));
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(fmaf(s[j][e], kLog2e, -mb[e >> 1]));
        ls[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], ls[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

#pragma unroll
    for (int j = 0; j < NJ; ++j) {   // acc += p·v
      uint32_t ab[4], as[4];
      frag_acc(s[j], ab, as);
      product_over_tokens<D, XI>(acc, ab, as, Vs + j * 16 * D, L);
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
  }
  store_rows<TO, D>(out + b * sob + h * soh, sot, q0 + r0, T, acc, inv);
  if (lse != nullptr && L.t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (q_g + 8 * i < T)
        lse[(long long)bh * T + q_g + 8 * i] = m[i] + logf(l[i]);
  }
}

template <typename TI, typename TO, int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int H, int T, const long long* st,
             float scale, int causal, cudaStream_t s) {
  auto kern = flash_fwd_kernel<TI, TO, D>;
  constexpr int smem = smem_bytes<TI, D>();
  // once per instantiation, on the first (uncaptured) call: later calls
  // may be captured into a CUDA graph
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((T + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, s>>>(
      (const TI*)q, (const TI*)k, (const TI*)v, (TO*)out, lse, H, T,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int T, int D, const long long* st,
           float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 32: return launch_d<TI, TO, 32>(q, k, v, out, lse, B, H, T, st, scale, causal, s);
    case 64: return launch_d<TI, TO, 64>(q, k, v, out, lse, B, H, T, st, scale, causal, s);
    case 128: return launch_d<TI, TO, 128>(q, k, v, out, lse, B, H, T, st, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes (0 for another head_dim).
extern "C" int flash_attention_fwd_smem(int in_bf16, int D) {
  using bf = __nv_bfloat16;
  switch (D) {
    case 32: return in_bf16 ? smem_bytes<bf, 32>() : smem_bytes<float, 32>();
    case 64: return in_bf16 ? smem_bytes<bf, 64>() : smem_bytes<float, 64>();
    case 128: return in_bf16 ? smem_bytes<bf, 128>() : smem_bytes<float, 128>();
    default: return 0;
  }
}

// in_bf16 / out_bf16: 0 = float32, 1 = bfloat16.  strides (12, in
// elements): q (b, h, t), k (b, h, t), v (b, h, t), out (b, h, t); the
// head_dim stride is 1 for all four.  lse may be null.
extern "C" int flash_attention_fwd(int in_bf16, int out_bf16, const void* q,
                                   const void* k, const void* v, void* out,
                                   float* lse, int B, int H, int T, int D,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  if (B < 1 || H < 1 || T < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16) {
    return out_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, lse, B, H, T, D, strides, scale, causal, s)
        : launch<__nv_bfloat16, float>(q, k, v, out, lse, B, H, T, D, strides, scale, causal, s);
  }
  return out_bf16
      ? launch<float, __nv_bfloat16>(q, k, v, out, lse, B, H, T, D, strides, scale, causal, s)
      : launch<float, float>(q, k, v, out, lse, B, H, T, D, strides, scale, causal, s);
}
