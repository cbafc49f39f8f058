// Flash attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py::_fwd_kernel, the
// Pallas TPU kernel that _flash_fwd hands to pl.pallas_call:
// out = softmax(q·kᵀ·scale)·v per (batch, head), with the online softmax
// over key tiles, an optional causal mask (key ≤ query), and optionally the
// per-row log-sum-exp m + log(l) (scaled-logits domain, stored (B, H, T)).
// q/k/v are f32 or bf16; all arithmetic is f32.  scale is applied to q in
// f32 before the dot, as the TPU kernel does.
//
// What bounds it on the card: operations.  At the predict path's shape
// (B·H = 96, T = 1024, D = 64, causal) it does 4·B·H·T²·D/2 ≈ 12.9 GFLOP
// on 0.1 GB of inputs; f32 has no tensor-core path that keeps f32
// accuracy (TF32 keeps ~3 digits), so the f32 FMA rate (67 TFLOP/s) is the
// roof, about 0.19 ms.  The design is the simple, correct first one:
//  - one thread block (256 threads, a 16 x 16 grid) per (b·h, 64-query
//    tile).  The TPU grid walks query tiles in order on one core; here the
//    tiles run in parallel, and the inner loop over key tiles replaces the
//    sequential fori_loop.  Query tiles near the diagonal do the most work
//    under the causal mask, so they are scheduled first.
//  - per key tile, K and V (64 x D) are staged in shared memory (16-byte
//    loads, rows padded by 4 floats so the float4 reads of 8 lanes hit 32
//    distinct banks).  Each thread computes a 4 x 4 block of scores
//    (rows ty + 16i, keys tx + 16j), keeps the running max / sum of its 4
//    rows in registers (reduced over the 16 lanes of a row with shuffles),
//    writes the probabilities to shared memory, and accumulates a 4 x D/16
//    block of the output.
//  - masks: keys at or past T (the ragged last tile; nothing is padded in
//    device memory — out-of-range rows are staged as zeros), and with
//    causal the keys past the query.  The causal loop stops at the
//    diagonal tile: the TPU kernel walks every key block and relies on
//    masked blocks adding exact zeros, so stopping changes only the bytes
//    read.
//  - q/k/v are read through their strides, so the projection layout
//    (B, T, heads, D) is read in place, with no transpose materialized; the
//    output is written through its own strides.
// bf16 or f32 tensor-core tiles (wgmma), cp.async/TMA double buffering and
// a persistent schedule are later work.
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

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 (tx: keys / head_dim) x 16 (ty: rows)
constexpr int kPadP = 16;        // P rows padded so odd/even ty use other banks
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as .to(bfloat16)
}

// Stage rows [t0, t0 + 64) of one (b, h) slice into smem (row pitch D + 4),
// times mul; rows at or past T become zeros.
template <typename TI, int D>
__device__ __forceinline__ void stage(float* dst, const TI* src, long long st,
                                      int t0, int T, float mul) {
  constexpr int V4 = D / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kBK * V4; i += kThreads) {
    const int r = i / V4;
    const int c = (i % V4) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T) f = load4(src + (long long)(t0 + r) * st + c);
    float* d = dst + r * (D + 4) + c;
    d[0] = f.x * mul; d[1] = f.y * mul; d[2] = f.z * mul; d[3] = f.w * mul;
  }
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
  constexpr int DJ = D / 16;     // output columns per thread
  constexpr int PITCH = D + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * PITCH;
  float* Vs = Ks + kBK * PITCH;
  float* Ps = Vs + kBK * PITCH;   // kBQ x (kBK + kPadP)

  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;   // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const TI* qp = q + b * sqb + h * sqh;
  const TI* kp = k + b * skb + h * skh;
  const TI* vp = v + b * svb + h * svh;

  stage<TI, D>(Qs, qp, sqt, q0, T, scale);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (T + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    stage<TI, D>(Ks, kp, skt, k0, T, 1.f);
    stage<TI, D>(Vs, vp, svt, k0, T, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * PITCH + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * PITCH + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // masks and the online softmax, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= T || (causal && kpos > qpos)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing valid so far keeps (m, l, acc) = (-inf, 0, 0)
      const bool none = m_new == -INFINITY;
      const float alpha = none ? 1.f : expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = none ? 0.f : expf(s[i][j] - m_new);
        ps += p;
        Ps[(ty + 16 * i) * (kBK + kPadP) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * (kBK + kPadP) + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[j] = Vs[(c + cc) * PITCH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                        : cc == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / ls;
    TO* op = out + b * sob + h * soh + (long long)t * sot;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store1(op + tx + 16 * j, acc[i][j] * inv);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * T + t] = m[i] + logf(ls);
  }
}

template <typename TI, typename TO, int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int H, int T, const long long* st,
             float scale, int causal, cudaStream_t s) {
  auto kern = flash_fwd_kernel<TI, TO, D>;
  const int smem = (int)sizeof(float) *
      ((kBQ + 2 * kBK) * (D + 4) + kBQ * (kBK + kPadP));
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
