// Flash attention backward for NVIDIA Hopper (sm_90a): two kernels.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel, the Pallas TPU kernels that _flash_bwd hands to
// pl.pallas_call.  With s = q·kᵀ·scale, p = exp(s − lse) (the forward's
// per-row log-sum-exp, so p is the softmax recomputed without a second
// reduction), the causal mask key ≤ query, and the per-row
// δ = rowsum(dO·O) − g_lse computed by the caller:
//   ds = p·(dO·vᵀ − δ)
//   dq = ds·k·scale              (flash_bwd_dq_kernel)
//   dk = dsᵀ·q·scale, dv = pᵀ·dO  (flash_bwd_dkv_kernel)
// q/k/v/dO are f32 or bf16; all arithmetic is f32; dq/dk/dv are written
// in the input dtype.
//
// What bounds it on the card: operations.  At the training path's shape
// (B·H = 96, T = 1024, D = 64, causal) the function needs 10·D flop per
// kept (query, key) pair (recompute s, then dp, dv, dk, dq), 32.2 GFLOP,
// against ~0.2 GB of q, k, v, O, dO, dq, dk and dv: at the f32 FMA rate
// (67 TFLOP/s; f32 has no tensor-core path that keeps f32 accuracy) about
// 0.48 ms.  This design recomputes s and dp in both kernels (14·D flop a
// pair), so it can reach at most ~71% of that bound.  It is the simple,
// correct first design:
//  - two kernels, as the TPU package has, so every gradient element is
//    written by exactly one thread block: no atomics, and two backward
//    calls give bitwise-equal gradients.  The TPU grid walks tiles in
//    order on one core; here tiles run in parallel, and the loop inside a
//    block replaces the sequential fori_loop.
//  - dq: one block (256 threads, a 16 x 16 grid) per (b·h, 64-query
//    tile).  The q tile (pre-scaled), the dO tile, lse and δ stay in
//    shared memory / registers; 64-key K and V tiles are staged in shared
//    memory; each thread computes a 4 x 4 block of s and dp, writes ds to
//    shared memory, and accumulates a 4 x D/16 block of dq in registers.
//    Under the causal mask the loop stops at the diagonal key tile.
//  - dk/dv: one block per (b·h, key tile).  The key tile is 64 keys at
//    head_dim 32 and 64, and 32 keys at head_dim 128, so that the two f32
//    accumulators (keys x D each) stay at 32 registers a thread instead
//    of 64.  The loop over 64-query tiles starts at the diagonal tile when
//    causal.  Query rows at or past T are masked here (their q, dO, lse
//    and δ are staged as zeros and their p is forced to 0): the TPU kernel
//    relies on padded rows of dO and δ being 0 in HBM, and this kernel
//    makes no padded copies.
//  - keys at or past T are masked in dq, and their dk/dv rows are never
//    written.  Tiles are staged with 16-byte (f32) / 8-byte (bf16) loads
//    into rows padded by 4 floats so the float4 reads of 8 lanes hit 32
//    distinct banks.
//  - every tensor is read through its (b, h, t) strides: q/k/v are views
//    of the fused qkv projection and dO arrives from autograd as a strided
//    view; dq/dk/dv are written through theirs, in (B, T, H, D) memory.
// bf16 or f32 tensor-core tiles (wgmma), cp.async/TMA double buffering and
// one fused kernel with a second reduction pass are later work.
//
// C interface, loaded with ctypes (analytics_zoo_tpu_torch/ops/_build.py):
// each entry launches on the given stream, allocates nothing and returns
// the CUDA error of the launch (0 = launched).  head_dim must be 32, 64 or
// 128; every row (the D elements of one position) must be 16-byte aligned
// for f32 and 8-byte aligned for bf16, with unit stride along D; lse and
// δ are contiguous (B, H, T) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kThreads = 256;    // 16 (tx) x 16 (ty)
constexpr int kPadP = 16;        // P / dS rows padded so odd/even ty use other banks

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

// Stage rows [t0, t0 + ROWS) of one (b, h) slice into smem (row pitch
// D + 4), times mul; rows at or past T become zeros.
template <typename TI, int D, int ROWS>
__device__ __forceinline__ void stage(float* dst, const TI* src, long long st,
                                      int t0, int T, float mul) {
  constexpr int V4 = D / 4;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * V4; i += kThreads) {
    const int r = i / V4;
    const int c = (i % V4) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T) f = load4(src + (long long)(t0 + r) * st + c);
    float* d = dst + r * (D + 4) + c;
    d[0] = f.x * mul; d[1] = f.y * mul; d[2] = f.z * mul; d[3] = f.w * mul;
  }
}

// acc[i][j] += Σ_d A[ra + 16i][d] · B[rb + 16j][d] for I rows of A and 4 of
// B (both row-major in smem with pitch D + 4): one 4-wide block of a tile
// product over the head dimension.
template <int D, int I>
__device__ __forceinline__ void dot_rows(float (&acc)[I][4], const float* A,
                                         int ra, const float* B, int rb) {
  constexpr int PITCH = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[I], b[4];
#pragma unroll
    for (int i = 0; i < I; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * PITCH + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * PITCH + d);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

template <typename TI, typename TG, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                    const TI* __restrict__ v, const TG* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, TI* __restrict__ dq,
                    int H, int T,
                    long long sqb, long long sqh, long long sqt,
                    long long skb, long long skh, long long skt,
                    long long svb, long long svh, long long svt,
                    long long sgb, long long sgh, long long sgt,
                    long long sdb, long long sdh, long long sdt,
                    float scale, int causal) {
  constexpr int BK = 64;          // keys per tile
  constexpr int DJ = D / 16;      // dq columns per thread
  constexpr int PITCH = D + 4;
  constexpr int PP = BK + kPadP;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // kBQ x PITCH, q·scale
  float* Gs = Qs + kBQ * PITCH;                  // kBQ x PITCH, dO
  float* Ks = Gs + kBQ * PITCH;                  // BK x PITCH
  float* Vs = Ks + BK * PITCH;                   // BK x PITCH
  float* Ss = Vs + BK * PITCH;                   // kBQ x PP, ds

  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;   // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const TI* kp = k + b * skb + h * skh;
  const TI* vp = v + b * svb + h * svh;
  stage<TI, D, kBQ>(Qs, q + b * sqb + h * sqh, sqt, q0, T, scale);
  stage<TG, D, kBQ>(Gs, dout + b * sgb + h * sgh, sgt, q0, T, 1.f);

  float lr[4], dr[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    lr[i] = t < T ? lse[(long long)bh * T + t] : 0.f;
    dr[i] = t < T ? delta[(long long)bh * T + t] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (T + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done
    stage<TI, D, BK>(Ks, kp, skt, k0, T, 1.f);
    stage<TI, D, BK>(Vs, vp, svt, k0, T, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<D, 4>(s, Qs, ty, Ks, tx);    // (q·scale)·kᵀ
    dot_rows<D, 4>(dp, Gs, ty, Vs, tx);   // dO·vᵀ

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = qpos < T && kpos < T && (!causal || kpos <= qpos);
        const float p = keep ? expf(s[i][j] - lr[i]) : 0.f;
        Ss[(ty + 16 * i) * PP + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();

    // dq += ds·k
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sa[i] = *reinterpret_cast<const float4*>(Ss + (ty + 16 * i) * PP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float kk[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) kk[j] = Ks[(c + cc) * PITCH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ds = cc == 0 ? sa[i].x : cc == 1 ? sa[i].y
                         : cc == 2 ? sa[i].z : sa[i].w;
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds, kk[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T) continue;
    TI* op = dq + b * sdb + h * sdh + (long long)t * sdt;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store1(op + tx + 16 * j, acc[i][j] * scale);
  }
}

template <typename TI, typename TG, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                     const TI* __restrict__ v, const TG* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, TI* __restrict__ dk,
                     TI* __restrict__ dv, int H, int T,
                     long long sqb, long long sqh, long long sqt,
                     long long skb, long long skh, long long skt,
                     long long svb, long long svh, long long svt,
                     long long sgb, long long sgh, long long sgt,
                     long long skob, long long skoh, long long skot,
                     long long svob, long long svoh, long long svot,
                     float scale, int causal) {
  constexpr int RI = BK / 16;     // key rows per thread
  constexpr int DJ = D / 16;      // dk/dv columns per thread
  constexpr int PITCH = D + 4;
  constexpr int PP = kBQ + kPadP;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // BK x PITCH, k·scale
  float* Vs = Ks + BK * PITCH;                   // BK x PITCH
  float* Qs = Vs + BK * PITCH;                   // kBQ x PITCH
  float* Gs = Qs + kBQ * PITCH;                  // kBQ x PITCH, dO
  float* Ps = Gs + kBQ * PITCH;                  // BK x PP, p (keys x queries)
  float* Ds = Ps + BK * PP;                      // BK x PP, ds
  float* Ls = Ds + BK * PP;                      // kBQ, lse
  float* Dl = Ls + kBQ;                          // kBQ, δ

  const int kt = blockIdx.x;     // low key tiles carry the most causal work
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = kt * BK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const TI* qp = q + b * sqb + h * sqh;
  const TG* gp = dout + b * sgb + h * sgh;
  stage<TI, D, BK>(Ks, k + b * skb + h * skh, skt, k0, T, scale);
  stage<TI, D, BK>(Vs, v + b * svb + h * svh, svt, k0, T, 1.f);

  float ak[RI][DJ], av[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) ak[i][j] = av[i][j] = 0.f;

  const int n_qt = (T + kBQ - 1) / kBQ;
  for (int qt = causal ? k0 / kBQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();   // the previous tile's readers are done
    stage<TI, D, kBQ>(Qs, qp, sqt, q0, T, 1.f);
    stage<TG, D, kBQ>(Gs, gp, sgt, q0, T, 1.f);
    if (threadIdx.x < kBQ) {
      const int t = q0 + threadIdx.x;
      Ls[threadIdx.x] = t < T ? lse[(long long)bh * T + t] : 0.f;
      Dl[threadIdx.x] = t < T ? delta[(long long)bh * T + t] : 0.f;
    }
    __syncthreads();

    // scores transposed: rows are this block's keys, columns the queries
    float s[RI][4], dp[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<D, RI>(s, Ks, ty, Qs, tx);    // (k·scale)·qᵀ
    dot_rows<D, RI>(dp, Vs, ty, Gs, tx);   // v·dOᵀ

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qpos = q0 + c;
        const bool keep = qpos < T && (!causal || kpos <= qpos);
        const float p = keep ? expf(s[i][j] - Ls[c]) : 0.f;
        Ps[(ty + 16 * i) * PP + c] = p;
        Ds[(ty + 16 * i) * PP + c] = p * (dp[i][j] - Dl[c]);
      }
    }
    __syncthreads();

    // dv += pᵀ·dO, dk += dsᵀ·q
#pragma unroll 2
    for (int c = 0; c < kBQ; c += 4) {
      float4 pa[RI], da[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PP + c);
        da[i] = *reinterpret_cast<const float4*>(Ds + (ty + 16 * i) * PP + c);
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float gg[DJ], qq[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gg[j] = Gs[(c + cc) * PITCH + tx + 16 * j];
          qq[j] = Qs[(c + cc) * PITCH + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                        : cc == 2 ? pa[i].z : pa[i].w;
          const float ds = cc == 0 ? da[i].x : cc == 1 ? da[i].y
                         : cc == 2 ? da[i].z : da[i].w;
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            av[i][j] = fmaf(p, gg[j], av[i][j]);
            ak[i][j] = fmaf(ds, qq[j], ak[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= T) continue;
    TI* kop = dk + b * skob + h * skoh + (long long)t * skot;
    TI* vop = dv + b * svob + h * svoh + (long long)t * svot;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store1(kop + tx + 16 * j, ak[i][j] * scale);
      store1(vop + tx + 16 * j, av[i][j]);
    }
  }
}

// once per instantiation, on the first (uncaptured) call: later calls may
// be captured into a CUDA graph
template <typename K>
int allow_smem(K kern, int smem, bool& configured) {
  if (configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  configured = true;
  return 0;
}

template <typename TI, typename TG, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const float* lse, const float* delta, void* dq, int B, int H,
              int T, const long long* st, float scale, int causal,
              cudaStream_t s) {
  constexpr int BK = 64;
  auto kern = flash_bwd_dq_kernel<TI, TG, D>;
  const int smem = (int)sizeof(float) *
      (2 * (kBQ + BK) * (D + 4) + kBQ * (BK + kPadP));
  static bool configured = false;
  if (const int e = allow_smem(kern, smem, configured)) return e;
  const dim3 grid((T + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, s>>>(
      (const TI*)q, (const TI*)k, (const TI*)v, (const TG*)g, lse, delta,
      (TI*)dq, H, T, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14], scale, causal);
  return (int)cudaGetLastError();
}

template <typename TI, typename TG, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int T, const long long* st, float scale,
               int causal, cudaStream_t s) {
  constexpr int BK = D == 128 ? 32 : 64;
  auto kern = flash_bwd_dkv_kernel<TI, TG, D, BK>;
  const int smem = (int)sizeof(float) *
      (2 * (BK + kBQ) * (D + 4) + 2 * BK * (kBQ + kPadP) + 2 * kBQ);
  static bool configured = false;
  if (const int e = allow_smem(kern, smem, configured)) return e;
  const dim3 grid((T + BK - 1) / BK, B * H);
  kern<<<grid, kThreads, smem, s>>>(
      (const TI*)q, (const TI*)k, (const TI*)v, (const TG*)g, lse, delta,
      (TI*)dk, (TI*)dv, H, T, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
      st[15], st[16], st[17], scale, causal);
  return (int)cudaGetLastError();
}

template <typename TI, typename TG>
int dq_d(int D, const void* q, const void* k, const void* v, const void* g,
         const float* lse, const float* delta, void* dq, int B, int H, int T,
         const long long* st, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 32: return launch_dq<TI, TG, 32>(q, k, v, g, lse, delta, dq, B, H, T, st, scale, causal, s);
    case 64: return launch_dq<TI, TG, 64>(q, k, v, g, lse, delta, dq, B, H, T, st, scale, causal, s);
    case 128: return launch_dq<TI, TG, 128>(q, k, v, g, lse, delta, dq, B, H, T, st, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TI, typename TG>
int dkv_d(int D, const void* q, const void* k, const void* v, const void* g,
          const float* lse, const float* delta, void* dk, void* dv, int B,
          int H, int T, const long long* st, float scale, int causal,
          cudaStream_t s) {
  switch (D) {
    case 32: return launch_dkv<TI, TG, 32>(q, k, v, g, lse, delta, dk, dv, B, H, T, st, scale, causal, s);
    case 64: return launch_dkv<TI, TG, 64>(q, k, v, g, lse, delta, dk, dv, B, H, T, st, scale, causal, s);
    case 128: return launch_dkv<TI, TG, 128>(q, k, v, g, lse, delta, dk, dv, B, H, T, st, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int H, int T) {
  return B < 1 || H < 1 || T < 1 || B * H > 65535;
}

}  // namespace

// in_bf16: q/k/v (and dq/dk/dv) are bfloat16, else float32; g_bf16: dO is
// bfloat16, else float32 (bf16 dO needs bf16 inputs).  strides (15, in
// elements): q, k, v, dO, dq, each (b, h, t); the head_dim stride is 1.
extern "C" int flash_attention_bwd_dq(int in_bf16, int g_bf16, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const float* lse,
                                      const float* delta, void* dq, int B,
                                      int H, int T, int D,
                                      const long long* strides, float scale,
                                      int causal, void* stream) {
  if (bad_shape(B, H, T) || (g_bf16 && !in_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!in_bf16)
    return dq_d<float, float>(D, q, k, v, dout, lse, delta, dq, B, H, T, strides, scale, causal, s);
  return g_bf16
      ? dq_d<__nv_bfloat16, __nv_bfloat16>(D, q, k, v, dout, lse, delta, dq, B, H, T, strides, scale, causal, s)
      : dq_d<__nv_bfloat16, float>(D, q, k, v, dout, lse, delta, dq, B, H, T, strides, scale, causal, s);
}

// strides (18, in elements): q, k, v, dO, dk, dv, each (b, h, t).
extern "C" int flash_attention_bwd_dkv(int in_bf16, int g_bf16, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, void* dk, void* dv,
                                       int B, int H, int T, int D,
                                       const long long* strides, float scale,
                                       int causal, void* stream) {
  if (bad_shape(B, H, T) || (g_bf16 && !in_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!in_bf16)
    return dkv_d<float, float>(D, q, k, v, dout, lse, delta, dk, dv, B, H, T, strides, scale, causal, s);
  return g_bf16
      ? dkv_d<__nv_bfloat16, __nv_bfloat16>(D, q, k, v, dout, lse, delta, dk, dv, B, H, T, strides, scale, causal, s)
      : dkv_d<__nv_bfloat16, float>(D, q, k, v, dout, lse, delta, dk, dv, B, H, T, strides, scale, causal, s);
}
