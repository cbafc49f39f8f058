// Fused-dequant quantized matmul for NVIDIA Hopper (sm_90a): the w8a8 and
// w4a16 kernels of the quantized predict path.
//
// Replaces analytics_zoo_tpu/ops/quant_matmul.py::_w8a8_kernel
// (w8a8_matmul_pallas) and ::_w4a16_kernel (w4a16_matmul_pallas):
//  - w8a8: (M, K) s8 x (K, N) s8 -> s32, times scale (N,) f32 -> (M, N)
//    f32.  The integer sum is exact and the output is one f32 multiply of
//    it, so the result is bitwise that of the plain version.
//  - w4a16: x (M, K) f32 or bf16 x split-nibble packed (ceil(K/2), N) u8
//    (byte row j holds weight row j in the low nibble and row
//    j + ceil(K/2) in the high nibble, value (b & 0xF ^ 8) - 8) with group
//    scales (G, N) f32, effective group size ceil(K/G) -> (M, N) f32, f32
//    accumulation of x * (q * s).  Every shape the quantizer emits: odd K,
//    a ragged last group.
//
// What bounds them on the card: device-memory bytes.  The predict head is
// 768 x 50257 at a batch of 8: the weight (38.6 MB int8, 19.3 MB packed
// int4 + 2.4 MB scales) is read once while each weight byte feeds only
// 2·M operations.  The design keeps the weight read once and coalesced:
//  - one thread per output column n, 128 columns a block, BM rows a block
//    (8, or 32 when M > 8).  A warp reads 32 consecutive bytes of a weight
//    row per load — whole 32-byte sectors, with no alignment demands on N,
//    which is odd at the head's width — and each thread issues the loads of
//    a whole K chunk before it uses any, to keep bytes in flight.
//  - the activations of the block's BM rows are staged per K chunk in
//    shared memory and read as broadcasts.
//  - w8a8 packs 4 consecutive K bytes of its column into one register and
//    accumulates with __dp4a (s8 x s8 -> s32); ragged K is zero-padded in
//    registers, so the sum stays exact.
//  - w4a16 dequantizes each nibble in registers with the scale of its
//    group, reloaded only when the group changes, so the weight is read at
//    half a byte an element.
// Tensor-core tiles (mma.sync s8 / wgmma) for large M are later work.
//
// C interface, loaded with ctypes (analytics_zoo_tpu_torch/ops/_build.py):
// each entry point launches on the given stream, allocates nothing, and
// returns the CUDA error of the launch (0 = launched).  All operands are
// contiguous row-major.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // output columns per block
constexpr int kKC8 = 64;         // w8a8: K bytes per chunk
constexpr int kKC4 = 32;         // w4a16: packed byte rows per chunk

template <int BM>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ out,
            int M, int N, int K) {
  __shared__ int xs[BM][kKC8 / 4];   // x chunk, 4 bytes of K per int
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int m0 = blockIdx.y * BM;
  int acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0;

  for (int k0 = 0; k0 < K; k0 += kKC8) {
    const int kend = min(kKC8, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * (kKC8 / 4); i += kThreads) {
      const int r = i / (kKC8 / 4);
      const int c = (i % (kKC8 / 4)) * 4;
      unsigned packed = 0;
      if (m0 + r < M) {
        const int8_t* xr = x + (size_t)(m0 + r) * K + k0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < kend) packed |= (unsigned)(uint8_t)xr[c + e] << (8 * e);
      }
      xs[r][c / 4] = (int)packed;
    }
    __syncthreads();
    if (n >= N) continue;
    const int8_t* wc = w + (size_t)k0 * N + n;
    int wq[kKC8 / 4];
    if (kend == kKC8) {
      uint8_t bytes[kKC8];
#pragma unroll
      for (int j = 0; j < kKC8; ++j) bytes[j] = (uint8_t)wc[(size_t)j * N];
#pragma unroll
      for (int c = 0; c < kKC8 / 4; ++c)
        wq[c] = (int)((unsigned)bytes[4 * c] | (unsigned)bytes[4 * c + 1] << 8
                      | (unsigned)bytes[4 * c + 2] << 16
                      | (unsigned)bytes[4 * c + 3] << 24);
    } else {
#pragma unroll
      for (int c = 0; c < kKC8 / 4; ++c) {
        unsigned packed = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * c + e < kend)
            packed |= (unsigned)(uint8_t)wc[(size_t)(4 * c + e) * N] << (8 * e);
        wq[c] = (int)packed;
      }
    }
#pragma unroll
    for (int c = 0; c < kKC8 / 4; ++c)
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = __dp4a(xs[r][c], wq[c], acc[r]);
  }
  if (n >= N) return;
  const float s = scale[n];
#pragma unroll
  for (int r = 0; r < BM; ++r)
    if (m0 + r < M) out[(size_t)(m0 + r) * N + n] = (float)acc[r] * s;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TX, int BM>
__global__ void __launch_bounds__(kThreads)
w4a16_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ wq,
             const float* __restrict__ sg, float* __restrict__ out,
             int M, int N, int K, int G) {
  // x columns of the chunk's low-nibble rows and of its high-nibble rows
  __shared__ float xlo[BM][kKC4];
  __shared__ float xhi[BM][kKC4];
  const int kh = (K + 1) / 2;
  const int gs = (K + G - 1) / G;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int m0 = blockIdx.y * BM;
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;
  // current group of the low and high rows: [start, end) and its scale
  int lo_end = 0, hi_end = 0;
  float s_lo = 0.f, s_hi = 0.f;

  for (int kb0 = 0; kb0 < kh; kb0 += kKC4) {
    const int jend = min(kKC4, kh - kb0);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kKC4; i += kThreads) {
      const int r = i / kKC4;
      const int j = i % kKC4;
      const int m = m0 + r;
      const int klo = kb0 + j;
      const int khi = kh + kb0 + j;
      float a = 0.f, b = 0.f;
      if (m < M && j < jend) {
        a = to_f(x[(size_t)m * K + klo]);
        if (khi < K) b = to_f(x[(size_t)m * K + khi]);
      }
      xlo[r][j] = a;
      xhi[r][j] = b;
    }
    __syncthreads();
    if (n >= N) continue;
    const uint8_t* wc = wq + (size_t)kb0 * N + n;
    uint8_t bytes[kKC4];
#pragma unroll
    for (int j = 0; j < kKC4; ++j) bytes[j] = j < jend ? wc[(size_t)j * N] : 0;
#pragma unroll
    for (int j = 0; j < kKC4; ++j) {
      if (j >= jend) break;
      const int klo = kb0 + j;
      const int khi = kh + kb0 + j;
      if (klo >= lo_end) {           // uniform across the block
        const int g = klo / gs;
        lo_end = (g + 1) * gs;
        s_lo = sg[(size_t)g * N + n];
      }
      const float w_lo = (float)(((bytes[j] & 0xF) ^ 8) - 8) * s_lo;
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = fmaf(xlo[r][j], w_lo, acc[r]);
      if (khi < K) {
        if (khi >= hi_end) {
          const int g = khi / gs;
          hi_end = (g + 1) * gs;
          s_hi = sg[(size_t)g * N + n];
        }
        const float w_hi = (float)(((bytes[j] >> 4) ^ 8) - 8) * s_hi;
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] = fmaf(xhi[r][j], w_hi, acc[r]);
      }
    }
  }
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < BM; ++r)
    if (m0 + r < M) out[(size_t)(m0 + r) * N + n] = acc[r];
}

bool bad_dims(int M, int N, int K) {
  return M < 1 || N < 1 || K < 1 || (M + 31) / 32 > 65535;
}

}  // namespace

extern "C" int w8a8_matmul(const int8_t* x, const int8_t* w,
                           const float* scale, float* out, int M, int N,
                           int K, void* stream) {
  if (bad_dims(M, N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int gx = (N + kThreads - 1) / kThreads;
  if (M <= 8) {
    w8a8_kernel<8><<<dim3(gx, 1), kThreads, 0, s>>>(x, w, scale, out, M, N, K);
  } else {
    w8a8_kernel<32><<<dim3(gx, (M + 31) / 32), kThreads, 0, s>>>(
        x, w, scale, out, M, N, K);
  }
  return (int)cudaGetLastError();
}

template <typename TX>
static int launch_w4(const TX* x, const uint8_t* wq, const float* sg,
                     float* out, int M, int N, int K, int G, void* stream) {
  if (bad_dims(M, N, K) || G < 1 || G > K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int gx = (N + kThreads - 1) / kThreads;
  if (M <= 8) {
    w4a16_kernel<TX, 8><<<dim3(gx, 1), kThreads, 0, s>>>(
        x, wq, sg, out, M, N, K, G);
  } else {
    w4a16_kernel<TX, 32><<<dim3(gx, (M + 31) / 32), kThreads, 0, s>>>(
        x, wq, sg, out, M, N, K, G);
  }
  return (int)cudaGetLastError();
}

extern "C" int w4a16_matmul_f32(const float* x, const uint8_t* wq,
                                const float* sg, float* out, int M, int N,
                                int K, int G, void* stream) {
  return launch_w4<float>(x, wq, sg, out, M, N, K, G, stream);
}

extern "C" int w4a16_matmul_bf16(const __nv_bfloat16* x, const uint8_t* wq,
                                 const float* sg, float* out, int M, int N,
                                 int K, int G, void* stream) {
  return launch_w4<__nv_bfloat16>(x, wq, sg, out, M, N, K, G, stream);
}
