// Fused 1x1 convolution + BatchNorm statistics for NVIDIA Hopper (sm_90a):
// y = x @ w together with the per-channel sums of y and y^2.
//
// Replaces tools/fused_bn_probe.py::_fused_kernel (make_pallas_fused), which
// computes y = x @ w with bf16 products and f32 sums and accumulates
// sum(y) and sum(y*y) over the rows of the f32 accumulator, before the cast
// to y's dtype, in its epilogue.  In a ResNet's training step those are the
// statistics of the BatchNormalization that follows every 1x1, stride-1,
// bias-free convolution (a 1x1 conv over NHWC is exactly this product over
// the (rows, channels) view), so the BN no longer reads y back.
//
// Function: x (M, K) with row stride ldx (a view of contiguous NHWC), w (K, N)
// contiguous, both f32 or both bf16 -> y (M, N) contiguous in the input
// dtype and stats (2, N) f32 = (sum over rows of acc, sum of acc^2), acc the
// f32 accumulator.  Products are in the input dtype with f32 sums: a bf16 x
// bf16 product is exact in f32, so converting the operands to f32 and using
// f32 FMAs gives the bf16 products exactly; with f32 inputs the products are
// f32.  The probe always feeds bf16 (its cast is then a no-op); on the
// training path the kernel stands in for an f32 convolution under the f32
// dtype policy, where the JAX package does not round to bf16, so f32 inputs
// keep f32 products.
//
// Across blocks: the TPU grid runs in order, so the probe can `+=` one
// stats block from step to step.  CUDA blocks run concurrently, so each
// (M-tile, N-tile) block writes its own column partials (2, BN) into
// part (tiles_m, 2, N), and a second small kernel sums the tiles of each
// column in a fixed order.  No atomics: two launches are bitwise equal.
// Rows past M are staged as zeros, so they add nothing to the sums, and are
// never written to y; ragged K and N are zero-filled the same way.
//
// What bounds it on the card: at the probe shape (401408, 256) @ (256, 64)
// the bf16 product is bytes-bound (205.5 MB of x read and 51.4 MB of y
// written, ~0.077 ms at 3.35 TB/s) and the f32 product operations-bound
// (13.15 GFLOP, ~0.196 ms at 67 TFLOP/s on the f32 SIMT pipes).  This first
// version is a plain SIMT tiled product: a 128 x 64 output tile per block of
// 256 threads, each thread 8 x 4 outputs in registers, K in steps of 16
// through shared memory, f32 FMAs.  So its bf16 case is held to the f32 FMA
// rate, not the tensor cores; bf16 / 3xTF32 wgmma tiles with TMA loads are
// later work.
//
// C interface, loaded with ctypes (analytics_zoo_tpu_torch/ops/_build.py):
// each entry point launches on the given stream, allocates nothing, and
// returns the CUDA error of the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;              // rows of x per block (TILE_M in ops/fused_bn.py)
constexpr int kTileN = 64;               // columns of y per block
constexpr int kTileK = 16;               // depth per shared-memory stage
constexpr int kRowsPerThread = 8;
constexpr int kColsPerThread = 4;
constexpr int kThreadRows = kTileM / kRowsPerThread;   // 16
constexpr int kThreadCols = kTileN / kColsPerThread;   // 16
constexpr int kThreads = kThreadRows * kThreadCols;    // 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);            // round to nearest even, as .astype
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_bn_kernel(const T* __restrict__ x, long long ldx,
                const T* __restrict__ w, T* __restrict__ y,
                float* __restrict__ part, int M, int N, int K) {
  // x tile k-major (each thread's 8 rows are contiguous: two float4 reads),
  // padded by 4 to keep 16-byte alignment and spread the transposing stores
  __shared__ __align__(16) float xs[kTileK][kTileM + 4];
  __shared__ __align__(16) float ws[kTileK][kTileN];
  __shared__ float red[2][kThreadRows][kTileN];

  const int tid = threadIdx.x;
  const int tc = tid % kThreadCols;      // column group: cols tc*4 .. +3
  const int tr = tid / kThreadCols;      // row group: rows tr*8 .. +7
  const long long m0 = (long long)blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kTileN;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    // stage x: consecutive threads read consecutive k of one row
    for (int i = tid; i < kTileM * kTileK; i += kThreads) {
      const int r = i / kTileK, c = i % kTileK;
      const long long gm = m0 + r;
      const int gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? to_f(x[gm * ldx + gk]) : 0.f;
    }
    // stage w: consecutive threads read consecutive columns
    for (int i = tid; i < kTileK * kTileN; i += kThreads) {
      const int r = i / kTileN, c = i % kTileN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? to_f(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][tr * kRowsPerThread]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][tr * kRowsPerThread + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tc * kColsPerThread]);
      const float a[kRowsPerThread] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kColsPerThread] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue 1: y in the input dtype, only rows < M and columns < N
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const long long gm = m0 + tr * kRowsPerThread + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int gn = n0 + tc * kColsPerThread + j;
      if (gn < N) y[gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
  // epilogue 2: this tile's column sums of acc and acc^2 (rows past M hold
  // exact zeros), reduced over the 16 row groups in a fixed order
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      s += acc[i][j];
      q = fmaf(acc[i][j], acc[i][j], q);
    }
    red[0][tr][tc * kColsPerThread + j] = s;
    red[1][tr][tc * kColsPerThread + j] = q;
  }
  __syncthreads();
  if (tid < 2 * kTileN) {
    const int which = tid / kTileN, c = tid % kTileN;
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) t += red[which][r][c];
    const int gn = n0 + c;
    if (gn < N) part[((size_t)blockIdx.x * 2 + which) * N + gn] = t;
  }
}

constexpr int kRedCols = 32;     // columns of (2, N) per reduce block
constexpr int kRedLanes = 32;    // tiles summed side by side per column

// stats[which][n] = sum over tiles t of part[t][which][n]: lane l sums tiles
// l, l + 32, ... in order, then lane 0 sums the 32 lanes in order.
__global__ void __launch_bounds__(kRedCols * kRedLanes)
fused_bn_reduce_kernel(const float* __restrict__ part,
                       float* __restrict__ stats, int tiles, int N) {
  __shared__ float sh[kRedLanes][kRedCols + 1];
  const int col = blockIdx.x * kRedCols + threadIdx.x;   // in [0, 2N)
  const int which = col / N, n = col % N;
  float t = 0.f;
  if (col < 2 * N) {
    for (int tile = threadIdx.y; tile < tiles; tile += kRedLanes)
      t += part[((size_t)tile * 2 + which) * N + n];
  }
  sh[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && col < 2 * N) {
    float s = 0.f;
    for (int l = 0; l < kRedLanes; ++l) s += sh[l][threadIdx.x];
    stats[col] = s;
  }
}

bool bad_dims(long long ldx, int M, int N, int K) {
  const long long tiles_n = (N + kTileN - 1) / kTileN;
  return M < 1 || N < 1 || K < 1 || ldx < K || tiles_n > 65535;
}

template <typename T>
int launch(const T* x, long long ldx, const T* w, T* y, float* part, int M,
           int N, int K, cudaStream_t stream) {
  if (bad_dims(ldx, M, N, K)) return (int)cudaErrorInvalidValue;
  dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN);
  fused_bn_kernel<T><<<grid, kThreads, 0, stream>>>(x, ldx, w, y, part, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_bn_tile_m() { return kTileM; }

// y (M, N) and part (ceil(M / 128), 2, N) from x (M, K; row stride ldx), w (K, N)
extern "C" int fused_bn_partials_f32(const float* x, long long ldx,
                                     const float* w, float* y, float* part,
                                     int M, int N, int K, cudaStream_t stream) {
  return launch<float>(x, ldx, w, y, part, M, N, K, stream);
}

extern "C" int fused_bn_partials_bf16(const __nv_bfloat16* x, long long ldx,
                                      const __nv_bfloat16* w, __nv_bfloat16* y,
                                      float* part, int M, int N, int K,
                                      cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, ldx, w, y, part, M, N, K, stream);
}

// stats (2, N) = the column sums of part (tiles, 2, N) over the tiles
extern "C" int fused_bn_reduce(const float* part, float* stats, int tiles,
                               int N, cudaStream_t stream) {
  if (tiles < 1 || N < 1) return (int)cudaErrorInvalidValue;
  dim3 block(kRedCols, kRedLanes);
  dim3 grid((2 * N + kRedCols - 1) / kRedCols);
  fused_bn_reduce_kernel<<<grid, block, 0, stream>>>(part, stats, tiles, N);
  return (int)cudaGetLastError();
}
