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
// f32 accumulator.  Products keep the input dtype's accuracy with f32 sums:
// bf16 x bf16 products are exact in f32; f32 products are 3xTF32 (see
// mma_tf32.cuh), as accurate as f32 FMAs.  The probe always feeds bf16; on
// the training path the kernel stands in for an f32 convolution under the
// f32 dtype policy, where the JAX package does not round to bf16.
//
// What bounds it on the card (chip_smoke.fused_bn_bound, 3.35 TB/s, 3xTF32
// at 165 TFLOP/s, bf16 at 989): ResNet-50's 12 path shapes at batch 128.  In
// f32 the 56x56 stage (M = 401408, K and N of 64-256: ~2 flop a byte) is
// bound by bytes, the 28x28, 14x14 and 7x7 stages (K·N >= 65536 at smaller
// M) by operations; in bf16 every stage but the deepest is bound by bytes.
// The design:
//  - products on the tensor cores: f32 as 3xTF32 mma.sync.m16n8k8 (the
//    correction products, then big·big), bf16 as mma.sync.m16n8k16 with f32
//    accumulation.  The tensor core truncates each mma's sum to 24 bits, so
//    a chain of k-steps fed back as C drifts towards zero (K = 2048 is 256
//    f32 or 128 bf16 k-steps; Σy² would drift past the 1e-5 tolerance in
//    f32): each k-tile (4 k-steps: 12 f32 mmas, 4 bf16) sums into a zeroed
//    partial, which one f32 add puts into the accumulator.  The CPU test
//    tests/test_torch_port_fused_bn_tf32.py emulates this arithmetic: at
//    K = 2048 a partial a k-tile keeps Σy² within ~5e-7 in f32, one chain
//    over K misses by ~3e-5.
//  - f32: a block is 128 rows of x by 64 columns of w, four warps of 32 x
//    64, two blocks an SM.  Each row of x belongs to one warp, which splits
//    its elements once, in registers, as it loads their A fragments from
//    the raw tile (padded rows: the 8-byte reads of a half warp hit every
//    bank once); w, which all four warps read, is split once into the
//    B-fragment layout in shared memory (one 16-byte load a lane and
//    n-tile).  A split x tile in shared memory (the A layout of
//    mma_tf32.cuh) would triple the x tile's shared-memory traffic and
//    leave room for one block an SM.
//  - bf16: a block is 128 rows by 64 (N <= 64) or 128 columns, eight warps
//    as 4 (32 rows each) x 2; no split, the tiles are XOR-swizzled (16-byte
//    chunk c of row r at c ^ (r & 7)) and fragments come from ldmatrix
//    (.trans for w).  For N <= 128 each row of x is read once.
//  - blocks walk the column tiles of a row tile next to each other, so a
//    wider N re-reads x from L2.
//  - K streams through a ring of cp.async stages (3 in f32, 4 in bf16) of
//    16-byte copies, rows past M and columns past K or N zero-filled by
//    src-size.  A base or row stride that is not 16-byte aligned takes 8-
//    or 4-byte copies, and a bf16 stride that is not 4-byte aligned plain
//    2-byte loads: a path of this kernel, not a route to the plain version.
//  - epilogue: y goes through shared memory to coalesced 16-byte stores
//    (narrower when N·size is not a multiple of 16); Σacc and Σacc² of each
//    column are reduced in a fixed order, in registers, then over a warp's
//    row lanes with shuffles, then over the 4 row warps in shared memory,
//    into part (tiles_m, 2, N); fused_bn_reduce then sums the row tiles of
//    each column in a fixed order.  No atomics: two launches are bitwise
//    equal.  Rows past M are zero in the accumulator and never written.
//  Registers (ptxas -v, sm_90a) and dynamic shared memory a block
//  (fused_bn_smem): every instantiation is at the 255-register cap and
//  spills, so the f32 design's two blocks an SM already cost local-memory
//  traffic:
//    f32, 128 x 64 tile:       255 registers, 24 B spill stores / loads,
//                              103936 B (two blocks an SM);
//    bf16, 128 x 64 tile:      255 registers, 12 B spill stores / loads,
//                              98304 B;
//    bf16, 128 x 128 tile:     255 registers, 24 B spill stores / loads,
//                              131072 B;
//    fused_bn_reduce_kernel:   32 registers, no shared memory.
//  chip_smoke.py prints both reports on every run.
//
// C interface, loaded with ctypes (analytics_zoo_tpu_torch/ops/_build.py):
// each entry point launches on the given stream, allocates nothing, and
// returns the CUDA error of the launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kTileM = 128;              // rows of x per block (TILE_M in ops/fused_bn.py)
constexpr int kWarpRows = 4;             // warps along the rows, 32 rows each

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int WARPS_N = 1;      // warps along the columns
  static constexpr int MIN_BLOCKS = 2;   // blocks an SM (registers, smem)
  static constexpr int STAGES = 3;       // cp.async ring over K
  static constexpr int BK = 32;          // depth of a k-tile
  static constexpr int KSTEP = 8;        // depth of an mma
  static constexpr int XPAD = 8;         // raw x row pitch BK + XPAD elements
  static constexpr int WPAD = 4;         // raw w row pitch BN + WPAD elements
  static constexpr int YPAD = 8;         // y staging row pitch BN + YPAD
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int WARPS_N = 2;
  static constexpr int MIN_BLOCKS = 1;
  static constexpr int STAGES = 4;
  static constexpr int BK = 64;
  static constexpr int KSTEP = 16;
  static constexpr int XPAD = 0;         // swizzled instead
  static constexpr int WPAD = 0;
  static constexpr int YPAD = 8;
};

template <typename T, int BN>
struct Smem {
  using C = Cfg<T>;
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int THREADS = 32 * kWarpRows * C::WARPS_N;
  static constexpr int XP = C::BK + C::XPAD;
  static constexpr int WP = BN + C::WPAD;
  static constexpr int X_RAW = kTileM * XP * (int)sizeof(T);
  static constexpr int W_RAW = C::BK * WP * (int)sizeof(T);
  static constexpr int STAGE = X_RAW + W_RAW;
  static constexpr int RING = C::STAGES * STAGE;
  // f32 only: the split w k-tile, (big, small) words
  static constexpr int W_SPLIT = F32 ? C::BK * BN * 8 : 0;
  // epilogue, over the ring: y staging and the row warps' column sums
  static constexpr int YP = BN + C::YPAD;
  static constexpr int Y_STAGE = kTileM * YP * (int)sizeof(T);
  static constexpr int RED = kWarpRows * 2 * BN * 4;
  static constexpr int MAIN = RING + W_SPLIT;
  static constexpr int EPI = Y_STAGE + RED;
  static constexpr int BYTES = MAIN > EPI ? MAIN : EPI;
};

// byte offset of byte cb of row r in a tile of row_bytes-byte rows, the
// 16-byte chunks XOR-swizzled when SWZ
template <bool SWZ>
__device__ __forceinline__ int tile_off(int r, int cb, int row_bytes) {
  if constexpr (SWZ)
    return r * row_bytes + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15));
  else
    return r * row_bytes + cb;
}

// Copy a ROWS x COLS tile (src: its element (0, 0), row stride ld) into
// shared memory (row pitch PITCH elements), element (r, c) valid when
// r < rows and c < cols and zero otherwise.  W: bytes a copy, 16, 8 or 4
// (cp.async; a chunk that crosses cols copies its valid bytes and
// zero-fills the rest) or 2 (plain loads and stores, bf16 only).
template <int THREADS, typename T, int ROWS, int COLS, int PITCH, bool SWZ, int W>
__device__ __forceinline__ void copy_tile_w(T* dst, const T* src, long long ld,
                                            int rows, int cols) {
  constexpr int E = W / (int)sizeof(T);        // elements a copy
  constexpr int PER_ROW = COLS / E;
  constexpr int TURN = THREADS / PER_ROW;      // rows a turn of the block copies
  static_assert(THREADS % PER_ROW == 0 && ROWS % TURN == 0, "tile vs block");
  // a thread copies the same column chunk of rows r0, r0 + TURN, ...
  const int r0 = threadIdx.x / PER_ROW, c = (threadIdx.x % PER_ROW) * E;
  int nc = cols - c;
  nc = nc < 0 ? 0 : nc > E ? E : nc;           // its valid elements
  const T* s0 = src + r0 * ld + c;
  char* d0 = reinterpret_cast<char*>(dst);
#pragma unroll
  for (int q = 0; q < ROWS / TURN; ++q) {
    const int r = r0 + q * TURN;
    const int n = r < rows ? nc : 0;
    const T* s = n ? s0 + q * TURN * ld : src;
    char* d = d0 + tile_off<SWZ>(r, c * (int)sizeof(T), PITCH * (int)sizeof(T));
    if constexpr (W >= 4) {
      cp_async_n<W>(d, s, n * (int)sizeof(T));
    } else {
      *reinterpret_cast<T*>(d) = n ? *s : static_cast<T>(0.f);
    }
  }
}

template <int THREADS, typename T, int ROWS, int COLS, int PITCH, bool SWZ>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long ld,
                                          int rows, int cols, int width) {
  switch (width) {
    case 16: copy_tile_w<THREADS, T, ROWS, COLS, PITCH, SWZ, 16>(dst, src, ld, rows, cols); break;
    case 8: copy_tile_w<THREADS, T, ROWS, COLS, PITCH, SWZ, 8>(dst, src, ld, rows, cols); break;
    case 4: copy_tile_w<THREADS, T, ROWS, COLS, PITCH, SWZ, 4>(dst, src, ld, rows, cols); break;
    default:
      if constexpr (sizeof(T) == 2)
        copy_tile_w<THREADS, T, ROWS, COLS, PITCH, SWZ, 2>(dst, src, ld, rows, cols);
  }
}

// f32: A fragments of a k-step straight from the raw x tile (pitch XP),
// split in registers; rows r and r + 8 at columns c0 + 2t and c0 + 2t + 1,
// the slots t and t + 4 (the split layout's order, see mma_tf32.cuh).
// The padded pitch makes the 8-byte reads of a half warp conflict-free.
template <int XP>
__device__ __forceinline__ void frag_a_raw(const float* raw, int r, int c,
                                           uint32_t (&big)[4], uint32_t (&small)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(raw + r * XP + c);
  const float2 hi = *reinterpret_cast<const float2*>(raw + (r + 8) * XP + c);
  split<false>(lo.x, big[0], small[0]);
  split<false>(hi.x, big[1], small[1]);
  split<false>(lo.y, big[2], small[2]);
  split<false>(hi.y, big[3], small[3]);
}

// f32: split a landed raw w tile (BK x BN, pitch WP) into the B layout: for
// k-step m and n-tile j, lane (g, t) holds (big B[8m + 2t][8j + g], big
// B[8m + 2t + 1][8j + g], small of both), the slots t and t + 4; one
// 16-byte load a lane.  One lane quad a thread and turn: two reads (the
// padded pitch puts the 32 lanes on 32 banks), one 16-byte store.
template <int THREADS, int BK, int BN, int WP>
__device__ __forceinline__ void split_w(uint32_t* tile, const float* raw) {
  constexpr int QUADS = (BK / 8) * (BN / 8) * 32;
  static_assert(QUADS % THREADS == 0, "tile vs block");
#pragma unroll
  for (int q = 0; q < QUADS / THREADS; ++q) {
    const int i = threadIdx.x + q * THREADS;
    const int lane = i & 31, blk = i >> 5;
    const int m = blk / (BN / 8), j = blk % (BN / 8);
    const int k = m * 8 + 2 * (lane & 3), n = j * 8 + (lane >> 2);
    uint4 v;
    split<false>(raw[k * WP + n], v.x, v.z);
    split<false>(raw[(k + 1) * WP + n], v.y, v.w);
    *reinterpret_cast<uint4*>(tile + blk * 128 + lane * 4) = v;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);   // as .astype
}

// Store rows [0, rows) and columns [0, cols) of the staged y tile (pitch YP)
// to y (row stride N) with W-byte stores.
template <int THREADS, typename T, int BN, int YP, int W>
__device__ __forceinline__ void store_y_w(T* y, long long N, const T* ys,
                                          int rows, int cols) {
  constexpr int E = W / (int)sizeof(T);
  constexpr int PER_ROW = BN / E;
  constexpr int TURN = THREADS / PER_ROW;      // rows a turn of the block stores
  static_assert(THREADS % PER_ROW == 0 && kTileM % TURN == 0, "tile vs block");
  const int r0 = threadIdx.x / PER_ROW, c = (threadIdx.x % PER_ROW) * E;
  if (c >= cols) return;
#pragma unroll
  for (int q = 0; q < kTileM / TURN; ++q) {
    const int r = r0 + q * TURN;
    if (r >= rows) break;
    const T* s = ys + r * YP + c;
    T* d = y + r * N + c;
    if (c + E <= cols) {
      if constexpr (W == 16) *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
      else if constexpr (W == 8) *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
      else if constexpr (W == 4) *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
      else *d = *s;
    } else {
      for (int e = 0; c + e < cols; ++e) d[e] = s[e];
    }
  }
}

template <int THREADS, typename T, int BN, int YP>
__device__ __forceinline__ void store_y(T* y, long long N, const T* ys,
                                        int rows, int cols, int width) {
  switch (width) {
    case 16: store_y_w<THREADS, T, BN, YP, 16>(y, N, ys, rows, cols); break;
    case 8: store_y_w<THREADS, T, BN, YP, 8>(y, N, ys, rows, cols); break;
    case 4: store_y_w<THREADS, T, BN, YP, 4>(y, N, ys, rows, cols); break;
    default:
      if constexpr (sizeof(T) == 2) store_y_w<THREADS, T, BN, YP, 2>(y, N, ys, rows, cols);
  }
}

// One block: rows m0 .. m0 + 127 of x against columns n0 .. n0 + BN − 1 of w.
// xw, ww, yw: bytes a copy of x and w, a store of y (see bytes_per_copy).
template <typename T, int BN>
__global__ void __launch_bounds__(Smem<T, BN>::THREADS, Cfg<T>::MIN_BLOCKS)
fused_bn_kernel(const T* __restrict__ x, long long ldx,
                const T* __restrict__ w, T* __restrict__ y,
                float* __restrict__ part, int M, int N, int K, int xw, int ww,
                int yw) {
  using C = Cfg<T>;
  using S = Smem<T, BN>;
  constexpr bool F32 = S::F32;
  constexpr int THREADS = S::THREADS;
  constexpr int BK = C::BK;
  constexpr int STAGES = C::STAGES;
  constexpr int KSTEPS = BK / C::KSTEP;
  constexpr int WN = BN / C::WARPS_N;    // a warp's columns
  constexpr int NJ = WN / 8;             // its n-tiles
  constexpr int MI = 2;                  // its 16-row m-tiles
  extern __shared__ uint4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + S::RING);   // f32 split w

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % kWarpRows, wc = warp / kWarpRows;
  const int n0 = blockIdx.x * BN;
  const long long m0 = (long long)blockIdx.y * kTileM;
  const int rows = (int)(M - m0 < kTileM ? M - m0 : kTileM);
  const int nk = (K + BK - 1) / BK;

  auto stage_x = [&](int kt) {
    return reinterpret_cast<T*>(smem + (kt % STAGES) * S::STAGE);
  };
  auto stage_w = [&](int kt) {
    return reinterpret_cast<T*>(smem + (kt % STAGES) * S::STAGE + S::X_RAW);
  };
  auto load = [&](int kt) {
    const int k0 = kt * BK;
    copy_tile<THREADS, T, kTileM, BK, S::XP, !F32>(
        stage_x(kt), x + m0 * ldx + k0, ldx, rows, K - k0, xw);
    copy_tile<THREADS, T, BK, BN, S::WP, !F32>(
        stage_w(kt), w + (long long)k0 * N + n0, N, K - k0, N - n0, ww);
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // STAGES − 1 tiles in flight, one commit group each and one an iteration
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // tile kt has landed; every reader of tile kt − 1 is done
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_commit();

    float p[MI][NJ][4];   // the k-tile's partial sums
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[i][j][e] = 0.f;

    if constexpr (F32) {
      const float* xs = reinterpret_cast<const float*>(stage_x(kt));
      split_w<THREADS, BK, BN, S::WP>(Ws, reinterpret_cast<const float*>(stage_w(kt)));
      __syncthreads();
#pragma unroll
      for (int m = 0; m < KSTEPS; ++m) {
        uint32_t ab[MI][4], as[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          frag_a_raw<S::XP>(xs, wr * 32 + i * 16 + g, m * 8 + 2 * t, ab[i], as[i]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint4 v = ld16(Ws + (m * (BN / 8) + wc * NJ + j) * 128 + lane * 4);
          const uint32_t bb[2] = {v.x, v.y}, bs[2] = {v.z, v.w};
#pragma unroll
          for (int i = 0; i < MI; ++i) mma3_into<false, false>(p[i][j], ab[i], as[i], bb, bs);
        }
      }
    } else {
      const char* xs = reinterpret_cast<const char*>(stage_x(kt));
      const char* ws = reinterpret_cast<const char*>(stage_w(kt));
      const int li = lane >> 3, lr = lane & 7;
#pragma unroll
      for (int m = 0; m < KSTEPS; ++m) {
        uint32_t a[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          // matrices: rows +0 / +8 (li & 1), k +0 / +8 (li >> 1)
          const int r = wr * 32 + i * 16 + lr + 8 * (li & 1);
          ldmatrix_x4(a[i], xs + tile_off<true>(r, (m * 16 + 8 * (li >> 1)) * 2, BK * 2));
        }
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          // matrices: k +0 / +8 (li & 1), n-tiles j / j + 1 (li >> 1)
          const int k = m * 16 + lr + 8 * (li & 1);
          uint32_t b[4];
          ldmatrix_x4_trans(b, ws + tile_off<true>(k, (wc * WN + (j + (li >> 1)) * 8) * 2, BN * 2));
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_bf16(p[i][j], a[i], b[0], b[1]);
            mma_bf16(p[i][j + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)   // the k-tile's partial into the sum
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += p[i][j][e];
  }
  cp_wait_all();
  __syncthreads();   // every stage and the split tile are free: the epilogue reuses them

  T* ys = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + S::Y_STAGE);   // [wr][2][BN]
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = wc * WN + j * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = wr * 32 + i * 16 + g;
      store_pair(ys + r * S::YP + col, acc[i][j][0], acc[i][j][1]);
      store_pair(ys + (r + 8) * S::YP + col, acc[i][j][2], acc[i][j][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = h; e < 4; e += 2) {
          s += acc[i][j][e];
          q = fmaf(acc[i][j][e], acc[i][j][e], q);
        }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {   // the 8 row lanes of this column
        s += __shfl_xor_sync(0xffffffffu, s, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      if (g == 0) {
        red[(wr * 2 + 0) * BN + col + h] = s;
        red[(wr * 2 + 1) * BN + col + h] = q;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * BN; i += THREADS) {
    const int which = i / BN, c = i % BN;
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) total += red[(r * 2 + which) * BN + c];
    if (n0 + c < N) part[((size_t)blockIdx.y * 2 + which) * N + n0 + c] = total;
  }
  store_y<THREADS, T, BN, S::YP>(y + m0 * N + n0, N, ys, rows, N - n0, yw);
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

// The widest copy (16, 8 or 4 bytes; 2 = plain element loads) that keeps
// every row of a tensor with this base and row stride (in bytes) aligned.
int bytes_per_copy(const void* base, long long row_bytes) {
  const long long a = (long long)(uintptr_t)base | row_bytes;
  return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : 2;
}

template <typename T, int BN>
int launch_bn(const T* x, long long ldx, const T* w, T* y, float* part, int M,
              int N, int K, cudaStream_t stream) {
  auto kern = fused_bn_kernel<T, BN>;
  constexpr int smem = Smem<T, BN>::BYTES;
  // once per instantiation, on the first (uncaptured) call: later calls
  // may be captured into a CUDA graph
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long es = sizeof(T);
  const dim3 grid((N + BN - 1) / BN, (M + kTileM - 1) / kTileM);
  kern<<<grid, Smem<T, BN>::THREADS, smem, stream>>>(
      x, ldx, w, y, part, M, N, K, bytes_per_copy(x, ldx * es),
      bytes_per_copy(w, N * es), bytes_per_copy(y, N * es));
  return (int)cudaGetLastError();
}

bool bad_dims(long long ldx, int M, int N, int K) {
  const long long tiles_m = (M + (long long)kTileM - 1) / kTileM;
  return M < 1 || N < 1 || K < 1 || ldx < K || tiles_m > 65535;
}

template <typename T>
int launch(const T* x, long long ldx, const T* w, T* y, float* part, int M,
           int N, int K, cudaStream_t stream) {
  if (bad_dims(ldx, M, N, K)) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4)   // four warps of 32 x 64, two blocks an SM
    return launch_bn<T, 64>(x, ldx, w, y, part, M, N, K, stream);
  else
    return N <= 64 ? launch_bn<T, 64>(x, ldx, w, y, part, M, N, K, stream)
                   : launch_bn<T, 128>(x, ldx, w, y, part, M, N, K, stream);
}

}  // namespace

extern "C" int fused_bn_tile_m() { return kTileM; }

// Dynamic shared memory of one block, in bytes, for bf16 (0/1) operands
// and column tile bn (64, or 128 in bf16); 0 for a tile the kernel lacks.
extern "C" int fused_bn_smem(int bf16, int bn) {
  using bf = __nv_bfloat16;
  if (bn == 64) return bf16 ? Smem<bf, 64>::BYTES : Smem<float, 64>::BYTES;
  if (bn == 128 && bf16) return Smem<bf, 128>::BYTES;
  return 0;
}

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
