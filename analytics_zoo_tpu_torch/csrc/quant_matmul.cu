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
//    scales (G, N) f32, effective group size ceil(K/G) -> (M, N) f32.
//    Every shape the quantizer emits: odd K, a ragged last group, any M.
//
// What bounds them on the card: device-memory bytes.  The predict head is
// 768 x 50257 at a batch of 8: the weight (38.6 MB int8, 19.3 MB packed
// int4 + 2.4 MB scales) is read once while each weight byte feeds only
// 2·M operations.
//
// w8a8 runs its products on the tensor cores (s8 mma.sync m16n8k32 with s32
// accumulation: IMMA.16832.S8.S8), operands swapped as in w4a16:
//  - out^T = W^T·x^T: the mma's 16-row side runs over output columns, its
//    8-wide side over rows of x (MT = ceil(M / 8) m-tiles of 8 rows a
//    block, at most 8).  A lane's four columns are one word of a weight row: mma rows g
//    and g + 8 of tile i are its columns cw + 2i and cw + 2i + 1.
//  - the k order inside a 64-row chunk is free (the same for both
//    operands): lane group t (lane & 3) takes rows 16t .. 16t + 15 of the
//    chunk, k-step a and register half h rows 16t + 8a + 4h + j.  So x's
//    B fragments of both k-steps are one 16-byte load of 16 consecutive x
//    bytes, and the 4 words a lane reads for one register group (rows
//    16t + 4v .. +3, its 4 columns) transpose into 4 A registers with 8
//    PRMTs (__byte_perm).  Rows 16 apart start on the same byte mod 16
//    (16·N ≡ 0), so the four row groups of one load are staged 8 banks
//    apart and every shared-memory load is free of bank conflicts.
//  - the weight streams through a kW8Stages-deep cp.async ring of 64-row
//    chunks, each row the 16-byte aligned superset of the block's 192
//    columns (208 bytes; N = 50257 leaves rows off 16 bytes, which no TMA
//    tensor map takes), read at the row's offset with a funnel shift of
//    two words; a weight base not on 16 bytes gets byte copies at its
//    start.  192 columns a block (6 warps of 32) and two blocks an SM make
//    the head's 262 blocks one wave on 132 SMs, each SM with ~80 KB of
//    weight in flight.
//  - x is staged once a segment of 768 k (zero past K and past M, so rows
//    of a ragged last chunk add nothing whatever the ring holds there),
//    by cp.async where its rows start on 16 bytes (the first segment in
//    the ring's first group).
//  - the s32 sum is exact in any order, and the output is one cvt.rn and
//    one f32 multiply, so the result is bitwise that of the plain version.
//    The output tile goes through shared memory and out a row at a time
//    (a warp's stores 128 contiguous bytes, not 8 columns of 4 rows).
// What holds it back (PERF.md, kernel_variants.py): the ring.  The weight
// copies alone take about the kernel's time, the products hide under
// them, and what is left is a fixed cost of launch, the first round trip
// and the stores.
//
// w4a16 runs its products on the tensor cores, where the f32 rate outside
// them (2·8·768·50257 flop at 67 TFLOP/s = 9.2 µs) is above the 7.0 µs
// byte bound of the head:
//  - out^T = W^T·x^T: the mma's 16-row side runs over 16 output columns
//    and its 8-wide side over 8 rows of x, which fits M = 8 (MT = 1 m-tile
//    a block; MT = 4, 32 rows, above).  128 columns a block, 32 a warp.
//  - the int4 codes are exact in TF32 and bf16, so the group scale comes
//    out of each group's sum: acc[n] += s[g, n]·Σ_{k∈g} x[k]·q[k, n].  f32
//    x takes two TF32 products a k-step (x's big and small halves against
//    the codes: m16n8k8, HMMA.1688.F32.TF32), bf16 x one bf16 product
//    (m16n8k16, HMMA.16816.F32.BF16).  The products of a chunk (at most 64
//    packed rows, inside one group in each half: the head's groups are 64
//    rows) sum into a zeroed partial, so the tensor core's truncating sum
//    (mma_probe.py) stays inside a group, and the scale's multiply-add puts
//    it into an f32 accumulator.  The rounding order therefore differs from
//    the plain x @ (q·s): s·Σ(x·q) a chunk, partials summed in f32.
//  - chunks end at every group boundary of either half (ragged groups,
//    odd K, a group straddling the two halves), so a chunk never mixes
//    groups; x is zero past K and past a chunk's rows, which masks the
//    codes of rows outside it.
//  - the weight streams through shared memory in a kW4Stages-deep
//    cp.async ring of 64-row chunks (8 KB of weight a chunk: scattered
//    144-byte row pieces need many bytes in flight, and each chunk costs a
//    barrier).  TMA cannot take it (a tensor map's row stride must be a
//    multiple of 16 bytes; the head's is 50257), so each packed row's 128
//    bytes are copied as the 16-byte aligned superset (144 bytes) and read
//    at the row's offset (a funnel shift of two words).  The chunk's two
//    scale rows ride in the same ring, the same way.  x is staged raw, once
//    a segment (all of K at the head: 24 KB at M = 8), with the first
//    chunk, and split into TF32 halves (Veltkamp's split: floating-point
//    instructions, not integer ones) as its fragments are read.
//  - codes are dequantized in registers with one LOP3 and one FADD each:
//    the nibble at bit p (p <= 16) or of the word shifted right by 12 is
//    or-ed into the mantissa of 2^23, so the FADD gives code·2^p exactly;
//    every product of a column carries the same 2^p, which the epilogue of
//    the chunk's partial takes out (exact).  Full chunks run unmasked and
//    fully unrolled.
// What holds it back (PERF.md): the dequantizing and fragment
// instructions at 12 warps an SM (the integer pipe issues half as many a
// clock as the floating-point one), every block staging all of x, and
// the scattered row pieces, which the ring alone reads at ~1.6 TB/s.
//
// C interface, loaded with ctypes (analytics_zoo_tpu_torch/ops/_build.py):
// each entry point launches on the given stream, allocates nothing, and
// returns the CUDA error of the launch (0 = launched).  All operands are
// contiguous row-major.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

// Copy the 16-byte aligned chunk at address a, of which only the bytes in
// [lo, hi) are read; the others are left as they are (callers never use
// them) or zero-filled
__device__ __forceinline__ void copy16(uint8_t* d, uintptr_t a, uintptr_t lo,
                                       uintptr_t hi) {
  if (a >= lo && a + 16 <= hi) {
    cp_async<16>(d, (const void*)a, true);
  } else if (a < lo && a + 16 > lo) {
    // the buffer's first bytes, when it does not start on 16 bytes
    for (int b = 0; b < 16; ++b)
      if (a + b >= lo && a + b < hi) d[b] = *(const uint8_t*)(a + b);
  } else if (a < hi && a + 16 > hi) {
    cp_async_n<16>(d, (const void*)a, (int)(hi - a));
  }
}

// -- w8a8 ----------------------------------------------------------------------

constexpr int kW8Threads = 192;                 // 6 warps
constexpr int kW8BN = 192;                      // output columns a block, 32 a warp
constexpr int kW8KC = 64;                       // weight rows a chunk: two k-steps
constexpr int kW8Stages = 4;                    // the weight ring
constexpr int kW8Copies = (kW8BN + 16) / 16;    // 16-byte copies a row
constexpr int kW8Pitch = 16 * kW8Copies;        // bytes a staged row
constexpr int kW8Group = 16 * kW8Pitch + 32;    // bytes a group of 16 rows
constexpr int kW8Stage = 4 * kW8Group;          // bytes a chunk
constexpr int kW8XSeg = 768;                    // k of x staged at once
constexpr int kW8XPitch = kW8XSeg + 64;         // bytes a row of x (64 mod 128)
constexpr int kW8OPitch = kW8BN + 1;            // floats a row of the output tile
static_assert(kW8Group / 4 % 16 == 8, "row groups must lie 8 banks apart");
static_assert(kW8XSeg % kW8KC == 0, "a chunk lies inside one x segment");
static_assert(64 * kW8OPitch * 4 <= kW8Stages * kW8Stage,
              "the ring holds the output tile of 8 m-tiles");

// Shared memory of a block at MT m-tiles: x of a segment (8·MT rows), then
// the weight ring (which holds the output tile at the end)
constexpr int w8_smem(int mt) {
  return 8 * mt * kW8XPitch + kW8Stages * kW8Stage;
}

// grid (ceil(N / kW8BN), ceil(M / (8·MT))), block kW8Threads, dynamic
// shared memory w8_smem(MT).
template <int MT>
__global__ void __launch_bounds__(kW8Threads, 2)
w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ out,
            int M, int N, int K) {
  constexpr int MR = 8 * MT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xs = smem;
  uint8_t* ring = smem + MR * kW8XPitch;

  const int n0 = blockIdx.x * kW8BN;
  const int m0 = blockIdx.y * MR;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cw = (threadIdx.x >> 5) * 32 + 4 * g;   // this lane's 4 columns
  const uintptr_t wbase = (uintptr_t)w;
  const uintptr_t wend = wbase + (uintptr_t)K * N;
  const int nchunks = (K + kW8KC - 1) / kW8KC;

  // Stage chunk c's rows below K into ring slot st: row r of the chunk in
  // group r / 16 at line r % 16, as the aligned superset of the block's
  // columns
  auto stage = [&](int c, int st) {
    uint8_t* dst = ring + st * kW8Stage;
    const int k0 = c * kW8KC;
    const int nr = min(kW8KC, K - k0);
    for (int i = threadIdx.x; i < nr * kW8Copies; i += kW8Threads) {
      const int r = i / kW8Copies;
      const int q16 = i - r * kW8Copies;
      const uintptr_t a =
          ((wbase + (uintptr_t)(k0 + r) * N + n0) & ~(uintptr_t)15) + 16 * q16;
      copy16(dst + (r >> 4) * kW8Group + (r & 15) * kW8Pitch + 16 * q16, a,
             wbase, wend);
    }
  };

  // x's k in [k0, k0 + kW8XSeg) of the block's rows, k-contiguous, zero
  // past K and past M: by cp.async (in the caller's next group) where
  // every row starts on 16 bytes, else by byte loads
  const bool x16 = (((uintptr_t)x | (uintptr_t)K) & 15) == 0;
  auto stage_x = [&](int k0) {
    if (x16) {
      constexpr int PER_ROW = kW8XSeg / 16;
      for (int i = threadIdx.x; i < MR * PER_ROW; i += kW8Threads) {
        const int r = i / PER_ROW;
        const int k = k0 + 16 * (i - r * PER_ROW);
        const bool in = m0 + r < M && k < K;
        cp_async<16>(xs + r * kW8XPitch + (k - k0),
                     in ? x + (size_t)(m0 + r) * K + k : x, in);
      }
      return;
    }
    constexpr int PER_ROW = kW8XSeg / 4;
    for (int i = threadIdx.x; i < MR * PER_ROW; i += kW8Threads) {
      const int r = i / PER_ROW;
      const int k = k0 + 4 * (i - r * PER_ROW);
      uint32_t v = 0u;
      if (m0 + r < M) {
        const int8_t* xr = x + (size_t)(m0 + r) * K;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < K) v |= (uint32_t)(uint8_t)xr[k + e] << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(xs + r * kW8XPitch + (k - k0)) = v;
    }
  };

  // Where this lane's word of line u (rows 16t + u of every chunk) lies
  // in a slot: the lane's part, and the word and funnel shift of the line
  // (the same for the whole warp): row k starts at byte (w + k·N + n0) mod
  // 16 of its superset, which is the same for every chunk
  const int lane_off = t * kW8Group + cw;
  int uoff[16];
  uint32_t sh[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const uint32_t lo = (uint32_t)(wbase + (uintptr_t)u * N + n0) & 15u;
    uoff[u] = u * kW8Pitch + (int)(lo & ~3u);
    sh[u] = 8u * (lo & 3u);
  }

  int acc[2][MT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // One chunk from ring slot st, whose first row is k = xk of the staged
  // x segment: 2 k-steps x 2 column tiles x MT m-tiles
  auto compute = [&](int st, int xk) {
    const uint8_t* slot = ring + st * kW8Stage + lane_off;
    uint32_t wv[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(slot + uoff[u]);
      wv[u] = __funnelshift_r(p[0], p[1], sh[u]);
    }
    // a[v][c]: column cw + c at rows 16t + 4v .. 16t + 4v + 3 (v = 2a + h)
    uint32_t a[4][4];
#pragma unroll
    for (int v = 0; v < 4; ++v) transpose4(wv + 4 * v, a[v]);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      // x row 8j + g at rows 16t .. 16t + 15: (k-step 0: h = 0, 1; k-step 1)
      const uint4 b = *reinterpret_cast<const uint4*>(
          xs + (8 * j + g) * kW8XPitch + xk + 16 * t);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_s8(acc[i][j], a[0][2 * i], a[0][2 * i + 1], a[1][2 * i],
               a[1][2 * i + 1], b.x, b.y);
        mma_s8(acc[i][j], a[2][2 * i], a[2][2 * i + 1], a[3][2 * i],
               a[3][2 * i + 1], b.z, b.w);
      }
    }
  };

  // the ring: kW8Stages - 1 chunks staged ahead of the one computed; x's
  // first segment rides in the first group
  stage_x(0);
#pragma unroll
  for (int s = 0; s < kW8Stages - 1; ++s) {
    if (s < nchunks) stage(s, s);
    cp_commit();
  }
  int seg = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int k0 = c * kW8KC;
    if (k0 / kW8XSeg != seg) {
      // a later segment of x: every warp is done with the old one
      seg = k0 / kW8XSeg;
      __syncthreads();
      stage_x(seg * kW8XSeg);
      cp_commit();
      cp_wait_all();
    }
    cp_wait<kW8Stages - 2>();
    __syncthreads();
    if (c + kW8Stages - 1 < nchunks) {
      stage(c + kW8Stages - 1, (c + kW8Stages - 1) % kW8Stages);
    }
    cp_commit();
    compute(c % kW8Stages, k0 - seg * kW8XSeg);
  }
  cp_wait_all();
  __syncthreads();

  // The output tile through shared memory (the ring's), then stored a row
  // at a time: c0, c1 are column cw + 2i, rows 2t, 2t + 1 of each m-tile;
  // c2, c3 column cw + 2i + 1.  One conversion and one multiply, nothing
  // fused
  float* ot = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = cw + 2 * i + (e >> 1);
      const float s = n0 + c < N ? scale[n0 + c] : 0.f;
#pragma unroll
      for (int j = 0; j < MT; ++j)
        ot[(8 * j + 2 * t + (e & 1)) * kW8OPitch + c] =
            __fmul_rn(__int2float_rn(acc[i][j][e]), s);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MR * kW8BN; i += kW8Threads) {
    const int r = i / kW8BN;
    const int c = i - r * kW8BN;
    if (m0 + r < M && n0 + c < N)
      out[(size_t)(m0 + r) * N + n0 + c] = ot[r * kW8OPitch + c];
  }
}

// -- w4a16 ---------------------------------------------------------------------

constexpr int kW4Threads = 128;            // 4 warps
constexpr int kW4BN = 128;                 // output columns a block, 32 a warp
constexpr int kW4KT = 64;                  // packed rows a chunk, at most
constexpr int kW4Stages = 3;               // the weight ring
constexpr int kW4Pitch = 160;              // bytes a staged row (8 mod 32 words)
constexpr int kW4Copies = (kW4BN + 16) / 16;       // 16-byte copies a row
constexpr int kW4SCopies = (4 * kW4BN + 16) / 16;  // ... a scale row
constexpr int kW4SPitch = 16 * kW4SCopies;         // bytes a staged scale row

// Shared memory of one instantiation: x of a segment, raw ([half][row]
// rows of XPW words: KSEG values, the kW4KT a chunk's masked tail may
// read past them, 8 mod 32 words apart), the weight ring and the scale
// ring (two rows a stage).
template <typename TX, int MT>
struct W4Geom {
  static constexpr int MR = 8 * MT;                      // rows of x a block
  static constexpr int EW = 4 / (int)sizeof(TX);         // x values a word
  static constexpr int KSEG = 384 * EW / MT;             // packed rows a segment
  static constexpr int XPW = ((KSEG + kW4KT) / EW + 31) / 32 * 32 + 8;
  static constexpr int X_BYTES = 2 * MR * XPW * 4;
  static constexpr int W_BYTES = kW4Stages * kW4KT * kW4Pitch;
  static constexpr int S_BYTES = kW4Stages * 2 * kW4SPitch;
  static constexpr int SMEM = X_BYTES + W_BYTES + S_BYTES;
};

// A chunk: packed rows [r0, r1), inside one x segment, one group of the
// low rows (k = r) and one of the high rows (k = kh + r; ghi = -1 when the
// chunk has no high row below K).
struct W4Chunk {
  int r0, r1, glo, ghi;
};

__device__ __forceinline__ W4Chunk w4_chunk(int r0, int kh, int K, int gs,
                                            int kseg) {
  W4Chunk c;
  c.r0 = r0;
  c.glo = r0 / gs;
  int r1 = min(min(r0 + kW4KT, kh), (r0 / kseg + 1) * kseg);
  r1 = min(r1, (c.glo + 1) * gs);
  c.ghi = -1;
  if (kh + r0 < K) {
    c.ghi = (kh + r0) / gs;
    r1 = min(r1, (c.ghi + 1) * gs - kh);
  }
  c.r1 = r1;
  return c;
}

// code·2^P of the nibble at bits P..P+3 of v (P <= 16): the nibble, its
// sign bit flipped, in the mantissa of 2^23, less 2^23 + 8·2^P; exact
template <int P>
__device__ __forceinline__ uint32_t code_x(uint32_t v) {
  return __float_as_uint(
      __uint_as_float((v & (0xFu << P)) ^ (0x4B000000u | (8u << P)))
      - (8388608.f + 8.f * (float)(1u << P)));
}

// The codes of bytes 0..3 of w (a lane's columns cw .. cw + 3) in half HF
// (0: low nibbles, 1: high), byte b scaled by 2^w4_exp(HF, b)
__host__ __device__ constexpr int w4_exp(int hf, int b) {
  return hf ? (b == 0 ? 4 : b == 1 ? 12 : b == 2 ? 8 : 16)
            : (b == 0 ? 0 : b == 1 ? 8 : b == 2 ? 16 : 12);
}

template <int HF>
__device__ __forceinline__ void codes4(uint32_t w, uint32_t (&c)[4]) {
  const uint32_t w12 = w >> 12;
  if constexpr (HF == 0) {
    c[0] = code_x<0>(w);
    c[1] = code_x<8>(w);
    c[2] = code_x<16>(w);
    c[3] = code_x<12>(w12);
  } else {
    c[0] = code_x<4>(w);
    c[1] = code_x<12>(w);
    c[2] = code_x<8>(w12);
    c[3] = code_x<16>(w12);
  }
}

// bf16x2 (code of x's byte B, code of y's byte B) in half HF: the nibbles
// in the mantissas of 128 (bf16 0x4300), less 136
template <int HF, int B>
__device__ __forceinline__ uint32_t code_pair(uint32_t x, uint32_t y) {
  const uint32_t p = __byte_perm(x, y, B | ((B + 4) << 8));
  uint32_t bits = ((p >> (4 * HF)) & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&bits);
  v = __hsub2(v, __float2bfloat162_rn(136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = big + small with big x to TF32's 11 significant bits (Veltkamp's
// split, 2^13 + 1: floating-point operations only, where rounding the bits
// takes integer ones, half as many of which an SM issues a clock) and small
// = x - big exact in f32; the mma reads small to 11 bits, which leaves an
// error of at most 2^-22·|x|
__device__ __forceinline__ void split_fp(float x, uint32_t& big, uint32_t& small) {
  const float c = __fmul_rn(x, 8193.f);
  const float b = __fsub_rn(c, __fsub_rn(c, x));
  big = __float_as_uint(b);
  small = __float_as_uint(__fsub_rn(x, b));
}

// The 4 bytes at columns col .. col + 3 of a staged row whose data starts
// at byte (lo & 15) (lo: the low bits of the row's device address)
__device__ __forceinline__ uint32_t row_word(const uint8_t* row, uint32_t lo,
                                             int col) {
  const int bo = (int)(lo & 15u) + col;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
  return __funnelshift_r(w[bo >> 2], w[(bo >> 2) + 1], (bo & 3) * 8);
}

// grid (ceil(N / kW4BN), ceil(M / (8·MT))), block kW4Threads, dynamic
// shared memory W4Geom<TX, MT>::SMEM.
template <typename TX, int MT>
__global__ void __launch_bounds__(kW4Threads, MT == 1 ? 3 : 2)
w4a16_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ wq,
             const float* __restrict__ sg, float* __restrict__ out,
             int M, int N, int K, int G) {
  using Gm = W4Geom<TX, MT>;
  constexpr bool F32 = sizeof(TX) == 4;
  constexpr int MR = Gm::MR, KSEG = Gm::KSEG;
  constexpr int XPB = Gm::XPW * 4;                 // bytes a row of x
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xs = smem;
  uint8_t* ws = smem + Gm::X_BYTES;
  uint8_t* ss = ws + Gm::W_BYTES;

  const int kh = (K + 1) / 2;
  const int gs = (K + G - 1) / G;
  const int n0 = blockIdx.x * kW4BN;
  const int m0 = blockIdx.y * MR;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // mma rows g and g + 8 of tile i are this lane's columns cw + 2i and
  // cw + 2i + 1: a lane's four columns are one word of a staged row
  const int cw = warp * 32 + 4 * g;
  const uintptr_t wbase = (uintptr_t)wq;
  const uintptr_t wend = wbase + (uintptr_t)kh * N;
  const uintptr_t sbase = (uintptr_t)sg;
  const uintptr_t send = sbase + (uintptr_t)G * N * 4;
  const uintptr_t xbase = (uintptr_t)x;
  const uintptr_t xend = xbase + (uintptr_t)M * K * sizeof(TX);

  // Stage chunk c's weight rows and its two scale rows into ring slot st:
  // each row as the 16-byte aligned superset of its block's columns
  auto stage = [&](const W4Chunk& c, int st) {
    uint8_t* dst = ws + st * kW4KT * kW4Pitch;
    const int nr = c.r1 - c.r0;
    for (int i = threadIdx.x; i < nr * kW4Copies; i += kW4Threads) {
      const int r = i / kW4Copies;
      const int q16 = i - r * kW4Copies;
      const uintptr_t a =
          ((wbase + (uintptr_t)(c.r0 + r) * N + n0) & ~(uintptr_t)15) + 16 * q16;
      copy16(dst + r * kW4Pitch + 16 * q16, a, wbase, wend);
    }
    uint8_t* sd = ss + st * 2 * kW4SPitch;
    for (int i = threadIdx.x; i < 2 * kW4SCopies; i += kW4Threads) {
      const int hf = i / kW4SCopies;
      const int q16 = i - hf * kW4SCopies;
      const int grp = hf ? c.ghi : c.glo;
      if (grp < 0) continue;
      const uintptr_t a =
          ((sbase + ((uintptr_t)grp * N + n0) * 4) & ~(uintptr_t)15) + 16 * q16;
      copy16(sd + hf * kW4SPitch + 16 * q16, a, sbase, send);
    }
  };

  // x's packed rows [R0, R0 + KSEG) of both halves, each row of x as the
  // 16-byte aligned superset of its values; rows past M are not read.
  // Where every row of each half starts on 16 bytes, plain copies that
  // zero-fill past K
  const bool x_aligned =
      ((xbase | (uintptr_t)K * sizeof(TX) | (uintptr_t)kh * sizeof(TX)) & 15) == 0;
  auto stage_x = [&](int R0) {
    if (x_aligned) {
      constexpr int PER_ROW = KSEG * (int)sizeof(TX) / 16;
      constexpr int E = 16 / (int)sizeof(TX);      // values a copy
      for (int i = threadIdx.x; i < 2 * MR * PER_ROW; i += kW4Threads) {
        const int rm = i / PER_ROW;
        const int q16 = i - rm * PER_ROW;
        const int hf = rm / MR;
        const int m = m0 + rm - hf * MR;
        const int k = hf * kh + R0 + q16 * E;
        const bool in = m < M && k < K;
        cp_async<16>(xs + rm * XPB + 16 * q16,
                     in ? x + (size_t)m * K + k : x, in);
      }
      return;
    }
    constexpr int PER_ROW = (15 + KSEG * (int)sizeof(TX) + 15) / 16;
    for (int i = threadIdx.x; i < 2 * MR * PER_ROW; i += kW4Threads) {
      const int rm = i / PER_ROW;                  // half * MR + row
      const int q16 = i - rm * PER_ROW;
      const int hf = rm / MR;
      const int m = m0 + rm - hf * MR;
      if (m >= M) continue;
      const uintptr_t start =
          xbase + ((uintptr_t)m * K + hf * kh + R0) * sizeof(TX);
      copy16(xs + rm * XPB + 16 * q16, (start & ~(uintptr_t)15) + 16 * q16,
             xbase, xend);
    }
  };

  float acc[2][MT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // this lane's rows of x (8j + g of each half): where the segment's
  // values start in them (the superset's offset, in values)
  const TX* xrow[2][MT];
  auto point_x = [&](int R0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int m = m0 + 8 * j + g;
        const uintptr_t start =
            xbase + ((uintptr_t)m * K + hf * kh + R0) * sizeof(TX);
        xrow[hf][j] = reinterpret_cast<const TX*>(
                          xs + (hf * MR + 8 * j + g) * XPB)
                      + (start & 15) / sizeof(TX);
      }
  };

  // One chunk from ring slot st: both halves' products into zeroed
  // partials, then acc += s·partial (the codes' 2^p taken out first).
  // Rows past the chunk's own (nr, or nh high rows below K) have x zero.
  auto compute = [&](const W4Chunk& c, int st, int R0) {
    const uint8_t* wt = ws + st * kW4KT * kW4Pitch;
    const int nr = c.r1 - c.r0;
    const bool hi = c.ghi >= 0;
    const int nh = hi ? min(nr, K - kh - c.r0) : 0;
    const int xk = c.r0 - R0;
    // low bits of row r0's device address; row r adds r·N
    const uint32_t lo0 = (uint32_t)(wbase + (uintptr_t)c.r0 * N + n0);
    float p[2][2][MT][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[hf][i][j][e] = 0.f;

    if constexpr (F32) {
      // one k-step of 8 rows: rows ks + t and ks + t + 4; MASKED: rows past
      // the chunk's own (nr, or nh high rows below K) read as x = 0
      auto kstep = [&](int ks, auto masked) {
        const int ra = ks + t;
        const int rb = ks + t + 4;
        const uint32_t wa = row_word(wt + ra * kW4Pitch, lo0 + (uint32_t)ra * N, cw);
        const uint32_t wb = row_word(wt + rb * kW4Pitch, lo0 + (uint32_t)rb * N, cw);
        uint32_t ca[2][4], cb[2][4];
        codes4<0>(wa, ca[0]);
        codes4<0>(wb, cb[0]);
        if (hi) {
          codes4<1>(wa, ca[1]);
          codes4<1>(wb, cb[1]);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (hf == 1 && !hi) break;
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            const float* xr = reinterpret_cast<const float*>(xrow[hf][j]) + xk;
            float va = xr[ra];
            float vb = xr[rb];
            if constexpr (decltype(masked)::value) {
              const int lim = hf ? nh : nr;
              va = ra < lim ? va : 0.f;
              vb = rb < lim ? vb : 0.f;
            }
            uint32_t bb[2], bs[2];
            split_fp(va, bb[0], bs[0]);
            split_fp(vb, bb[1], bs[1]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint32_t a[4] = {ca[hf][2 * i], ca[hf][2 * i + 1],
                                     cb[hf][2 * i], cb[hf][2 * i + 1]};
              mma(p[hf][i][j], a, bs);
              mma(p[hf][i][j], a, bb);
            }
          }
        }
      };
      if (nr == kW4KT && (!hi || nh == nr)) {
#pragma unroll
        for (int ks = 0; ks < kW4KT; ks += 8) kstep(ks, std::false_type{});
      } else {
        for (int ks = 0; ks < nr; ks += 8) kstep(ks, std::true_type{});
      }
    } else {
      for (int ks = 0; ks < nr; ks += 16) {
        // rows ks + 2t, 2t + 1, 2t + 8, 2t + 9
        uint32_t w4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = ks + 2 * t + (q & 1) + 8 * (q >> 1);
          w4[q] = row_word(wt + r * kW4Pitch, lo0 + (uint32_t)r * N, cw);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (hf == 1 && !hi) break;
          const int lim = hf ? nh : nr;
          uint32_t a[2][4];
#define AZ_W4_PAIRS(HF)                                                      \
          a[0][0] = code_pair<HF, 0>(w4[0], w4[1]);                          \
          a[0][1] = code_pair<HF, 1>(w4[0], w4[1]);                          \
          a[0][2] = code_pair<HF, 0>(w4[2], w4[3]);                          \
          a[0][3] = code_pair<HF, 1>(w4[2], w4[3]);                          \
          a[1][0] = code_pair<HF, 2>(w4[0], w4[1]);                          \
          a[1][1] = code_pair<HF, 3>(w4[0], w4[1]);                          \
          a[1][2] = code_pair<HF, 2>(w4[2], w4[3]);                          \
          a[1][3] = code_pair<HF, 3>(w4[2], w4[3])
          if (hf == 0) {
            AZ_W4_PAIRS(0);
          } else {
            AZ_W4_PAIRS(1);
          }
#undef AZ_W4_PAIRS
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            const uint16_t* xr =
                reinterpret_cast<const uint16_t*>(xrow[hf][j]) + xk + ks;
            uint32_t v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = 2 * t + (q & 1) + 8 * (q >> 1);
              v[q] = ks + r < lim ? xr[r] : 0u;
            }
            const uint32_t b0 = v[0] | v[1] << 16;
            const uint32_t b1 = v[2] | v[3] << 16;
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_bf16(p[hf][i][j], a[i], b0, b1);
          }
        }
      }
    }

    // acc += s·partial: c0, c1 are column cw + 2i, c2, c3 column cw + 2i + 1
    const uint8_t* sd = ss + st * 2 * kW4SPitch;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (hf == 1 && !hi) break;
      const int grp = hf ? c.ghi : c.glo;
      const uintptr_t sa = sbase + ((uintptr_t)grp * N + n0) * 4;
      const float* srow =
          reinterpret_cast<const float*>(sd + hf * kW4SPitch + (sa & 15)) + cw;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = 2 * i + (e >> 1);
          const float unit = F32 ? 1.f / (float)(1u << w4_exp(hf, b)) : 1.f;
          const float s = srow[b];
#pragma unroll
          for (int j = 0; j < MT; ++j)
            acc[i][j][e] = fmaf(s, p[hf][i][j][e] * unit, acc[i][j][e]);
        }
      }
    }
  };

  // the ring: kW4Stages - 1 chunks staged ahead of the one computed; x's
  // first segment rides in the first group
  stage_x(0);
  point_x(0);
  int pr = 0;
#pragma unroll
  for (int st = 0; st < kW4Stages - 1; ++st) {
    if (pr < kh) {
      const W4Chunk c = w4_chunk(pr, kh, K, gs, KSEG);
      stage(c, st);
      pr = c.r1;
    }
    cp_commit();
  }
  int seg = 0;
  int cr = 0;
  for (int ci = 0; cr < kh; ++ci) {
    const W4Chunk c = w4_chunk(cr, kh, K, gs, KSEG);
    if (cr / KSEG != seg) {
      // a later segment of x: every warp is done with the old one
      seg = cr / KSEG;
      __syncthreads();
      stage_x(seg * KSEG);
      point_x(seg * KSEG);
      cp_commit();
      cp_wait_all();
    }
    cp_wait<kW4Stages - 2>();
    __syncthreads();
    if (pr < kh) {
      const W4Chunk nc = w4_chunk(pr, kh, K, gs, KSEG);
      stage(nc, (ci + kW4Stages - 1) % kW4Stages);
      pr = nc.r1;
    }
    cp_commit();
    compute(c, ci % kW4Stages, seg * KSEG);
    cr = c.r1;
  }
  cp_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + cw + 2 * i + (e >> 1);
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int m = m0 + 8 * j + 2 * t + (e & 1);
        if (n < N && m < M) out[(size_t)m * N + n] = acc[i][j][e];
      }
    }
  }
}

bool bad_dims(int M, int N, int K) {
  return M < 1 || N < 1 || K < 1 || (M + 31) / 32 > 65535;
}

template <typename TX, int MT>
cudaError_t launch_w4_mt(const TX* x, const uint8_t* wq, const float* sg,
                         float* out, int M, int N, int K, int G,
                         cudaStream_t s) {
  constexpr int smem = W4Geom<TX, MT>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      w4a16_kernel<TX, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kW4BN - 1) / kW4BN, (M + 8 * MT - 1) / (8 * MT));
  w4a16_kernel<TX, MT><<<grid, kW4Threads, smem, s>>>(x, wq, sg, out, M, N,
                                                     K, G);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_w8_mt(const int8_t* x, const int8_t* w, const float* scale,
                         float* out, int M, int N, int K, cudaStream_t s) {
  constexpr int smem = w8_smem(MT);
  // two blocks an SM need the largest shared-memory carveout at MT = 8
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        w8a8_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(w8a8_kernel<MT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kW8BN - 1) / kW8BN, (M + 8 * MT - 1) / (8 * MT));
  w8a8_kernel<MT><<<grid, kW8Threads, smem, s>>>(x, w, scale, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int w8a8_matmul(const int8_t* x, const int8_t* w,
                           const float* scale, float* out, int M, int N,
                           int K, void* stream) {
  if (bad_dims(M, N, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // ceil(M / 8) m-tiles a block, at most 8 (64 rows; more rows, more
  // blocks over them)
  switch (min((M + 7) / 8, 8)) {
    case 1: return (int)launch_w8_mt<1>(x, w, scale, out, M, N, K, s);
    case 2: return (int)launch_w8_mt<2>(x, w, scale, out, M, N, K, s);
    case 3: return (int)launch_w8_mt<3>(x, w, scale, out, M, N, K, s);
    case 4: return (int)launch_w8_mt<4>(x, w, scale, out, M, N, K, s);
    case 5: return (int)launch_w8_mt<5>(x, w, scale, out, M, N, K, s);
    case 6: return (int)launch_w8_mt<6>(x, w, scale, out, M, N, K, s);
    case 7: return (int)launch_w8_mt<7>(x, w, scale, out, M, N, K, s);
    default: return (int)launch_w8_mt<8>(x, w, scale, out, M, N, K, s);
  }
}

// Dynamic shared memory a block of the w8a8 kernel at mt (1..8) m-tiles
extern "C" int w8a8_smem(int mt) { return w8_smem(mt); }

template <typename TX>
static int launch_w4(const TX* x, const uint8_t* wq, const float* sg,
                     float* out, int M, int N, int K, int G, void* stream) {
  if (bad_dims(M, N, K) || G < 1 || G > K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(M <= 8 ? launch_w4_mt<TX, 1>(x, wq, sg, out, M, N, K, G, s)
                      : launch_w4_mt<TX, 4>(x, wq, sg, out, M, N, K, G, s));
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

// Dynamic shared memory a block of the w4a16 kernel: bf16 = 0|1 (x's
// type), mt = 1|4 (m-tiles a block)
extern "C" int w4a16_smem(int bf16, int mt) {
  if (bf16) return mt == 1 ? W4Geom<__nv_bfloat16, 1>::SMEM
                           : W4Geom<__nv_bfloat16, 4>::SMEM;
  return mt == 1 ? W4Geom<float, 1>::SMEM : W4Geom<float, 4>::SMEM;
}
