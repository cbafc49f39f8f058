// The s8 implicit-GEMM convolution for NVIDIA Hopper (sm_90a): the spatial
// branch of the quantized convolution w8a8_conv.
//
// Computes, for int8 NHWC x (B, H, W, C), int8 w (KH, KW, C/G, COUT) (the
// layout the quantizer stores) and f32 scale (COUT,) = s_x·s_w:
//   out (B, HO, WO, COUT) f32 = float(conv_s32(x, w)) * scale
// with strides, dilation, G groups and explicit pads; the top and left
// pads place the window, the bottom and right ones are implicit in HO and
// WO (a tap outside the input reads zero).  It is the spatial branch of
// analytics_zoo_tpu/ops/quant_matmul.py::w8a8_conv (:334; the s8 x s8 ->
// s32 lax.conv_general_dilated at :348-353), which the JAX package leaves
// to XLA outside any Pallas kernel.  PyTorch has no int8 convolution on
// CUDA.
//
// An implicit GEMM: M = B·HO·WO output pixels, N = COUT/G, K = KH·KW·C/G
// in (kh, kw, c) order, so w read as (K, COUT) is already the B operand;
// one group a blockIdx.z.  No im2col buffer exists: the loader gathers each
// A tile from x, zero for a padded position, past K and past M.
//  - a block computes 64 pixels x 64 channels with 4 warps of 32 x 32, on
//    s8 mma.sync m16n8k32 (IMMA.16832.S8.S8) with s32 accumulators, 64 k a
//    stage (two k-steps), two stages: the next stage's loads are issued
//    before the current stage's products.
//  - A is staged [pixel][k], B transposed [channel][k], both k-contiguous
//    rows of 80 bytes (20 words: the 8 row groups of a fragment load fall
//    in distinct banks), so every fragment register is one 4-byte load.
//  - A: where C/G and C are multiples of 16 and x lies on 16 bytes, a
//    16-byte piece of k lies inside one tap and is one cp.async (zero-fill
//    where it is padding or past K); otherwise (the stem's C = 3) each
//    byte is gathered by its own (kh, kw, c), into registers before the
//    products and stored after them.
//  - B: four 4-byte words (4 k rows x 4 channels) a piece, read before
//    the products and transposed with PRMTs (transpose4) as they are
//    stored; bytes instead of words where the channels are off 4 bytes.
//  - the s32 sum is exact in any order, and the epilogue is one cvt.rn and
//    one f32 multiply, so the result is bitwise that of the plain version
//    (ops/quant_matmul.py::w8a8_conv_torch) and of the JAX package.
// What bounds it on the card: bytes, mostly its f32 output (the stem of
// ResNet-50 at a batch of 16 reads 2.4 MB and writes 51.4 MB), except the
// deep 3x3 convs of stages 3-4, where 2·M·N·K operations at the int8 rate
// are near the bytes.  A first, simple kernel: no TMA, no wgmma, and a
// block re-reads its weight columns from L2 for every 64 pixels.
//
// C interface, loaded with ctypes (analytics_zoo_tpu_torch/ops/_build.py):
// the entry point launches on the given stream, allocates nothing, and
// returns the CUDA error of the launch (0 = launched).  x, w and out are
// contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kCvBM = 64;                 // output pixels a block
constexpr int kCvBN = 64;                 // output channels a block
constexpr int kCvBK = 64;                 // k a stage: two k-steps of 32
constexpr int kCvThreads = 128;           // 4 warps of 32 x 32
constexpr int kCvPitch = kCvBK + 16;      // bytes a staged row (20 words)
constexpr int kCvTile = kCvBM * kCvPitch; // bytes of the A (or B) tile
constexpr int kCvStage = 2 * kCvTile;     // A, then B transposed
constexpr int kCvStages = 2;
constexpr int kCvSmem = kCvStages * kCvStage;
static_assert(kCvBM == kCvBN, "the A and B tiles share one shape");
static_assert(kCvBM * kCvBK / 16 == 2 * kCvThreads,
              "two 16-byte pieces of A a thread");
static_assert(kCvBN * kCvBK / 16 == 2 * kCvThreads,
              "two 4 x 4 pieces of B a thread");

struct ConvGeom {
  int H, W, C, KW, CG, NG, COUT, HO, WO, SH, SW, PT, PL, DH, DW, M, K;
};

// Where an output pixel's window starts in x
struct Pixel {
  long long base;   // x offset of its image and of its group's channels
  int ih0, iw0;     // top-left tap (may be negative: padding)
  bool ok;          // a pixel inside M
};

__device__ __forceinline__ Pixel pixel(const ConvGeom& g, int m, int grp) {
  Pixel p;
  p.ok = m < g.M;
  const int mm = p.ok ? m : 0;
  const int hw = g.HO * g.WO;
  const int img = mm / hw, rem = mm % hw;
  p.base = (long long)img * g.H * g.W * g.C + (long long)grp * g.CG;
  p.ih0 = (rem / g.WO) * g.SH - g.PT;
  p.iw0 = (rem % g.WO) * g.SW - g.PL;
  return p;
}

// Registers of the pieces loaded before a stage's products and stored into
// shared memory after them: A's gathered bytes (unless cp.async took
// them) and B's raw rows
struct Staged {
  uint32_t a[2][4];
  uint32_t b[2][4];
};

// A: this thread's two 16-byte pieces, k = k0 + 16·j .. + 15 of pixels
// r0 and r0 + 32 (cp.async into the stage, or bytes into st.a)
template <bool AVEC>
__device__ __forceinline__ void fetch_a(uint8_t* sa, Staged& st,
                                        const int8_t* __restrict__ x,
                                        const ConvGeom& g,
                                        const Pixel (&px)[2], int k0, int r0,
                                        int j) {
  const int k = k0 + 16 * j;
  int c = k % g.CG;
  const int tap = k / g.CG;
  int kw = tap % g.KW, kh = tap / g.KW;
  if constexpr (AVEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ih = px[h].ih0 + kh * g.DH, iw = px[h].iw0 + kw * g.DW;
      const bool in = px[h].ok && k < g.K && ih >= 0 && ih < g.H &&
                      iw >= 0 && iw < g.W;
      const int8_t* src =
          in ? x + px[h].base + ((long long)ih * g.W + iw) * g.C + c : x;
      cp_async<16>(sa + (r0 + 32 * h) * kCvPitch + 16 * j, src, in);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 4; ++v) st.a[h][v] = 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (k + e < g.K) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ih = px[h].ih0 + kh * g.DH, iw = px[h].iw0 + kw * g.DW;
          if (px[h].ok && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
            const uint32_t v = (uint8_t)__ldg(
                x + px[h].base + ((long long)ih * g.W + iw) * g.C + c);
            st.a[h][e >> 2] |= v << (8 * (e & 3));
          }
        }
      }
      if (++c == g.CG) {
        c = 0;
        if (++kw == g.KW) {
          kw = 0;
          ++kh;
        }
      }
    }
  }
}

// B: this thread's two 4 x 4 pieces, rows k0 + 4·kb .. + 3 and channels
// n0 + 4·nb .. + 3 (nb + 8 for the second), raw rows into st.b
template <bool BVEC>
__device__ __forceinline__ void fetch_b(Staged& st,
                                        const int8_t* __restrict__ w,
                                        const ConvGeom& g, int k0, int col0,
                                        int n0, int kb, int nb) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 4 * (nb + 8 * h);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + 4 * kb + r;
      const int8_t* row = w + (long long)k * g.COUT + col0;
      uint32_t word = 0u;
      if constexpr (BVEC) {
        if (k < g.K && n < g.NG)
          word = __ldg(reinterpret_cast<const uint32_t*>(row + n));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k < g.K && n + e < g.NG)
            word |= (uint32_t)(uint8_t)__ldg(row + n + e) << (8 * e);
      }
      st.b[h][r] = word;
    }
  }
}

// The register-held pieces into the stage: A's gathered bytes (AVEC's
// went by cp.async) and B transposed to [channel][k]
template <bool AVEC>
__device__ __forceinline__ void store_staged(uint8_t* sa, uint8_t* sb,
                                             const Staged& st, int r0, int j,
                                             int kb, int nb) {
  if constexpr (!AVEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint4*>(sa + (r0 + 32 * h) * kCvPitch + 16 * j) =
          make_uint4(st.a[h][0], st.a[h][1], st.a[h][2], st.a[h][3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t o[4];
    transpose4(st.b[h], o);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(
          sb + (4 * (nb + 8 * h) + c) * kCvPitch + 4 * kb) = o[c];
  }
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// grid (ceil(M / kCvBM), ceil(NG / kCvBN), G), block kCvThreads, dynamic
// shared memory kCvSmem.
template <bool AVEC, bool BVEC>
__global__ void __launch_bounds__(kCvThreads)
w8a8_conv2d_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out,
                   ConvGeom g) {
  extern __shared__ __align__(16) uint8_t cv_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;        // mma group, thread in group
  const int wm = warp & 1, wn = warp >> 1;         // warp's 32 x 32 quadrant
  const int grp = blockIdx.z;
  const int m0 = blockIdx.x * kCvBM, n0 = blockIdx.y * kCvBN;
  const int col0 = grp * g.NG;                     // the group's first channel

  // A: pieces j of pixels r0 and r0 + 32
  const int j = tid & 3, r0 = tid >> 2;
  const Pixel px[2] = {pixel(g, m0 + r0, grp), pixel(g, m0 + r0 + 32, grp)};
  // B: k rows 4·kb .. + 3, channels 4·nb .. + 3 and 4·(nb + 8) .. + 3; a
  // warp's lanes read 8 rows of 16 bytes
  const int kb = (lane >> 2) + 8 * (warp & 1), nb = (lane & 3) + 4 * (warp >> 1);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0;

  const int KT = (g.K + kCvBK - 1) / kCvBK;
  Staged st;
  fetch_a<AVEC>(cv_smem, st, x, g, px, 0, r0, j);
  fetch_b<BVEC>(st, w, g, 0, col0, n0, kb, nb);
  store_staged<AVEC>(cv_smem, cv_smem + kCvTile, st, r0, j, kb, nb);
  cp_commit();

  for (int kt = 0; kt < KT; ++kt) {
    const uint8_t* sa = cv_smem + (kt & 1) * kCvStage;
    const uint8_t* sb = sa + kCvTile;
    uint8_t* na = cv_smem + ((kt + 1) & 1) * kCvStage;
    const bool more = kt + 1 < KT;
    if (more) {
      fetch_a<AVEC>(na, st, x, g, px, (kt + 1) * kCvBK, r0, j);
      fetch_b<BVEC>(st, w, g, (kt + 1) * kCvBK, col0, n0, kb, nb);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kCvBK / 32; ++s) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* p = sa + (32 * wm + 16 * i + gq) * kCvPitch + 32 * s +
                           4 * tq;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * kCvPitch);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * kCvPitch + 16);
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const uint8_t* p = sb + (32 * wn + 8 * jn + gq) * kCvPitch + 32 * s +
                           4 * tq;
        bf[jn][0] = lds32(p);
        bf[jn][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
          mma_s8(acc[i][jn], af[i][0], af[i][1], af[i][2], af[i][3],
                 bf[jn][0], bf[jn][1]);
    }
    if (more) store_staged<AVEC>(na, na + kCvTile, st, r0, j, kb, nb);
    __syncthreads();
  }
  cp_wait_all();

  // C element e of tile (i, jn): pixel 16i + gq + 8(e >> 1), channel
  // 8jn + 2tq + (e & 1) of the warp's quadrant
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + 32 * wm + 16 * i + gq + 8 * hf;
      if (m >= g.M) continue;
      float* orow = out + (long long)m * g.COUT + col0;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 32 * wn + 8 * jn + 2 * tq + e;
          if (n < g.NG)
            orow[n] = __int2float_rn(acc[i][jn][2 * hf + e]) * scale[col0 + n];
        }
    }
}

template <bool AVEC, bool BVEC>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* scale,
                   float* out, const ConvGeom& g, int groups, cudaStream_t s) {
  const dim3 grid((g.M + kCvBM - 1) / kCvBM, (g.NG + kCvBN - 1) / kCvBN,
                  groups);
  w8a8_conv2d_kernel<AVEC, BVEC><<<grid, kCvThreads, kCvSmem, s>>>(
      x, w, scale, out, g);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) int8 NHWC, w (KH, KW, C/G, COUT) int8, scale (COUT,) f32
// -> out (B, HO, WO, COUT) f32; pt / pl the top and left pads.
extern "C" int w8a8_conv2d(const int8_t* x, const int8_t* w,
                           const float* scale, float* out, int B, int H,
                           int W, int C, int KH, int KW, int COUT, int HO,
                           int WO, int SH, int SW, int PT, int PL, int DH,
                           int DW, int G, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || KH < 1 || KW < 1 || COUT < 1 ||
      HO < 1 || WO < 1 || SH < 1 || SW < 1 || DH < 1 || DW < 1 || G < 1 ||
      G > 65535 || C % G || COUT % G)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)B * HO * WO;
  const long long k = (long long)KH * KW * (C / G);
  if (m > 0x7fffffffLL || k > 0x7fffffffLL ||
      (COUT / G + kCvBN - 1) / kCvBN > 65535)
    return (int)cudaErrorInvalidValue;
  ConvGeom g{H, W, C, KW, C / G, COUT / G, COUT, HO, WO, SH, SW, PT, PL,
             DH, DW, (int)m, (int)k};
  cudaStream_t s = (cudaStream_t)stream;
  const bool avec = g.CG % 16 == 0 && C % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool bvec = g.NG % 4 == 0 && COUT % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 4 == 0;
  if (avec)
    return (int)(bvec ? launch<true, true>(x, w, scale, out, g, G, s)
                      : launch<true, false>(x, w, scale, out, g, G, s));
  return (int)(bvec ? launch<false, true>(x, w, scale, out, g, G, s)
                    : launch<false, false>(x, w, scale, out, g, G, s));
}

// Dynamic shared memory a block of the kernel
extern "C" int w8a8_conv2d_smem() { return kCvSmem; }
