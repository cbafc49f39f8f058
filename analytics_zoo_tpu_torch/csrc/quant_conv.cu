// The s8 implicit-GEMM convolution for NVIDIA Hopper (sm_90a): the spatial
// branch of the quantized convolution w8a8_conv.
//
// Computes, for int8 NHWC x (B, H, W, C), the int8 weight and f32 scale
// (COUT,) = s_x·s_w:
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
// in (kh, kw, c) order; one group a blockIdx.z.  No im2col buffer exists:
// the loader gathers each A tile from x, zero for a padded position, past
// K and past M.
//  - the weight comes K-major, packed once per layer by the wrapper
//    (ops/quant_matmul.py::pack_conv_weight): (G, COUT/G, Kp) int8, Kp = K
//    rounded up to kCvBK with zeros.  A B tile is kCvBK bytes of BN rows,
//    16-byte cp.async pieces straight into shared memory.
//  - a block computes kCvBM = 128 pixels x BN = 64 or 128 channels with 8
//    warps, s32 accumulators, over stages of kCvBK = 64 k.  A and B rows
//    of 64 bytes are stored with their four 16-byte chunks XOR-swizzled by
//    (row >> 1) & 3: the 64-byte swizzle of wgmma's K-major operands, and
//    the 8 rows of an ldmatrix phase (and the stores) fall in distinct
//    banks.
//  - A, three routes (the kernel's second template argument, AMode):
//    AVEC, where C/G and C are multiples of 16 and x lies on 16 bytes: a
//    16-byte piece of k lies inside one tap and is one cp.async
//    (zero-fill where it is padding or past K).  Products on wgmma
//    (m64nBNk32 s8, IGMMA.64xBNx32.S8.S8: a warpgroup 64 pixels x BN),
//    both operands read from shared memory by descriptor; a 5-stage ring
//    with 3 stages of copies in flight and the previous stage's wgmma
//    still running while the next copies are issued.
//    RUN, where DW = 1, one group and 16 <= KW·C <= 32 (the stem's cin =
//    3: a kernel row's 21 bytes are contiguous in x): the block first
//    stages the input rows its pixels' windows cover (rows [gi_lo, gi_hi]
//    of the (B·H, W·C) view, copied once with 16-byte cp.async) and
//    builds each A piece from them, one chunk of k a warp (the run walk
//    stays uniform), as at most two unaligned 16-byte runs, masked.  The
//    entry point works out how many rows that takes (halo_rows_of).
//    BYTES, every other case (channels or x off 16 bytes where RUN does
//    not apply, or a tile's rows past kCvHaloCap bytes): each byte
//    gathered from x by its own tap.
//    RUN and BYTES build A with plain stores, so their products stay on
//    s8 mma.sync m16n8k32 (IMMA.16832.S8.S8, fragments by ldmatrix.x4,
//    warps of 32 x BN/2) over a 3-stage ring: wgmma would need a proxy
//    fence after every built stage, which measured slower on the stem.
//  - split-K: a launch may run each output tile on a thread-block cluster
//    of `split` blocks (1, 2, 4 or 8: a portable cluster), block r of the
//    cluster taking the r-th slice of the k-tiles.  For the deep convs
//    (M·N / tile too few to fill the 132 SMs) this multiplies the blocks
//    and divides the serial k-steps of each.  The partial sums merge
//    through distributed shared memory: each block stages its s32 tile,
//    then block r sums rows [r·BM/split, (r+1)·BM/split) over the blocks
//    of the cluster and writes them.  One launch a convolution, no
//    workspace.  The rule that picks BN and split is conv_config in
//    ops/quant_matmul.py.
//  - the epilogue stages the s32 tile in shared memory (row pitch BN + 8
//    words: the int2 stores of a half-warp fall in distinct banks) and
//    writes each row as 16-byte pieces (4 channels), the scale read once
//    per column; scalar stores where COUT or COUT/G is off 4.
//  - the s32 sum is exact in any order (|sum| <= 128·128·K < 2^31 for K
//    <= 131071), so the split and the merge change nothing, and the
//    epilogue is one cvt.rn and one f32 multiply: the result is bitwise
//    that of the plain version (ops/quant_matmul.py::w8a8_conv_torch) and
//    of the JAX package.
// What bounds it on the card: bytes, mostly its f32 output (the stem of
// ResNet-50 at a batch of 16 reads 2.4 MB and writes 51.4 MB), except the
// deep 3x3 convs of stages 3-4, whose 2·M·N·K operations at the int8 rate
// are at or above the bytes; there the split keeps every SM busy.
//
// C interface, loaded with ctypes (analytics_zoo_tpu_torch/ops/_build.py):
// the entry point launches on the given stream, allocates nothing, and
// returns the CUDA error of the launch (0 = launched).  x, the pack and
// out are contiguous, the pack on 16 bytes.

#include <cooperative_groups.h>
#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCvBM = 128;                 // output pixels a tile
constexpr int kCvBK = 64;                  // k a stage; the pack's k granule
constexpr int kCvBNSmall = 64;             // output channels a tile: the
constexpr int kCvBNLarge = 128;            // two configs
constexpr int kCvThreads = 256;            // 8 warps: 4 along M x 2 along N
constexpr int kCvStages = 5;               // the cp.async ring (AVEC)
constexpr int kCvStagesBytes = 3;          // the ring of the built routes
constexpr int kCvMaxSplit = 8;             // blocks a cluster (portable)
constexpr int kCvTileA = kCvBM * kCvBK;    // bytes of an A stage
constexpr int kCvOutPad = 8;               // s32 words past a staged row
constexpr int kCvHaloCap = 65536;          // bytes of input rows a block
static_assert(kCvBM * kCvBK / 16 == 2 * kCvThreads,
              "two 16-byte pieces of A a thread");
static_assert(kCvBM % kCvMaxSplit == 0, "a split divides the tile's rows");

// A planted fault, built only by chip_smoke.py (-DCV_MERGE_SKIP=1) to show
// that its bitwise check sees a lost partial: the merge leaves out the
// block q places after its own.  0, the default, leaves out none.
#ifndef CV_MERGE_SKIP
#define CV_MERGE_SKIP 0
#endif

// How a block fills its A stages (the route w8a8_conv2d_kernel's second
// template argument names): copies from x; gathers from x; runs from
// staged input rows (build16_run)
enum AMode { kAVec = 0, kABytes = 1, kARun = 2 };

struct ConvGeom {
  int H, W, C, KH, KW, CG, NG, COUT, HO, WO, SH, SW, PT, PL, DH, DW, M, K,
      Kp;
  int split;       // blocks a cluster, one K slice each
  int halo_rows;   // RUN: the most input rows a block stages
};

__host__ __device__ constexpr int stage_bytes(int bn) {
  return kCvTileA + bn * kCvBK;
}

// Stages of the ring: where A is copied, three stages of copies in flight
// (each takes a round trip to L2 or device memory), one in use, one left
// to the wgmma still reading it; where A is built, the stem's K is three
// stages
__host__ __device__ constexpr int ring_stages(int amode) {
  return amode == kAVec ? kCvStages : kCvStagesBytes;
}

// Shared memory before the halo: the ring, or the staged s32 output tile
__host__ __device__ constexpr int ring_bytes(int bn, int amode) {
  return ring_stages(amode) * stage_bytes(bn) > kCvBM * (bn + kCvOutPad) * 4
             ? ring_stages(amode) * stage_bytes(bn)
             : kCvBM * (bn + kCvOutPad) * 4;
}

// Dynamic shared memory of a launch: room to align the ring to 1024
// (AVEC: wgmma reads it), the ring, the halo
inline int smem_bytes(int bn, int amode, int halo) {
  return (amode == kAVec ? 1024 : 0) + ring_bytes(bn, amode) + halo;
}

// Bytes of a halo of `rows` rows of w_c bytes: the rows, a 16-byte chunk
// on each side (the copy is on 16 bytes of the global address), and 32
// bytes past them for build16_run's word loads
inline int halo_bytes(int rows, int w_c) {
  return rows > 0 ? ((rows * w_c + 64 + 15) / 16) * 16 : 0;
}

// Byte offset of chunk (16 bytes) `chunk` of row `row` in a 64-byte-row
// tile: the chunks XOR-swizzled by (row >> 1) & 3
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kCvBK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint8_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// wgmma's descriptor of a K-major operand in the 64-byte swizzle (the
// layout swz() writes): rows of 64 bytes, 8-row groups 512 bytes apart;
// the start may sit 32 bytes into a row (the second k-step), the hardware
// swizzles the absolute address
__device__ __forceinline__ uint64_t sw64_desc(const uint8_t* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4)     // start address
         | (uint64_t)1 << 16                 // leading offset (unused)
         | (uint64_t)(512 >> 4) << 32        // stride of 8-row groups
         | (uint64_t)2 << 62;                // 64-byte swizzle
}

// D (64 x N, s32) += A (64 x 32, s8) · B (32 x N, s8), both from shared
// memory: wgmma.mma_async m64nNk32 (IGMMA.64xNx32.S8.S8).  Thread t of the
// warpgroup holds d[4j + e] = D[16·(t / 32) + (t % 32) / 4 + 8·(e >> 1),
// 8j + 2·(t % 4) + (e & 1)].
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Where an output pixel's window starts in x
struct Pixel {
  long long base;   // x offset of its image and of its group's channels
  int hrow;         // RUN: its image's row 0 as a row of the halo
  int ih0, iw0;     // top-left tap (may be negative: padding)
  bool ok;          // a pixel inside M
};

__device__ __forceinline__ Pixel pixel(const ConvGeom& g, int m, int grp,
                                       int gi_lo) {
  Pixel p;
  p.ok = m < g.M;
  const int mm = p.ok ? m : 0;
  const int hw = g.HO * g.WO;
  const int img = mm / hw, rem = mm % hw;
  p.base = (long long)img * g.H * g.W * g.C + (long long)grp * g.CG;
  p.hrow = img * g.H - gi_lo;
  p.ih0 = (rem / g.WO) * g.SH - g.PT;
  p.iw0 = (rem % g.WO) * g.SW - g.PL;
  return p;
}

// (c, kw, kh) of contraction index k
struct Tap {
  int c, kw, kh;
};

__device__ __forceinline__ Tap tap_of(const ConvGeom& g, int k) {
  const int t = k / g.CG;
  return {k - t * g.CG, t % g.KW, t / g.KW};
}

__device__ __forceinline__ void next_tap(const ConvGeom& g, Tap& t) {
  if (++t.c == g.CG) {
    t.c = 0;
    if (++t.kw == g.KW) {
      t.kw = 0;
      ++t.kh;
    }
  }
}

// BYTES: the 16 bytes k .. k + 15 of pixel p's A row, each gathered
// from x by its own (kh, kw, c)
__device__ __forceinline__ uint4 gather16(const int8_t* __restrict__ x,
                                          const ConvGeom& g, const Pixel& p,
                                          int k) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  Tap t = tap_of(g, k);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int ih = p.ih0 + t.kh * g.DH, iw = p.iw0 + t.kw * g.DW;
    if (p.ok && k + e < g.K && ih >= 0 && ih < g.H && iw >= 0 &&
        iw < g.W) {
      const uint32_t b = (uint8_t)__ldg(
          x + p.base + ((long long)ih * g.W + iw) * g.C + t.c);
      v[e >> 2] |= b << (8 * (e & 3));
    }
    next_tap(g, t);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// RUN: where a pixel's window lies in the staged rows: the offset of its
// top-left tap (meaningful where a mask bit is set), the mask of its
// kernel rows inside the image and the halo (bit kh) and that of a kernel
// row's run inside the image (bit j: byte j); KH, KW <= 32
struct Window {
  int base;
  uint32_t rows;
  uint32_t run;
};

__device__ __forceinline__ Window window(const ConvGeom& g, const Pixel& p,
                                         int hoff, int nrows) {
  Window w{(p.hrow + p.ih0) * (g.W * g.C) + p.iw0 * g.C + hoff, 0u, 0u};
  uint32_t cols = 0u;
  for (int kh = 0; kh < g.KH; ++kh) {
    const int ih = p.ih0 + kh * g.DH;
    if (p.ok && ih >= 0 && ih < g.H && (unsigned)(p.hrow + ih) <
        (unsigned)nrows)
      w.rows |= 1u << kh;
  }
  for (int kw = 0; kw < g.KW; ++kw) {
    const int iw = p.iw0 + kw * g.DW;
    if (iw >= 0 && iw < g.W) cols |= 1u << kw;
  }
  // with DW = 1 the inside columns are one range [lo, hi), so the inside
  // bytes of a run are [C·lo, C·hi)
  if (cols) {
    const int lo = __ffs(cols) - 1, hi = 32 - __clz(cols);
    w.run = (uint32_t)(((1ull << (g.C * hi)) - 1ull) &
                       ~((1ull << (g.C * lo)) - 1ull));
  }
  return w;
}

// Bytes a .. a + 15 of the halo as four words, from the five aligned words
// around them (a may be off 4)
__device__ __forceinline__ uint4 load16u(const uint8_t* halo, int a) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(halo + (a & ~3));
  const int sh = 8 * (a & 3);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// A 32-bit mask whose byte i is 0xff where bit i of the nibble is set
__device__ __forceinline__ uint32_t byte_mask(uint32_t nibble) {
  return ((nibble * 0x00204081u) & 0x01010101u) * 0xffu;
}

// RUN (DW = 1, one group and 16 <= KW·C <= 32; the stem's KW·C is 21): a
// kernel row's KW·C bytes (kw, c) are R = KW·C contiguous bytes of the
// staged input row, so a 16-byte piece of k is at most two runs, each
// loaded as 16 bytes (load16u) and kept where its kernel row, its columns
// (the run mask) and k < K allow
__device__ __forceinline__ void build16_run(uint4 (&out)[2],
                                            const uint8_t* halo,
                                            const ConvGeom& g,
                                            const Window (&wd)[2], int k) {
  const int R = g.KW * g.C, wc = g.W * g.C;
  const int kh0 = k / R, j0 = k - kh0 * R;
  const int n1 = min(16, R - j0);           // bytes from row kh0, then kh0 + 1
  const uint32_t first = (1u << n1) - 1u;   // n1 <= 16
  const uint32_t kin = k >= g.K ? 0u
                       : k + 16 <= g.K ? 0xffffu
                                       : (1u << (g.K - k)) - 1u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t m = 0u;
    if (kin) {
      if ((wd[h].rows >> kh0) & 1u) m |= (wd[h].run >> j0) & first;
      if (kh0 + 1 < 32 && ((wd[h].rows >> (kh0 + 1)) & 1u))
        m |= (wd[h].run << n1) & 0xffffu & ~first;
      m &= kin;
    }
    uint4 p1 = make_uint4(0u, 0u, 0u, 0u), p2 = p1;
    if (m & first) p1 = load16u(halo, wd[h].base + kh0 * g.DH * wc + j0);
    if (m & ~first)
      p2 = load16u(halo, wd[h].base + (kh0 + 1) * g.DH * wc - n1);
    const uint32_t a1[4] = {p1.x, p1.y, p1.z, p1.w};
    const uint32_t a2[4] = {p2.x, p2.y, p2.z, p2.w};
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t sel = byte_mask((first >> (4 * q)) & 15u);
      v[q] = ((a1[q] & sel) | (a2[q] & ~sel)) &
             byte_mask((m >> (4 * q)) & 15u);
    }
    out[h] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// blocks an SM the registers must allow: three of 64 channels, two of 128
// (the byte gathers of BYTES, a rare route, take one)
template <int BN, int AMODE>
constexpr int kMinBlocks = AMODE == kABytes ? 1 : BN == kCvBNSmall ? 3 : 2;

// grid (ceil(M / kCvBM) · split, ceil(NG / BN), G), clusters of (split, 1,
// 1) when split > 1, block kCvThreads, dynamic shared memory
// smem_bytes(BN, AMODE, halo_bytes(halo_rows, W·C)) (plan).
template <int BN, int AMODE>
__global__ void __launch_bounds__(kCvThreads, (kMinBlocks<BN, AMODE>))
w8a8_conv2d_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ wp,
                   const float* __restrict__ scale, float* __restrict__ out,
                   ConvGeom g) {
  // AVEC: the ring on 1024 bytes (wgmma's swizzle atoms repeat every 512)
  extern __shared__ __align__(128) uint8_t cv_smem_raw[];
  uint8_t* cv_smem = reinterpret_cast<uint8_t*>(
      AMODE == kAVec ? (reinterpret_cast<uintptr_t>(cv_smem_raw) + 1023) &
                           ~(uintptr_t)1023
                     : reinterpret_cast<uintptr_t>(cv_smem_raw));
  constexpr int kStage = stage_bytes(BN);
  constexpr int S = ring_stages(AMODE);
  constexpr int NI = BN / 16;              // n8 tiles of a warp's BN / 2
  constexpr int BP = BN * 4 / kCvThreads;  // B pieces a thread: 1 or 2
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;   // mma group, thread in group
  const int wm = warp & 3, wn = warp >> 2;   // the warp's 32 x BN/2 part
  const int split = g.split;
  const int rank = blockIdx.x % split;
  const int m0 = (blockIdx.x / split) * kCvBM, n0 = blockIdx.y * BN;
  const int grp = blockIdx.z;
  const int col0 = grp * g.NG;               // the group's first channel

  // this block's K slice: k-tiles [kt0, kt0 + nk)
  const int KT = g.Kp / kCvBK;
  const int per = (KT + split - 1) / split;
  const int kt0 = min(KT, rank * per);
  const int nk = min(KT, kt0 + per) - kt0;

  // RUN: the input rows the tile's windows cover, as rows of the
  // (B·H, W·C) view: from the first pixel's top tap (clamped into its
  // image) to the last pixel's bottom tap (clamped likewise); halo_rows
  // is at least as many as any tile spans (halo_rows_of)
  uint8_t* halo = cv_smem + ring_bytes(BN, AMODE);
  int gi_lo = 0, nrows = 0, hoff = 0;
  if constexpr (AMODE == kARun) {
    const int hw = g.HO * g.WO;
    const int first = m0, last = min(m0 + kCvBM, g.M) - 1;
    const int ia = first / hw, ha = (first % hw) / g.WO;
    const int ib = last / hw, hb = (last % hw) / g.WO;
    gi_lo = ia * g.H + min(max(ha * g.SH - g.PT, 0), g.H);
    const int gi_hi =
        ib * g.H + min(max(hb * g.SH - g.PT + (g.KH - 1) * g.DH, -1),
                       g.H - 1);
    nrows = min(gi_hi - gi_lo + 1, g.halo_rows);
    const long long wc = (long long)g.W * g.C;
    const uintptr_t xs = reinterpret_cast<uintptr_t>(x + gi_lo * wc);
    const uintptr_t a0 = xs & ~(uintptr_t)15;
    hoff = (int)(xs - a0) + grp * g.CG;
    if (nrows > 0) {
      const uintptr_t xe = xs + (uintptr_t)(nrows * wc);
      const int nch = (int)((xe + 15 - a0) >> 4);
      for (int ch = tid; ch < nch; ch += kCvThreads) {
        const uintptr_t ga = a0 + 16 * (uintptr_t)ch;
        uint8_t* dst = halo + 16 * ch;
        if (ga >= xs && ga + 16 <= xe) {
          cp_async<16>(dst, reinterpret_cast<const void*>(ga), true);
        } else {
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (ga + b >= xs && ga + b < xe)
              dst[b] = *reinterpret_cast<const uint8_t*>(ga + b);
        }
      }
    }
    cp_commit();
    cp_wait_all();
    __syncthreads();
  }

  // A: this thread's pieces are chunk ca of rows ra and ra + 64; four
  // lanes a row where they copy or gather from x (16-byte pieces of a
  // pixel side by side), one chunk a warp where they build from staged
  // rows (every lane of a warp the same k, so the run walk does not
  // diverge)
  const int ca = AMODE == kARun ? warp & 3 : tid & 3;
  const int ra = AMODE == kARun ? 32 * (warp >> 2) + lane : tid >> 2;
  const Pixel px[2] = {pixel(g, m0 + ra, grp, gi_lo),
                       pixel(g, m0 + ra + 64, grp, gi_lo)};
  Window wd[2];
  if constexpr (AMODE == kARun) {
    wd[0] = window(g, px[0], hoff, nrows);
    wd[1] = window(g, px[1], hoff, nrows);
  }
  // AVEC: the tap of k = 64·kt + 16·ca, advanced a stage at a time
  Tap ta = tap_of(g, kt0 * kCvBK + 16 * ca);

  auto load_stage = [&](int slot, int kt) {
    uint8_t* sa = cv_smem + slot * kStage;
    uint8_t* sb = sa + kCvTileA;
    const int k = kt * kCvBK + 16 * ca;
    if constexpr (AMODE == kAVec) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ih = px[h].ih0 + ta.kh * g.DH;
        const int iw = px[h].iw0 + ta.kw * g.DW;
        const bool in = px[h].ok && k < g.K && ih >= 0 && ih < g.H &&
                        iw >= 0 && iw < g.W;
        const int8_t* src =
            in ? x + px[h].base + ((long long)ih * g.W + iw) * g.C + ta.c
               : x;
        cp_async<16>(sa + swz(ra + 64 * h, ca), src, in);
      }
      // k + 64: C/G >= 16, so at most 4 taps on
      ta.c += kCvBK;
      while (ta.c >= g.CG) {
        ta.c -= g.CG;
        if (++ta.kw == g.KW) {
          ta.kw = 0;
          ++ta.kh;
        }
      }
    } else if constexpr (AMODE == kARun) {
      uint4 v[2];
      build16_run(v, halo, g, wd, k);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint4*>(sa + swz(ra + 64 * h, ca)) = v[h];
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint4*>(sa + swz(ra + 64 * h, ca)) =
            gather16(x, g, px[h], k);
    }
#pragma unroll
    for (int h = 0; h < BP; ++h) {
      const int q = tid + kCvThreads * h;
      const int nb = q >> 2, cb = q & 3;
      const bool in = n0 + nb < g.NG;
      const int8_t* src =
          in ? wp + (long long)(col0 + n0 + nb) * g.Kp + kt * kCvBK + 16 * cb
             : wp;
      cp_async<16>(sb + swz(nb, cb), src, in);
    }
  };

  // s32 sums: AVEC's wgmma fragments (warpgroup wg: pixels 64·wg ..
  // + 63, all BN channels), else mma.sync's (i2, j) tiles of the warp's
  // 32 x BN/2 part
  int acc[BN / 2];
  int accm[2][NI][4];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accm[i][j][e] = 0;
  const int wg = warp >> 2;

  // stages in flight ahead of the one in use: AVEC also leaves one stage
  // to the wgmma still running (its products overlap the next stage's
  // barrier and copies), so a slot is refilled two stages after its use
  constexpr int AHEAD = AMODE == kAVec ? S - 2 : S - 1;
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nk) load_stage(s, kt0 + s);
    cp_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_wait<AHEAD - 1>();
    // wgmma reads shared memory through the async proxy: the copies
    // landed by the generic one are fenced first
    if constexpr (AMODE == kAVec)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the slot stage i + AHEAD takes was last read by stage i - 1 (i - 2
    // with wgmma): every warp passed the barrier after those products
    const int nxt = i + AHEAD;
    if (nxt < nk) load_stage(nxt % S, kt0 + nxt);
    cp_commit();
    const uint8_t* sa = cv_smem + (i % S) * kStage;
    const uint8_t* sb = sa + kCvTileA;
    if constexpr (AMODE == kAVec) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < kCvBK / 32; ++s)
        wgmma_s8(acc, sw64_desc(sa + 64 * kCvBK * wg + 32 * s),
                 sw64_desc(sb + 32 * s));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      continue;
    }
#pragma unroll
    for (int s = 0; s < kCvBK / 32; ++s) {
      // ldmatrix.x4: lanes 8q .. 8q + 7 address matrix q's 8 rows
      uint32_t af[2][4], bf[NI][2];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int row = 32 * wm + 16 * i2 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldsm4(af[i2], sa + swz(row, 2 * s + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        const int row = (BN / 2) * wn + 16 * j + (lane & 7) + 8 * (lane >> 4);
        uint32_t r[4];
        ldsm4(r, sb + swz(row, 2 * s + ((lane >> 3) & 1)));
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_s8(accm[i2][j], af[i2][0], af[i2][1], af[i2][2], af[i2][3],
                 bf[j][0], bf[j][1]);
    }
  }
  if constexpr (AMODE == kAVec)
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  cp_wait_all();
  __syncthreads();   // every warp is done with the ring

  // stage the s32 tile: element e of fragment f is pixel (wgmma) 64·wg +
  // 16·(warp & 3) + gq + 8·(e >> 1), channel 8·f + 2·tq + (e & 1), or
  // (mma.sync, f = NI·i2 + j) pixel 32·wm + 16·i2 + gq + 8·(e >> 1),
  // channel BN/2·wn + 8·j + 2·tq + (e & 1)
  constexpr int P = BN + kCvOutPad;
  int* st = reinterpret_cast<int*>(cv_smem);
#pragma unroll
  for (int f = 0; f < BN / 8; ++f)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = AMODE == kAVec
                          ? 64 * wg + 16 * (warp & 3) + gq + 8 * hf
                          : 32 * wm + 16 * (f / NI) + gq + 8 * hf;
      const int col = AMODE == kAVec ? 8 * f + 2 * tq
                                     : (BN / 2) * wn + 8 * (f % NI) + 2 * tq;
      const int* c = AMODE == kAVec ? acc + 4 * f : accm[f / NI][f % NI];
      *reinterpret_cast<int2*>(st + row * P + col) =
          make_int2(c[2 * hf], c[2 * hf + 1]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();

  // rows [r0, r0 + rows) of the tile: the sum over the cluster's blocks,
  // converted, scaled, written as 16-byte pieces (4 channels a thread,
  // the same 4 for every row it writes)
  constexpr int QP = BN / 4;                  // pieces a row
  const int rows = kCvBM / split, r0 = rank * rows;
  const int n = n0 + 4 * (tid % QP);
  const bool vec = (g.COUT & 3) == 0 && (g.NG & 3) == 0;
  float sc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) sc[e] = n + e < g.NG ? scale[col0 + n + e] : 0.f;
  // the other blocks' tiles: every remote load of a row issued before
  // the first sum (distributed shared memory is a round trip each)
  const int* peer[kCvMaxSplit - 1];
#pragma unroll
  for (int q = 1; q < kCvMaxSplit; ++q)
    peer[q - 1] = q < split ? cluster.map_shared_rank(st, (rank + q) % split)
                            : st;
  for (int r = r0 + tid / QP; r < r0 + rows; r += kCvThreads / QP) {
    const int off = r * P + 4 * (tid % QP);
    int4 u[kCvMaxSplit - 1];
#pragma unroll
    for (int q = 1; q < kCvMaxSplit; ++q)
      if (q < split) u[q - 1] = *reinterpret_cast<const int4*>(peer[q - 1] + off);
    int4 v = *reinterpret_cast<const int4*>(st + off);
#pragma unroll
    for (int q = 1; q < kCvMaxSplit; ++q)
      if (q < split && q != CV_MERGE_SKIP) {
        v.x += u[q - 1].x;
        v.y += u[q - 1].y;
        v.z += u[q - 1].z;
        v.w += u[q - 1].w;
      }
    const int m = m0 + r;
    if (m >= g.M || n >= g.NG) continue;
    float* orow = out + (long long)m * g.COUT + col0;
    const float o[4] = {__int2float_rn(v.x) * sc[0],
                        __int2float_rn(v.y) * sc[1],
                        __int2float_rn(v.z) * sc[2],
                        __int2float_rn(v.w) * sc[3]};
    if (vec) {
      *reinterpret_cast<float4*>(orow + n) = make_float4(o[0], o[1], o[2],
                                                         o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < g.NG) orow[n + e] = o[e];
    }
  }
  // the other blocks' staged tiles must outlive this block's reads
  if (split > 1) cluster.sync();
}

template <int BN, int AMODE>
cudaError_t launch(const int8_t* x, const int8_t* wp, const float* scale,
                   float* out, const ConvGeom& g, int groups, int smem,
                   cudaStream_t s) {
  auto kern = w8a8_conv2d_kernel<BN, AMODE>;
  // once: the most any launch of this instantiation takes, and the
  // largest carveout (two blocks an SM)
  static const cudaError_t once = [] {
    const int most =
        smem_bytes(BN, AMODE, AMODE == kARun ? kCvHaloCap + 64 : 0);
    cudaError_t e = cudaFuncSetAttribute(
        w8a8_conv2d_kernel<BN, AMODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(w8a8_conv2d_kernel<BN, AMODE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (once != cudaSuccess) return once;
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((g.M + kCvBM - 1) / kCvBM) * g.split),
                     (unsigned)((g.NG + BN - 1) / BN), (unsigned)groups);
  cfg.blockDim = dim3(kCvThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, x, wp, scale, out, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bn(int amode, const int8_t* x, const int8_t* wp,
                      const float* scale, float* out, const ConvGeom& g,
                      int groups, int smem, cudaStream_t s) {
  switch (amode) {
    case kAVec:
      return launch<BN, kAVec>(x, wp, scale, out, g, groups, smem, s);
    case kARun:
      return launch<BN, kARun>(x, wp, scale, out, g, groups, smem, s);
    default:
      return launch<BN, kABytes>(x, wp, scale, out, g, groups, smem, s);
  }
}

// RUN: rows of the (B·H, W·C) view that cover every tile's windows.  A
// tile's span depends only on where in an image it starts (the last
// pixel is capped at M - 1, which only shortens it), tile starts fall on
// multiples of gcd(kCvBM, HO·WO) there, and within one output row the
// latest start spans the most; so the most over the last such start of
// each output row bounds every tile (and equals it once the batch holds
// every start).
long long halo_rows_of(long long M, int H, int KH, int HO, int WO, int SH,
                       int PT, int DH) {
  const long long hw = (long long)HO * WO;
  long long a = kCvBM, b = hw;
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  long long most = 0;
  for (long long ho = 0; ho < HO; ++ho) {
    const long long first = ((ho + 1) * WO - 1) / a * a;
    if (first < ho * WO) continue;
    const long long last = std::min(first + kCvBM - 1, M - 1);
    const long long lo = std::min(std::max(ho * SH - PT, 0LL), (long long)H);
    const long long hb = (last % hw) / WO;
    const long long hi =
        last / hw * H +
        std::min(std::max(hb * SH - PT + (KH - 1LL) * DH, -1LL), H - 1LL);
    most = std::max(most, hi - lo + 1);
  }
  return most;
}

struct Plan {
  ConvGeom g;
  int amode, smem;
};

// The geometry, the A route and the shared memory of a launch, or false
// where the arguments are out of the kernel's range; x16: x lies on 16
// bytes
bool plan(int B, int H, int W, int C, int KH, int KW, int COUT, int HO,
          int WO, int SH, int SW, int PT, int PL, int DH, int DW, int G,
          int bn, int split, bool x16, Plan& p) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || KH < 1 || KW < 1 || COUT < 1 ||
      HO < 1 || WO < 1 || SH < 1 || SW < 1 || DH < 1 || DW < 1 || G < 1 ||
      G > 65535 || C % G || COUT % G || (bn != kCvBNSmall && bn != kCvBNLarge)
      || split < 1 || split > kCvMaxSplit || (split & (split - 1)))
    return false;
  const long long m = (long long)B * HO * WO;
  const long long k = (long long)KH * KW * (C / G);
  const long long kp = (k + kCvBK - 1) / kCvBK * kCvBK;
  const long long wc = (long long)W * C;
  if (m > 0x7fffffffLL || kp > 131071 || (long long)B * H > 0x7fffffffLL ||
      ((m + kCvBM - 1) / kCvBM) * split > 0x7fffffffLL ||
      (COUT / G + bn - 1) / bn > 65535)
    return false;
  const bool avec = C / G % 16 == 0 && C % 16 == 0 && x16;
  // RUN: masks of 32 kernel rows, int offsets into the staged rows, and
  // the rows within kCvHaloCap bytes
  long long rows = 0;
  if (!avec && DW == 1 && G == 1 && KW * C >= 16 && KW * C <= 32 &&
      KH <= 32 && (long long)KH * DH * wc + KW * C < 0x40000000LL) {
    rows = halo_rows_of(m, H, KH, HO, WO, SH, PT, DH);
    if (rows * wc + 16 > kCvHaloCap) rows = 0;
  }
  p.g = ConvGeom{H,  W,  C,  KH, KW, C / G,  COUT / G, COUT,   HO, WO,
                 SH, SW, PT, PL, DH, DW, (int)m, (int)k, (int)kp, split,
                 (int)rows};
  p.amode = avec ? kAVec : rows > 0 ? kARun : kABytes;
  p.smem = smem_bytes(bn, p.amode, halo_bytes((int)rows, (int)wc));
  return true;
}

}  // namespace

// x (B, H, W, C) int8 NHWC, w_pack (G, COUT/G, Kp) int8 (K-major, Kp = K
// rounded up to 64), scale (COUT,) f32 -> out (B, HO, WO, COUT) f32; pt /
// pl the top and left pads; bn (64 | 128) and split (1 | 2 | 4 | 8) the
// tile's channels and the blocks of its cluster.
extern "C" int w8a8_conv2d(const int8_t* x, const int8_t* w_pack,
                           const float* scale, float* out, int B, int H,
                           int W, int C, int KH, int KW, int COUT, int HO,
                           int WO, int SH, int SW, int PT, int PL, int DH,
                           int DW, int G, int bn, int split, void* stream) {
  Plan p;
  if (reinterpret_cast<uintptr_t>(w_pack) % 16 ||
      !plan(B, H, W, C, KH, KW, COUT, HO, WO, SH, SW, PT, PL, DH, DW, G, bn,
            split, reinterpret_cast<uintptr_t>(x) % 16 == 0, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bn == kCvBNSmall
                   ? launch_bn<kCvBNSmall>(p.amode, x, w_pack, scale, out,
                                           p.g, G, p.smem, s)
                   : launch_bn<kCvBNLarge>(p.amode, x, w_pack, scale, out,
                                           p.g, G, p.smem, s));
}

// Dynamic shared memory a block of the launch w8a8_conv2d would make with
// these arguments and an x on 16 bytes (x16 = 1) or off them; -1 where it
// would refuse them
extern "C" int w8a8_conv2d_smem(int B, int H, int W, int C, int KH, int KW,
                                int COUT, int HO, int WO, int SH, int SW,
                                int PT, int PL, int DH, int DW, int G, int bn,
                                int split, int x16) {
  Plan p;
  return plan(B, H, W, C, KH, KW, COUT, HO, WO, SH, SW, PT, PL, DH, DW, G, bn,
              split, x16 != 0, p)
             ? p.smem
             : -1;
}
