// The tensor-core building blocks shared by the port's Hopper (sm_90a)
// kernels: 3xTF32 mma.sync products with f32 partial sums, cp.async copies
// with zero-fill, the split operand layouts and their fragment loaders, the
// bf16 mma, and the s8 mma (m16n8k32) with its 4 x 4 byte transpose.
// Included by flash_attention_bwd.cu, flash_attention.cu, fused_bn.cu,
// quant_matmul.cu and quant_conv.cu; everything here has internal linkage
// (ops/_build.py hashes every csrc/*.cuh into each library's name, so an
// edited header rebuilds them).
//
// 3xTF32: an f32 operand x is split into big = rna(x) and small =
// rna(x − big) (rna: cvt.rna.tf32.f32), and a·b is accumulated as
// big·small + small·big, then big·big, which keeps f32 accuracy on the
// TF32 tensor cores; one TF32 product alone is ~1e-3 off.  A widened bf16
// value is exact in TF32, so its small part is zero and those products
// are skipped (EXACT / AX / BX below).  The tensor core aligns an mma's
// terms to the largest and truncates the sum to 24 bits (mma_probe.py), so
// a running sum must not be an mma's C operand for long: products sum a
// few k-steps into a zeroed partial that an f32 add puts into the sum.
//
// Block-wide loops take the block's thread count THREADS as a template
// argument.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T>
struct Elt;
template <>
struct Elt<float> {
  static constexpr bool exact = false;   // needs a small part in TF32
  static constexpr int copy = 16;        // bytes a cp.async
};
template <>
struct Elt<__nv_bfloat16> {
  static constexpr bool exact = true;
  static constexpr int copy = 8;
};

// Copy the first n bytes (0 <= n <= BYTES) of a BYTES chunk and zero-fill
// the rest of it (cp.async's src-size operand: with n = 0 nothing is read)
template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, int n) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(src), "n"(BYTES), "r"(n) : "memory");
}

// The whole chunk, or (in = false) zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  cp_async_n<BYTES>(dst, src, in ? BYTES : 0);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy rows [t0, t0 + ROWS) of one (b, h) slice into a raw row-major tile
// (pitch D); rows at or past T are zero-filled.
template <int THREADS, typename T, int D, int ROWS>
__device__ __forceinline__ void load_raw(T* raw, const T* src, long long st,
                                         int t0, int T_) {
  constexpr int E = Elt<T>::copy / (int)sizeof(T);   // elements a copy
  constexpr int PER_ROW = D / E;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * E;
    const bool in = t0 + r < T_;
    cp_async<Elt<T>::copy>(raw + r * D + c,
                           in ? src + (long long)(t0 + r) * st + c : src, in);
  }
}

// cvt.rna.tf32.f32 of a finite x (round to nearest, ties away from zero:
// add half a TF32 unit to the magnitude's bits and clear the 13 low bits)
// in two integer instructions; the conversion instruction itself costs
// several on sm_90
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small in TF32 (x − big is exact in f32); an exact operand
// (widened bf16) has no small part
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if constexpr (EXACT) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    big = tf32(x);
    small = tf32(x - __uint_as_float(big));
  }
}

// Split tiles hold every element as its (big, small) pair, in one of two
// layouts.  Row layout (tiles read as B operands): elements c and c + 1 of
// row r form the 16-byte chunk (big c, big c + 1, small c, small c + 1),
// stored at chunk (c / 2) ^ sw(r) of the row; the swizzle keeps every
// 16-byte fragment load free of bank conflicts at D = 64 (see the header).
// The A layout is described at split_frags.
template <int D>
__device__ __forceinline__ int sw(int r) {
  return (((r & 1) << 2) | ((r >> 1) & 3)) & (D / 2 - 1);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Split every element of a raw ROWS x D tile, once, so that the fragments
// of every warp and every product load it ready-made: the row layout.
template <int THREADS, typename T, int D, int ROWS>
__device__ __forceinline__ void split_rows(uint32_t* tile, const T* raw) {
  constexpr bool X = Elt<T>::exact;
  for (int i = threadIdx.x; i < ROWS * D / 4; i += THREADS) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    const float4 f = load4(raw + r * D + c);
    uint4 lo, hi;
    split<X>(f.x, lo.x, lo.z);
    split<X>(f.y, lo.y, lo.w);
    split<X>(f.z, hi.x, hi.z);
    split<X>(f.w, hi.y, hi.w);
    uint32_t* row = tile + r * 2 * D;
    *reinterpret_cast<uint4*>(row + (((c >> 1) ^ sw<D>(r)) << 2)) = lo;
    *reinterpret_cast<uint4*>(row + ((((c >> 1) + 1) ^ sw<D>(r)) << 2)) = hi;
  }
}

// The A layout (tiles read as A operands, ROWS a multiple of 16): for each
// 16-row group and k-step m, 32 lanes' big quads, then their small quads;
// lane (g, t) holds rows g, g + 8 at slot t, then rows g, g + 8 at slot
// t + 4, which is the mma's A register order, slot t being column
// 8m + 2t and slot t + 4 column 8m + 2t + 1 (the order of frag_b_rows).
// Each element is taken times mul first (q·scale in the forward); X: the
// products are exact TF32 values (no small part).
template <int THREADS, typename T, int D, int ROWS, bool X = Elt<T>::exact>
__device__ __forceinline__ void split_frags(uint32_t* tile, const T* raw,
                                            float mul = 1.f) {
  for (int i = threadIdx.x; i < ROWS * D / 4; i += THREADS) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    const float4 f = load4(raw + r * D + c);
    const float x[4] = {f.x * mul, f.y * mul, f.z * mul, f.w * mul};
    uint32_t* q = tile + ((r >> 4) * (D / 8) + (c >> 3)) * 256 +
                  ((r & 7) * 4 + ((c & 7) >> 1)) * 4 + ((r >> 3) & 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // column c + e: slot t + (e >> 1), half e & 1
      uint32_t big, small;
      split<X>(x[e], big, small);
      q[(e >> 1) * 4 + 2 * (e & 1)] = big;
      q[(e >> 1) * 4 + 2 * (e & 1) + 128] = small;
    }
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b for bf16 operands: m16n8k16, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p += a·b in 3xTF32: the two correction products first, then big·big
template <bool AX, bool BX>
__device__ __forceinline__ void mma3_into(float (&p)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          const uint32_t (&bb)[2],
                                          const uint32_t (&bs)[2]) {
  if constexpr (!BX) mma(p, ab, bs);
  if constexpr (!AX) mma(p, as, bb);
  mma(p, ab, bb);
}

// c += a·b through a zeroed partial that one f32 add (round to nearest)
// puts into c.  The tensor core aligns the terms of an mma to the largest
// one and truncates the sum to 24 bits (mma_probe.py), so a running sum fed
// back as the C operand loses up to an ulp of itself at every step, which
// took dv past the f32 tolerance at T = 1000; a partial loses ulps of
// itself only.
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma3_into<AX, BX>(p, ab, as, bb, bs);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}

// A lane's word offsets into split tiles, computed once.  Products over the
// head dimension take its 8 columns c0 .. c0 + 7 in the order slot t =
// column c0 + 2t, slot t + 4 = column c0 + 2t + 1 (the same for A and B,
// so the sum is unchanged), so a lane's two slots are one chunk: k-step
// m = 2u + e reads chunk (4m + t) ^ sw(row) = 8u + ((4e + t) ^ sw(g)) of
// rows g and g + 8 (mod 8), i.e. word 32u + row[e].  Products over tokens
// read rows 2t + r of 8-row groups: col[r][i] is the word offset (row
// included) of chunk (g·D/16 + i) ^ sw(2t + r), the B values of n-tiles 2i
// and 2i + 1 (see product_over_tokens).
template <int D>
struct Lane {
  int g, t;
  int row[2];
  int col[2][D / 16];
  __device__ __forceinline__ Lane() {
    g = (threadIdx.x & 31) >> 2;
    t = threadIdx.x & 3;
#pragma unroll
    for (int e = 0; e < 2; ++e) row[e] = 4 * ((4 * e + t) ^ sw<D>(g));
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        col[r][i] = (2 * t + r) * 2 * D +
                    4 * ((g * (D / 16) + i) ^ sw<D>(2 * t + r));
  }
};

__device__ __forceinline__ uint4 ld16(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// A fragment of a product over the head dimension from an A-layout tile
// (`frags`: the warp's 16-row group, this lane's quad, k-step 0)
__device__ __forceinline__ void frag_a(const uint32_t* frags, int m,
                                       uint32_t (&big)[4], uint32_t (&small)[4]) {
  const uint4 x = ld16(frags + m * 256);
  const uint4 y = ld16(frags + m * 256 + 128);
  big[0] = x.x; big[1] = x.y; big[2] = x.z; big[3] = x.w;
  small[0] = y.x; small[1] = y.y; small[2] = y.z; small[3] = y.w;
}

// B fragment of such a product from a row-layout tile: B[k][n] =
// tile[r0 + n][k], the tile's rows being the output's columns (`row` is the
// tile's row r0 + g)
__device__ __forceinline__ void frag_b_rows(const uint32_t* row, int off,
                                            uint32_t (&big)[2], uint32_t (&small)[2]) {
  const uint4 x = ld16(row + off);
  big[0] = x.x; big[1] = x.y; small[0] = x.z; small[1] = x.w;
}

// An m16n8 accumulator (c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row
// g + 8) split into the A fragment of a product over its columns, taken in
// the order slot t = column 2t, slot t + 4 = column 2t + 1: no data moves
// between lanes
__device__ __forceinline__ void frag_acc(const float (&c)[4], uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  split<false>(c[0], big[0], small[0]);
  split<false>(c[2], big[1], small[1]);
  split<false>(c[1], big[2], small[2]);
  split<false>(c[3], big[3], small[3]);
}

// acc += A·rows[0 .. 7][:] over those 8 token rows (in frag_acc's order)
// for all D output columns.  The output column of n-tile nn at mma column
// n is n·(D/8) + nn, so a lane's B values for all n-tiles are one
// contiguous run of a row: D/16 16-byte loads a row.
template <int D, bool BX>
__device__ __forceinline__ void product_over_tokens(
    float (&acc)[D / 8][4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
    const uint32_t* rows, const Lane<D>& L) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const uint4 x = ld16(rows + L.col[0][i]);
    const uint4 y = ld16(rows + L.col[1][i]);
    const uint32_t b0[2] = {x.x, y.x}, s0[2] = {x.z, y.z};
    const uint32_t b1[2] = {x.y, y.y}, s1[2] = {x.w, y.w};
    mma3<false, BX>(acc[2 * i], ab, as, b0, s0);
    mma3<false, BX>(acc[2 * i + 1], ab, as, b1, s1);
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  // round to nearest even, as .to(bfloat16)
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&lo),
      *reinterpret_cast<const uint32_t*>(&hi));
}

// Write rows g and g + 8 of a warp's product_over_tokens accumulator:
// row i's columns 2t·(D/8) .. 2t·(D/8) + D/4 − 1 are this lane's.
template <typename TO, int D>
__device__ __forceinline__ void store_rows(TO* out, long long st, int row0,
                                           int T, const float (&acc)[D / 8][4],
                                           const float (&mul)[2]) {
  constexpr int NT = D / 8;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= T) continue;
    TO* o = out + (long long)r * st + 2 * t * NT;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nn = 0; nn < NT; nn += 4)
        store4(o + h * NT + nn, acc[nn][2 * i + h] * mul[i],
               acc[nn + 1][2 * i + h] * mul[i],
               acc[nn + 2][2 * i + h] * mul[i],
               acc[nn + 3][2 * i + h] * mul[i]);
  }
}

// ... with one multiplier for both rows
template <typename TO, int D>
__device__ __forceinline__ void store_rows(TO* out, long long st, int row0,
                                           int T, const float (&acc)[D / 8][4],
                                           float mul) {
  const float m2[2] = {mul, mul};
  store_rows<TO, D>(out, st, row0, T, acc, m2);
}

// s = A·Bᵀ over the head dimension for a warp's 16 rows of an A-layout
// tile (a: as frag_a takes it) against NJ·8 rows of a row-layout tile (bt:
// its row g).  Each pair of k-steps sums into a zeroed partial that one f32
// add puts into s (see mma3): a chain of 6 mmas, 16 of the 64 products.
// UNROLL pairs are unrolled: more partials in flight, more registers.
template <int D, int NJ, bool AX, bool BX, int UNROLL = 1>
__device__ __forceinline__ void product_over_d(float (&s)[NJ][4],
                                               const uint32_t* a,
                                               const uint32_t* bt,
                                               const Lane<D>& L) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll (UNROLL)
  for (int u = 0; u < D / 16; ++u) {
    float p[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      uint32_t ab[4], as[4], bb[2], bs[2];
      frag_a(a, 2 * u + e, ab, as);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        frag_b_rows(bt + j * 16 * D, 32 * u + L.row[e], bb, bs);
        mma3_into<AX, BX>(p[j], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += p[j][e];
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// c += a·b: s8 x s8 -> s32, exact
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte c of r[j] to byte j of o[c]: 4 words of 4 rows x 4 columns to 4
// words of one column x 4 rows each
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t* o) {
  const uint32_t s0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t s1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t s2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t s3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(s0, s2, 0x5410);
  o[1] = __byte_perm(s0, s2, 0x7632);
  o[2] = __byte_perm(s1, s3, 0x5410);
  o[3] = __byte_perm(s1, s3, 0x7632);
}

}  // namespace
